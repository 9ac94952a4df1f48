"""Configuration: CLI flags + optional YAML overlay (ports
livetalking_tpu/config.py).

Same flag surface, defaults and precedence (CLI > YAML > built-in
defaults) as the reference package, so launch scripts keep working, plus
``--device`` (default ``cuda``), the port's counterpart of
``JAX_PLATFORMS``. ``--model`` takes wav2lip, musetalk (bf16/f32, with
``--whisper_short_window``, and W8A8 int8 with ``--vae_int8`` /
``--unet_int8``, widened by ``--vae_mid_int8`` / ``--attn_int8``),
ultralight and ernerf (``hubert_size``, ``ernerf_size`` and
``ernerf_samples`` are options of the opt object, not flags). Flags of
features that later slices port (meshes, profiling) are accepted and have
no effect yet. ``customvideo_config`` JSON is post-parsed into
``opt.customopt``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Optional, Sequence


def _declare_flags(parser: argparse.ArgumentParser) -> None:
    add = parser.add_argument

    add("--config", "-c", type=str, default="config.yaml",
        help="YAML config file path (empty string skips)")

    # audio timing
    add("--fps", type=int, default=25, help="video fps (must be 25)")
    add("-l", type=int, default=10, help="left stride context, in 20ms frames")
    add("-m", type=int, default=8)
    add("-r", type=int, default=10, help="right stride context, in 20ms frames")

    # avatar model
    add("--model", type=str, default="wav2lip",
        help="avatar model: wav2lip, musetalk, ultralight, ernerf")
    add("--avatar_id", type=str, default="wav2lip256_avatar1",
        help="avatar id in data/avatars")
    add("--batch_size", type=int, default=16, help="inference batch size")
    add("--modelres", type=int, default=192)
    add("--modelfile", type=str, default="")

    # custom choreography / multi-avatar
    add("--customvideo_config", type=str, default="", help="custom action json")

    # TTS
    add("--tts", type=str, default="edgetts",
        help="tts plugin: edgetts/gpt-sovits/xtts/cosyvoice/fishtts/tencent/"
             "doubao/indextts2/azuretts/qwentts/omnitts/dummy")
    add("--REF_FILE", type=str, default="zh-CN-YunxiaNeural",
        help="reference audio filename or voice model id")
    add("--REF_TEXT", type=str, default=None)
    add("--TTS_SERVER", type=str, default="http://127.0.0.1:9880")

    # transport
    add("--transport", type=str, default="webrtc",
        help="output: webrtc/rtcpush/rtmp/virtualcam/queue/null")
    add("--stun", type=str, default="stun:stun.freeswitch.org:3478")
    add("--push_url", type=str,
        default="http://localhost:1985/rtc/v1/whip/?app=live&stream=livestream")
    add("--max_session", type=int, default=5)
    add("--listenport", type=int, default=8010, help="web listen port")

    # virtualcam
    add("--audio_output_device", type=int, default=None,
        help="audio output device index (virtualcam transport only)")

    # ---- device and engine ----------------------------------------------
    add("--device", type=str, default="cuda", choices=["cuda", "cpu"],
        help="where models, features and the paste-back run; cuda raises "
             "at startup when no CUDA device is present")
    add("--dtype", type=str, default="bfloat16",
        choices=["bfloat16", "float32"], help="model compute dtype on device")
    add("--coalesce", action="store_true", default=False,
        help="coalesce concurrent sessions into one device batch per tick "
             "(engine/scheduler.py)")
    add("--coalesce_buckets", type=str, default="1,2,4,8",
        help="session-count bucket sizes of the coalescing scheduler "
             "(padding absorbs counts in between)")
    add("--capacity_sessions", type=int, default=-1,
        help="per-device real-time capacity (sessions sustaining >=25 fps "
             "each) used for admission beyond --max_session: -1 = auto "
             "(none is measured for this port yet), 0 = disable, N = override")
    add("--capacity_policy", type=str, default="warn",
        choices=["warn", "strict", "off"],
        help="what to do when a new session exceeds the capacity: warn "
             "(admit + log + flag in /api/admin/sessions), strict (reject "
             "with a clean error envelope), off")
    add("--feature_window_ms", type=float, default=0.0,
        help="alignment window of the cross-session Whisper feature "
             "coalescer (musetalk --coalesce), in ms; 0 = none")
    add("--coalesce_window_ms", type=float, default=-1.0,
        help="idle-device session-alignment window for the coalescing "
             "scheduler, in ms. While the device is idle and a "
             "super-batch is partial, the scheduler holds it up to this "
             "long for other sessions to land on the same batch (a lone "
             "session never waits). -1 = auto (one request period, "
             "1000*batch_size/fps); 0 = dispatch immediately when idle")
    add("--scheduler_prewarm", type=int, default=1,
        help="run every coalescing-bucket super-batch once in the "
             "background as soon as the first session registers (1, "
             "default); 0 = each bucket's first call happens live")
    add("--egress_buffer_frames", type=int, default=5,
        help="transport egress backlog (video frames) at which the "
             "render loop throttles feature extraction (reference value "
             "5 = ~200 ms); +40 ms playout latency per extra frame")
    add("--session_inflight", type=int, default=2,
        help="per-session inference batches kept in flight (>=1); depth 2 "
             "decouples a session's emission rate from the scheduler's "
             "request latency at the cost of one batch of glass-to-glass "
             "latency. Depth 1 is the synchronous reference behavior")
    add("--vae_int8", action="store_true", default=False,
        help="musetalk: W8A8 int8 VAE decoder (3x3 convs on the csrc/conv.cu "
             "kernels; static activation scales calibrated on the first "
             "session's avatar; LT_FUSED_VAE=1 fuses GroupNorm+SiLU+quantize "
             "into the up-block convs)")
    add("--unet_int8", action="store_true", default=False,
        help="musetalk: W8A8 int8 U-Net convs (calibrated on the first "
             "session's avatar latents)")
    add("--attn_int8", type=int, default=1,
        help="with --unet_int8: also run the transformer's softmax-safe "
             "matmuls in int8 (q/k and cross-attention k/v stay bf16)")
    add("--vae_mid_int8", type=int, default=1,
        help="with --vae_int8: also run the decoder's two mid-block resnets "
             "in int8")
    add("--whisper_short_window", action="store_true", default=False,
        help="musetalk: encode the Whisper rolling window itself instead "
             "of the 30 s zero-padded chunk (same mel values for the real "
             "frames, ~20x fewer encoder positions)")
    add("--device_paste_back", action="store_true", default=False,
        help="composite predicted crops into full frames on the device "
             "(ops/blend.py, the csrc/blend.cu kernels: rect for wav2lip "
             "and, with --coalesce, ultralight; masked for musetalk) instead "
             "of per-frame host cv2")
    add("--mesh", type=str, default="",
        help="device mesh spec; accepted and unused by the server, as in the JAX "
             "package (multi-GPU: parallel/, the training CLI's --mesh, parallel.dryrun)")
    add("--profile_dir", type=str, default="",
        help="write a torch.profiler trace (CPU and CUDA) of the whole run here at exit")
    add("--models_dir", type=str, default="./models")
    add("--data_dir", type=str, default="./data")


def _yaml_overlay(parser: argparse.ArgumentParser, argv: Optional[Sequence[str]]) -> None:
    """Apply YAML file values as parser defaults (so CLI still wins)."""
    try:
        import yaml
    except ImportError:
        return
    probe, _ = parser.parse_known_args(argv)
    path = probe.config
    if not path or not os.path.exists(path):
        return
    with open(path, "r", encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    if isinstance(cfg, dict):
        parser.set_defaults(**{k.replace("-", "_"): v for k, v in cfg.items()})


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="LiveTalking Digital Human Server (PyTorch/CUDA)")
    _declare_flags(parser)
    _yaml_overlay(parser, argv)
    opt = parser.parse_args(argv)

    opt.customopt = []
    if opt.customvideo_config:
        with open(opt.customvideo_config, "r") as f:
            opt.customopt = json.load(f)
    return opt


def default_opt(**overrides: Any) -> argparse.Namespace:
    """Programmatic config (tests, embedding): defaults + keyword overrides."""
    opt = parse_args(["--config", ""])
    for k, v in overrides.items():
        setattr(opt, k, v)
    return opt
