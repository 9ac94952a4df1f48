#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--paced 2,4]

Drives ``livetalking_tpu_torch`` on the card with random weights from fixed
seeds, through the entry points a server uses, at full width: Wav2Lip-256,
MuseTalk (U-Net (320, 640, 1280, 1280), the full sd-vae-ft-mse,
Whisper-tiny) in bf16 and in W8A8 int8, and the HuBERT-fed families
(HuBERT-large, the Ultralight U-Net, ER-NeRF), at batch 16; then the
speech-to-text path (Whisper-tiny, ``/api/asr``) and the avatar builds
(S3FD, BiSeNet, PFLD, the task manager), training, and the multi-device
path (the sharded MuseTalk step, the scheduler driving it on every rank,
``--mesh`` training) with ``--profile_dir``'s trace; last the host edge
(RTMP, recording, a TTS provider, WebRTC and the virtual camera where their
modules are installed).

  1. device     — ``nvidia-smi`` name and power limit; compute capability 9.0.
  2. build      — every kernel under ``livetalking_tpu_torch/csrc``, one nvcc
                  per source, all at once; beside it ``nvcc -Xptxas -v`` on
                  ``conv.cu`` and ``blend.cu`` prints each kernel's
                  registers, shared memory and spills.
  3. blend      — the rect paste-back kernel, fused (frames by index in, new
                  frames out, as ``make_resize_paste_fn`` runs it) and in
                  place, against its plain version on 480x640 frames at B in
                  {16, 32, 128} and on 1080x1920 frames at B=32 from 8-frame
                  cycles, and at B=128 (480x640) and B=32 (1080x1920) from
                  400-frame stores with sessions' consecutive indices; a
                  240x256 bucket, feather in {0, 9}: at most 1 LSB apart,
                  byte-identical outside the bbox. Times of both forms by
                  ``cuda_ms`` and ``device_ms``, the full-frame gather the
                  fused form absorbs (context), both bounds, the step's host
                  time at B=32.
     blend_s168 — the same rect kernel at Ultralight's S = 168 (504-byte
                  crop rows), B=16 from 8 frames and B=128 from 400.
  4. blend_mask — the same for the masked kernel on the synthetic MuseTalk
                  avatar's geometry (blurred ellipse masks in a 288x384
                  bucket), outside the face bbox. Then one paste step call of
                  each kind at B=32 is one CUDA kernel (torch.profiler).
  5. attention  — the attention kernel against its plain version at every
                  shape a MuseTalk step gives it, B=16, bf16 (atol 2e-2, and
                  per element 2 bf16 ulps + 4e-3) and f32 (atol 2e-5); the
                  T=1024 shapes also at the engine's B=64 and 128, one
                  T % 16 == 8 shape and T = 1000 and 72 (ragged tiles);
                  share of the bound per shape; beside it PyTorch's
                  ``scaled_dot_product_attention`` as the yardstick only.
  6. conv_int8  — the int8 3x3 conv kernel against its plain version at every
                  3x3 stride-1 int8 site of a B=16 MuseTalk int8 step (U-Net
                  and unfused decoder, 80 launches): bf16 bit-equal; the
                  residual epilogue; the bf16 twin (rtol = atol = 2e-2, and
                  1 bf16 ulp on positive inputs). Per shape its K split and
                  blocks, ``ms`` (an event pair around each call) and
                  ``device_ms`` (20 launches queued behind ``torch.cuda._sleep``,
                  the card's own time), each against the bound; cuDNN's bf16
                  conv and ``torch._int_mm``'s GEMM of the shape as context
                  only; sums per unfused (80) and fused (59) step; the
                  wrapper's host time per call at the 4x4 site.
  7. gnq        — the fused GroupNorm-SiLU-quantize conv kernel against its
                  plain version at every site of the fused B=16 decode (21
                  launches), at tests/test_pallas_conv.py's bars.
  8. model      — the fp32 Wav2Lip step on the card (TF32 off) against the same
                  step on the CPU at B=2: at most 1 LSB; the bf16 step's time.
  9. musetalk model — the fp32 MuseTalk step at B=1 on the card (TF32 off)
                  against the CPU: at most 1 LSB; the bf16 step's time at B=16
                  with 17 attention launches and 91 GroupNorm calls per step
                  (their shapes recorded), its profile; the batched Whisper
                  encode's time at k=1 and k=2.
     norm       — the GroupNorm (-> SiLU) kernel against its plain version at
                  every site of that step, B=16 and B=128: at most 1 bf16 ulp
                  apart on 99.9% of the elements, the normalized values within
                  1 ulp + 2^-16 of the affine's terms, SiLU bit for bit on
                  them, bitwise equal across two launches; ``device_ms`` against the bound (4
                  bytes an element), TB/s at the 6 bytes it moves, the plain
                  version's time, sums per step.
 10. musetalk int8 model — the B=16 step with ``--vae_int8 --unet_int8``,
                  calibrated on the synthetic avatar as a first session does,
                  unfused (80 int8 conv launches) and with ``LT_FUSED_VAE=1``
                  (59 + 21): fused vs unfused PSNR > 35 dB in the reference's
                  setting and > 30 dB at the served shapes, int8 vs the bf16
                  step >= 24 dB; step times of the three.
 11. engine     — ``app.load_plugin_stack`` with ``--model wav2lip --coalesce
                  --device_paste_back``, two sessions, text in, full frames out
                  of the queue transport.
 12. musetalk engine — the same with ``--model musetalk``, two sessions on
                  avatars encoded by the port's VAE on the card.
 13. musetalk int8 engine — the same with ``--vae_int8 --unet_int8`` and
                  ``LT_FUSED_VAE=1``.
 14. hubert     — HuBERT-large through the session's extractor on one
                  16,640-sample window: bf16 weights (f32 activations, the
                  reference's arithmetic) against f32 weights, relative L2
                  error <= 5e-2; ms per window, bound, kernel profile.
 15. ultralight model — the B=16 bf16 step on reference-layout random
                  weights against f32 (>= 30 dB), its time, bound and
                  profile; the grouped step at n=2 and 8 sessions with
                  distinct weights within 1 LSB of the per-avatar steps.
 16. ultralight engine — ``--model ultralight --coalesce
                  --device_paste_back``, two sessions on avatars with
                  distinct weights: one kernel-1 launch per batch.
 17. ernerf     — the render on the card against the CPU (16 px, 4
                  samples, 1 LSB); B=16 at 128 px, 32 samples (ms, peak
                  memory); one ``--model ernerf`` session.
 18. stt        — Whisper-tiny speech-to-text as ``/api/asr`` serves it (bf16,
                  30 s encoder window, 128 decode steps forced by a zeroed
                  EOT embedding): encode ms, decode ms per token and its
                  kernel profile, the host syncs of a decode
                  (``torch.cuda.set_sync_debug_mode``), the real-time
                  factor on 5 s of audio; the card's ids equal the
                  CPU's in f32 for 16 tokens; one ``/api/asr`` round trip
                  through ``app.build_web_app()`` on a local aiohttp server.
 19. face_models — S3FD, BiSeNet and PFLD on the card (TF32 convolutions)
                  against the CPU at a small size (relative L2 error, TF32
                  on and off); S3FD on 16 frames of 480x640 (GMAC, share of
                  the TF32 rate, the detector's whole chunk), BiSeNet at 512
                  px for B=1 and 16, PFLD per face.
 20. genavatar  — a synthetic 480x640 video built into wav2lip, MuseTalk and
                  Ultralight avatars by the port's task manager on the card
                  (s per frame), and an ER-NeRF avatar whose field the
                  training step fits (200 steps) on the HuBERT features of
                  a separate audio file (its audio net must move); each
                  served in one session by its plugin.
 21. train      — kernel 3's autograd Function at every training shape, f32
                  and bf16: the card's (dq, dk, dv) against the CPU's
                  (1e-4 and 1e-2 of max|grad|), the forward kernel's and the
                  PyTorch backward's times at B=10; MuseTalk's full recipe
                  at full width through ``train.cli.main`` (f32, B=10, 3
                  steps, a random SyncNet file as the sync expert, both
                  GANs): 20 attention launches a step, finite losses, step
                  ms, peak memory; the U-Net self-attention gradients of
                  the same step's forward (its latents' squared error)
                  with the kernel against ``attention_plain`` in its place
                  (each q, k, v, o leaf's relative L2 <= 1e-3); the step's
                  FLOPs and busy share; 2 bf16 L1 steps; one step with the MuseTalk
                  expert (B=16, 22 launches); one Wav2Lip full-recipe step,
                  one Ultralight L1 step and one SyncNet step.
 22. multigpu   — (a) one rank per card over NCCL (``default_mesh_for`` of
                  the card count): the full-width MuseTalk step (B=16, bf16)
                  sharded over the mesh against the single-device step, bit
                  for bit at one rank (1 LSB, f32, above), and 2 ``--mesh``
                  training steps of the tiny MuseTalk L1 recipe against one
                  rank; (b) two gloo ranks sharing cuda:0 (two NCCL ranks on
                  one card are refused: the error is printed; which
                  collectives gloo takes on CUDA tensors, probed): the full-
                  width step at dp=2 and at tp=2 in f32 (TF32 off) within 1
                  LSB of the single-device step, kernel 3's launches on each
                  rank, the step's ms per rank, the tp all-gathers' count,
                  bytes and time; one coalesced ``BatchScheduler`` round
                  over the sharded step with the masked paste (kernel 2)
                  composed on rank 0; 2 ``--mesh dp=2`` MuseTalk L1 steps
                  at full width (f32, B=2) against one rank's run: losses
                  (1e-6), each gradient leaf (``TRAIN_GRAD_REL``), the
                  parameters bit-equal across ranks after each step, peak
                  memory and the gradient all-reduce's bytes and time per
                  rank; (c) with two cards or more, (b) over NCCL on two
                  cards. Two ranks on one card check the arithmetic and the
                  collectives' cost, not scaling.
 23. profile_dir — ``--profile_dir``'s profiler (``app.start_profiler``)
                  around one composed MuseTalk step (tiny U-Net, full VAE,
                  bf16, B=16, the masked paste): the trace it writes holds
                  kernel 3's and kernel 2's CUDA events.
 24. transports — the host edge on the main path: ``--model wav2lip --coalesce
                  --device_paste_back`` at full width, session 0 booted as for
                  ``--transport rtmp`` (a local ``.flv``, no server), ``--tts
                  cosyvoice`` from a local stand-in (10 s of speech through
                  ``stream_pcm16``), ``/human``, ``/record`` start and end and
                  ``GET /record/0`` through ``app.build_web_app()``: kernel 1
                  launches, ``start`` then ``end``, the audio of the mp4 and
                  the flv within 2% of the PCM pushed; the encoder, frame
                  size, frames muxed, egress fps and ``write_video``'s host ms
                  and share of the compose thread. WebRTC (a loopback to
                  ``/offer``) and the virtual camera where ``aiortc``/``av``
                  and ``pyvirtualcam`` import, else ``skipped=``; without
                  ``pkg-config`` or the ffmpeg development libraries the native
                  module is ``skipped=`` with its build error and recording
                  takes the ffmpeg CLI, if there is one.
 25. paced      — only with ``--paced``: MuseTalk sessions whose frames are
                  taken at 25 fps, started 160 ms apart, with the shared
                  Whisper feature coalescer and without it (with, without,
                  without, with); speech frames/s, starved ticks, requests
                  per super-batch and request latency of each run.

In each engine phase every kernel count is set to 0 just before the
sessions start and read after: every kernel of the path must have launched
(the kernels line's ``blend`` row also carries the Ultralight engine's
launches and the S = 168 times).
Kernel times are medians of 60 runs (CUDA events). Prints one line per
phase, then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero without that line; without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import functools
import json
import os
import queue
import subprocess
import sys
import time
import wave

import numpy as np

# peak memory bandwidth (bytes/s), fp32 rate outside the tensor cores and
# dense bf16 tensor-core rate (FLOP/s), from NVIDIA's data sheets; first
# matching name wins
PEAKS = [
    ("H100 NVL", 3.9e12, 60e12, 835e12),
    ("H100 PCIe", 2.0e12, 51e12, 756e12),
    ("H200", 4.8e12, 67e12, 989e12),
    ("H100", 3.35e12, 67e12, 989e12),  # SXM
]
EXP_PER_SM_CLOCK = 16  # SFU exponentials per SM per clock
NO_LIBRARY = "null (no single PyTorch call resizes per item into per-item boxes, blends and pastes)"
NO_INT8_CONV = "null (PyTorch has no int8 convolution on CUDA)"
# kernel-6 calls (GroupNorm sites) per MuseTalk step: every site of the bf16
# step (61 U-Net, 30 VAE decode); the int8 step with LT_FUSED_VAE=1 keeps
# kernel 5 from the decoder's block 1 on (61 U-Net, 11 decoder mid and block 0)
NORM_SITES_BF16, NORM_SITES_INT8 = 91, 72
FUSED_REF_DB = 35.0  # tests/test_pallas_conv.py::test_fused_decode_matches_xla_path
FUSED_SERVED_DB = 30.0  # fused vs unfused at the served shapes (phase_musetalk_int8_model)
INT8_E2E_DB = 24.0  # tests/test_int8_quality.py's end-to-end bar
UL_PSNR_DB = 30.0  # the bf16 Ultralight step against f32 on the same weights
HUBERT_REL_ERR = 5e-2  # HuBERT-large features, bf16 weights against f32 (relative L2)
# the face models on the card against the CPU (relative L2): f32 convolutions
# differ by summation order only; TF32 rounds every conv input to 10 bits
FACE_REL_ERR_F32, FACE_REL_ERR_TF32 = 1e-4, 1e-2

S, H, W = 256, 480, 640
BOX = (120, 360, 200, 440)  # 240x240 face box centred in a 480x640 frame
TOL_LSB = 1
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_pallas_attention.py's bars
# the bf16 tensor-core path is also held per element to 2 bf16 ulps of the
# plain output plus 4e-3: one flipped rounding of a probability near 0.5
# times |v| ~ 1 (the f32 sums differ in order); dropping one 8-key tile
# moves T=1024 outputs by about 1e-2
TC_ATOL, TC_ULPS = 4e-3, 2
# (T, D, heads, launches per MuseTalk step): the U-Net's self-attention at its
# four levels and the VAE decoder's mid-block
ATTN_SHAPES = [(1024, 40, 8, 5), (256, 80, 8, 5), (64, 160, 8, 5), (16, 160, 8, 1),
               (1024, 512, 1, 1)]
# checked only: the super-batch sizes the engine runs (16 x buckets 4 and 8)
# at the two T=1024 sites, T % 16 == 8, and T = 1000 and 72, where the bf16
# kernels' last query and key tiles are partly past T
ATTN_CHECK_ONLY = [(64, 8, 1024, 40), (128, 8, 1024, 40), (64, 1, 1024, 512),
                   (128, 1, 1024, 512), (16, 8, 1016, 40), (2, 3, 1000, 40), (3, 2, 72, 40),
                   (2, 1, 1000, 512)]


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 10, iters: int = 60) -> float:
    """Median device time of ``fn`` over ``iters`` runs, one event pair each."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(t_bytes: float, t_ops: float) -> tuple:
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def make_avatar(plugin, avatar_id: str, n: int, seed: int, device: str):
    """A 480x640 Wav2Lip avatar drawn with numpy: smooth gradients plus
    noise, a 240x240 face box, face crops resized to 256 with torch."""
    import torch

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    frames = []
    for i in range(n):
        base = np.stack([(xx + 7 * i) % 256, (yy + 3 * i) % 256, (xx + yy) % 256], -1)
        noise = rng.integers(0, 16, (H, W, 3))
        frames.append(((base + noise) % 256).astype(np.uint8))
    y1, y2, x1, x2 = BOX
    crops = torch.from_numpy(np.stack([f[y1:y2, x1:x2] for f in frames])).permute(0, 3, 1, 2)
    faces = torch.nn.functional.interpolate(crops.float(), size=(S, S), mode="bilinear",
                                            align_corners=False)
    faces = faces.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).numpy()
    return plugin.avatar_from_arrays(avatar_id, frames, faces, [BOX] * n, device=device)


def start_ptxas_report(_build, source: str):
    """Compile ``csrc/<source>.cu`` to a cubin with ``-Xptxas -v`` beside the
    build (same flags); ``log_ptxas_report`` prints each kernel's registers,
    shared memory and spills."""
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    out = _build.build_dir() / f"{source}.ptxas.cubin"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o", str(out),
           str(_build.CSRC / f"{source}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def log_ptxas_report(proc) -> None:
    import re

    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"nvcc -Xptxas -v failed:\n{text}")
    name = None
    info = {}
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            info[name] = {}
        elif name:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                info[name]["spill_stores"], info[name]["spill_loads"] = m.groups()
            m = re.search(r"Used (\d+) registers", line)
            if m:
                info[name]["registers"] = m.group(1)
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                info[name]["static_smem_bytes"] = m.group(1)
    for fn, kv in info.items():
        log("ptxas", kernel=fn, **kv)


# (frame, B, cycle frames in the store): 8-frame cycles, each index repeated
# about B/8 times; then stores of real cycle length (the kernels line reads
# the 480x640 one)
PASTE_SHAPES = [((H, W), 16, 8), ((H, W), 32, 8), ((H, W), 128, 8), ((1080, 1920), 32, 8),
                ((H, W), 128, 400), ((1080, 1920), 32, 400)]
# kernel 1 at Ultralight's S = 168: B=16 from an 8-frame cycle, B=128 from a
# store of real cycle length (the kernels line reads the latter)
UL_PASTE_SHAPES = [((H, W), 16, 8), ((H, W), 128, 400)]
HD_OFFSET = (300, 640)  # the 480x640 face geometry moved into a 1080x1920 frame
SESSION_FRAMES = 16  # frames per session in a super-batch (Wav2Lip's batch)


def paste_idxs(rng, B: int, N: int) -> np.ndarray:
    """Cycle indices of a super-batch: with 8 frames, drawn at random (each
    repeated about B/8 times); with a longer cycle, B/16 sessions stepping
    through it from random starts, 16 consecutive frames each, as the
    scheduler gathers them (almost all distinct)."""
    if N <= 8:
        return rng.integers(0, N, (B,)).astype(np.int32)
    starts = rng.integers(0, N, (B // SESSION_FRAMES, 1))
    return ((starts + np.arange(SESSION_FRAMES)) % N).reshape(-1).astype(np.int32)


def paste_frames(torch, rng, N: int, Hf: int, Wf: int):
    """N random (Hf, Wf, 3) uint8 cycle frames on the card: drawn by numpy
    for 8-frame cycles, on the card (seeded from ``rng``) for long ones."""
    if N <= 8:
        return torch.from_numpy(rng.integers(0, 256, (N, Hf, Wf, 3), dtype=np.uint8)).cuda()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(int(rng.integers(0, 2**31)))
    return torch.randint(0, 256, (N, Hf, Wf, 3), dtype=torch.uint8, device="cuda", generator=gen)


def traced(torch, run):
    """``run()`` under torch.profiler (CPU and CUDA activity) -> the profile.
    A window whose trace holds no CUDA event at all is the tracer's miss
    (every window here launches kernels; it happens now and then on a
    process's first window) and is taken again, up to three windows; a
    third empty one raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        if any(e.device_type == DeviceType.CUDA for e in prof.events()):
            if attempt:
                log("profiler", empty_windows_taken_again=attempt)
            return prof
    raise AssertionError("torch.profiler traced no CUDA event in three windows")


def check_one_kernel_per_paste(torch, call) -> None:
    """One paste step call is one CUDA kernel (torch.profiler window)."""
    from torch.autograd import DeviceType

    call()
    prof = traced(torch, call)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    if len(names) != 1 or "paste" not in names[0]:
        raise AssertionError(f"one paste call ran the CUDA kernels {names}, want one paste kernel")


def time_paste(torch, phase: str, shape, B: int, paste, inplace, gather, plain, bytes_fused,
               bytes_inplace, ops: float, peak_bw: float, peak_f32: float,
               clock_hz: float, N: int) -> dict:
    """Times of one paste shape: the fused step (``paste``) and the in-place
    kernel (``inplace``), each by ``cuda_ms`` and ``device_ms``; the full-frame
    gather that the fused form absorbs, alone (context: the port never runs
    it); the plain version; the bounds; at B=32 the step's host time."""
    r = {"paste_ms": cuda_ms(paste), "paste_device_ms": device_ms(torch, paste, clock_hz),
         "inplace_ms": cuda_ms(inplace), "inplace_device_ms": device_ms(torch, inplace, clock_hz),
         "gather_ms": cuda_ms(gather), "plain_ms": cuda_ms(plain, warmup=2, iters=10)}
    r["old_route_ms"] = r["gather_ms"] + r["inplace_ms"]
    r["paste_bound_ms"], r["paste_bound_by"] = bound(bytes_fused / peak_bw * 1e3,
                                                     ops / peak_f32 * 1e3)
    r["inplace_bound_ms"], r["inplace_bound_by"] = bound(bytes_inplace / peak_bw * 1e3,
                                                         ops / peak_f32 * 1e3)
    r["wrapper_host_us"] = host_us_per_call(torch, paste, n=200) if B == 32 else None
    log(phase, frame=f"{shape[0]}x{shape[1]}", B=B, store_frames=N,
        **{k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in r.items()},
        paste_share_of_bound=f"{r['paste_bound_ms'] / r['paste_device_ms']:.3f}",
        inplace_share_of_bound=f"{r['inplace_bound_ms'] / r['inplace_device_ms']:.3f}",
        paste_MB=f"{bytes_fused / 1e6:.1f}", inplace_MB=f"{bytes_inplace / 1e6:.1f}",
        library_ms=NO_LIBRARY)
    return r


def phase_blend(torch, blend, peak_bw: float, peak_f32: float, clock_hz: float, S: int = S,
                shapes=PASTE_SHAPES, phase: str = "blend", seed: int = 1) -> dict:
    """The rect paste kernel, both forms, against its plain version for (S,
    S) crops at each of ``shapes`` (240x256 bucket, feather 0 and 9
    checked, 0 timed): at most 1 LSB apart, byte-identical outside the
    bbox; then timed. Also returns the paste step at B=32, 480x640
    (``step``) when ``shapes`` has it."""
    rng = np.random.default_rng(seed)
    max_err = 0
    rows = {}
    step = None
    for (Hf, Wf), B, N in shapes:
        oy, ox = HD_OFFSET if Hf != H else (0, 0)
        frames = paste_frames(torch, rng, N, Hf, Wf)
        boxes_np = []
        for _ in range(N):
            h, w = int(rng.integers(200, 241)), int(rng.integers(200, 241))
            y1, x1 = oy + int(rng.integers(0, H - h + 1)), ox + int(rng.integers(0, W - w + 1))
            boxes_np.append((y1, y1 + h, x1, x1 + w))
        Ho, Wo = blend.bucket_shape(boxes_np)
        if (Ho, Wo) != (240, 256):
            raise AssertionError(f"bucket {(Ho, Wo)} != (240, 256)")
        boxes = torch.tensor(boxes_np, dtype=torch.int32, device="cuda")
        pred = torch.from_numpy(rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8)).cuda()
        idxs = torch.from_numpy(paste_idxs(rng, B, N)).cuda()
        picked = frames.index_select(0, idxs)
        box_b = boxes.index_select(0, idxs)
        outside = torch.ones((B, Hf, Wf), dtype=torch.bool, device="cuda")
        for b, i in enumerate(idxs.tolist()):
            y1, y2, x1, x2 = boxes_np[i]
            outside[b, y1:y2, x1:x2] = False
        for feather in (0, 9):
            fn = blend.make_resize_paste_fn(S, Ho, Wo, Hf, Wf, feather=feather)
            want = blend.resize_paste_plain(pred, frames, idxs, boxes, S=S, Ho=Ho, Wo=Wo, H=Hf,
                                            W=Wf, feather=feather)
            for form, got in (("fused", fn(pred, frames, idxs, boxes)),
                              ("in place", blend.blend_rect_(pred, picked.clone(), box_b, Ho=Ho,
                                                             Wo=Wo, feather=feather))):
                torch.cuda.synchronize()
                err = int((got.int() - want.int()).abs().max())
                if err > TOL_LSB or not torch.equal(got[outside], picked[outside]):
                    raise AssertionError(f"{phase} {form} {Hf}x{Wf} B={B} S={S} "
                                         f"feather={feather}: max err {err} (tolerance "
                                         f"{TOL_LSB} LSB) or pixels outside the bbox changed")
                max_err = max(max_err, err)
        fn = blend.make_resize_paste_fn(S, Ho, Wo, Hf, Wf)
        paste = lambda: fn(pred, frames, idxs, boxes)  # noqa: E731
        if (Hf, Wf, B) == (H, W, 32):
            step = functools.partial(fn, pred, frames, idxs, boxes)
        buf = picked.clone()
        # least work for these inputs, fused: each distinct frame read once,
        # each output frame written once, each pred crop read once, the box
        # of each distinct index once, the indices; in place (as before):
        # each pred crop once, the boxes, each bbox pixel read and written
        # once. About 59 fp32 operations per bbox pixel (20 for positions,
        # weights and alpha, 13 per channel for the 4-tap resize and blend)
        uniq = len(set(idxs.tolist()))
        hw = sum(min(y2 - y1, Ho) * min(x2 - x1, Wo)
                 for (y1, y2, x1, x2) in (boxes_np[i] for i in idxs.tolist()))
        frame_bytes = Hf * Wf * 3
        r = time_paste(
            torch, phase, (Hf, Wf), B, paste,
            lambda: blend.blend_rect_(pred, buf, box_b, Ho=Ho, Wo=Wo),
            lambda: frames.index_select(0, idxs),
            lambda: blend.resize_paste_plain(pred, frames, idxs, boxes, S=S, Ho=Ho, Wo=Wo,
                                             H=Hf, W=Wf),
            (uniq + B) * frame_bytes + B * (3 * S * S + 4) + uniq * 16,
            B * (3 * S * S + 16) + 2 * 3 * hw, 59 * hw, peak_bw, peak_f32, clock_hz, N)
        rows[(Hf, Wf, B, N)] = r
        del frames, picked, buf, outside
        torch.cuda.empty_cache()
    log(phase, S=S, max_abs_err=max_err)
    return {"max_abs_err": max_err, "rows": rows, "step": step}


def phase_blend_mask(torch, blend, synthetic, peak_bw: float, peak_f32: float,
                     clock_hz: float) -> dict:
    """The masked paste kernel, both forms, on the synthetic MuseTalk
    avatar's geometry (blurred ellipse masks, 288x384 bucket), the face box
    jittered per cycle index so items differ, at each of ``PASTE_SHAPES``:
    the same bars outside the face bbox; then timed. Also returns the paste
    step at B=32, 480x640 (``step``)."""
    rng = np.random.default_rng(3)
    a = synthetic.musetalk_avatar_arrays(n_frames=1, frame_hw=(H, W), seed=3)
    (x1, y1, x2, y2), (xs, ys, xe, ye) = a["coords"][0], a["mask_coords"][0]
    max_err = 0
    rows = {}
    for (Hf, Wf), B, N in PASTE_SHAPES:
        oy, ox = HD_OFFSET if Hf != H else (0, 0)
        faces, crops, masks = [], [], []
        for _ in range(N):
            dx, dy = ox + int(rng.integers(-20, 21)), oy + int(rng.integers(-20, 21))
            faces.append((x1 + dx, y1 + dy, x2 + dx, y2 + dy))
            crops.append((xs + dx, ys + dy, xe + dx, ye + dy))
            masks.append(a["masks"][0])
        Ho, Wo = blend.bucket_shape([(b, d, a_, c) for (a_, b, c, d) in crops])
        origins, scalars, mask_np = blend.prepare_masked_paste_data(faces, crops, masks, Ho, Wo,
                                                                    Hf, Wf)
        frames = paste_frames(torch, rng, N, Hf, Wf)
        org, sc, mk = (torch.from_numpy(v).cuda() for v in (origins, scalars, mask_np))
        fn = blend.make_masked_paste_fn(S, Ho, Wo, Hf, Wf)
        pred = torch.from_numpy(rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8)).cuda()
        idxs = torch.from_numpy(paste_idxs(rng, B, N)).cuda()
        picked = frames.index_select(0, idxs)
        want = blend.masked_paste_plain(pred, frames, idxs, org, sc, mk, S=S, Ho=Ho, Wo=Wo,
                                        H=Hf, W=Wf)
        outside = torch.ones((B, Hf, Wf), dtype=torch.bool, device="cuda")
        for b, i in enumerate(idxs.tolist()):
            fx1, fy1, fx2, fy2 = faces[i]
            outside[b, fy1:fy2, fx1:fx2] = False
        for form, got in (("fused", fn(pred, frames, idxs, org, sc, mk)),
                          ("in place", blend.blend_masked_(pred, picked.clone(), idxs, org, sc,
                                                           mk, Ho=Ho, Wo=Wo))):
            torch.cuda.synchronize()
            err = int((got.int() - want.int()).abs().max())
            if err > TOL_LSB or not torch.equal(got[outside], picked[outside]):
                raise AssertionError(f"blend_mask {form} {Hf}x{Wf} B={B}: max err {err} "
                                     f"(tolerance {TOL_LSB} LSB) or pixels outside the face "
                                     "bbox changed")
            max_err = max(max_err, err)
        paste = lambda: fn(pred, frames, idxs, org, sc, mk)  # noqa: E731
        if (Hf, Wf, B) == (H, W, 32):
            step = functools.partial(fn, pred, frames, idxs, org, sc, mk)
        buf = picked.clone()
        # least work for these inputs, fused: each distinct frame read once,
        # each output frame written once, each pred crop and index once; the
        # origin, the geometry and the mask inside the face bbox once per
        # distinct index; in place (as before): the same without the frames,
        # plus a read and a write of every pixel whose mask is non-zero.
        # About 60 fp32 operations per pixel with a non-zero mask
        uniq = sorted(set(idxs.tolist()))
        h_w = sum(int(scalars[i, 0]) * int(scalars[i, 1]) for i in uniq)
        nnz = sum(int((mask_np[i] > 0).sum()) for i in idxs.tolist())
        planes = B * (3 * S * S + 4) + len(uniq) * (8 + 16) + h_w
        r = time_paste(
            torch, "blend_mask", (Hf, Wf), B, paste,
            lambda: blend.blend_masked_(pred, buf, idxs, org, sc, mk, Ho=Ho, Wo=Wo),
            lambda: frames.index_select(0, idxs),
            lambda: blend.masked_paste_plain(pred, frames, idxs, org, sc, mk, S=S, Ho=Ho, Wo=Wo,
                                             H=Hf, W=Wf),
            planes + (len(uniq) + B) * Hf * Wf * 3, planes + 2 * 3 * nnz, 60 * nnz, peak_bw,
            peak_f32, clock_hz, N)
        rows[(Hf, Wf, B, N)] = r
        del frames, picked, buf, outside
        torch.cuda.empty_cache()
    log("blend_mask", bucket=f"{Ho}x{Wo}", max_abs_err=max_err)
    return {"max_abs_err": max_err, "rows": rows, "step": step}


def check_attention(torch, attn, shape, gen, err: dict) -> tuple:
    """The kernel against its plain version on one shape, f32 and bf16;
    returns the f32 (q, k, v). The bf16 output must also lie within
    ``TC_ULPS`` bf16 ulps of the plain one plus ``TC_ATOL`` per element."""
    scale = shape[-1] ** -0.5
    q32, k32, v32 = (torch.randn(shape, device="cuda", generator=gen) for _ in range(3))
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.to(dtype) for t in (q32, k32, v32))
        got = attn.attention(q, k, v, scale).float()
        want = attn.attention_plain(q, k, v, scale).float()
        torch.cuda.synchronize()
        d = (got - want).abs()
        e = float(d.max())
        name = str(dtype).split(".")[1]
        if not e <= ATOL[name]:
            raise AssertionError(f"attention {shape} {name}: max err {e} > {ATOL[name]}")
        if dtype == torch.bfloat16:
            # one bf16 ulp of w is 2**(e - 8) for w = m * 2**e, 0.5 <= m < 1
            ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
            over = float((d - TC_ULPS * ulp - TC_ATOL).max())
            if over > 0:
                raise AssertionError(f"attention {shape} bf16: an error exceeds {TC_ULPS} "
                                     f"ulps + {TC_ATOL} by {over}")
            err["bf16_over_bar"] = max(err.get("bf16_over_bar", -1.0), over)
        err[name] = max(err[name], e)
    return q32, k32, v32


def phase_attention(torch, attn, peak_bw: float, peak_bf16: float, exp_rate: float) -> dict:
    """Every self-attention shape of a MuseTalk step at B=16, timed; the
    engine's larger super-batches and a half last key tile, checked only.
    The step figures weight each shape by its launches per step (17 in all)."""
    from torch.nn import functional as F

    B = 16
    gen = torch.Generator(device="cuda").manual_seed(5)
    err = {"float32": 0.0, "bfloat16": 0.0}
    step = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
            "bytes": 0.0, "operations": 0.0}
    for shape in ATTN_CHECK_ONLY:
        check_attention(torch, attn, shape, gen, err)
        torch.cuda.empty_cache()
    log("attention", checked=[list(s) for s in ATTN_CHECK_ONLY],
        max_abs_err_f32=err["float32"], max_abs_err_bf16=err["bfloat16"],
        bf16_margin_to_bar=-err["bf16_over_bar"])
    shapes = []
    for T, D, heads, per_step in ATTN_SHAPES:
        shape = (B, heads, T, D)
        scale = D ** -0.5
        q32, k32, v32 = check_attention(torch, attn, shape, gen, err)
        q, k, v = (t.to(torch.bfloat16) for t in (q32, k32, v32))
        ms = cuda_ms(lambda: attn.attention(q, k, v, scale))
        plain_ms = cuda_ms(lambda: attn.attention_plain(q, k, v, scale))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
        nbytes = 4 * B * heads * T * D * 2
        t_bytes = nbytes / peak_bw * 1e3
        t_mma = 4 * B * heads * T * T * D / peak_bf16 * 1e3
        t_exp = B * heads * T * T / exp_rate * 1e3
        b_ms, b_by = bound(t_bytes, max(t_mma, t_exp))
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                         ("library_ms", lib_ms)):
            step[key] += per_step * val
        step["bytes" if b_by == "bytes" else "operations"] += per_step * b_ms
        shapes.append({"shape": shape, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": b_ms, "bound_by": b_by})
        log("attention", shape=f"{B}x{heads}x{T}x{D}", per_step=per_step, kernel_ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", library_ms=f"{lib_ms:.4f}", bound_ms=f"{b_ms:.5f}",
            bound_by=b_by, share_of_bound=f"{b_ms / ms:.3f}", bytes_ms=f"{t_bytes:.5f}",
            mma_ms=f"{t_mma:.5f}", exp_ms=f"{t_exp:.5f}")
    step["bound_by"] = "bytes" if step["bytes"] > step["operations"] else "operations"
    log("attention", per_musetalk_step="17 launches", kernel_ms=f"{step['ms']:.4f}",
        plain_ms=f"{step['plain_ms']:.4f}", library_ms=f"{step['library_ms']:.4f}",
        bound_ms=f"{step['bound_ms']:.4f}", bound_by=step["bound_by"],
        share_of_bound=f"{step['bound_ms'] / step['ms']:.3f}",
        max_abs_err_f32=err["float32"], max_abs_err_bf16=err["bfloat16"],
        bf16_margin_to_bar=-err["bf16_over_bar"])
    return {"max_abs_err": max(err["float32"], err["bfloat16"]), "step": step,
            "shapes": shapes}


def unet_conv_sites(sd_unet, cfg, px: int = 32) -> dict:
    """{(H, C, O): launches per step} of the U-Net's 3x3 stride-1 int8
    convs at latent size ``px`` (conv_in's 8 channels padded to 64)."""
    sites = collections.Counter()
    sites[(px, -(-cfg.in_channels // 64) * 64, cfg.block_out[0])] += 1  # conv_in
    h = px
    for blk in sd_unet._down_plan(cfg):
        for cin in blk["res_ins"]:
            sites[(h, cin, blk["out"])] += 1
            sites[(h, blk["out"], blk["out"])] += 1
        h //= 2 if blk["down"] else 1
    mid = cfg.block_out[-1]
    sites[(h, mid, mid)] += 4
    for blk in sd_unet._up_plan(cfg):
        for cin in blk["res_ins"]:
            sites[(h, cin, blk["out"])] += 1
            sites[(h, blk["out"], blk["out"])] += 1
        if blk["up"]:
            h *= 2
            sites[(h, blk["out"], blk["out"])] += 1
    sites[(h, cfg.block_out[0], cfg.out_channels)] += 1  # conv_out
    return dict(sites)


def vae_conv_sites(sd_vae, px: int = 32, fused: bool = False) -> tuple:
    """The int8 decoder's 3x3 convs at latent size ``px`` (mid resnets in
    int8, the final conv in bf16): ({(H, C, O): n} of kernel 4,
    {(H, C, O, upsample, gn, residual): n} of kernel 5). With ``fused`` the
    chain from block 0's upsampler to the end runs kernel 5."""
    ch = list(reversed(sd_vae.BLOCK_CH))
    k4, k5 = collections.Counter(), collections.Counter()
    k4[(px, ch[0], ch[0])] += 4
    cin, h = ch[0], px
    for i, cout in enumerate(ch):
        for j in range(3):
            c = cin if j == 0 else cout
            if fused and i > 0:
                k5[(h, c, cout, False, True, False)] += 1
                k5[(h, cout, cout, False, True, True)] += 1
            else:
                k4[(h, c, cout)] += 1
                k4[(h, cout, cout)] += 1
        cin = cout
        if i < len(ch) - 1:
            h *= 2
            if fused:
                k5[(h, cout, cout, True, False, False)] += 1
            else:
                k4[(h, cout, cout)] += 1
    return dict(k4), dict(k5)


def ulps_apart(torch, got, want) -> float:
    """Largest |got - want| in bf16 ulps of ``want``."""
    w = want.float()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
    return float(((got.float() - w).abs() / ulp).max())


def norm_against_plain(torch, got, want, x, scale, shift, beta, chunk: int = 1 << 25) -> tuple:
    """(share of elements within 1 bf16 ulp of ``want``, the largest
    |got - want| - ulp(max(|got|, |want|)) - 2^-16 (|x scale| + |mu scale| +
    |beta|)), in chunks (the largest tensors fill a quarter of the card in
    float32): moments summed in another order move the float32 affine by a
    part of its terms' sizes before it is rounded, not of its result (which
    cancels near 0). ``mu scale`` is ``beta - shift``."""
    def ulp(v):
        return torch.ldexp(torch.ones_like(v), torch.frexp(v).exponent - 8)

    C = x.shape[-1]
    g, w, xs = got.reshape(-1, C), want.reshape(-1, C), x.reshape(-1, C)
    rows, per_sample = max(1, chunk // C), x[0].numel() // C
    bf = beta.float()
    terms = ((bf - shift).abs() + bf.abs()) * 2.0 ** -16  # (B, C)
    within, excess = 0, float("-inf")
    for i in range(0, w.shape[0], rows):
        gf, wf, xf = g[i:i + rows].float(), w[i:i + rows].float(), xs[i:i + rows].float()
        bi = torch.arange(i, i + gf.shape[0], device=x.device) // per_sample
        diff = (gf - wf).abs()
        within += int((diff <= ulp(wf)).sum())
        excess = max(excess, float((diff - ulp(torch.maximum(gf.abs(), wf.abs()))
                                    - (xf * scale[bi]).abs() * 2.0 ** -16 - terms[bi]).max()))
    return within / w.numel(), excess


def device_ms(torch, fn, clock_hz: float, n: int = 20, reps: int = 3) -> float:
    """The card's own time per call of ``fn``: ``n`` calls queued behind
    ``torch.cuda._sleep``, long enough that the host has queued all ``n``
    before the card reaches them, one event pair around the ``n``; the
    median of ``reps`` such runs. A run whose queueing outlasted the sleep
    is repeated with a longer sleep."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sleep_s = 2 * (time.perf_counter() - t0) + 5e-4
    torch.cuda.synchronize()
    times = []
    while len(times) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_s * clock_hz))
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        queued = time.perf_counter() - t0
        end.synchronize()
        if queued > 0.8 * sleep_s:
            sleep_s *= 2
            continue
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def host_us_per_call(torch, fn, n: int = 100) -> float:
    """Host time per call of ``fn`` in microseconds: the host clock around
    ``n`` calls, then one synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def int8_gemm_ms(torch, xq, wq) -> float:
    """``torch._int_mm`` on the conv's (M, 9C) x (9C, O) product, the patch
    matrix built outside the timed region (O padded to a multiple of 8, as
    the GEMM asks). Context only: it leaves out the im2col and the epilogue."""
    from torch.nn import functional as F

    B, Hh, Ww, C = xq.shape
    O = wq.shape[0]
    xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
    patches = torch.cat([xp[:, dy:dy + Hh, dx:dx + Ww] for dy in range(3) for dx in range(3)],
                        dim=-1).reshape(B * Hh * Ww, 9 * C)
    w2 = wq.reshape(O, 9 * C)
    if O % 8:
        w2 = F.pad(w2, (0, 0, 0, 8 - O % 8))
    ms = cuda_ms(lambda: torch._int_mm(patches, w2.t()), warmup=3, iters=20)
    del patches, xp
    return ms


def phase_conv_int8(torch, conv, sd_unet, sd_vae, peak_bw: float, peak_int8: float,
                    clock_hz: float) -> dict:
    """Kernel 4 against its plain version at every 3x3 stride-1 int8 site
    of a B=16 step (U-Net, and the int8 decoder through the unfused route:
    80 launches), bf16 bit-equal; timed against its bound two ways: ``ms``
    (``cuda_ms``, an event pair around each call, host time included where
    the card waits for it) and ``device_ms`` (the card's own time per
    launch), with the kernel's split and block count, and as context only
    cuDNN's bf16 conv and ``torch._int_mm``'s int8 GEMM of the same shape.
    Sums per unfused step (80 sites) and per fused step (59: the U-Net's 49
    and the decoder's 10 at 32 px); the wrapper's host time per call at the
    4x4 site. The bf16 twin and the residual epilogue are checked at one VAE
    shape each. With a ``conv`` module that has no ``conv3x3_plan`` (an
    earlier kernel, measured in the same call for comparison) the split
    prints as n/a."""
    from torch.nn import functional as F

    B = 16
    k4, _ = vae_conv_sites(sd_vae)
    k4_fused, _ = vae_conv_sites(sd_vae, fused=True)
    unet = unet_conv_sites(sd_unet, sd_unet.MUSETALK)
    sites = collections.Counter(unet)
    sites.update(k4)
    fused = collections.Counter(unet)
    fused.update(k4_fused)
    if sum(sites.values()) != 80 or sum(fused.values()) != 59:
        raise AssertionError(f"{sum(sites.values())} int8 3x3 sites per unfused step (want 80), "
                             f"{sum(fused.values())} per fused step (want 59)")
    plan = getattr(conv, "conv3x3_plan", None)
    gen = torch.Generator(device="cuda").manual_seed(7)
    step = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "cudnn_bf16_ms": 0.0,
            "int8_gemm_ms": 0.0, "device_ms": 0.0, "bytes": 0.0, "operations": 0.0}
    fused_step = {"device_ms": 0.0, "ms": 0.0, "bound_ms": 0.0}
    host_us = None
    for (Hh, C, O), n in sorted(sites.items()):
        xq = torch.randint(-127, 128, (B, Hh, Hh, C), device="cuda", generator=gen,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (O, 3, 3, C), device="cuda", generator=gen,
                           dtype=torch.int8)
        scale = torch.rand(O, device="cuda", generator=gen) * 1.5e-4 + 5e-5
        bias = torch.randn(O, device="cuda", generator=gen)
        got = conv.conv3x3_q(xq, wq, scale, bias)
        want = conv.conv3x3_q_plain(xq, wq, scale, bias)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"conv3x3_q {(B, Hh, Hh, C, O)}: {ulps_apart(torch, got, want)} "
                                 "bf16 ulps from the plain version, want bit-equal")
        run = lambda: conv.conv3x3_q(xq, wq, scale, bias)  # noqa: E731
        ms = cuda_ms(run, warmup=3, iters=20)
        dev_ms = device_ms(torch, run, clock_hz)
        if Hh == 4 and host_us is None:
            host_us = host_us_per_call(torch, run)
            log("conv_int8", shape=f"{B}x{Hh}x{Hh}x{C}->{O}",
                wrapper_host_us_per_call=f"{host_us:.2f}")
        plain_ms = cuda_ms(lambda: conv.conv3x3_q_plain(xq, wq, scale, bias), warmup=1, iters=3)
        gemm_ms = int8_gemm_ms(torch, xq, wq)
        xb = torch.randn((B, C, Hh, Hh), device="cuda", generator=gen, dtype=torch.bfloat16)
        xb = xb.contiguous(memory_format=torch.channels_last)
        wb = torch.randn((O, C, 3, 3), device="cuda", generator=gen, dtype=torch.bfloat16)
        wb = wb.contiguous(memory_format=torch.channels_last)
        bb = bias.to(torch.bfloat16)
        cudnn_ms = cuda_ms(lambda: F.conv2d(xb, wb, bb, padding=1), warmup=3, iters=20)
        M = B * Hh * Hh
        nbytes = M * C + 9 * C * O + 8 * O + 2 * M * O
        ops = 2 * M * 9 * C * O
        b_ms, b_by = bound(nbytes / peak_bw * 1e3, ops / peak_int8 * 1e3)
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                         ("cudnn_bf16_ms", cudnn_ms), ("int8_gemm_ms", gemm_ms),
                         ("device_ms", dev_ms)):
            step[key] += n * val
        step[b_by] += n * b_ms
        nf = fused.get((Hh, C, O), 0)
        for key, val in (("device_ms", dev_ms), ("ms", ms), ("bound_ms", b_ms)):
            fused_step[key] += nf * val
        pl = plan(B, Hh, Hh, C, O) if plan else None
        log("conv_int8", shape=f"{B}x{Hh}x{Hh}x{C}->{O}", per_step=n, per_fused_step=nf,
            splits=pl.splits if pl else "n/a", units=pl.units if pl else "n/a",
            blocks=pl.grid if pl else "n/a", halo=pl.halo if pl else "n/a",
            bn=pl.bn if pl else "n/a", kernel_ms=f"{ms:.4f}", device_ms=f"{dev_ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.5f}", bound_by=b_by,
            share_of_bound=f"{b_ms / ms:.3f}", device_share_of_bound=f"{b_ms / dev_ms:.3f}",
            int8_gemm_ms=f"{gemm_ms:.4f}", cudnn_bf16_ms=f"{cudnn_ms:.4f}", bit_equal=True)
        del xq, wq, xb, wb, got, want, run
        torch.cuda.empty_cache()

    # the residual epilogue and the bf16 twin, at the 128 px 256-channel site
    Hh, C, O = 128, 256, 256
    xq = torch.randint(-127, 128, (B, Hh, Hh, C), device="cuda", generator=gen, dtype=torch.int8)
    wq = torch.randint(-127, 128, (O, 3, 3, C), device="cuda", generator=gen, dtype=torch.int8)
    scale = torch.full((O,), 1e-4, device="cuda")
    bias = torch.randn(O, device="cuda", generator=gen)
    res = torch.randn((B, Hh, Hh, O), device="cuda", generator=gen, dtype=torch.bfloat16)
    got = conv.conv3x3_q(xq, wq, scale, bias, residual=res)
    want = conv.conv3x3_q_plain(xq, wq, scale, bias, residual=res)
    # the bf16 twin: signed inputs at the reference's bars (rtol = atol =
    # 2e-2), and positive inputs, where no sum cancels, within 1 bf16 ulp:
    # its f32 sums run in another order than the plain conv's and may round
    # the last bf16 bit the other way (with cancellation an ulp of the
    # small result says nothing)
    x = (torch.randn((B, Hh, Hh, C), device="cuda", generator=gen) * 0.3).to(torch.bfloat16)
    w = (torch.randn((O, 3, 3, C), device="cuda", generator=gen) * 0.02).to(torch.bfloat16)
    got_bf = conv.conv3x3_bf16(x, w, bias)
    want_bf = conv.conv3x3_bf16_plain(x, w, bias)
    torch.cuda.synchronize()
    twin_err = float((got_bf.float() - want_bf.float()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"conv3x3_q with residual: {ulps_apart(torch, got, want)} ulps apart")
    over = float(((got_bf.float() - want_bf.float()).abs() - 2e-2
                  - 2e-2 * want_bf.float().abs()).max())
    xp, wp = x.abs(), w.abs()
    twin_ulps = ulps_apart(torch, conv.conv3x3_bf16(xp, wp, bias.abs()),
                           conv.conv3x3_bf16_plain(xp, wp, bias.abs()))
    if over > 0 or twin_ulps > 1:
        raise AssertionError(f"conv3x3_bf16: signed inputs {over} over rtol/atol 2e-2, "
                             f"positive inputs {twin_ulps} bf16 ulps apart (bar 1)")
    twin_ms = cuda_ms(lambda: conv.conv3x3_bf16(x, w, bias), warmup=3, iters=20)
    log("conv_int8", residual_bit_equal=True, bf16_twin_max_abs_err=twin_err,
        bf16_twin_positive_max_ulps=twin_ulps,
        bf16_twin_ms=f"{twin_ms:.4f}", bf16_twin_shape=f"{B}x{Hh}x{Hh}x{C}->{O}")
    step["bound_by"] = "bytes" if step["bytes"] > step["operations"] else "operations"
    log("conv_int8", per_musetalk_int8_step="80 launches", kernel_ms=f"{step['ms']:.4f}",
        device_ms=f"{step['device_ms']:.4f}", plain_ms=f"{step['plain_ms']:.4f}",
        bound_ms=f"{step['bound_ms']:.4f}", bound_by=step["bound_by"],
        share_of_bound=f"{step['bound_ms'] / step['ms']:.3f}",
        device_share_of_bound=f"{step['bound_ms'] / step['device_ms']:.3f}",
        cudnn_bf16_ms=f"{step['cudnn_bf16_ms']:.4f}",
        int8_gemm_ms=f"{step['int8_gemm_ms']:.4f}", library_ms=NO_INT8_CONV)
    log("conv_int8", per_fused_int8_step="59 launches", kernel_ms=f"{fused_step['ms']:.4f}",
        device_ms=f"{fused_step['device_ms']:.4f}", bound_ms=f"{fused_step['bound_ms']:.4f}",
        device_share_of_bound=f"{fused_step['bound_ms'] / fused_step['device_ms']:.3f}",
        wrapper_host_us_per_call_4x4=f"{host_us:.2f}")
    return {"max_abs_err": 0.0, "step": step, "fused_step": fused_step}


def phase_gnq(torch, conv, sd_vae, peak_bw: float, peak_f32: float, peak_int8: float) -> dict:
    """Kernel 5 against its plain version at every chain site of a B=16
    fused int8 decode (21 launches) at the reference test's bars: y within
    atol max(2e-2, 4 max out_scale) + rtol 1e-2, the moments within rtol
    1e-3 + atol 1e-2 H W; timed against its bound."""
    B = 16
    _, k5 = vae_conv_sites(sd_vae, fused=True)
    if sum(k5.values()) != 21:
        raise AssertionError(f"{sum(k5.values())} fused chain sites, want 21")
    gen = torch.Generator(device="cuda").manual_seed(8)
    step = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0.0, "operations": 0.0}
    worst = {"y": 0.0, "s": 0.0, "y_mismatch": 0}
    for (Hh, C, O, up, gn, has_res), n in sorted(k5.items()):
        Hs = Hh // 2 if up else Hh
        x = torch.randn((B, Hs, Hs, C), device="cuda", generator=gen).to(torch.bfloat16)
        gns = torch.rand((B, C), device="cuda", generator=gen) + 0.5 if gn else None
        gnb = torch.randn((B, C), device="cuda", generator=gen) * 0.2 if gn else None
        act = torch.tensor(0.011 if gn else 0.012, device="cuda")
        wq = torch.randint(-127, 128, (O, 3, 3, C), device="cuda", generator=gen,
                           dtype=torch.int8)
        osc = torch.rand(O, device="cuda", generator=gen) * 1.5e-4 + 5e-5
        bias = torch.randn(O, device="cuda", generator=gen) * 0.1
        res = (torch.randn((B, Hh, Hh, O), device="cuda", generator=gen).to(torch.bfloat16)
               if has_res else None)
        args = (x, gns, gnb, act, wq, osc, bias, res)
        y, s1, s2 = conv.conv3x3_gnq(*args, upsample=up)
        yr, s1r, s2r = conv.conv3x3_gnq_plain(*args, upsample=up)
        torch.cuda.synchronize()
        atol = max(2e-2, 4 * float(osc.max()))
        over_y = float(((y.float() - yr.float()).abs() - atol - 1e-2 * yr.float().abs()).max())
        over_s = max(float(((a - b).abs() - 1e-2 * Hh * Hh - 1e-3 * b.abs()).max())
                     for a, b in ((s1, s1r), (s2, s2r)))
        mismatch = int((y != yr).sum())
        if over_y > 0 or over_s > 0:
            raise AssertionError(f"conv3x3_gnq {(B, Hh, C, O, up, gn, has_res)}: y over its bar "
                                 f"by {over_y}, moments by {over_s}")
        worst = {"y": max(worst["y"], float((y.float() - yr.float()).abs().max())),
                 "s": max(worst["s"], over_s), "y_mismatch": worst["y_mismatch"] + mismatch}
        ms = cuda_ms(lambda: conv.conv3x3_gnq(*args, upsample=up), warmup=3, iters=20)
        plain_ms = cuda_ms(lambda: conv.conv3x3_gnq_plain(*args, upsample=up), warmup=1, iters=3)
        M = B * Hh * Hh
        n_in = B * Hs * Hs * C
        nbytes = (2 * n_in + (8 * B * C if gn else 0) + 4 + 9 * C * O + 8 * O + 2 * M * O
                  + (2 * M * O if has_res else 0) + 8 * B * O)
        # int8 products on the tensor cores, then about 8 f32 operations per
        # input element with GroupNorm + SiLU (2 + 4, quantize 2), 2 without
        t_ops = (2 * M * 9 * C * O / peak_int8 + (8 if gn else 2) * n_in / peak_f32) * 1e3
        b_ms, b_by = bound(nbytes / peak_bw * 1e3, t_ops)
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms)):
            step[key] += n * val
        step[b_by] += n * b_ms
        log("gnq", shape=f"{B}x{Hh}x{Hh}x{C}->{O}", upsample=up, gn=gn, residual=has_res,
            per_step=n, kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{b_ms:.5f}", bound_by=b_by, share_of_bound=f"{b_ms / ms:.3f}",
            y_max_abs_err=f"{float((y.float() - yr.float()).abs().max()):.3g}",
            y_elements_differing=mismatch)
        del args, x, res, y, yr
        torch.cuda.empty_cache()
    step["bound_by"] = "bytes" if step["bytes"] > step["operations"] else "operations"
    log("gnq", per_fused_decode="21 launches", kernel_ms=f"{step['ms']:.4f}",
        plain_ms=f"{step['plain_ms']:.4f}", bound_ms=f"{step['bound_ms']:.4f}",
        bound_by=step["bound_by"], y_max_abs_err=worst["y"],
        y_elements_differing=worst["y_mismatch"], library_ms=NO_INT8_CONV)
    return {"max_abs_err": worst["y"], "step": step}


def psnr_u8(a, b) -> float:
    """PSNR in dB of two uint8 image batches (peak 255)."""
    mse = float(((a.double() - b.double()) ** 2).mean())
    return float(10.0 * np.log10(255.0 ** 2 / max(mse, 1e-12)))


def psnr_unit(a, b) -> float:
    """PSNR in dB of two image batches in [0, 1]."""
    mse = float(((a.double() - b.double()) ** 2).mean())
    return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))


def check_fused_decode(torch, sd_vae, vae_params) -> float:
    """The reference's own check of the fused route
    (tests/test_pallas_conv.py::test_fused_decode_matches_xla_path) on the
    served decoder: every site int8 (no bf16 epilogue), calibrated on one
    8x8 noise latent (numpy seed 4), the kernel-5 chain from the mid-block
    output against the unfused route; f32 images, PSNR > 35 dB."""
    z = np.random.default_rng(4).standard_normal((1, 8, 8, 4)).astype(np.float32)
    z = torch.from_numpy(z * sd_vae.SCALING_FACTOR).cuda()
    vq = sd_vae.calibrate_decoder(
        vae_params, sd_vae.quantize_decoder(vae_params, bf16_epilogue=False), z)
    with torch.inference_mode():
        want = sd_vae.decode_int8(vq, z)  # LT_FUSED_VAE unset: unfused
        got = sd_vae._decode_int8_fused(vq, sd_vae._decode_int8_mid(vq, z))
    db = psnr_unit(got, want)
    if not db > FUSED_REF_DB:
        raise AssertionError(f"fused decode (reference setting) {db:.3f} dB from the "
                             f"unfused route, want > {FUSED_REF_DB}")
    return db


def phase_musetalk_int8_model(torch, muse, mt, conv, attn, wf, synthetic, sd_vae) -> dict:
    """The B=16 int8 step (both flags, the reference's int8 defaults) on
    the synthetic avatar's latents, quantized and calibrated as a first
    session does (``session_params``), with Whisper features from the
    model's encoder: the unfused route (kernel 4 at all 80 int8 3x3 sites)
    and the fused one (``LT_FUSED_VAE=1``: 59 kernel-4 and 21 kernel-5
    launches). Fused against unfused: > 35 dB in the reference's own
    setting (``check_fused_decode``), > 30 dB at the served shapes; int8
    against the bf16 step >= 24 dB (tests/test_int8_quality.py's
    end-to-end bar); step times of both routes beside the bf16 step's, on
    the same inputs."""
    from livetalking_tpu_torch.config import default_opt

    B = 16
    opt = default_opt(model="musetalk", dtype="bfloat16", device="cuda", vae_int8=True,
                      unet_int8=True)
    model = muse.load_model(opt)
    a = synthetic.musetalk_avatar_arrays(n_frames=8, frame_hw=(H, W), seed=40)
    avatar = muse.avatar_from_arrays("int8_model", a["frames"], a["faces"], a["coords"],
                                     a["mask_coords"], a["masks"], model["vae_params"],
                                     device="cuda")
    lat = avatar["latent_cycle_device"]
    os.environ.pop("LT_FUSED_VAE", None)
    ref_db = check_fused_decode(torch, sd_vae, model["vae_params"])
    t0 = time.time()
    uq, vq = muse.session_params(model, opt, lat)
    torch.cuda.synchronize()
    t_cal = time.time() - t0
    rng = np.random.default_rng(41)
    factory, n_samples = wf.make_batched_encode_factory(
        model["whisper_params"], model["whisper_cfg"], batch_size=B, l=10, r=10, device="cuda")
    wav = (0.1 * rng.standard_normal((1, n_samples))).astype(np.float32)
    feats = factory(1)(wav)[0]
    ix = torch.from_numpy(rng.integers(0, lat.shape[0], (B,)).astype(np.int32)).cuda()

    bf_step = mt.make_infer_fn(model["unet_cfg"], B, dtype=torch.bfloat16)
    q_step = mt.make_infer_fn(model["unet_cfg"], B, dtype=torch.bfloat16, vae_int8=True,
                              unet_int8=True)
    runs = {
        "bf16": lambda: bf_step(model["unet_params"], model["vae_params"], lat, ix, feats),
        "int8": lambda: q_step(uq, vq, lat, ix, feats),
    }
    want_k4 = {"bf16": 0, "int8": 80, "int8_fused": 59}
    want_k5 = {"bf16": 0, "int8": 0, "int8_fused": 21}
    out, ms = {}, {}
    for route in ("bf16", "int8", "int8_fused"):
        run = runs["int8" if route == "int8_fused" else route]
        os.environ["LT_FUSED_VAE"] = "1" if route == "int8_fused" else "0"
        try:
            before = (conv.conv3x3_q.launches, conv.conv3x3_gnq.launches,
                      attn.attention.launches)
            out[route] = run()
            torch.cuda.synchronize()
            k4, k5, at = (conv.conv3x3_q.launches - before[0],
                          conv.conv3x3_gnq.launches - before[1],
                          attn.attention.launches - before[2])
            if (k4, k5, at) != (want_k4[route], want_k5[route], 17):
                raise AssertionError(f"{route} step: {k4} conv3x3_q, {k5} conv3x3_gnq, {at} "
                                     f"attention launches; want {want_k4[route]}, "
                                     f"{want_k5[route]}, 17")
            o = out[route]
            if tuple(o.shape) != (B, S, S, 3) or o.dtype != torch.uint8:
                raise AssertionError(f"{route} step: output {tuple(o.shape)} {o.dtype}")
            ms[route] = cuda_ms(run, warmup=2, iters=10)
        finally:
            os.environ.pop("LT_FUSED_VAE", None)
    log("musetalk_int8_model", B=B, calibrate_s=f"{t_cal:.2f}",
        **{f"{r}_step_ms": f"{ms[r]:.3f}" for r in ms},
        **{f"{r}_inferfps": f"{B / ms[r] * 1e3:.1f}" for r in ms},
        conv3x3_q_per_step="80 unfused, 59 fused", conv3x3_gnq_per_step="0 unfused, 21 fused")
    # the served decoder on what it was calibrated for: the avatar's
    # reference-face latents of this batch, through both routes
    zc = lat.index_select(0, ix)[..., 4:].contiguous()
    dec = {}
    with torch.inference_mode():
        for fused in ("0", "1"):
            os.environ["LT_FUSED_VAE"] = fused
            dec[fused] = sd_vae.decode_int8(vq, zc)
    os.environ.pop("LT_FUSED_VAE", None)
    dec_db = psnr_unit(dec["1"], dec["0"])
    fused_vs_unfused = psnr_u8(out["int8_fused"], out["int8"])
    int8_vs_bf16 = psnr_u8(out["int8"], out["bf16"])
    fused_vs_bf16 = psnr_u8(out["int8_fused"], out["bf16"])
    log("musetalk_int8_model", psnr_fused_vs_unfused_reference_setting_db=f"{ref_db:.4f}",
        psnr_fused_vs_unfused_avatar_latents_db=f"{dec_db:.4f}",
        psnr_fused_vs_unfused_step_db=f"{fused_vs_unfused:.4f}",
        psnr_int8_vs_bf16_db=f"{int8_vs_bf16:.4f}", psnr_fused_vs_bf16_db=f"{fused_vs_bf16:.4f}")
    # the reference holds the routes to > 35 dB in its own setting only (8x8
    # noise latents, checked above). At the served 32x32 latents they
    # measured 33.5 dB on the avatar's latents and 34.1 dB on the step (H100
    # 80GB HBM3, 700 W): each route quantizes a differently rounded
    # activation (f32 against bf16), and every int8 level that flips
    # carries on through the later convs. So the served shapes are held to
    # 30 dB, 6 dB above the int8 vs bf16 bar
    if not (dec_db > FUSED_SERVED_DB and fused_vs_unfused > FUSED_SERVED_DB
            and int8_vs_bf16 >= INT8_E2E_DB and fused_vs_bf16 >= INT8_E2E_DB):
        raise AssertionError(f"int8 quality: fused vs unfused {dec_db:.2f} dB on the avatar "
                             f"latents, {fused_vs_unfused:.2f} dB on the step (bar > "
                             f"{FUSED_SERVED_DB}); int8 vs bf16 {int8_vs_bf16:.2f}, fused vs "
                             f"bf16 {fused_vs_bf16:.2f} dB (bar >= {INT8_E2E_DB})")
    os.environ["LT_FUSED_VAE"] = "1"
    try:
        profile_step(torch, runs["int8"], steps=3, step_ms=ms["int8_fused"])
    finally:
        os.environ.pop("LT_FUSED_VAE", None)
    del model, uq, vq, out
    torch.cuda.empty_cache()
    return ms


def phase_model(torch, w2l) -> dict:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(2)
    cycle = torch.from_numpy(rng.integers(0, 256, (4, S, S, 3), dtype=np.uint8))
    idxs = torch.tensor([0, 3])
    mel = torch.from_numpy(np.clip(rng.standard_normal((2, 80, 16)), -4, 4).astype(np.float32))
    base = w2l.init_model(seed=0)
    cpu_net = w2l.prepare(base, "cpu", torch.float32)
    want = w2l.make_infer_fn(2, S, torch.float32)(cpu_net, cycle, idxs, mel)
    gpu_net = w2l.prepare(w2l.init_model(seed=0), "cuda", torch.float32)
    got = w2l.make_infer_fn(2, S, torch.float32)(gpu_net, cycle.cuda(), idxs.cuda(), mel.cuda()).cpu()
    diff = (got.int() - want.int()).abs()
    unsat = float(((want > 0) & (want < 255)).float().mean())
    if int(diff.max()) > TOL_LSB:
        raise AssertionError(f"fp32 step on the card differs from the CPU by {int(diff.max())} LSB")
    bf_net = w2l.prepare(w2l.init_model(seed=0), "cuda", torch.bfloat16)
    bf = w2l.make_infer_fn(2, S, torch.bfloat16)(bf_net, cycle.cuda(), idxs.cuda(), mel.cuda()).cpu()
    bdiff = (bf.int() - want.int()).abs().float()
    log("model", fp32_card_vs_cpu_max_lsb=int(diff.max()), unsaturated_share=f"{unsat:.3f}",
        bf16_vs_fp32_max_lsb=int(bdiff.max()), bf16_vs_fp32_mean_lsb=f"{float(bdiff.mean()):.3f}")
    torch.backends.cudnn.allow_tf32 = True

    B = 16
    cyc = torch.from_numpy(rng.integers(0, 256, (32, S, S, 3), dtype=np.uint8)).cuda()
    ix = torch.from_numpy(rng.integers(0, 32, (B,))).cuda()
    m = torch.from_numpy(np.clip(rng.standard_normal((B, 80, 16)), -4, 4).astype(np.float32)).cuda()
    step = w2l.make_infer_fn(B, S, torch.bfloat16)
    ms = cuda_ms(lambda: step(bf_net, cyc, ix, m), warmup=3, iters=20)
    log("model", B=B, dtype="bfloat16", step_ms=f"{ms:.3f}", inferfps=f"{B / ms * 1e3:.1f}")
    return {"step_ms": ms}


def profile_step(torch, run, steps: int, step_ms: float, tag: str = "profile") -> dict:
    """Device time of ``steps`` runs by kernel (torch.profiler, kernel
    events only), the top entries, and the kernels' busy share of the step
    time ``step_ms`` measured without the profiler; logged under ``tag`` and
    returned."""
    from torch.autograd import DeviceType

    def runs():
        for _ in range(steps):
            run()

    prof = traced(torch, runs)
    # kernels only: a ``record_function`` range (``Optimizer.step#AdamW.step``)
    # also shows on the device timeline, over the kernels it encloses
    rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count // steps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    log(tag, steps=steps, kernel_ms_per_step=f"{total:.3f}", step_ms=f"{step_ms:.3f}",
        device_busy_share=f"{total / step_ms:.3f}",
        launches_per_step=sum(r[2] for r in rows))
    for key, t, n in rows[:12]:
        log(tag, kernel=json.dumps(key[:90]), ms_per_step=f"{t:.3f}",
            share=f"{t / max(total, 1e-9):.3f}", calls_per_step=n)
    return {"kernel_ms": total, "busy_share": total / step_ms}


def record_norm_sites(norm, run) -> dict:
    """{(H, W, C, groups, eps, silu): calls} of kernel 6 in one ``run()``,
    read by a wrapper around ``norm._launch`` (the kernel pair's launch,
    which ``norm.group_norm`` looks up on the module at each call)."""
    sites = collections.Counter()
    launch = norm._launch

    def recording(x, gamma, beta, groups, eps, silu):
        sites[(x.shape[1], x.shape[2], x.shape[3], groups, float(eps), bool(silu))] += 1
        return launch(x, gamma, beta, groups, eps, silu)

    norm._launch = recording
    try:
        run()
    finally:
        norm._launch = launch
    return dict(sites)


def phase_musetalk_model(torch, muse, mt, attn, norm, wf) -> dict:
    """The fp32 step on the card against the CPU, the bf16 step's time,
    launches and profile, kernel 6's sites in it (returned), the batched
    Whisper encode."""
    from livetalking_tpu_torch.config import default_opt

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(4)
    lat = torch.from_numpy(rng.standard_normal((4, 32, 32, 8)).astype(np.float32))
    idxs = torch.tensor([2], dtype=torch.int32)
    feats = torch.from_numpy(rng.standard_normal((1, 50, 384)).astype(np.float32))
    t0 = time.time()
    cpu = muse.load_model(default_opt(model="musetalk", dtype="float32", device="cpu"))
    want = mt.make_infer_fn(cpu["unet_cfg"], 1, dtype=torch.float32)(
        cpu["unet_params"], cpu["vae_params"], lat, idxs, feats)
    t_cpu = time.time() - t0
    del cpu
    gpu = muse.load_model(default_opt(model="musetalk", dtype="float32", device="cuda"))
    got = mt.make_infer_fn(gpu["unet_cfg"], 1, dtype=torch.float32)(
        gpu["unet_params"], gpu["vae_params"], lat.cuda(), idxs.cuda(), feats.cuda()).cpu()
    del gpu
    diff = (got.int() - want.int()).abs()
    unsat = float(((want > 0) & (want < 255)).float().mean())
    if int(diff.max()) > TOL_LSB:
        raise AssertionError(f"fp32 MuseTalk step on the card differs from the CPU by "
                             f"{int(diff.max())} LSB")
    log("musetalk_model", fp32_card_vs_cpu_max_lsb=int(diff.max()),
        unsaturated_share=f"{unsat:.3f}", cpu_build_and_step_s=f"{t_cpu:.1f}")
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()

    model = muse.load_model(default_opt(model="musetalk", dtype="bfloat16", device="cuda"))
    B = 16
    cyc = torch.from_numpy(rng.standard_normal((32, 32, 32, 8)).astype(np.float32)).cuda()
    ix = torch.from_numpy(rng.integers(0, 32, (B,)).astype(np.int32)).cuda()
    wh = torch.from_numpy(rng.standard_normal((B, 50, 384)).astype(np.float32)).cuda()
    step = mt.make_infer_fn(model["unet_cfg"], B, dtype=torch.bfloat16)
    run = lambda: step(model["unet_params"], model["vae_params"], cyc, ix, wh)  # noqa: E731
    before = attn.attention.launches, norm.group_norm.launches
    out = run()
    torch.cuda.synchronize()
    per_step = attn.attention.launches - before[0]
    norm_per_step = norm.group_norm.launches - before[1]
    if per_step != 17 or tuple(out.shape) != (B, S, S, 3) or out.dtype != torch.uint8:
        raise AssertionError(f"bf16 step: {per_step} attention launches (want 17), "
                             f"output {tuple(out.shape)} {out.dtype}")
    norm_sites = record_norm_sites(norm, run)
    if norm_per_step != NORM_SITES_BF16 or sum(norm_sites.values()) != NORM_SITES_BF16:
        raise AssertionError(f"bf16 step: {norm_per_step} group_norm calls "
                             f"({sum(norm_sites.values())} recorded), want {NORM_SITES_BF16}")
    ms = cuda_ms(run, warmup=3, iters=20)
    log("musetalk_model", B=B, dtype="bfloat16", step_ms=f"{ms:.3f}",
        inferfps=f"{B / ms * 1e3:.1f}", attention_launches_per_step=per_step,
        group_norm_calls_per_step=norm_per_step)
    profile_step(torch, run, steps=3, step_ms=ms)

    enc = {}
    for short in (False, True):
        factory, n_samples = wf.make_batched_encode_factory(
            model["whisper_params"], model["whisper_cfg"], batch_size=B, l=10, r=10,
            short_window=short, device="cuda")
        for k in (1, 2):
            fn = factory(k)
            wav = (0.1 * rng.standard_normal((k, n_samples))).astype(np.float32)
            rows = fn(wav)
            if tuple(rows.shape) != (k, B, 50, 384) or not bool(torch.isfinite(rows).all()):
                raise AssertionError(f"whisper encode k={k}: {tuple(rows.shape)}")
            enc[(short, k)] = cuda_ms(lambda: fn(wav), warmup=3, iters=20)
            log("musetalk_model", whisper_encode_k=k, short_window=short,
                ms=f"{enc[(short, k)]:.3f}")
    del model
    torch.cuda.empty_cache()
    return {"step_ms": ms, "encode_ms": enc, "norm_sites": norm_sites}


def phase_norm(torch, norm, sites: dict, peak_bw: float, clock_hz: float) -> dict:
    """Kernel 6 against its plain version at every site of the bf16 step
    (``sites``, as ``record_norm_sites`` read them), at B=16 and B=128: at
    most 1 bf16 ulp apart on 99.9% of the elements; the normalized values
    within 1 ulp plus 2^-16 of the affine's terms (``norm_against_plain``);
    SiLU's output PyTorch's SiLU of them bit for bit; the same bits from a
    second launch. Timed by ``device_ms`` against its bound (x read and y
    written once in bf16, 4 bytes an element) and by the 6 bytes an element
    the two launches move (x read twice); the plain version's time; as
    context, the library's (``F.group_norm`` on the NCHW view, then
    ``F.silu`` at SiLU sites: the same function, rounded otherwise); sums
    per step of each B."""
    from torch.nn import functional as F

    steps = {}
    worst = float("-inf")
    for B in (16, 128):
        step = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                "bound_ms": 0.0}
        for (Hh, Ww, C, groups, eps, silu), n in sorted(sites.items()):
            gen = torch.Generator(device="cuda").manual_seed(Hh * 7 + C + B)
            x = (torch.randn((B, Hh, Ww, C), device="cuda", generator=gen) * 1.5
                 + 0.3).to(torch.bfloat16)
            g = (torch.rand(C, device="cuda", generator=gen) + 0.5).to(torch.bfloat16)
            b = (torch.randn(C, device="cuda", generator=gen) * 0.3).to(torch.bfloat16)
            call = functools.partial(norm.group_norm, x, g, b, groups, eps, silu=silu)
            got = call()
            if not torch.equal(got, call()):
                raise AssertionError(f"group_norm {(B, Hh, Ww, C, silu)}: two launches differ")
            pre = norm.group_norm(x, g, b, groups, eps) if silu else got
            if silu and not torch.equal(got, F.silu(pre.float()).to(torch.bfloat16)):
                raise AssertionError(f"group_norm {(B, Hh, Ww, C)}: SiLU output is not the "
                                     "plain SiLU of the kernel's normalized values")
            xf = x.float()
            scale, shift = norm.affine_from_moments(xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2)),
                                                    g, b, Hh * Ww, groups, eps)
            del xf
            _, excess = norm_against_plain(torch, pre, norm.group_norm_plain(x, g, b, groups, eps),
                                           x, scale, shift, b)
            del pre
            within_one, _ = norm_against_plain(
                torch, got, norm.group_norm_plain(x, g, b, groups, eps, silu=silu), x, scale,
                shift, b)
            del got
            if within_one < 0.999 or excess > 0:
                raise AssertionError(f"group_norm {(B, Hh, Ww, C, silu)}: {within_one:.6f} of "
                                     f"the elements within 1 ulp, the normalized values "
                                     f"{excess} over 1 ulp + 2^-16 of the affine's terms")
            worst = max(worst, excess)
            ms = cuda_ms(call, warmup=3, iters=20)
            dms = device_ms(torch, call, clock_hz)
            plain_ms = cuda_ms(functools.partial(norm.group_norm_plain, x, g, b, groups, eps,
                                                 silu=silu), warmup=1, iters=3)

            def library(x=x, g=g, b=b, groups=groups, eps=eps, silu=silu):
                y = F.group_norm(x.permute(0, 3, 1, 2), groups, g, b, eps)
                return F.silu(y) if silu else y

            library_ms = cuda_ms(library, warmup=3, iters=20)
            elements = B * Hh * Ww * C
            bound_ms = 4 * elements / peak_bw * 1e3
            for key, val in (("ms", ms), ("device_ms", dms), ("plain_ms", plain_ms),
                             ("library_ms", library_ms), ("bound_ms", bound_ms)):
                step[key] += n * val
            log("norm", shape=f"{B}x{Hh}x{Ww}x{C}", silu=silu, per_step=n,
                kernel_ms=f"{ms:.4f}", device_ms=f"{dms:.4f}", plain_ms=f"{plain_ms:.4f}",
                library_ms=f"{library_ms:.4f}", bound_ms=f"{bound_ms:.5f}",
                share_of_bound=f"{bound_ms / dms:.3f}",
                tb_per_s_at_6_bytes=f"{6 * elements / dms / 1e9:.3f}",
                within_1_ulp=f"{within_one:.6f}", excess_over_bound=f"{excess:.3g}")
            del x
            torch.cuda.empty_cache()
        log("norm", B=B, per_bf16_step=f"{sum(sites.values())} calls",
            kernel_ms=f"{step['ms']:.4f}", device_ms=f"{step['device_ms']:.4f}",
            plain_ms=f"{step['plain_ms']:.4f}", library_ms=f"{step['library_ms']:.4f}",
            bound_ms=f"{step['bound_ms']:.4f}",
            share_of_bound=f"{step['bound_ms'] / step['device_ms']:.3f}")
        steps[B] = step
    return {"max_excess": worst, "steps": steps}


@contextlib.contextmanager
def open_sessions(app, session_manager, avatar_ids):
    """One session per avatar, each with its render thread; stopped and
    removed on exit."""
    sids = []
    try:
        for avatar in avatar_ids:
            sid = asyncio.run(session_manager.create_session({"avatar": avatar}))
            sids.append(sid)
            app.start_render_thread(sid)
        yield [session_manager.get_session(s) for s in sids]
    finally:
        for sid in sids:
            app.stop_render_thread(sid, timeout=15)
            session_manager.remove_session(sid)


def speech_classifier(app, avatar_ids, box):
    """``is_speech(k, frame)``: the frame must match one of avatar k's frames
    outside ``box`` (x1, y1, x2, y2) and the watermark rows; True when it
    differs from that frame inside the box."""
    x1, y1, x2, y2 = box
    keep = np.ones((H, W), bool)
    keep[y1:y2, x1:x2] = False
    keep[:32] = False  # the watermark
    by_outside = [{c[keep].tobytes(): c for c in app.global_avatars[a]["frame_list_cycle"]}
                  for a in avatar_ids]

    def is_speech(k: int, f: np.ndarray) -> bool:
        if f.shape != (H, W, 3) or f.dtype != np.uint8:
            raise AssertionError(f"session {k}: frame {f.shape} {f.dtype}")
        idle = by_outside[k].get(f[keep].tobytes())
        if idle is None:
            raise AssertionError(f"session {k}: a frame matches no avatar frame "
                                 "outside the face box")
        return not np.array_equal(idle[y1:y2, x1:x2], f[y1:y2, x1:x2])

    return is_speech


def drive_sessions(app, session_manager, plugin, avatar_ids, box, watch) -> dict:
    """Free-running sessions, one per avatar, text in, full frames out. Runs
    until each said at least 32 speech frames, stopped speaking, and the
    plugin's shared scheduler (made by the first session), where it has
    one, resolved every request. ``watch()`` is read after."""
    is_speech = speech_classifier(app, avatar_ids, box)
    n = len(avatar_ids)
    with open_sessions(app, session_manager, avatar_ids) as sessions:
        sched = getattr(plugin, "_shared", {}).get("scheduler")
        for k, s in enumerate(sessions):
            s.put_msg_txt(f"session {k} reads a sentence long enough for many batches of frames.")
        speech, frames = [0] * n, [0] * n
        t_first, t_last = [None] * n, [None] * n
        deadline = time.time() + 240
        while time.time() < deadline:
            if (min(speech) >= 32 and not any(s.is_speaking() for s in sessions)
                    and (sched is None or sched.requests_run == sched.requests_submitted)):
                break
            for k, s in enumerate(sessions):
                try:
                    f = s.output.video_queue.get(timeout=0.01)
                except queue.Empty:
                    continue
                frames[k] += 1
                if is_speech(k, f):
                    speech[k] += 1
                    t_first[k] = t_first[k] or time.time()
                    t_last[k] = time.time()
        counts = watch()
    if min(speech) < 32:
        raise AssertionError(f"speech frames per session {speech} < 32 within the time limit")
    r = {"speech": speech, "frames": frames, "counts": counts, "sched": sched,
         "fps": [speech[k] / max(t_last[k] - t_first[k], 1e-9) for k in range(n)]}
    if sched is None:
        return r
    if sched.requests_run != sched.requests_submitted or sched.requests_run == 0:
        raise AssertionError(f"scheduler resolved {sched.requests_run} of "
                             f"{sched.requests_submitted} requests submitted")
    lat = np.asarray(sched.latency_s) * 1e3
    return {**r, "latency_p50_ms": float(np.percentile(lat, 50)),
            "mean_coalesced": float(np.mean(sched.batch_sizes))}


def phase_engine(torch, app, plugin, blend, session_manager) -> dict:
    from livetalking_tpu_torch.config import default_opt

    app.global_avatars["smoke_a"] = make_avatar(plugin, "smoke_a", 8, 10, "cuda")
    app.global_avatars["smoke_b"] = make_avatar(plugin, "smoke_b", 10, 11, "cuda")
    opt = default_opt(model="wav2lip", transport="queue", tts="dummy", coalesce=True,
                      device_paste_back=True, batch_size=16, device="cuda",
                      avatar_id="smoke_a", max_session=2, modelfile="")
    t0 = time.time()
    app.load_plugin_stack(opt)
    log("engine", load_plugin_stack_s=f"{time.time() - t0:.2f}")
    try:
        # the main path starts here: every kernel count from 0
        blend.blend_rect_.launches = 0
        y1, y2, x1, x2 = BOX
        r = drive_sessions(app, session_manager, plugin, ("smoke_a", "smoke_b"),
                           (x1, y1, x2, y2), lambda: {"blend": blend.blend_rect_.launches})
        launches, sched = r["counts"]["blend"], r["sched"]
        if launches < sched.batches_run or sched.batches_run == 0:
            raise AssertionError(f"blend launches {launches} < scheduler batches {sched.batches_run}")
        log("engine", sessions=2, speech_frames=r["speech"], frames=r["frames"],
            speech_fps_per_session=[f"{v:.1f}" for v in r["fps"]],
            batches_run=sched.batches_run, requests_run=sched.requests_run,
            requests_submitted=sched.requests_submitted,
            mean_coalesced=f"{r['mean_coalesced']:.2f}",
            latency_p50_ms=f"{r['latency_p50_ms']:.1f}", blend_launches=launches)
        return {"launches": launches}
    finally:
        plugin.reset_shared_scheduler()


def phase_musetalk_engine(torch, app, muse, blend, attn, conv, norm, synthetic, sd_vae,
                          session_manager, int8: bool = False) -> dict:
    """Two coalesced MuseTalk sessions on avatars encoded on the card: every
    bf16 step runs 91 kernel-6 calls; with ``int8``, ``--vae_int8
    --unet_int8`` and ``LT_FUSED_VAE=1``, the first session quantizes and
    calibrates, and every step runs 59 kernel-4, 21 kernel-5 and 72
    kernel-6 launches."""
    from livetalking_tpu_torch.config import default_opt

    phase = "musetalk_int8_engine" if int8 else "musetalk_engine"
    # the avatars' latents come from the same VAE (seed 1) the server loads
    vae = sd_vae.init_params(1, torch.bfloat16, "cuda")
    boxes, ids = [], (("smoke_qa", "smoke_qb") if int8 else ("smoke_ma", "smoke_mb"))
    for avatar_id, n, seed in ((ids[0], 8, 20), (ids[1], 10, 21)):
        a = synthetic.musetalk_avatar_arrays(n_frames=n, frame_hw=(H, W), seed=seed)
        app.global_avatars[avatar_id] = muse.avatar_from_arrays(
            avatar_id, a["frames"], a["faces"], a["coords"], a["mask_coords"], a["masks"],
            vae, device="cuda")
        boxes.append(a["mask_coords"][0])
    del vae
    opt = default_opt(model="musetalk", transport="queue", tts="dummy", coalesce=True,
                      device_paste_back=True, batch_size=16, device="cuda",
                      avatar_id=ids[0], max_session=2, vae_int8=int8, unet_int8=int8)
    if int8:
        os.environ["LT_FUSED_VAE"] = "1"
    try:
        t0 = time.time()
        app.load_plugin_stack(opt)
        log(phase, load_plugin_stack_s=f"{time.time() - t0:.2f}")
        # the main path starts here: every kernel count from 0
        attn.attention.launches = 0
        blend.blend_masked_.launches = 0
        conv.conv3x3_q.launches = 0
        conv.conv3x3_gnq.launches = 0
        norm.group_norm.launches = 0
        r = drive_sessions(app, session_manager, muse, ids, boxes[0],
                           lambda: {"attention": attn.attention.launches,
                                    "blend_mask": blend.blend_masked_.launches,
                                    "conv3x3_q": conv.conv3x3_q.launches,
                                    "conv3x3_gnq": conv.conv3x3_gnq.launches,
                                    "group_norm": norm.group_norm.launches})
        fc, sched, c = muse._shared["feat_coalescer"], r["sched"], r["counts"]
        if fc is None or fc.batches_run == 0:
            raise AssertionError("the feature coalescer ran no batch")
        n = sched.batches_run
        want = {"attention": 17, "blend_mask": 1, "conv3x3_q": 59 if int8 else 0,
                "conv3x3_gnq": 21 if int8 else 0,
                "group_norm": NORM_SITES_INT8 if int8 else NORM_SITES_BF16}
        if n == 0 or any(c[k] < per * n for k, per in want.items()):
            raise AssertionError(f"launches {c} for {n} scheduler batches; want at least "
                                 f"{want} per batch")
        if not int8 and (c["conv3x3_q"] or c["conv3x3_gnq"]):
            raise AssertionError(f"the bf16 path launched int8 convs: {c}")
        log(phase, sessions=2, speech_frames=r["speech"], frames=r["frames"],
            speech_fps_per_session=[f"{v:.1f}" for v in r["fps"]],
            batches_run=n, requests_run=sched.requests_run,
            requests_submitted=sched.requests_submitted,
            mean_coalesced=f"{r['mean_coalesced']:.2f}",
            latency_p50_ms=f"{r['latency_p50_ms']:.1f}",
            feature_batches=fc.batches_run, feature_requests=fc.requests_run,
            **{f"{k}_launches": v for k, v in c.items()})
        return c
    finally:
        os.environ.pop("LT_FUSED_VAE", None)
        muse.reset_shared_scheduler()


def drive_paced(app, session_manager, plugin, avatar_ids, box, stagger_s: float) -> dict:
    """Sessions whose viewers take one frame each per 1/25 s, as a paced
    transport does; session k starts speaking ``k * stagger_s`` after the
    first. Counts, per session, the speech frames, their rate from the
    first to the last, and the ticks in between that found no frame
    (starved). Every bucket of the shared scheduler is warm before speech."""
    is_speech = speech_classifier(app, avatar_ids, box)
    n = len(avatar_ids)
    with open_sessions(app, session_manager, avatar_ids) as sessions:
        sched = plugin._shared["scheduler"]
        sched.prewarm((50, 384))
        speech, empty = [0] * n, [[] for _ in range(n)]
        first, last = [None] * n, [None] * n
        said = [False] * n
        t0 = time.perf_counter()
        tick = 0
        while time.perf_counter() - t0 < 120:
            for k, s in enumerate(sessions):
                if not said[k] and time.perf_counter() - t0 >= k * stagger_s:
                    s.put_msg_txt(f"paced session {k} reads one sentence of about sixty chars.")
                    said[k] = True
            for k, s in enumerate(sessions):
                try:
                    f = s.output.video_queue.get_nowait()
                except queue.Empty:
                    empty[k].append(tick)
                    continue
                if is_speech(k, f):
                    speech[k] += 1
                    first[k] = tick if first[k] is None else first[k]
                    last[k] = tick
            if (all(said) and min(speech) >= 32 and not any(s.is_speaking() for s in sessions)
                    and sched.requests_run == sched.requests_submitted):
                break
            tick += 1
            time.sleep(max(0.0, t0 + tick / 25.0 - time.perf_counter()))
    if min(speech) < 32:
        raise AssertionError(f"paced: speech frames per session {speech} < 32")
    lat = np.asarray(sched.latency_s) * 1e3
    fc = plugin._shared.get("feat_coalescer")
    return {
        "fps": [25.0 * (speech[k] - 1) / max(last[k] - first[k], 1) for k in range(n)],
        "starved": [sum(first[k] < t < last[k] for t in empty[k]) for k in range(n)],
        "speech": speech, "batches": sched.batches_run, "requests": sched.requests_run,
        "mean_coalesced": float(np.mean(sched.batch_sizes)),
        "p50_ms": float(np.percentile(lat, 50)), "p90_ms": float(np.percentile(lat, 90)),
        "feature_batches": None if fc is None else fc.batches_run,
        "feature_requests": None if fc is None else fc.requests_run}


def phase_paced_ab(torch, app, muse, synthetic, sd_vae, session_manager, counts) -> None:
    """MuseTalk sessions paced at 25 fps, with the shared Whisper feature
    coalescer and without it (each session encodes alone, as without
    --coalesce), in the order with, without, without, with, at each session
    count in ``counts``."""
    from livetalking_tpu_torch.config import default_opt

    vae = sd_vae.init_params(1, torch.bfloat16, "cuda")
    ids, box = [], None
    for k in range(max(counts)):
        a = synthetic.musetalk_avatar_arrays(n_frames=8, frame_hw=(H, W), seed=30 + k)
        app.global_avatars[f"paced_{k}"] = muse.avatar_from_arrays(
            f"paced_{k}", a["frames"], a["faces"], a["coords"], a["mask_coords"], a["masks"],
            vae, device="cuda")
        ids.append(f"paced_{k}")
        box = a["mask_coords"][0]
    del vae
    opt = default_opt(model="musetalk", transport="queue", tts="dummy", coalesce=True,
                      device_paste_back=True, batch_size=16, device="cuda",
                      avatar_id=ids[0], max_session=max(counts))
    app.load_plugin_stack(opt)
    shared_encoder = muse.get_shared_feature_coalescer
    for n in counts:
        for variant in ("coalescer", "alone", "alone", "coalescer"):
            if variant == "alone":
                muse.get_shared_feature_coalescer = lambda model, opt: None
            try:
                r = drive_paced(app, session_manager, muse, ids[:n], box, stagger_s=0.16)
            finally:
                muse.get_shared_feature_coalescer = shared_encoder
                muse.reset_shared_scheduler()
            log("paced", sessions=n, features=variant,
                speech_fps=[f"{v:.2f}" for v in r["fps"]], starved_ticks=r["starved"],
                speech_frames=r["speech"], batches=r["batches"], requests=r["requests"],
                mean_coalesced=f"{r['mean_coalesced']:.2f}", latency_p50_ms=f"{r['p50_ms']:.1f}",
                latency_p90_ms=f"{r['p90_ms']:.1f}", feature_batches=r["feature_batches"],
                feature_requests=r["feature_requests"])


def ultralight_state_dict(ul, seed: int) -> dict:
    """A random ``ultralight.pth`` state dict in the reference layout, with
    numpy: PyTorch-default-sized convs and BatchNorm with random running
    stats, so activations stay in range as a trained net's do (the
    He-normal init saturates the sigmoid almost everywhere)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(key, spec, bias=False):
        k = spec.kernel
        lim = 1.0 / np.sqrt(spec.cin // spec.groups * k * k)
        sd[f"{key}.weight"] = rng.uniform(-lim, lim, (spec.cout, spec.cin // spec.groups, k, k))
        if bias:
            sd[f"{key}.bias"] = rng.uniform(-lim, lim, spec.cout)

    def bn(key, c):
        sd[f"{key}.weight"] = rng.uniform(0.5, 1.5, c)
        sd[f"{key}.bias"] = rng.normal(0, 0.2, c)
        sd[f"{key}.running_mean"] = rng.normal(0, 0.3, c)
        sd[f"{key}.running_var"] = rng.uniform(0.5, 2.0, c)

    for name, prefixes in ul._PREFIXES.items():
        for prefix, (_, specs, _) in zip(prefixes, ul.ARCH[name]):
            for c, spec in zip((0, 3, 6), specs):
                conv(f"{prefix}.conv.{c}", spec)
                bn(f"{prefix}.conv.{c + 1}", spec.cout)
    for i in (3, 5):
        spec = ul.ARCH[f"a_conv{i}"][0][1]
        conv(f"audio_model.conv{i}", spec, bias=True)
        bn(f"audio_model.bn{i}", spec.cout)
    conv("outc.conv", ul.ARCH["outc"][0][1], bias=True)
    return {k: v.astype(np.float32) for k, v in sd.items()}


def conv_work(torch, fn) -> tuple:
    """(multiply-adds, bytes) of one call of ``fn``: every convolution's and
    matrix product's MACs from its shapes, and its operands read once and
    its output written once."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    work = {"macs": 0, "bytes": 0}
    # op -> position of the operand whose last dimension is the sum's length
    # (outside inference mode conv2d and matmul arrive decomposed)
    gemms = {aten.mm.default: 0, aten.bmm.default: 0, aten.matmul.default: 0,
             aten.addmm.default: 1, aten.baddbmm.default: 1, aten.baddbmm.out: 1}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ts = [a for a in args if isinstance(a, torch.Tensor)]
            if func in (aten.convolution.default, aten.conv2d.default):
                work["macs"] += out.numel() * args[1][0].numel()
            elif func in gemms:
                work["macs"] += out.numel() * args[gemms[func]].shape[-1]
            else:
                return out
            work["bytes"] += sum(t.numel() * t.element_size() for t in ts + [out])
            return out

    with Count():
        fn()
    return work["macs"], work["bytes"]


def phase_hubert(torch, hub, ul, hubert_features, default_opt, peak_bw: float,
                 peak_f32: float) -> dict:
    """HuBERT-large (seed 0) through the extractor a session runs, on one
    16,640-sample window at B=16 (51 encoder frames): the served weights
    (bf16; activations f32, as the reference computes them) against f32
    weights with TF32 off, relative L2 error of the (16, 16, 32, 32)
    features at most ``HUBERT_REL_ERR``; ms per window, its bound (the bf16
    weights read once; the MACs at the f32 rate)."""
    cfg = hub.LARGE
    opt = default_opt(device="cuda", batch_size=16)
    f32 = hub.init_params(0, cfg, torch.float32, "cuda")
    params = {"float32": f32, "bfloat16": ul.cast_params(f32, torch.bfloat16)}
    del f32
    feats, extractors = {}, {}
    for name, p in params.items():
        hf = hubert_features.HubertFeatures(opt, hubert_params=p, hubert_cfg=cfg)
        extractors[name] = hf
    wav = (0.1 * np.random.default_rng(8).standard_normal(hf._n_samples)).astype(np.float32)
    torch.backends.cudnn.allow_tf32 = False
    feats["float32"] = extractors["float32"]._fn(wav)
    torch.backends.cudnn.allow_tf32 = True
    feats["bfloat16"] = extractors["bfloat16"]._fn(wav)
    got, want = feats["bfloat16"], feats["float32"]
    if tuple(got.shape) != (16, 16, 32, 32) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"hubert features {tuple(got.shape)}, finite "
                             f"{bool(torch.isfinite(got).all())}")
    rel = float((got - want).norm() / want.norm())
    if not rel <= HUBERT_REL_ERR:
        raise AssertionError(f"hubert bf16 weights vs f32: relative error {rel} > "
                             f"{HUBERT_REL_ERR}")
    hf = extractors["bfloat16"]
    ms = cuda_ms(lambda: hf._fn(wav), warmup=3, iters=20)
    w_dev = torch.from_numpy(wav).cuda()[None].to(torch.bfloat16)
    bf16_act_ms = cuda_ms(lambda: hub.apply(params["bfloat16"], cfg, w_dev), warmup=3, iters=20)
    macs, _ = conv_work(torch, lambda: hub.apply(params["bfloat16"], cfg,
                                                 torch.from_numpy(wav).cuda()[None]))
    n_params = ul.count_params(params["bfloat16"])
    nbytes = 2 * n_params + 4 * wav.size + 4 * got.numel()
    b_ms, b_by = bound(nbytes / peak_bw * 1e3, 2 * macs / peak_f32 * 1e3)
    profile_step(torch, lambda: hf._fn(wav), steps=3, step_ms=ms, tag="hubert_profile")
    log("hubert", config="large", window_samples=wav.size, frames=cfg.out_length(wav.size),
        ms_per_window=f"{ms:.3f}", bf16_activations_ms=f"{bf16_act_ms:.3f}",
        rel_err_vs_f32=f"{rel:.5f}", bar=HUBERT_REL_ERR, params=n_params,
        GFLOP=f"{2 * macs / 1e9:.2f}", weight_GB=f"{2 * n_params / 1e9:.3f}",
        bound_ms=f"{b_ms:.4f}", bound_by=b_by, bytes_ms=f"{nbytes / peak_bw * 1e3:.4f}")
    del params, extractors
    torch.cuda.empty_cache()
    return {"ms": ms, "rel_err": rel}


def phase_ultralight_model(torch, ul, synthetic, peak_bw: float, peak_bf16: float) -> dict:
    """The Ultralight step at B=16 on reference-layout random weights: bf16
    against f32 (TF32 off) on the same weights at least ``UL_PSNR_DB``;
    the bf16 step's time, inferfps and bound; the grouped step at n=2 and
    n=8 sessions with distinct weights, each block within 1 LSB of that
    avatar's own step, and its time beside n per-avatar steps."""
    B = 16
    rng = np.random.default_rng(9)
    trees = [ul.convert_torch_state_dict(ultralight_state_dict(ul, s), torch.float32, "cuda")
             for s in range(8)]
    bf = [ul.cast_params(t, torch.bfloat16) for t in trees]
    crops = torch.from_numpy(synthetic.ultralight_avatar_arrays(n_frames=16, seed=9)["crops"])
    cyc = crops.cuda()
    audio = torch.from_numpy((0.5 * rng.standard_normal((8 * B, 16, 32, 32)))
                             .astype(np.float32)).cuda()
    idx = torch.from_numpy(np.concatenate([(np.arange(B) + 3 * s) % 16 for s in range(8)])
                           .astype(np.int32)).cuda()
    solo = {dt: ul.make_infer_fn(B, dt) for dt in (torch.float32, torch.bfloat16)}

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = solo[torch.float32](trees[0], cyc, idx[:B], audio[:B])
    torch.backends.cudnn.allow_tf32 = True
    out = solo[torch.bfloat16](bf[0], cyc, idx[:B], audio[:B])
    db = psnr_u8(out.cpu(), ref.cpu())
    unsat = float(((ref > 0) & (ref < 255)).float().mean())
    if tuple(out.shape) != (B, 160, 160, 3) or not db >= UL_PSNR_DB:
        raise AssertionError(f"ultralight bf16 step {tuple(out.shape)}: {db:.2f} dB against "
                             f"f32 (bar {UL_PSNR_DB})")
    run = lambda: solo[torch.bfloat16](bf[0], cyc, idx[:B], audio[:B])  # noqa: E731
    ms = cuda_ms(run, warmup=3, iters=20)
    macs, act_bytes = conv_work(torch, run)
    b_ms, b_by = bound(act_bytes / peak_bw * 1e3, 2 * macs / peak_bf16 * 1e3)
    log("ultralight_model", B=B, dtype="bfloat16", step_ms=f"{ms:.3f}",
        inferfps=f"{B / ms * 1e3:.1f}", psnr_bf16_vs_f32_db=f"{db:.2f}", bar_db=UL_PSNR_DB,
        unsaturated_share=f"{unsat:.3f}", GFLOP=f"{2 * macs / 1e9:.2f}",
        MB=f"{act_bytes / 1e6:.1f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by,
        share_of_bound=f"{b_ms / ms:.3f}", params=ul.count_params(trees[0]))
    profile_step(torch, run, steps=3, step_ms=ms, tag="ultralight_profile")

    stacked = ul.stack_params(bf)
    grouped = {}
    for n in (2, 8):
        slots = torch.arange(n, device="cuda").flip(0)  # blocks in reverse slot order
        step = ul.make_grouped_infer_fn(n, B, torch.bfloat16)
        call = lambda: step(stacked, cyc, idx[:n * B], slots, audio[:n * B])  # noqa: E731
        got = call()
        err = 0
        for k, s in enumerate(slots.tolist()):
            sl = slice(k * B, (k + 1) * B)
            want = solo[torch.bfloat16](bf[s], cyc, idx[sl], audio[sl])
            err = max(err, int((got[sl].int() - want.int()).abs().max()))
        if err > TOL_LSB:
            raise AssertionError(f"grouped step n={n}: {err} LSB from the per-avatar steps")
        g_ms = cuda_ms(call, warmup=3, iters=20)
        g_macs, g_bytes = conv_work(torch, call)
        g_bound, g_by = bound(g_bytes / peak_bw * 1e3, 2 * g_macs / peak_bf16 * 1e3)
        grouped[n] = {"ms": g_ms, "max_lsb": err}
        if n == 8:
            profile_step(torch, call, steps=3, step_ms=g_ms, tag="ultralight_grouped_profile")
        log("ultralight_model", grouped_sessions=n, B=B, step_ms=f"{g_ms:.3f}",
            per_avatar_steps_ms=f"{n * ms:.3f}", frames_per_s=f"{n * B / g_ms * 1e3:.1f}",
            bound_ms=f"{g_bound:.4f}", bound_by=g_by, share_of_bound=f"{g_bound / g_ms:.3f}",
            max_lsb_vs_per_avatar=err)
    del trees, bf, stacked
    torch.cuda.empty_cache()
    return {"step_ms": ms, "psnr_db": db, "grouped": grouped}


def phase_ultralight_engine(torch, app, ua, ul, blend, synthetic, session_manager) -> dict:
    """Two coalesced Ultralight sessions on avatars with distinct weights,
    ``--device_paste_back``: every super-batch step pastes with one launch
    of kernel 1 at S = 168."""
    from livetalking_tpu_torch.config import default_opt

    ids, box = ("smoke_ua", "smoke_ub"), None
    for k, aid in enumerate(ids):
        a = synthetic.ultralight_avatar_arrays(n_frames=8 + 2 * k, frame_hw=(H, W), seed=40 + k)
        weights = ul.convert_torch_state_dict(ultralight_state_dict(ul, 20 + k), torch.float32,
                                              "cuda")
        app.global_avatars[aid] = ua.avatar_from_arrays(aid, a["frames"], a["crops"],
                                                        a["coords"], weights, device="cuda")
        box = a["coords"][0]
    opt = default_opt(model="ultralight", transport="queue", tts="dummy", coalesce=True,
                      device_paste_back=True, batch_size=16, device="cuda",
                      avatar_id=ids[0], max_session=2)
    t0 = time.time()
    app.load_plugin_stack(opt)
    log("ultralight_engine", load_plugin_stack_s=f"{time.time() - t0:.2f}")
    try:
        # this path starts here: its kernel count from 0
        blend.blend_rect_.launches = 0
        r = drive_sessions(app, session_manager, ua, ids, box,
                           lambda: {"blend": blend.blend_rect_.launches})
        launches, sched = r["counts"]["blend"], r["sched"]
        if launches < sched.batches_run or sched.batches_run == 0:
            raise AssertionError(f"blend launches {launches} < scheduler batches "
                                 f"{sched.batches_run}")
        log("ultralight_engine", sessions=2, speech_frames=r["speech"], frames=r["frames"],
            speech_fps_per_session=[f"{v:.1f}" for v in r["fps"]],
            batches_run=sched.batches_run, requests_run=sched.requests_run,
            requests_submitted=sched.requests_submitted,
            mean_coalesced=f"{r['mean_coalesced']:.2f}",
            latency_p50_ms=f"{r['latency_p50_ms']:.1f}", blend_launches=launches)
        return {"launches": launches}
    finally:
        ua.reset_shared_scheduler()


def phase_ernerf(torch, app, ea, ernerf, synthetic, session_manager) -> dict:
    """ER-NeRF: the render on the card against the CPU at 16 px, 4 samples
    (at most 1 LSB); ``render_frame_batch`` at B=16, 128 px, 32 samples
    (ms, peak memory); then one session through the engine."""
    from livetalking_tpu_torch.config import default_opt

    rng = np.random.default_rng(11)
    cpu = ernerf.init_params(0, audio_dim=ea.AUDIO_DIM)
    gpu = ernerf.params_from_jax(cpu, "cuda")
    feats = torch.from_numpy((0.1 * rng.standard_normal((2, ea.AUDIO_DIM))).astype(np.float32))
    bg = torch.from_numpy(rng.random((2, 16, 16, 3)).astype(np.float32))
    want = ernerf.render_frame_batch(cpu, feats, bg, size=16, n_samples=4)
    got = ernerf.render_frame_batch(gpu, feats.cuda(), bg.cuda(), size=16, n_samples=4).cpu()
    err = int((got.int() - want.int()).abs().max())
    if err > TOL_LSB:
        raise AssertionError(f"ernerf render on the card differs from the CPU by {err} LSB")
    B, size, ns = 16, 128, 32
    feats = torch.from_numpy((0.1 * rng.standard_normal((B, ea.AUDIO_DIM)))
                             .astype(np.float32)).cuda()
    bg = torch.from_numpy(rng.random((B, size, size, 3)).astype(np.float32)).cuda()
    torch.cuda.reset_peak_memory_stats()
    out = ernerf.render_frame_batch(gpu, feats, bg, size=size, n_samples=ns)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if tuple(out.shape) != (B, size, size, 3) or out.dtype != torch.uint8:
        raise AssertionError(f"ernerf render {tuple(out.shape)} {out.dtype}")
    ms = cuda_ms(lambda: ernerf.render_frame_batch(gpu, feats, bg, size=size, n_samples=ns),
                 warmup=1, iters=5)
    log("ernerf", card_vs_cpu_max_lsb=err, B=B, size=size, samples=ns,
        render_ms=f"{ms:.3f}", Msamples_per_s=f"{B * size * size * ns / ms / 1e3:.1f}",
        peak_memory_GB=f"{peak_gb:.2f}")
    del feats, bg, out
    torch.cuda.empty_cache()

    a = synthetic.ultralight_avatar_arrays(n_frames=8, frame_hw=(H, W), seed=50)
    x1, y1, x2, y2 = a["coords"][0]
    app.global_avatars["smoke_nf"] = ea.avatar_from_arrays(
        "smoke_nf", a["frames"], [(y1, y2, x1, x2)] * 8, device="cuda")
    opt = default_opt(model="ernerf", transport="queue", tts="dummy", batch_size=B,
                      device="cuda", avatar_id="smoke_nf", max_session=1)
    t0 = time.time()
    app.load_plugin_stack(opt)
    log("ernerf_engine", load_plugin_stack_s=f"{time.time() - t0:.2f}")
    r = drive_sessions(app, session_manager, ea, ("smoke_nf",), (x1, y1, x2, y2), lambda: {})
    log("ernerf_engine", sessions=1, speech_frames=r["speech"], frames=r["frames"],
        speech_fps=f"{r['fps'][0]:.1f}")
    return {"render_ms": ms, "fps": r["fps"][0]}


class IdTokenizer:
    """Stand-in tokenizer for random weights: ids as words, the special ids
    (>= EOT) dropped."""

    def __init__(self, eot: int):
        self.eot = eot

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"w{int(i)}" for i in ids if not skip_special_tokens or i < self.eot)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def count_syncs(torch, fn):
    """(result, synchronizing CUDA calls, {file:line: count}) of one call of
    ``fn``, as ``torch.cuda.set_sync_debug_mode`` reports them; each call
    is placed at the innermost frame of the package that made it."""
    import traceback
    import warnings

    sites = collections.Counter()

    def record(message, *args, **kwargs):
        if "synchronizing" in str(message):
            frames = [f for f in traceback.extract_stack()
                      if "livetalking_tpu_torch" in f.filename] or traceback.extract_stack()[-3:]
            sites[f"{os.path.basename(frames[-1].filename)}:{frames[-1].lineno}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum(sites.values()), dict(sites)


@contextlib.contextmanager
def serve_app(web_app):
    """``web_app`` on 127.0.0.1 at a free port, served from its own event loop
    in a thread; yields the base URL, cleans up on exit."""
    import threading

    from aiohttp import web

    port = free_port()
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(web_app)
    started = threading.Event()

    def serve():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(runner.setup())
        loop.run_until_complete(web.TCPSite(runner, "127.0.0.1", port).start())
        started.set()
        loop.run_forever()

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    if not started.wait(30):
        raise AssertionError("the aiohttp server did not start")
    try:
        yield f"http://127.0.0.1:{port}"
    finally:
        asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)


def asr_roundtrip(app, pcm: np.ndarray) -> tuple:
    """``/api/asr`` through ``app.build_web_app()`` (the port's
    ``setup_routes``) on a local aiohttp server: JSON config, PCM16 chunks,
    ``is_speaking: false``; (the one reply, its ms from the last chunk)."""
    import aiohttp

    async def client(base):
        async with aiohttp.ClientSession() as sess:
            async with sess.ws_connect(f"{base}/api/asr") as ws:
                await ws.send_str(json.dumps({"chunk_size": [5, 10, 5], "wav_name": "smoke",
                                              "is_speaking": True, "mode": "2pass",
                                              "itn": True}))
                data = pcm.tobytes()
                for i in range(0, len(data), 3200):  # 100 ms chunks
                    await ws.send_bytes(data[i:i + 3200])
                t0 = time.perf_counter()
                await ws.send_str(json.dumps({"is_speaking": False}))
                msg = await asyncio.wait_for(ws.receive(), timeout=120)
                ms = (time.perf_counter() - t0) * 1e3
                extra = None
                with contextlib.suppress(asyncio.TimeoutError):
                    extra = await asyncio.wait_for(ws.receive(), timeout=0.5)
                if extra is not None and extra.type == aiohttp.WSMsgType.TEXT:
                    raise AssertionError(f"a second reply: {extra.data}")
                return json.loads(msg.data), ms

    with serve_app(app.build_web_app()) as base:
        return asyncio.run(client(base))


def phase_stt(torch, app, asr_server, wd, we, textnorm) -> dict:
    """Whisper-tiny as ``/api/asr`` serves it, bf16: the encoder on a 30 s
    window, the decoder at d_model 384, 4 layers, vocabulary 51,865, a
    4-token prompt and ``max_new`` = 128 (EOT's embedding row zeroed, so
    its logit is 0 and random weights run all 128 steps). Encode ms,
    decode ms per token and for 128 with its kernel profile, the host
    syncs a decode makes, the real-time factor of one pass on 5 s of
    audio; the card's ids equal to the CPU's in f32 (TF32 off) for 16
    tokens; two ``/api/asr`` round trips with the backend injected and a
    stand-in tokenizer."""
    cfg, max_new = wd.TINY_DECODER, 128
    rng = np.random.default_rng(12)
    t = np.arange(5 * 16000) / 16000
    audio = (0.3 * np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 3 * t))
             + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    tok = IdTokenizer(cfg.eot)

    # the card against the CPU, f32, TF32 off, 16 tokens; the seeded inits
    # draw on the host, so both devices hold the same weights
    ids = {}
    torch.backends.cudnn.allow_tf32 = False
    for dev in ("cpu", "cuda"):
        s = asr_server.WhisperTorchSTT(we.init_params(0, we.TINY, torch.float32, dev),
                                       wd.init_params(1, cfg, torch.float32, dev), tok,
                                       max_new=16, dtype=torch.float32, device=dev)
        enc = s.encode(audio)
        prompt = torch.tensor([[cfg.sot, s.detect_language(enc), cfg.task_transcribe,
                                cfg.no_timestamps]], device=dev)
        ids[dev] = s.decode(enc, prompt)[0].cpu()
    torch.backends.cudnn.allow_tf32 = True
    if not torch.equal(ids["cpu"], ids["cuda"]):
        raise AssertionError(f"STT ids on the card {ids['cuda'].tolist()} differ from the CPU's "
                             f"{ids['cpu'].tolist()}")

    enc_p = we.init_params(0, we.TINY, torch.bfloat16, "cuda")
    dec_p = wd.init_params(1, cfg, torch.bfloat16, "cuda")
    dec_p["tok_emb"][cfg.eot] = 0
    stt = asr_server.WhisperTorchSTT(enc_p, dec_p, tok, max_new=max_new, device="cuda")
    enc = stt.encode(audio)
    if tuple(enc.shape) != (1, 1500, 384) or not bool(torch.isfinite(enc).all()):
        raise AssertionError(f"encoder states {tuple(enc.shape)}")
    enc_ms = cuda_ms(lambda: stt.encode(audio), warmup=3, iters=20)
    lang_ms = cuda_ms(lambda: stt.detect_language(enc), warmup=3, iters=20)
    prompt = torch.tensor([[cfg.sot, cfg.lang_en, cfg.task_transcribe, cfg.no_timestamps]],
                          device="cuda")
    (out, n_valid), syncs, sync_sites = count_syncs(torch, lambda: stt.decode(enc, prompt))
    n_valid = int(n_valid[0])
    if n_valid != max_new or not bool(((out < cfg.eot) | (out == cfg.eot)).all()):
        raise AssertionError(f"decode: {n_valid} of {max_new} tokens valid, ids "
                             f"{out[0, :8].tolist()}...")
    dec_ms = cuda_ms(lambda: stt.decode(enc, prompt), warmup=2, iters=10)
    # the profile of a 16-token decode (the profiler's cost grows with the
    # 300-odd launches a token): kernel time and launches a token
    short = wd.make_greedy_decode(dec_p, cfg, max_new=16)
    profile_step(torch, lambda: short(enc, prompt), steps=1,
                 step_ms=cuda_ms(lambda: short(enc, prompt), warmup=1, iters=5),
                 tag="stt_decode16_profile")
    rtf = (enc_ms + lang_ms + dec_ms) / 1e3 / (audio.size / 16000)
    t0 = time.perf_counter()
    text = stt.transcribe(audio, 16000)
    transcribe_ms = (time.perf_counter() - t0) * 1e3

    asr_server.set_stt_backend(stt)
    try:
        pcm = (np.clip(audio, -1, 1) * 32767).astype(np.int16)
        # the first request in a fresh server also makes the executor
        # thread's cuBLAS/cuDNN handles
        (reply, rt_ms), (reply2, rt2_ms) = asr_roundtrip(app, pcm), asr_roundtrip(app, pcm)
    finally:
        asr_server.set_stt_backend(None)
    want = textnorm.postprocess(stt.transcribe(pcm.astype(np.float32) / 32768.0, 16000), itn=True)
    if (set(reply) != {"text", "mode", "is_final", "timestamp"} or reply["is_final"] is not True
            or reply["mode"] != "2pass-offline" or reply["text"] != want or reply2 != reply):
        raise AssertionError(f"/api/asr replies {reply!r}, {reply2!r}; want text {want!r}")
    log("stt", model="whisper-tiny", dtype="bfloat16", window_s=30, audio_s=audio.size / 16000,
        encode_ms=f"{enc_ms:.3f}", detect_language_ms=f"{lang_ms:.3f}", max_new=max_new,
        decode_ms=f"{dec_ms:.3f}", decode_ms_per_token=f"{dec_ms / max_new:.4f}",
        host_syncs_per_decode=syncs, host_syncs_per_token=f"{syncs / max_new:.4f}",
        sync_sites=json.dumps(sync_sites),
        rtf_one_pass=f"{rtf:.5f}", transcribe_ms=f"{transcribe_ms:.1f}",
        transcript_words=len(text.split()), card_vs_cpu_f32_ids="equal",
        asr_roundtrip_ms=f"{rt_ms:.1f}", asr_roundtrip_again_ms=f"{rt2_ms:.1f}",
        asr_reply_chars=len(reply["text"]))
    del stt, enc_p, dec_p
    torch.cuda.empty_cache()
    return {"encode_ms": enc_ms, "decode_ms": dec_ms, "rtf": rtf, "roundtrip_ms": rt_ms}


def rel_err(torch, got, want) -> float:
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def phase_face_models(torch, s3fd, bisenet, pfld, peak_tf32: float) -> dict:
    """The avatar build's face models on the card, as the builds run them:
    f32 weights and activations, cuDNN's default TF32 convolutions. Each
    against the same module on the CPU at a small size: relative L2 error
    at most ``FACE_REL_ERR_TF32`` with TF32 and ``FACE_REL_ERR_F32`` with
    it off. S3FD: the VGG16 tower and decode on 16 frames of 480x640
    (padded to 512x640), its GMAC and share of the TF32 rate, and the
    detector's whole chunk (upload, pad, tower, decode, host filter and
    NMS; the heads' biases favour the background, so random weights find
    no face, as a trained detector finds none on most anchors); BiSeNet's
    parse at 512 px, B=1 and 16; PFLD per face at 192 px."""
    rng = np.random.default_rng(13)
    errs = {}

    def card_vs_cpu(name, fn, cpu_params, cuda_params, x):
        out = {}
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            out[tf32] = rel_err(torch, fn(cuda_params, x.cuda()), fn(cpu_params, x))
        bars = {False: FACE_REL_ERR_F32, True: FACE_REL_ERR_TF32}
        if any(out[k] > bars[k] for k in out):
            raise AssertionError(f"{name} on the card vs the CPU: relative error {out} > {bars}")
        errs[name] = out
        return out

    s_cpu = s3fd.init_params(0)
    for src, l2, conf in s3fd._HEADS:  # background-biased confidence heads
        head = s3fd._head_names(src, l2)[0]
        s_cpu[head]["b"] = torch.tensor([4.0] * (conf - 1) + [-4.0])
    s_gpu = s3fd.params_to(s_cpu, "cuda")
    # the tower's and the location heads' outputs at all six scales
    frames = rng.integers(0, 256, (2, 3, 128, 128)).astype(np.float32) - 117.0
    card_vs_cpu("s3fd", lambda p, x: torch.cat([r.flatten() for _, r in s3fd.apply(p, x)]),
                s_cpu, s_gpu, torch.from_numpy(frames))
    b_cpu = bisenet.init_params(0)
    b_gpu = bisenet.params_to(b_cpu, "cuda")
    x = torch.from_numpy(rng.standard_normal((1, 3, 64, 64)).astype(np.float32))
    card_vs_cpu("bisenet", bisenet.apply, b_cpu, b_gpu, x)
    p_cpu = pfld.init_params(0)
    mean = np.tile(np.asarray([0.5, 0.5], np.float32), pfld.N_LANDMARKS)
    lk = pfld.PFLDLandmarker(p_cpu, mean, device="cuda")
    x = torch.from_numpy(rng.random((2, 3, 192, 192)).astype(np.float32))
    card_vs_cpu("pfld", pfld.apply, p_cpu, lk.params, x)
    torch.backends.cudnn.allow_tf32 = True

    # S3FD at full width: 16 frames of 480x640
    video = np.stack(synthetic_frames(16))
    det = s3fd.S3FDDetector(s_gpu, max_batch=16, device="cuda")
    Hp, Wp = -(-H // 128) * 128, -(-W // 128) * 128
    imgs = torch.zeros((16, Hp, Wp, 3), device="cuda")
    imgs[:, :H, :W] = torch.from_numpy(video).cuda()
    cand = s3fd.detect(s_gpu, imgs)
    # strides 4-16 exact; fc6 (3x3, padding 3) grows the /32 map by 4, then
    # two stride-2 convs round up
    sizes, (h, w) = [(Hp // s, Wp // s) for s in (4, 8, 16)], (Hp // 32 + 4, Wp // 32 + 4)
    for _ in range(3):
        sizes.append((h, w))
        h, w = -(-h // 2), -(-w // 2)
    anchors = sum(a * b for a, b in sizes)
    if tuple(cand.shape) != (16, anchors, 5) or not bool(torch.isfinite(cand).all()):
        raise AssertionError(f"s3fd candidates {tuple(cand.shape)}")
    s_ms = cuda_ms(lambda: s3fd.detect(s_gpu, imgs), warmup=3, iters=10)
    macs, _ = conv_work(torch, lambda: s3fd.detect(s_gpu, imgs))
    dets = det.detect_batch(video)
    t0 = time.perf_counter()
    det.detect_batch(video)
    chunk_ms = (time.perf_counter() - t0) * 1e3
    if len(dets) != 16 or any(d.shape[1] != 5 for d in dets):
        raise AssertionError(f"s3fd detections {[d.shape for d in dets]}")
    s_bound = 2 * macs / peak_tf32 * 1e3

    parse = bisenet.make_parse_fn(512)
    faces = torch.from_numpy(rng.integers(0, 256, (16, 512, 512, 3), dtype=np.uint8)).cuda()
    cm = parse(b_gpu, faces)
    if tuple(cm.shape) != (16, 512, 512) or int(cm.min()) < 0 or int(cm.max()) >= 19:
        raise AssertionError(f"bisenet class map {tuple(cm.shape)}")
    b_ms = {B: cuda_ms(lambda: parse(b_gpu, faces[:B]), warmup=3, iters=20) for B in (1, 16)}
    b_macs, _ = conv_work(torch, lambda: parse(b_gpu, faces))

    inp = torch.from_numpy(rng.random((1, 3, 192, 192)).astype(np.float32)).cuda()
    p_ms = cuda_ms(lambda: pfld.apply(lk.params, inp), warmup=5, iters=40)
    frame = video[0]
    lm = lk.landmarks(frame, (200, 120, 440, 360))
    if lm.shape != (pfld.N_LANDMARKS, 2) or not (np.abs(lm - (320, 240)).max() < 200):
        raise AssertionError(f"pfld landmarks {lm.shape}, spread {np.abs(lm - (320, 240)).max()}")
    t0 = time.perf_counter()
    for _ in range(20):
        lk.landmarks(frame, (200, 120, 440, 360))
    lm_ms = (time.perf_counter() - t0) / 20 * 1e3
    log("face_models", tf32=True,
        **{f"{k}_rel_err_vs_cpu": f"f32 {v[False]:.2e} tf32 {v[True]:.2e}"
           for k, v in errs.items()},
        bars=f"f32 {FACE_REL_ERR_F32} tf32 {FACE_REL_ERR_TF32}")
    log("face_models", model="s3fd", B=16, frame=f"{H}x{W}", padded=f"{Hp}x{Wp}",
        tower_decode_ms=f"{s_ms:.3f}", frames_per_s=f"{16 / s_ms * 1e3:.1f}",
        GMAC=f"{macs / 1e9:.1f}", GFLOP=f"{2 * macs / 1e9:.1f}",
        tf32_bound_ms=f"{s_bound:.3f}", share_of_tf32_rate=f"{s_bound / s_ms:.3f}",
        detector_chunk_ms=f"{chunk_ms:.1f}", detections=sum(len(d) for d in dets))
    log("face_models", model="bisenet", size=512, B1_ms=f"{b_ms[1]:.3f}",
        B16_ms=f"{b_ms[16]:.3f}", B16_faces_per_s=f"{16 / b_ms[16] * 1e3:.1f}",
        B16_GFLOP=f"{2 * b_macs / 1e9:.1f}",
        B16_share_of_tf32_rate=f"{2 * b_macs / peak_tf32 * 1e3 / b_ms[16]:.3f}")
    log("face_models", model="pfld", size=192, B=1, forward_ms=f"{p_ms:.3f}",
        landmarks_per_face_ms=f"{lm_ms:.3f}")
    return {"s3fd_ms": s_ms, "bisenet_ms": b_ms, "pfld_ms": p_ms}


def synthetic_frames(n: int, seed: int = 14) -> list:
    """``n`` 480x640 BGR frames of the synthetic generator."""
    from livetalking_tpu_torch.utils import synthetic

    return synthetic.musetalk_avatar_arrays(n_frames=n, frame_hw=(H, W), seed=seed)["frames"]


def phase_genavatar(torch, app, session_manager) -> dict:
    """Avatar builds through the port's task manager on the card: a
    synthetic 480x640 video written with ``cv2.VideoWriter``, built as
    wav2lip, MuseTalk (the random full-width VAE, seed 0) and Ultralight
    avatars with ``face_detector="center"`` and the geometric masks (no
    parse weights), twice each, and an ER-NeRF avatar (frames, boxes and a
    triplane field fit by the training step, 200 steps at 64 px, on the
    random HuBERT-large features of a separate speech WAV); seconds
    per frame of each build; each built avatar loaded by its plugin and
    served in one session."""
    import pickle
    import tempfile

    import cv2

    from livetalking_tpu_torch.avatars import (
        ernerf_avatar,
        musetalk_avatar,
        ultralight_avatar,
        wav2lip_avatar,
    )
    from livetalking_tpu_torch.config import default_opt
    from livetalking_tpu_torch.genavatar.pipeline import load_frames
    from livetalking_tpu_torch.models import ernerf
    from livetalking_tpu_torch.server.task_manager import TaskManager

    n = 24
    with tempfile.TemporaryDirectory(prefix="smoke_genavatar_") as tmp:
        path = os.path.join(tmp, "input.mp4")
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25, (W, H))
        for f in synthetic_frames(n, seed=15):
            w.write(f)
        w.release()
        if len(load_frames(path, watermark=False)) != n:  # what every build decodes first
            raise AssertionError(f"the synthetic video does not decode to {n} frames")
        # the clip's speech for the ER-NeRF fit (cv2 writes no audio track)
        speech = os.path.join(tmp, "speech.wav")
        t = np.arange(int(16000 * n / 25)) / 16000.0
        with wave.open(speech, "wb") as wf:
            wf.setnchannels(1)
            wf.setsampwidth(2)
            wf.setframerate(16000)
            wf.writeframes((0.3 * np.sin(2 * np.pi * 220 * t) * 32767).astype("<i2").tobytes())
        data_dir, models_dir = os.path.join(tmp, "data"), os.path.join(tmp, "models")
        tm = TaskManager(device="cuda")
        spf = {}
        # each family twice: the first build also pays its models' first
        # calls (cuDNN's plan choice, the VAE's weights); the second is served
        for aid, model in [(f"first_{m}", m) for m in ("wav2lip", "musetalk", "ultralight")] + [
                (f"built_{m}", m) for m in ("wav2lip", "musetalk", "ultralight", "ernerf")]:
            task = tm.add_task(aid, {"model": model, "video_path": path, "data_dir": data_dir,
                                     "models_dir": models_dir, "face_detector": "center",
                                     "audio_path": speech})
            deadline = time.time() + 300
            while task.status not in ("completed", "failed") and time.time() < deadline:
                time.sleep(0.05)
            if task.status != "completed":
                raise AssertionError(f"{model} build {task.status}: {task.message}")
            spf[aid] = (task.updated_at - task.created_at) / n
        log("genavatar", frames=n, frame=f"{H}x{W}", detector="center",
            **{f"{k}_s_per_frame": f"{v:.4f}" for k, v in spf.items()})

        fps = {}
        for model, plugin in (("wav2lip", wav2lip_avatar), ("musetalk", musetalk_avatar),
                              ("ultralight", ultralight_avatar), ("ernerf", ernerf_avatar)):
            aid = f"built_{model}"
            avatar = plugin.load_avatar(aid, data_dir, "cuda")
            if len(avatar["frame_list_cycle"]) != n:
                raise AssertionError(f"{aid}: {len(avatar['frame_list_cycle'])} frames")
            app.global_avatars[aid] = avatar
            with open(os.path.join(data_dir, "avatars", aid, "coords.pkl"), "rb") as f:
                c = pickle.load(f)[0]
            if model == "musetalk":  # the paste covers the mask's crop box
                with open(os.path.join(data_dir, "avatars", aid, "mask_coords.pkl"), "rb") as f:
                    c = pickle.load(f)[0]
            if model == "ernerf":
                # zero conditioning leaves the audio net where the seeded
                # init put it: the fit must have seen the HuBERT features
                w0 = ernerf.init_params(0, audio_dim=ernerf_avatar.AUDIO_DIM)["audio1"]["w"]
                if (avatar["nerf_params"] is None
                        or torch.equal(avatar["nerf_params"]["audio1"]["w"].cpu(), w0)):
                    raise AssertionError(f"{aid}: no field fit on the clip's audio")
            box = (c[2], c[0], c[3], c[1]) if model in ("wav2lip", "ernerf") else tuple(c)
            served = {} if model == "ernerf" else {"coalesce": True, "device_paste_back": True}
            opt = default_opt(model=model, transport="queue", tts="dummy", batch_size=16,
                              device="cuda", avatar_id=aid, max_session=1, data_dir=data_dir,
                              modelfile="", **served)
            app.load_plugin_stack(opt)
            try:
                r = drive_sessions(app, session_manager, plugin, (aid,), box, lambda: {})
            finally:
                if hasattr(plugin, "reset_shared_scheduler"):
                    plugin.reset_shared_scheduler()
            fps[model] = r["fps"][0]
        log("genavatar", served={k: f"{v:.1f}" for k, v in fps.items()},
            speech_frames_each=">= 32")
    return {"s_per_frame": spf, "fps": fps}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN_B = 10  # the MuseTalk full recipe's batch on the card: two 5-frame clips
# (T, D, heads, forward launches per training step, of them with a backward):
# the U-Net's 16 self-attention sites, and the VAE mid-block's in the three
# encodes (no gradient) and the decode
TRAIN_ATTN_SHAPES = [(1024, 40, 8, 5, 5), (256, 80, 8, 5, 5), (64, 160, 8, 5, 5),
                     (16, 160, 8, 1, 1), (1024, 512, 1, 4, 1)]
TRAIN_LAUNCHES = sum(n for *_, n, _ in TRAIN_ATTN_SHAPES)  # 20
MT_SYNC_LAUNCHES = 2  # the MuseTalk expert's two attention blocks (musetalk_syncnet.MUSETALK)
# the attention gradient on the card against the same Function on the CPU,
# relative to max|grad|
ATTN_GRAD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# U-Net self-attention gradients, kernel against attention_plain: each leaf's
# relative L2
GRAD_LINK_TOL = 1e-3


def phase_train_attention(torch, attn, peak_bw: float, peak_f32: float) -> dict:
    """Kernel 3's autograd Function at every training shape: the card's
    (dq, dk, dv) against the same Function on CPU copies (B=2, f32 and
    bf16); then, at the training batch in f32, the forward kernel's time and
    the PyTorch backward's, each against its bound, summed over a step."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    step = {"forward_ms": 0.0, "backward_ms": 0.0, "forward_bound_ms": 0.0,
            "backward_bound_ms": 0.0}
    for T, D, heads, fwd_n, bwd_n in TRAIN_ATTN_SHAPES:
        scale = D ** -0.5
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            q, k, v, do = (torch.randn((2, heads, T, D), device="cuda", generator=gen)
                           .to(dtype) for _ in range(4))
            grads = []
            for dev in ("cuda", "cpu"):
                ts = [t.to(dev, copy=True).requires_grad_(True) for t in (q, k, v)]
                attn.attention(*ts, scale).backward(do.to(dev))
                grads.append([t.grad.float().cpu() for t in ts])
            for g, w in zip(*grads):
                e = float((g - w).abs().max() / w.abs().max())
                if not e <= ATTN_GRAD_TOL[name]:
                    raise AssertionError(f"attention gradient {T}x{D} {name}: {e} of max|grad| "
                                         f"> {ATTN_GRAD_TOL[name]}")
                worst[name] = max(worst[name], e)
        q, k, v, do = (torch.randn((TRAIN_B, heads, T, D), device="cuda", generator=gen)
                       for _ in range(4))
        fwd_ms = cuda_ms(lambda: attn.attention(q, k, v, scale), warmup=3, iters=20)
        bwd_ms = cuda_ms(lambda: attn.attention_backward(q, k, v, do, scale), warmup=3, iters=20)
        n = TRAIN_B * heads
        fwd_bound, fwd_by = bound(4 * n * T * D * 4 / peak_bw * 1e3,
                                  4 * n * T * T * D / peak_f32 * 1e3)
        # backward: the scores again, dv, da, dq, dk (five T*T*D products);
        # reads q, k, v, do and writes dq, dk, dv
        bwd_bound, bwd_by = bound(7 * n * T * D * 4 / peak_bw * 1e3,
                                  10 * n * T * T * D / peak_f32 * 1e3)
        step["forward_ms"] += fwd_n * fwd_ms
        step["backward_ms"] += bwd_n * bwd_ms
        step["forward_bound_ms"] += fwd_n * fwd_bound
        step["backward_bound_ms"] += bwd_n * bwd_bound
        log("train_attention", shape=f"{TRAIN_B}x{heads}x{T}x{D}", dtype="float32",
            forward_ms=f"{fwd_ms:.4f}", forward_bound_ms=f"{fwd_bound:.5f}", forward_by=fwd_by,
            backward_ms=f"{bwd_ms:.4f}", backward_bound_ms=f"{bwd_bound:.5f}",
            backward_by=bwd_by, per_step=f"{fwd_n} forward, {bwd_n} backward")
        del q, k, v, do
        torch.cuda.empty_cache()
    log("train_attention", per_training_step=f"{TRAIN_LAUNCHES} forward launches",
        **{k: f"{v:.4f}" for k, v in step.items()},
        grad_err_f32=f"{worst['float32']:.2e}", grad_err_bf16=f"{worst['bfloat16']:.2e}")
    return step


def _cli_run(torch, cli, attn, args: list, tag: str) -> dict:
    """``train.cli.main(args)`` on the card with every kernel count at 0 just
    before; per step its metrics, its wall time (each step ends on the host
    with its metrics) and its attention launches; the peak device memory."""
    marks = []

    def on_step(i, m):
        marks.append((time.perf_counter(), attn.attention.launches, m))

    torch.cuda.reset_peak_memory_stats()
    attn.attention.launches = 0
    t0 = time.perf_counter()
    cli.main(args + ["--device", "cuda", "--log_every", "0"], on_step=on_step)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    starts = [t0] + [t for t, _, _ in marks[:-1]]
    step_s = [t - s for (t, _, _), s in zip(marks, starts)]
    launches = [n - p for (_, n, _), p in zip(marks, [0] + [n for _, n, _ in marks[:-1]])]
    for _, _, m in marks:
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{tag}: a loss is not finite: {m}")
    # the first step also pays the model loads and the data windows
    steady = step_s[1:] or step_s
    r = {"step_ms": 1e3 * float(np.median(steady)), "peak_gb": peak_gb, "launches": launches,
         "metrics": marks[-1][2], "steps": len(marks)}
    log("train", run=tag, steps=len(marks), step_ms=f"{r['step_ms']:.1f}",
        first_step_s=f"{step_s[0]:.1f}", peak_memory_GB=f"{peak_gb:.2f}",
        attention_launches_per_step=launches,
        **{k: f"{v:.4f}" for k, v in r["metrics"].items()})
    return r


def _unet_self_attention_leaves(unet) -> list:
    """(name, tensor) of the q/k/v/o weights of every U-Net self-attention."""
    blocks = [("mid", unet["mid"]["attn"])]
    for side in ("down", "up"):
        for i, blk in enumerate(unet[side]):
            blocks += [(f"{side}{i}.{j}", t) for j, t in enumerate(blk.get("attentions", []))]
    return [(f"{n}.{w}", tr["block"]["attn1"][w]["w"]) for n, tr in blocks for w in "qkvo"]


def phase_train(torch, attn, peak_bw: float, peak_f32: float, peak_tf32: float) -> dict:
    """Training on the card: the attention gradient, the MuseTalk full
    recipe at full width through ``train.cli.main`` (f32, B=10, 3 steps, the
    sync expert from a random SyncNet file, both GANs) with 20 attention
    launches a step; the U-Net self-attention gradients of the same step's
    forward (its latents' squared error) with the kernel against
    ``attention_plain`` in its place (each leaf's relative L2; f32
    deterministic convolutions);
    the step's FLOPs, busy share and peak memory; 2 bf16 L1 steps; one step with
    the MuseTalk expert (B=16, 22 launches); one Wav2Lip full-recipe step
    at 256 px, one Ultralight L1 step at 160 px and one SyncNet step."""
    import tempfile
    from types import SimpleNamespace

    from torch.utils.flop_counter import FlopCounterMode

    from livetalking_tpu_torch.avatars import musetalk_avatar
    from livetalking_tpu_torch.models import diffusion_blocks as db
    from livetalking_tpu_torch.models import musetalk_syncnet, syncnet
    from livetalking_tpu_torch.models.musetalk import positional_encoding_table
    from livetalking_tpu_torch.train import cli, syncnet_train
    from livetalking_tpu_torch.train import data as td
    from livetalking_tpu_torch.train import musetalk_train as mtt
    from livetalking_tpu_torch.utils.checkpoint import save_params
    from livetalking_tpu_torch.utils.tree import to_torch_tree

    ta = phase_train_attention(torch, attn, peak_bw, peak_f32)
    out = {"attention": ta}
    with tempfile.TemporaryDirectory(prefix="smoke_train_") as tmp:
        sync_pkl = os.path.join(tmp, "syncnet.pkl")
        save_params(sync_pkl, syncnet.init_params(2, 256))
        base = ["--family", "musetalk", "--size", "full", "--synthetic", "40",
                "--models_dir", os.path.join(tmp, "models"), "--lr", "1e-5"]
        full = _cli_run(torch, cli, attn, base + [
            "--dtype", "float32", "--recipe", "full", "--batch_size", str(TRAIN_B), "--steps",
            "3", "--sync_init", sync_pkl], "musetalk_f32_full")
        if full["launches"] != [TRAIN_LAUNCHES] * 3:
            raise AssertionError(f"attention launches per step {full['launches']}, want "
                                 f"{TRAIN_LAUNCHES} each")
        if not {"sync", "gan", "mouth_gan", "face_disc", "mouth_disc"} <= set(full["metrics"]):
            raise AssertionError(f"full recipe metrics {sorted(full['metrics'])}")
        out["musetalk_full"] = full
        torch.cuda.empty_cache()

        # the same step through the API: the gradient reaches the U-Net's
        # self-attention weights through the kernel's backward
        opt = SimpleNamespace(models_dir=os.path.join(tmp, "models"), dtype="float32",
                              device="cuda", musetalk_size="full")
        model = musetalk_avatar.load_model(opt)
        weights = mtt.LossWeights(sync=0.1, gan=0.05, mouth_gan=0.05)
        txs, step = mtt.make_train_step(model["unet_cfg"], weights, lr=1e-5, max_steps=3)
        state = mtt.init_train_state(1, model["unet_cfg"], txs, weights,
                                     unet_params=model["unet_params"], device="cuda")
        sync_p = syncnet.init_params(2, 256, device="cuda")
        rng = np.random.RandomState(0)
        faces = rng.randint(0, 255, (40, 256, 256, 3), dtype=np.uint8)
        t = np.arange(int(16000 * 40 / 25.0)) / 16000.0
        audio = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
        feats = td.whisper_windows(audio, model["whisper_params"], model["whisper_cfg"])
        batch = to_torch_tree(next(td.clip_batches("musetalk", faces, feats, TRAIN_B, rng,
                                                   clip_len=5, audio=audio)), "cuda")
        names, leaves = zip(*_unet_self_attention_leaves(state.unet))

        pe = torch.as_tensor(positional_encoding_table(50, model["unet_cfg"].cross_dim),
                             device="cuda")

        def link_grads():
            # the step's forward with a smooth loss: the recipe's L1 terms
            # are signs (and the decode clamps), so a 1e-6 change of the
            # prediction flips a few of its 2 M pixels and moves every
            # gradient by ~2e-3 whatever the attention does
            pred_lat, _, gt_lat = mtt.forward(state.unet, model["vae_params"],
                                              model["unet_cfg"], pe, batch["gt"], batch["ref"],
                                              batch["audio"])
            return torch.autograd.grad(((pred_lat - gt_lat) ** 2).mean(), leaves)

        # TF32 convolutions would round the two runs' inputs apart at 10 bits,
        # and cuDNN's nondeterministic backward would add noise: the check
        # runs its convolutions in f32, deterministically
        tf32, det = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = False, True
        attn.attention.launches = 0
        kernel = db.attention_kernel
        try:
            with_kernel = link_grads()
            kernel_launches = attn.attention.launches
            db.attention_kernel = attn.attention_plain
            plain = link_grads()
        finally:
            db.attention_kernel = kernel
            torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = tf32, det
        if kernel_launches != TRAIN_LAUNCHES or attn.attention.launches != kernel_launches:
            raise AssertionError(f"link check launches: {kernel_launches} with the kernel, "
                                 f"{attn.attention.launches - kernel_launches} with plain")
        # each leaf (a site's q, k, v or o weight) on its own; the per-site
        # relative L2 is logged beside it
        errs = [float((a - b).norm() / b.norm()) for a, b in zip(with_kernel, plain)]
        sites = {}
        for n, a, b in zip(names, with_kernel, plain):
            site = sites.setdefault(n.rsplit(".", 1)[0], [0.0, 0.0])
            site[0] += float((a - b).norm()) ** 2
            site[1] += float(b.norm()) ** 2
        site_err = {k: float(np.sqrt(d / w)) for k, (d, w) in sites.items()}
        worst = int(np.argmax(errs))
        if not errs[worst] <= GRAD_LINK_TOL or min(float(b.norm()) for b in plain) == 0.0:
            raise AssertionError(f"U-Net self-attention gradient of {names[worst]}: kernel vs "
                                 f"plain {errs[worst]} relative L2 > {GRAD_LINK_TOL}")
        order = np.argsort(errs)[::-1][:4]
        log("train", check="unet_self_attention_grads_kernel_vs_plain", leaves=len(errs),
            leaf_rel_l2_worst=[(names[i], f"{errs[i]:.2e}") for i in order],
            leaf_rel_l2_median=f"{float(np.median(errs)):.2e}",
            site_rel_l2_worst=f"{max(site_err.values()):.2e}", tol=GRAD_LINK_TOL)
        del with_kernel, plain

        def one_step():
            step(state, model["vae_params"], sync_p, batch)

        one_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            one_step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 2 * 1e3
        prof = profile_step(torch, one_step, 1, step_ms, "train_profile")
        with FlopCounterMode(display=False) as fc:
            one_step()
        # the forward kernel is opaque to the counter: 4*T*T*D per (batch, head)
        attn_fwd = sum(n * 4 * TRAIN_B * h * T * T * D for T, D, h, n, _ in TRAIN_ATTN_SHAPES)
        flops = fc.get_total_flops() + attn_fwd
        log("train", run="musetalk_f32_full_api", step_ms=f"{step_ms:.1f}",
            GFLOP_per_step=f"{flops / 1e9:.1f}",
            f32_bound_ms=f"{flops / peak_f32 * 1e3:.1f}",
            tf32_bound_ms=f"{flops / peak_tf32 * 1e3:.1f}",
            share_of_tf32_rate=f"{flops / peak_tf32 * 1e3 / step_ms:.3f}",
            device_busy_share=f"{prof['busy_share']:.3f}")
        out.update(link_err=max(errs), step_flops=flops, api_step_ms=step_ms,
                   busy_share=prof["busy_share"])
        del state, model, batch, step, txs, sync_p
        torch.cuda.empty_cache()

        out["musetalk_bf16_l1"] = _cli_run(torch, cli, attn, base + [
            "--dtype", "bfloat16", "--recipe", "l1", "--batch_size", str(TRAIN_B), "--steps",
            "2"], "musetalk_bf16_l1")
        torch.cuda.empty_cache()
        mt_pkl = os.path.join(tmp, "musetalk_syncnet.pkl")
        save_params(mt_pkl, musetalk_syncnet.init_params(0))
        mts = _cli_run(torch, cli, attn, base + [
            "--dtype", "float32", "--recipe", "full", "--sync_backend", "musetalk",
            "--batch_size", "16", "--steps", "2", "--sync_init", mt_pkl], "musetalk_mt_sync")
        if mts["launches"] != [TRAIN_LAUNCHES + MT_SYNC_LAUNCHES] * 2:
            raise AssertionError(f"attention launches with the MuseTalk expert "
                                 f"{mts['launches']}")
        out["musetalk_mt_sync"] = mts
        torch.cuda.empty_cache()

        out["wav2lip_full"] = _cli_run(torch, cli, attn, [
            "--family", "wav2lip", "--recipe", "full", "--batch_size", "5", "--steps", "2",
            "--synthetic", "20", "--models_dir", os.path.join(tmp, "models")], "wav2lip_full")
        out["ultralight_l1"] = _cli_run(torch, cli, attn, [
            "--family", "ultralight", "--recipe", "l1", "--batch_size", "8", "--steps", "2",
            "--synthetic", "20", "--size", "full", "--models_dir", os.path.join(tmp, "models")],
            "ultralight_l1")
        torch.cuda.empty_cache()

    sp = syncnet.init_params(3, 256, device="cuda")
    tx, sstep = syncnet_train.make_train_step(1e-4)
    sopt = tx.init(sp)
    g = torch.Generator(device="cuda").manual_seed(4)
    faces = torch.rand((16, 128, 256, 15), device="cuda", generator=g)
    mels = torch.randn((16, 80, 16, 1), device="cuda", generator=g)
    labels = (torch.arange(16, device="cuda") % 2).float()
    sstep(sp, sopt, faces, mels, labels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = float(sstep(sp, sopt, faces, mels, labels)[2])  # on the host: the step is done
    sync_ms = (time.perf_counter() - t0) * 1e3
    if not np.isfinite(loss):
        raise AssertionError(f"syncnet step: loss {loss}")
    log("train", run="syncnet", B=16, img=256, step_ms=f"{sync_ms:.1f}", loss=f"{loss:.4f}")
    out["syncnet_step_ms"] = sync_ms
    return out


MESH_LSB = 1  # tests/test_parallel.py's bar for the sharded steps
# --mesh training against one rank: the losses, and each gradient leaf
# (relative L2). The recipes' L1 terms have sign gradients, and rounding
# that depends on the batch split flips some: tests/test_torch_parallel.py
# measured 1e-2 on the CPU, so not 1e-5
TRAIN_LOSS_REL, TRAIN_GRAD_REL = 1e-6, 5e-2


def _nccl_same_card(rank: int, path: str, q) -> None:
    """One of two NCCL ranks on cuda:0 (spawned): the error NCCL gives."""
    import datetime

    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=dist.FileStore(path, 2), rank=rank, world_size=2,
                                timeout=datetime.timedelta(seconds=30))
        t = torch.ones(1, device="cuda:0")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        q.put((rank, f"no error (sum {float(t)})"))
    except Exception as e:  # the point: report what NCCL said
        q.put((rank, f"{type(e).__name__}: {' '.join(str(e).split())[:240]}"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def nccl_same_card_error() -> list:
    """Two NCCL ranks on one card: what each reports (joined within 90 s)."""
    import multiprocessing
    import tempfile

    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_nccl_same_card, args=(r, os.path.join(tmp, "store"), q),
                             daemon=True) for r in range(2)]
        for p in procs:
            p.start()
        out = []
        for _ in procs:
            try:
                out.append(q.get(timeout=90))
            except queue.Empty:
                out.append((None, "no answer within 90 s"))
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
    return sorted(out, key=lambda r: -1 if r[0] is None else r[0])


def gloo_cuda_probe() -> dict:
    """On each rank: which collectives gloo takes on CUDA tensors."""
    import torch
    import torch.distributed as dist

    t = torch.ones(4, device="cuda")
    calls = {"all_reduce": lambda: dist.all_reduce(t),
             "broadcast": lambda: dist.broadcast(t, 0),
             "all_gather": lambda: dist.all_gather_into_tensor(
                 torch.empty(4 * dist.get_world_size(), device="cuda"), t)}
    out = {}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize()
            out[name] = "accepted"
        except Exception as e:  # the probe's answer
            out[name] = f"refused ({type(e).__name__}: {' '.join(str(e).split())[:120]})"
    return out


def train_ok(r: dict, dryrun) -> bool:
    """``--mesh`` training against one rank: losses, gradient leaves (the
    cancelled ones in absolute terms, ``dryrun.train_parity``)."""
    return (r["loss_rel"] <= TRAIN_LOSS_REL and r["grad_rel"] <= TRAIN_GRAD_REL
            and r["cancelled_err"] <= dryrun.CANCELLED)


def _mesh_checks(tag: str, ranks, dryrun, cfg, inputs, train_argv) -> dict:
    """The full-width MuseTalk step at dp=2 and at tp=2 against the single-
    device step, one coalesced scheduler round with the masked paste, and
    ``--mesh dp=2`` training held to one rank, on two ranks."""
    out = {}
    for spec in ("dp=2", "dp=1,tp=2"):
        rs = ranks.run(dryrun.musetalk_frames, 1, cfg, *inputs, spec=spec, dtype="float32",
                       single=True, timed=1, timeout_s=300)
        d = dryrun.lsb(rs[0]["frames"], rs[0]["single"])
        launches = [r["attention_launches"] for r in rs]
        log(f"{tag}_step", mesh=spec.replace(",", "x"), dtype="float32", max_lsb=d,
            attention_launches_per_rank=launches,
            step_ms_per_rank=[f"{r['step_ms']:.3f}" for r in rs],
            tp_gathers=rs[0]["tp_gathers"], tp_gather_mb=f"{rs[0]['tp_gather_bytes'] / 1e6:.1f}",
            tp_gather_ms=f"{rs[0]['tp_gather_s'] * 1e3:.3f}",
            dp_gather_mb=f"{rs[0]['dp_gather_bytes'] / 1e6:.2f}",
            dp_gather_ms=f"{rs[0]['dp_gather_s'] * 1e3:.3f}")
        if d > MESH_LSB or min(launches) < 1:
            raise AssertionError(f"{tag} {spec}: {d} LSB from the single-device step, "
                                 f"attention launches {launches}")
        out[spec] = {"lsb": d, "attention_launches": launches}
    rs = ranks.run(dryrun.scheduler_round, 1, cfg, dtype="float32", B=8, S=256, frame=320,
                   timeout_s=300)
    d = dryrun.lsb(rs[0]["frames"], rs[0]["single"])
    log(f"{tag}_round", batches=rs[0]["batches"], frames=rs[0]["frames"].shape, max_lsb=d,
        paste_launches=rs[0]["paste_launches"], follower_batches=rs[1]["served"])
    if rs[0]["batches"] != 1 or rs[1]["served"] != 1 or d > MESH_LSB or rs[0]["paste_launches"] < 1:
        raise AssertionError(f"{tag} scheduler round: {rs[0]['batches']} batches, {d} LSB, "
                             f"{rs[0]['paste_launches']} paste launches")
    out["round"] = {"lsb": d, "paste_launches": rs[0]["paste_launches"]}
    rs = ranks.run(dryrun.train_parity, train_argv, timeout_s=420)
    r0 = rs[0]
    ar = [sum(b for b, _ in r["all_reduce"]) for r in rs]
    log(f"{tag}_train", argv=" ".join(train_argv), loss_rel=f"{r0['loss_rel']:.3e}",
        grad_rel=f"{r0['grad_rel']:.3e}", cancelled_err=f"{r0['cancelled_err']:.3e}",
        leaves=r0["leaves"],
        peak_gb_per_rank=[f"{r['peak_gb']:.2f}" for r in rs],
        step_ms_per_rank=[f"{r['step_s'] * 1e3:.1f}" for r in rs],
        one_rank_step_ms=f"{r0['ref_step_s'] * 1e3:.1f}",
        all_reduce_mb=f"{ar[0] / 1e6:.1f}", all_reduce_calls=len(r0["all_reduce"]),
        all_reduce_ms=f"{sum(t for _, t in r0['all_reduce']) * 1e3:.1f}")
    if not train_ok(r0, dryrun):
        raise AssertionError(f"{tag} --mesh training differs from one rank: {r0}")
    out["train"] = r0
    return out


def phase_multigpu(torch) -> dict:
    """(a) every card over NCCL: the full-width sharded MuseTalk step bit
    for bit at one rank (1 LSB above), 2 ``--mesh`` training steps equal to
    one rank's; (b) two gloo ranks sharing cuda:0 (NCCL refuses that): the
    step at dp=2 and tp=2, one coalesced scheduler round with the masked
    paste, ``--mesh dp=2`` MuseTalk L1 training at full width; (c) with two
    cards or more, (b) over NCCL on distinct cards. Two ranks on one card
    check the sharded arithmetic and the collectives' cost, not scaling."""
    from livetalking_tpu_torch.models import sd_unet
    from livetalking_tpu_torch.parallel import dist as pdist
    from livetalking_tpu_torch.parallel import dryrun

    torch.cuda.empty_cache()
    n = torch.cuda.device_count()
    cfg = sd_unet.MUSETALK
    rng = np.random.default_rng(0)
    B = 16
    inputs = (rng.standard_normal((8, 32, 32, 8)).astype(np.float32),
              (np.arange(B) % 8).astype(np.int32),
              rng.standard_normal((B, 50, 384)).astype(np.float32))
    out = {}
    # one rank: the served dtype, bit for bit; more: f32 (bf16 steps of other
    # batch splits are other roundings), within 1 LSB
    dtype = "bfloat16" if n == 1 else "float32"
    with pdist.Ranks(n) as ranks:
        rs = ranks.run(dryrun.musetalk_frames, 1, cfg, *inputs, dtype=dtype, single=True,
                       timed=3, timeout_s=300)
        d = dryrun.lsb(rs[0]["frames"], rs[0]["single"])
        launches = [r["attention_launches"] for r in rs]
        log("multigpu_nccl_step", ranks=n, mesh=f"{n // (2 if n % 2 == 0 and n >= 4 else 1)}x"
            f"{2 if n % 2 == 0 and n >= 4 else 1}", dtype=dtype, max_lsb=d,
            attention_launches_per_rank=launches,
            step_ms_per_rank=[f"{r['step_ms']:.3f}" for r in rs],
            tp_gather_mb=f"{rs[0]['tp_gather_bytes'] / 1e6:.1f}")
        if d > (0 if n == 1 else MESH_LSB) or min(launches) < 1:
            raise AssertionError(f"NCCL sharded step at {n} rank(s): {d} LSB, launches {launches}")
        argv = ["--family", "musetalk", "--size", "tiny", "--recipe", "l1", "--synthetic", "16",
                "--steps", "2", "--batch_size", str(n), "--mesh", f"dp={n}", "--device", "cuda"]
        r0 = ranks.run(dryrun.train_parity, argv, timeout_s=300)[0]
        log("multigpu_nccl_train", argv=" ".join(argv), loss_rel=f"{r0['loss_rel']:.3e}",
            grad_rel=f"{r0['grad_rel']:.3e}", cancelled_err=f"{r0['cancelled_err']:.3e}",
            leaves=r0["leaves"])
        if not train_ok(r0, dryrun):
            raise AssertionError(f"--mesh dp={n} training differs from one rank: {r0}")
        out["nccl"] = {"lsb": d, "attention_launches": launches, "train": r0}

    errs = nccl_same_card_error()
    log("multigpu_nccl_same_card", errors=json.dumps(errs))
    train_argv = ["--family", "musetalk", "--recipe", "l1", "--synthetic", "8", "--steps", "2",
                  "--batch_size", "2", "--mesh", "dp=2", "--device", "cuda"]
    with pdist.Ranks(2, backend="gloo", devices=["cuda:0", "cuda:0"]) as ranks:
        probe = ranks.run(gloo_cuda_probe, timeout_s=120)
        log("multigpu_gloo_probe", per_rank=json.dumps(probe))
        if any(v != "accepted" for r in probe for v in r.values()):
            raise AssertionError(f"gloo refuses a collective on CUDA tensors: {probe} (the "
                                 "port passes them as they are)")
        out["gloo"] = _mesh_checks("multigpu_gloo", ranks, dryrun, cfg, inputs, train_argv)
    if n >= 2:
        with pdist.Ranks(2) as ranks:
            out["nccl2"] = _mesh_checks("multigpu_nccl2", ranks, dryrun, cfg, inputs, train_argv)
    else:
        log("multigpu_nccl2", skipped="one CUDA device: the kernels on cuda:1 and NCCL across "
            "cards are not verified here")
    return out


def phase_profile_dir(torch, app, muse, attention, blend) -> dict:
    """``--profile_dir``'s profiler around one composed MuseTalk engine
    step (bf16, B=16, the masked paste): the trace it writes must hold CUDA
    kernel events of kernels 3 and 2."""
    import tempfile

    from livetalking_tpu_torch.engine.scheduler import AvatarStore
    from livetalking_tpu_torch.models import sd_unet, sd_vae
    from livetalking_tpu_torch.parallel import dryrun

    dev = torch.device("cuda")
    cfg = sd_unet.UNetConfig(**dryrun.DRY_UNET)
    params = (sd_unet.init_params(1, cfg, torch.bfloat16, dev),
              sd_vae.init_params(2, torch.bfloat16, dev))
    rng = np.random.default_rng(3)
    S, frame, B = 256, 480, 16
    cycles, aux = dryrun.round_avatars(rng, 8, S, S // 2, S // 2, frame, frame, (32, 32, 8))
    store = AvatarStore(item_shape=(32, 32, 8), dtype=np.float32, device=dev)
    store.add("p", cycles[0], aux=aux)
    step = muse.make_step_factory(cfg, torch.bfloat16, store,
                                  {"S": S, "H": frame, "W": frame, "Ho": S // 2, "Wo": S // 2})(B)
    idxs = torch.arange(B, device=dev, dtype=torch.int32) % 8
    feats = torch.from_numpy(rng.standard_normal((B, 50, 384)).astype(np.float32)).to(dev)
    step(params, store.buffer, idxs, feats)  # warm
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        stop = app.start_profiler(tmp, "cuda")
        step(params, store.buffer, idxs, feats)
        torch.cuda.synchronize()
        path = stop()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(path)
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    ours = {k: sorted(n[:60] for n in kernels if k in n) for k in ("attention", "paste_kernel")}
    log("profile_dir", trace_bytes=size, cuda_kernel_events=len(kernels),
        hand_written=json.dumps(ours))
    if not all(ours.values()):
        raise AssertionError(f"--profile_dir trace lacks the hand-written kernels: {ours}")
    return ours

TRANSPORT_AUDIO_TOL = 0.02  # decoded audio against the PCM the compose loop pushed: count, RMS


def speech_pcm24k(seconds: float, seed: int = 21) -> bytes:
    """A voice-like int16 stream at 24 kHz (a TTS server's rate): a gliding
    140-160 Hz fundamental and its third partial under a 3.5 Hz syllable
    envelope, a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(24000 * seconds)) / 24000
    phase = 2 * np.pi * np.cumsum(150 + 10 * np.sin(2 * np.pi * 0.5 * t)) / 24000
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 3.5 * t)
    x = env * (0.5 * np.sin(phase) + 0.25 * np.sin(3 * phase)) + 0.01 * rng.standard_normal(t.size)
    return (x * 12000).astype("<i2").tobytes()


@contextlib.contextmanager
def cosyvoice_stand_in(pcm: bytes):
    """The CosyVoice server's zero-shot endpoint on 127.0.0.1 (the card
    machine has no network): ``GET /inference_zero_shot`` streams ``pcm``
    (int16, 24 kHz) in 9600-byte chunks, as the provider does."""
    from aiohttp import web

    async def zero_shot(request):
        resp = web.StreamResponse(status=200)
        await resp.prepare(request)
        for i in range(0, len(pcm), 9600):
            await resp.write(pcm[i:i + 9600])
        await resp.write_eof()
        return resp

    web_app = web.Application()
    web_app.router.add_route("GET", "/inference_zero_shot", zero_shot)
    with serve_app(web_app) as base:
        yield base


class EgressProbe:
    """Host times of the compose thread's egress for one session: each
    ``push_video_frame`` (entry, exit), each ``AVMuxer.write_video`` of the
    transport's muxer and of the recorder's, and the PCM pushed to the
    transport and to the recorder."""

    def __init__(self, session, native):
        self.pushes, self.writes, self.rec_writes = [], [], []
        self.audio, self.recorded = [], []
        self._native, self._write = native, native.AVMuxer.write_video
        out, probe = session.output, self
        push_video, push_audio = out.push_video_frame, out.push_audio_frame
        record_audio = session.record_audio_data

        def timed_push(frame):
            t0 = time.perf_counter()
            push_video(frame)
            probe.pushes.append((t0, time.perf_counter()))

        def kept_audio(frame, eventpoint=None):
            probe.audio.append(np.array(frame, np.int16))
            push_audio(frame, eventpoint)

        def kept_record(frame):
            with session._record_lock:
                on = session.recording
            record_audio(frame)
            if on:
                probe.recorded.append(np.array(frame, np.int16))

        def timed_write(muxer, frame):
            t0 = time.perf_counter()
            probe._write(muxer, frame)
            kept = probe.writes if muxer is out._muxer else probe.rec_writes
            kept.append((t0, time.perf_counter()))

        out.push_video_frame, out.push_audio_frame = timed_push, kept_audio
        session.record_audio_data = kept_record
        native.AVMuxer.write_video = timed_write

    def restore(self) -> None:
        self._native.AVMuxer.write_video = self._write

    def summary(self, fps: int) -> dict:
        """Frames muxed, egress fps between the first and the last write, the
        median ``write_video`` ms, the compose thread's busy ms per frame (the
        interval between two pushes less the transport's pacing sleep) and
        the transport muxer's share of it (the recorder's encode, while it
        records, is part of the busy time)."""
        n = len(self.writes)
        if n < 2:
            return {"frames_muxed": n}
        write = np.array([b - a for a, b in self.writes]) * 1e3
        rec = np.array([b - a for a, b in self.rec_writes] or [np.nan]) * 1e3
        push = np.array([b - a for a, b in self.pushes]) * 1e3
        enter = np.array([a for a, _ in self.pushes]) * 1e3
        # the pushes that muxed are the last n (the muxer opens on the first)
        sleep = push[-n:] - write
        busy = np.diff(enter[-n:]) - sleep[:-1]
        return {"frames_muxed": n,
                "egress_fps": (n - 1) / (self.writes[-1][0] - self.writes[0][0]),
                "write_ms_p50": float(np.median(write)),
                "write_ms_p90": float(np.percentile(write, 90)),
                "record_write_ms_p50": float(np.median(rec)),
                "frames_recorded": len(self.rec_writes),
                "compose_busy_ms_p50": float(np.median(busy)),
                "write_share_of_busy": float(write[1:].sum() / busy.sum()),
                "write_share_of_period": float(np.median(write) * fps / 1e3)}


def audio_within(tag: str, got: np.ndarray, pushed: list) -> dict:
    """``got`` (decoded, float) against the int16 frames pushed: sample count
    and RMS within ``TRANSPORT_AUDIO_TOL``."""
    want = np.concatenate(pushed).astype(np.float64) / 32767
    rms_got, rms_want = float(np.sqrt(np.mean(got.astype(np.float64) ** 2))), float(
        np.sqrt(np.mean(want ** 2)))
    r = {"samples": int(got.shape[0]), "pushed": int(want.shape[0]),
         "count_err": abs(got.shape[0] - want.shape[0]) / want.shape[0],
         "rms_err": abs(rms_got - rms_want) / rms_want}
    if r["count_err"] > TRANSPORT_AUDIO_TOL or r["rms_err"] > TRANSPORT_AUDIO_TOL:
        raise AssertionError(f"{tag}: decoded audio {r} is not within {TRANSPORT_AUDIO_TOL} "
                             "of the PCM the compose loop pushed")
    return r


def webrtc_loopback(base: str, n_video: int = 100) -> dict:
    """A client ``RTCPeerConnection`` posts its offer to the port's ``/offer``,
    receives both tracks and pulls ``n_video`` video frames (after the first,
    which waits for the render pipeline), audio frames alongside."""
    import aiohttp
    from aiortc import RTCPeerConnection, RTCSessionDescription

    async def run():
        pc = RTCPeerConnection()
        pc.addTransceiver("video", direction="recvonly")
        pc.addTransceiver("audio", direction="recvonly")
        tracks, both = {}, asyncio.Event()

        @pc.on("track")
        def on_track(track):
            tracks[track.kind] = track
            if len(tracks) == 2:
                both.set()

        await pc.setLocalDescription(await pc.createOffer())
        async with aiohttp.ClientSession() as http:
            async with http.post(f"{base}/offer", json={"sdp": pc.localDescription.sdp,
                                                        "type": pc.localDescription.type}) as r:
                answer = await r.json()
        if "sdp" not in answer:
            raise AssertionError(f"/offer answered {answer}")
        await pc.setRemoteDescription(RTCSessionDescription(sdp=answer["sdp"],
                                                            type=answer["type"]))
        await asyncio.wait_for(both.wait(), 30)
        audio = [0]

        async def pull_audio():
            while True:
                await tracks["audio"].recv()
                audio[0] += 1

        puller = asyncio.ensure_future(pull_audio())
        await asyncio.wait_for(tracks["video"].recv(), 120)
        t0 = time.perf_counter()
        for _ in range(n_video):
            await asyncio.wait_for(tracks["video"].recv(), 10)
        fps = n_video / (time.perf_counter() - t0)
        puller.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await puller
        await pc.close()
        return {"video_fps": fps, "audio_frames": audio[0], "sessionid": answer["sessionid"]}

    return asyncio.run(run())


def virtualcam_rate(opt, frame: np.ndarray, n: int = 50) -> float:
    """``n`` frames through the ``virtualcam`` output plugin, imported by
    name as the session's plugin loader imports it (``pyvirtualcam`` is
    gated); the camera's paced frames per second."""
    import importlib

    from livetalking_tpu_torch.streamout import OUTPUT_MODULES

    vc = importlib.import_module(OUTPUT_MODULES["virtualcam"])
    cam = vc.VirtualCamOutput(opt=opt, parent=None)
    cam.start()
    t0 = time.perf_counter()
    for _ in range(n):
        cam.push_video_frame(frame.copy())
    fps = n / (time.perf_counter() - t0)
    cam.stop()
    return fps


def phase_transports(torch, app, plugin, blend, native, session_manager,
                     device: str = "cuda") -> dict:
    """The host edge on the main path: ``--model wav2lip --coalesce
    --device_paste_back`` at full width on the synthetic 480x640 avatar,
    ``--transport rtmp`` to a local ``.flv`` (the ``flv`` format, no server),
    ``--tts cosyvoice`` served by a local stand-in (10 s of speech through
    ``stream_pcm16``). Session 0 is booted as ``main()`` does for rtmp;
    ``/human``, ``/record`` and ``GET /record/0`` go through
    ``app.build_web_app()``. Kernel 1's count must rise, ``start`` and
    ``end`` arrive in order, and the audio decoded from the mp4 and the flv
    is within 2% of the PCM pushed. Prints the encoder, frame size, frames
    muxed, egress fps, ``write_video``'s host ms and share of the compose
    thread's time. Then WebRTC (an in-process loopback to ``/offer``) and
    the virtual camera, where ``aiortc``/``av`` and ``pyvirtualcam`` import;
    else a ``skipped=`` line each. The native module may be missing only
    for want of ``pkg-config`` or the ffmpeg development libraries (then
    recording takes the ffmpeg CLI, if there is one)."""
    import importlib.util
    import shutil
    import tempfile

    import requests

    from livetalking_tpu_torch.config import default_opt
    from livetalking_tpu_torch.utils.audio import load_pcm16k

    card = json.dumps(smi("name,power.limit") if device == "cuda" else "cpu")
    libs = bool(shutil.which("pkg-config")) and subprocess.run(
        ["pkg-config", "--exists", *native.FFMPEG_LIBS]).returncode == 0
    if libs:
        native.get_lib()  # everything it needs is here: a failed build fails the phase
        encoder, recorder = native.video_encoder_name(), "native"
        log("transports_native", lib=native.get_lib()._name, video_encoder=encoder,
            frame_size=f"{W}x{H}", card=card)
    else:
        try:
            native.build()
        except (OSError, RuntimeError, subprocess.CalledProcessError) as e:
            error = f"{type(e).__name__}: {e}"
        else:
            raise AssertionError("avmux built without pkg-config's ffmpeg libraries")
        encoder, recorder = None, ("ffmpeg" if shutil.which("ffmpeg") else None)
        log("transports_native", skipped=json.dumps(
            "no pkg-config or ffmpeg development libraries: " + " ".join(error.split())[:300]),
            recording=recorder or "skipped (no ffmpeg CLI either)")
    decode = native.decode_audio_bytes if recorder == "native" else load_pcm16k

    tmp = tempfile.mkdtemp(prefix="smoke_transports_")
    cwd = os.getcwd()
    os.chdir(tmp)  # the recording lands in ./data/record/0.mp4
    probe = None
    try:
        ref = os.path.join(tmp, "prompt.wav")
        with wave.open(ref, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((np.sin(np.arange(8000) * 0.2) * 8000).astype("<i2").tobytes())
        flv = os.path.join(tmp, "live.flv")
        app.global_avatars["smoke_t"] = make_avatar(plugin, "smoke_t", 8, 12, device)
        with cosyvoice_stand_in(speech_pcm24k(10.0)) as tts_url:
            opt = default_opt(model="wav2lip", transport="rtmp", push_url=flv, tts="cosyvoice",
                              TTS_SERVER=tts_url, REF_FILE=ref, REF_TEXT="prompt",
                              coalesce=True, device_paste_back=True, batch_size=16,
                              device=device, avatar_id="smoke_t", max_session=2, modelfile="",
                              stun="")
            app.load_plugin_stack(opt)
            session = app.build_avatar_session("0", {})
            session_manager.add_session("0", session)
            if type(session.output).__name__ != "RTMPOutput" or session.tts is None:
                raise AssertionError(f"session 0: output {session.output}, tts {session.tts}")
            probe = EgressProbe(session, native)
            events = queue.Queue()
            session.add_msgqueue(events)
            # the main path starts here: the kernel count from 0
            blend.blend_rect_.launches = 0
            t0 = time.time()
            app.start_render_thread("0")
            with serve_app(app.build_web_app()) as base:
                while len(probe.pushes) < 25 and time.time() - t0 < 120:
                    time.sleep(0.05)
                if recorder:
                    r = requests.post(f"{base}/record", json={"sessionid": "0",
                                                              "type": "start_record"}).json()
                    if r != {"code": 0, "msg": "ok"}:
                        raise AssertionError(f"/record start_record: {r}")
                r = requests.post(f"{base}/human", json={
                    "sessionid": "0", "type": "echo", "text": "the smoke test speaks."}).json()
                if r != {"code": 0, "msg": "ok"}:
                    raise AssertionError(f"/human: {r}")
                statuses, deadline = [], time.time() + 120
                while "end" not in statuses and time.time() < deadline:
                    with contextlib.suppress(queue.Empty):
                        statuses.append(json.loads(events.get(timeout=1))["status"])
                if statuses != ["start", "end"]:
                    raise AssertionError(f"eventpoints {statuses}, want start then end")
                time.sleep(0.5)  # a few ticks of silence after the utterance
                record = None
                if recorder:
                    r = requests.post(f"{base}/record", json={"sessionid": "0",
                                                              "type": "end_record"}).json()
                    if r != {"code": 0, "msg": "ok"}:
                        raise AssertionError(f"/record end_record: {r}")
                    got = requests.get(f"{base}/record/0", timeout=60)
                    if got.status_code != 200 or got.content[4:8] != b"ftyp":
                        raise AssertionError(f"GET /record/0: {got.status_code}, "
                                             f"{got.content[:16]!r}")
                    record = audio_within("record", decode(got.content), probe.recorded)
                elif requests.get(f"{base}/record/0", timeout=60).status_code != 404:
                    raise AssertionError("GET /record/0 without a recording must be 404")
                if not app.stop_render_thread("0", timeout=30):
                    raise AssertionError("session 0's render thread did not stop")
                session_manager.remove_session("0")
                launches = blend.blend_rect_.launches
                if launches == 0 and device == "cuda":  # the CPU runs its plain version
                    raise AssertionError("kernel 1 never launched during the transports phase")
                spoke_s = time.time() - t0
                egress = probe.summary(opt.fps)
                size = f"{W}x{H}"
                if recorder == "native":
                    with open(flv, "rb") as fh:
                        flv_audio = audio_within("flv", decode(fh.read()), probe.audio)
                    log("transports", video_encoder=encoder, frame_size=size,
                        frames_muxed=egress["frames_muxed"],
                        rtmp_egress_fps=f"{egress['egress_fps']:.2f}",
                        write_video_ms_p50=f"{egress['write_ms_p50']:.3f}",
                        write_video_ms_p90=f"{egress['write_ms_p90']:.3f}",
                        frames_recorded=egress["frames_recorded"],
                        record_write_video_ms_p50=f"{egress['record_write_ms_p50']:.3f}",
                        compose_busy_ms_p50=f"{egress['compose_busy_ms_p50']:.3f}",
                        write_share_of_compose=f"{egress['write_share_of_busy']:.3f}",
                        write_share_of_40ms=f"{egress['write_share_of_period']:.3f}",
                        card=card)
                    log("transports_audio", flv=json.dumps(flv_audio), record=json.dumps(record),
                        tol=TRANSPORT_AUDIO_TOL, card=card)
                else:
                    log("transports", video_encoder="skipped (no native muxer)", frame_size=size,
                        frames_muxed=egress["frames_muxed"], frames_composed=len(probe.pushes),
                        rtmp_egress_fps="not measured (no muxer)",
                        write_video_ms="not measured (no muxer)",
                        record=json.dumps(record), card=card)
                log("transports", kernel1_launches=launches, eventpoints=statuses,
                    tts="cosyvoice (stand-in, 10 s at 24 kHz)", seconds=f"{spoke_s:.1f}",
                    card=card)

                missing = [m for m in ("aiortc", "av") if importlib.util.find_spec(m) is None]
                if missing:
                    log("transports_webrtc", skipped=f"missing module(s): {','.join(missing)}")
                else:
                    app.opt.transport = "webrtc"  # the /offer session's output
                    rtc = webrtc_loopback(base)
                    deadline = time.time() + 30
                    while session_manager.has_session(rtc["sessionid"]) and time.time() < deadline:
                        time.sleep(0.1)
                    if session_manager.has_session(rtc["sessionid"]):
                        raise AssertionError("the /offer session outlived its peer connection")
                    log("transports_webrtc", received_video_fps=f"{rtc['video_fps']:.2f}",
                        audio_frames=rtc["audio_frames"], card=card)
        if importlib.util.find_spec("pyvirtualcam") is None:
            log("transports_virtualcam", skipped="missing module: pyvirtualcam")
        else:
            fps = virtualcam_rate(opt, app.global_avatars["smoke_t"]["frame_list_cycle"][0])
            log("transports_virtualcam", camera_fps=f"{fps:.2f}", card=card)
        return {"launches": launches, "egress": egress}
    finally:
        if probe is not None:
            probe.restore()
        plugin.reset_shared_scheduler()
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke test of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--paced", default="", metavar="N[,N...]",
                    help="after the phases, run MuseTalk sessions paced at 25 fps with and "
                         "without the shared feature coalescer at these session counts")
    paced = [int(v) for v in ap.parse_args(argv).paced.split(",") if v]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from livetalking_tpu_torch import app, native
    from livetalking_tpu_torch.audio_features import hubert_features
    from livetalking_tpu_torch.audio_features import whisper_features as wf
    from livetalking_tpu_torch.avatars import ernerf_avatar as ea
    from livetalking_tpu_torch.avatars import musetalk_avatar as muse
    from livetalking_tpu_torch.avatars import ultralight_avatar as ua
    from livetalking_tpu_torch.avatars import wav2lip_avatar as plugin
    from livetalking_tpu_torch.config import default_opt
    from livetalking_tpu_torch.models import bisenet, ernerf, hubert, pfld, s3fd
    from livetalking_tpu_torch.models import musetalk as mt
    from livetalking_tpu_torch.models import sd_unet, sd_vae
    from livetalking_tpu_torch.models import ultralight as ul
    from livetalking_tpu_torch.models import wav2lip as w2l
    from livetalking_tpu_torch.models import whisper_decoder, whisper_encoder
    from livetalking_tpu_torch.ops import _build, attention, blend, conv, norm
    from livetalking_tpu_torch.server import asr_server, textnorm
    from livetalking_tpu_torch.server.session_manager import session_manager
    from livetalking_tpu_torch.utils import synthetic

    t_start = time.time()
    card = smi("name,power.limit")
    name = torch.cuda.get_device_name(0)
    cc = torch.cuda.get_device_capability(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    print(card, flush=True)
    log("device", name=json.dumps(name), capability=cc, count=torch.cuda.device_count(),
        sms=sms, max_sm_clock_mhz=clock_mhz, torch=torch.__version__, cuda=torch.version.cuda)
    if cc != (9, 0):
        raise AssertionError(f"compute capability {cc}, the kernels target sm_90a")
    peaks = [p[1:] for p in PEAKS if p[0] in name]
    if not peaks:
        raise AssertionError(f"no peak rates known for {name}")
    peak_bw, peak_f32, peak_bf16 = peaks[0]
    peak_int8 = 2 * peak_bf16  # dense int8 tensor-core rate: twice bf16 on Hopper
    exp_rate = EXP_PER_SM_CLOCK * sms * clock_mhz * 1e6

    def timed(phase, fn, *args):
        t0 = time.time()
        out = fn(*args)
        log(phase, seconds=f"{time.time() - t0:.1f}")
        return out

    t0 = time.time()
    ptxas = [start_ptxas_report(_build, source) for source in ("conv", "blend", "norm")]
    libs = _build.build_all()
    log("build", seconds=f"{time.time() - t0:.2f}", libs=sorted(libs))
    for proc in ptxas:
        log_ptxas_report(proc)

    b = timed("blend", phase_blend, torch, blend, peak_bw, peak_f32, clock_mhz * 1e6)
    bm = timed("blend_mask", phase_blend_mask, torch, blend, synthetic, peak_bw, peak_f32,
               clock_mhz * 1e6)
    b168 = timed("blend_s168", phase_blend, torch, blend, peak_bw, peak_f32, clock_mhz * 1e6,
                 168, UL_PASTE_SHAPES, "blend_s168", 169)
    for r in (b, bm):
        check_one_kernel_per_paste(torch, r["step"])
    log("paste_kernels_per_call", rect=1, mask=1)
    at = timed("attention", phase_attention, torch, attention, peak_bw, peak_bf16, exp_rate)
    k4 = timed("conv_int8", phase_conv_int8, torch, conv, sd_unet, sd_vae, peak_bw, peak_int8,
               clock_mhz * 1e6)
    k5 = timed("gnq", phase_gnq, torch, conv, sd_vae, peak_bw, peak_f32, peak_int8)
    timed("model", phase_model, torch, w2l)
    mm = timed("musetalk_model", phase_musetalk_model, torch, muse, mt, attention, norm, wf)
    k6 = timed("norm", phase_norm, torch, norm, mm["norm_sites"], peak_bw, clock_mhz * 1e6)
    timed("musetalk_int8_model", phase_musetalk_int8_model, torch, muse, mt, conv, attention,
          wf, synthetic, sd_vae)
    e = timed("engine", phase_engine, torch, app, plugin, blend, session_manager)
    me = timed("musetalk_engine", phase_musetalk_engine, torch, app, muse, blend, attention,
               conv, norm, synthetic, sd_vae, session_manager)
    qe = timed("musetalk_int8_engine", phase_musetalk_engine, torch, app, muse, blend,
               attention, conv, norm, synthetic, sd_vae, session_manager, True)
    timed("hubert", phase_hubert, torch, hubert, ul, hubert_features, default_opt, peak_bw,
          peak_f32)
    timed("ultralight_model", phase_ultralight_model, torch, ul, synthetic, peak_bw, peak_bf16)
    ue = timed("ultralight_engine", phase_ultralight_engine, torch, app, ua, ul, blend,
               synthetic, session_manager)
    timed("ernerf", phase_ernerf, torch, app, ea, ernerf, synthetic, session_manager)
    timed("stt", phase_stt, torch, app, asr_server, whisper_decoder, whisper_encoder, textnorm)
    timed("face_models", phase_face_models, torch, s3fd, bisenet, pfld, peak_bf16 / 2)
    timed("genavatar", phase_genavatar, torch, app, session_manager)
    torch.cuda.empty_cache()
    tr = timed("train", phase_train, torch, attention, peak_bw, peak_f32, peak_bf16 / 2)
    mg = timed("multigpu", phase_multigpu, torch)
    timed("profile_dir", phase_profile_dir, torch, app, muse, attention, blend)
    tp = timed("transports", phase_transports, torch, app, plugin, blend, native,
               session_manager)
    if paced:
        timed("paced", phase_paced_ab, torch, app, muse, synthetic, sd_vae, session_manager,
              paced)

    def row(name, source, replaces, launches, err, r, library_ms):
        extra = {k: r[k] for k in ("device_ms", "gather_ms", "library_note") if k in r}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": library_ms, **extra}

    def paste_row(r):
        """The fused paste at B=128, 480x640, from a store of real cycle
        length: ``ms`` by ``cuda_ms``, with its ``device_ms`` and, as context,
        the gather it absorbs."""
        return {"ms": r["paste_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["paste_bound_ms"],
                "bound_by": r["paste_bound_by"], "device_ms": r["paste_device_ms"],
                "gather_ms": r["gather_ms"], "library_note": NO_LIBRARY}

    src = "livetalking_tpu_torch/csrc/"
    s168 = b168["rows"][(H, W, 128, 400)]
    kernels = [
        {**row("blend", src + "blend.cu", "livetalking_tpu/ops/pallas_blend.py:116",
               e["launches"], max(b["max_abs_err"], b168["max_abs_err"]),
               paste_row(b["rows"][(H, W, 128, 400)]), None),
         # the Ultralight path's own run of kernel 1 (S = 168, B=128, 400-frame store),
         # and the transports phase's (wav2lip through --transport rtmp)
         "ultralight_launches": ue["launches"], "transports_launches": tp["launches"],
         "s168_ms": s168["paste_ms"],
         "s168_device_ms": s168["paste_device_ms"], "s168_plain_ms": s168["plain_ms"],
         "s168_bound_ms": s168["paste_bound_ms"], "s168_bound_by": s168["paste_bound_by"]},
        {**row("blend_mask", src + "blend.cu", "livetalking_tpu/ops/pallas_blend.py:141",
               me["blend_mask"], bm["max_abs_err"], paste_row(bm["rows"][(H, W, 128, 400)]),
               None),
         # the sharded scheduler round on rank 0 (two gloo ranks on one card)
         "multigpu_launches": mg["gloo"]["round"]["paste_launches"]},
        {**row("attention", src + "attention.cu", "livetalking_tpu/ops/pallas_attention.py:79",
               me["attention"], at["max_abs_err"], at["step"], at["step"]["library_ms"]),
         # the training step: forward launches of the f32 full-recipe run
         # (3 steps) and the PyTorch backward's time per step (B=10, f32)
         "train_launches": sum(tr["musetalk_full"]["launches"]),
         # one sharded step on each rank: NCCL over every card, gloo dp=2, tp=2
         "multigpu_launches": {"nccl": mg["nccl"]["attention_launches"],
                               **{k: v["attention_launches"] for k, v in mg["gloo"].items()
                                  if k in ("dp=2", "dp=1,tp=2")}},
         "backward_ms": tr["attention"]["backward_ms"],
         "train_forward_ms": tr["attention"]["forward_ms"]},
        row("conv3x3_q", src + "conv.cu", "livetalking_tpu/ops/pallas_conv.py:130",
            qe["conv3x3_q"], k4["max_abs_err"], k4["step"], None),
        row("conv3x3_gnq", src + "conv.cu", "livetalking_tpu/ops/pallas_conv.py:324",
            qe["conv3x3_gnq"], k5["max_abs_err"], k5["step"], None),
        # kernel 6 replaces no TPU kernel (XLA fuses GroupNorm); its error: the
        # largest excess over norm_against_plain's bound (<= 0); ms and
        # device_ms per bf16 step at B=16, and at B=128 beside them; library_ms:
        # F.group_norm on the NCHW view (then F.silu), the same function
        {**row("group_norm", src + "norm.cu", None, me["group_norm"], k6["max_excess"],
               {**k6["steps"][16], "bound_by": "bytes"}, k6["steps"][16]["library_ms"]),
         "int8_launches": qe["group_norm"],
         "b128_ms": k6["steps"][128]["ms"], "b128_device_ms": k6["steps"][128]["device_ms"],
         "b128_plain_ms": k6["steps"][128]["plain_ms"],
         "b128_library_ms": k6["steps"][128]["library_ms"],
         "b128_bound_ms": k6["steps"][128]["bound_ms"]},
    ]
    log("done", seconds=f"{time.time() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
