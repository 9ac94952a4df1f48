"""The port's Wav2Lip-256 path against the benchmark's plain reference
(``ltbench/reference_wav2lip.py``) on the CPU, at the published widths.

The reference imports nothing of the port and keeps BatchNorm unfolded, so
these tests hold the port's checkpoint converter (BatchNorm folding, the
transposed convs' layout), its step (gather, lower-half mask, [masked,
reference] channels, /255, uint8), its mel front-end and kernel 1's plain
version to LiveTalking's published computation. Also: the mel front-end's
request counter, which the benchmark reads.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from livetalking_tpu_torch.avatars import wav2lip_avatar as plugin
from livetalking_tpu_torch.config import default_opt
from livetalking_tpu_torch.models import wav2lip as w2l
from livetalking_tpu_torch.ops import mel as mel_ops
from livetalking_tpu_torch.ops.blend import bucket_shape, paste_rect
from livetalking_tpu_torch.utils import spans
from ltbench import avatars as lt_avatars
from ltbench import reference_wav2lip as ref
from ltbench import weights_wav2lip
from ltbench.traffic import Speech
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 33 + 17


def _config() -> dict:
    with open(os.path.join(ROOT, "ltbench", "configs", "wav2lip256_bf16.json")) as f:
        cfg = json.load(f)
    cfg["weights"]["calibration_avatars"] = 1   # two calibration frames: one pass at B=2
    return cfg


@pytest.fixture(scope="module")
def model():
    cfg = _config()
    avs = lt_avatars.make({"frames": 4, "frame_hw": [120, 160]}, SEED, 2, "cpu")
    sd = weights_wav2lip.state_dict(cfg, SEED, "cpu", avs)
    return cfg, avs, sd, w2l.convert_torch_state_dict(sd).eval()


def _speech_windows(cfg, session: int) -> torch.Tensor:
    pcm = np.concatenate([Speech(SEED).chunk(session, c) for c in range(52)])
    return ref.mel_windows(ref.log_mel(torch.from_numpy(pcm), cfg["mel"]), 16, 10, 25, 16)


def test_step_matches_the_reference_on_the_unfolded_checkpoint(model):
    """The port's served step (f32), its weights through the checkpoint
    converter, against the reference's network on the unfolded layout, at
    B=2 on an avatar the BatchNorm statistics were not set on: the sigmoid's
    input (read at the port's last conv) and the 8-bit faces."""
    cfg, avs, sd, net = model
    mel = _speech_windows(cfg, 1)[[3, 11]]
    faces = torch.from_numpy(np.ascontiguousarray(avs[1]["faces"][[1, 3]]))
    seen = []
    hook = net.output_block[-1].conv.register_forward_hook(lambda _m, _i, out: seen.append(out))
    step = w2l.make_infer_fn(2, 256, torch.float32)
    try:
        got = step(net, faces, torch.tensor([0, 1]), mel)
    finally:
        hook.remove()
    with torch.inference_mode():
        logits = ref.network(sd, cfg, mel[:, None], ref.face_input(faces))
    # float32 both sides: folding BatchNorm into the convs and the convs'
    # own summation order reassociate the sums of a 55-layer network; with
    # two calibration frames these weights amplify a perturbation more than
    # the benchmark's, so the bound is relative to the logits' spread
    # (measured: under 1e-5 of it)
    err = float((seen[0] - logits).abs().max()) / float(logits.std())
    assert err < 1e-4, err
    # 8-bit levels: the same values rounded; a last-bit difference may flip
    # a level that lies on a rounding boundary
    assert int((got.int() - ref.faces_u8(logits).int()).abs().max()) <= 1


def test_mel_windows_match_the_reference(model):
    """``ops/mel.py``'s request (52 chunks: l + r context and 2B new) against
    the reference's log-mel and window cut."""
    cfg = model[0]
    pcm = np.concatenate([Speech(SEED).chunk(0, c) for c in range(100, 152)])
    got = mel_ops.make_mel_chunks_fn(16, 10, 10, 25, device="cpu")(pcm)
    want = ref.mel_windows(ref.log_mel(torch.from_numpy(pcm), cfg["mel"]), 16, 10, 25, 16)
    assert got.shape == want.shape == (16, 80, 16)
    # both float32 on the [-4, 4] scale: an rfft of framed windows against
    # torch.stft, a filterbank built twice; 1e-3 is 0.0125 dB
    assert float((got - want).abs().max()) < 1e-3


def test_rect_paste_matches_the_reference(model):
    """Kernel 1's plain version (``paste_rect`` on CPU tensors) against the
    reference's resize-paste, at the benchmark's 480x640 frames and box."""
    avs = lt_avatars.make({"frames": 3, "frame_hw": [480, 640]}, SEED + 1, 1, "cpu")[0]
    frames = torch.from_numpy(np.stack(avs["frames"]))
    yyxx = [(y1, y2, x1, x2) for (x1, y1, x2, y2) in avs["coords"]]
    Ho, Wo = bucket_shape(yyxx)
    pred = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (4, 256, 256, 3),
                                                              dtype=np.uint8))
    idx = torch.tensor([2, 0, 1, 2])
    got = paste_rect(pred, frames, idx, torch.tensor(yyxx, dtype=torch.int32), Ho=Ho, Wo=Wo)
    for b, i in enumerate(idx.tolist()):
        want = ref.paste(pred[b], frames[i], avs["coords"][i])
        # float resize both sides, rounded once; the sums differ in order
        assert int((got[b].int() - want.int()).abs().max()) <= 1
        assert torch.equal(got[b][:, :avs["coords"][i][0]], frames[i][:, :avs["coords"][i][0]])


def test_mel_request_counter_and_encode_span_per_step():
    """One CPU wav2lip session: each ``run_step`` that makes features
    advances the mel front-end's request counter by one and closes one
    ``features.encode`` span."""
    opt = default_opt(transport="queue", tts="dummy", batch_size=2, dtype="float32",
                      device="cpu", sessionid="mel-counter")
    model = {"net": w2l.prepare(w2l.Wav2Lip(), "cpu", torch.float32), "dtype": torch.float32,
             "device": torch.device("cpu")}
    rng = np.random.default_rng(4)
    avatar = plugin.avatar_from_arrays(
        "mel-counter", [rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)] * 2,
        rng.integers(0, 256, (2, 256, 256, 3), dtype=np.uint8), [(30, 90, 50, 110)] * 2,
        device="cpu")
    session = plugin.LipReal(opt, model, avatar)
    chunk = np.zeros(320, np.float32)
    spans.clear()
    before = mel_ops.make_mel_chunks_fn.requests
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for step in range(3):
            for _ in range(4):
                session.put_audio_frame(chunk + 0.01 * step)
            session.asr.run_step()
            session.asr.get_next_feat(timeout=5)
            assert mel_ops.make_mel_chunks_fn.requests == before + step + 1
    encodes = [s for s in spans.snapshot().spans if s.name == "features.encode"]
    assert len(encodes) == 3 and len({s.rid for s in encodes}) == 3
