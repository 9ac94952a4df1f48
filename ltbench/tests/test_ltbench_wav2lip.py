"""The Wav2Lip family on the CPU: its check at test widths (the reference
against itself, planted faults, the control), its work counts against the
port's module, ``paste_roofline``'s byte count and reading, and whole runs
of the cell through the port at the published widths, sound and with faults
planted under the timed path."""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import types

import numpy as np
import pytest
import torch

from ltbench import avatars, check_wav2lip, reference_wav2lip as ref, weights_wav2lip
from ltbench import work_wav2lip
from ltbench.drive import Observed, SessionLog, mirror_index
from ltbench.spec import Spec
from ltbench.tests.conftest import ROOT
from ltbench.trace import TraceData
from ltbench.traffic import Speech
from ltbench.work import PEAKS, flops

SEED = 2 ** 32 + 901
family = Spec(ROOT).family("wav2lip")
paste_metric = Spec(ROOT)._module("metrics", "paste_roofline")


def _config() -> dict:
    with open(os.path.join(ROOT, "ltbench", "configs", "wav2lip256_bf16.json")) as f:
        return json.load(f)


def _narrow(spec: list) -> list:
    """A layer at a quarter of its published channels (the 6-channel face, the
    mel and the 3 output channels kept)."""
    cin, cout = spec[:2]
    return [cin if cin in (1, 6) else cin // 4, cout if cout == 3 else cout // 4] + spec[2:]


def test_config() -> dict:
    """Every structure of Wav2Lip-256 at 256 px with a quarter of the channels,
    batches of 4 frames, small avatars."""
    cfg = _config()
    cfg["face_encoder"] = [[_narrow(s) for s in b] for b in cfg["face_encoder"]]
    cfg["face_decoder"] = [[_narrow(s) for s in b] for b in cfg["face_decoder"]]
    cfg["audio_encoder"] = [_narrow(s) for s in cfg["audio_encoder"]]
    cfg["output_block"] = [_narrow(s) for s in cfg["output_block"]]
    cfg["avatar"].update(frames=6, frame_hw=[120, 160])
    cfg["program"].update(batch_size=4, coalesce_buckets="1,2", dtype="float32")
    cfg["weights"]["calibration_avatars"] = 4
    return cfg


test_config.__test__ = False


@pytest.fixture(scope="module")
def model_at_test_widths():
    cfg = test_config()
    avs = avatars.make(cfg["avatar"], SEED, 4, "cpu")
    return cfg, weights_wav2lip.state_dict(cfg, SEED, "cpu", avs), avs


def _served_by_reference(cfg, sd, avs, fault=None) -> Observed:
    """Two sessions' window as the reference itself would serve it, or with
    ``fault`` planted: every audio item speech after the warm-up's r silent
    ones, and 4 kept frames a session worked out from that speech.
    ``mel_shift``: each frame reads the next frame's mel window; ``no_mask``:
    the lower half left in the masked face; ``box_shift``: the face pasted one
    pixel right."""
    B, r = cfg["program"]["batch_size"], cfg["serving"]["r"]
    speech = Speech(SEED)
    logs = []
    for k in range(2):
        log = SessionLog(audio=[-1] * r + list(range(200)))
        for n in (5, 9, 14, 17):   # none the last of its batch: mel_shift reads the next
            mel = check_wav2lip.mel_rows(cfg, speech, log.audio, k, n // B, B, "cpu")
            mel = mel[n % B + (fault == "mel_shift")][None]
            i = mirror_index(len(avs[k]["frames"]), n)
            face = ref.face_input(torch.from_numpy(avs[k]["faces"][i][None]))
            if fault == "no_mask":
                face = torch.cat([face[:, 3:], face[:, 3:]], dim=1)
            with torch.inference_mode():
                out = ref.faces_u8(ref.network(sd, cfg, mel, face))[0]
            x1, y1, x2, y2 = avs[k]["coords"][i]
            box = (x1 + 1, y1, x2 + 1, y2) if fault == "box_shift" else (x1, y1, x2, y2)
            log.kept[n] = ref.paste(out, torch.from_numpy(avs[k]["frames"][i]), box).numpy()
        logs.append(log)
    return Observed(logs, 0.0, 1.0, {})


def _compare(cfg, sd, avs, obs):
    return check_wav2lip.compare(cfg, sd, avs, obs, SEED, "cpu")


def _correct(numbers) -> bool:
    return all(v["limit"] is None or v["value"] <= v["limit"] for v in numbers.values())


def test_check_passes_the_reference_against_itself(model_at_test_widths):
    cfg, sd, avs = model_at_test_widths
    got = _compare(cfg, sd, avs, _served_by_reference(cfg, sd, avs))
    assert _correct(got), got
    # the same function in blocks of another size: a level flips where a
    # value lies on a rounding boundary
    assert got["worst_frame_mse"]["value"] < 0.01 and got["frames_checked"]["value"] == 8
    # the sigmoid's input spreads over its responsive range
    assert 0.5 < got["reference_logit_std"]["value"] < 3.0
    assert got["reference_level_std"]["value"] > 30


@pytest.mark.parametrize("fault", ["mel_shift", "no_mask", "box_shift"])
def test_planted_faults_fail_the_check(model_at_test_widths, fault):
    cfg, sd, avs = model_at_test_widths
    got = _compare(cfg, sd, avs, _served_by_reference(cfg, sd, avs, fault))
    assert not _correct(got), got


def test_control_fails_the_check(model_at_test_widths):
    cfg, sd, avs = model_at_test_widths
    got = _compare(family.control(cfg), sd, avs, _served_by_reference(cfg, sd, avs))
    assert not _correct(got), got
    assert got["outside_crop_diff_px"]["value"] == 0   # it fails on the face alone


def test_the_reference_stands_apart():
    """The reference, the weights, the check and the work counts import
    nothing of the program, of the JAX package or of JAX; the reference
    runs with TF32 off."""
    import ast

    for name in ("reference_wav2lip", "weights_wav2lip", "check_wav2lip", "work_wav2lip"):
        with open(os.path.join(ROOT, "ltbench", f"{name}.py")) as f:
            tree = ast.parse(f.read())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
        assert not {m.split(".")[0] for m in mods} & {"livetalking_tpu_torch", "livetalking_tpu",
                                                        "jax", "jaxlib", "flax"}, (name, mods)
    cfg = test_config()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    sd = {k: torch.zeros(shape) for k, shape, _kind, _fan in weights_wav2lip.specs(cfg)}
    with torch.inference_mode():
        ref.network(sd, cfg, torch.zeros(1, 1, 80, 16), torch.zeros(1, 6, 256, 256))
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


def test_config_tables_are_the_ports_architecture():
    from livetalking_tpu_torch.models import wav2lip as w2l

    cfg = _config()

    def specs(rows):
        return [(r[0], r[1], r[2], tuple(r[3]) if isinstance(r[3], list) else r[3], r[4],
                 r[5] == "res", r[5] == "tconv", r[6] if r[5] == "tconv" else 0,
                 r[5] != "out") for r in rows]

    def port(rows):
        return [(s.cin, s.cout, s.kernel, s.stride, s.padding, s.residual, s.transpose,
                 s.output_padding, s.bn) for s in rows]

    assert [specs(b) for b in cfg["face_encoder"]] == [port(b) for b in w2l.FACE_ENCODER]
    assert specs(cfg["audio_encoder"]) == port(w2l.AUDIO_ENCODER)
    assert [specs(b) for b in cfg["face_decoder"]] == [port(b) for b in w2l.FACE_DECODER]
    assert specs(cfg["output_block"]) == port(w2l.OUTPUT_BLOCK)


def test_work_counts_match_a_forward_hook_count_over_the_ports_module():
    """``work(cfg)``'s frame operations against the convs the port's
    ``Wav2Lip`` module runs for one frame, counted by forward hooks on the
    meta device: 2 Ho Wo Cout Cin k^2 a conv, 2 Hi Wi Cin Cout k^2 a
    transposed conv."""
    from livetalking_tpu_torch.models import wav2lip as w2l

    with torch.device("meta"):
        net = w2l.Wav2Lip()
    seen = []

    def hook(m, inp, out):
        kh, kw = m.kernel_size
        if isinstance(m, torch.nn.ConvTranspose2d):
            seen.append(2.0 * inp[0][0].numel() * m.out_channels * kh * kw)
        else:
            seen.append(2.0 * out[0].numel() * m.in_channels // m.groups * kh * kw)

    for m in net.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            m.register_forward_hook(hook)
    net(torch.empty(1, 80, 16, 1, device="meta"), torch.empty(1, 256, 256, 6, device="meta"))
    cfg = _config()
    ops = family.work(cfg)
    assert len(seen) == len(ops["frames_run"]) == 55
    assert sum(seen) == flops(ops["frames_run"]) == 55_577_198_592
    assert [op.prec for op in ops["frames_run"]] == ["bfloat16"] * 55
    # the mel request: 84 spectrogram columns x 401 bins x 80 mels, float32
    assert flops(ops["mel_requests_run"]) == 2 * 84 * 401 * 80


def test_paste_bytes_by_hand_at_b4():
    """Four 480x640 output frames from three distinct cycle frames: each
    distinct frame read once (921,600 bytes) with its box (16), each output
    frame written once (921,600), each 256 px crop (196,608) and its index
    (4) read once."""
    cfg = _config()
    assert work_wav2lip.paste_bytes(cfg, 4, 3) == 3 * (921_600 + 16) + 4 * (921_600 + 196_608 + 4)
    assert work_wav2lip.paste_bytes(cfg, 4, 3) == 7_237_696


def _paste_run(cfg, kernels, sizes=(8, 8, 8)):
    counters = {"start": {"batches_run": 0, "batch_sizes": []},
                "end": {"batches_run": len(sizes), "batch_sizes": list(sizes),
                        "buckets": [1, 2, 4, 8], "batch_size": 16}}
    trace = TraceData(kernels=kernels, busy_s=1.0, window_s=1.0, breakdown={})
    return types.SimpleNamespace(cfg=cfg, trace=trace,
                                 obs=types.SimpleNamespace(counters=counters))


def test_paste_roofline_reads_the_rect_kernels_of_complete_steps():
    cfg = _config()
    rect = "void (anonymous namespace)::paste_kernel<false, true>((anonymous namespace)::Args)"
    k = [(rect, 0, 1000), ("sm90_xmma_fprop_implicit_gemm", 2000, 9000), (rect, 9000, 11_000),
         ("sm90_xmma_fprop_implicit_gemm", 12_000, 19_000), (rect, 19_000, 22_000)]
    got = paste_metric.read(_paste_run(cfg, k))
    # two complete steps of 128 frames (8 requests, no padding), each
    # reading 128 x 249/250 distinct frames; 5,000 ns of kernel 1
    least = 2 * work_wav2lip.paste_bytes(cfg, 128, 128 * 249 / 250) / PEAKS["hbm_bytes_per_s"]
    assert got == pytest.approx(100.0 * least / 5e-6)
    # padded steps: 5 requests in bucket 8 also write the 48 padded frames
    k = [(rect, 0, 1000), (rect, 9000, 11_000)]
    got = paste_metric.read(_paste_run(cfg, k, sizes=(5,)))
    least = work_wav2lip.paste_bytes(cfg, 128, 80 * 249 / 250 + 1) / PEAKS["hbm_bytes_per_s"]
    assert got == pytest.approx(100.0 * least / 2e-6)


def test_paste_roofline_reads_nothing_without_the_rect_kernel_or_a_trace():
    cfg = _config()
    masked = "paste_kernel<true, true>"
    assert paste_metric.read(_paste_run(cfg, [(masked, 0, 10), (masked, 20, 30)])) is None
    run = _paste_run(cfg, [("paste_kernel<false, true>", 0, 10)] * 2)
    run.trace = None
    assert paste_metric.read(run) is None


# -- whole runs through the port, at the published widths ---------------------

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout whose wav2lip cell is cut to two sessions of 4-frame
    batches on small avatars, float32 on the CPU."""
    r = tmp_path_factory.mktemp("checkout")
    shutil.copytree(os.path.join(ROOT, "ltbench"), r / "ltbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), r / "BENCHMARK.json")
    cfg = _config()
    cfg["avatar"].update(frames=6, frame_hw=[120, 160])
    cfg["program"].update(batch_size=4, coalesce_buckets="1,2", dtype="float32")
    cfg["weights"]["calibration_avatars"] = 2
    cfg["serving"]["warm_up_deadline_s"] = 60
    (r / "ltbench" / "configs" / "wav2lip256_bf16.json").write_text(json.dumps(cfg))
    (r / "ltbench" / "workloads" / "free32.json").write_text(json.dumps(
        {"kind": "free", "sessions": 2, "queued_s": 4.0, "warm_batches": 2,
         "check_frames_per_session": 4}))
    return str(r)


def _run(root, trace=0, seconds=5.0):
    from ltbench import run as ltrun

    args = argparse.Namespace(workload="wav2lip256.free32", seed=SEED, seconds=seconds,
                              trace=trace)
    return ltrun.run_cell(args, root, device="cpu")[0]


def test_cell_runs_correct_through_the_port(root):
    r = _run(root, trace=1)
    assert r["correct"], r["compared"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["metrics"]["requests_per_batch"]["value"] >= 1
    assert r["metrics"]["step_mfu_pct"]["value"] > 0
    assert r["metrics"]["feature_encode_p95_ms.free"]["value"] > 0


def _shifted_mel(starts):
    def f(batch_size, *a, **kw):
        return starts(batch_size + 1, *a, **kw)[1:]
    return f


def _unmasked(make):
    def f(batch_size, img_size=256, dtype=torch.bfloat16):
        @torch.inference_mode()
        def step(model, face_cycle, idxs, mel):
            faces = face_cycle.index_select(0, idxs).to(dtype) / 255.0
            out = model(mel.to(dtype)[..., None], torch.cat([faces, faces], dim=-1))
            return (out * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)
        return step
    return f


def _shifted_box(make):
    def f(*geometry):
        paste = make(*geometry)
        return lambda pred, frames, idxs, boxes: paste(
            pred, frames, idxs, boxes + torch.tensor([0, 0, 1, 1], dtype=boxes.dtype))
    return f


@pytest.mark.parametrize("fault", ["mel_shift", "no_mask", "box_shift"])
def test_faults_planted_in_the_port_fail_the_check(root, fault, monkeypatch):
    """The mel windows one video frame late, the face's lower half left in,
    the face pasted one pixel right: each under the timed path."""
    from livetalking_tpu_torch.avatars import wav2lip_avatar as plugin
    from livetalking_tpu_torch.models import wav2lip as w2l
    from livetalking_tpu_torch.ops import mel

    if fault == "mel_shift":
        monkeypatch.setattr(mel, "mel_chunk_starts", _shifted_mel(mel.mel_chunk_starts))
    elif fault == "no_mask":
        monkeypatch.setattr(w2l, "make_infer_fn", _unmasked(w2l.make_infer_fn))
    else:
        monkeypatch.setattr(plugin, "make_resize_paste_fn",
                            _shifted_box(plugin.make_resize_paste_fn))
    r = _run(root)
    assert not r["correct"], r["compared"]


def test_window_ends_when_no_frame_is_served(root, monkeypatch):
    """A program that serves no frame: the warm-up deadline ends the run
    with an error instead of a hang."""
    from livetalking_tpu_torch.streamout import local

    monkeypatch.setattr(local.QueueOutput, "push_video_frame", lambda self, frame: None)
    cfg_path = os.path.join(root, "ltbench", "configs", "wav2lip256_bf16.json")
    cfg = json.load(open(cfg_path))
    short = copy.deepcopy(cfg)
    short["serving"]["warm_up_deadline_s"] = 3
    try:
        with open(cfg_path, "w") as f:
            json.dump(short, f)
        with pytest.raises(RuntimeError, match="did not reach the warm-up"):
            _run(root)
    finally:
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)


def test_weights_put_the_sigmoid_in_its_responsive_range():
    """The benchmark's weights at the published widths: the BatchNorm
    statistics and the last layer set on 8 calibration avatars leave the
    sigmoid's input with a spread of 0.5-3 on faces and speech of an avatar
    outside the calibration set."""
    cfg = _config()
    avs = avatars.make({"frames": 4, "frame_hw": [120, 160]}, SEED, 9, "cpu")
    sd = weights_wav2lip.state_dict(cfg, SEED, "cpu", avs)
    pcm = np.concatenate([Speech(SEED).chunk(8, c) for c in range(60, 112)])
    mel = ref.mel_windows(ref.log_mel(torch.from_numpy(pcm), cfg["mel"]), 16, 10, 25, 16)
    with torch.inference_mode():
        logits = ref.network(sd, cfg, mel[[2, 9]][:, None],
                             ref.face_input(torch.from_numpy(avs[8]["faces"][[1, 3]])))
    assert 0.5 < float(logits.std()) < 3.0
    levels = ref.faces_u8(logits).float()
    assert float(levels.std()) > 30 and float((levels == 0).float().mean()) < 0.05
    assert float((levels == 255).float().mean()) < 0.05
    assert np.isfinite(float(logits.abs().max()))
    assert set(sd) == {k for k, _shape, _kind, _fan in weights_wav2lip.specs(cfg)}
    assert len(weights_wav2lip.layers(cfg)) == 55
