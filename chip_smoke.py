#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``livetalking_tpu_torch`` on the card, at full Wav2Lip-256 width
with random weights from seed 0, through the entry points a server uses:

  1. device  — ``nvidia-smi`` name and power limit; compute capability 9.0.
  2. build   — every kernel under ``livetalking_tpu_torch/csrc`` with nvcc.
  3. blend   — the paste-back kernel against its plain PyTorch version on
               480x640 frames, a 240x256 bucket, B in {16, 128}, feather in
               {0, 9}: at most 1 LSB apart, byte-identical outside the bbox;
               kernel and plain times (CUDA events, median of 60 runs).
  4. model   — the fp32 Wav2Lip step on the card (TF32 off) against the same
               step on the CPU at B=2: at most 1 LSB; the bf16 serving step's
               time at B=16 and B=128.
  5. engine  — ``app.load_plugin_stack`` with ``--coalesce
               --device_paste_back``, two sessions on numpy-made avatars,
               text in, full frames out of the queue transport; every kernel
               of the path must have launched, and the scheduler must have
               resolved every request submitted.

Prints one line per phase, then a ``{"kernels": [...]}`` line, the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``. Any failed
check raises and the script exits non-zero without that line; without a
CUDA device it exits 1 at once.
"""

from __future__ import annotations

import asyncio
import json
import os
import queue
import subprocess
import sys
import time

import numpy as np

# peak memory bandwidth (bytes/s) and fp32 rate outside the tensor cores
# (FLOP/s), from NVIDIA's data sheets; first matching name wins
PEAKS = [
    ("H100 NVL", 3.9e12, 60e12),
    ("H100 PCIe", 2.0e12, 51e12),
    ("H200", 4.8e12, 67e12),
    ("H100", 3.35e12, 67e12),  # SXM
]

S, H, W = 256, 480, 640
BOX = (120, 360, 200, 440)  # 240x240 face box centred in a 480x640 frame
TOL_LSB = 1


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
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


def make_avatar(plugin, avatar_id: str, n: int, seed: int, device: str):
    """A 480x640 avatar drawn with numpy: smooth gradients plus noise, a
    240x240 face box, face crops resized to 256 with torch."""
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


def phase_blend(torch, blend, peak_bw: float, peak_f32: float) -> dict:
    rng = np.random.default_rng(1)
    N = 8
    frames = torch.from_numpy(rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)).cuda()
    boxes_np = []
    for _ in range(N):
        h, w = int(rng.integers(200, 241)), int(rng.integers(200, 241))
        y1, x1 = int(rng.integers(0, H - h + 1)), int(rng.integers(0, W - w + 1))
        boxes_np.append((y1, y1 + h, x1, x1 + w))
    Ho, Wo = blend.bucket_shape(boxes_np)
    if (Ho, Wo) != (240, 256):
        raise AssertionError(f"bucket {(Ho, Wo)} != (240, 256)")
    boxes = torch.tensor(boxes_np, dtype=torch.int32, device="cuda")

    max_err = 0
    rows = {}
    for B in (16, 128):
        pred = torch.from_numpy(rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8)).cuda()
        idxs = torch.from_numpy(rng.integers(0, N, (B,))).cuda()
        for feather in (0, 9):
            fn = blend.make_resize_paste_fn(S, Ho, Wo, H, W, feather=feather)
            got = fn(pred, frames, idxs, boxes)
            want = blend.resize_paste_plain(pred, frames, idxs, boxes, S=S, Ho=Ho,
                                            Wo=Wo, H=H, W=W, feather=feather)
            torch.cuda.synchronize()
            err = int((got.int() - want.int()).abs().max())
            picked = frames.index_select(0, idxs)
            outside = torch.ones((B, H, W), dtype=torch.bool, device="cuda")
            for b, i in enumerate(idxs.tolist()):
                y1, y2, x1, x2 = boxes_np[i]
                outside[b, y1:y2, x1:x2] = False
            if err > TOL_LSB or not torch.equal(got[outside], picked[outside]):
                raise AssertionError(f"blend B={B} feather={feather}: max err {err} "
                                     f"(tolerance {TOL_LSB} LSB) or pixels outside the bbox changed")
            max_err = max(max_err, err)

        # time the kernel's own function (in place on gathered frames) and
        # its plain version on the same inputs; feather 0 is the served one
        box_b = boxes.index_select(0, idxs)
        buf_k = frames.index_select(0, idxs)
        buf_p = buf_k.clone()
        ms = cuda_ms(lambda: blend.blend_rect_(pred, buf_k, box_b, Ho=Ho, Wo=Wo))
        plain_ms = cuda_ms(lambda: blend._blend_rect_plain(pred, buf_p, box_b, Ho=Ho, Wo=Wo))
        # least work the function needs for these inputs: read each pred crop
        # once and each bbox pixel of the frame once, write it once; about
        # 59 fp32 operations per bbox pixel (20 for positions/weights/alpha,
        # 13 per channel for the 4-tap resize and the blend)
        hw = [(min(y2 - y1, Ho)) * (min(x2 - x1, Wo))
              for (y1, y2, x1, x2) in (boxes_np[i] for i in idxs.tolist())]
        nbytes = B * (3 * S * S + 16) + 2 * 3 * sum(hw)
        nops = 59 * sum(hw)
        t_bytes = nbytes / peak_bw * 1e3
        t_ops = nops / peak_f32 * 1e3
        rows[B] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "bytes": nbytes}
        log("blend", B=B, bucket=f"{Ho}x{Wo}", kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{rows[B]['bound_ms']:.4f}", bound_by=rows[B]["bound_by"],
            MB=f"{nbytes / 1e6:.1f}", library_ms="null", max_abs_err=max_err)
    return {"max_abs_err": max_err, "rows": rows}


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

    out = {}
    for B in (16, 128):
        cyc = torch.from_numpy(rng.integers(0, 256, (32, S, S, 3), dtype=np.uint8)).cuda()
        ix = torch.from_numpy(rng.integers(0, 32, (B,))).cuda()
        m = torch.from_numpy(np.clip(rng.standard_normal((B, 80, 16)), -4, 4).astype(np.float32)).cuda()
        step = w2l.make_infer_fn(B, S, torch.bfloat16)
        ms = cuda_ms(lambda: step(bf_net, cyc, ix, m), warmup=3, iters=20)
        out[B] = ms
        log("model", B=B, dtype="bfloat16", step_ms=f"{ms:.3f}", inferfps=f"{B / ms * 1e3:.1f}")
    return out


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

    # the main path starts here: every kernel count from 0
    blend.blend_rect_.launches = 0
    sids = []
    try:
        for avatar in ("smoke_a", "smoke_b"):
            sid = asyncio.run(session_manager.create_session({"avatar": avatar}))
            sids.append(sid)
            app.start_render_thread(sid)
        sessions = [session_manager.get_session(s) for s in sids]
        sched = plugin._shared["scheduler"]
        for k, s in enumerate(sessions):
            s.put_msg_txt(f"session {k} reads a sentence long enough for many batches of frames.")

        y1, y2, x1, x2 = BOX
        keep = np.ones((H, W), bool)
        keep[y1:y2, x1:x2] = False
        keep[:32] = False  # the watermark
        # each avatar frame by its pixels outside the bbox: every frame out
        # of the queue must be one of them there, pasted or not
        by_outside = []
        for a in ("smoke_a", "smoke_b"):
            cyc = app.global_avatars[a]["frame_list_cycle"]
            by_outside.append({c[keep].tobytes(): c for c in cyc})
        speech = [0, 0]
        frames = [0, 0]
        t_first = [None, None]
        t_last = [None, None]
        # read every frame until both utterances are over and every request
        # submitted has been resolved
        deadline = time.time() + 180
        while time.time() < deadline:
            if (min(speech) >= 32 and not any(s.is_speaking() for s in sessions)
                    and sched.requests_run == sched.requests_submitted):
                break
            for k, s in enumerate(sessions):
                try:
                    f = s.output.video_queue.get(timeout=0.01)
                except queue.Empty:
                    continue
                if f.shape != (H, W, 3) or f.dtype != np.uint8:
                    raise AssertionError(f"session {k}: frame {f.shape} {f.dtype}")
                frames[k] += 1
                idle = by_outside[k].get(f[keep].tobytes())
                if idle is None:
                    raise AssertionError(f"session {k}: a frame matches no avatar frame outside the bbox")
                if not np.array_equal(idle[y1:y2, x1:x2], f[y1:y2, x1:x2]):
                    speech[k] += 1
                    t_first[k] = t_first[k] or time.time()
                    t_last[k] = time.time()
        if min(speech) < 32:
            raise AssertionError(f"speech frames per session {speech} < 32 within the time limit")
        launches = blend.blend_rect_.launches
        if sched.requests_run != sched.requests_submitted or sched.requests_run == 0:
            raise AssertionError(f"scheduler resolved {sched.requests_run} of "
                                 f"{sched.requests_submitted} requests submitted")
        if launches < sched.batches_run or sched.batches_run == 0:
            raise AssertionError(f"blend launches {launches} < scheduler batches {sched.batches_run}")
        lat = np.asarray(sched.latency_s) * 1e3
        fps = [speech[k] / max(t_last[k] - t_first[k], 1e-9) for k in range(2)]
        log("engine", sessions=2, speech_frames=speech, frames=frames,
            speech_fps_per_session=[f"{v:.1f}" for v in fps],
            batches_run=sched.batches_run, requests_run=sched.requests_run,
            requests_submitted=sched.requests_submitted,
            mean_coalesced=f"{np.mean(sched.batch_sizes):.2f}",
            latency_p50_ms=f"{np.percentile(lat, 50):.1f}", blend_launches=launches)
        return {"launches": launches}
    finally:
        for sid in sids:
            app.stop_render_thread(sid, timeout=15)
            session_manager.remove_session(sid)
        plugin.reset_shared_scheduler()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from livetalking_tpu_torch import app
    from livetalking_tpu_torch.avatars import wav2lip_avatar as plugin
    from livetalking_tpu_torch.models import wav2lip as w2l
    from livetalking_tpu_torch.ops import _build, blend
    from livetalking_tpu_torch.server.session_manager import session_manager

    t_start = time.time()
    card = smi_line()
    name = torch.cuda.get_device_name(0)
    cc = torch.cuda.get_device_capability(0)
    print(card, flush=True)
    log("device", name=json.dumps(name), capability=cc, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    if cc != (9, 0):
        raise AssertionError(f"compute capability {cc}, the kernels target sm_90a")
    peaks = [(bw, f32) for key, bw, f32 in PEAKS if key in name]
    if not peaks:
        raise AssertionError(f"no peak rates known for {name}")
    peak_bw, peak_f32 = peaks[0]

    t0 = time.time()
    libs = _build.build_all()
    log("build", seconds=f"{time.time() - t0:.2f}", libs=sorted(libs))

    b = phase_blend(torch, blend, peak_bw, peak_f32)
    log("kernels", blend=f"ok max_abs_err={b['max_abs_err']} tolerance={TOL_LSB}")
    phase_model(torch, w2l)
    e = phase_engine(torch, app, plugin, blend, session_manager)

    row = b["rows"][128]
    kernels = [{
        "name": "blend", "route": "cuda", "source": "livetalking_tpu_torch/csrc/blend.cu",
        "replaces": "livetalking_tpu/ops/pallas_blend.py:116",
        "launches": e["launches"], "max_abs_err": b["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": None,
    }]
    log("done", seconds=f"{time.time() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
