#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--paced 2,4]

Drives ``livetalking_tpu_torch`` on the card with random weights from fixed
seeds, through the entry points a server uses, at full width: Wav2Lip-256,
MuseTalk (U-Net (320, 640, 1280, 1280), the full sd-vae-ft-mse,
Whisper-tiny) in bf16 and in W8A8 int8, and the HuBERT-fed families
(HuBERT-large, the Ultralight U-Net, ER-NeRF), at batch 16.

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
                  with 17 attention launches per step; the batched Whisper
                  encode's time at k=1 and k=2.
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
 18. paced      — only with ``--paced``: MuseTalk sessions whose frames are
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
FUSED_REF_DB = 35.0  # tests/test_pallas_conv.py::test_fused_decode_matches_xla_path
FUSED_SERVED_DB = 30.0  # fused vs unfused at the served shapes (phase_musetalk_int8_model)
INT8_E2E_DB = 24.0  # tests/test_int8_quality.py's end-to-end bar
UL_PSNR_DB = 30.0  # the bf16 Ultralight step against f32 on the same weights
HUBERT_REL_ERR = 5e-2  # HuBERT-large features, bf16 weights against f32 (relative L2)

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


def check_one_kernel_per_paste(torch, call) -> None:
    """One paste step call is one CUDA kernel (torch.profiler window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
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


def profile_step(torch, run, steps: int, step_ms: float, tag: str = "profile") -> None:
    """Device time of ``steps`` runs by kernel (torch.profiler, kernel
    events only), the top entries, and the kernels' busy share of the step
    time ``step_ms`` measured without the profiler; logged under ``tag``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count // steps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    log(tag, steps=steps, kernel_ms_per_step=f"{total:.3f}", step_ms=f"{step_ms:.3f}",
        device_busy_share=f"{total / step_ms:.3f}",
        launches_per_step=sum(r[2] for r in rows))
    for key, t, n in rows[:12]:
        log(tag, kernel=json.dumps(key[:90]), ms_per_step=f"{t:.3f}",
            share=f"{t / max(total, 1e-9):.3f}", calls_per_step=n)


def phase_musetalk_model(torch, muse, mt, attn, wf) -> dict:
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
    before = attn.attention.launches
    out = run()
    torch.cuda.synchronize()
    per_step = attn.attention.launches - before
    if per_step != 17 or tuple(out.shape) != (B, S, S, 3) or out.dtype != torch.uint8:
        raise AssertionError(f"bf16 step: {per_step} attention launches (want 17), "
                             f"output {tuple(out.shape)} {out.dtype}")
    ms = cuda_ms(run, warmup=3, iters=20)
    log("musetalk_model", B=B, dtype="bfloat16", step_ms=f"{ms:.3f}",
        inferfps=f"{B / ms * 1e3:.1f}", attention_launches_per_step=per_step)
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
    return {"step_ms": ms, "encode_ms": enc}


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


def phase_musetalk_engine(torch, app, muse, blend, attn, conv, synthetic, sd_vae,
                          session_manager, int8: bool = False) -> dict:
    """Two coalesced MuseTalk sessions on avatars encoded on the card; with
    ``int8``, ``--vae_int8 --unet_int8`` and ``LT_FUSED_VAE=1``: the first
    session quantizes and calibrates, and every step runs 59 kernel-4 and
    21 kernel-5 launches."""
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
        r = drive_sessions(app, session_manager, muse, ids, boxes[0],
                           lambda: {"attention": attn.attention.launches,
                                    "blend_mask": blend.blend_masked_.launches,
                                    "conv3x3_q": conv.conv3x3_q.launches,
                                    "conv3x3_gnq": conv.conv3x3_gnq.launches})
        fc, sched, c = muse._shared["feat_coalescer"], r["sched"], r["counts"]
        if fc is None or fc.batches_run == 0:
            raise AssertionError("the feature coalescer ran no batch")
        n = sched.batches_run
        want = {"attention": 17, "blend_mask": 1, "conv3x3_q": 59 if int8 else 0,
                "conv3x3_gnq": 21 if int8 else 0}
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
    from livetalking_tpu_torch import app
    from livetalking_tpu_torch.audio_features import hubert_features
    from livetalking_tpu_torch.audio_features import whisper_features as wf
    from livetalking_tpu_torch.avatars import ernerf_avatar as ea
    from livetalking_tpu_torch.avatars import musetalk_avatar as muse
    from livetalking_tpu_torch.avatars import ultralight_avatar as ua
    from livetalking_tpu_torch.avatars import wav2lip_avatar as plugin
    from livetalking_tpu_torch.config import default_opt
    from livetalking_tpu_torch.models import ernerf, hubert
    from livetalking_tpu_torch.models import musetalk as mt
    from livetalking_tpu_torch.models import sd_unet, sd_vae
    from livetalking_tpu_torch.models import ultralight as ul
    from livetalking_tpu_torch.models import wav2lip as w2l
    from livetalking_tpu_torch.ops import _build, attention, blend, conv
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
    ptxas = [start_ptxas_report(_build, source) for source in ("conv", "blend")]
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
    timed("musetalk_model", phase_musetalk_model, torch, muse, mt, attention, wf)
    timed("musetalk_int8_model", phase_musetalk_int8_model, torch, muse, mt, conv, attention,
          wf, synthetic, sd_vae)
    e = timed("engine", phase_engine, torch, app, plugin, blend, session_manager)
    me = timed("musetalk_engine", phase_musetalk_engine, torch, app, muse, blend, attention,
               conv, synthetic, sd_vae, session_manager)
    qe = timed("musetalk_int8_engine", phase_musetalk_engine, torch, app, muse, blend,
               attention, conv, synthetic, sd_vae, session_manager, True)
    timed("hubert", phase_hubert, torch, hubert, ul, hubert_features, default_opt, peak_bw,
          peak_f32)
    timed("ultralight_model", phase_ultralight_model, torch, ul, synthetic, peak_bw, peak_bf16)
    ue = timed("ultralight_engine", phase_ultralight_engine, torch, app, ua, ul, blend,
               synthetic, session_manager)
    timed("ernerf", phase_ernerf, torch, app, ea, ernerf, synthetic, session_manager)
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
         # the Ultralight path's own run of kernel 1 (S = 168, B=128, 400-frame store)
         "ultralight_launches": ue["launches"], "s168_ms": s168["paste_ms"],
         "s168_device_ms": s168["paste_device_ms"], "s168_plain_ms": s168["plain_ms"],
         "s168_bound_ms": s168["paste_bound_ms"], "s168_bound_by": s168["paste_bound_by"]},
        row("blend_mask", src + "blend.cu", "livetalking_tpu/ops/pallas_blend.py:141",
            me["blend_mask"], bm["max_abs_err"], paste_row(bm["rows"][(H, W, 128, 400)]), None),
        row("attention", src + "attention.cu", "livetalking_tpu/ops/pallas_attention.py:79",
            me["attention"], at["max_abs_err"], at["step"], at["step"]["library_ms"]),
        row("conv3x3_q", src + "conv.cu", "livetalking_tpu/ops/pallas_conv.py:130",
            qe["conv3x3_q"], k4["max_abs_err"], k4["step"], None),
        row("conv3x3_gnq", src + "conv.cu", "livetalking_tpu/ops/pallas_conv.py:324",
            qe["conv3x3_gnq"], k5["max_abs_err"], k5["step"], None),
    ]
    log("done", seconds=f"{time.time() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
