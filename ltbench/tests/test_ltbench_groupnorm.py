"""``groupnorm_roofline``: its GroupNorm sites against the plain reference's own
GroupNorm calls and a count by hand, and what it reads from a trace."""

from __future__ import annotations

import copy
import json
import os
import types

import pytest
import torch

from ltbench import reference as ref, weights
from ltbench.spec import Spec
from ltbench.tests.conftest import ROOT
from ltbench.trace import TraceData
from ltbench.work import PEAKS

metric = Spec(ROOT)._module("metrics", "groupnorm_roofline")


def _config(name: str) -> dict:
    with open(os.path.join(ROOT, "ltbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def test_sites_of_the_served_bf16_step_counted_by_hand():
    """MuseTalk v1.5: 61 U-Net sites with 11,264,000 elements a frame and 30
    in the VAE decode with 114,819,072 (126.1 M in all): 4 bytes each."""
    sites = metric.sites(_config("musetalk_v15_bf16"))
    unet = [n for name, n in sites if not name.startswith("decoder.")]
    vae = [n for name, n in sites if name.startswith("decoder.")]
    assert (len(unet), len(vae)) == (61, 30)
    assert (sum(unet), sum(vae)) == (11_264_000, 114_819_072)
    assert metric.BYTES_PER_ELEMENT * sum(unet + vae) == 504_332_288


def test_sites_match_the_plain_references_groupnorm_calls(tiny_cfg, monkeypatch):
    """Every GroupNorm the plain reference runs for one frame (U-Net, then
    the VAE decode), by the elements it normalizes, in order."""
    seen = []
    gn = ref._gn

    def counting(sd, name, x, eps):
        seen.append(x[0].numel())
        return gn(sd, name, x, eps)

    monkeypatch.setattr(ref, "_gn", counting)
    sds = weights.state_dicts(tiny_cfg, seed=3, device="cpu", dtype=torch.float32)
    un, vae = ref.f32_state(sds["unet"]), ref.f32_state(sds["vae"])
    lat = torch.randn(1, 8, 32, 32)
    ctx = torch.randn(1, 50, tiny_cfg["unet"]["cross_attention_dim"])
    ref.vae_decode(vae, ref.unet(un, tiny_cfg["unet"], lat, torch.zeros(1), ctx))
    assert seen == [n for _name, n in metric.sites(tiny_cfg)]


def _run(cfg, kernels, sizes=(8, 8, 8)):
    """A traced run's readings: ``kernels`` (name, start, end) in ns, the
    window's steps of ``sizes`` requests (bucket 8, 16 frames each)."""
    counters = {"start": {"batches_run": 0, "batch_sizes": []},
                "end": {"batches_run": len(sizes), "batch_sizes": list(sizes),
                        "buckets": [1, 2, 4, 8], "batch_size": 16}}
    trace = TraceData(kernels=kernels, busy_s=1.0, window_s=1.0, breakdown={})
    return types.SimpleNamespace(cfg=cfg, trace=trace,
                                 obs=types.SimpleNamespace(counters=counters))


def test_reads_the_kernels_over_the_complete_steps(tiny_cfg):
    cfg = _config("musetalk_v15_bf16")
    k = [("paste_kernel<true, true>", 0, 1000),
         ("void (anonymous namespace)::group_norm_moments_kernel(...)", 2000, 3000),
         ("void (anonymous namespace)::group_norm_apply_kernel<true>(...)", 3000, 5000),
         ("sm90_xmma_fprop_implicit_gemm", 5000, 9000),
         ("paste_kernel<true, true>", 9000, 10_000),
         ("void (anonymous namespace)::group_norm_apply_kernel<false>(...)", 11_000, 12_000)]
    got = metric.read(_run(cfg, k))
    elements = sum(n for _name, n in metric.sites(cfg))
    least = 1 * 128 * elements * 4 / PEAKS["hbm_bytes_per_s"]  # one complete step
    assert got == pytest.approx(100.0 * least / 3e-6)


def test_reads_nothing_without_a_trace_a_kernel_or_the_bf16_route(tiny_cfg):
    cfg = _config("musetalk_v15_bf16")
    steps = [("paste_kernel<true, true>", 0, 1000), ("paste_kernel<true, true>", 9000, 10_000)]
    run = _run(cfg, steps)
    assert metric.read(run) is None  # the parent's step: no kernel 6
    run.trace = None
    assert metric.read(run) is None
    k = steps[:1] + [("group_norm_apply_kernel<true>", 2000, 3000)] + steps[1:]
    assert metric.read(_run(cfg, k)) is not None
    w8a8 = copy.deepcopy(cfg)
    w8a8["program"].update(vae_int8=True, unet_int8=True)
    assert metric.read(_run(w8a8, k)) is None
