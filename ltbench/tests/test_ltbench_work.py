"""The work counts against PyTorch's own operation counter over the plain
reference, and the check that no JAX module is loaded."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ltbench import guard, reference as ref, weights, work


def _counted(fn) -> float:
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


def test_step_ops_match_the_flop_counter(tiny_cfg):
    sds = weights.state_dicts(tiny_cfg, seed=3, device="cpu", dtype=torch.float32)
    un, vae = ref.f32_state(sds["unet"]), ref.f32_state(sds["vae"])
    lat = torch.randn(1, 8, 32, 32)
    ctx = torch.randn(1, 50, tiny_cfg["unet"]["cross_attention_dim"])
    counted = _counted(lambda: ref.vae_decode(vae, ref.unet(un, tiny_cfg["unet"], lat,
                                                            torch.zeros(1), ctx)))
    assert counted == work.flops(work.step_ops(tiny_cfg))


def test_whisper_ops_match_the_flop_counter(tiny_cfg):
    sds = weights.state_dicts(tiny_cfg, seed=3, device="cpu", dtype=torch.float32)
    mel = torch.randn(1, 80, 3000)
    counted = _counted(lambda: ref.whisper_states(ref.f32_state(sds["whisper"]), mel, 2))
    assert counted == work.flops(work.whisper_ops(tiny_cfg))


def test_int8_route_groups(tiny_cfg):
    """The served int8 route's kernel sites: 59 on kernel 4 and 21 on
    kernel 5 per step with the fused decode, 17 self-attention calls."""
    cfg = dict(tiny_cfg, program=dict(tiny_cfg["program"], vae_int8=True, unet_int8=True),
               env={"LT_FUSED_VAE": "1"})
    ops = work.step_ops(cfg)
    count = {g: sum(op.group == g for op in ops) for g in ("conv4", "conv5", "attention")}
    assert count == {"conv4": 59, "conv5": 21, "attention": 17}
    assert work.flops(ops) == work.flops(work.step_ops(tiny_cfg))
    assert {op.prec for op in ops if op.group in ("conv4", "conv5")} == {"int8"}


def test_forbidden_modules_by_whole_top_level_name():
    assert guard.forbidden_modules(["livetalking_tpu_torch", "livetalking_tpu_torch.app",
                                    "jaxtyping", "torch"]) == []
    assert guard.forbidden_modules(["livetalking_tpu.models", "jax.numpy", "jaxlib",
                                    "flax.linen", "numpy"]) == ["flax", "jax", "jaxlib",
                                                                "livetalking_tpu"]
