"""The port's int8 (and bf16) 3x3 convolutions (ops/conv.py) against the
JAX package's Pallas kernels on the CPU.

The JAX side runs ``livetalking_tpu/ops/pallas_conv.py`` in interpret mode,
as its own tests do; the port's wrappers run their plain versions on CPU
tensors. Inputs are numpy arrays from a seed. Bars are the reference's
(tests/test_pallas_conv.py): int8 atol 8e-3 max|ref| (both sides sum
exactly, so the outputs agree bit for bit up to the f32 epilogue's
rounding), bf16 rtol = atol = 2e-2, the fused GN + SiLU + quantize conv
atol max(2e-2, 4 max out_scale) + rtol 1e-2 and its moments rtol 1e-3 +
atol 1e-2 H W.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from livetalking_tpu.models import diffusion_blocks as jdb
from livetalking_tpu.models import sd_vae as jv
from livetalking_tpu.ops import pallas_conv as jpc
from livetalking_tpu_torch.models import sd_vae as tv
from livetalking_tpu_torch.ops import conv as tc
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401


def _hwio_to_port(w: np.ndarray) -> torch.Tensor:
    """(3, 3, C, O) -> the port's (O, 3, 3, C)."""
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 0, 1, 2)))


def _bf16(a: np.ndarray):
    """The same bf16 values on both sides."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("residual", [False, True])
def test_conv3x3_q_plain_matches_jax_kernel(residual):
    rng = np.random.default_rng(0)
    B, H, W, C, O = 2, 32, 24, 128, 256
    xq = rng.integers(-127, 128, (B, H, W, C), dtype=np.int8)
    wq = rng.integers(-127, 128, (3, 3, C, O), dtype=np.int8)
    scale = rng.uniform(5e-5, 2e-4, O).astype(np.float32)
    bias = rng.standard_normal(O).astype(np.float32)
    res_j, res_t = _bf16(rng.standard_normal((B, H, W, O))) if residual else (None, None)
    want = np.asarray(jpc.conv3x3_q(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(scale),
                                    jnp.asarray(bias), residual=res_j, interpret=True),
                      np.float32)
    got = tc.conv3x3_q(torch.from_numpy(xq), _hwio_to_port(wq), torch.from_numpy(scale),
                       torch.from_numpy(bias), residual=res_t)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, H, W, O)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=np.abs(want).max() * 8e-3)
    exact = float((got == want).mean())
    print(f"conv3x3_q residual={residual}: {exact:.5f} of outputs bit-equal")
    assert exact > 0.99


def test_conv3x3_bf16_plain_matches_jax_kernel():
    rng = np.random.default_rng(2)
    B, H, W, C, O = 1, 32, 32, 128, 128
    x_j, x_t = _bf16(rng.standard_normal((B, H, W, C)) * 0.3)
    w_j, w_t = _bf16(rng.standard_normal((3, 3, C, O)) * 0.02)
    bias = rng.standard_normal(O).astype(np.float32)
    want = np.asarray(jpc.conv3x3_bf16(x_j, w_j, jnp.asarray(bias), interpret=True), np.float32)
    got = tc.conv3x3_bf16(x_t, w_t.permute(3, 0, 1, 2).contiguous(), torch.from_numpy(bias))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)


def _gnq_inputs(rng, B, Hs, Ws, C, O, gn, residual, H, W):
    x_j, x_t = _bf16(rng.standard_normal((B, Hs, Ws, C)))
    gns = rng.uniform(0.5, 1.5, (B, C)).astype(np.float32) if gn else None
    gnb = (rng.standard_normal((B, C)) * 0.2).astype(np.float32) if gn else None
    wq = rng.integers(-127, 128, (3, 3, C, O), dtype=np.int8)
    osc = rng.uniform(5e-5, 2e-4, O).astype(np.float32)
    bias = (rng.standard_normal(O) * 0.1).astype(np.float32)
    res_j, res_t = _bf16(rng.standard_normal((B, H, W, O))) if residual else (None, None)
    return (x_j, gns, gnb, wq, osc, bias, res_j), (x_t, gns, gnb, wq, osc, bias, res_t)


def _check_gnq(jargs, targs, act, upsample, H, W):
    x_j, gns, gnb, wq, osc, bias, res_j = jargs
    x_t, _, _, _, _, _, res_t = targs

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.from_numpy(a)

    yj, s1j, s2j = jpc.conv3x3_gnq(x_j, j(gns), j(gnb), jnp.asarray(act, jnp.float32),
                                   jnp.asarray(wq), jnp.asarray(osc), jnp.asarray(bias),
                                   residual=res_j, upsample=upsample, interpret=True)
    y, s1, s2 = tc.conv3x3_gnq(x_t, t(gns), t(gnb), torch.tensor(act, dtype=torch.float32),
                               _hwio_to_port(wq), t(osc), t(bias), residual=res_t,
                               upsample=upsample)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == tuple(yj.shape)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(yj, np.float32),
                               atol=max(2e-2, 4 * float(osc.max())), rtol=1e-2)
    for got, want in ((s1, s1j), (s2, s2j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-2 * H * W)


@pytest.mark.parametrize("gn", [True, False])
def test_conv3x3_gnq_plain_matches_jax_kernel(gn):
    rng = np.random.default_rng(3)
    B, H, W, C, O = 2, 32, 24, 128, 128
    jargs, targs = _gnq_inputs(rng, B, H, W, C, O, gn, True, H, W)
    _check_gnq(jargs, targs, 0.011, False, H, W)


def test_conv3x3_gnq_upsample_plain_matches_jax_kernel():
    rng = np.random.default_rng(5)
    B, Hs, Ws, C, O = 2, 16, 12, 128, 128
    jargs, targs = _gnq_inputs(rng, B, Hs, Ws, C, O, False, False, 2 * Hs, 2 * Ws)
    _check_gnq(jargs, targs, 0.012, True, 2 * Hs, 2 * Ws)


def _decoder_sites(px=32, ch=tv.BLOCK_CH):
    """(H, C, O, upsample) of every 3x3 conv of the full-width decoder from
    the mid-block (at latent size ``px``) to the end."""
    rev = list(reversed(ch))
    sites = [(px, rev[0], rev[0], False)] * 4
    cin, h = rev[0], px
    for i, cout in enumerate(rev):
        for j in range(3):
            sites += [(h, cin if j == 0 else cout, cout, False), (h, cout, cout, False)]
        cin = cout
        if i < len(rev) - 1:
            h *= 2
            sites.append((h, cout, cout, True))
    return sites


def test_gnq_fit_rule_picks_the_reference_sites():
    """The port's shape rule against the reference's over the full-width
    decoder at min_h 64 (shapes only): both take every conv from block 0's
    upsampler on and nothing at the mid-block's 32 px; and the chain gate
    agrees on (structural) full-width trees at 32 and 16 px."""
    sites = _decoder_sites()
    fits = [tc.conv3x3_gnq_fits(h, h, c, o, 64, upsample=u) for h, c, o, u in sites]
    assert fits == [jpc.conv3x3_gnq_fits(h, h, c, o, 64, upsample=u) for h, c, o, u in sites]
    first = sites.index((64, 512, 512, True))
    assert fits == [False] * first + [True] * (len(sites) - first)

    def trees(cin):
        jblocks, tblocks = [], []
        for i, cout in enumerate(reversed(tv.BLOCK_CH)):
            jres, tres = [], []
            for j in range(3):
                c = cin if j == 0 else cout
                jres.append({k: {"wq": np.zeros((3, 3, ci, cout), np.int8), "as": 1.0}
                             for k, ci in (("conv1", c), ("conv2", cout))})
                tres.append({k: {"wq": torch.empty((cout, 3, 3, ci), dtype=torch.int8),
                                 "as": torch.tensor(1.0)}
                             for k, ci in (("conv1", c), ("conv2", cout))})
            jblocks.append({"resnets": jres})
            tblocks.append({"resnets": tres})
            if i < 3:
                jblocks[-1]["up"] = {"wq": np.zeros((3, 3, cout, cout), np.int8)}
                tblocks[-1]["up"] = {"wq": torch.empty((cout, 3, 3, cout), dtype=torch.int8)}
            cin = cout
        return {"dec_up": jblocks}, {"dec_up": tblocks}

    jtree, ttree = trees(512)
    for px in (32, 16):
        assert tv._fused_chain_fits(ttree, px) == jv._fused_chain_fits(jtree, px) == (px == 32)
    for blk in ttree["dec_up"]:  # an uncalibrated tree never takes the chain
        del blk["resnets"][0]["conv1"]["as"]
    assert not tv._fused_chain_fits(ttree, 32)


def test_wrappers_raise_for_non_cpu_tensors_without_launching():
    """A tensor on another device than the CPU goes to the kernel, which
    takes only CUDA tensors: it raises instead of running the plain
    version, and counts nothing."""
    meta = dict(device="meta")
    xq = torch.empty((1, 8, 16, 64), dtype=torch.int8, **meta)
    wq = torch.empty((64, 3, 3, 64), dtype=torch.int8, **meta)
    v = torch.empty((64,), **meta)
    before = (tc.conv3x3_q.launches, tc.conv3x3_gnq.launches)
    with pytest.raises(ValueError):
        tc.conv3x3_q(xq, wq, v, v)
    with pytest.raises(ValueError):
        tc.conv3x3_gnq(xq.to(torch.bfloat16), None, None, torch.empty((), **meta), wq, v, v)
    assert (tc.conv3x3_q.launches, tc.conv3x3_gnq.launches) == before


def test_int8_matmul_is_exact():
    rng = np.random.default_rng(7)
    a = rng.integers(-127, 128, (37, 2560), dtype=np.int8)
    w = rng.integers(-127, 128, (40, 2560), dtype=np.int8)
    got = tc.int8_matmul(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ w.astype(np.int64).T)


def test_plain_conv_agrees_with_the_reference_conv_q():
    """conv3x3_q's plain version is what ``diffusion_blocks.conv_q`` of the
    reference computes with XLA's conv: the same int8 inputs and epilogue."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 8, 8, 64)).astype(np.float32)
    p = {"w": (rng.standard_normal((3, 3, 64, 64)) * 0.05).astype(np.float32),
         "b": (rng.standard_normal(64) * 0.1).astype(np.float32)}
    pq = jdb.quantize_conv({k: jnp.asarray(v) for k, v in p.items()})
    sx = np.float32(np.abs(x).max() / 127.0)
    want = np.asarray(jdb.conv_q(dict(pq, **{"as": jnp.asarray(sx)}), jnp.asarray(x)))
    xq = torch.round(torch.from_numpy(x) / torch.tensor(sx)).clamp(-127, 127).to(torch.int8)
    got = tc.conv3x3_q(xq, _hwio_to_port(np.array(pq["wq"])),
                       torch.tensor(sx) * torch.from_numpy(np.array(pq["ws"])),
                       torch.from_numpy(np.array(pq["b"])), out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("B", [16, 64, 128])
def test_conv3x3_plan_splits_cover_k_once(B):
    """Kernel 4's work division at every int8 3x3 site of a MuseTalk step
    (chip_smoke.py's site lists: the U-Net's and the unfused decoder's 26
    shapes), int8 and bf16 inputs: tiles of 128 pixels cover the output, K
    splits into ranges of whole stages that cover it exactly once, K is
    split only where the tiles do not fill the card's 132 SMs, and the
    U-Net's 4x4 and 8x8 sites are split into enough parts to fill it."""
    import chip_smoke
    from livetalking_tpu_torch.models import sd_unet

    sites = set(chip_smoke.unet_conv_sites(sd_unet, sd_unet.MUSETALK))
    sites |= set(chip_smoke.vae_conv_sites(tv)[0])
    assert len(sites) == 26
    for H, C, O in sorted(sites):
        for in_bytes in (1, 2):
            plan = tc.conv3x3_plan(B, H, H, C, O, in_bytes)
            bw, bh, bb = plan.box
            assert bw * bh * bb == tc.BLOCK_M
            assert plan.m_tiles == -(-B * H * H // tc.BLOCK_M)  # ceil(M / BM): no ragged tile
            assert plan.n_tiles == -(-O // plan.bn) and plan.bn in (128, 256)
            stage_bytes = 9 * 64 if plan.halo else 64  # a chunk of all taps, or of one
            assert plan.stages * stage_bytes == 9 * C * in_bytes
            ranges = plan.k_ranges()
            assert len(ranges) == plan.splits and 1 <= plan.splits <= 6
            assert ranges[0][0] == 0 and ranges[-1][1] == plan.stages
            assert all(b < e for b, e in ranges)
            assert all(r[1] == n[0] for r, n in zip(ranges, ranges[1:]))
            if plan.tiles >= 132:
                assert plan.splits == 1, (H, C, O, plan)
            if B == 16 and H <= 8:  # the U-Net's 4x4 and 8x8 sites fill the card by parts
                assert plan.splits >= 3 and plan.units >= 120, (H, C, O, plan)
