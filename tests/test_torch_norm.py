"""Kernel 6's wrapper (``ops/norm.py``) on the CPU: the plain version is the
model step's GroupNorm and GroupNorm -> SiLU arithmetic bit for bit, the
model step's choice between the kernel and the plain version, and the
shape rule and work division the kernel is launched with. The kernel
itself runs only on the card (``tests/test_torch_kernels.py``)."""

import pytest
import torch
from torch.nn import functional as F

from livetalking_tpu_torch.models import diffusion_blocks as tdb
from livetalking_tpu_torch.ops import norm

from test_torch_kernels import unet_norm_sites, vae_decode_norm_sites
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401

# the served GroupNorm sites' channel counts (U-Net and VAE decoder), all
# with 32 groups
SERVED_C = (128, 256, 512, 320, 640, 960, 1280, 1920, 2560)


def _model_step_group_norm(p, x, groups=32, eps=1e-6):
    """The model step's GroupNorm as it was written before the kernel, line
    for line: the plain version must keep every rounding of it."""
    B, H, W, C = x.shape
    n = H * W * (C // groups)
    xf = x.float()
    s1 = xf.sum(dim=(1, 2))
    s2 = (xf * xf).sum(dim=(1, 2))
    g1 = s1.reshape(B, groups, C // groups).sum(-1)
    g2 = s2.reshape(B, groups, C // groups).sum(-1)
    mu = g1 / n
    var = (g2 / n - mu * mu).clamp(min=0.0)
    inv = torch.rsqrt(var + eps)
    mu_c = mu.repeat_interleave(C // groups, dim=-1)
    inv_c = inv.repeat_interleave(C // groups, dim=-1)
    scale = inv_c * p["g"].float()[None]
    shift = p["b"].float()[None] - mu_c * scale
    y = xf * scale[:, None, None, :] + shift[:, None, None, :]
    return y.to(x.dtype)


def _model_step_silu(x):
    return F.silu(x.float()).to(x.dtype)


def _site(C, dtype, seed, B=2, H=3, W=5):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn((B, H, W, C), generator=g) * 2.0 + 0.7).to(dtype)
    p = {"g": (torch.rand(C, generator=g) + 0.5).to(dtype),
         "b": (torch.randn(C, generator=g) * 0.3).to(dtype)}
    return p, x


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C", SERVED_C)
def test_plain_version_is_the_model_steps_arithmetic(C, dtype, silu):
    p, x = _site(C, dtype, seed=C)
    want = _model_step_group_norm(p, x, eps=1e-5)
    if silu:
        want = _model_step_silu(want)
    got = norm.group_norm_plain(x, p["g"], p["b"], 32, 1e-5, silu=silu)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    # the wrapper runs it on the CPU, and so does the model step, without a launch
    before = norm.group_norm.launches
    assert torch.equal(norm.group_norm(x, p["g"], p["b"], 32, 1e-5, silu=silu), want)
    blocks = tdb.group_norm_silu if silu else tdb.group_norm
    assert torch.equal(blocks(p, x, eps=1e-5), want)
    assert norm.group_norm.launches == before


def test_resnet_block_keeps_its_rounding():
    """``resnet_block`` through ``group_norm_silu`` gives the bits of
    conv(silu(group_norm(...))), bf16."""
    C = 64
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 4, 4, C), generator=g).to(torch.bfloat16)

    def conv_p():
        return {"w": (torch.randn((C, C, 3, 3), generator=g) * 0.05).to(torch.bfloat16),
                "b": torch.zeros(C, dtype=torch.bfloat16)}

    norm_p = {"g": torch.ones(C, dtype=torch.bfloat16), "b": torch.zeros(C, dtype=torch.bfloat16)}
    p = {"norm1": norm_p, "conv1": conv_p(), "norm2": norm_p, "conv2": conv_p()}
    h = tdb.conv(p["conv1"], _model_step_silu(_model_step_group_norm(p["norm1"], x)))
    h = tdb.conv(p["conv2"], _model_step_silu(_model_step_group_norm(p["norm2"], h)))
    assert torch.equal(tdb.resnet_block(p, x), x + h)


@pytest.mark.parametrize("case, device, dtype, grad_enabled, requires_grad, want", [
    ("cpu bf16", "cpu", torch.bfloat16, False, False, False),
    ("cuda bf16", "cuda", torch.bfloat16, False, False, True),
    ("cuda bf16, grad mode, no grad needed", "cuda", torch.bfloat16, True, False, True),
    ("cuda bf16 recording a gradient", "cuda", torch.bfloat16, True, True, False),
    ("cuda f32 (parity decode, avatar encode)", "cuda", torch.float32, False, False, False),
    ("cuda f16", "cuda", torch.float16, False, False, False),
])
def test_router_choice(case, device, dtype, grad_enabled, requires_grad, want):
    records = grad_enabled and requires_grad
    assert norm.routes_to_kernel(device, dtype, records) is want, case


def test_model_step_router_reads_autograd_and_dtype(monkeypatch):
    """``diffusion_blocks`` hands the router the tensor's device, dtype and
    whether autograd records it (through the input or the affine)."""
    seen = []

    def spy(device_type, dtype, records_grad):
        seen.append((device_type, dtype, records_grad))
        return False

    monkeypatch.setattr(norm, "routes_to_kernel", spy)
    p, x = _site(64, torch.float32, seed=1)
    tdb.group_norm(p, x)
    xg = x.clone().requires_grad_(True)
    tdb.group_norm_silu(p, xg)
    pg = {"g": p["g"].clone().requires_grad_(True), "b": p["b"]}
    tdb.group_norm(pg, x)
    with torch.no_grad():
        tdb.group_norm_silu(p, xg)
    assert seen == [("cpu", torch.float32, False), ("cpu", torch.float32, True),
                    ("cpu", torch.float32, True), ("cpu", torch.float32, False)]


@pytest.mark.parametrize("shape, groups, dtype, fits", [
    ((16, 64, 64, 512), 32, torch.bfloat16, True),
    ((128, 4, 4, 2560), 32, torch.bfloat16, True),
    ((1, 1, 1, 8), 1, torch.bfloat16, True),
    ((16, 8, 8, 4096), 32, torch.bfloat16, True),
    ((16, 8, 8, 4104), 8, torch.bfloat16, False),    # more channels than shared memory holds
    ((16, 8, 8, 36), 4, torch.bfloat16, False),      # not whole 16-byte vectors
    ((16, 8, 8, 80), 32, torch.bfloat16, False),     # not whole groups
    ((16, 8, 8, 4096), 512, torch.bfloat16, True),
    ((16, 8, 8, 4096), 1024, torch.bfloat16, False),  # more groups than shared memory holds
    ((16, 8, 8, 512), 32, torch.float32, False),     # float32: the plain version's
    ((16, 8, 8, 512), 32, torch.float16, False),
    ((16, 64, 512), 32, torch.bfloat16, False),      # not (B, H, W, C)
    ((0, 8, 8, 512), 32, torch.bfloat16, False),
    ((65536, 1, 1, 512), 32, torch.bfloat16, False),  # the grid's y dimension
    ((2, 0, 8, 512), 32, torch.bfloat16, False),
])
def test_fit_check(shape, groups, dtype, fits):
    assert norm.group_norm_fits(shape, groups, dtype) is fits


@pytest.mark.parametrize("case, shape, groups", [
    ("more channels than shared memory holds", (2, 2, 2, 4104), 8),
    ("not whole 16-byte vectors", (2, 2, 2, 36), 4),
    ("not whole groups", (2, 2, 2, 80), 32),
    ("more groups than shared memory holds", (2, 2, 2, 4096), 1024),
    ("not (B, H, W, C)", (2, 4, 512), 32),
    ("no sample", (0, 2, 2, 512), 32),
])
def test_misfit_goes_to_the_kernel_and_raises(case, shape, groups):
    """The router does not read the shape: a card bf16 tensor the kernel
    cannot take reaches the kernel's wrapper, which refuses its shape
    before anything else, and never falls back to the plain version."""
    assert norm.routes_to_kernel("cuda", torch.bfloat16, False), case
    x = torch.zeros(shape, dtype=torch.bfloat16)
    v = torch.ones(shape[-1], dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="want bfloat16 \\(B, H, W, C\\)"):
        norm._launch(x, v, v, groups, 1e-6, False)


def _served_sites():
    """(H, C) of every GroupNorm site of the bf16 step, with its count."""
    sites = {}
    for h, c, _silu in unet_norm_sites() + vae_decode_norm_sites():
        sites[(h, c)] = sites.get((h, c), 0) + 1
    return sites


def test_served_sites_are_91_and_all_fit():
    u, v = unet_norm_sites(), vae_decode_norm_sites()
    assert (len(u), len(v)) == (61, 30)
    assert sum(h * h * c for h, c, _ in u) == 11_264_000
    assert sum(h * h * c for h, c, _ in v) == 114_819_072
    for h, c in _served_sites():
        for B in (1, 16, 128):
            assert norm.group_norm_fits((B, h, h, c), 32, torch.bfloat16)


@pytest.mark.parametrize("B", [1, 2, 16, 128, 1024])
def test_plan_divides_every_served_site(B):
    for (h, c), _n in sorted(_served_sites().items()):
        HW = h * h
        plan = norm.group_norm_plan(B, HW, c, 132)
        V = c // 8
        assert plan.threads == V * plan.rows <= norm.MAX_THREADS
        assert plan.threads > norm.MAX_THREADS - V  # as many rows as fit
        assert 1 <= plan.blocks <= max(1, -(-HW // plan.rows))  # no block without a pixel row
        # each block's pixel range, as the kernel cuts it, covers HW once
        edges = [HW * j // plan.blocks for j in range(plan.blocks + 1)]
        assert edges[0] == 0 and edges[-1] == HW
        assert all(a < b for a, b in zip(edges, edges[1:]))
        # about 16 blocks an SM, unless a block would get fewer than 8 rows a
        # thread or 32 pixels
        total = B * plan.blocks
        assert total >= min(16 * 132, B * -(-HW // plan.rows // 8), B * (HW // 32))
        assert plan.blocks == 1 or HW // plan.blocks >= 32


def test_kernel_refuses_grad_and_cuda_wrapper_refuses_what_it_does_not_take():
    p, x = _site(64, torch.bfloat16, seed=2)
    with pytest.raises(RuntimeError, match="no backward"):
        norm.group_norm(x.clone().requires_grad_(True).float(), p["g"].float(), p["b"].float())
    with pytest.raises(ValueError, match="not CUDA"):
        norm._launch(x, p["g"], p["b"], 32, 1e-6, False)

