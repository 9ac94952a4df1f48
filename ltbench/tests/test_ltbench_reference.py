"""The plain reference against the program's float32 CPU path at test
widths: each stage, and the W8A8 route with scales each side derives
itself. The reference imports nothing of the program; this test imports
both to show they compute the same functions."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ltbench import avatars, reference as ref, weights
from ltbench.tests.conftest import tiny_config

from livetalking_tpu_torch.avatars import musetalk_avatar as muse  # noqa: E402
from livetalking_tpu_torch.models import musetalk as mt  # noqa: E402
from livetalking_tpu_torch.models import sd_unet, sd_vae  # noqa: E402
from livetalking_tpu_torch.models import whisper_encoder as we  # noqa: E402
from livetalking_tpu_torch.ops.blend import masked_paste_plain, prepare_masked_paste_data  # noqa: E402
from livetalking_tpu_torch.ops.whisper_mel import log_mel_spectrogram  # noqa: E402


@pytest.fixture(scope="module")
def model():
    from ltbench.program import load_model

    cfg = tiny_config()
    sds = weights.state_dicts(cfg, seed=2 ** 33 + 5, device="cpu", dtype=torch.float32)
    return cfg, sds, load_model(cfg, sds, torch.float32, "cpu")


def test_log_mel_and_whisper_states(model):
    cfg, sds, m = model
    wav = torch.from_numpy((np.random.default_rng(1).standard_normal((2, 16640)) * 0.1)
                           .astype(np.float32))
    mel_r = ref.log_mel(wav)
    mel_p = log_mel_spectrogram(wav)
    assert mel_r.shape == mel_p.shape == (2, 80, 3000)
    assert float((mel_r - mel_p).abs().max()) < 1e-4
    st_r = ref.whisper_states(ref.f32_state(sds["whisper"]), mel_r, 2)
    st_p = we.apply_stacked(m["whisper_params"], m["whisper_cfg"], mel_p)
    assert st_r.shape == st_p.shape == (2, 1500, 5, 64)
    assert float((st_r - st_p).abs().max()) < 2e-4


def test_unet_and_vae(model):
    cfg, sds, m = model
    g = torch.Generator().manual_seed(3)
    lat = torch.randn((2, 8, 32, 32), generator=g)
    ctx = torch.randn((2, 50, 64), generator=g)
    t = torch.zeros(2)
    u_r = ref.unet(ref.f32_state(sds["unet"]), cfg["unet"], lat, t, ctx)
    u_p = sd_unet.apply(m["unet_params"], m["unet_cfg"], lat.permute(0, 2, 3, 1), t, ctx)
    assert float((u_r - u_p.permute(0, 3, 1, 2)).abs().max()) < 1e-4 * float(u_r.abs().max())
    vae = ref.f32_state(sds["vae"])
    img_r = ref.vae_decode(vae, u_r)
    img_p = sd_vae.decode(m["vae_params"], u_p, dtype=torch.float32)
    assert float((img_r - img_p.permute(0, 3, 1, 2)).abs().max()) < 1e-4
    # the served step, faces and avatar latents
    faces = np.random.default_rng(4).integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    lat_r = ref.avatar_latents(vae, torch.from_numpy(faces))
    lat_p = mt.encode_avatar_latents(m["vae_params"], faces, device="cpu")
    assert float(np.abs(lat_r.permute(0, 2, 3, 1).numpy() - lat_p).max()) < 1e-4
    step = mt.make_infer_fn(m["unet_cfg"], 2, dtype=torch.float32)
    got = step(m["unet_params"], m["vae_params"], torch.from_numpy(lat_p),
               torch.tensor([1, 0], dtype=torch.int32), ctx)
    want = ref.step_faces(ref.f32_state(sds["unet"]), cfg["unet"], vae, lat_r[[1, 0]], ctx)
    assert int((got.int() - want.int()).abs().max()) <= 1


def test_paste(tiny_cfg):
    av = avatars.make(tiny_cfg["avatar"], seed=11, n=1, device="cpu")[0]
    frames = torch.from_numpy(np.stack(av["frames"]))
    H, W = frames.shape[1:3]
    face_box, crop_box = av["coords"][0], av["mask_coords"][0]
    from livetalking_tpu_torch.ops.blend import bucket_shape

    Ho, Wo = bucket_shape([(ys, ye, xs, xe) for (xs, ys, xe, ye) in av["mask_coords"]])
    org, sc, masks = prepare_masked_paste_data(av["coords"], av["mask_coords"], av["masks"],
                                               Ho, Wo, H, W)
    pred = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (3, 256, 256, 3),
                                                              dtype=np.uint8))
    idx = torch.tensor([0, 2, 5], dtype=torch.int32)
    got = masked_paste_plain(pred, frames, idx, torch.from_numpy(org), torch.from_numpy(sc),
                             torch.from_numpy(masks), S=256, Ho=Ho, Wo=Wo, H=H, W=W)
    for b, i in enumerate(idx.tolist()):
        want = ref.paste(pred[b], frames[i], face_box, crop_box, torch.from_numpy(av["masks"][i]))
        assert int((got[b].int() - want.int()).abs().max()) <= 1


def test_w8a8_route_and_its_scales(model):
    """The program's quantised step against the reference's fake-quantised
    one, each calibrating on the same inputs in its own arithmetic, and the
    int4 control farther from the reference than the program. The scales
    agree; the outputs agree only to int8's noise, since a rounding that
    flips on a last-bit difference upstream moves every later layer."""
    cfg, sds, m = model
    faces = np.random.default_rng(6).integers(0, 256, (4, 256, 256, 3), dtype=np.uint8)
    lat_p = torch.from_numpy(mt.encode_avatar_latents(m["vae_params"], faces, device="cpu"))
    opt = type("O", (), {"vae_int8": True, "unet_int8": True, "vae_mid_int8": 1,
                         "attn_int8": 1})()
    up, vp = muse.session_params(m, opt, lat_p)
    vae, un = ref.f32_state(sds["vae"]), ref.f32_state(sds["unet"])
    lat_r = ref.avatar_latents(vae, torch.from_numpy(faces))
    ctx0 = ref.calibration_context(ref.f32_state(sds["whisper"]), 2, 4, "cpu")
    q8, q4 = ref.Quant(8), ref.Quant(4)
    for q in (q8, q4):
        ref.calibrate(q, un, cfg["unet"], vae, lat_r, ctx0)
    assert abs(float(q8.scales["conv_in"]) / float(up["conv_in"]["as"]) - 1) < 1e-3
    assert abs(float(q8.scales["decoder.up_blocks.0.upsamplers.0.conv"])
               / float(vp["dec_up"][0]["up"]["as"]) - 1) < 1e-3
    ctx = torch.randn((4, 50, 64), generator=torch.Generator().manual_seed(7))
    step = mt.make_infer_fn(m["unet_cfg"], 4, dtype=torch.float32, vae_int8=True, unet_int8=True)
    got = step(up, vp, lat_p, torch.arange(4, dtype=torch.int32), ctx).float()
    want = ref.step_faces(un, cfg["unet"], vae, lat_r, ctx, q8).float()
    control = ref.step_faces(un, cfg["unet"], vae, lat_r, ctx, q4).float()
    # at test widths int8's own noise is large (few channels to average
    # over); the cells' limits come from full-width readings on the card
    assert float(((control - want) ** 2).mean()) > float(((got - want) ** 2).mean())
    # the bf16 configuration's control: the program's int8 route fails the
    # test configuration's float32-reference limit, which its float32 route meets
    limit = tiny_config()["check"]["limits"]["mean_frame_mse"]
    plain = ref.step_faces(un, cfg["unet"], vae, lat_r, ctx).float()
    f32 = mt.make_infer_fn(m["unet_cfg"], 4, dtype=torch.float32)(
        m["unet_params"], m["vae_params"], lat_p, torch.arange(4, dtype=torch.int32), ctx).float()
    assert float(((got - plain) ** 2).mean()) > limit > float(((f32 - plain) ** 2).mean())
