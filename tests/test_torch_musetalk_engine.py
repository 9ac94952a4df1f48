"""The port's MuseTalk serving path on the CPU: two coalesced sessions end
to end (dummy TTS -> Whisper features through the shared feature coalescer
-> U-Net step -> VAE decode -> masked paste-back inside the scheduler's
step -> full frames out), the per-session paths, the int8 flags, and the
configurations that must raise.

The U-Net is the tiny test configuration and the VAE a narrow one
(channels (32, 32, 64, 64), the recomposed ``TorchVAE`` of
tests/test_sd_converters.py read by the port's converter), both random, so
a step takes well under a second here; the full widths run in
tests/test_torch_musetalk.py (VAE) and on the card (``chip_smoke.py``).
"""

import queue
import time
from threading import Event, Thread

import numpy as np
import pytest
import torch

from livetalking_tpu_torch import registry
from livetalking_tpu_torch.avatars import musetalk_avatar as plugin
from livetalking_tpu_torch.config import default_opt
from livetalking_tpu_torch.engine.scheduler import SchedulerConfigError
from livetalking_tpu_torch.models import sd_vae
from livetalking_tpu_torch.ops import attention, blend
from livetalking_tpu_torch.utils import synthetic
from livetalking_tpu_torch.utils.image import mirror_indices
from test_sd_converters import TorchVAE, _init
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401

H, W = 480, 640


@pytest.fixture(scope="module")
def model():
    m = plugin.load_model(default_opt(model="musetalk", dtype="float32", device="cpu",
                                      musetalk_size="tiny"))
    narrow = dict(_init(TorchVAE(ch=(32, 32, 64, 64)), seed=1).state_dict())
    m["vae_params"] = sd_vae.convert_torch_state_dict(narrow, dtype=torch.float32)
    return m


def _arrays(n, seed):
    return synthetic.musetalk_avatar_arrays(n_frames=n, frame_hw=(H, W), seed=seed)


def _avatar(model, avatar_id, n, seed):
    a = _arrays(n, seed)
    return plugin.avatar_from_arrays(avatar_id, a["frames"], a["faces"], a["coords"],
                                     a["mask_coords"], a["masks"], model["vae_params"],
                                     device="cpu")


def _opt(sid, **kw):
    base = dict(model="musetalk", transport="queue", tts="dummy", batch_size=2,
                dtype="float32", device="cpu", whisper_short_window=True,
                coalesce_buckets="1,2", sessionid=sid)
    base.update(kw)
    return default_opt(**base)


def test_two_coalesced_musetalk_sessions_stream_full_frames(model):
    avatars = [_avatar(model, "m1", 4, 0), _avatar(model, "m2", 5, 1)]
    plugin.reset_shared_scheduler()
    sessions = [registry.create("avatar", "musetalk", model=model, avatar=a,
                                opt=_opt(f"s{k}", coalesce=True, device_paste_back=True))
                for k, a in enumerate(avatars)]
    sched = sessions[0]._scheduler
    fc = plugin._shared["feat_coalescer"]
    assert sched is sessions[1]._scheduler and all(s._scheduler_composes for s in sessions)
    assert sessions[0].asr._coalescer is fc is sessions[1].asr._coalescer
    xs, ys, xe, ye = avatars[0]["mask_coords_list_cycle"][0]
    keep = np.ones((H, W), bool)
    keep[ys:ye, xs:xe] = False
    keep[:32] = False  # the watermark
    idle = [{f[keep].tobytes(): f for f in a["frame_list_cycle"]} for a in avatars]
    launches = (attention.attention.launches, blend.blend_masked_.launches)
    quits = [Event(), Event()]
    threads = [Thread(target=s.render, args=(q,), daemon=True) for s, q in zip(sessions, quits)]
    try:
        for t in threads:
            t.start()
        for k, s in enumerate(sessions):
            s.put_msg_txt(f"hi {k}")
        speech = [0, 0]
        deadline = time.time() + 150
        while time.time() < deadline:
            if (min(speech) >= 4 and not any(s.is_speaking() for s in sessions)
                    and sched.requests_run == sched.requests_submitted):
                break
            for k, s in enumerate(sessions):
                try:
                    f = s.output.video_queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                assert f.shape == (H, W, 3) and f.dtype == np.uint8
                base = idle[k].get(f[keep].tobytes())
                assert base is not None, "a frame changed outside the crop box"
                speech[k] += not np.array_equal(base[ys:ye, xs:xe], f[ys:ye, xs:xe])
        assert min(speech) >= 4, speech
        assert 0 < sched.requests_run == sched.requests_submitted
        assert max(sched.batch_sizes) >= 2, list(sched.batch_sizes)  # coalesced batches ran
        assert fc.batches_run > 0 and fc.requests_run >= fc.batches_run
        # CPU tensors run the plain versions: no kernel launched
        assert (attention.attention.launches, blend.blend_masked_.launches) == launches
    finally:
        for q in quits:
            q.set()
        for t in threads:
            t.join(timeout=30)
        plugin.reset_shared_scheduler()
    assert not any(t.is_alive() for t in threads)


@pytest.mark.parametrize("paste", [True, False])
def test_solo_session_device_paste_matches_host_blend(model, paste):
    """Without --coalesce: the step's faces go through the masked device
    paste-back, or back to the host and through cv2 + ``blend_face``; the
    two composites agree (resize rounding differs: at most 3 LSB, as the
    reference's test of the same pair)."""
    import cv2

    avatar = _avatar(model, "solo", 4, 2)
    sess = registry.create("avatar", "musetalk", model=model, avatar=avatar,
                           opt=_opt("solo", device_paste_back=paste))
    assert (sess._device_paste is not None) == paste and sess._scheduler is None
    feats = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 50, 384))
                             .astype(np.float32))
    out = sess.inference_batch(1, feats)
    if paste:
        assert out.shape == (2, H, W, 3)
        return
    assert out.shape == (2, 256, 256, 3)
    dp = blend.MaskedDevicePasteBack(np.stack(avatar["frame_list_cycle"]),
                                     avatar["coord_list_cycle"], avatar["mask_coords_list_cycle"],
                                     avatar["mask_list_cycle"], 256, device="cpu")
    idxs = [1, 2]
    dev = dp.paste_batch(torch.from_numpy(out), np.asarray(idxs))
    for b, i in enumerate(idxs):
        host = sess.paste_back_frame(out[b], i)
        assert np.abs(host.astype(int) - dev[b].astype(int)).max() <= 3
        x1, y1, x2, y2 = avatar["coord_list_cycle"][i]
        ref = plugin.blend_face(avatar["frame_list_cycle"][i].copy(),
                                cv2.resize(out[b], (x2 - x1, y2 - y1)), (x1, y1, x2, y2),
                                avatar["mask_list_cycle"][i], avatar["mask_coords_list_cycle"][i])
        np.testing.assert_array_equal(host, ref)


def test_device_paste_back_bucket_wider_than_frame_raises(model):
    """A 200x120 frame: the 72 px crop box rounds up to a 128 px wide paste
    bucket, wider than the frame. --device_paste_back raises instead of
    blending on the host."""
    a = synthetic.musetalk_avatar_arrays(n_frames=2, frame_hw=(200, 120), seed=5)
    avatar = plugin.avatar_from_arrays("narrow", a["frames"], a["faces"], a["coords"],
                                       a["mask_coords"], a["masks"], model["vae_params"],
                                       device="cpu")
    with pytest.raises(SchedulerConfigError, match="exceeds the 120x200 frame"):
        registry.create("avatar", "musetalk", model=model, avatar=avatar,
                        opt=_opt("narrow", device_paste_back=True))


@pytest.mark.parametrize("flag", ["vae_int8", "unet_int8"])
def test_int8_flags_raise_instead_of_serving_bf16(model, flag):
    """Each int8 flag serves int8, never the full-precision trees in its
    place: warm_up runs the int8 graph, the session's step runs the trees
    it quantized and calibrated (static scales at every conv site), its
    faces differ from the full-precision step's, and a second session
    asking for other int8 flags raises instead of being served them."""
    m = dict(model)  # the quantized trees are cached in the model dict
    opt = _opt("q", **{flag: True})
    plugin.warm_up(1, m, opt=opt)  # the int8 graph; batch 1 keeps the CPU test short
    avatar = _avatar(m, "q", 2, 3)
    sess = registry.create("avatar", "musetalk", model=m, avatar=avatar, opt=opt)
    vae_q = flag == "vae_int8"
    q_tree, fp_tree = ((sess._vae_params, sess._unet_params) if vae_q
                       else (sess._unet_params, sess._vae_params))
    assert q_tree is m["vae_params_q" if vae_q else "unet_params_q"]
    assert fp_tree is m["unet_params" if vae_q else "vae_params"]
    site = q_tree["dec_up"][0]["resnets"][0]["conv1"] if vae_q else q_tree["conv_in"]
    assert site["wq"].dtype == torch.int8 and "as" in site
    feats = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 50, 384))
                             .astype(np.float32))
    out = sess.inference_batch(1, feats)
    assert out.shape == (2, 256, 256, 3) and out.dtype == np.uint8
    full = plugin.mt.make_infer_fn(m["unet_cfg"], 2, dtype=torch.float32)(
        m["unet_params"], m["vae_params"], avatar["latent_cycle_device"],
        torch.from_numpy(mirror_indices(2, 1, 2)), feats)
    assert not np.array_equal(out, full.numpy())
    other = {"vae_mid_int8": 0} if vae_q else {"attn_int8": 0}
    with pytest.raises(SchedulerConfigError, match="int8 flag"):
        registry.create("avatar", "musetalk", model=m, avatar=avatar,
                        opt=_opt("q2", **{flag: True}, **other))


def test_quant_flag_cache_mismatch_rejected():
    """The shared quantized trees are keyed by the flags that made them: a
    match passes, another flag raises, trees installed without a record
    are accepted."""
    m = {"unet_q_flags": {"attn_int8": True}}
    plugin._check_quant_flags(m, "unet_q_flags", {"attn_int8": True})
    with pytest.raises(SchedulerConfigError, match="int8 flag"):
        plugin._check_quant_flags(m, "unet_q_flags", {"attn_int8": False})
    plugin._check_quant_flags({}, "unet_q_flags", {"attn_int8": False})


def test_conflicting_session_config_is_rejected(model):
    plugin.reset_shared_scheduler()
    try:
        plugin.get_shared_scheduler(model, 2, buckets=(1, 2))
        with pytest.raises(SchedulerConfigError):
            plugin.get_shared_scheduler(model, 4, buckets=(1, 2))
        for flag in ("vae_int8", "unet_int8"):  # the step is built for the first's flags
            with pytest.raises(SchedulerConfigError):
                plugin.get_shared_scheduler(model, 2, buckets=(1, 2), **{flag: True})
        plugin.get_shared_feature_coalescer(model, _opt("a"))
        with pytest.raises(SchedulerConfigError):
            plugin.get_shared_feature_coalescer(model, _opt("b", whisper_short_window=False))
    finally:
        plugin.reset_shared_scheduler()


def test_avatar_directory_round_trip(model, tmp_path):
    """``make_synthetic_musetalk_avatar`` writes the reference's directory
    layout; ``load_avatar`` reads back the same frames, masks, boxes and
    latents as ``avatar_from_arrays`` builds in memory."""
    synthetic.make_synthetic_musetalk_avatar(str(tmp_path / "avatars" / "d1"),
                                             model["vae_params"], n_frames=3, seed=4,
                                             device="cpu")
    got = plugin.load_avatar("d1", str(tmp_path), device="cpu")
    want = _avatar(model, "d1", 3, 4)
    for key in ("coord_list_cycle", "mask_coords_list_cycle"):
        assert got[key] == want[key]
    for a, b in zip(got["frame_list_cycle"], want["frame_list_cycle"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got["mask_list_cycle"], want["mask_list_cycle"]):
        np.testing.assert_array_equal(a[..., 0], b)  # read back as BGR
    assert got["latent_cycle_host"].shape == (3, 32, 32, 8)
    np.testing.assert_array_equal(got["latent_cycle_host"], want["latent_cycle_host"])


@pytest.mark.parametrize("build", ["encode_avatar_latents", "make_synthetic_musetalk_avatar"])
def test_avatar_builds_default_to_the_card(model, tmp_path, monkeypatch, build):
    """Both avatar builders run on the card unless the caller asks for the
    CPU: on a host without a CUDA device their default raises, and the
    directory builder writes nothing first."""
    from livetalking_tpu_torch.models import musetalk as mt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    faces = synthetic.musetalk_avatar_arrays(n_frames=1, seed=6)["faces"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if build == "encode_avatar_latents":
            mt.encode_avatar_latents(model["vae_params"], faces)
        else:
            synthetic.make_synthetic_musetalk_avatar(str(tmp_path / "d"), model["vae_params"])
    assert not (tmp_path / "d").exists()
