"""The port's HuBERT-fed serving paths on the CPU, end to end: dummy TTS ->
HuBERT features (the tiny config) -> Ultralight U-Net or ER-NeRF render ->
paste-back -> full frames out of the queue transport.

Ultralight: two coalesced sessions on avatars with distinct weights share
one scheduler, whose super-batch step runs the grouped U-Net and the
device paste (its plain version: the tensors lie on the CPU). ER-NeRF: one
session at 16 px and 4 samples a ray. The U-Net is full width, so these
are the slowest tests of the slice; the parity with the JAX package is in
tests/test_torch_ultralight.py, test_torch_hubert.py and
test_torch_ernerf.py.
"""

import queue
import time
from threading import Event, Thread

import numpy as np
import pytest
import torch

from livetalking_tpu_torch import registry
from livetalking_tpu_torch.avatars import ernerf_avatar, ultralight_avatar as plugin
from livetalking_tpu_torch.config import default_opt
from livetalking_tpu_torch.engine.scheduler import SchedulerConfigError
from livetalking_tpu_torch.models import ultralight as ul
from livetalking_tpu_torch.ops import blend
from livetalking_tpu_torch.utils import synthetic

H, W, B = 480, 640, 2


@pytest.fixture(scope="module")
def model():
    return plugin.load_model(default_opt(dtype="float32", device="cpu", hubert_size="tiny"))


def _opt(sid, **kw):
    base = dict(model="ultralight", transport="queue", tts="dummy", batch_size=B,
                dtype="float32", device="cpu", hubert_size="tiny", coalesce_buckets="1,2",
                sessionid=sid)
    base.update(kw)
    return default_opt(**base)


def _drive(sessions, box, done, min_speech=4, timeout=150):
    """Speak one sentence in each session and read frames until
    ``done(speech)``: every frame must be one of the session's avatar frames
    outside ``box`` (x1, y1, x2, y2); a frame that differs inside counts as
    speech. Returns the speech frame counts."""
    x1, y1, x2, y2 = box
    keep = np.ones((H, W), bool)
    keep[y1:y2, x1:x2] = False
    keep[:32] = False  # the watermark
    idle = [{f[keep].tobytes(): f for f in s.frame_list_cycle} for s in sessions]
    quits = [Event() for _ in sessions]
    threads = [Thread(target=s.render, args=(q,), daemon=True) for s, q in zip(sessions, quits)]
    speech = [0] * len(sessions)
    try:
        for t in threads:
            t.start()
        for k, s in enumerate(sessions):
            s.put_msg_txt(f"ul {k} ok")  # 7 chars: 560 ms, 14 frames of speech
        deadline = time.time() + timeout
        while time.time() < deadline and not (min(speech) >= min_speech and done()):
            for k, s in enumerate(sessions):
                try:
                    f = s.output.video_queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                assert f.shape == (H, W, 3) and f.dtype == np.uint8
                base = idle[k].get(f[keep].tobytes())
                assert base is not None, "a frame changed outside the face box"
                speech[k] += not np.array_equal(base[y1:y2, x1:x2], f[y1:y2, x1:x2])
    finally:
        for q in quits:
            q.set()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    return speech


def test_two_coalesced_ultralight_sessions_with_distinct_weights(model):
    arrays = [synthetic.ultralight_avatar_arrays(n_frames=4 + k, seed=k) for k in range(2)]
    avatars = [plugin.avatar_from_arrays(f"u{k}", a["frames"], a["crops"], a["coords"],
                                         ul.init_params(1 + k, torch.float32), device="cpu")
               for k, a in enumerate(arrays)]
    plugin.reset_shared_scheduler()
    try:
        sessions = [registry.create("avatar", "ultralight", model=model, avatar=a,
                                    opt=_opt(f"s{k}", coalesce=True, device_paste_back=True))
                    for k, a in enumerate(avatars)]
        sched, store = sessions[0]._scheduler, plugin._shared["store"]
        assert sched is sessions[1]._scheduler and all(s._scheduler_composes for s in sessions)
        assert [s._slot for s in sessions] == [0, 1]
        assert {"ul_slot", "pb_frames", "pb_boxes"} <= set(store.aux)
        np.testing.assert_array_equal(store.aux["ul_slot"].numpy(), [0] * 4 + [1] * 5)
        stacked = plugin._shared["stacked"]
        assert stacked["inc"][0][0]["w"].shape[0] == 2
        assert not torch.equal(stacked["inc"][0][0]["w"][0], stacked["inc"][0][0]["w"][1])
        # under --coalesce no session keeps a device copy of its crops
        assert not any(hasattr(s, "_crops_dev") for s in sessions)
        # a session in another dtype cannot join the running scheduler
        bf16 = dict(model, dtype=torch.bfloat16)
        with pytest.raises(SchedulerConfigError, match="conflicting"):
            registry.create("avatar", "ultralight", model=bf16, avatar=avatars[0],
                            opt=_opt("bad", coalesce=True, device_paste_back=True,
                                     dtype="bfloat16"))
        launches = blend.blend_rect_.launches
        speech = _drive(sessions, arrays[0]["coords"][0],
                        lambda: (not any(s.is_speaking() for s in sessions)
                                 and sched.requests_run == sched.requests_submitted))
        assert min(speech) >= 4, speech
        assert 0 < sched.requests_run == sched.requests_submitted
        assert max(sched.batch_sizes) >= 2, list(sched.batch_sizes)  # coalesced batches ran
        assert blend.blend_rect_.launches == launches  # CPU tensors: the plain paste
    finally:
        plugin.reset_shared_scheduler()


def test_solo_ultralight_session_pastes_on_the_host(model):
    """Without --coalesce: the session's own step, 160 px predictions, and
    the host paste of each into its 168 px crop and box."""
    import cv2

    a = synthetic.ultralight_avatar_arrays(n_frames=3, seed=5)
    avatar = plugin.avatar_from_arrays("solo", a["frames"], a["crops"], a["coords"],
                                       device="cpu")
    sess = registry.create("avatar", "ultralight", model=model, avatar=avatar,
                           opt=_opt("solo", device_paste_back=True))
    assert sess._scheduler is None and not sess._scheduler_composes
    feats = torch.from_numpy(np.random.default_rng(0).standard_normal((B, 16, 32, 32))
                             .astype(np.float32))
    pred = sess.inference_batch(1, feats)
    assert pred.shape == (B, 160, 160, 3) and pred.dtype == np.uint8
    frame = sess.paste_back_frame(pred[0], 1)
    x1, y1, x2, y2 = a["coords"][1]
    crop = a["crops"][1].copy()
    crop[4:164, 4:164] = pred[0]
    want = a["frames"][1].copy()
    want[y1:y2, x1:x2] = cv2.resize(crop, (x2 - x1, y2 - y1))
    np.testing.assert_array_equal(frame, want)


def test_ernerf_session_streams_full_frames(model):
    a = synthetic.ultralight_avatar_arrays(n_frames=4, seed=6)
    boxes = [(y1, y2, x1, x2) for (x1, y1, x2, y2) in a["coords"]]
    avatar = ernerf_avatar.avatar_from_arrays("nf", a["frames"], boxes, device="cpu")
    sess = registry.create("avatar", "ernerf", model=model, avatar=avatar,
                           opt=_opt("nf", model="ernerf", ernerf_size=16, ernerf_samples=4))
    assert sess.bg_cycle_device.shape == (4, 16, 16, 3)
    speech = _drive([sess], a["coords"][0], lambda: not sess.is_speaking())
    assert speech[0] >= 4, speech


@pytest.mark.parametrize("family", ["ultralight", "ernerf"])
def test_app_loads_the_family(family, monkeypatch):
    """``load_plugin_stack`` with ``--model ultralight --coalesce
    --device_paste_back`` or ``--model ernerf``: on the CPU it loads HuBERT
    and warms the step (160 px, or ``ernerf_size``); ``--device cuda``
    without a card raises."""
    from livetalking_tpu_torch import app

    monkeypatch.setitem(app.global_avatars, "app_probe", {})
    kw = dict(model=family, avatar_id="app_probe", batch_size=B, hubert_size="tiny",
              coalesce=family == "ultralight", device_paste_back=family == "ultralight",
              ernerf_size=16, ernerf_samples=4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            app.load_plugin_stack(default_opt(device="cuda", **kw))
    app.load_plugin_stack(default_opt(device="cpu", **kw))
    assert app.model["hubert_cfg"] == plugin.TINY_HUBERT
    assert app.model["device"] == torch.device("cpu")
    assert app._load_avatar.__module__ == f"livetalking_tpu_torch.avatars.{family}_avatar"
