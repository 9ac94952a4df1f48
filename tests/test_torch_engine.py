"""The port's serving engine on the CPU: coalesced sessions end to end, and
the scheduler's batch composition under a fake step.

The composition tests hold the fake device step on an event, or freeze the
scheduler's clock, so they check which requests share a batch without
depending on how fast this host runs.
"""

import queue
import threading
import time
from threading import Event, Thread

import numpy as np
import pytest
import torch

from livetalking_tpu_torch import registry
from livetalking_tpu_torch.avatars import wav2lip_avatar as plugin
from livetalking_tpu_torch.config import default_opt
from livetalking_tpu_torch.engine.scheduler import (
    AvatarStore,
    BatchScheduler,
    SchedulerConfigError,
    parse_buckets,
    resolve_coalesce_window,
)
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401

H, W, S = 480, 640, 256
BOX = (120, 360, 200, 440)


def _avatar(avatar_id, n, seed):
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 256, (H, W, 3), dtype=np.uint8) for _ in range(n)]
    faces = rng.integers(0, 256, (n, S, S, 3), dtype=np.uint8)
    return plugin.avatar_from_arrays(avatar_id, frames, faces, [BOX] * n, device="cpu")


def test_two_coalesced_sessions_with_device_paste_stream_full_frames():
    model = plugin.load_model("", default_opt(dtype="float32", device="cpu"))
    avatars = [_avatar("e1", 4, 0), _avatar("e2", 4, 1)]
    plugin.reset_shared_scheduler()

    def session(sid, avatar):
        opt = default_opt(transport="queue", tts="dummy", batch_size=2, dtype="float32",
                          device="cpu", coalesce=True, device_paste_back=True, sessionid=sid)
        return registry.create("avatar", "wav2lip", opt=opt, model=model, avatar=avatar)

    sessions = [session("e1", avatars[0]), session("e2", avatars[1])]
    sched = sessions[0]._scheduler
    assert sched is sessions[1]._scheduler and all(s._scheduler_composes for s in sessions)
    quits = [Event(), Event()]
    threads = [Thread(target=s.render, args=(q,), daemon=True) for s, q in zip(sessions, quits)]
    try:
        for t in threads:
            t.start()
        for k, s in enumerate(sessions):
            s.put_msg_txt(f"hi {k}")
        got = [[], []]
        deadline = time.time() + 150
        while time.time() < deadline:
            if (min(len(g) for g in got) >= 8 and sched.batches_run > 0
                    and not any(s.is_speaking() for s in sessions)
                    and sched.requests_run == sched.requests_submitted):
                break
            for k, s in enumerate(sessions):
                try:
                    got[k].append(s.output.video_queue.get(timeout=0.05))
                except queue.Empty:
                    pass
        assert min(len(g) for g in got) >= 8, [len(g) for g in got]
        assert all(f.shape == (H, W, 3) and f.dtype == np.uint8 for g in got for f in g)
        assert sched.requests_submitted > 0
        assert sched.requests_run == sched.requests_submitted
        assert max(sched.batch_sizes) >= 2, list(sched.batch_sizes)  # coalesced batches ran
    finally:
        for q in quits:
            q.set()
        for t in threads:
            t.join(timeout=30)
        plugin.reset_shared_scheduler()
    assert not any(t.is_alive() for t in threads)


def test_conflicting_session_config_is_rejected():
    model = plugin.load_model("", default_opt(dtype="float32", device="cpu"))
    plugin.reset_shared_scheduler()
    try:
        plugin.get_shared_scheduler(model, 2, buckets=(1, 2))
        with pytest.raises(SchedulerConfigError):
            plugin.get_shared_scheduler(model, 4, buckets=(1, 2))
    finally:
        plugin.reset_shared_scheduler()


def test_device_paste_back_bucket_wider_than_frame_raises():
    """A 100 px box rounds up to a 128 px wide bucket, wider than the
    120 px frame: --device_paste_back raises instead of blending on the
    host."""
    model = plugin.load_model("", default_opt(dtype="float32", device="cpu"))
    rng = np.random.default_rng(6)
    frames = [rng.integers(0, 256, (200, 120, 3), dtype=np.uint8) for _ in range(2)]
    faces = rng.integers(0, 256, (2, S, S, 3), dtype=np.uint8)
    avatar = plugin.avatar_from_arrays("narrow", frames, faces, [(20, 120, 10, 110)] * 2,
                                       device="cpu")
    opt = default_opt(transport="queue", tts="dummy", batch_size=2, dtype="float32",
                      device="cpu", device_paste_back=True, sessionid="narrow")
    with pytest.raises(SchedulerConfigError, match="exceeds the 120x200 frame"):
        registry.create("avatar", "wav2lip", opt=opt, model=model, avatar=avatar)


# -- batch composition with a fake step -----------------------------------

def _store(n=16):
    store = AvatarStore(item_shape=(1,), device="cpu")
    store.add("a", np.zeros((n, 1), np.uint8))
    return store


def _echo_factory(gate=None, started=None):
    """A step that returns each row's index, optionally held on ``gate``."""
    def factory(n):
        def step(model, buffer, idxs, mel):
            assert idxs.shape[0] == n and mel.shape[0] == n
            if started is not None:
                started.set()
            if gate is not None:
                assert gate.wait(30)
            return idxs.view(-1, 1).clone()
        return step
    return factory


class _Clock:
    """A frozen clock the test advances by hand; counts reads."""

    def __init__(self):
        self.t = 0.0
        self.reads = 0

    def __call__(self):
        self.reads += 1
        return self.t

    def wait_reads(self, n, timeout=30.0):
        target = self.reads + n
        deadline = time.monotonic() + timeout
        while self.reads < target and time.monotonic() < deadline:
            time.sleep(0.001)
        assert self.reads >= target


def _submit(sched, k, B=2):
    return sched.submit(np.arange(k * B, (k + 1) * B), torch.zeros(B, 1))


def test_requests_arriving_while_busy_share_the_next_batch():
    gate, started = Event(), Event()
    sched = BatchScheduler(None, _store(), _echo_factory(gate, started), batch_size=2,
                           buckets=(1, 2, 4))
    sched.start()
    try:
        first = _submit(sched, 0)
        assert started.wait(30)  # dispatched alone; the device step is held
        later = [_submit(sched, k) for k in (1, 2, 3)]
        gate.set()
        results = [f.result(timeout=30) for f in [first] + later]
    finally:
        gate.set()
        sched.stop()
    assert list(sched.batch_sizes) == [1, 3]
    for k, r in enumerate(results):  # each request gets its own rows back
        np.testing.assert_array_equal(r[:, 0], [2 * k, 2 * k + 1])
    assert sched.requests_run == sched.requests_submitted == 4
    assert sched.frames_run == 8


def test_idle_window_holds_a_partial_batch_until_target_or_timeout():
    clock = _Clock()
    sched = BatchScheduler(None, _store(), _echo_factory(), batch_size=2, buckets=(1, 2, 4),
                           coalesce_window_s=10.0, clock=clock)
    a, b = _submit(sched, 0), _submit(sched, 1)
    sched.start()
    try:
        a.result(timeout=30), b.result(timeout=30)
        assert list(sched.batch_sizes) == [2]

        # recent rounds launched 2 requests: a lone one waits for its peer
        c = _submit(sched, 2)
        clock.wait_reads(50)
        assert not c.done()
        d = _submit(sched, 3)
        c.result(timeout=30), d.result(timeout=30)
        assert list(sched.batch_sizes) == [2, 2]

        # ... or for the window, on the scheduler's clock
        e = _submit(sched, 4)
        clock.wait_reads(50)
        assert not e.done()
        clock.t += 10.0
        np.testing.assert_array_equal(e.result(timeout=30)[:, 0], [8, 9])
        assert list(sched.batch_sizes) == [2, 2, 1]
    finally:
        sched.stop()


def test_hold_policy_aligns_staggered_sessions():
    """The port's counterpart of the JAX package's
    tests/test_scheduler.py::test_hold_policy_aligns_staggered_sessions, at
    its setup and bar: four free-running closed-loop sessions that start
    3 ms apart, a 50 ms device step, buckets (1, 2, 4) and no idle window
    must lock onto full super-batches (at least 80% of the batches after
    the first two)."""
    N, B = 4, 2
    store = AvatarStore(item_shape=(1,), device="cpu")
    offs = [store.add(f"h{i}", np.zeros((6, 1), np.uint8))[0] for i in range(N)]

    def slow_factory(n):
        def step(model, buffer, idxs, mel):
            time.sleep(0.05)  # stand-in for a long device step
            return buffer.index_select(0, idxs.long())
        return step

    sched = BatchScheduler(None, store, slow_factory, B, buckets=(1, 2, 4),
                           coalesce_window_s=0.0)
    sched.start()
    stop = Event()

    def session(i):
        idxs = (offs[i] + np.arange(B)).astype(np.int32)
        mel = np.zeros((B, 4, 4), np.float32)
        time.sleep(0.003 * i)  # initial stagger
        while not stop.is_set():
            sched.infer(idxs, mel)

    threads = [Thread(target=session, args=(i,), daemon=True) for i in range(N)]
    try:
        for t in threads:
            t.start()
        time.sleep(2.0)
        stop.set()
        for t in threads:
            t.join(timeout=10)
    finally:
        stop.set()
        sched.stop()
    sizes = list(sched.batch_sizes)
    assert len(sizes) >= 5, sizes
    steady = sizes[2:]
    assert sum(s == N for s in steady) / len(steady) >= 0.8, sizes


def test_stop_fails_held_requests_and_refuses_new_ones():
    gate, started = Event(), Event()
    sched = BatchScheduler(None, _store(), _echo_factory(gate, started), batch_size=2,
                           buckets=(1,))
    sched.start()
    first = _submit(sched, 0)
    assert started.wait(30)
    second = _submit(sched, 1)
    stopper = threading.Thread(target=sched.stop)
    stopper.start()
    assert sched._quit.wait(30)
    gate.set()
    stopper.join(timeout=60)
    assert not stopper.is_alive()
    first.result(timeout=5)  # already on the device: completes
    with pytest.raises(RuntimeError):
        second.result(timeout=5)
    with pytest.raises(RuntimeError):
        _submit(sched, 2)


def test_avatar_store_offsets_and_aux_planes():
    store = AvatarStore(item_shape=(2,), device="cpu")
    assert store.add("a", np.ones((3, 2), np.uint8), aux={"p": np.zeros((3, 4))}) == (0, 3)
    assert store.add("b", np.ones((2, 2), np.uint8), aux={"p": np.ones((2, 4))}) == (3, 2)
    assert store.add("a", np.ones((3, 2), np.uint8), aux={"p": np.zeros((3, 4))}) == (0, 3)
    assert tuple(store.buffer.shape) == (5, 2) and tuple(store.aux["p"].shape) == (5, 4)
    with pytest.raises(ValueError):
        store.add("c", np.ones((2, 2), np.uint8), aux={"q": np.ones((2, 4))})
    with pytest.raises(ValueError):
        store.add("d", np.ones((2, 2), np.uint8), aux={"p": np.ones((3, 4))})
    with pytest.raises(ValueError):
        store.add("e", np.ones((2, 3), np.uint8), aux={"p": np.ones((2, 4))})


def test_avatar_store_aux_read_stays_one_generation():
    """A step reads ``store.aux`` once, without the lock, while a new
    session may be adding its avatar: what it read must keep planes of one
    length, so ``add`` swaps in a new dict instead of growing the old one
    plane by plane."""
    store = AvatarStore(item_shape=(2,), device="cpu")
    store.add("a", np.ones((3, 2), np.uint8), aux={"p": np.zeros((3, 4)), "q": np.zeros(3)})
    seen = store.aux
    store.add("b", np.ones((2, 2), np.uint8), aux={"p": np.ones((2, 4)), "q": np.ones(2)})
    assert [int(t.shape[0]) for t in seen.values()] == [3, 3]
    assert [int(t.shape[0]) for t in store.aux.values()] == [5, 5]


def test_bucket_and_window_flags():
    assert parse_buckets(default_opt()) == (1, 2, 4, 8)
    assert parse_buckets(default_opt(coalesce_buckets="2, 4")) == (2, 4)
    assert resolve_coalesce_window(default_opt(), 16) == pytest.approx(0.64)
    assert resolve_coalesce_window(default_opt(coalesce_window_ms=30), 16) == pytest.approx(0.03)
