"""The port's span recorder (``livetalking_tpu_torch/utils/spans.py``).

CPU: recording is off without a profiler session and on under one, from
every thread; parents per thread and spans across threads; the ring's
bound; the mapping onto the profiler's clock (a CPU operation lies inside
the mapped span around it); the scheduler's spans against its own latency
entries; ``--profile_dir``'s trace holding the spans. On the card
(``-m cuda``): every kernel's device interval lies inside its span mapped
onto the trace's clock.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest
import torch

from livetalking_tpu_torch.utils import spans

SLACK_NS = 50_000   # the card test's bound at either end of a kernel


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """One intra-op thread for the module (the port's test files all run
    so under the Tier-1 workers); restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the clock check reads CUPTI's kernel times")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_lie_inside_their_spans_on_the_card(cuda):
    """200 launches, each with a synchronise inside a span, under a
    CUDA-only profiler (the benchmark's): each kernel's device interval
    lies inside its span mapped onto the trace's clock, to 50 us."""
    from torch.autograd import DeviceType

    x = torch.zeros(1 << 20, device=cuda)
    for _ in range(10):
        x.add_(1)
    torch.cuda.synchronize()
    spans.clear()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    for i in range(200):
        with spans.span("probe", rid=i):
            x.add_(1)
            torch.cuda.synchronize()
    prof.stop()
    snap = spans.snapshot()
    probes = [s for s in snap.spans if s.name == "probe"]
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0)
    assert len(probes) == len(kernels) == 200
    early = [snap.to_trace(s.start_ns) - k0 for s, (k0, _k1) in zip(probes, kernels)]
    late = [k1 - snap.to_trace(s.end_ns) for s, (_k0, k1) in zip(probes, kernels)]
    worst = max(max(early), max(late))
    print(f"clock check: worst offset {worst / 1e3:.3f} us outside the span "
          f"(kernel start after span start: {-max(early) / 1e3:.3f}-{-min(early) / 1e3:.3f} us; "
          f"kernel end before span end: {-max(late) / 1e3:.3f}-{-min(late) / 1e3:.3f} us)")
    assert worst <= SLACK_NS


# -- the CPU ------------------------------------------------------------------

def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _names(snap):
    return [s.name for s in snap.spans]


def test_off_without_a_profiler_and_on_under_one_in_every_thread():
    spans.clear()
    assert not spans.on()
    with spans.span("off"):
        spans.end(spans.begin("off"))
        spans.record("off", 0, 1)
        spans.count("off")
    snap = spans.snapshot()
    assert snap.spans == [] and snap.counters == {}

    seen = []

    def worker():
        seen.append(spans.on())
        with spans.span("worker"):
            pass

    with _profile():
        t = threading.Thread(target=worker)
        t.start()
        t.join(10)
        assert not t.is_alive()
        with spans.span("main"):
            spans.count("frames", 3)
    assert seen == [True] and not spans.on()
    snap = spans.snapshot()
    assert sorted(_names(snap)) == ["main", "worker"] and snap.counters == {"frames": 3}
    assert len({s.tid for s in snap.spans}) == 2


def test_parents_per_thread_and_spans_across_threads():
    spans.clear()
    tokens = {}

    def worker(tag):
        with spans.span(f"outer.{tag}", rid=tag):
            with spans.span(f"inner.{tag}", rid=tag) as sp:
                spans.note(7)
                assert sp is not None
            tokens[tag] = spans.begin(f"hand.{tag}", rid=tag)

    with _profile():
        threads = [threading.Thread(target=worker, args=(k,)) for k in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
            assert not t.is_alive()
        closer = threading.Thread(target=lambda: [spans.end(tokens[k]) for k in (1, 2)])
        closer.start()
        closer.join(10)
    by = {s.name: s for s in spans.snapshot().spans}
    for k in (1, 2):
        outer, inner, hand = by[f"outer.{k}"], by[f"inner.{k}"], by[f"hand.{k}"]
        assert inner.parent == outer.id and outer.parent == 0 and inner.n == 7
        assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
        assert inner.nested and outer.nested and not hand.nested
        # begun inside ``outer`` on the worker, ended on another thread
        assert hand.tid == outer.tid and hand.parent == outer.id and hand.rid == k
        assert hand.end_ns >= outer.end_ns
    assert by["outer.1"].tid != by["outer.2"].tid


def test_the_ring_is_bounded():
    rec = spans.Recorder(size=8)
    with _profile():
        for k in range(20):
            rec.record("r", k, k + 1, rid=k)
    snap = rec.snapshot()
    assert [s.rid for s in snap.spans] == list(range(12, 20))
    assert spans.RING * 1.0 / 400 >= 120   # 120 s of ~400 spans a second (eight free sessions)


def test_a_cpu_op_lies_inside_its_mapped_span():
    """The profiler's events are in the mapped clock: each ``aten::mul`` lies
    inside the span around it."""
    spans.clear()
    a = torch.ones(4096)
    with _profile() as prof:
        for k in range(20):
            with spans.span("mul", rid=k):
                a * 2
    snap = spans.snapshot()
    muls = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                  if e.name() == "aten::mul")
    around = [s for s in snap.spans if s.name == "mul"]
    assert len(muls) == len(around) == 20
    for (s0, s1), sp in zip(muls, around):
        assert snap.to_trace(sp.start_ns) <= s0 and s1 <= snap.to_trace(sp.end_ns)


def _echo_factory(n):
    def step(model, buffer, idxs, mel):
        time.sleep(0.002)
        return idxs.view(-1, 1).clone()
    return step


def test_scheduler_spans_add_up_to_each_latency_entry():
    """A request's ``sched.hold`` and its batch's ``sched.to_host`` add up to
    its ``latency_s`` entry; each request's id is on one hold, one dispatch
    and one to_host span, and its future carries the to_host span's end."""
    from livetalking_tpu_torch.engine.scheduler import AvatarStore, BatchScheduler

    store = AvatarStore(item_shape=(1,), device="cpu")
    store.add("a", np.zeros((64, 1), np.uint8))
    sched = BatchScheduler(None, store, _echo_factory, batch_size=2, buckets=(1, 2, 4))
    spans.clear()
    rid = spans.request_ids()
    futures = {}
    with _profile():
        sched.start()
        try:
            for k in range(12):
                r = next(rid)
                futures[r] = sched.submit(np.arange(2 * k, 2 * k + 2) % 64, torch.zeros(2, 1), r)
                if k % 3 == 2:
                    time.sleep(0.01)
            for f in futures.values():
                f.result(timeout=30)
        finally:
            sched.stop()
    snap = spans.snapshot()
    hold = {s.rid: s for s in snap.spans if s.name == "sched.hold"}
    to_host = [s for s in snap.spans if s.name == "sched.to_host"]
    dispatch = [s for s in snap.spans if s.name == "sched.dispatch"]
    assert sorted(hold) == sorted(futures)
    for name, group in (("to_host", to_host), ("dispatch", dispatch)):
        ids = [r for s in group for r in s.rid]
        assert sorted(ids) == sorted(futures), name
        assert all(s.n == len(s.rid) for s in group)
    pairs = [(hold[r], s) for s in to_host for r in s.rid]
    assert len(pairs) == len(sched.latency_s) == 12
    for (h, t), latency in zip(pairs, sched.latency_s):
        assert h.end_ns == t.start_ns
        assert abs((h.end_ns - h.start_ns) + (t.end_ns - t.start_ns) - latency * 1e9) <= 1000
        assert futures[h.rid].host_ns == t.end_ns
    d = {s.rid: s for s in dispatch}
    for t in to_host:
        assert d[t.rid].start_ns == t.start_ns <= d[t.rid].end_ns


class _Frames:
    """A scheduler handle: frames, and when they reached the host."""

    def __init__(self, frames, host_ns):
        self.frames, self.host_ns = frames, host_ns


def test_session_threads_carry_the_request_id():
    """``BaseAvatar``'s inference and compose threads close the feature
    queue's span and record ``session.inflight``, ``compose.queue`` and
    ``compose.frame`` under the feature batch's request id."""
    import queue as q
    from types import SimpleNamespace

    from livetalking_tpu_torch.audio_features.base import AudioFrameData
    from livetalking_tpu_torch.avatars.base_avatar import BaseAvatar

    B = 2

    class Fake(BaseAvatar):
        def __init__(self):  # BaseAvatar.inference()'s and process_frames()'s collaborators
            self.batch_size = B
            self.custom_index = {}
            self.res_frame_queue = q.Queue()
            self.asr = SimpleNamespace(feat_queue=q.Queue(), output_queue=q.Queue())
            self.opt = SimpleNamespace(session_inflight=2)
            self.frame_list_cycle = [np.zeros((8, 8, 3), np.uint8)] * 4
            self.output = SimpleNamespace(start=lambda: None, stop=lambda: None,
                                          push_video_frame=lambda f: None,
                                          push_audio_frame=lambda a, u: None)
            self.submitted = []

        def record_video_data(self, frame):
            pass

        def record_audio_data(self, pcm):
            pass

        def submit_batch(self, index, feats, rid=None):
            self.submitted.append(rid)
            return _Frames(np.full((B, 8, 8, 3), rid % 256, np.uint8), spans.now())

        def resolve_batch(self, handle):
            return handle.frames

        def paste_back_frame(self, pred, idx):
            return pred.copy()

    av = Fake()
    spans.clear()
    rids = spans.request_ids()
    sent = []
    quit_i, quit_c = threading.Event(), threading.Event()
    with _profile():
        threads = [threading.Thread(target=av.inference, args=(quit_i,)),
                   threading.Thread(target=av.process_frames, args=(quit_c,))]
        for t in threads:
            t.start()
        for _ in range(3):
            r = next(rids)
            sent.append(r)
            av.asr.feat_queue.put((torch.zeros(B, 1), r, spans.begin("features.queue", r)))
            for _ in range(2 * B):
                av.asr.output_queue.put(AudioFrameData(np.zeros(320, np.float32), 0))
        deadline = time.monotonic() + 30
        while (sum(s.name == "compose.frame" for s in spans.snapshot().spans) < 3 * B
               and time.monotonic() < deadline):
            time.sleep(0.01)
        quit_i.set()
        quit_c.set()
        for t in threads:
            t.join(10)
            assert not t.is_alive()
    snap = spans.snapshot()
    assert av.submitted == sent
    for r in sent:
        mine = [s for s in snap.spans if s.rid == r]
        count = {n: sum(s.name == n for s in mine) for n in
                 ("features.queue", "session.inflight", "compose.queue", "compose.frame")}
        assert count == {"features.queue": 1, "session.inflight": 1, "compose.queue": B,
                         "compose.frame": B}, (r, count)


def test_profile_dir_trace_holds_the_spans(tmp_path):
    """``--profile_dir``'s Chrome trace holds the spans on their threads, in
    the trace's time base: an operation inside a span lies inside its event."""
    from livetalking_tpu_torch import app

    spans.clear()
    stop = app.start_profiler(str(tmp_path / "prof"), "cpu")
    x = torch.ones(4096)
    with spans.span("outer", rid=5):
        x * 3
    tok = spans.begin("handoff", rid=6)
    t = threading.Thread(target=spans.end, args=(tok,))
    t.start()
    t.join(10)
    path = stop()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    mine = [e for e in events if e.get("cat") == "span"]
    outer = next(e for e in mine if e["name"] == "outer")
    assert outer["ph"] == "X" and outer["args"]["rid"] == 5
    assert sorted(e["ph"] for e in mine if e["name"] == "handoff") == ["b", "e"]
    mul = next(e for e in events if e.get("name") == "aten::mul")
    assert outer["ts"] <= mul["ts"] and mul["ts"] + mul["dur"] <= outer["ts"] + outer["dur"]
    assert outer["tid"] == mul["tid"]
    names = {e["args"]["name"] for e in events if e.get("ph") == "M"
             and e.get("name") == "thread_name" and e.get("tid") == outer["tid"]}
    assert names
