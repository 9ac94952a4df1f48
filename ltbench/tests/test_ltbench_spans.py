"""The span readers (``ltbench/spans.py`` and the metrics that use it) on a
synthetic run: each reader's value, None where the program has no span
module or recorded no span, the idle shares within the device's idle share;
and a traced run on the CPU at test widths, whose span metrics all read."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import types

import pytest

from ltbench import run as ltrun
from ltbench.drive import Observed
from ltbench.spec import Spec
from ltbench.tests.conftest import ROOT
from ltbench.tests.test_ltbench_harness import root  # noqa: F401  (the fixture)
from ltbench.trace import TraceData
from livetalking_tpu_torch.utils import spans as program_spans

MS = 1_000_000
T0, T1 = 100.0, 101.0            # the window, perf_counter seconds
OFFSET = 5_000_000_000            # the trace's clock: perf_counter_ns + OFFSET
LO = round(T0 * 1e9) + OFFSET     # the window's first instant on the trace's clock

P95 = {"feature_encode_p95_ms": "features.encode",
       "feature_queue_wait_p95_ms": "features.queue",
       "sched_hold_p95_ms": "sched.hold",
       "step_to_host_p95_ms": "sched.to_host",
       "inflight_hold_p95_ms": "session.inflight",
       "compose_queue_wait_p95_ms": "compose.queue"}
SPAN_METRICS = sorted(P95) + [f"{m}.{c}" for m in ("compose_ms_per_frame", "idle_in_dispatch_pct",
                                                    "idle_while_held_pct")
                              for c in ("free", "paced")]


def _span(name, start_ms, end_ms, k=0):
    """A span of the window at ``start_ms``..``end_ms`` after its first instant."""
    t0 = round(T0 * 1e9)
    return program_spans.Span(name, t0 + int(start_ms * MS), t0 + int(end_ms * MS), 1, 0, k,
                              None, k + 1, False)


def _synthetic():
    out = []
    for name in P95.values():
        # 1..20 ms long, ending in the window; one more ends after it
        out += [_span(name, 10 * k, 10 * k + k, k) for k in range(1, 21)]
        out.append(_span(name, 990, 1500, 99))
    return out + [_span("compose.frame", 0, 2), _span("compose.frame", 10, 14)]


def _launches():
    """The device is busy 0-200 and 500-700 ms of the window: idle 600 ms."""
    return [_span("sched.dispatch", 150, 250),           # idle under it: 200-250
            _span("sched.hold", 220, 550),               # held, not in dispatch: 250-500
            _span("sched.hold", 800, 900)]               # 800-900


def _run(spans, trace=True):
    snap = program_spans.Snapshot(spans, {}, lambda ns: ns + OFFSET, {})
    kernels = [("k0", LO, LO + 200 * MS), ("k1", LO + 500 * MS, LO + 700 * MS)]
    tr = TraceData(kernels, 0.4, 1.0, {}) if trace else None
    obs = Observed([], T0, T1, {})
    return ltrun.RunData({}, {}, {}, obs, 1.0, {}, tr), snap


@pytest.fixture
def fake_program(monkeypatch):
    """Puts a span module holding ``snap`` where the readers look."""

    def install(snap):
        mod = types.ModuleType("fake_spans")
        mod.snapshot = lambda: snap
        monkeypatch.setitem(sys.modules, "livetalking_tpu_torch.utils.spans", mod)
    return install


def _read(metric, run):
    return Spec(ROOT).reader(metric)(run)


@pytest.mark.parametrize("metric", sorted(P95))
def test_p95_readers(metric, fake_program):
    run, snap = _run(_synthetic())
    fake_program(snap)
    assert _read(metric, run) == pytest.approx(19.05)   # 1..20 ms, the 95th percentile


@pytest.mark.parametrize("cell", ["free", "paced"])
def test_compose_ms_per_frame(cell, fake_program):
    run, snap = _run(_synthetic())
    fake_program(snap)
    assert _read(f"compose_ms_per_frame.{cell}", run) == pytest.approx(3.0)


@pytest.mark.parametrize("cell", ["free", "paced"])
def test_idle_shares(cell, fake_program):
    run, snap = _run(_launches())
    fake_program(snap)
    assert _read(f"idle_in_dispatch_pct.{cell}", run) == pytest.approx(5.0)
    assert _read(f"idle_while_held_pct.{cell}", run) == pytest.approx(35.0)


def test_idle_shares_within_device_idle(fake_program):
    run, snap = _run(_launches())
    fake_program(snap)
    idle = _read("device_idle_pct", run)
    assert idle == pytest.approx(60.0)
    assert _read("idle_in_dispatch_pct.free", run) + _read("idle_while_held_pct.free", run) <= idle


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_none_without_the_span_module(metric, monkeypatch):
    """An older program (no ``utils/spans.py``): the import fails, the reader
    returns None."""
    run, _snap = _run(_synthetic() + _launches())
    monkeypatch.setitem(sys.modules, "livetalking_tpu_torch.utils.spans", None)
    assert _read(metric, run) is None


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_none_without_spans_or_trace(metric, fake_program):
    run, snap = _run([])
    fake_program(snap)
    assert _read(metric, run) is None
    run, snap = _run(_synthetic() + _launches(), trace=False)
    fake_program(snap)
    assert _read(metric, run) is None


def test_interval_arithmetic():
    from ltbench.spans import intersect, measure, subtract, union

    a = union([(5, 9), (0, 3), (2, 4), (9, 10)])
    assert a == [(0, 4), (5, 10)]
    assert intersect(a, [(3, 6), (8, 20)]) == [(3, 4), (5, 6), (8, 10)]
    assert subtract(a, [(1, 2), (3, 6), (7, 8)]) == [(0, 1), (2, 3), (6, 7), (8, 10)]
    assert measure(subtract([(0, 10)], a)) == 1


@pytest.fixture(scope="module")
def span_root(root, tmp_path_factory):  # noqa: F811
    """The harness's test checkout with the span metrics listing its tiny
    paced cell."""
    r = tmp_path_factory.mktemp("spans_checkout")
    shutil.copytree(os.path.join(root, "ltbench"), r / "ltbench")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["per_layer"]:
        if m["name"] in SPAN_METRICS and m["name"].endswith(("_ms", ".paced")):
            m["workloads"].append("tiny.paced2")
    (r / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(r)


def test_traced_paced_run_reads_every_span_metric(span_root):
    """A traced paced run on the CPU: every span metric but the idle shares
    (a CPU trace has no device activity) reads, and the scheduler's spans
    add up to its own latency entries."""
    args = argparse.Namespace(workload="tiny.paced2", seed=2 ** 31 + 77, seconds=12.0, trace=1)
    r = ltrun.run_cell(args, span_root, device="cpu")[0]
    assert r["correct"], r["compared"]
    m = r["metrics"]
    for name in ("feature_encode_p95_ms", "feature_queue_wait_p95_ms", "sched_hold_p95_ms",
                 "step_to_host_p95_ms", "inflight_hold_p95_ms", "compose_queue_wait_p95_ms",
                 "compose_ms_per_frame.paced"):
        assert m[name]["value"] > 0, name
    assert "idle_in_dispatch_pct.paced" not in m and "idle_while_held_pct.paced" not in m
