"""Whole runs of the harness on the CPU at test widths: a cell, a
configuration, a mix, a metric and a model family added as files only; the
paced mix; the control run; and faults planted under the timed path, which
the check must catch."""

from __future__ import annotations

import argparse
import json
import os
import shutil

import pytest
import torch

from ltbench import run as ltrun
from ltbench.tests.conftest import ROOT, tiny_config

NEW_METRIC = '''"""frames_taken: every frame the viewers took in the window."""


def read(run):
    o = run.obs
    return sum(sum(1 for t in log.video_t if o.t0 <= t < o.t1) for log in o.logs)
'''

TOY_FAMILY = '''"""A throwaway family: each session's step sums the squares of 1..n on the
host; the check holds every answer against n(n + 1)(2n + 1) / 6."""

import contextlib
import time

import torch

from ltbench.drive import Observed, SessionLog
from ltbench.work import Op


def setup(cfg, mix, seed, device, phase):
    phase("toy")
    return {"n": int(cfg["n"]), "sessions": int(mix["sessions"]), "answers": []}


def serving(state):
    return contextlib.nullcontext(state)


def window(served, state, mix, seed, seconds, tracer):
    logs = [SessionLog() for _ in range(state["sessions"])]
    t0 = time.perf_counter()
    t1, steps = t0 + seconds, 0
    while time.perf_counter() < t1:
        x = torch.arange(1, state["n"] + 1, dtype=torch.float64)
        for log in logs:
            state["answers"].append(float(x @ x))
            log.video_t.append(time.perf_counter())
        steps += len(logs)
    return Observed(logs, t0, t1, {"start": {"steps": 0}, "end": {"steps": steps}})


def tally(obs):
    return sum(len(log.video_t) for log in obs.logs), 0


def release(state):
    pass


def compare(state, obs, seed):
    n = state["n"]
    wrong = sum(a != n * (n + 1) * (2 * n + 1) / 6 for a in state["answers"])
    return {"wrong_answers": {"value": wrong, "limit": 0}}


def work(cfg):
    return {"steps": [Op("dot", "float32", 2.0 * cfg["n"])]}


def control(cfg):
    return cfg
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout whose benchmark gained a cell, a configuration, two mixes
    and a per-layer metric, as new files and entries only."""
    r = tmp_path_factory.mktemp("checkout")
    for sub in ("metrics", "workloads", "configs", "families"):
        shutil.copytree(os.path.join(ROOT, "ltbench", sub), r / "ltbench" / sub)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cfg = tiny_config()
    (r / "ltbench" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (r / "ltbench" / "workloads" / "free2.json").write_text(json.dumps(
        {"kind": "free", "sessions": 2, "queued_s": 4.0, "warm_batches": 2,
         "check_frames_per_session": 4}))
    (r / "ltbench" / "workloads" / "paced2.json").write_text(json.dumps(
        {"kind": "paced", "sessions": 2, "utterance_s": [0.5, 1.0], "gap_s": [0.2, 0.4],
         "phase_s": 0.16, "fps": 25, "lead_s": 1.0, "check_frames_per_session": 4}))
    (r / "ltbench" / "metrics" / "frames_taken.py").write_text(NEW_METRIC)
    (r / "ltbench" / "families" / "toy.py").write_text(TOY_FAMILY)
    (r / "ltbench" / "configs" / "toy.json").write_text(json.dumps({"family": "toy", "n": 300}))
    bench["configs"] += [
        {"name": "tiny", "source": "test widths", "reduced": [],
         "file": "ltbench/configs/tiny.json", "why": "tests"},
        {"name": "toy", "source": "a sum of squares", "reduced": [],
         "file": "ltbench/configs/toy.json", "why": "tests"}]
    bench["workloads"] += [
        {"name": "tiny.free2", "config": "tiny", "traffic": "free2", "chips": 1, "why": "t"},
        {"name": "tiny.paced2", "config": "tiny", "traffic": "paced2", "chips": 1, "why": "t"},
        {"name": "toy.free2", "config": "toy", "traffic": "free2", "chips": 1, "why": "t"}]
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] += (["tiny.free2", "toy.free2"] if m["name"] == "frames_per_s"
                               else ["tiny.paced2"])
    bench["per_layer"].append({"name": "frames_taken", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "egress",
                               "moves": "frames_per_s", "workloads": ["tiny.free2"]})
    for m in bench["per_layer"]:
        if m["name"] == "requests_per_batch":
            m["workloads"].append("tiny.free2")
        if m["name"] == "step_mfu_pct":
            m["workloads"].append("toy.free2")
    (r / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(r)


def _run(root, workload, trace=0, seconds=12.0, edit=None):
    args = argparse.Namespace(workload=workload, seed=2 ** 31 + 77, seconds=seconds, trace=trace)
    return ltrun.run_cell(args, root, device="cpu", edit=edit)[0]


def test_new_files_only_cell_runs_correct(root):
    r = _run(root, "tiny.free2")
    assert r["correct"], r["compared"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"frames_per_s", "setup_s"}
    assert r["compared"]["frames_checked"]["value"] >= 2
    assert list(r)[-1] == "compared"


def test_new_per_layer_metric_is_read_by_name(root):
    r = _run(root, "tiny.free2", trace=1)
    assert r["correct"], r["compared"]
    assert r["metrics"]["frames_taken"]["value"] > 0
    assert r["metrics"]["requests_per_batch"]["value"] >= 1


def test_paced_mix(root):
    r = _run(root, "tiny.paced2", seconds=12.0)
    assert r["correct"], r["compared"]
    assert r["metrics"]["av_latency_p95_ms"]["value"] > 0


def test_new_family_is_found_by_name(root):
    """A model family added as a file: the harness runs its cell, reads an
    end-to-end metric and a per-layer metric from the family's work counts,
    and holds the family's check."""
    r = _run(root, "toy.free2", seconds=1.0)
    assert r["correct"] and r["compared"] == {"wrong_answers": {"value": 0, "limit": 0}}
    assert r["metrics"]["frames_per_s"]["value"] > 0
    r = _run(root, "toy.free2", trace=1, seconds=1.0)
    assert 0 < r["metrics"]["step_mfu_pct"]["value"] < 100


def test_control_run_is_not_correct(root, monkeypatch):
    """The calibration's control run (the configuration's control in the
    program's place: here the program's int8 route) fails the check."""
    monkeypatch.delenv("LT_FUSED_VAE", raising=False)   # the run sets it
    r = _run(root, "tiny.free2", edit=lambda cfg, mix, fam: (fam.control(cfg), mix))
    assert not r["correct"], r["compared"]


def test_without_a_card_no_result(capsys, monkeypatch):
    monkeypatch.chdir(ROOT)
    for key in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "USE_FLAX"):   # the run sets them
        monkeypatch.setenv(key, os.environ.get(key, ""))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ltrun.main(["--workload", "musetalk_bf16.free8", "--seed", str(2 ** 32 + 1),
                       "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def _idle(step):
    """A step that leaves its state as it was: the avatar's own frames."""
    from livetalking_tpu_torch.avatars import musetalk_avatar as muse

    def f(params, buffer, idxs, whisper):
        step(params, buffer, idxs, whisper)
        return muse._shared["store"].aux["pb_frames"].index_select(0, idxs.long())
    return f


def _half(step):
    """Half of the batch left out: its second half repeats the first."""
    def f(params, buffer, idxs, whisper):
        out = step(params, buffer, idxs, whisper).clone()
        h = out.shape[0] // 2
        out[h:2 * h] = out[:h]
        return out
    return f


def _altered(step):
    """An answer altered where it is produced: each frame's audio rows are
    those of its neighbour."""
    def f(params, buffer, idxs, whisper):
        return step(params, buffer, idxs, torch.roll(whisper, 1, dims=0))
    return f


@pytest.mark.parametrize("fault", [_idle, _half, _altered], ids=["unchanged", "half", "altered"])
def test_planted_fault_makes_correct_false(root, fault, monkeypatch):
    """Every super-batch step of the program routed through ``fault``."""
    from livetalking_tpu_torch.avatars import musetalk_avatar as muse

    factory = muse.make_step_factory

    def faulty_factory(*a, **kw):
        inner = factory(*a, **kw)
        return lambda n: fault(inner(n))

    monkeypatch.setattr(muse, "make_step_factory", faulty_factory)
    r = _run(root, "tiny.free2")
    assert not r["correct"], r["compared"]

