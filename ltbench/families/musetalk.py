"""MuseTalk's hooks for the harness: a configuration with ``"family": "musetalk"``.

``ltbench/run.py`` finds a family's module by that name and calls, in order:

  ``setup(cfg, mix, seed, device, phase) -> state``
      the program's kernels, weights from the seed, the program loaded with
      them, the avatars; ``phase(name)`` stamps the end of each step;
  ``serving(state)``, a context manager yielding the served system
      sessions opened as the server opens them, every shape the traffic
      uses warmed, nothing rendering yet; every thread stopped on exit;
  ``window(served, state, mix, seed, seconds, tracer) -> Observed``
      the traffic driven, ``seconds`` measured on the host clock;
  ``tally(obs) -> (attempted, failed)``;
  ``release(state)``: the program's state dropped before the reference runs;
  ``compare(state, obs, seed) -> {name: {"value", "limit"}}``;
  ``work(cfg) -> {counter: [Op]}``: the operations per unit of each of the
      program's counters (``step_mfu_pct`` and the rooflines read them);
  ``control(cfg) -> cfg``: the configuration of the cell's control run.

``cfg`` is the configuration file's contents. A new family is a new module
here with these functions; the harness needs no edit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch

from ltbench import avatars, check, program, weights
from ltbench.drive import DRIVERS, Observed, tally  # noqa: F401  (tally is a hook)
from ltbench.work import step_ops, whisper_ops


@dataclasses.dataclass
class State:
    cfg: dict
    device: str
    sds: Dict[str, dict]
    model: object
    avatars: List[dict]


def setup(cfg: dict, mix: dict, seed: int, device: str, phase: Callable) -> State:
    program.set_env(cfg.get("env", {}))
    if device == "cuda":
        program.build_kernels()
    phase("kernels")
    dtype = torch.bfloat16 if cfg["program"]["dtype"] == "bfloat16" else torch.float32
    sds = weights.state_dicts(cfg, seed, device, dtype)
    phase("weights")
    model = program.load_model(cfg, sds, dtype, device)
    phase("load_model")
    avs = avatars.make(cfg["avatar"], seed, int(mix["sessions"]), device)
    phase("avatars")
    return State(cfg, device, sds, model, avs)


def serving(state: State):
    return program.serve(state.model, state.cfg["program"], state.avatars, state.device,
                         (state.cfg["serving"]["audio_rows"], state.cfg["whisper"]["d_model"]))


def window(served, state: State, mix: dict, seed: int, seconds: float, tracer) -> Observed:
    return DRIVERS[mix["kind"]](served, mix, state.avatars, seed, seconds, tracer,
                                keep=int(mix["check_frames_per_session"]),
                                r=int(state.cfg["serving"]["r"]))


def release(state: State) -> None:
    state.model = None


def compare(state: State, obs: Observed, seed: int) -> Dict[str, dict]:
    return check.compare(state.cfg, state.sds, state.avatars, obs, seed, state.device)


def work(cfg: dict) -> Dict[str, list]:
    """Operations per frame the scheduler ran, and per request the feature
    coalescer ran."""
    return {"frames_run": step_ops(cfg), "feature_requests_run": whisper_ops(cfg)}


def control(cfg: dict) -> dict:
    """The configuration's ``control``: the program's lower-precision route
    (``program`` and ``env`` keys), or the reference at ``reference_bits``
    in the program's place."""
    c = cfg.get("control", {})
    return dict(cfg, program={**cfg["program"], **c.get("program", {})},
                env={**cfg.get("env", {}), **c.get("env", {})},
                check={**cfg["check"], "in_place_bits": int(c.get("reference_bits", 0))})
