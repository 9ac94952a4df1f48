"""Wav2Lip-256's hooks for the harness: a configuration with ``"family": "wav2lip"``.

The hooks are those ``ltbench/families/musetalk.py`` lists, in the same order.
Set-up draws the avatars before the weights: the weights' BatchNorm running
statistics are set on calibration faces of the first avatars
(``ltbench/weights_wav2lip.py``).

``window`` drives the traffic with ``ltbench/drive.py``'s loop, with two
additions:

  - speech made ahead of the loop. The loop makes each session's speech in
    5 s blocks as it feeds them; at 32 sessions the blocks fall due
    together, and making them stalled the loop, which is also the viewer,
    for 2-3 s at the start (the render threads meanwhile making silent
    frames). The queue transport then dropped the oldest frames of the
    sessions whose viewer was 100 frames behind, and the viewer's count of
    frames no longer matched the audio it took: the check read the frames
    as wrong. So the loop gets the seed's ``Speech`` with the first blocks
    made in set-up and a helper thread making each block before the loop
    reaches it;
  - a watchdog: the loop waits, with no deadline of its own, until every
    session has taken its warm-up batches. If that has not happened within
    the configuration's ``serving.warm_up_deadline_s`` (a program that
    serves no frame), the watchdog interrupts the loop and the run ends with
    ``WarmUpTimeout`` instead of hanging.
"""

from __future__ import annotations

import _thread
import dataclasses
import threading
from typing import Callable, Dict, List
from unittest import mock

import torch

from ltbench import avatars, check_wav2lip, drive, program_wav2lip, weights_wav2lip
from ltbench.drive import DRIVERS, Observed, tally  # noqa: F401  (tally is a hook)
from ltbench.program import build_kernels
from ltbench.traffic import BLOCK, Speech
from ltbench.work_wav2lip import mel_ops, step_ops


class WarmUpTimeout(RuntimeError):
    """The sessions did not reach the window's warm-up in time."""


class SpeechAhead(Speech):
    """The seed's speech (``traffic.Speech``), its blocks made ``ahead``
    blocks before any session's feed reaches them: the first in ``__init__``,
    the rest by ``fill`` (a thread's target) until ``stop`` is set."""

    def __init__(self, seed: int, sessions: int, ahead: int = 3):
        super().__init__(seed)
        self.sessions, self.ahead = sessions, ahead
        self.reached = 0   # the furthest block a feed has asked for
        self.made = 0      # blocks made for every session
        while self.made <= ahead:
            self._make(self.made)

    def _make(self, b: int) -> None:
        for k in range(self.sessions):
            super().chunk(k, b * BLOCK)
        self.made = b + 1

    def chunk(self, session: int, k: int):
        self.reached = max(self.reached, int(k) // BLOCK)
        return super().chunk(session, k)

    def fill(self, stop: threading.Event) -> None:
        while not stop.is_set():
            if self.made > self.reached + self.ahead:
                stop.wait(0.05)
            else:
                self._make(self.made)


@dataclasses.dataclass
class State:
    cfg: dict
    device: str
    sd: Dict[str, torch.Tensor]
    model: object
    avatars: List[dict]


def setup(cfg: dict, mix: dict, seed: int, device: str, phase: Callable) -> State:
    if device == "cuda":
        build_kernels()
    phase("kernels")
    avs = avatars.make(cfg["avatar"], seed, int(mix["sessions"]), device)
    phase("avatars")
    sd = weights_wav2lip.state_dict(cfg, seed, device, avs)
    phase("weights")
    dtype = torch.bfloat16 if cfg["program"]["dtype"] == "bfloat16" else torch.float32
    model = program_wav2lip.load_model(sd, dtype, device)
    phase("load_model")
    return State(cfg, device, sd, model, avs)


def serving(state: State):
    return program_wav2lip.serve(state.model, state.cfg["program"], state.avatars,
                                 state.device)


def window(served, state: State, mix: dict, seed: int, seconds: float, tracer) -> Observed:
    deadline = float(state.cfg["serving"]["warm_up_deadline_s"])
    reached = threading.Event()   # the loop reads the counters first at the window's start
    fired = threading.Event()
    served.on_counters = reached.set

    def watch():
        if not reached.wait(deadline):
            fired.set()
            _thread.interrupt_main()

    threading.Thread(target=watch, daemon=True, name="ltbench-warm-up-watchdog").start()
    speech = SpeechAhead(seed, len(served.sessions))
    done = threading.Event()
    threading.Thread(target=speech.fill, args=(done,), daemon=True,
                     name="ltbench-speech").start()
    try:
        with mock.patch.object(drive, "Speech", lambda _seed: speech):
            return DRIVERS[mix["kind"]](served, mix, state.avatars, seed, seconds, tracer,
                                        keep=int(mix["check_frames_per_session"]),
                                        r=int(state.cfg["serving"]["r"]))
    except KeyboardInterrupt:
        if fired.is_set():
            raise WarmUpTimeout(f"the sessions did not reach the warm-up of "
                                f"{mix.get('warm_batches')} batches each within "
                                f"{deadline:.0f} s") from None
        raise
    finally:
        reached.set()
        done.set()


def release(state: State) -> None:
    state.model = None


def compare(state: State, obs: Observed, seed: int) -> Dict[str, dict]:
    return check_wav2lip.compare(state.cfg, state.sd, state.avatars, obs, seed, state.device)


def work(cfg: dict) -> Dict[str, list]:
    """Operations per frame the scheduler ran, and per request the mel
    front-end served."""
    return {"frames_run": step_ops(cfg), "mel_requests_run": mel_ops(cfg)}


def control(cfg: dict) -> dict:
    """The reference at ``reference_bits`` in the program's place."""
    bits = int(cfg["control"]["reference_bits"])
    return dict(cfg, check={**cfg["check"], "in_place_bits": bits})
