"""Traffic from a mix file and the seed: speech, and when it is handed in.

Every session speaks one stream of 20 ms chunks (320 samples at 16 kHz).
Chunk ``k`` of session ``s`` is a pure function of (seed, s, k): a voiced,
speech-like signal (a gliding fundamental with harmonics, a syllable-rate
envelope, a little noise) drawn block by block. Two kinds of mix:

``free``: a closed loop. The feeder keeps ``queued_s`` seconds of speech
queued in every session beyond what its viewer has taken, so the loop
never idles and runs as fast as the system allows; viewers drain frames as
they come.

``paced``: an open loop at real-time pace. Each session receives
utterances on a schedule drawn from the seed: lengths uniform in
``utterance_s``, gaps uniform in ``gap_s`` between one utterance's end and
the next one's start, session start phases spread over ``phase_s``. Each
utterance's chunks are handed in whole when it is due, as a TTS plugin
does; each viewer takes one frame per ``1/fps`` tick. Chunk ``c`` of an
utterance is due ``20 ms x c`` after the utterance's start.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

CHUNK = 320
BLOCK = 250  # chunks per generated block (5 s)


def _rng(*key: int) -> np.random.Generator:
    return np.random.default_rng([int(k) % (2 ** 63) for k in key])


class Speech:
    """Chunks of one seed's speech, cached by block."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self._blocks: Dict[tuple, np.ndarray] = {}

    def _block(self, session: int, b: int) -> np.ndarray:
        key = (session, b)
        if key not in self._blocks:
            r = _rng(self.seed, 7001, session, b)
            n = BLOCK * CHUNK
            t = np.arange(n) / 16000.0
            f0 = 110.0 + 110.0 * r.random() + 30.0 * np.sin(2 * np.pi * r.uniform(0.2, 0.6) * t
                                                           + r.uniform(0, 6.28))
            phase = 2 * np.pi * np.cumsum(f0) / 16000.0
            voice = sum(np.sin(h * phase + r.uniform(0, 6.28)) / h for h in range(1, 9))
            env = np.abs(np.sin(np.pi * r.uniform(3.0, 6.0) * t + r.uniform(0, 3.14)))
            x = 0.12 * voice * env + 0.01 * r.standard_normal(n)
            self._blocks[key] = np.clip(x, -0.99, 0.99).astype(np.float32)
        return self._blocks[key]

    def chunk(self, session: int, k: int) -> np.ndarray:
        b, i = divmod(int(k), BLOCK)
        return self._block(session, b)[i * CHUNK:(i + 1) * CHUNK]


@dataclasses.dataclass
class Utterance:
    session: int
    start_s: float      # due time of its first chunk, from the schedule's origin
    first: int          # serial of its first chunk in the session's stream
    n: int              # chunks


def paced_schedule(mix: dict, seed: int, sessions: int, horizon_s: float) -> List[List[Utterance]]:
    """Per session, the utterances starting before ``horizon_s``."""
    out = []
    lo_u, hi_u = mix["utterance_s"]
    lo_g, hi_g = mix["gap_s"]
    for s in range(sessions):
        r = _rng(seed, 7002, s)
        t = mix["phase_s"] * s / max(sessions, 1)
        serial, utts = 0, []
        while t < horizon_s:
            n = int(round(r.uniform(lo_u, hi_u) * 50))
            utts.append(Utterance(s, t, serial, n))
            serial += n
            t += n * 0.02 + r.uniform(lo_g, hi_g)
        out.append(utts)
    return out
