"""The Wav2Lip family's boundary with the program under test,
``livetalking_tpu_torch``: loading, sessions and counters.

Sessions are made as the server makes them: ``app.load_plugin_stack(opt)``
with ``--model wav2lip`` (its warm-up included), ``session_manager.
create_session`` and ``app.start_render_thread``, with the ``queue``
transport. The weights are the benchmark's ``wav2lip256.pth`` state dict,
loaded by the program's own converter (``models/wav2lip.py::
convert_torch_state_dict``, which folds BatchNorm) and ``prepare``, and
handed to the server through ``wav2lip_avatar.load_model``, patched for the
run; no file is written. Avatars come from ``wav2lip_avatar.
avatar_from_arrays``, with (y1, y2, x1, x2) boxes.
"""

from __future__ import annotations

import asyncio
import contextlib
import importlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

PACKAGE = "livetalking_tpu_torch"
FEATURE_SHAPE = (80, 16)   # one frame's mel window


def _mod(name: str):
    return importlib.import_module(f"{PACKAGE}.{name}")


def load_model(sd: Dict[str, torch.Tensor], dtype: torch.dtype, device) -> dict:
    """The model dictionary ``wav2lip_avatar.load_model`` returns."""
    w2l = _mod("models.wav2lip")
    net = w2l.convert_torch_state_dict({k: v.detach().cpu() for k, v in sd.items()})
    dev = torch.device(device)
    return {"net": w2l.prepare(net, dev, dtype), "dtype": dtype, "device": dev}


def boxes_yyxx(coords) -> List[tuple]:
    """(x1, y1, x2, y2) boxes as the (y1, y2, x1, x2) the program takes."""
    return [(y1, y2, x1, x2) for (x1, y1, x2, y2) in coords]


class Served:
    """Running sessions and the program's counters."""

    def __init__(self, app, w2l_avatar, sessions: List, sids: List[str]):
        self.app, self.w2l_avatar = app, w2l_avatar
        self.sessions, self.sids = sessions, sids
        self.on_counters = None   # called at each ``counters()`` (the family's watchdog)

    def start(self) -> None:
        for sid in self.sids:
            self.app.start_render_thread(sid)

    @property
    def scheduler(self):
        return self.w2l_avatar._shared["scheduler"]

    def counters(self) -> dict:
        """A snapshot of the scheduler's counters (the rolling deques as
        lists), the mel front-end's requests (None where the program does
        not count them) and kernel 1's launches."""
        if self.on_counters is not None:
            self.on_counters()
        s = self.scheduler
        mel = getattr(_mod("ops.mel").make_mel_chunks_fn, "requests", None)
        return {"batches_run": s.batches_run, "requests_run": s.requests_run,
                "requests_submitted": s.requests_submitted, "frames_run": s.frames_run,
                "batch_sizes": list(s.batch_sizes), "latency_s": list(s.latency_s),
                "buckets": list(s.buckets), "batch_size": s.batch_size,
                "mel_requests_run": mel,
                "paste_launches": _mod("ops.blend").blend_rect_.launches}


@contextlib.contextmanager
def serve(model: dict, program: dict, avatars: List[dict], device):
    """``len(avatars)`` sessions of ``--model wav2lip`` with ``program``'s
    flags, each on its own avatar, not yet rendering, every bucket of the
    scheduler warmed; yields a ``Served``. Stops every thread and the shared
    scheduler on exit."""
    app = _mod("app")
    w2l_avatar = _mod("avatars.wav2lip_avatar")
    sm = _mod("server.session_manager").session_manager
    config = _mod("config")
    ids = [f"ltbench_{k}" for k in range(len(avatars))]
    for avatar_id, a in zip(ids, avatars):
        app.global_avatars[avatar_id] = w2l_avatar.avatar_from_arrays(
            avatar_id, a["frames"], np.asarray(a["faces"]), boxes_yyxx(a["coords"]),
            device=device)
    opt = config.default_opt(transport="queue", tts="dummy", device=str(device),
                             avatar_id=ids[0], max_session=len(ids), **program)
    saved_load = w2l_avatar.load_model
    w2l_avatar.load_model = lambda _path, _opt: model
    sids: List[str] = []
    try:
        app.load_plugin_stack(opt)
        for avatar_id in ids:
            sids.append(asyncio.run(sm.create_session({"avatar": avatar_id})))
        served = Served(app, w2l_avatar, [sm.get_session(s) for s in sids], sids)
        served.scheduler.prewarm(FEATURE_SHAPE)
        yield served
    finally:
        for sid in sids:
            sm.get_session(sid).flush_talk()
        with ThreadPoolExecutor(max(1, len(sids))) as pool:
            list(pool.map(lambda sid: app.stop_render_thread(sid, timeout=30), sids))
        for sid in sids:
            sm.remove_session(sid)
        w2l_avatar.reset_shared_scheduler()
        w2l_avatar.load_model = saved_load
        for avatar_id in ids:
            app.global_avatars.pop(avatar_id, None)
        app.model = None
