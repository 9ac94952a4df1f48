"""Interpreter-shutdown lifecycle for device worker threads (ports
livetalking_tpu/utils/lifecycle.py).

Long-lived worker objects with a ``stop()`` method register here; one
atexit hook stops them all before the interpreter tears down, so no daemon
thread is still inside a device call at exit. Registration is a WeakSet so
workers stay garbage-collectable.
"""

from __future__ import annotations

import atexit
import threading
import weakref

_lock = threading.Lock()
_live: "weakref.WeakSet" = weakref.WeakSet()


def register(obj) -> None:
    """Track a worker exposing ``stop()`` for stop-at-exit."""
    with _lock:
        _live.add(obj)


def stop_all() -> None:
    """Stop every live registered worker (idempotent; also callable from
    test teardown for deterministic ordering)."""
    with _lock:
        objs = list(_live)
    for o in objs:
        try:
            o.stop()
        except Exception:  # a failing stop must not block the others
            pass


atexit.register(stop_all)
