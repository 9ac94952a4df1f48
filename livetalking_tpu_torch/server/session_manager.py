"""Global session manager: sessionid -> BaseAvatar (ports
livetalking_tpu/server/session_manager.py).

Singleton; max-session
gate; sessions built in a thread-pool executor (model/avatar load is slow);
UUID session ids; a ``None`` placeholder reserves the slot during async
construction.
"""

from __future__ import annotations

import asyncio
import threading
import uuid
from typing import Callable, Dict, Optional

from livetalking_tpu_torch.utils.logger import logger


class MaxSessionError(Exception):
    """Raised when the concurrent-session limit is reached."""


class CapacityError(MaxSessionError):
    """Raised under --capacity_policy strict when a new session would
    exceed the measured per-device real-time capacity (sessions that
    sustain >=25 fps each), as opposed to the static --max_session gate."""


# Measured per-device real-time capacity (sessions sustaining >=25
# finalfps each) per family, used by --capacity_sessions -1. No family has
# been measured on the H100 yet (PERF.md), so auto admits on --max_session
# alone.
MEASURED_CAPACITY: Dict[str, int] = {}


class SessionManager:
    _instance = None
    _instance_lock = threading.Lock()

    def __new__(cls):
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = super().__new__(cls)
            return cls._instance

    def __init__(self):
        if getattr(self, "initialized", False):
            return
        self.sessions: Dict[str, object] = {}
        self.build_session_fn: Optional[Callable] = None
        self.max_session = 1
        self.capacity: Optional[int] = None
        self.capacity_policy = "off"
        self.over_capacity = False
        self._lock = threading.Lock()
        self.initialized = True

    def set_max_session(self, n: int) -> None:
        self.max_session = max(1, n)

    def configure_capacity(self, capacity: Optional[int],
                           policy: str = "warn") -> None:
        """Measured-capacity admission: ``capacity`` is the per-device
        session count known to sustain >=25 fps each
        (``MEASURED_CAPACITY`` or an operator override); ``policy`` is
        'warn' (admit + log, surfaced in /api/admin/sessions),
        'strict' (reject with a clean envelope error) or 'off'."""
        self.capacity = capacity if capacity and capacity > 0 else None
        self.capacity_policy = policy if policy in ("warn", "strict") else "off"

    def init_builder(self, build_session_fn: Callable) -> None:
        self.build_session_fn = build_session_fn

    def get_session(self, sessionid: str):
        return self.sessions.get(sessionid)

    def has_session(self, sessionid: str) -> bool:
        return self.sessions.get(sessionid) is not None

    async def create_session(self, params: dict, sessionid: Optional[str] = None) -> str:
        if self.build_session_fn is None:
            raise RuntimeError("SessionManager builder not initialized")
        if sessionid is None:
            sessionid = str(uuid.uuid4())

        with self._lock:
            active = sum(1 for s in self.sessions.values() if s is not None)
            if active >= self.max_session:
                raise MaxSessionError(
                    f"Maximum session limit reached ({active}/{self.max_session})"
                )
            if self.capacity is not None and active >= self.capacity:
                msg = (f"measured real-time capacity exceeded: {active + 1} "
                       f"sessions > {self.capacity} sustaining >=25 fps each "
                       "on this device (--capacity_sessions)")
                if self.capacity_policy == "strict":
                    raise CapacityError(msg)
                if self.capacity_policy == "warn":
                    self.over_capacity = True
                    logger.warning("%s — admitting anyway "
                                   "(--capacity_policy warn)", msg)
            elif self.capacity is not None:
                self.over_capacity = False
            logger.info("Creating sessionid=%s, current session num=%d", sessionid, active)
            self.sessions[sessionid] = None  # reserve

        try:
            avatar_session = await asyncio.get_event_loop().run_in_executor(
                None, self.build_session_fn, sessionid, params
            )
        except Exception:
            self.sessions.pop(sessionid, None)
            raise
        self.sessions[sessionid] = avatar_session
        return sessionid

    def add_session(self, sessionid: str, avatar_session) -> None:
        self.sessions[sessionid] = avatar_session

    def remove_session(self, sessionid: str) -> None:
        if sessionid in self.sessions:
            logger.info("Removing session %s", sessionid)
            self.sessions.pop(sessionid, None)


session_manager = SessionManager()
