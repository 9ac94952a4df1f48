"""WebRTC / rtcpush transport adapters (ports livetalking_tpu/streamout/webrtc.py).

Both modes forward composed A/V ticks to the session's ``HumanPlayer``
(the aiortc-facing pacer owned by ``server/rtc_manager.py``), which
attaches itself when the peer connection is negotiated; until then the
engine free-runs and ticks are dropped here. The adapter owns no
lifecycle: connect/teardown belong to the RTC manager, so
``start``/``stop`` are deliberate no-ops. It imports no ``aiortc``, so
the default transport has an output plugin where ``aiortc`` is absent.
"""

from __future__ import annotations

from typing import Optional

from livetalking_tpu_torch.registry import register
from livetalking_tpu_torch.streamout.base import BaseOutput


@register("streamout", "webrtc")
@register("streamout", "rtcpush")
class WebRTCOutput(BaseOutput):
    """Hand-off point between the frame composer and the RTC pacer."""

    def __init__(self, opt=None, parent=None, **kw):
        super().__init__(opt, parent)
        # set by rtc_manager once the peer connection is live; cleared
        # never (teardown kills the whole session, not the adapter)
        self._player = None

    def attach_player(self, player) -> None:
        """Called by the RTC manager when negotiation completes."""
        self._player = player

    # -- BaseOutput contract ---------------------------------------------

    def start(self) -> None:
        """No-op: the RTC manager owns connection lifecycle."""

    def stop(self) -> None:
        """No-op: teardown is driven from the peer-connection side."""

    def push_video_frame(self, frame) -> None:
        sink = self._player
        if sink is None:
            return  # not negotiated yet: drop, engine keeps pacing
        sink.push_video(frame)

    def push_audio_frame(self, frame, eventpoint: Optional[dict] = None) -> None:
        sink = self._player
        if sink is None:
            return
        sink.push_audio(frame, eventpoint)

    def get_buffer_size(self) -> int:
        """Pacer backlog in video frames (0 before negotiation — the
        engine must not throttle against a player that isn't there)."""
        probe = getattr(self._player, "get_buffer_size", None)
        return int(probe()) if probe else 0
