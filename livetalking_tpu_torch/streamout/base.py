"""Output transport base class (ports livetalking_tpu/streamout/base.py)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import TYPE_CHECKING, Optional

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from livetalking_tpu_torch.avatars.base_avatar import BaseAvatar


class BaseOutput(ABC):
    """Transport contract: the frame composer pushes one BGR video frame per
    40 ms tick and two int16 16 kHz audio frames (20 ms each) per tick."""

    def __init__(self, opt=None, parent: Optional["BaseAvatar"] = None, **kwargs):
        self.opt = opt
        self.parent = parent

    @abstractmethod
    def start(self) -> None: ...

    @abstractmethod
    def push_video_frame(self, frame: np.ndarray) -> None: ...

    @abstractmethod
    def push_audio_frame(self, frame: np.ndarray, eventpoint: Optional[dict] = None) -> None: ...

    def get_buffer_size(self) -> int:
        """Backlog depth in video frames, for engine throttling."""
        return 0

    @abstractmethod
    def stop(self) -> None: ...
