"""Image helpers: ping-pong cycle indexing and parallel image loading
(ports livetalking_tpu/utils/image.py).

``mirror_index`` walks an avatar frame cycle forward then backward so the
loop never visibly jumps; ``read_imgs`` loads a sorted list of image paths
with a thread pool (``cv2`` is imported only there).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np


def mirror_index(size: int, index: int) -> int:
    """Ping-pong index into a cycle of ``size`` frames."""
    if size <= 1:
        return 0
    turn, res = divmod(index, size)
    return res if turn % 2 == 0 else size - res - 1


def mirror_indices(size: int, start: int, count: int) -> np.ndarray:
    """Vectorized ``mirror_index`` for a contiguous run of frame indices."""
    idx = np.arange(start, start + count, dtype=np.int64)
    if size <= 1:
        return np.zeros(count, dtype=np.int32)
    turn = idx // size
    res = idx % size
    return np.where(turn % 2 == 0, res, size - res - 1).astype(np.int32)


def read_imgs(img_paths: Sequence[str]) -> List[Optional[np.ndarray]]:
    """Load BGR images in parallel, preserving order."""
    import cv2

    frames: List[Optional[np.ndarray]] = [None] * len(img_paths)

    def _load(i: int) -> None:
        frames[i] = cv2.imread(img_paths[i])

    with ThreadPoolExecutor() as pool:
        list(pool.map(_load, range(len(img_paths))))
    return frames
