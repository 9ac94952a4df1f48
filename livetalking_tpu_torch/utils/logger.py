"""Framework logger (ports livetalking_tpu/utils/logger.py).

Keeps the reference's published metric log shapes (``inferfps`` /
``finalfps`` counters) so tooling that scrapes the log keeps working. A
file handler writes ``livetalking.log`` (or ``$LIVETALKING_LOG``) and a
stream handler serves containers.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger("livetalking_tpu_torch")
logger.setLevel(logging.DEBUG)

if not logger.handlers:
    _fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")

    _logfile = os.environ.get("LIVETALKING_LOG", "livetalking.log")
    try:
        _fh = logging.FileHandler(_logfile, encoding="utf-8")
        _fh.setFormatter(_fmt)
        _fh.setLevel(logging.INFO)
        logger.addHandler(_fh)
    except OSError:  # read-only fs etc.
        pass

    _sh = logging.StreamHandler()
    _sh.setFormatter(_fmt)
    _sh.setLevel(os.environ.get("LIVETALKING_LOGLEVEL", "INFO"))
    logger.addHandler(_sh)
