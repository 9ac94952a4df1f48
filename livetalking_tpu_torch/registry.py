"""Plugin registry: decorator registration + factory creation (ports
livetalking_tpu/registry.py).

The port keeps its own table, so the two packages never share a
``register`` table. Categories ``stt`` / ``llm`` / ``tts`` / ``avatar`` /
``streamout`` (``output`` is an alias of ``streamout``).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Type

from livetalking_tpu_torch.utils.logger import logger

_ALIASES = {"output": "streamout"}

_registry_lock = threading.Lock()
_REGISTRY: Dict[str, Dict[str, Type]] = {
    "stt": {},
    "llm": {},
    "tts": {},
    "avatar": {},
    "streamout": {},
}


def _canon(category: str) -> str:
    return _ALIASES.get(category, category)


def register(category: str, name: str) -> Callable[[Type], Type]:
    """Class decorator registering ``cls`` as ``category/name``."""

    def decorator(cls: Type) -> Type:
        cat = _canon(category)
        with _registry_lock:
            table = _REGISTRY.setdefault(cat, {})
            table[name] = cls
        logger.info("Registered %s/%s: %s", cat, name, cls.__name__)
        return cls

    return decorator


def create(category: str, name: str, **kwargs: Any) -> Any:
    """Instantiate the plugin registered as ``category/name``; raises
    ``ValueError`` listing the available plugins when the name is unknown."""
    cat = _canon(category)
    with _registry_lock:
        cls = _REGISTRY.get(cat, {}).get(name)
        available = list(_REGISTRY.get(cat, {}).keys())
    if cls is None:
        raise ValueError(
            f"Plugin '{name}' not found in category '{cat}'. Available: {available}"
        )
    return cls(**kwargs)


def list_plugins(category: Optional[str] = None) -> Dict[str, List[str]]:
    """List registered plugin names, optionally for one category."""
    with _registry_lock:
        if category:
            cat = _canon(category)
            return {cat: list(_REGISTRY.get(cat, {}).keys())}
        return {cat: list(tbl.keys()) for cat, tbl in _REGISTRY.items()}
