"""Bounded-LRU helper for caches of built programs.

Counterpart of ``multimodal_timesfm_tpu/utils/cache.py``. The ``Forecaster``
caches its captured CUDA graphs keyed by geometry tuples; each entry pins a
graph and its static buffers, so the cache must be bounded.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, TypeVar

V = TypeVar("V")


def lru_get(
    cache: OrderedDict,
    key: Any,
    factory: Callable[[], V],
    max_size: int,
) -> V:
    """Return ``cache[key]``, building it with ``factory()`` on a miss.

    Hits are moved to the MRU end; on insert the least-recently-used entries
    are evicted until ``len(cache) <= max_size``.
    """
    if key in cache:
        cache.move_to_end(key)
        return cache[key]
    value = factory()
    cache[key] = value
    while len(cache) > max_size:
        cache.popitem(last=False)
    return value
