"""LRU projection/result cache for the serving frontend.

PyTorch counterpart of ``repro.serving.cache`` (numpy only: entries and
keys live on the host, so a hit never touches the device).

A cache entry is the *served* answer for one query row at one dispatch
width: the (n_bucket,) distances and external ids that came out of the
bucketed projection + search (+ optional exact re-rank) pipeline. Because
every dispatch path — direct or scheduled — computes at the same bucketed
shapes, a cached row is bit-identical to what a fresh dispatch would
return, so hits are indistinguishable from recomputation.

Keys quantise the query to its canonical float32 byte string
(:func:`query_fingerprint`) and append everything the answer depends on:
estimator mode, bucketed fetch/output widths, ``nprobe``, the re-rank
factor, and the **index generation** — a counter ``ZenIndex`` /
``IVFZenIndex`` bump on every upsert/delete/compact. Churn therefore never
serves stale results: old-generation entries can no longer be looked up
and age out of the LRU ring naturally.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Hashable, Optional, Tuple

import numpy as np


def query_fingerprint(row: np.ndarray) -> bytes:
    """Canonical byte string of one query row (the cache's quantisation).

    The row is cast to contiguous little-endian float32 first, so the same
    logical query hits the cache whether the caller passed float64, a
    non-contiguous slice, or a jax array — while queries that differ in
    even one f32 ulp never alias (cache hits must stay bit-identical to a
    fresh dispatch).
    """
    return np.ascontiguousarray(row, dtype="<f4").tobytes()


def result_key(
    fingerprint: bytes,
    mode: str,
    fetch_width: int,
    n_bucket: int,
    nprobe: int,
    rerank_factor: int,
    generation: int,
) -> Tuple[Hashable, ...]:
    """Full cache key of one served query row (see module docstring)."""
    return (fingerprint, mode, fetch_width, n_bucket, nprobe,
            rerank_factor, generation)


class LRUCache:
    """Bounded least-recently-used map with hit/miss accounting.

    Not thread-safe on its own — the scheduler serialises access under its
    queue lock. ``capacity <= 0`` disables the cache entirely (every
    ``get`` misses, ``put`` is a no-op), which lets callers keep one code
    path for the cached and uncached configurations.
    """

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._data: "OrderedDict[Hashable, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.stale_evictions = 0  # dropped by evict_stale (generation swap)

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: Hashable) -> Optional[Any]:
        """Return the cached value (refreshing recency) or ``None``."""
        if self.capacity <= 0:
            self.misses += 1
            return None
        try:
            value = self._data.pop(key)
        except KeyError:
            self.misses += 1
            return None
        self._data[key] = value  # re-insert at the MRU end
        self.hits += 1
        return value

    def put(self, key: Hashable, value: Any) -> None:
        """Insert (or refresh) an entry, evicting the LRU tail if full."""
        if self.capacity <= 0:
            return
        if key in self._data:
            self._data.pop(key)
        elif len(self._data) >= self.capacity:
            self._data.popitem(last=False)
            self.evictions += 1
        self._data[key] = value

    def evict_stale(self, generation: int) -> int:
        """Drop entries keyed on any generation other than ``generation``.

        Correctness never needs this — a key embeds its generation, so a
        stale entry can no longer be *looked up* after churn or a replica
        hot-swap. But the dead entries still occupy LRU capacity and would
        evict live ones; a replica calls this right after swapping to a
        freshly published generation (``MicroBatchScheduler.on_index_swap``)
        so the cache restarts the new generation at full capacity. Returns
        the number of entries dropped (also counted in ``stale_evictions``).
        """
        stale = [k for k in self._data
                 if isinstance(k, tuple) and k and k[-1] != generation]
        for k in stale:
            del self._data[k]
        self.stale_evictions += len(stale)
        return len(stale)

    def clear(self) -> None:
        """Drop every entry and restart the hit/miss accounting."""
        self._data.clear()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.stale_evictions = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def info(self) -> dict:
        return {
            "entries": len(self._data),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "stale_evictions": self.stale_evictions,
            "hit_rate": round(self.hit_rate, 4),
        }
