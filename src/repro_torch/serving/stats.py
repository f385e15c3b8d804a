"""SLO instrumentation for the serving frontend.

PyTorch counterpart of ``repro.serving.stats`` (pure Python).

One ``FrontendStats`` object per scheduler collects everything an operator
needs to see whether the frontend is earning its keep:

  * **latency** — per-request submit-to-complete wall time (measured with
    the scheduler's injectable clock, so simulation tests get exact
    deterministic values), reported as p50/p95/p99 over a bounded window;
  * **batch occupancy** — real rows per dispatch over the padded bucket
    size; low occupancy means the tick interval is too short or traffic
    too thin for batching to pay;
  * **cache hit rate** — forwarded from the LRU projection/result cache;
  * **compile pressure** — the set of distinct dispatch shapes
    ``(Q_bucket, fetch_width, n_bucket)`` seen so far; its size bounds the
    number of launch shapes (and so of kernel plans) the query path
    creates, and must stay at most the bucket-menu size;
  * **backpressure** — submitted/rejected/completed row counters for the
    bounded admission queue.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Tuple

import numpy as np

#: latency samples kept for the percentile window (oldest dropped first)
LATENCY_WINDOW = 4096


class FrontendStats:
    """Counters + bounded latency window for one scheduler (see module doc)."""

    def __init__(self, window: int = LATENCY_WINDOW):
        self.submitted = 0        # rows accepted into the frontend
        self.rejected = 0         # rows refused by reject-on-full
        self.completed = 0        # rows answered (cache hits included)
        self.failures = 0         # rows resolved with a dispatch error
        self.cache_hits = 0
        self.cache_misses = 0
        self.dispatches = 0       # kernel dispatches issued
        self.dispatched_rows = 0  # real rows across all dispatches
        self.padded_rows = 0      # padded (bucketed) rows across dispatches
        self.ticks = 0
        self.swaps = 0            # replica hot-swaps absorbed (replication)
        self.serving_generation = None  # generation after the last swap
        self.dispatch_shapes: set = set()  # distinct (Qp, w, n_bucket)
        self._latency_s: Deque[float] = deque(maxlen=window)

    # -- recording hooks -----------------------------------------------------
    def record_submit(self, rows: int) -> None:
        self.submitted += rows

    def record_reject(self, rows: int) -> None:
        self.rejected += rows

    def record_failure(self, rows: int) -> None:
        """Rows whose dispatch raised (their handles carry the error)."""
        self.failures += rows

    def record_cache(self, hits: int, misses: int) -> None:
        self.cache_hits += hits
        self.cache_misses += misses

    def record_tick(self) -> None:
        self.ticks += 1

    def record_swap(self, generation: int) -> None:
        """One replica hot-swap to a newly published index generation."""
        self.swaps += 1
        self.serving_generation = int(generation)

    def record_dispatch(
        self, shape: Tuple[int, int, int], real_rows: int, padded_rows: int
    ) -> None:
        """One kernel dispatch: its bucketed shape and fill level."""
        self.dispatches += 1
        self.dispatched_rows += real_rows
        self.padded_rows += padded_rows
        self.dispatch_shapes.add(shape)

    def record_complete(self, rows: int, latency_s: float) -> None:
        self.completed += rows
        self._latency_s.append(latency_s)

    # -- derived -------------------------------------------------------------
    @property
    def occupancy(self) -> float:
        """Mean dispatch fill: real rows / padded bucket rows."""
        return (self.dispatched_rows / self.padded_rows
                if self.padded_rows else 0.0)

    @property
    def cache_hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    @property
    def compile_count(self) -> int:
        """Distinct dispatch shapes — an upper bound on query-path compiles."""
        return len(self.dispatch_shapes)

    def latency_percentiles(self) -> dict:
        """p50/p95/p99 over the window — NaN until the first sample lands.

        An idle frontend must not report a perfect p99: fabricating a 0.0 ms
        sample would satisfy any SLO check before a single query ran.
        """
        if not self._latency_s:
            nan = float("nan")
            return {"p50_ms": nan, "p95_ms": nan, "p99_ms": nan}
        lat = np.asarray(self._latency_s, np.float64)
        return {
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p95_ms": float(np.percentile(lat, 95) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
        }

    def snapshot(self) -> dict:
        """Flat dict for ``ZenServer.stats()`` / logging. Latency percentile
        keys are omitted until at least one sample exists — absent beats a
        NaN that breaks naive JSON serialisation of operator dashboards."""
        out = {
            "submitted": self.submitted,
            "rejected": self.rejected,
            "completed": self.completed,
            "failures": self.failures,
            "ticks": self.ticks,
            "dispatches": self.dispatches,
            "batch_occupancy": round(self.occupancy, 4),
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "cache_hit_rate": round(self.cache_hit_rate, 4),
            "compile_count": self.compile_count,
        }
        if self.swaps:
            out["swaps"] = self.swaps
            out["serving_generation"] = self.serving_generation
        if self._latency_s:
            out.update(self.latency_percentiles())
        return out
