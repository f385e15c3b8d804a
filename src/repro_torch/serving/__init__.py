"""Serving frontend: micro-batching scheduler + result cache (PyTorch
counterpart of ``repro.serving``).

  * ``scheduler.MicroBatchScheduler`` coalesces concurrent ``submit()``
    calls into one dispatch per tick, pads each dispatch to a power-of-two
    query bucket and a fixed ``n_neighbors`` menu, and splits oversized
    coalesced batches at ``max_batch``;
  * ``cache.LRUCache`` is the result cache, keyed on the query's canonical
    f32 bytes plus (mode, width, nprobe, rerank, index generation): churn
    bumps the generation and invalidates every stale entry;
  * ``stats.FrontendStats`` carries the SLO instrumentation (latency
    percentiles, batch occupancy, cache hit rate, dispatch shapes,
    backpressure counters, replica hot-swaps);
  * ``loadgen.run_open_loop`` measures them under offered (Poisson) load.

``launch.serve.ZenServer(frontend=True)`` wires them together.
"""
from .cache import LRUCache, query_fingerprint, result_key
from .loadgen import OpenLoopReport, poisson_arrivals, run_open_loop
from .scheduler import (
    DEFAULT_NEIGHBOR_MENU,
    MIN_Q_BUCKET,
    FrontendOverloadError,
    MicroBatchScheduler,
    QueryHandle,
    bucket_neighbors,
    bucket_q,
)
from .stats import FrontendStats

__all__ = [
    "DEFAULT_NEIGHBOR_MENU",
    "FrontendOverloadError",
    "FrontendStats",
    "LRUCache",
    "MIN_Q_BUCKET",
    "MicroBatchScheduler",
    "OpenLoopReport",
    "QueryHandle",
    "bucket_neighbors",
    "bucket_q",
    "poisson_arrivals",
    "query_fingerprint",
    "result_key",
    "run_open_loop",
]
