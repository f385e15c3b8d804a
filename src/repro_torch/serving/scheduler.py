"""Micro-batching query scheduler with shape-bucketed dispatch.

PyTorch counterpart of ``repro.serving.scheduler``. Many small callers, one
kernel stream: concurrent ``submit()`` calls land in a bounded admission
queue; each ``tick()`` drains the queue, groups the pending rows by their
bucketed result shape, coalesces every group into dispatches of at most
``max_batch`` rows, pads each dispatch's row count to a **power-of-two Q
bucket** (floor 2, as in the JAX package), and hands the padded block to
``ZenServer._query_block``. The direct (unscheduled) path pads to the same
buckets, and every operation of the query path gives a row the same bits
whatever batch it rides in (``core.metrics``' row-invariant forms and the
search kernels), so every response — scheduled, cached, or direct — is
bit-identical.

Host and device: admission is on the host. A row's cache fingerprint is
taken from its host float32 bytes; a dispatch stacks its rows once, copies
the (Qp, m) block to the index's device once, and copies the results back
to the host once. Handles and the cache hold numpy arrays, so a cache hit
never touches the device.

Determinism is a design requirement: the scheduler never sleeps on its
own. ``tick()`` is a plain synchronous function; tests call it step by
step with a fake injected ``clock``. Production callers start the optional
ticker thread (``start()``), which calls ``tick()`` every
``tick_interval`` seconds on the index's device; ``ZenServer.query``
ticks inline when no ticker is running.

Backpressure is reject-on-full: ``submit`` raises
:class:`FrontendOverloadError` when the queue cannot take the request's
uncached rows, and the reject is counted in ``FrontendStats``.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .cache import LRUCache, query_fingerprint, result_key
from .stats import FrontendStats

#: fixed output-width menu: requested n_neighbors is rounded up to the next
#: entry (and to the next power of two beyond the menu)
DEFAULT_NEIGHBOR_MENU = (8, 16, 32, 64, 128)

#: smallest dispatched row count, as in the JAX package (whose XLA:CPU
#: lowers Q = 1 to a matvec with another reduction order)
MIN_Q_BUCKET = 2


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def bucket_q(q: int, max_batch: Optional[int] = None) -> int:
    """Power-of-two row bucket for a dispatch of ``q`` real rows.

    >>> [bucket_q(q) for q in (1, 2, 3, 8, 9)]
    [2, 2, 4, 8, 16]
    """
    b = max(_next_pow2(max(q, 1)), MIN_Q_BUCKET)
    return min(b, max_batch) if max_batch else b


def bucket_neighbors(
    n: int, menu: Sequence[int] = DEFAULT_NEIGHBOR_MENU
) -> int:
    """Round a requested ``n_neighbors`` up to the fixed width menu.

    >>> [bucket_neighbors(n) for n in (1, 8, 10, 100, 200)]
    [8, 8, 16, 128, 256]
    """
    for m in menu:
        if n <= m:
            return int(m)
    return _next_pow2(n)


class FrontendOverloadError(RuntimeError):
    """Raised by ``submit`` when the bounded admission queue is full."""


def _host_f32(queries) -> np.ndarray:
    """Host float32 copy (or view) of a query batch, tensor or array."""
    if isinstance(queries, torch.Tensor):
        return queries.detach().to("cpu", torch.float32).numpy()
    return np.asarray(queries, np.float32)


def _device_context(dev: torch.device):
    """Make ``dev`` the calling thread's current CUDA device (a no-op
    context for the CPU)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class QueryHandle:
    """Future-like response slot for one submitted query batch.

    Rows resolve independently (cache hits immediately, misses when their
    dispatch lands); ``result()`` blocks until every row is filled. The
    buffers are plain numpy so resolution never touches the device.
    """

    def __init__(self, n_rows: int, n_neighbors: int, clock):
        self._d = np.full((n_rows, n_neighbors), np.inf, np.float32)
        self._ids = np.full((n_rows, n_neighbors), -1, np.int32)
        self._remaining = n_rows
        self._clock = clock
        self._t_submit = clock()
        self._event = threading.Event()
        self._error: Optional[BaseException] = None
        self.latency_s: Optional[float] = None
        if n_rows == 0:
            self._event.set()
            self.latency_s = 0.0

    def _fill_row(self, row: int, d: np.ndarray, ids: np.ndarray) -> None:
        if self._error is not None:  # already failed: nothing to deliver
            return
        n = self._d.shape[1]
        self._d[row] = d[:n]
        self._ids[row] = ids[:n]
        self._remaining -= 1
        if self._remaining == 0:
            self.latency_s = self._clock() - self._t_submit
            self._event.set()

    def _fail(self, error: BaseException) -> None:
        """Resolve the handle with an error (dispatch failure): ``result``
        re-raises instead of blocking the caller forever."""
        if not self._event.is_set():
            self._error = error
            self.latency_s = self._clock() - self._t_submit
            self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(
        self, timeout: Optional[float] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(distances, ids), each (Q, n_neighbors) — blocks until resolved.

        Re-raises the dispatch error if the serving attempt failed."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                "query not resolved — is the scheduler ticking? (call "
                "tick()/flush(), or start() the ticker thread)")
        if self._error is not None:
            raise self._error
        return self._d, self._ids


class _Slot:
    """One pending query row: its handle position plus dispatch geometry."""

    __slots__ = ("handle", "row", "qrow", "fingerprint", "n_bucket", "width")

    def __init__(self, handle, row, qrow, fingerprint, n_bucket, width):
        self.handle = handle
        self.row = row
        self.qrow = qrow                  # (m,) f32 raw query vector
        self.fingerprint = fingerprint    # canonical f32 bytes of qrow
        self.n_bucket = n_bucket          # bucketed result width
        self.width = width                # bucketed candidate fetch width


class MicroBatchScheduler:
    """Coalesce concurrent query submissions into bucketed dispatches.

    Args:
      server:        the ``ZenServer`` whose ``_query_block`` serves padded
                     blocks on its index's device (it also supplies the
                     mode, nprobe, re-rank factor and the index generation
                     of the cache keys).
      max_batch:     largest dispatched row count (rounded up to a power of
                     two); oversized coalesced groups are split into
                     ``max_batch``-row dispatches.
      queue_limit:   bounded admission queue, in rows; ``submit`` raises
                     :class:`FrontendOverloadError` beyond it.
      cache_size:    LRU projection/result cache capacity in rows
                     (0 disables caching).
      neighbor_menu: fixed output-width menu (see :func:`bucket_neighbors`).
      clock:         injectable monotonic time source (tests pass a fake).
      tick_interval: ticker thread period in seconds (only used by
                     ``start()``; ``tick()`` itself never sleeps).
    """

    def __init__(
        self,
        server,
        *,
        max_batch: int = 64,
        queue_limit: int = 4096,
        cache_size: int = 0,
        neighbor_menu: Sequence[int] = DEFAULT_NEIGHBOR_MENU,
        clock=time.monotonic,
        tick_interval: float = 0.002,
    ):
        if max_batch < MIN_Q_BUCKET:
            raise ValueError(f"max_batch must be >= {MIN_Q_BUCKET}")
        self.server = server
        self.max_batch = _next_pow2(max_batch)
        self.queue_limit = int(queue_limit)
        self.neighbor_menu = tuple(neighbor_menu)
        self.clock = clock
        self.tick_interval = tick_interval
        self.cache = LRUCache(cache_size)
        self.stats = FrontendStats()
        self._pending: List[_Slot] = []
        self._lock = threading.Lock()
        self._ticker: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- admission -----------------------------------------------------------
    def _geometry(self, n_neighbors: int) -> Tuple[int, int]:
        """(n_bucket, fetch width) of a request — same math as the direct
        path (``ZenServer._query_geometry``), so cache entries written by
        one path are readable by the other."""
        return self.server._query_geometry(n_neighbors)

    def _cache_key(self, slot: _Slot, generation: Optional[int] = None):
        s = self.server
        gen = s.index.generation if generation is None else generation
        return result_key(
            slot.fingerprint, s.mode, slot.width, slot.n_bucket, s.nprobe,
            s.rerank_factor, gen)

    def submit(self, queries, n_neighbors: int = 10) -> QueryHandle:
        """Enqueue a (Q, m) or (m,) query; returns a :class:`QueryHandle`.

        Cached rows resolve immediately; the rest wait for a tick. Raises
        :class:`FrontendOverloadError` (counting the reject, resolving
        nothing) when the uncached rows would overflow ``queue_limit``.

        Queries are canonicalised to host float32 at admission (a tensor on
        the card is copied to the host once) — the serving frontend, like
        the cache fingerprint, is defined on f32 numerics. Callers who need
        f64 query precision should use the direct path
        (``ZenServer.query(..., direct=True)``).
        """
        q = _host_f32(queries)
        if q.ndim == 1:
            q = q[None, :]
        handle = QueryHandle(q.shape[0], n_neighbors, self.clock)
        if q.shape[0] == 0:
            return handle
        n_bucket, width = self._geometry(n_neighbors)
        slots = [
            _Slot(handle, i, q[i], query_fingerprint(q[i]), n_bucket, width)
            for i in range(q.shape[0])
        ]
        with self._lock:
            # every handle/stats/cache mutation happens under the queue
            # lock: a ticker thread may resolve this handle's uncached
            # rows the moment they land in _pending, and the row
            # countdown / counters are not atomic on their own
            hits = [(s, self.cache.get(self._cache_key(s))) for s in slots]
            misses = [s for s, v in hits if v is None]
            if len(misses) > self.queue_limit:
                # a retry can never succeed — don't dress this up as
                # transient overload (ZenServer.query routes such batches
                # to the direct path instead of submitting them)
                self.stats.record_reject(q.shape[0])
                raise FrontendOverloadError(
                    f"request of {len(misses)} uncached rows exceeds "
                    f"queue_limit={self.queue_limit}; split it or use the "
                    "direct path (ZenServer.query(..., direct=True))")
            if len(self._pending) + len(misses) > self.queue_limit:
                self.stats.record_reject(q.shape[0])
                raise FrontendOverloadError(
                    f"admission queue full ({len(self._pending)}/"
                    f"{self.queue_limit} rows pending); retry later or "
                    "raise queue_limit")
            self.stats.record_submit(q.shape[0])
            self.stats.record_cache(len(slots) - len(misses), len(misses))
            for s, value in hits:
                if value is not None:
                    s.handle._fill_row(s.row, *value)
            if handle.done():
                self.stats.record_complete(q.shape[0], handle.latency_s)
            self._pending.extend(misses)
        return handle

    @property
    def backlog(self) -> int:
        """Rows currently waiting for a dispatch."""
        with self._lock:
            return len(self._pending)

    def on_index_swap(self, generation: int) -> None:
        """Absorb a replica hot-swap to published ``generation``.

        Correctness needs nothing here — every cache key embeds its
        generation, so entries written against the pre-swap index can no
        longer be looked up the moment ``server.index`` points at the new
        snapshot. This hook is the bookkeeping that rides along: count the
        swap in :class:`FrontendStats` and drop the now-unreachable stale
        entries so they stop occupying LRU capacity
        (``LRUCache.evict_stale``). Called by ``launch.replicate``'s
        ``QueryReplica`` after each swap.
        """
        with self._lock:
            self.stats.record_swap(generation)
            self.cache.evict_stale(generation)

    # -- dispatch ------------------------------------------------------------
    def tick(self) -> int:
        """Drain the queue: coalesce, pad, dispatch. Returns dispatch count.

        Synchronous and sleep-free — the deterministic unit the simulation
        tests drive directly, and the only thing the ticker thread does.
        """
        tick_hook = getattr(self.server, "on_tick", None)
        if tick_hook is not None:  # shard liveness + preemption-save refresh
            tick_hook()            # (launch.serve.ZenServer fault tolerance)
        with self._lock:
            pending, self._pending = self._pending, []
        self.stats.record_tick()
        if not pending:
            return 0
        groups: Dict[Tuple[int, int], List[_Slot]] = {}
        for slot in pending:  # FIFO within each result-shape group
            groups.setdefault((slot.width, slot.n_bucket), []).append(slot)
        n_dispatches = 0
        for (width, n_bucket), slots in groups.items():
            for lo in range(0, len(slots), self.max_batch):
                chunk = slots[lo:lo + self.max_batch]
                try:
                    self._dispatch(chunk, width, n_bucket)
                except Exception as exc:  # noqa: BLE001 — fail the waiters,
                    # not the ticker: the popped slots would otherwise hang
                    # their callers forever and kill the tick loop
                    with self._lock:
                        self.stats.record_failure(len(chunk))
                        for slot in chunk:
                            slot.handle._fail(exc)
                else:  # a raised dispatch issued no kernel — don't count it
                    n_dispatches += 1
        return n_dispatches

    def _dispatch(
        self, slots: List[_Slot], width: int, n_bucket: int
    ) -> None:
        """One padded kernel dispatch for ``slots`` (all same geometry)."""
        rows = np.stack([s.qrow for s in slots])
        qp = bucket_q(rows.shape[0], self.max_batch)
        if qp > rows.shape[0]:  # pad with copies of a real row: any valid
            # vector works, the padding rows are sliced off unobserved
            pad = np.broadcast_to(rows[0], (qp - rows.shape[0],
                                            rows.shape[1]))
            rows = np.concatenate([rows, pad])
        # one index snapshot for both the compute and the cache keys:
        # concurrent churn swapping server.index mid-dispatch must not
        # store pre-churn results under the post-churn generation
        index = self.server.index
        dev = index.device
        # one copy up, one down; the ticker thread names the device itself
        # (a new thread starts on the default device)
        with _device_context(dev):
            d, ids = self.server._query_block(
                torch.from_numpy(rows).to(dev), width, n_bucket,
                index=index)
            d, ids = d.cpu().numpy(), ids.cpu().numpy()
        with self._lock:  # see submit(): handles/stats/cache share the lock
            self.stats.record_dispatch((qp, width, n_bucket), len(slots), qp)
            done: List[QueryHandle] = []
            for i, slot in enumerate(slots):
                # copies, not views: a row view would pin the whole (Qp,
                # n_bucket) dispatch arrays in the cache
                self.cache.put(self._cache_key(slot, index.generation),
                               (d[i].copy(), ids[i].copy()))
                slot.handle._fill_row(slot.row, d[i], ids[i])
                if slot.handle.done() and slot.handle not in done:
                    done.append(slot.handle)
            for handle in done:
                self.stats.record_complete(handle._d.shape[0],
                                           handle.latency_s)

    def flush(self) -> None:
        """Tick until the queue is empty (inline driving, no ticker)."""
        while True:
            with self._lock:
                if not self._pending:
                    return
            self.tick()

    # -- optional ticker thread ---------------------------------------------
    @property
    def running(self) -> bool:
        return self._ticker is not None and self._ticker.is_alive()

    def start(self) -> "MicroBatchScheduler":
        """Start the background ticker (idempotent). Returns self."""
        if not self.running:
            self._stop.clear()
            self._ticker = threading.Thread(
                target=self._tick_loop, name="zen-frontend-ticker",
                daemon=True)
            self._ticker.start()
        return self

    def stop(self) -> None:
        """Stop the ticker and drain whatever is still queued."""
        self._stop.set()
        if self._ticker is not None:
            self._ticker.join(timeout=5.0)
            self._ticker = None
        self.flush()

    def _tick_loop(self) -> None:
        while not self._stop.wait(self.tick_interval):
            self.tick()
