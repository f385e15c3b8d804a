"""Replicated query-plane serving: one index owner, N hot-swapping replicas.

PyTorch counterpart of ``repro.launch.replicate``; the snapshots and the
publish pointer are the JAX package's files, so a replica of either
package serves a generation that a leader of either published.

The paper's transform is fitted once and then applied out-of-sample from
reference distances alone, so the fitted index is a read-mostly artifact —
the natural production shape is a single **leader** that owns churn and N
**query-plane replicas** that only serve. This module is that split, built
on the existing primitives:

* :class:`IndexLeader` wraps the one mutable ``ZenServer``. Churn goes
  through it (``upsert``/``delete``/``compact``); ``publish()`` writes the
  full serving state as an atomic versioned snapshot
  (``ZenServer.save`` -> ``checkpoint.index_io``) into a per-generation
  directory under the publish root, then atomically replaces the
  ``PUBLISHED.json`` pointer (``index_io.write_json_atomic``). The pointer
  is written strictly *after* the snapshot directory is complete, so a
  leader killed mid-publish leaves the previous pointer aimed at the
  previous — fully loadable — snapshot; the half-written attempt is a
  ``tmp.*`` sibling no reader ever follows.

* :class:`QueryReplica` watches the publish root. ``poll()`` reads the
  pointer and, on a new generation, loads the snapshot into a fresh
  ``ZenIndex`` on the replica's device (``serve.load_index_snapshot``,
  optionally ``mmap=True`` and/or over a published tile pool for the
  tiered store) and swaps it under its long-lived ``ZenServer``. The swap is a single attribute
  assignment: in-flight queries already hold the old ``ZenIndex`` snapshot
  (``_query_block`` reads ``server.index`` exactly once per dispatch), and
  the replica additionally *pins* each generation with an in-flight
  counter so the old index — its device memory and any mmap'd files
  backing it — is released only after its last query resolves, never
  under one. During a swap both generations are resident on the device.

**Generation is the coherence key.** The published snapshot carries the
leader's monotonic ``generation`` churn counter, the restored index serves
under it (not a local counter restarted at 0), and the frontend result
cache keys every entry on it — so a pre-swap cache entry is structurally
unreachable after a hot-swap, on every replica, with no invalidation
message. ``MicroBatchScheduler.on_index_swap`` additionally evicts the
dead entries so they stop occupying LRU capacity.

Replicas are pull-based and may lag (a lagging replica keeps serving its
old generation — correct, just stale); the leader observes the fleet via
``distributed.fault.ReplicaTracker`` and hands off cleanly on preemption
(``enable_preemption``: publish one final snapshot, then refuse churn).

Deterministic simulation coverage lives in
``tests/test_torch_replication.py``; the open-loop SLO harness that drives
replica fleets under offered load is ``repro_torch.serving.loadgen``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import index_io
from repro_torch.checkpoint.index_io import CheckpointFormatError
from repro_torch.distributed.fault import PreemptionGuard, ReplicaTracker
from repro_torch.index.ivf import TieredIVFZenIndex
from repro_torch.launch.serve import ZenServer, load_index_snapshot

#: pointer file the replicas watch, at the publish root
PUBLISH_POINTER = "PUBLISHED.json"
#: pointer format tag / version (checked by readers; never reuse the tag)
PUBLISH_FORMAT = "zen-publish"
PUBLISH_VERSION = 1


class LeaderHandedOff(RuntimeError):
    """Churn refused: the leader already published its handoff snapshot."""


class ReplicaNotReady(RuntimeError):
    """Query refused: the replica has not swapped to any snapshot yet."""


class PublishedSnapshot(NamedTuple):
    """One resolved publish-pointer target."""

    generation: int
    snapshot: str             # server snapshot directory (absolute)
    pool: Optional[str]       # tile-pool snapshot directory, when published


def _gen_dirname(generation: int) -> str:
    # zero-padded so lexicographic order == generation order (ls-friendly)
    return f"gen-{int(generation):012d}"


def read_pointer(root: str) -> Optional[PublishedSnapshot]:
    """Resolve the publish pointer under ``root``; ``None`` before the
    first publish. Raises :class:`CheckpointFormatError` for a pointer
    written by an unknown format/version (never guess at a layout)."""
    path = os.path.join(root, PUBLISH_POINTER)
    try:
        with open(path) as f:
            ptr = json.load(f)
    except FileNotFoundError:
        return None
    if (ptr.get("format") != PUBLISH_FORMAT
            or ptr.get("version") != PUBLISH_VERSION):
        raise CheckpointFormatError(
            f"{path}: publish pointer format "
            f"{ptr.get('format')!r} v{ptr.get('version')!r}, expected "
            f"{PUBLISH_FORMAT!r} v{PUBLISH_VERSION}")
    pool = ptr.get("pool")
    return PublishedSnapshot(
        generation=int(ptr["generation"]),
        snapshot=os.path.join(root, ptr["snapshot"]),
        pool=None if pool is None else os.path.join(root, pool),
    )


class IndexLeader:
    """The index owner: applies churn, publishes snapshots, tracks the fleet.

    Args:
      server:       the one mutable ``ZenServer`` (flat or resident IVF).
      root:         publish root directory (created on first publish).
      keep:         published generations retained after each publish (the
                    pointer target is always kept; older directories are
                    pruned — POSIX keeps the inodes alive for any lagging
                    replica that still mmaps them).
      publish_pool: also publish the IVF tier as a ``TieredIVFZenIndex``
                    tile-pool snapshot next to each server snapshot
                    (``<gen>.pool``), so replicas can serve the cold tiles
                    straight off the mmap'd files (resident-IVF leaders
                    only; the pool rides the same generation + pointer).
    """

    def __init__(self, server: ZenServer, root: str, *, keep: int = 2,
                 publish_pool: bool = False):
        if keep < 1:
            raise ValueError("keep must be >= 1 (the published snapshot)")
        if publish_pool and (server.index.ivf is None
                             or server.index._is_tiered()):
            raise ValueError(
                "publish_pool=True needs a resident IVF leader index (the "
                "pool is packed from the leader's inverted lists)")
        self.server = server
        self.root = os.path.abspath(root)
        self.keep = int(keep)
        self.publish_pool = bool(publish_pool)
        self.handed_off = False
        self.preemption = None           # PreemptionGuard (enable_preemption)
        self.replicas = None             # ReplicaTracker (track_replicas)
        self._published: Optional[PublishedSnapshot] = None

    # -- state ----------------------------------------------------------------
    @property
    def generation(self) -> int:
        """The live (possibly not yet published) churn generation."""
        return int(self.server.index.generation)

    @property
    def published_generation(self) -> Optional[int]:
        pub = self._published or read_pointer(self.root)
        return None if pub is None else pub.generation

    # -- churn (refused after handoff) ----------------------------------------
    def _check_owner(self) -> None:
        if self.handed_off:
            raise LeaderHandedOff(
                "this leader published its handoff snapshot (preemption); "
                "churn must move to the successor")

    def upsert(self, ids: Sequence[int], vectors) -> None:
        self._check_owner()
        self.server.upsert(ids, vectors)

    def delete(self, ids: Sequence[int]) -> None:
        self._check_owner()
        self.server.delete(ids)

    def compact(self, **kw) -> None:
        self._check_owner()
        self.server.compact(**kw)

    def maybe_compact(self, **thresholds) -> bool:
        self._check_owner()
        return self.server.maybe_compact(**thresholds)

    # -- publish ---------------------------------------------------------------
    def publish(self) -> PublishedSnapshot:
        """Atomically publish the current index state under its generation.

        Write order is the crash-safety argument: (1) the snapshot
        directory (itself tmp+fsync+rename atomic), (2) the pool when
        enabled, (3) the pointer (atomic file replace). A crash anywhere
        leaves the pointer aimed at a complete earlier snapshot; republish
        of the *same* generation is idempotent.
        """
        gen = self.generation
        os.makedirs(self.root, exist_ok=True)
        snap = os.path.join(self.root, _gen_dirname(gen))
        self.server.save(snap)
        pool = None
        if self.publish_pool:
            tiered = TieredIVFZenIndex.from_index(self.server.index.ivf)
            # pool coherence rides the *wrapper* generation (the cache key),
            # not the inner IVF counter from_index propagated
            tiered.generation = gen
            pool = snap + ".pool"
            tiered.save(pool)
        index_io.write_json_atomic(
            os.path.join(self.root, PUBLISH_POINTER),
            {
                "format": PUBLISH_FORMAT,
                "version": PUBLISH_VERSION,
                "generation": gen,
                "snapshot": os.path.basename(snap),
                "pool": None if pool is None else os.path.basename(pool),
            },
        )
        self._published = PublishedSnapshot(gen, snap, pool)
        self._prune()
        return self._published

    def _prune(self) -> None:
        """Drop published generations beyond ``keep`` (never the pointer's)."""
        assert self._published is not None
        gens = sorted(
            (name for name in os.listdir(self.root)
             if name.startswith("gen-") and not name.endswith(".pool")),
            reverse=True)
        current = os.path.basename(self._published.snapshot)
        for name in gens[self.keep:]:
            if name == current:
                continue
            shutil.rmtree(os.path.join(self.root, name), ignore_errors=True)
            shutil.rmtree(os.path.join(self.root, name + ".pool"),
                          ignore_errors=True)

    # -- preemption handoff ----------------------------------------------------
    def enable_preemption(self, *, install_signal: bool = False):
        """Attach a ``PreemptionGuard``; check it via :meth:`maybe_handoff`."""
        self.preemption = PreemptionGuard(install_signal=install_signal)
        return self.preemption

    def maybe_handoff(self) -> bool:
        """Publish-and-retire when the platform announced preemption.

        Returns True when the handoff ran: one final snapshot of the
        current generation is published (replicas keep serving, a successor
        leader loads it and resumes churn from the same counter) and every
        later churn call raises :class:`LeaderHandedOff`. Call this from
        the leader's control loop — e.g. once per churn batch.
        """
        guard = self.preemption
        if guard is None or not guard.should_save() or self.handed_off:
            return False
        self.publish()
        self.handed_off = True
        guard.clear()
        return True

    # -- fleet observation -----------------------------------------------------
    def track_replicas(self, *, deadline_s: float = 60.0, clock=None):
        """Attach a ``distributed.fault.ReplicaTracker`` for the fleet."""
        kw = {"now": clock} if clock is not None else {}
        self.replicas = ReplicaTracker(deadline_s=deadline_s, **kw)
        return self.replicas

    def replica_report(self, replica: str, generation: int) -> None:
        """One replica status beat (its currently served generation)."""
        if self.replicas is None:
            raise RuntimeError("call track_replicas() first")
        self.replicas.report(replica, generation)

    def fleet_status(self) -> dict:
        """Liveness + lag of every reporting replica vs the last publish."""
        if self.replicas is None:
            raise RuntimeError("call track_replicas() first")
        pub = self.published_generation
        return self.replicas.status(-1 if pub is None else pub)


class _PinnedIndex:
    """One fully swapped-in index generation + its in-flight query count."""

    __slots__ = ("generation", "index", "inflight")

    def __init__(self, generation: int, index):
        self.generation = generation
        self.index = index
        self.inflight = 0


class QueryReplica:
    """A query-plane replica: watches the publish root, hot-swaps, serves.

    The replica owns one long-lived ``ZenServer`` (constructed from the
    saved server config at the first successful :meth:`poll`, with
    ``server_kw`` overrides — e.g. ``frontend=True, cache_size=...``).
    Swaps replace only ``server.index``, so the frontend scheduler, its
    stats, and its generation-keyed result cache survive across
    generations; queries in flight during a swap finish on the index they
    started on (pinned until their last row resolves) and a generation is
    never served before its snapshot is *fully* loaded — the swap is the
    publication point.

    ``poll()`` is explicitly non-throwing for torn or vanished publishes:
    a replica that cannot load the new pointer target keeps serving its
    current generation and counts the error (``poll_errors``), which is
    exactly the lagging-replica behaviour the leader's ``ReplicaTracker``
    surfaces.

    Args:
      root:      publish root (shared with the leader).
      name:      replica name used in ``stats()`` / fleet reports.
      mmap:      load snapshots with read-only memory-mapping.
      use_pool:  serve the IVF tier from the published tile pool when the
                 pointer advertises one (tiered mmap'd store).
      pool_kw:   extra ``TieredIVFZenIndex.load`` options.
      device:    where the loaded generations live ("cuda" unless told
                 otherwise; raises without a card).
      server_kw: ``ZenServer`` construction overrides on top of the saved
                 server config.
    """

    def __init__(self, root: str, *, name: str = "replica",
                 mmap: bool = False, use_pool: bool = False,
                 pool_kw: Optional[dict] = None, device=None, **server_kw):
        self.device = resolve_device(device)
        self.root = os.path.abspath(root)
        self.name = str(name)
        self.mmap = bool(mmap)
        self.use_pool = bool(use_pool)
        self.pool_kw = dict(pool_kw or {})
        self.server_kw = dict(server_kw)
        self.server: Optional[ZenServer] = None
        self.swaps = 0
        self.poll_errors = 0
        self.last_error: Optional[str] = None
        self._lock = threading.Lock()
        self._current: Optional[_PinnedIndex] = None
        self._retired: list[_PinnedIndex] = []        # pinned by in-flight
        self._released: list[int] = []                # fully released gens

    # -- swap protocol ---------------------------------------------------------
    @property
    def generation(self) -> Optional[int]:
        """Generation currently served; ``None`` before the first swap."""
        cur = self._current
        return None if cur is None else cur.generation

    def poll(self) -> bool:
        """Check the publish pointer; hot-swap when it moved forward.

        Returns True iff a swap happened. Never raises on a torn/missing
        publish — the replica keeps serving what it has (see class doc).
        """
        try:
            pub = read_pointer(self.root)
        except (CheckpointFormatError, json.JSONDecodeError, OSError) as e:
            self.poll_errors += 1
            self.last_error = repr(e)
            return False
        if pub is None:
            return False
        cur = self._current
        if cur is not None and pub.generation <= cur.generation:
            return False  # nothing newer (a pointer never moves backwards)
        try:
            index, saved_kw = load_index_snapshot(
                pub.snapshot, mmap=self.mmap,
                pool=pub.pool if self.use_pool else None,
                pool_kw=self.pool_kw if self.use_pool else None,
                device=self.device)
        except (FileNotFoundError, CheckpointFormatError, ValueError,
                KeyError, OSError) as e:
            # torn publish / pruned-under-us snapshot: serve on, stay lagged
            self.poll_errors += 1
            self.last_error = repr(e)
            return False
        # --- the swap: only now does the new generation become servable ---
        with self._lock:
            if self.server is None:
                kw = dict(saved_kw)
                kw.update(self.server_kw)
                self.server = ZenServer(index, **kw)
            else:
                self.server.index = index
            old = self._current
            self._current = _PinnedIndex(int(index.generation), index)
            if old is not None:
                self._retired.append(old)
            self._release_idle_locked()
            self.swaps += 1
            frontend = self.server.frontend
        if frontend is not None:
            frontend.on_index_swap(int(index.generation))
        return True

    # -- serving with generation pinning ---------------------------------------
    def query(self, queries, n_neighbors: int = 10, *,
              direct: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Serve one batch, pinning the serving generation while in flight.

        The pin guarantees an index (and the mmap'd snapshot files backing
        it) outlives every query that may read it: a hot-swap during this
        call retires the old generation but cannot release it until the
        pin drops.
        """
        with self._lock:
            if self.server is None or self._current is None:
                raise ReplicaNotReady(
                    f"replica {self.name!r}: no published snapshot swapped "
                    "in yet (poll() after the leader's first publish)")
            pinned = self._current
            pinned.inflight += 1
            server = self.server
        try:
            return server.query(queries, n_neighbors, direct=direct)
        finally:
            with self._lock:
                pinned.inflight -= 1
                self._release_idle_locked()

    def _release_idle_locked(self) -> None:
        """Release retired generations whose last in-flight query resolved."""
        still = []
        for pin in self._retired:
            if pin.inflight == 0:
                self._released.append(pin.generation)
                # drop the device tensors (and any mmap-backed arrays)
                pin.index = None
            else:
                still.append(pin)
        self._retired = still

    # -- observability ---------------------------------------------------------
    def pinned_generations(self) -> Tuple[int, ...]:
        """Generations still alive: the serving one + retired-but-in-flight."""
        with self._lock:
            gens = [] if self._current is None else [self._current.generation]
            gens.extend(pin.generation for pin in self._retired)
            return tuple(sorted(gens))

    def released_generations(self) -> Tuple[int, ...]:
        """Retired generations fully released (no in-flight pins left)."""
        with self._lock:
            return tuple(self._released)

    def stats(self) -> dict:
        out = {
            "name": self.name,
            "generation": self.generation,
            "swaps": self.swaps,
            "poll_errors": self.poll_errors,
            "pinned_generations": list(self.pinned_generations()),
        }
        if self.server is not None:
            out["server"] = self.server.stats()
        return out
