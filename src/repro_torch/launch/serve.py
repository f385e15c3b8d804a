"""nSimplex-Zen retrieval serving, flat and IVF (PyTorch + CUDA).

PyTorch counterpart of ``repro.launch.serve``.

Offline:  ``build_index`` fits the transform on references drawn from the
          corpus (reference pdist -> Gram -> Cholesky) and projects the
          corpus to (N, k) apex coordinates (one batched triangular solve).
          ``index="flat"`` stores them float32, bfloat16 or int8;
          ``index="ivf"`` fits a k-means coarse quantizer and packs them
          into inverted-list tiles (``index.ivf``), stored float32,
          bfloat16, int8 or as PQ codes (``storage="pq"``).
Online:   ``ZenServer.query`` pads the batch to a power-of-two Q bucket,
          projects it and searches: the streaming fused top-k over a flat
          index (the Hopper ``zen_topk`` kernel on the card), or the probe
          of the ``nprobe`` nearest clusters of an IVF index (the Hopper
          ``ivf_probe`` / ``ivf_probe_pq`` kernels); the plain versions on
          the CPU. It then re-ranks the candidate pool exactly and returns
          external ids.
Churn:    ``upsert`` projects new rows with the fitted transform and writes
          them into dead slots or grown capacity; ``delete`` tombstones rows
          (a far sentinel in the flat index, the ``-1`` id in IVF tiles);
          ``compact`` repacks the live rows.
Offload:  ``build_index(index="ivf", offload=True)`` keeps the IVF tile
          pool on the host (``index.ivf.TieredIVFZenIndex``): a hot set of
          clusters stays on the device, and each query batch uploads the
          cold clusters it probes through the Hopper staging kernel
          (``kernels.tile_stage``). The tiered index is serve-only.
Persist:  ``ZenServer.save`` writes the transform, the flat coordinates or
          the IVF members, and the re-rank corpus as one versioned atomic
          snapshot (``checkpoint.index_io``), the JAX package's format;
          ``ZenServer.load`` restores it, optionally serving the IVF tier
          from a tile-pool snapshot (``pool=``, memory-mapped).
Frontend: ``ZenServer(frontend=True)`` attaches the micro-batching
          scheduler (``repro_torch.serving``): many small concurrent callers
          coalesce into one shape-bucketed dispatch per tick, with an LRU
          result cache keyed on the index ``generation`` and reject-on-full
          backpressure. Every row is served with the same bits whatever
          batch it rides in (``core.metrics``' row-invariant forms), so
          scheduled, cached and direct answers are bit-identical.
Mesh:     ``build_index(mesh=)``, ``load_index_snapshot(mesh=)`` and
          ``ZenServer.load(mesh=)`` row-shard the flat coordinates or the
          IVF inverted lists over a ``distributed.mesh.Mesh`` (cards, or
          logical shards of one device); each query runs the search
          kernel once a shard, on the shard's device, and merges the
          candidates on the mesh's first device
          (``distributed.retrieval``). A sharded index is immutable:
          churn a single-device index, save, and reload onto the mesh.
Faults:   ``ZenServer.enable_fault_tolerance`` attaches a heartbeat
          registry and a preemption guard (``distributed.fault``): a shard
          silent past its deadline is masked out of a tiered index's
          probes or a sharded index's merge (degraded answers, not
          errors), and a preemption notice saves a snapshot at the next
          tick. ``launch.replicate`` builds the leader / hot-swapping
          replica tier on the snapshots.

CLI:  python -m repro_torch.launch.serve --n 20000 --dim 256 --k 16 \
          --queries 64 [--index ivf --nprobe 8 [--offload]] \
          [--checkpoint DIR] [--frontend [--max-batch N --cache ROWS]] \
          [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import index_io
from repro_torch.core import metrics as metrics_lib
from repro_torch.core import zen as zen_lib
from repro_torch.core import pivots as pivots_lib
from repro_torch.core.projection import NSimplexTransform
from repro_torch.core.simplex import BaseSimplex
from repro_torch.distributed import retrieval as retrieval_lib
from repro_torch.index.ivf import IVFZenIndex, ShardedIVFZenIndex
from repro_torch.index.ivf import TieredIVFZenIndex, _sharded_from_snapshot
from repro_torch.index.ivf import _check_ids, _dedupe_last_wins, exact_rerank
from repro_torch.index.ivf import _ivf_from_snapshot, snapshot_payload
from repro_torch.kernels import quantize as quant
from repro_torch.kernels.scoring import mask_invalid
from repro_torch.serving import (
    DEFAULT_NEIGHBOR_MENU, MicroBatchScheduler, bucket_neighbors, bucket_q,
)

Tensor = torch.Tensor

#: snapshot kind tag for full serving state (transform + index + corpus)
SERVER_SNAPSHOT_KIND = "zen-server"
#: coordinate sentinel written into tombstoned flat rows — far enough that a
#: dead row can never win a top-k slot, small enough that f32 squared norms
#: stay finite (1e15^2 * k << f32 max)
_DEAD_COORD = 1.0e15
#: flat capacity growth quantum
_GROW_ROWS = 4096


@dataclasses.dataclass
class ZenIndex:
    """Serving-side index: fitted transform + searchable coordinates.

    Attributes:
      transform:  fitted ``NSimplexTransform``.
      coords:     (cap, k) flat apex coordinates in the storage dtype; rows
                  beyond the live set (tombstones, growth slack) hold a far
                  sentinel and never win a search. Row-sharded over
                  ``mesh`` they are ``distributed.retrieval.ShardedRows``,
                  whose ``n_rows`` counts the rows before the shard
                  padding. ``None`` for an IVF index, whose inverted lists
                  are the searchable state.
      corpus:     original vectors for exact re-ranking, row ``i`` holding
                  the vector of external id ``i``; optional.
      n_valid:    number of live rows; ``None`` means every row is live.
      row_ids:    (cap,) int32 external id per row, ``-1`` for dead rows
                  (and for shard padding); ``None`` while ids equal row
                  positions.
      n_deleted:  tombstones since the last build/compact.
      storage:    resident dtype of the searchable state, one of
                  ``kernels.quantize.SCALAR_STORAGE_DTYPES`` (the IVF index
                  also takes "pq").
      coord_scales: (cap, 1) f32 per-row int8 scales, else ``None``.
      generation: churn counter, bumped by every change of the searchable
                  state.
      ivf:        the ``IVFZenIndex`` (or the serve-only
                  ``TieredIVFZenIndex``, or the immutable
                  ``ShardedIVFZenIndex``) when built with ``index="ivf"``;
                  the mutations and the search then go to it.
      mesh:       the ``distributed.mesh.Mesh`` a sharded index (flat or
                  IVF) is spread over, else ``None``.

    Mutations return a new ``ZenIndex`` and leave this one as it was; a
    sharded index refuses them.
    """

    transform: NSimplexTransform
    coords: Optional[Tensor]
    corpus: Optional[Tensor]
    n_valid: Optional[int] = None
    row_ids: Optional[Tensor] = None
    n_deleted: int = 0
    storage: str = "float32"
    coord_scales: Optional[Tensor] = None
    generation: int = 0
    ivf: Optional[object] = None
    mesh: Optional[object] = None

    @property
    def size(self) -> int:
        """Number of live (searchable) rows."""
        if self.ivf is not None:
            return self.ivf.size
        if self.n_valid is not None:
            return self.n_valid
        return self.coords.shape[0]

    @property
    def device(self) -> torch.device:
        return self.ivf.device if self.ivf is not None else self.coords.device

    def to(self, device) -> "ZenIndex":
        """A copy of this index (transform included) with every tensor on
        ``device``. A sharded index moves by reloading its snapshot
        (``load_index_snapshot(mesh=...)``)."""
        if self.mesh is not None:
            raise NotImplementedError(
                "a mesh-sharded index moves by reloading its snapshot onto "
                "another mesh or device (load_index_snapshot(mesh=...))")

        def mv(t):
            return None if t is None else t.to(device)
        tr = self.transform
        if tr is not None:
            base = None if tr.base is None else type(tr.base)(
                *(mv(t) for t in tr.base))
            tr = dataclasses.replace(tr, refs=mv(tr.refs), base=base)
        return dataclasses.replace(
            self, transform=tr, coords=mv(self.coords),
            corpus=mv(self.corpus), row_ids=mv(self.row_ids),
            coord_scales=mv(self.coord_scales),
            ivf=None if self.ivf is None else self.ivf.to(device))

    def _with_ivf(self, new_ivf: IVFZenIndex) -> "ZenIndex":
        if new_ivf is self.ivf:  # nothing changed
            return self
        return dataclasses.replace(self, ivf=new_ivf,
                                   generation=self.generation + 1)

    # -- storage helpers -----------------------------------------------------
    @staticmethod
    def _write_rows(vals: Tensor, scl: Optional[Tensor], where: Tensor,
                    new_f32: Tensor) -> None:
        """Write f32 rows into the storage tensors at ``where`` (in place).

        int8 rows are quantised with their own fresh per-row scales;
        f32/bf16 rows are plain casting assignments. Every other row keeps
        its exact stored bytes.
        """
        if scl is None:
            vals[where] = new_f32.to(vals.dtype)
        else:
            v, s = quant.encode_rows(new_f32, "int8")
            vals[where] = v
            scl[where] = s

    @staticmethod
    def _kill_rows(vals: Tensor, scl: Optional[Tensor], where) -> None:
        """Stamp the far-sentinel dead-row pattern at ``where`` (in place)."""
        if scl is None:
            vals[where] = _DEAD_COORD
        else:  # 127 * (sentinel / 127) dequantises to the exact sentinel
            vals[where] = 127
            scl[where] = _DEAD_COORD / 127.0

    def _cloned_state(self) -> Tuple[Tensor, Optional[Tensor]]:
        scl = None if self.coord_scales is None else self.coord_scales.clone()
        return self.coords.clone(), scl

    def _host_row_ids(self) -> np.ndarray:
        if self.row_ids is None:
            return np.arange(self.coords.shape[0], dtype=np.int64)
        return self.row_ids.cpu().numpy().astype(np.int64)

    def _on_device(self, rows: np.ndarray) -> Tensor:
        return torch.as_tensor(rows, dtype=torch.long, device=self.device)

    def _is_tiered(self) -> bool:
        return isinstance(self.ivf, TieredIVFZenIndex)

    def _check_not_sharded(self) -> None:
        if self.mesh is not None:
            raise NotImplementedError(
                "mutating a mesh-sharded index in place is not supported: "
                "churn the single-host index, save(), and reload onto the "
                "mesh (resharding happens at load)")

    def _check_not_tiered(self) -> None:
        if self._is_tiered():
            raise NotImplementedError(
                "a tiered (host-offloaded) index is serve-only: churn the "
                "resident index and re-offload (build_index(..., "
                "offload=True) or TieredIVFZenIndex.from_index)")

    # -- mutation ------------------------------------------------------------
    def delete(self, ids: Sequence[int]) -> "ZenIndex":
        """Tombstone the given external ids; unknown ids are ignored."""
        self._check_not_sharded()
        if self.ivf is not None:
            self._check_not_tiered()
            return self._with_ivf(self.ivf.delete(ids))
        row_ids = self._host_row_ids()
        mask = (row_ids >= 0) & np.isin(row_ids, np.asarray(ids, np.int64))
        if not mask.any():
            return self
        row_ids[mask] = -1
        coords, scl = self._cloned_state()
        self._kill_rows(coords, scl, self._on_device(np.flatnonzero(mask)))
        n_dead = int(mask.sum())
        return dataclasses.replace(
            self, coords=coords, coord_scales=scl,
            row_ids=self._on_device(row_ids).to(torch.int32),
            n_valid=self.size - n_dead, n_deleted=self.n_deleted + n_dead,
            generation=self.generation + 1)

    def upsert(self, ids: Sequence[int], coords_new: Tensor) -> "ZenIndex":
        """Insert (or replace) projected rows keyed by external id.

        Existing ids are replaced in place; duplicate ids in the batch keep
        the last occurrence. New rows reuse tombstoned slots first; when
        the capacity runs out it grows by multiples of ``_GROW_ROWS`` dead
        rows. An IVF index writes them into its inverted lists.
        """
        self._check_not_sharded()
        if self.ivf is not None:
            self._check_not_tiered()
            return self._with_ivf(self.ivf.upsert(ids, coords_new))
        ids_np = np.asarray(ids, np.int64).ravel()
        _check_ids(ids_np)
        if ids_np.size == 0:
            return self
        new = coords_new.to(device=self.device, dtype=torch.float32)
        new = new.reshape(ids_np.size, -1)
        ids_np, new = _dedupe_last_wins(ids_np, new)

        row_ids = self._host_row_ids()
        coords, scl = self._cloned_state()
        # replace rows whose external id already exists
        sorter = np.argsort(row_ids, kind="stable")
        pos = np.searchsorted(row_ids, ids_np, sorter=sorter)
        pos = np.clip(pos, 0, row_ids.size - 1)
        hit = row_ids[sorter[pos]] == ids_np
        if hit.any():
            self._write_rows(coords, scl, self._on_device(sorter[pos[hit]]),
                             new[self._on_device(np.flatnonzero(hit))])
        miss = np.flatnonzero(~hit)
        ids_np, new = ids_np[miss], new[self._on_device(miss)]
        n_live = self.size + int(ids_np.size)
        reclaimed = 0
        if ids_np.size:
            free = np.flatnonzero(row_ids < 0)[: ids_np.size]
            reclaimed = int(free.size)  # dead slots this batch refills
            if free.size < ids_np.size:  # grow capacity in fixed quanta
                deficit = int(ids_np.size - free.size)
                grow = -(-deficit // _GROW_ROWS) * _GROW_ROWS
                cap = row_ids.size
                row_ids = np.concatenate(
                    [row_ids, np.full(grow, -1, np.int64)])
                coords = torch.cat(
                    [coords, coords.new_empty((grow, coords.shape[1]))])
                if scl is not None:
                    scl = torch.cat([scl, scl.new_empty((grow, 1))])
                self._kill_rows(coords, scl, slice(cap, cap + grow))
                free = np.concatenate([free, cap + np.arange(deficit)])
            row_ids[free] = ids_np
            self._write_rows(coords, scl, self._on_device(free), new)
        return dataclasses.replace(
            self, coords=coords, coord_scales=scl,
            row_ids=self._on_device(row_ids).to(torch.int32),
            n_valid=n_live, n_deleted=max(0, self.n_deleted - reclaimed),
            generation=self.generation + 1)

    def compact(self, **kw) -> "ZenIndex":
        """Repack the live rows, dropping tombstones and growth slack.

        An IVF index forwards to ``IVFZenIndex.compact`` (``recluster=True``
        refits the quantizer). In the flat index per-row scales ride with
        their rows: slicing is the whole repack, with no
        dequantise/requantise cycle.
        """
        self._check_not_sharded()
        if self.ivf is not None:
            self._check_not_tiered()
            return self._with_ivf(self.ivf.compact(**kw))
        if self.row_ids is None:
            return self
        live = self.row_ids >= 0
        return dataclasses.replace(
            self, coords=self.coords[live], row_ids=self.row_ids[live],
            coord_scales=(None if self.coord_scales is None
                          else self.coord_scales[live]),
            n_valid=int(live.sum()), n_deleted=0,
            generation=self.generation + 1)

    def needs_compact(self, max_tombstone_ratio: float = 0.2, **kw) -> bool:
        """True when tombstones exceed ``max_tombstone_ratio`` of the rows
        once live. Growth slack of the flat index is not counted; an IVF
        index also takes the tile-slack and imbalance thresholds of
        ``IVFZenIndex.needs_compact``; a tiered index never does (it is
        serve-only), nor a sharded one (it is immutable)."""
        if self._is_tiered() or self.mesh is not None:
            return False
        if self.ivf is not None:
            return self.ivf.needs_compact(
                max_tombstone_ratio=max_tombstone_ratio, **kw)
        return (self.n_deleted / max(self.size + self.n_deleted, 1)
                > max_tombstone_ratio)


def build_index(
    corpus: Tensor,
    k: int,
    *,
    metric: str = "euclidean",
    index: str = "flat",
    storage: str = "float32",
    pivots: str = "random",
    pivot_ids: Optional[Sequence[int]] = None,
    generator: Optional[torch.Generator] = None,
    keep_corpus: bool = True,
    device=None,
    n_clusters: Optional[int] = None,
    tile_rows: int = 128,
    kmeans_iters: int = 15,
    pq_m: Optional[int] = None,
    mesh=None,
    offload: bool = False,
    hot_clusters: Optional[int] = None,
    offload_shards: int = 1,
    prefetch_cols: int = 2,
) -> ZenIndex:
    """Fit on the corpus and project every row into a flat or IVF index.

    Args:
      corpus:    (N, m) raw vectors; moved to ``device``.
      k:         number of references == projected width.
      index:     "flat" keeps the (N, k) coordinates for the streaming
                 scan; "ivf" fits a k-means coarse quantizer and packs the
                 inverted-list tiles, so a query probes a few clusters.
      storage:   resident dtype of the searchable state: "float32",
                 "bfloat16" (plain cast), "int8" (symmetric scales, per row
                 in the flat index, per cluster in IVF tiles) or "pq" (IVF
                 only: ``pq_m`` uint8 product-quantiser codes per row). Fit
                 and query math stay f32.
      pivots:    base-simplex selection strategy
                 (``core.pivots.PIVOT_STRATEGIES``): the paper's "random"
                 redraw loop, or kmeanspp/farthest_first/maxvol over a
                 witness distance matrix.
      pivot_ids: explicit reference row ids (one fit, no redraw); else
                 ``pivots`` selects them, drawing from ``generator``.
      generator: the reference draws, then the k-means++ (and PQ codebook)
                 draws of an IVF build.
      device:    where the index lives; "cuda" by default, which raises
                 when there is no card.
      n_clusters: IVF cluster count (default ``round(4 * sqrt(N))``).
      tile_rows:  rows per IVF tile.
      kmeans_iters: Lloyd iterations of the IVF quantizer fit.
      pq_m:      PQ subspace count (default ``pq.default_m(k)``).
      mesh:      a ``distributed.mesh.Mesh`` to row-shard the index over
                 (every axis): the flat rows padded once to a multiple of
                 the shard count, or the IVF inverted lists dealt per
                 shard (``ShardedIVFZenIndex``). The index then lives on
                 the mesh's first device (``device`` is not read) and is
                 immutable.
      offload:   (IVF only) drop the packed tiles to a host pool after the
                 build (``index.ivf.TieredIVFZenIndex``): the centroids,
                 scales and the ``hot_clusters`` largest clusters (default
                 10% of C) stay on the device, cold probes are uploaded in
                 ``prefetch_cols``-wide double-buffered chunks, and the
                 clusters are split over ``offload_shards`` logical shards
                 for degraded serving. The offloaded index is serve-only:
                 upsert/delete/compact raise.
    """
    if index not in ("flat", "ivf"):
        raise ValueError(f"index must be 'flat' or 'ivf', got {index!r}")
    if offload and index != "ivf":
        raise ValueError("offload=True requires index='ivf' (the tiered "
                         "tile store offloads inverted-list tiles)")
    if offload and mesh is not None:
        raise ValueError(
            "offload=True and mesh are mutually exclusive: the tiered "
            "store already splits device/host residency on one host; "
            "degraded serving over its logical shards replaces mesh "
            "sharding (offload_shards=...)")
    pivots_lib.check_strategy(pivots)
    quant.check_storage(storage)
    if storage == "pq" and index != "ivf":
        raise ValueError(
            "storage='pq' is IVF-only (codes are per-cluster residuals); "
            "the flat layout takes " + "/".join(quant.SCALAR_STORAGE_DTYPES))
    if storage == "pq" and mesh is not None:
        raise NotImplementedError(
            "storage='pq' is single-host for now; drop the mesh or pick "
            "one of " + "/".join(quant.SCALAR_STORAGE_DTYPES))
    dev = resolve_device(device) if mesh is None else mesh.first_device
    corpus = corpus.to(dev)
    tr = pivots_lib.select_references(corpus, k, ids=pivot_ids,
                                      generator=generator, metric=metric,
                                      strategy=pivots)
    coords = tr.transform(corpus)
    keep = corpus if keep_corpus else None
    if index == "ivf":
        n = coords.shape[0]
        n_clusters = n_clusters or max(1, min(n, int(round(4 * n ** 0.5))))
        if mesh is not None:
            ivf = ShardedIVFZenIndex.build(
                coords, n_clusters, mesh=mesh, tile_rows=tile_rows,
                n_iters=kmeans_iters, generator=generator, storage=storage)
        else:
            ivf = IVFZenIndex.build(
                coords, n_clusters, tile_rows=tile_rows,
                n_iters=kmeans_iters, generator=generator, storage=storage,
                pq_m=pq_m)
        if offload:
            ivf = TieredIVFZenIndex.from_index(
                ivf, hot_clusters=hot_clusters, n_shards=offload_shards,
                prefetch_cols=prefetch_cols)
        return ZenIndex(transform=tr, coords=None, corpus=keep,
                        storage=storage, ivf=ivf, mesh=mesh)
    coords, coord_scales = quant.encode_rows(coords, storage)
    n_valid = None
    if mesh is not None:
        # pad once to a shard-divisible row count so no query batch pays
        # the O(N) re-pad; the search masks rows >= n_rows
        coords, n_valid = retrieval_lib.shard_rows(coords, mesh=mesh)
        if coord_scales is not None:
            coord_scales, _ = retrieval_lib.shard_rows(coord_scales,
                                                       mesh=mesh)
    return ZenIndex(transform=tr, coords=coords, corpus=keep,
                    storage=storage, coord_scales=coord_scales,
                    n_valid=n_valid, mesh=mesh)


def load_index_snapshot(
    directory: str,
    *,
    mesh=None,
    mmap: bool = False,
    pool: Optional[str] = None,
    pool_kw: Optional[dict] = None,
    device=None,
) -> Tuple[ZenIndex, dict]:
    """Load a :meth:`ZenServer.save` snapshot (of either package) into a
    ``ZenIndex`` on ``device`` ("cuda" unless told otherwise).

    Args:
      directory: snapshot directory (``SERVER_SNAPSHOT_KIND``).
      mesh:      a ``distributed.mesh.Mesh`` to reshard onto, whatever
                 shard count saved it: flat rows re-padded and re-sharded
                 (shard padding maps to the dead id -1), IVF members dealt
                 into per-shard inverted lists. The index then lives on
                 the mesh's first device (``device`` is not read).
      mmap:      memory-map the snapshot's arrays read-only instead of
                 reading them; for the tiered ``pool`` the cold tiles are
                 then served straight off the mapped files.
      pool:      optional ``TILE_POOL_SNAPSHOT_KIND`` snapshot directory:
                 the IVF tier is opened as a serve-only
                 ``TieredIVFZenIndex`` over that pool (``load(mmap=...)``)
                 instead of packing resident tiles. IVF snapshots only.
      pool_kw:   extra ``TieredIVFZenIndex.load`` options (``hot_clusters``,
                 ``hot_fraction``, ``prefetch_cols``, ``n_shards``).

    Returns ``(index, server_kw)``: the restored index (with the saved
    ``generation``) and the saved server settings. Raises
    ``checkpoint.CheckpointFormatError`` for a snapshot of an unreadable
    version or another kind.
    """
    if pool is not None and mesh is not None:
        raise ValueError("pool=... and mesh are mutually exclusive (the "
                         "tiered store is single-host)")
    dev = resolve_device(device) if mesh is None else mesh.first_device
    arrays, meta = index_io.load_state(
        directory, expect_kind=SERVER_SNAPSHOT_KIND, mmap=mmap)

    def get(name, **kw):
        return index_io.to_tensor(arrays[name], dev, **kw)

    tr = NSimplexTransform(
        k=int(meta["k"]), metric=meta["metric"],
        jitter=float(meta["jitter"]), refs=get("refs"),
        base=BaseSimplex(chol=get("base_chol"), diag_g=get("base_diag_g"),
                         d0=get("base_d0")))
    corpus = get("corpus") if "corpus" in arrays else None
    generation = int(meta.get("generation", 0))
    storage = meta.get("storage", "float32")
    if pool is not None and meta["index"] != "ivf":
        raise ValueError(
            "pool=... serves the IVF tier from a tile-pool snapshot; this "
            "snapshot holds a flat index")
    if meta["index"] == "ivf":
        if pool is not None:
            ivf = TieredIVFZenIndex.load(pool, mmap=mmap, device=dev,
                                         **dict(pool_kw or {}))
            # the server snapshot's generation is authoritative
            ivf.generation = generation
        elif mesh is not None:
            ivf = _sharded_from_snapshot(arrays, meta, mesh, prefix="ivf_")
        else:
            ivf = _ivf_from_snapshot(arrays, meta, dev, prefix="ivf_")
        index = ZenIndex(transform=tr, coords=None, corpus=corpus,
                         storage=storage, generation=generation, ivf=ivf,
                         mesh=mesh)
    elif mesh is not None:
        coords, n_valid = retrieval_lib.shard_rows(index_io.to_tensor(
            arrays["coords"], "cpu", bfloat16=storage == "bfloat16"),
            mesh=mesh)
        row_ids = get("row_ids").to(torch.int32)
        pad = coords.shape[0] - row_ids.shape[0]
        if pad:  # shard-padding positions map to the dead id
            row_ids = torch.cat([row_ids, row_ids.new_full((pad,), -1)])
        coord_scales = None
        if "coord_scales" in arrays:
            coord_scales, _ = retrieval_lib.shard_rows(
                index_io.to_tensor(arrays["coord_scales"], "cpu"),
                mesh=mesh)
        index = ZenIndex(transform=tr, coords=coords, corpus=corpus,
                         n_valid=n_valid, row_ids=row_ids, storage=storage,
                         coord_scales=coord_scales, generation=generation,
                         mesh=mesh)
    else:
        index = ZenIndex(
            transform=tr,
            coords=get("coords", bfloat16=storage == "bfloat16"),
            corpus=corpus, row_ids=get("row_ids").to(torch.int32),
            storage=storage,
            coord_scales=(get("coord_scales") if "coord_scales" in arrays
                          else None),
            generation=generation)
    return index, dict(meta.get("server", {}))


class ZenServer:
    """Batched k-NN serving over a reduced index, flat or IVF.

    Every query is served at bucketed shapes — rows padded to a power-of-two
    Q bucket (floor 2; past ``max_batch`` to a multiple of it),
    ``n_neighbors`` rounded up to the width menu — and sliced back, as in
    the JAX package. A flat index is searched by the Hopper ``zen_topk``
    kernel on the card; on the CPU ``chunk`` picks the streaming scan
    (index longer than ``chunk``) or the dense path. An IVF index probes
    the ``nprobe`` nearest clusters per query (the recall / latency knob;
    ``nprobe = n_clusters`` gives the flat answer). A row's answer has the
    same bits whatever batch it is served in.

    ``frontend=True`` attaches a ``serving.MicroBatchScheduler``: ``query``
    then submits its rows to the scheduler (coalescing across concurrent
    callers, an LRU result cache of ``cache_size`` rows keyed on the index
    generation, reject-on-full backpressure past ``queue_limit`` rows) and
    waits for the answer; ``query(..., direct=True)`` serves on the calling
    thread. ``clock`` replaces the scheduler's monotonic clock (tests).
    """

    def __init__(self, index: ZenIndex, *, mode: str = "zen",
                 rerank_factor: int = 0, chunk: int = 8192, nprobe: int = 8,
                 frontend: bool = False, max_batch: int = 64,
                 cache_size: int = 0, queue_limit: int = 4096,
                 tick_interval: float = 0.002,
                 neighbor_menu: Sequence[int] = DEFAULT_NEIGHBOR_MENU,
                 clock=None):
        if mode not in zen_lib.MODES:
            raise ValueError(f"mode must be one of {zen_lib.MODES}, got "
                             f"{mode!r}")
        self.index = index
        self.mode = mode
        self.rerank_factor = rerank_factor
        self.chunk = chunk
        self.nprobe = nprobe
        self.neighbor_menu = tuple(neighbor_menu)
        self.max_batch = max_batch
        self.cache_size = cache_size
        self._stats = {"queries": 0, "batches": 0, "latency_s": [],
                       "upserts": 0, "deletes": 0}
        # fault tolerance (enable_fault_tolerance): the liveness registry,
        # the preemption guard, and the degraded state they imply
        self.heartbeats = None
        self.preemption = None
        self._snapshot_dir: Optional[str] = None
        self._ft_shards: Tuple[str, ...] = ()
        self._degraded: Tuple[int, ...] = ()
        # per-shard liveness of a sharded index, None while every shard
        # is alive
        self._alive_mask: Optional[np.ndarray] = None
        self.frontend: Optional[MicroBatchScheduler] = None
        if frontend:
            kw = {"clock": clock} if clock is not None else {}
            self.frontend = MicroBatchScheduler(
                self, max_batch=max_batch, cache_size=cache_size,
                queue_limit=queue_limit, tick_interval=tick_interval,
                neighbor_menu=self.neighbor_menu, **kw)

    # -- bucketed dispatch core ----------------------------------------------
    def _query_geometry(self, n_neighbors: int) -> Tuple[int, int]:
        """(n_bucket, fetch width) a request dispatches at; shared with the
        scheduler, so direct and coalesced dispatches (and their cache
        keys) agree."""
        n_bucket = bucket_neighbors(n_neighbors, self.neighbor_menu)
        width = bucket_neighbors(
            n_neighbors * max(self.rerank_factor, 1), self.neighbor_menu)
        return n_bucket, max(width, n_bucket)

    def _query_block(self, queries: Tensor, width: int, n_bucket: int,
                     index: Optional[ZenIndex] = None
                     ) -> Tuple[Tensor, Tensor]:
        """Serve one padded block: project, search, optional exact re-rank,
        external-id mapping, and the (+inf, -1) fill for slots the index
        cannot serve. Returns (distances, ids), each (Qp, n_bucket).

        The whole block is served from one ``index`` snapshot (the current
        ``self.index`` unless given; the scheduler passes the one it keys
        its cache entries on), so churn swapping the live index cannot mix
        two states within a query. Both the direct path and the scheduler
        dispatch through here."""
        index = index if index is not None else self.index
        if index.size == 0:  # fully deleted index: all slots unfilled
            shape = (queries.shape[0], n_bucket)
            return (torch.full(shape, float("inf"), device=queries.device),
                    torch.full(shape, -1, dtype=torch.int32,
                               device=queries.device))
        qp = index.transform.transform(queries)
        n_fetch = min(width, index.size)
        if index.ivf is not None:  # ids are the global ids of the tiles
            # a sharded IVF takes the alive mask; the tiered store is
            # masked up front instead (set_dead_shards)
            kw = ({"alive": self._alive_mask}
                  if self._alive_mask is not None and index.mesh is not None
                  else {})
            d, ids = index.ivf.search(qp, n_neighbors=n_fetch,
                                      nprobe=self.nprobe, mode=self.mode,
                                      **kw)
        elif index.mesh is not None:
            d, ids = retrieval_lib.sharded_knn_search(
                qp, index.coords, n_neighbors=n_fetch, mode=self.mode,
                mesh=index.mesh, chunk=self.chunk, scales=index.coord_scales,
                alive=self._alive_mask)
            d, ids = self._map_row_ids(d, ids, index)
        else:
            d, ids = zen_lib.knn_search(
                qp, index.coords, n_neighbors=n_fetch, mode=self.mode,
                chunk=self.chunk if index.coords.shape[0] > self.chunk
                else 0, scales=index.coord_scales)
            d, ids = self._map_row_ids(d, ids, index)
        if self.rerank_factor and index.corpus is not None:
            d, ids = exact_rerank(queries, index.corpus, ids, n_bucket,
                                  metric=index.transform.metric)
        else:
            d, ids = d[:, :n_bucket], ids[:, :n_bucket]
        if d.shape[1] < n_bucket:  # fewer live rows than the bucket width
            pad = n_bucket - d.shape[1]
            d = torch.nn.functional.pad(d, (0, pad), value=float("inf"))
            ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
        return d, ids

    def query(self, queries: Tensor, n_neighbors: int = 10, *,
              direct: bool = False) -> Tuple[Tensor, Tensor]:
        """Serve one batch: (Q, m) raw queries -> (distances, ids).

        ``direct`` bypasses the frontend scheduler (when one is attached)
        and serves on the calling thread; the answers are bit-identical
        either way. Returns (distances, ids), each (Q, n_neighbors),
        ascending, on the index's device. Ids are external ids; slots the
        index cannot fill come back as (+inf, -1). The latency recorded in
        ``stats`` waits for the device.
        """
        t0 = time.perf_counter()
        self.on_tick()  # refresh shard liveness / a pending preemption save
        dev = self.index.device
        n_rows = len(queries)
        if (self.frontend is not None and not direct
                and n_rows <= self.frontend.queue_limit):
            # a batch past queue_limit takes the direct path: it is far past
            # any coalescing benefit, and a permanent reject would read as
            # transient overload
            handle = self.frontend.submit(queries, n_neighbors)
            if not self.frontend.running:  # no ticker: drive it inline
                self.frontend.flush()
            d_np, ids_np = handle.result()
            d = torch.from_numpy(d_np).to(dev)
            ids = torch.from_numpy(ids_np).to(dev)
            self._record(n_rows, t0)
            return d, ids
        queries = torch.as_tensor(queries).to(device=dev,
                                              dtype=torch.float32)
        if n_rows == 0:
            d = torch.full((0, n_neighbors), float("inf"), device=dev)
            ids = torch.full((0, n_neighbors), -1, dtype=torch.int32,
                             device=dev)
        else:
            n_bucket, width = self._query_geometry(n_neighbors)
            if n_rows <= self.max_batch:
                qp_rows = bucket_q(n_rows)
            else:  # round up to a multiple of max_batch instead
                qp_rows = -(-n_rows // self.max_batch) * self.max_batch
            if qp_rows > n_rows:  # pad with copies of a real row
                queries = torch.cat([queries, queries[:1].expand(
                    qp_rows - n_rows, -1)])
            d, ids = self._query_block(queries, width, n_bucket)
            d, ids = d[:n_rows, :n_neighbors], ids[:n_rows, :n_neighbors]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self._record(n_rows, t0)
        return d, ids

    def _record(self, n_rows: int, t0: float) -> None:
        self._stats["queries"] += n_rows
        self._stats["batches"] += 1
        self._stats["latency_s"].append(time.perf_counter() - t0)

    @staticmethod
    def _map_row_ids(d: Tensor, ids: Tensor, index: ZenIndex
                     ) -> Tuple[Tensor, Tensor]:
        """Map flat row positions to external ids; a dead id that reaches
        an under-filled result is masked to (+inf, -1)."""
        if index.row_ids is None:
            return d, ids
        ext = index.row_ids[torch.clamp_min(ids, 0).long()]
        ext = torch.where(ids >= 0, ext, torch.full_like(ext, -1))
        return mask_invalid(d, ext), ext

    # -- mutable corpus lifecycle -------------------------------------------
    def upsert(self, ids: Sequence[int], vectors: Tensor) -> None:
        """Project and insert (or replace) raw vectors under external ids.

        The fitted transform projects the batch (no refit); the re-rank
        corpus, indexed densely by external id, grows or is overwritten at
        the same ids.
        """
        ids_np = np.asarray(ids, np.int64).ravel()
        vectors = torch.as_tensor(vectors).to(self.index.device)
        new_index = self.index.upsert(
            ids_np, self.index.transform.transform(vectors))
        corpus = self.index.corpus
        if corpus is not None and ids_np.size:
            hi = int(ids_np.max()) + 1
            if hi > corpus.shape[0]:
                limit = max(2 * corpus.shape[0], corpus.shape[0] + 1_000_000)
                if hi > limit:
                    raise ValueError(
                        f"upsert id {hi - 1} would grow the dense re-rank "
                        f"corpus from {corpus.shape[0]} to {hi} rows; ids "
                        "index the corpus by position — use dense ids or "
                        "drop the corpus (keep_corpus=False)")
                corpus = torch.cat([corpus, corpus.new_zeros(
                    (hi - corpus.shape[0], corpus.shape[1]))])
            else:
                corpus = corpus.clone()
            corpus[torch.as_tensor(ids_np, device=corpus.device)] = \
                vectors.to(corpus.dtype)
            new_index = dataclasses.replace(new_index, corpus=corpus)
        self.index = new_index
        self._stats["upserts"] += int(ids_np.size)

    def delete(self, ids: Sequence[int]) -> None:
        """Tombstone external ids (unknown ids are ignored)."""
        before = self.index.size
        self.index = self.index.delete(ids)
        self._stats["deletes"] += before - self.index.size

    def compact(self, **kw) -> None:
        """Repack the index now (see ``ZenIndex.compact``)."""
        self.index = self.index.compact(**kw)

    def maybe_compact(self, max_tombstone_ratio: float = 0.2,
                      **thresholds) -> bool:
        """Compact iff churn crossed the thresholds; True when it ran.

        When the IVF ``max_imbalance`` threshold is what tripped, the
        compaction refits the quantizer: a plain repack keeps the
        assignments and would trip again on every call.
        """
        if not self.index.needs_compact(max_tombstone_ratio, **thresholds):
            return False
        mi = thresholds.get("max_imbalance")
        ivf = self.index.ivf
        self.compact(**({"recluster": True} if mi is not None and ivf
                        is not None and ivf.imbalance > mi else {}))
        return True

    # -- fault tolerance ------------------------------------------------------
    def _default_shard_count(self) -> int:
        """Logical shard count of the index layout: a tiered index's
        ``n_shards``, a sharded index's mesh size, else 1."""
        if self.index._is_tiered():
            return int(self.index.ivf.n_shards)
        if self.index.mesh is not None:
            return int(self.index.mesh.size)
        return 1

    def enable_fault_tolerance(self, shards=None, *,
                               deadline_s: float = 60.0, clock=None,
                               snapshot_dir: Optional[str] = None,
                               install_signal: bool = False):
        """Attach liveness and preemption handling (``distributed.fault``).

        Args:
          shards:      logical shard names expected to heartbeat: a count
                       (names ``shard0..shardN-1``) or a sequence of names.
                       Defaults to the index's own shards (a tiered index's
                       ``n_shards``, a sharded index's mesh size, else 1).
          deadline_s:  silence longer than this marks a shard dead.
          clock:       monotonic time source (tests inject a fake).
          snapshot_dir: when set, a preemption notice (SIGTERM or
                       ``preemption.request()``) saves a full server
                       snapshot here at the next tick.
          install_signal: install the real SIGTERM handler (off by default).

        Each shard's supervisor then calls :meth:`heartbeat`; every query
        and every frontend tick refreshes the verdicts (:meth:`on_tick`).
        A dead shard's clusters are masked out of a tiered index's probes
        (``TieredIVFZenIndex.set_dead_shards``) and a dead shard of a
        sharded index out of its merge (the ``alive`` mask of
        ``distributed.retrieval``), so queries keep answering
        from the survivors; ``stats()["degraded_shards"]`` reports the
        outage. Returns the registry.
        """
        from repro_torch.distributed.fault import (HeartbeatRegistry,
                                                   PreemptionGuard)

        if shards is None:
            shards = self._default_shard_count()
        if isinstance(shards, int):
            shards = [f"shard{i}" for i in range(shards)]
        self._ft_shards = tuple(str(s) for s in shards)
        kw = {"now": clock} if clock is not None else {}
        self.heartbeats = HeartbeatRegistry(deadline_s=deadline_s, **kw)
        for name in self._ft_shards:
            self.heartbeats.register(name)
        self.preemption = PreemptionGuard(install_signal=install_signal)
        self._snapshot_dir = snapshot_dir
        self._degraded = ()
        self._alive_mask = None
        return self.heartbeats

    def heartbeat(self, shard) -> None:
        """Record a liveness beat for ``shard`` (index or name)."""
        if self.heartbeats is None:
            raise RuntimeError("call enable_fault_tolerance() first")
        name = (self._ft_shards[shard] if isinstance(shard, int)
                else str(shard))
        self.heartbeats.beat(name)

    def on_tick(self) -> None:
        """Refresh the liveness verdicts and run a pending preemption save.

        Called on every query and every frontend tick; a no-op until
        :meth:`enable_fault_tolerance`. The mask changes only when the
        verdict does, so the steady state costs one clock read.
        """
        reg = self.heartbeats
        if reg is not None:
            dead_names = set(reg.dead_hosts())
            dead = tuple(i for i, n in enumerate(self._ft_shards)
                         if n in dead_names)
            if dead != self._degraded:
                self._degraded = dead
                if self.index._is_tiered():
                    self.index.ivf.set_dead_shards(dead)
                elif self.index.mesh is not None:
                    alive = np.ones(len(self._ft_shards), bool)
                    alive[list(dead)] = False
                    self._alive_mask = None if alive.all() else alive
                # any other single-host index has nothing to mask: the
                # registry still tracks external replicas for stats()
        guard = self.preemption
        if (guard is not None and guard.should_save()
                and self._snapshot_dir is not None):
            self.save(self._snapshot_dir)
            guard.clear()

    def stats(self) -> dict:
        """Serving counters: query/batch totals, latency percentiles, churn.

        With fault tolerance, ``"degraded_shards"`` names the dead shards;
        with a frontend, ``"frontend"`` adds its SLO counters (latency
        percentiles, batch occupancy, cache hit rate, dispatch shapes,
        backpressure) and ``"cache"`` the LRU state."""
        lat = np.asarray(self._stats["latency_s"] or [0.0])
        out = {
            "queries": self._stats["queries"],
            "batches": self._stats["batches"],
            "upserts": self._stats["upserts"],
            "deletes": self._stats["deletes"],
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
        }
        if self.heartbeats is not None:
            out["degraded_shards"] = [self._ft_shards[i]
                                      for i in self._degraded]
        if self.index._is_tiered():
            out["tier"] = self.index.ivf.stats()  # hot/cold traffic, bytes
        if self.frontend is not None:
            out["frontend"] = self.frontend.stats.snapshot()
            out["cache"] = self.frontend.cache.info()
        return out

    # -- persistence ---------------------------------------------------------
    def save(self, directory: str) -> str:
        """Persist the full serving state as one versioned atomic snapshot:
        the fitted transform, the flat coordinates (live rows, raw storage
        dtype, their per-row scales) with the external-id map *or* the IVF
        members and quantizer, the re-rank corpus if kept, and the server's
        settings. The files are those the JAX package writes."""
        index = self.index
        tr = index.transform
        if tr.refs is None:
            raise ValueError(
                "distance-only transforms hold no reference coordinates and "
                "cannot serve raw-vector queries after reload; checkpointing "
                "them is unsupported")
        f32 = torch.float32
        arrays = {
            "refs": tr.refs.to(f32),
            "base_chol": tr.base.chol.to(f32),
            "base_diag_g": tr.base.diag_g.to(f32),
            "base_d0": tr.base.d0.to(f32),
        }
        meta = {
            "k": tr.k,
            "metric": tr.metric,
            "jitter": tr.jitter,
            "index": "ivf" if index.ivf is not None else "flat",
            "server": {
                "mode": self.mode,
                "rerank_factor": self.rerank_factor,
                "chunk": self.chunk,
                "nprobe": self.nprobe,
                "frontend": self.frontend is not None,
                "max_batch": self.max_batch,
                "cache_size": self.cache_size,
            },
        }
        if index.ivf is not None:
            ivf_arrays, ivf_meta = snapshot_payload(index.ivf)
            arrays.update({f"ivf_{k}": v for k, v in ivf_arrays.items()})
            meta.update(ivf_meta)
        else:
            # raw storage-dtype rows and their per-row scales: a sharded
            # index gathers its blocks without the shard padding
            coords, scales = index.coords, index.coord_scales
            if index.mesh is not None:
                coords = retrieval_lib.host_rows(coords)
                scales = None if scales is None else \
                    retrieval_lib.host_rows(scales)
            row_ids = index._host_row_ids()[:coords.shape[0]]
            live = row_ids >= 0
            keep = torch.as_tensor(np.flatnonzero(live),
                                   device=coords.device)
            arrays["coords"] = coords[keep]
            arrays["row_ids"] = row_ids[live].astype(np.int32)
            if scales is not None:
                arrays["coord_scales"] = scales[keep].to(f32)
            meta["storage"] = index.storage
        # the wrapper's churn counter is the published generation (set
        # after the IVF meta on purpose, as the reference does)
        meta["generation"] = int(index.generation)
        if index.corpus is not None:
            arrays["corpus"] = index.corpus
        return index_io.save_state(
            directory, arrays, meta, kind=SERVER_SNAPSHOT_KIND)

    @classmethod
    def load(cls, directory: str, *, mesh=None, mmap: bool = False,
             pool: Optional[str] = None, device=None,
             **server_kw) -> "ZenServer":
        """Restore a server from :meth:`save` (or from the JAX package's)
        on ``device``: the same answers as before the save, with the saved
        settings (the frontend's included).

        ``mesh``, ``mmap`` and ``pool`` as in :func:`load_index_snapshot`;
        ``server_kw`` overrides the saved settings (``mode``,
        ``rerank_factor``, ``chunk``, ``nprobe``, ``frontend``,
        ``max_batch``, ``cache_size``, ...).
        """
        index, saved_kw = load_index_snapshot(
            directory, mesh=mesh, mmap=mmap, pool=pool, device=device)
        kw = dict(saved_kw)
        kw.update(server_kw)
        return cls(index, **kw)


def exact_topk(queries: Tensor, corpus: Tensor, n_neighbors: int,
               metric: str = "euclidean") -> Tensor:
    """(Q, n) ids of the exact nearest corpus rows (brute force, stable
    ascending order): the recall yardstick of the CLI and the smoke run."""
    d = metrics_lib.pairwise(metric, queries, corpus)
    return torch.sort(d, dim=1, stable=True).indices[:, :n_neighbors]


def recall(ids: Tensor, true_ids: Tensor) -> float:
    """Mean fraction of each row's true ids found in ``ids``."""
    hits = (ids.long()[:, :, None] == true_ids.long()[:, None, :]).any(-1)
    return float(hits.sum(1).float().mean() / true_ids.shape[1])


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=20000)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--k", type=int, default=16)
    p.add_argument("--queries", type=int, default=64)
    p.add_argument("--batches", type=int, default=4)
    p.add_argument("--neighbors", type=int, default=10)
    p.add_argument("--metric", default="euclidean")
    p.add_argument("--rerank", type=int, default=4)
    p.add_argument("--index", default="flat", choices=["flat", "ivf"])
    p.add_argument("--clusters", type=int, default=0,
                   help="IVF cluster count (0 = ~4*sqrt(N))")
    p.add_argument("--nprobe", type=int, default=8)
    p.add_argument("--storage", default="float32",
                   choices=list(quant.STORAGE_DTYPES),
                   help=quant.storage_help())
    p.add_argument("--pq-m", type=int, default=0,
                   help="PQ subspace count M (storage=pq; 0 = ~k/4)")
    p.add_argument("--pivots", default="random",
                   choices=list(pivots_lib.PIVOT_STRATEGIES),
                   help="base-simplex (reference) selection strategy "
                        "(core.pivots; random = the paper's redraw loop)")
    p.add_argument("--offload", action="store_true",
                   help="host-offload the IVF tile pool (tiered store): "
                        "only centroids + a hot cluster set stay on the "
                        "device, cold probes are uploaded double-buffered")
    p.add_argument("--hot-clusters", type=int, default=0,
                   help="device-resident hot set size (0 = 10%% of C)")
    p.add_argument("--offload-shards", type=int, default=1,
                   help="logical shards for degraded serving (tiered)")
    p.add_argument("--checkpoint", default=None, metavar="DIR",
                   help="restore the server from DIR if a snapshot exists "
                        "there, else build and save one (versioned, atomic)")
    p.add_argument("--frontend", action="store_true",
                   help="serve through the micro-batching frontend "
                        "(coalesced, shape-bucketed dispatches + result "
                        "cache; repro_torch.serving)")
    p.add_argument("--max-batch", type=int, default=64,
                   help="largest coalesced dispatch (frontend mode)")
    p.add_argument("--cache", type=int, default=0, metavar="ROWS",
                   help="LRU result-cache capacity in rows (frontend mode; "
                        "0 disables)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from repro_torch.data import synthetic as syn

    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    frontend_kw = dict(frontend=args.frontend, max_batch=args.max_batch,
                       cache_size=args.cache)
    corpus = syn.manifold_space(args.n, args.dim, args.dim // 8,
                                generator=gen)
    if args.checkpoint and os.path.exists(
            os.path.join(args.checkpoint, "manifest.json")):
        server = ZenServer.load(args.checkpoint, device=dev,
                                rerank_factor=args.rerank, nprobe=args.nprobe,
                                **frontend_kw)
        index = server.index
        ref_dim = int(index.transform.refs.shape[1])
        if ref_dim != args.dim:
            raise SystemExit(
                f"checkpoint {args.checkpoint} serves {ref_dim}-d vectors "
                f"but --dim is {args.dim}; pass --dim {ref_dim}")
        print(f"restored server from {args.checkpoint}")
    else:
        index = build_index(
            corpus, args.k, metric=args.metric, index=args.index,
            storage=args.storage, pivots=args.pivots,
            generator=torch.Generator().manual_seed(args.seed), device=dev,
            n_clusters=args.clusters or None, pq_m=args.pq_m or None,
            offload=args.offload, hot_clusters=args.hot_clusters or None,
            offload_shards=args.offload_shards)
        server = ZenServer(index, rerank_factor=args.rerank,
                           nprobe=args.nprobe, **frontend_kw)
        if args.checkpoint:
            print(f"saved snapshot to {server.save(args.checkpoint)}")
    print(f"index: {index.size} x {args.k} (from dim {args.dim}, "
          f"storage={index.storage}, device={dev})"
          + (f"; ivf: {index.ivf.n_clusters} clusters, T="
             f"{index.ivf.tiles_per_cluster}, nprobe={args.nprobe}"
             if index.ivf is not None else ""))
    recalls = []
    for _ in range(args.batches):
        q = syn.manifold_space(args.queries, args.dim, args.dim // 8,
                               generator=gen)
        _, ids = server.query(q, args.neighbors)
        recalls.append(recall(ids, exact_topk(q, corpus, args.neighbors,
                                              args.metric)))
    print(f"recall@{args.neighbors}: {np.mean(recalls):.3f}")
    print("latency:", server.stats())


if __name__ == "__main__":
    main()
