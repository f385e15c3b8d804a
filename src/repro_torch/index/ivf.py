"""IVFZenIndex — clustered (inverted-file) retrieval over apex coordinates.

PyTorch counterpart of ``repro.index.ivf``. A k-means coarse quantizer
(``index.kmeans``) partitions the (N, k) apex coordinates, and each query
scores only the members of its ``nprobe`` estimator-nearest clusters.
``nprobe = n_clusters`` recovers the flat result.

Padded tile layout: members are sorted by cluster and written into ``T``
fixed ``tile_rows``-row tiles per cluster,

  tile_coords : (C*T, tile_rows, k)   cluster c owns blocks c*T .. c*T+T-1
  tile_ids    : (C*T, tile_rows)      global row ids, -1 marks padding

with ``T`` sized by the largest cluster; under ``storage="pq"`` the tiles
hold (C*T, tile_rows, M) uint8 codes instead. ``search`` probes through
``kernels.ops.ivf_probe`` / ``ivf_probe_pq``: the Hopper kernels for a
CUDA index, their plain versions on the CPU.

Mutable corpus: ``upsert`` assigns new rows to their nearest centroid and
writes them into free slots of that cluster (growing every cluster by whole
tiles when one fills); ``delete`` tombstones rows by rewriting their id to
``-1``, which the probes mask like padding; ``compact`` repacks the live
rows (``recluster=True`` refits the quantizer first). Mutations run on the
index's device and return a new index: the tensors are cloned, then
written in place, and ``self`` is left as it was. The bytes they leave are
the JAX package's.

Snapshots: ``save``/``load`` persist the live members and the quantizer
as canonical host arrays (``checkpoint.index_io``), the same files the JAX
package writes and reads.

``TieredIVFZenIndex`` serves the same tile layout from a host pool: the
centroids, scales and a hot set of clusters stay on the device, and each
search uploads the cold clusters it probes in chunks through the staging
kernel (``kernels.tile_stage``), one chunk's copy on a staging stream while
the chunk before is scored.

``ShardedIVFZenIndex`` row-shards the same layout over a device mesh
(``distributed.mesh``): one global quantizer, each shard holding ~1/S of
every inverted list (dealt round-robin within each cluster), searched by
``distributed.retrieval.sharded_ivf_probe``.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import index_io
from repro_torch.core import metrics as metrics_lib
from repro_torch.core import zen as zen_lib
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import pq as pq_lib
from repro_torch.kernels import quantize as quant
from repro_torch.kernels import scoring
from repro_torch.kernels import tile_stage
from repro_torch.kernels.scoring import MODE_IDS

from .kmeans import kmeans_assign, kmeans_fit

Tensor = torch.Tensor

#: snapshot kind tag of an IVF index (its live members + the quantizer)
IVF_SNAPSHOT_KIND = "ivf-index"
#: snapshot kind tag of a tiered store's packed tile pool itself, so that a
#: memory-mapped load serves straight off the snapshot files
TILE_POOL_SNAPSHOT_KIND = "ivf-tile-pool"


def _check_ids(ids: np.ndarray) -> None:
    """Reject ids the int32 id layout cannot represent (``-1`` is the dead
    slot; an id above int32 max would wrap negative)."""
    if ids.size == 0:
        return
    if ids.min() < 0:
        raise ValueError("ids must be non-negative (-1 marks padding)")
    if ids.max() > np.iinfo(np.int32).max:
        raise ValueError(
            f"ids must fit int32 (max {np.iinfo(np.int32).max}), "
            f"got {ids.max()}")


def _dedupe_last_wins(
    ids: np.ndarray, rows: Tensor
) -> Tuple[np.ndarray, Tensor]:
    """Drop duplicate ids within an upsert batch, keeping the last
    occurrence of each (relative order otherwise preserved)."""
    _, first_of_rev = np.unique(ids[::-1], return_index=True)
    keep = np.sort(ids.size - 1 - first_of_rev)
    return ids[keep], rows[torch.as_tensor(keep, device=rows.device)]


def snapshot_payload(index) -> Tuple[dict, dict]:
    """(arrays, meta) of an IVF index's canonical snapshot: the live members
    in their raw storage dtype (bf16/int8 values, uint8 PQ codes) with the
    quantizer and the decode state (per-cluster scales, PQ codebooks), so a
    load packs them back without a requantise cycle. Shared by
    ``IVFZenIndex.save``, ``ShardedIVFZenIndex.save`` and
    ``launch.serve.ZenServer.save``; takes a resident, a sharded or a
    tiered index. The arrays and meta equal the JAX package's, key for
    key."""
    coords, ids, assign = index._live_members(raw=True)
    arrays = {
        "centroids": index.centroids.to(torch.float32),
        "member_coords": coords,
        "member_ids": ids.to(torch.int32),
        "member_assign": assign.to(torch.int32),
    }
    if index.tile_scales is not None:
        arrays["cluster_scales"] = torch.as_tensor(index.tile_scales,
                                                   dtype=torch.float32)
    if getattr(index, "codebooks", None) is not None:
        arrays["pq_codebooks"] = index.codebooks.to(torch.float32)
    meta = {"n_clusters": index.n_clusters, "tile_rows": index.tile_rows,
            "storage": index.storage,
            "generation": int(getattr(index, "generation", 0))}
    return arrays, meta


def _packed_scales(packed: Tensor) -> Tensor:
    """(C, 1) per-cluster int8 scales of a packed f32 (C, rows, k) layout.

    Equals ``quant.cluster_scales`` over the members (padding rows are zero
    and cannot carry the absmax); stale tombstone coordinates can only keep
    a scale larger than the live rows need, until the next compact.
    """
    return quant.symmetric_scales(
        packed.to(torch.float32).abs().amax(dim=(1, 2)))[:, None]


def _encode_packed(packed: Tensor,
                   storage: str) -> Tuple[Tensor, Optional[Tensor]]:
    """Encode a packed f32 (C, rows, k) layout into a scalar storage dtype:
    ``(values, (C, 1) per-cluster scales or None)``."""
    quant.check_storage(storage)
    packed = packed.to(torch.float32)
    if storage == "float32":
        return packed, None
    if storage == "bfloat16":
        return packed.to(torch.bfloat16), None
    scales = _packed_scales(packed)
    return quant.quantize(packed, scales[:, :, None]), scales


def _coerce_member_storage(
    coords: Tensor,
    assign: Tensor,
    n_clusters: int,
    storage: str,
    scales: Optional[Tensor],
) -> Tuple[Tensor, Optional[Tensor]]:
    """Member coords as restored or fresh -> (storage-dtype values, scales).

    int8 values pass through with their persisted per-cluster ``scales``
    (no dequantise/requantise cycle); f32 input under a narrow ``storage``
    is encoded here, int8 with scales from the global assignment.
    """
    quant.check_storage(storage)
    if storage == "pq":
        raise ValueError("PQ members are packed by IVFZenIndex.from_members")
    if coords.dtype == torch.int8:
        if scales is None:
            raise ValueError("int8 member coords need per-cluster scales")
        return coords, scales.to(torch.float32)
    if storage == "int8":
        scales = quant.cluster_scales(coords, assign, n_clusters)
        return quant.quantize(coords, scales[assign.long()]), scales
    return coords.to(quant.torch_dtype(storage)), None


def _pack_tiles(
    coords: Tensor,
    assign: Tensor,
    ids: Tensor,
    n_clusters: int,
    tile_rows: int,
    *,
    min_tiles: int = 1,
) -> Tuple[Tensor, Tensor, int]:
    """Pack member rows into the padded inverted-list tile layout.

    ``coords`` (n, width) in any storage dtype (packed as they are),
    ``assign`` (n,) cluster ids, ``ids`` (n,) global ids. Members keep
    their order within a cluster (a stable sort by cluster). Returns
    ``(packed (C, T*tile_rows, width), out_ids (C, T*tile_rows) int32 with
    -1 padding, T)``, on the device of ``coords``.
    """
    n, width = coords.shape
    dev = coords.device
    assign = assign.to(device=dev, dtype=torch.long)
    counts = torch.bincount(assign, minlength=n_clusters)
    cmax = int(counts.max()) if n else 0
    per_cluster = max(min_tiles * tile_rows,
                      -(-cmax // tile_rows) * tile_rows)
    out_ids = torch.full((n_clusters, per_cluster), -1, dtype=torch.int32,
                         device=dev)
    packed = torch.zeros((n_clusters, per_cluster, width), dtype=coords.dtype,
                         device=dev)
    if n:
        order = torch.argsort(assign, stable=True)
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.arange(n, device=dev) - torch.repeat_interleave(starts,
                                                                    counts)
        a = assign[order]
        out_ids[a, pos] = ids.to(dev)[order].to(torch.int32)
        packed[a, pos] = coords[order]
    return packed, out_ids, per_cluster // tile_rows


@dataclasses.dataclass
class IVFZenIndex:
    """Clustered Zen index: k-means centroids + padded inverted-list tiles.

    Attributes:
      centroids:   (C, k) f32 coarse-quantizer centroids.
      tile_coords: (C*T, tile_rows, k) packed member coordinates in the
                   ``storage`` dtype, or (C*T, tile_rows, M) uint8 PQ codes.
      tile_ids:    (C*T, tile_rows) int32 global row ids; ``-1`` marks both
                   padding and tombstones.
      n_clusters:  C.
      tiles_per_cluster: T (grows when ``upsert`` fills a list).
      tile_rows:   rows per tile.
      n_valid:     live (searchable) rows.
      n_deleted:   tombstones since the last build/compact.
      storage:     one of ``kernels.quantize.STORAGE_DTYPES``.
      tile_scales: (C, 1) f32 per-cluster int8 scales, else ``None``.
      codebooks:   (M, 256, ds) f32 PQ codebooks under "pq", else ``None``.
      generation:  churn counter, bumped by every change of the searchable
                   state.

    Every tensor lies on one device (``device``); searches and mutations
    run there.
    """

    centroids: Tensor
    tile_coords: Tensor
    tile_ids: Tensor
    n_clusters: int
    tiles_per_cluster: int
    tile_rows: int
    n_valid: int
    n_deleted: int = 0
    storage: str = "float32"
    tile_scales: Optional[Tensor] = None
    codebooks: Optional[Tensor] = None
    generation: int = 0

    @property
    def size(self) -> int:
        return self.n_valid

    @property
    def dim(self) -> int:
        return int(self.centroids.shape[1])

    @property
    def device(self) -> torch.device:
        return self.tile_ids.device

    def to(self, device) -> "IVFZenIndex":
        """A copy of this index with every tensor on ``device``."""
        def mv(t):
            return None if t is None else t.to(device)
        return dataclasses.replace(
            self, centroids=mv(self.centroids),
            tile_coords=mv(self.tile_coords), tile_ids=mv(self.tile_ids),
            tile_scales=mv(self.tile_scales), codebooks=mv(self.codebooks))

    # -- build ---------------------------------------------------------------
    @classmethod
    def build(
        cls,
        coords: Tensor,
        n_clusters: int,
        *,
        ids: Optional[Sequence[int]] = None,
        tile_rows: int = 128,
        n_iters: int = 15,
        chunk: int = 16384,
        generator: Optional[torch.Generator] = None,
        init: Optional[Tensor] = None,
        storage: str = "float32",
        pq_m: Optional[int] = None,
    ) -> "IVFZenIndex":
        """Cluster (N, k) apex coordinates and pack the inverted lists, on
        the device of ``coords``.

        Args:
          n_clusters: requested C (clamped to [1, N]).
          ids:        optional (N,) non-negative global ids (default
                      ``arange(N)``).
          tile_rows:  rows per packed tile.
          n_iters:    Lloyd iterations of the quantizer fit (and of the PQ
                      codebooks).
          chunk:      row chunk of the k-means assignment passes.
          generator:  k-means++ draws (and PQ codebook draws).
          init:       (C, k) initial centroids instead of the seeding.
          storage:    one of ``kernels.quantize.STORAGE_DTYPES``; the fit
                      always runs on the f32 coordinates.
          pq_m:       PQ subspace count M (``pq.default_m(k)`` by default).
        """
        quant.check_storage(storage)
        n, kdim = coords.shape
        n_clusters = max(1, min(n_clusters, n))
        x = coords.to(torch.float32)
        centroids, _ = kmeans_fit(x, n_clusters, generator=generator,
                                  init=init, n_iters=n_iters, chunk=chunk)
        assign = kmeans_assign(x, centroids, chunk=chunk)
        ids_np = (np.arange(n, dtype=np.int64) if ids is None
                  else np.asarray(ids, np.int64).reshape(n))
        _check_ids(ids_np)
        ids_t = torch.as_tensor(ids_np, device=x.device)
        codebooks = scales = None
        if storage == "pq":
            residuals = x - centroids[assign.long()]
            codebooks = pq_lib.train_codebooks(
                residuals, pq_m or pq_lib.default_m(kdim),
                generator=generator, n_iters=n_iters)
            values, out_ids, T = _pack_tiles(
                pq_lib.encode(residuals, codebooks), assign, ids_t,
                n_clusters, tile_rows)
        else:
            packed, out_ids, T = _pack_tiles(x, assign, ids_t, n_clusters,
                                             tile_rows)
            values, scales = _encode_packed(packed, storage)
        return cls(
            centroids=centroids,
            tile_coords=values.reshape(n_clusters * T, tile_rows, -1),
            tile_ids=out_ids.reshape(n_clusters * T, tile_rows),
            n_clusters=n_clusters, tiles_per_cluster=T, tile_rows=tile_rows,
            n_valid=n, storage=storage, tile_scales=scales,
            codebooks=codebooks)

    @classmethod
    def from_members(
        cls,
        coords: Tensor,
        ids: Tensor,
        assign: Tensor,
        centroids: Tensor,
        n_clusters: int,
        tile_rows: int,
        *,
        storage: str = "float32",
        scales: Optional[Tensor] = None,
        codebooks: Optional[Tensor] = None,
        pq_m: Optional[int] = None,
        generation: int = 0,
    ) -> "IVFZenIndex":
        """Pack live members ``(coords (n, k), ids (n,), assign (n,))`` and
        a fitted quantizer into a fresh index, on the device of
        ``centroids``: no tombstones, minimal tiles per cluster.

        ``coords`` already in the storage dtype (int8 with its ``scales``,
        or uint8 PQ codes with their ``codebooks``) are packed as they are;
        f32 ``coords`` under a narrow ``storage`` are encoded here (fresh
        scales; for "pq" fresh codebooks unless given).
        """
        quant.check_storage(storage)
        dev = centroids.device
        coords, ids = coords.to(dev), ids.to(dev)
        assign = assign.to(device=dev, dtype=torch.long)
        if storage == "pq":
            if coords.dtype == torch.uint8:  # codes: pack as they are
                if codebooks is None:
                    raise ValueError(
                        "uint8 PQ member codes need their codebooks")
                values = coords
            else:
                residuals = coords.to(torch.float32) - centroids[assign]
                if codebooks is None:
                    codebooks = pq_lib.train_codebooks(
                        residuals, pq_m or pq_lib.default_m(coords.shape[1]))
                values = pq_lib.encode(residuals, codebooks)
            scales = None
        else:
            values, scales = _coerce_member_storage(
                coords, assign, n_clusters, storage, scales)
            codebooks = None
        packed, out_ids, T = _pack_tiles(values, assign, ids, n_clusters,
                                         tile_rows)
        return cls(
            centroids=centroids.to(torch.float32),
            tile_coords=packed.reshape(n_clusters * T, tile_rows, -1),
            tile_ids=out_ids.reshape(n_clusters * T, tile_rows),
            n_clusters=n_clusters, tiles_per_cluster=T, tile_rows=tile_rows,
            n_valid=int(values.shape[0]), storage=storage,
            tile_scales=None if scales is None else scales.to(dev),
            codebooks=None if codebooks is None else codebooks.to(dev),
            generation=generation)

    # -- persistence ---------------------------------------------------------
    def save(self, directory: str) -> str:
        """Persist the live members and the quantizer as a versioned
        snapshot (atomic publish). Tombstones and grow-by-tile slack are
        dropped: a save is implicitly a repack."""
        return index_io.save_state(
            directory, *snapshot_payload(self), kind=IVF_SNAPSHOT_KIND)

    @classmethod
    def load(cls, directory: str, *, tile_rows: Optional[int] = None,
             device=None) -> "IVFZenIndex":
        """Load a snapshot written by :meth:`save` (or by the JAX package)
        onto ``device`` ("cuda" unless told otherwise). ``tile_rows``
        overrides the stored tile geometry. Raises
        ``checkpoint.CheckpointFormatError`` on a version/kind mismatch."""
        arrays, meta = index_io.load_state(
            directory, expect_kind=IVF_SNAPSHOT_KIND)
        return _ivf_from_snapshot(arrays, meta, resolve_device(device),
                                  tile_rows=tile_rows)

    # -- mutation ------------------------------------------------------------
    def delete(self, ids: Sequence[int]) -> "IVFZenIndex":
        """Tombstone the given global ids (unknown ids are ignored): their
        id slots become ``-1``, the value the probes already mask; the stale
        coordinates stay until ``compact``. Returns a new index."""
        ids_t = torch.as_tensor(np.unique(np.asarray(ids, np.int64).ravel()),
                                device=self.device)
        tids = self.tile_ids
        mask = (tids >= 0) & torch.isin(tids.long(), ids_t)
        removed = int(mask.sum())
        if removed == 0:
            return self
        return dataclasses.replace(
            self, tile_ids=torch.where(mask, -1, tids),
            n_valid=self.n_valid - removed,
            n_deleted=self.n_deleted + removed,
            generation=self.generation + 1)

    def upsert(self, ids: Sequence[int], coords: Tensor) -> "IVFZenIndex":
        """Insert (or replace) rows keyed by global id; returns a new index.

        An id already present is tombstoned first (it may move cluster);
        duplicate ids in the batch keep the last occurrence. Each row goes
        to its nearest centroid (the frozen quantizer) and takes that
        cluster's lowest free slot, rows of one cluster in batch order. When
        a cluster is full every cluster grows by whole tiles. int8 clusters
        that receive rows are dequantised, written and requantised with a
        fresh scale; PQ rows are encoded with the frozen codebooks.
        """
        ids_np = np.asarray(ids, np.int64).ravel()
        _check_ids(ids_np)
        dev = self.device
        x = torch.as_tensor(coords).to(device=dev, dtype=torch.float32)
        x = x.reshape(ids_np.size, self.dim)
        if ids_np.size == 0:
            return self
        ids_np, x = _dedupe_last_wins(ids_np, x)

        base = self.delete(ids_np)  # replaced rows become tombstones
        C, T, rows = self.n_clusters, base.tiles_per_cluster, self.tile_rows
        width = int(base.tile_coords.shape[-1])
        tids = base.tile_ids.reshape(C, T * rows).clone()
        tvals = base.tile_coords.reshape(C, T * rows, width).clone()
        scl = None if base.tile_scales is None else base.tile_scales.clone()

        assign = kmeans_assign(x, self.centroids).long()
        counts = torch.bincount(assign, minlength=C)
        deficit = int((counts - (tids < 0).sum(dim=1)).max())
        if deficit > 0:  # grow-by-tile: append whole empty tiles
            grow = -(-deficit // rows) * rows
            tids = torch.cat([tids, tids.new_full((C, grow), -1)], dim=1)
            tvals = torch.cat([tvals, tvals.new_zeros((C, grow, width))],
                              dim=1)
            T += grow // rows
        # the r-th new row of cluster c (in batch order) takes the r-th
        # free slot of c (ascending)
        order = torch.argsort(assign, stable=True)
        a = assign[order]
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.arange(a.numel(), device=dev) - starts[a]
        free = tids < 0
        free_slot = free.nonzero(as_tuple=True)[1]   # row-major: by cluster
        n_free = free.sum(dim=1)
        slot = free_slot[(torch.cumsum(n_free, 0) - n_free)[a] + rank]
        new_x = x[order]
        tids[a, slot] = torch.as_tensor(ids_np, device=dev)[order].to(
            torch.int32)
        if self.codebooks is not None:
            # residuals against each row's own centroid, frozen codebooks
            tvals[a, slot] = pq_lib.encode(new_x - self.centroids[a],
                                           self.codebooks)
        elif scl is None:  # f32 / bf16: a plain (casting) write
            tvals[a, slot] = new_x.to(tvals.dtype)
        else:
            # int8: dequantise each receiving cluster, write its rows,
            # re-derive its scale from the whole block and requantise (the
            # absmax pinning keeps untouched values when the scale holds)
            touched, inv = torch.unique(a, return_inverse=True)
            blk = quant.dequantize(tvals[touched], scl[touched][:, :, None])
            blk[inv, slot] = new_x
            s = quant.symmetric_scales(blk.abs().amax(dim=(1, 2)))
            scl[touched, 0] = s
            tvals[touched] = quant.quantize(blk, s[:, None, None])
        return dataclasses.replace(
            base,
            tile_coords=tvals.reshape(C * T, rows, width),
            tile_ids=tids.reshape(C * T, rows),
            tiles_per_cluster=T,
            n_valid=base.n_valid + int(ids_np.size),
            # each insert refills a dead slot, reclaiming a tombstone
            n_deleted=max(0, base.n_deleted - int(ids_np.size)),
            tile_scales=scl,
            generation=self.generation + 1)

    @property
    def tombstone_ratio(self) -> float:
        """Fraction of once-live rows that are now tombstones."""
        return self.n_deleted / max(self.n_valid + self.n_deleted, 1)

    def cluster_sizes(self) -> np.ndarray:
        """(C,) live member count per cluster."""
        tids = self.tile_ids.reshape(self.n_clusters, -1)
        return (tids >= 0).sum(dim=1).cpu().numpy()

    @property
    def imbalance(self) -> float:
        """Max/mean live cluster load; 1.0 is perfectly balanced."""
        sizes = self.cluster_sizes()
        mean = float(sizes.mean())
        return float(sizes.max()) / mean if mean > 0 else 0.0

    def _tiles_needed(self) -> int:
        return max(1, -(-int(self.cluster_sizes().max()) // self.tile_rows))

    def needs_compact(
        self,
        *,
        max_tombstone_ratio: float = 0.2,
        max_tile_slack: float = 2.0,
        max_imbalance: Optional[float] = None,
    ) -> bool:
        """True when more than ``max_tombstone_ratio`` of the once-live rows
        are tombstones, when T is at least ``max_tile_slack`` times what the
        largest list needs, or (if given) when :attr:`imbalance` exceeds
        ``max_imbalance`` (that one calls for ``compact(recluster=True)``).
        """
        if self.tombstone_ratio > max_tombstone_ratio:
            return True
        if max_imbalance is not None and self.imbalance > max_imbalance:
            return True
        return self.tiles_per_cluster >= max_tile_slack * self._tiles_needed()

    def compact(
        self,
        *,
        recluster: bool = False,
        n_clusters: Optional[int] = None,
        n_iters: int = 15,
        chunk: int = 16384,
        generator: Optional[torch.Generator] = None,
    ) -> "IVFZenIndex":
        """Repack the live rows into a minimal tile layout; ids are kept.

        Without ``recluster`` the quantizer and assignments stay (a pure
        repack that drops tombstones and grow-by-tile slack). With
        ``recluster=True`` or an explicit ``n_clusters`` the quantizer (and
        under "pq" the codebooks) is refit on the live rows first. With
        nothing to reclaim and no refit asked, returns ``self``.
        """
        if (not recluster and n_clusters is None and self.n_deleted == 0
                and self.tiles_per_cluster == self._tiles_needed()):
            return self
        pq = self.storage == "pq"
        refit = recluster or n_clusters is not None
        # a pure pq repack moves the raw codes; only a refit decodes,
        # because the residual anchors move
        coords, ids, assign = self._live_members(raw=pq and not refit)
        if refit:
            n_clusters = n_clusters or self.n_clusters
            n_clusters = max(1, min(n_clusters, max(len(ids), 1)))
            if len(ids) == 0:
                centroids = self.centroids[:n_clusters]
            else:
                centroids, _ = kmeans_fit(coords, n_clusters,
                                          generator=generator,
                                          n_iters=n_iters, chunk=chunk)
                assign = kmeans_assign(coords, centroids, chunk=chunk)
        else:
            n_clusters, centroids = self.n_clusters, self.centroids
        codebooks = scales = None
        if pq:
            codebooks = self.codebooks
            if refit:
                if len(ids):
                    residuals = coords - centroids[assign.long()]
                    codebooks = pq_lib.train_codebooks(
                        residuals, codebooks.shape[0], generator=generator,
                        n_iters=n_iters)
                    coords = pq_lib.encode(residuals, codebooks)
                else:  # emptied index: keep the old books, pack no codes
                    coords = torch.zeros((0, codebooks.shape[0]),
                                         dtype=torch.uint8,
                                         device=self.device)
            values, out_ids, T = _pack_tiles(coords, assign, ids, n_clusters,
                                             self.tile_rows)
        else:
            packed, out_ids, T = _pack_tiles(coords, assign, ids, n_clusters,
                                             self.tile_rows)
            values, scales = _encode_packed(packed, self.storage)
        return IVFZenIndex(
            centroids=centroids,
            tile_coords=values.reshape(n_clusters * T, self.tile_rows, -1),
            tile_ids=out_ids.reshape(n_clusters * T, self.tile_rows),
            n_clusters=n_clusters, tiles_per_cluster=T,
            tile_rows=self.tile_rows, n_valid=len(ids),
            storage=self.storage, tile_scales=scales, codebooks=codebooks,
            generation=self.generation + 1)

    def _host_tiles_f32(self) -> Tensor:
        """(C*T, rows, k) dequantised (or decoded) f32 copy of the tiles, on
        the index's device. Dead slots hold whatever their bytes decode to;
        callers filter by ``tile_ids >= 0``."""
        vals = self.tile_coords
        if self.codebooks is not None:
            ct = vals.shape[0]
            flat = pq_lib.decode(vals.reshape(ct * self.tile_rows, -1),
                                 self.codebooks, self.dim)
            cents = torch.repeat_interleave(self.centroids,
                                            self.tiles_per_cluster, dim=0)
            return flat.reshape(ct, self.tile_rows, self.dim) + \
                cents[:, None, :]
        if self.tile_scales is not None:
            per_block = torch.repeat_interleave(self.tile_scales[:, 0],
                                                self.tiles_per_cluster)
            return quant.dequantize(vals, per_block[:, None, None])
        return vals.to(torch.float32)

    def _live_members(self, *, raw: bool = False
                      ) -> Tuple[Tensor, Tensor, Tensor]:
        """The live rows as (coords (n, width), ids (n,) int64, assign (n,)
        int64), ordered by cluster then slot; ``raw`` keeps the storage
        dtype, the default dequantises (decodes) to f32."""
        tids = self.tile_ids
        valid = tids >= 0
        block_cluster = torch.arange(tids.shape[0], device=self.device) \
            // self.tiles_per_cluster
        assign = block_cluster[:, None].expand_as(tids)[valid]
        tiles = self.tile_coords if raw else self._host_tiles_f32()
        return tiles[valid], tids[valid].long(), assign

    # -- search --------------------------------------------------------------
    def search(self, queries: Tensor, n_neighbors: int = 10, nprobe: int = 8,
               mode: str = "zen") -> Tuple[Tensor, Tensor]:
        """Probe the ``nprobe`` nearest clusters per query, return best-k.

        Returns (distances, ids), each (Q, n_neighbors), ascending; ids are
        the global ids stored with the rows. Slots the probed clusters
        cannot fill are (+inf, -1); an emptied index keeps the full shape.
        """
        if n_neighbors <= 0:
            raise ValueError(f"n_neighbors must be > 0, got {n_neighbors}")
        if self.n_valid == 0:
            return _empty_result(queries.shape[0], n_neighbors, self.device)
        n_neighbors = min(n_neighbors, self.n_valid)
        nprobe = max(1, min(nprobe, self.n_clusters))
        return _ivf_search(self, queries, n_neighbors=n_neighbors,
                           nprobe=nprobe, mode=mode)

    def probe_clusters(self, queries: Tensor, nprobe: int,
                       mode: str = "zen") -> Tensor:
        """(Q, nprobe) ids of the clusters nearest each query."""
        nprobe = max(1, min(nprobe, self.n_clusters))
        return _probe_clusters(queries, self.centroids, nprobe, mode)


def _ivf_from_snapshot(arrays: dict, meta: dict, dev, *, prefix: str = "",
                       tile_rows: Optional[int] = None) -> IVFZenIndex:
    """Pack the members of a snapshot (``arrays`` keyed ``prefix`` +
    name, as ``snapshot_payload`` wrote them) into an index on ``dev``."""
    storage = meta.get("storage", "float32")

    def get(name, **kw):
        arr = arrays.get(prefix + name)
        return None if arr is None else index_io.to_tensor(arr, dev, **kw)

    return IVFZenIndex.from_members(
        get("member_coords", bfloat16=storage == "bfloat16"),
        get("member_ids").long(), get("member_assign").long(),
        get("centroids"), int(meta["n_clusters"]),
        tile_rows or int(meta["tile_rows"]), storage=storage,
        scales=get("cluster_scales"), codebooks=get("pq_codebooks"),
        generation=int(meta.get("generation", 0)))


def _pack_sharded_tiles(
    coords: Tensor,
    assign,
    ids,
    n_clusters: int,
    n_shards: int,
    tile_rows: int,
) -> Tuple[Tensor, Tensor, int]:
    """Pack members into per-shard inverted lists with a common T, on the
    host.

    Members are dealt round-robin across shards *within each cluster* (a
    stable cluster-then-position sort, strided by shard), so every shard
    holds ~1/S of every inverted list and its T stays ~1/S of the
    unsharded one however the rows are ordered. Each shard then packs with
    :func:`_pack_tiles`, padded to the largest shard's tiles per cluster,
    so the stacked array splits into S equal row blocks. ``coords`` (n,
    width) in any storage dtype. Returns ``(tile_coords (S*C*T, tile_rows,
    width), tile_ids (S*C*T, tile_rows) int32, T)`` as CPU tensors, the
    bytes of the JAX package's ``_pack_sharded_tiles``.
    """
    coords = coords.cpu()
    assign = np.asarray(torch.as_tensor(assign).cpu(), np.int64)
    ids = np.asarray(torch.as_tensor(ids).cpu(), np.int64)
    n = len(ids)
    order = np.argsort(assign, kind="stable") if n else np.zeros(0, np.int64)
    shard_of = np.empty(n, np.int64)
    shard_of[order] = np.arange(n) % n_shards  # round-robin within cluster
    T = max(
        max(1, -(-int(np.bincount(assign[shard_of == s],
                                  minlength=n_clusters).max()
                      if (shard_of == s).any() else 0) // tile_rows))
        for s in range(n_shards))
    packed_s, ids_s = [], []
    for s in range(n_shards):
        sel = np.flatnonzero(shard_of == s)
        sel_t = torch.as_tensor(sel)
        packed, out_ids, _ = _pack_tiles(
            coords[sel_t], torch.as_tensor(assign[sel]),
            torch.as_tensor(ids[sel]), n_clusters, tile_rows, min_tiles=T)
        packed_s.append(packed)
        ids_s.append(out_ids)
    width = coords.shape[1]
    return (torch.stack(packed_s).reshape(n_shards * n_clusters * T,
                                          tile_rows, width),
            torch.stack(ids_s).reshape(n_shards * n_clusters * T, tile_rows),
            T)


_SHARDED_PQ = ("storage='pq' packs uint8 code tiles with their codebooks and "
               "is only supported by the single-host IVFZenIndex "
               "(IVFZenIndex.from_members); sharded/tiered layouts take "
               + "/".join(quant.SCALAR_STORAGE_DTYPES))


@dataclasses.dataclass
class ShardedIVFZenIndex:
    """IVF index row-sharded over a device mesh.

    One global quantizer; each shard packs its own part of every inverted
    list (global ids), padded to a common tiles per cluster, so the tiles
    are S equal row blocks of (C*T, tile_rows, k), block ``s`` on the
    mesh's ``s``-th shard device. A query probes the same clusters on
    every shard (the centroids and scales stay on the mesh's first device
    and are copied to the others a search) and the per-shard candidates
    merge on the first device (``distributed.sharded_ivf_probe``).

    Mutation is a control-plane concern, as in the reference: churn an
    ``IVFZenIndex``, ``save`` it, and :meth:`load` the snapshot onto the
    mesh; a save from S shards reloads onto any other shard count.

    Attributes:
      centroids:   (C, k) f32, on the mesh's first device.
      tile_coords: (S*C*T, tile_rows, k) as ``ShardedRows``, in the
                   ``storage`` dtype.
      tile_ids:    (S*C*T, tile_rows) int32 global ids as ``ShardedRows``;
                   -1 marks padding.
      n_valid:     searchable rows.
      n_shards:    S.
      mesh, axis_names: the mesh and the axes the tiles are sharded over.
      tile_scales: (C, 1) f32 per-cluster int8 scales (from the global
                   assignment), else ``None``.
    """

    centroids: Tensor
    tile_coords: object
    tile_ids: object
    n_clusters: int
    tiles_per_cluster: int
    tile_rows: int
    n_valid: int
    n_shards: int
    mesh: object
    axis_names: Tuple[str, ...]
    storage: str = "float32"
    tile_scales: Optional[Tensor] = None

    @property
    def size(self) -> int:
        return self.n_valid

    @property
    def dim(self) -> int:
        return int(self.centroids.shape[1])

    @property
    def device(self) -> torch.device:
        """The mesh's first device, where answers are merged."""
        return self.centroids.device

    @classmethod
    def build(
        cls,
        coords: Tensor,
        n_clusters: int,
        *,
        mesh,
        axis=None,
        tile_rows: int = 128,
        n_iters: int = 15,
        chunk: int = 16384,
        generator: Optional[torch.Generator] = None,
        storage: str = "float32",
    ) -> "ShardedIVFZenIndex":
        """Fit the global quantizer on the mesh's first device and pack the
        per-shard inverted lists. Arguments as :meth:`IVFZenIndex.build`,
        plus ``mesh`` and ``axis`` (the mesh axes carrying the shards,
        default all); the fit is the one ``IVFZenIndex.build`` makes from
        the same generator on that device."""
        if storage == "pq":
            raise NotImplementedError(_SHARDED_PQ)
        quant.check_storage(storage)
        n = coords.shape[0]
        n_clusters = max(1, min(n_clusters, n))
        x = coords.to(device=mesh.first_device, dtype=torch.float32)
        centroids, _ = kmeans_fit(x, n_clusters, generator=generator,
                                  n_iters=n_iters, chunk=chunk)
        assign = kmeans_assign(x, centroids, chunk=chunk)
        return cls._from_members(
            x, torch.arange(n), assign, centroids, n_clusters, tile_rows,
            mesh=mesh, axis=axis, storage=storage)

    @classmethod
    def _from_members(
        cls,
        coords: Tensor,
        ids,
        assign,
        centroids: Tensor,
        n_clusters: int,
        tile_rows: int,
        *,
        mesh,
        axis=None,
        storage: str = "float32",
        scales: Optional[Tensor] = None,
    ) -> "ShardedIVFZenIndex":
        from repro_torch.distributed import retrieval as retrieval_lib

        if storage == "pq":
            raise NotImplementedError(_SHARDED_PQ)
        # quantise *before* the shard split, with per-cluster scales from
        # the global assignment: the stored bytes are then independent of
        # the shard count, so a snapshot reloads bit-identically onto any
        # mesh
        assign = torch.as_tensor(assign).to(device=coords.device,
                                            dtype=torch.long)
        coords, scales = _coerce_member_storage(coords, assign, n_clusters,
                                                storage, scales)
        names = retrieval_lib.resolve_axis_names(mesh, axis)
        n_shards = len(mesh.shard_devices(names))
        tiles, tids, T = _pack_sharded_tiles(coords, assign, ids, n_clusters,
                                             n_shards, tile_rows)
        home = mesh.first_device
        return cls(
            centroids=centroids.to(device=home, dtype=torch.float32),
            tile_coords=retrieval_lib.shard_rows(tiles, mesh=mesh,
                                                 axis=names)[0],
            tile_ids=retrieval_lib.shard_rows(tids, mesh=mesh,
                                              axis=names)[0],
            n_clusters=n_clusters, tiles_per_cluster=T, tile_rows=tile_rows,
            n_valid=len(ids), n_shards=n_shards, mesh=mesh, axis_names=names,
            storage=storage,
            tile_scales=None if scales is None else scales.to(home))

    # -- persistence ---------------------------------------------------------
    def _live_members(self, *, raw: bool = False
                      ) -> Tuple[Tensor, Tensor, Tensor]:
        """Every shard's live rows gathered to the host as (coords, ids
        int64, assign int64), shard by shard, then by cluster and slot;
        ``raw`` keeps the storage dtype, the default dequantises to f32."""
        from repro_torch.distributed.retrieval import host_rows

        tids = host_rows(self.tile_ids)
        valid = tids >= 0
        ct = self.n_clusters * self.tiles_per_cluster
        block_cluster = (torch.arange(tids.shape[0]) % ct) \
            // self.tiles_per_cluster
        assign = block_cluster[:, None].expand_as(tids)[valid]
        tiles = host_rows(self.tile_coords)
        if not raw:
            if self.tile_scales is not None:
                per_block = self.tile_scales.cpu()[:, 0][block_cluster]
                tiles = quant.dequantize(tiles, per_block[:, None, None])
            else:
                tiles = tiles.to(torch.float32)
        return tiles[valid], tids[valid].long(), assign

    def save(self, directory: str) -> str:
        """Gather every shard's live rows and write the same canonical
        snapshot as ``IVFZenIndex.save``: the shard count is a load-time
        choice, not part of the files."""
        return index_io.save_state(
            directory, *snapshot_payload(self), kind=IVF_SNAPSHOT_KIND)

    @classmethod
    def load(cls, directory: str, *, mesh, axis=None,
             tile_rows: Optional[int] = None) -> "ShardedIVFZenIndex":
        """Load an IVF snapshot (of either package, from any shard count)
        and reshard it onto ``mesh``: the members are dealt into per-shard
        inverted lists here."""
        arrays, meta = index_io.load_state(
            directory, expect_kind=IVF_SNAPSHOT_KIND)
        return _sharded_from_snapshot(arrays, meta, mesh, axis=axis,
                                      tile_rows=tile_rows)

    def search(self, queries: Tensor, n_neighbors: int = 10, nprobe: int = 8,
               mode: str = "zen", *, alive=None) -> Tuple[Tensor, Tensor]:
        """Probe the ``nprobe`` nearest clusters on every shard and merge
        (global ids, on the mesh's first device). ``alive`` is an optional
        (n_shards,) bool mask: a False shard is dropped from the merge
        (degraded serving)."""
        from repro_torch.distributed import retrieval as retrieval_lib

        if n_neighbors <= 0:
            raise ValueError(f"n_neighbors must be > 0, got {n_neighbors}")
        if self.n_valid == 0:
            return _empty_result(queries.shape[0], n_neighbors, self.device)
        n_neighbors = min(n_neighbors, self.n_valid)
        nprobe = max(1, min(nprobe, self.n_clusters))
        queries = queries.to(device=self.device, dtype=torch.float32)
        probes = _probe_clusters(queries, self.centroids, nprobe, mode)
        return retrieval_lib.sharded_ivf_probe(
            queries, self.tile_coords, self.tile_ids, probes, n_neighbors,
            mode, mesh=self.mesh, axis=self.axis_names,
            tiles_per_cluster=self.tiles_per_cluster,
            tile_scales=self.tile_scales, alive=alive)


def _sharded_from_snapshot(arrays: dict, meta: dict, mesh, *,
                           prefix: str = "", axis=None,
                           tile_rows: Optional[int] = None
                           ) -> ShardedIVFZenIndex:
    """Deal the members of a snapshot (``arrays`` keyed ``prefix`` + name)
    onto ``mesh``; the members are read on the host."""
    storage = meta.get("storage", "float32")
    scales = arrays.get(prefix + "cluster_scales")
    return ShardedIVFZenIndex._from_members(
        index_io.to_tensor(arrays[prefix + "member_coords"], "cpu",
                           bfloat16=storage == "bfloat16"),
        np.asarray(arrays[prefix + "member_ids"], np.int64),
        np.asarray(arrays[prefix + "member_assign"], np.int64),
        index_io.to_tensor(arrays[prefix + "centroids"], mesh.first_device),
        int(meta["n_clusters"]), tile_rows or int(meta["tile_rows"]),
        mesh=mesh, axis=axis, storage=storage,
        scales=None if scales is None else index_io.to_tensor(scales, "cpu"))


@dataclasses.dataclass
class _StagingSlot:
    """One pair of host staging buffers (pinned for a CUDA store) and the
    event recorded after the last copy out of them."""

    coords: Tensor
    ids: Tensor
    copied: Optional["torch.cuda.Event"] = None


def _nbytes(t: Optional[Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


class TieredIVFZenIndex:
    """Serve-only IVF index whose inverted lists live in a host pool.

    The same (C*T, tile_rows, k) layout as ``IVFZenIndex``, split:

      * **on the device**: the centroids, a *hot set* of clusters (plus one
        always-empty dummy cluster that absorbs probe slots pointing at
        cold or dead clusters) and its per-cluster scales;
      * **on the host**: the whole tile pool as numpy (bf16 as uint16
        bits), optionally a read-only memmap of a
        :data:`TILE_POOL_SNAPSHOT_KIND` snapshot (:meth:`load`), so cold
        tiles are paged straight off disk.

    A search runs the coarse probe, answers the hot part of every probe
    list from the hot set, and walks the cold probe columns in
    ``prefetch_cols``-wide chunks. Each chunk's cold clusters are gathered
    on the host into one of two staging buffers (pinned for a CUDA store,
    allocated once for the batch shape) and uploaded by the staging kernel
    (``kernels.tile_stage``) on a staging stream; chunk ``j+1``'s upload is
    issued before chunk ``j`` is scored, and the probe waits on the
    upload's event. Upload buffers are bucketed to power-of-two cluster
    counts, as in the JAX package (which bounds its recompiles), so the
    byte counters equal the reference's.

    Results equal ``IVFZenIndex.search`` at equal ``nprobe`` up to the order
    of exactly tied distances: the same probe scores the same tiles, only
    partitioned into passes merged by ``scoring.merge_topk``.

    Clusters are partitioned over ``n_shards`` logical shards (cluster
    ``c`` on shard ``c % n_shards``); :meth:`set_dead_shards` masks a dead
    shard's clusters out of both passes (degraded serving).

    A search reuses the staging slots and stream and updates the traffic
    and hot-set counters, so concurrent searches (a frontend's ticker
    thread beside ``query(direct=True)`` callers) take turns on a lock.

    The tier is immutable serving state: churn the resident index and
    offload again (:meth:`from_index`). It serves from the device of
    ``centroids``. The reference's ``force_stage_kernel`` option (run the
    Pallas copy in interpret mode off the TPU) has no counterpart: the
    device decides, and a CUDA store always runs the staging kernel.
    """

    def __init__(
        self,
        centroids: Tensor,
        host_coords: np.ndarray,
        host_ids: np.ndarray,
        *,
        n_clusters: int,
        tiles_per_cluster: int,
        tile_rows: int,
        n_valid: int,
        storage: str = "float32",
        host_scales: Optional[np.ndarray] = None,
        hot_clusters: Optional[np.ndarray] = None,
        prefetch_cols: int = 2,
        n_shards: int = 1,
        generation: int = 0,
    ):
        ct = n_clusters * tiles_per_cluster
        if storage not in quant.SCALAR_STORAGE_DTYPES:
            raise ValueError(f"the tiered store takes storage in "
                             f"{quant.SCALAR_STORAGE_DTYPES}, got {storage!r}")
        if storage == "bfloat16":
            host_coords = host_coords.view(np.uint16)
        if host_coords.shape[:2] != (ct, tile_rows) or \
                host_ids.shape != (ct, tile_rows):
            raise ValueError(f"host tiles {host_coords.shape} / ids "
                             f"{host_ids.shape} do not match (C*T, rows) = "
                             f"({ct}, {tile_rows})")
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.centroids = centroids.to(torch.float32)
        self.host_coords = host_coords
        self.host_ids = host_ids
        self.host_scales = (None if host_scales is None
                            else np.asarray(host_scales, np.float32))
        self.n_clusters = n_clusters
        self.tiles_per_cluster = tiles_per_cluster
        self.tile_rows = tile_rows
        self.n_valid = n_valid
        self.n_deleted = 0
        self.storage = storage
        self.prefetch_cols = max(1, prefetch_cols)
        self.n_shards = n_shards
        self.generation = generation
        self.dead_shards: list = []
        self._dead_cluster = np.zeros(n_clusters, bool)
        self._traffic = np.zeros(n_clusters, np.int64)
        self._hot_hits = 0
        self._cold_uploads = 0
        self._bytes_uploaded = 0
        self._max_chunk_bytes = 0
        self._slots: list = []
        self._next_slot = 0
        self._stream = None
        self._search_lock = threading.Lock()
        if hot_clusters is None:
            hot_clusters = np.empty(0, np.int64)
        self._set_hot(np.asarray(hot_clusters, np.int64))

    # -- construction --------------------------------------------------------
    @classmethod
    def from_index(
        cls,
        index: IVFZenIndex,
        *,
        hot_clusters: Optional[int] = None,
        hot_fraction: float = 0.1,
        prefetch_cols: int = 2,
        n_shards: int = 1,
    ) -> "TieredIVFZenIndex":
        """Offload a resident index to the host, keeping a hot set on its
        device: the ``hot_clusters`` (default ``hot_fraction`` of C)
        largest clusters by live members; :meth:`refresh_hot` re-picks by
        observed probe traffic. Raises ``NotImplementedError`` for PQ
        storage, whose probe scores codes, not coordinates."""
        if index.storage == "pq":
            raise NotImplementedError(
                "tiered offload does not support storage='pq' (its probe "
                "scores coordinates, not codes); compact to one of "
                + "/".join(quant.SCALAR_STORAGE_DTYPES) + " first")
        C = index.n_clusters
        sizes = index.cluster_sizes()
        H = (max(0, min(int(hot_clusters), C)) if hot_clusters is not None
             else max(1, int(C * hot_fraction)))
        hot = np.sort(np.argsort(sizes, kind="stable")[::-1][:H])
        return cls(
            index.centroids,
            index_io.to_numpy(index.tile_coords),
            index_io.to_numpy(index.tile_ids.to(torch.int32)),
            n_clusters=C,
            tiles_per_cluster=index.tiles_per_cluster,
            tile_rows=index.tile_rows,
            n_valid=index.n_valid,
            storage=index.storage,
            host_scales=(None if index.tile_scales is None
                         else index.tile_scales.cpu().numpy()),
            hot_clusters=hot,
            prefetch_cols=prefetch_cols,
            n_shards=n_shards,
            generation=index.generation,
        )

    def to(self, device) -> "TieredIVFZenIndex":
        """The same host pool served from ``device`` (hot set re-staged,
        dead shards kept, counters fresh)."""
        out = TieredIVFZenIndex(
            self.centroids.to(device), self.host_coords, self.host_ids,
            n_clusters=self.n_clusters,
            tiles_per_cluster=self.tiles_per_cluster,
            tile_rows=self.tile_rows, n_valid=self.n_valid,
            storage=self.storage, host_scales=self.host_scales,
            hot_clusters=self.hot_clusters, prefetch_cols=self.prefetch_cols,
            n_shards=self.n_shards, generation=self.generation)
        out.set_dead_shards(self.dead_shards)
        return out

    @property
    def size(self) -> int:
        return self.n_valid

    @property
    def dim(self) -> int:
        return int(self.centroids.shape[1])

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    @property
    def tile_scales(self) -> Optional[np.ndarray]:
        """Host view of the per-cluster scales (snapshot-payload
        contract)."""
        return self.host_scales

    def _device_tiles(self, t: Tensor) -> Tensor:
        """Staged tiles as the probe reads them (bf16 from its bits)."""
        return t.view(torch.bfloat16) if self.storage == "bfloat16" else t

    # -- hot set -------------------------------------------------------------
    def _set_hot(self, hot: np.ndarray) -> None:
        """(Re)upload the hot cluster set + the trailing dummy cluster."""
        C, T, rows = self.n_clusters, self.tiles_per_cluster, self.tile_rows
        kdim = self.host_coords.shape[2]
        self.hot_clusters = np.sort(hot.astype(np.int64))
        H = self.hot_clusters.size
        blocks = (self.hot_clusters[:, None] * T + np.arange(T)).reshape(-1)
        coords = np.zeros(((H + 1) * T, rows, kdim), self.host_coords.dtype)
        ids = np.full(((H + 1) * T, rows), -1, np.int32)
        if H:
            coords[:H * T] = self.host_coords[blocks]
            ids[:H * T] = self.host_ids[blocks]
        self._hot_coords = self._device_tiles(
            tile_stage.stage_blocks(coords, self.device))
        self._hot_ids = tile_stage.stage_blocks(ids, self.device)
        if self.host_scales is None:
            self._hot_scales = None
        else:
            hs = np.ones((H + 1, 1), np.float32)
            if H:
                hs[:H] = self.host_scales[self.hot_clusters]
            self._hot_scales = torch.from_numpy(hs).to(self.device)
        base = np.full(C, H, np.int32)  # cold clusters -> the dummy slot
        base[self.hot_clusters] = np.arange(H, dtype=np.int32)
        self._base_slot = base
        self._refresh_slot()

    def _refresh_slot(self) -> None:
        dummy = np.int32(self.hot_clusters.size)
        self._hot_slot = np.where(self._dead_cluster, dummy, self._base_slot)

    def refresh_hot(self, hot_clusters: Optional[int] = None) -> None:
        """Re-pick the hot set from observed probe traffic and re-upload."""
        H = (self.hot_clusters.size if hot_clusters is None
             else max(0, min(int(hot_clusters), self.n_clusters)))
        with self._search_lock:  # not under a search
            order = np.argsort(self._traffic, kind="stable")[::-1]
            self._set_hot(np.sort(order[:H]))

    # -- degraded serving ----------------------------------------------------
    def shard_of_cluster(self) -> np.ndarray:
        """(C,) logical shard owning each cluster."""
        return np.arange(self.n_clusters) % self.n_shards

    def set_dead_shards(self, shards) -> None:
        """Mask the given logical shards' clusters out of every probe."""
        dead = sorted({int(s) for s in shards})
        for s in dead:
            if not 0 <= s < self.n_shards:
                raise ValueError(
                    f"shard {s} out of range for n_shards={self.n_shards}")
        with self._search_lock:  # never between a search's two passes
            self.dead_shards = dead
            self._dead_cluster = np.isin(self.shard_of_cluster(), dead)
            self._refresh_slot()

    # -- memory accounting ---------------------------------------------------
    def _resident_bytes(self) -> int:
        return (_nbytes(self.centroids) + _nbytes(self._hot_coords)
                + _nbytes(self._hot_ids) + _nbytes(self._hot_scales))

    def _worst_slots(self, n_queries: int) -> int:
        """The largest slot bucket ``_stage_chunk`` can use for a batch of
        ``n_queries`` rows."""
        worst_uniq = min(int(n_queries) * self.prefetch_cols, self.n_clusters)
        n_slots = min(1 << worst_uniq.bit_length(), self.n_clusters + 1)
        return max(n_slots, worst_uniq + 1)

    def device_bytes(self) -> int:
        """Device-resident footprint: centroids + hot set + the (double-
        buffered) peak cold upload so far."""
        return self._resident_bytes() + 2 * self._max_chunk_bytes

    def provisioned_device_bytes(self, n_queries: int) -> int:
        """Worst-case device high-water mark for ``n_queries``-row batches:
        the resident arrays plus both uploads at the largest slot bucket
        that batch shape can use, whatever clusters the traffic touches."""
        n_slots = self._worst_slots(n_queries)
        T, rows = self.tiles_per_cluster, self.tile_rows
        kdim = self.host_coords.shape[2]
        per_slot = T * rows * (kdim * self.host_coords.dtype.itemsize + 4)
        chunk = n_slots * per_slot
        if self.host_scales is not None:
            chunk += n_slots * 4
        return self._resident_bytes() + 2 * chunk

    def host_bytes(self) -> int:
        out = self.host_coords.nbytes + self.host_ids.nbytes
        if self.host_scales is not None:
            out += self.host_scales.nbytes
        return out

    def stats(self) -> dict:
        return {
            "hot_clusters": int(self.hot_clusters.size),
            "hot_hits": int(self._hot_hits),
            "cold_uploads": int(self._cold_uploads),
            "bytes_uploaded": int(self._bytes_uploaded),
            "device_bytes": self.device_bytes(),
            "host_bytes": self.host_bytes(),
            "dead_shards": list(self.dead_shards),
            "masked_clusters": int(self._dead_cluster.sum()),
        }

    # -- staging -------------------------------------------------------------
    def _reserve_slots(self, n_queries: int) -> None:
        """Make both staging buffers hold the worst chunk of an
        ``n_queries``-row batch (allocated once per larger batch shape)."""
        blocks = self._worst_slots(n_queries) * self.tiles_per_cluster
        if self._slots and self._slots[0].coords.shape[0] >= blocks:
            return
        for s in self._slots:  # an old buffer may still feed a copy
            if s.copied is not None:
                s.copied.synchronize()
        pin = self.device.type == "cuda"
        dtype = torch.from_numpy(np.empty(0, self.host_coords.dtype)).dtype
        shape = (blocks, self.tile_rows)
        self._slots = [_StagingSlot(
            torch.empty(shape + (self.host_coords.shape[2],), dtype=dtype,
                        pin_memory=pin),
            torch.empty(shape, dtype=torch.int32, pin_memory=pin))
            for _ in range(2)]

    def _upload(self, slot: _StagingSlot, n_blocks: int):
        """Issue the copy of a filled slot's first ``n_blocks`` blocks:
        ``(coords, ids, ready event or None)``. On the card the copy runs
        on the staging stream; its outputs are marked in use by the current
        stream, which must wait on ``ready`` before reading them."""
        coords, ids = slot.coords[:n_blocks], slot.ids[:n_blocks]
        if self.device.type != "cuda":
            return (self._device_tiles(tile_stage.stage_blocks(
                coords, self.device)),
                tile_stage.stage_blocks(ids, self.device), None)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            up_coords = tile_stage.stage_blocks(coords, self.device)
            up_ids = tile_stage.stage_blocks(ids, self.device)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        cur = torch.cuda.current_stream(self.device)
        up_coords.record_stream(cur)
        up_ids.record_stream(cur)
        slot.copied = ready
        return self._device_tiles(up_coords), up_ids, ready

    def _stage_chunk(self, sub: np.ndarray, subcold: np.ndarray):
        """Gather and launch the upload for one cold probe-column chunk.

        Returns ``(coords, ids, scales, remapped_probes, ready)`` (the copy
        in flight), or None when the chunk has no cold cluster.
        ``sub``/``subcold``: (Q, w) probe ids and their cold-and-alive
        mask.
        """
        uniq = np.unique(sub[subcold])
        if uniq.size == 0:
            return None
        T = self.tiles_per_cluster
        # power-of-two slot bucket (incl. the dummy), as the reference
        n_slots = min(1 << int(uniq.size).bit_length(), self.n_clusters + 1)
        n_slots = max(n_slots, uniq.size + 1)
        slot_of = np.full(self.n_clusters, n_slots - 1, np.int32)
        slot_of[uniq] = np.arange(uniq.size, dtype=np.int32)
        remapped = np.where(subcold, slot_of[sub], n_slots - 1).astype(
            np.int32)
        blocks = (uniq[:, None] * T + np.arange(T)).reshape(-1)
        n_blocks, used = n_slots * T, uniq.size * T
        slot = self._slots[self._next_slot]
        self._next_slot ^= 1
        if slot.copied is not None:  # its last copy has read the host bytes
            slot.copied.synchronize()
        coords = slot.coords[:n_blocks].numpy()
        ids = slot.ids[:n_blocks].numpy()
        np.take(self.host_coords, blocks, axis=0, out=coords[:used],
                mode="clip")
        np.take(self.host_ids, blocks, axis=0, out=ids[:used], mode="clip")
        coords[used:] = 0
        ids[used:] = -1
        scales = None
        if self.host_scales is not None:
            hs = np.ones((n_slots, 1), np.float32)
            hs[:uniq.size] = self.host_scales[uniq]
            scales = torch.from_numpy(hs).to(self.device)
        up_bytes = coords.nbytes + ids.nbytes
        self._cold_uploads += 1
        self._bytes_uploaded += up_bytes
        self._max_chunk_bytes = max(self._max_chunk_bytes, up_bytes)
        up_coords, up_ids, ready = self._upload(slot, n_blocks)
        return (up_coords, up_ids, scales,
                torch.from_numpy(remapped).to(self.device), ready)

    # -- search --------------------------------------------------------------
    def search(self, queries: Tensor, n_neighbors: int = 10, nprobe: int = 8,
               mode: str = "zen") -> Tuple[Tensor, Tensor]:
        """Hot-set probe + double-buffered cold-chunk probes, merged.

        Same contract as ``IVFZenIndex.search``; dead shards' clusters are
        skipped (degraded mode), which lowers recall but never raises.
        Concurrent callers are served one at a time.
        """
        with self._search_lock:
            return self._search(queries, n_neighbors, nprobe, mode)

    def _search(self, queries: Tensor, n_neighbors: int, nprobe: int,
                mode: str) -> Tuple[Tensor, Tensor]:
        if n_neighbors <= 0:
            raise ValueError(f"n_neighbors must be > 0, got {n_neighbors}")
        dev = self.device
        if self.n_valid == 0:
            return _empty_result(queries.shape[0], n_neighbors, dev)
        n_neighbors = min(n_neighbors, self.n_valid)
        nprobe = max(1, min(nprobe, self.n_clusters))
        T = self.tiles_per_cluster
        queries = queries.to(device=dev, dtype=torch.float32)
        probes = _probe_clusters(queries, self.centroids, nprobe,
                                 mode).cpu().numpy().astype(np.int64)
        np.add.at(self._traffic, probes.reshape(-1), 1)

        # hot pass: the full probe list with cold/dead entries remapped to
        # the dummy slot answers everything the hot set can
        hot_pr = self._hot_slot[probes]
        H = self.hot_clusters.size
        self._hot_hits += int((hot_pr < H).sum())
        best_d, best_i = kernel_ops.ivf_probe(
            queries, self._hot_coords, self._hot_ids,
            torch.from_numpy(hot_pr).to(dev), n_neighbors, mode,
            tiles_per_cluster=T, tile_scales=self._hot_scales)

        # cold passes: probe columns in fixed-width chunks; the upload for
        # chunk j+1 is in flight while chunk j is scored
        cold = (~self._dead_cluster & (self._base_slot == H))[probes]
        self._reserve_slots(queries.shape[0])
        w = self.prefetch_cols
        spans = [(lo, min(lo + w, nprobe)) for lo in range(0, nprobe, w)]
        staged = self._stage_chunk(probes[:, :spans[0][1]],
                                   cold[:, :spans[0][1]])
        for j in range(len(spans)):
            cur, staged = staged, None
            if j + 1 < len(spans):
                lo, hi = spans[j + 1]
                staged = self._stage_chunk(probes[:, lo:hi], cold[:, lo:hi])
            if cur is None:
                continue
            up_coords, up_ids, up_scales, remapped, ready = cur
            if ready is not None:
                torch.cuda.current_stream(dev).wait_event(ready)
            d, i = kernel_ops.ivf_probe(
                queries, up_coords, up_ids, remapped, n_neighbors, mode,
                tiles_per_cluster=T, tile_scales=up_scales)
            best_d, best_i = scoring.merge_topk(best_d, best_i, d, i,
                                                n_neighbors)
        return best_d, best_i

    # -- persistence ---------------------------------------------------------
    def _live_members(self, *, raw: bool = False
                      ) -> Tuple[Tensor, Tensor, Tensor]:
        """Host (CPU) tensors of the live rows, the contract of
        ``IVFZenIndex._live_members``: lets ``snapshot_payload`` serve a
        tiered index too."""
        valid = self.host_ids >= 0
        block_cluster = (np.arange(self.host_ids.shape[0])
                         // self.tiles_per_cluster)
        assign = np.broadcast_to(block_cluster[:, None],
                                 self.host_ids.shape)[valid]
        coords = index_io.to_tensor(np.asarray(self.host_coords)[valid],
                                    "cpu",
                                    bfloat16=self.storage == "bfloat16")
        if not raw and self.host_scales is not None:
            coords = quant.dequantize(
                coords, torch.from_numpy(self.host_scales[assign]))
        elif not raw:
            coords = coords.to(torch.float32)
        return (coords, torch.from_numpy(self.host_ids[valid].astype(
            np.int64)), torch.from_numpy(assign.astype(np.int64)))

    def save(self, directory: str) -> str:
        """Persist the packed tile pool itself (memmap-servable layout)."""
        coords = (index_io.to_tensor(self.host_coords, "cpu", bfloat16=True)
                  if self.storage == "bfloat16" else self.host_coords)
        arrays = {
            "centroids": self.centroids.to(torch.float32),
            "tile_coords": coords,
            "tile_ids": np.asarray(self.host_ids, np.int32),
        }
        if self.host_scales is not None:
            arrays["cluster_scales"] = self.host_scales
        meta = {
            "n_clusters": self.n_clusters,
            "tiles_per_cluster": self.tiles_per_cluster,
            "tile_rows": self.tile_rows,
            "n_valid": self.n_valid,
            "storage": self.storage,
            "n_shards": self.n_shards,
            "generation": int(self.generation),
        }
        return index_io.save_state(
            directory, arrays, meta, kind=TILE_POOL_SNAPSHOT_KIND)

    @classmethod
    def load(
        cls,
        directory: str,
        *,
        mmap: bool = True,
        hot_clusters: Optional[int] = None,
        hot_fraction: float = 0.1,
        prefetch_cols: int = 2,
        n_shards: Optional[int] = None,
        device=None,
    ) -> "TieredIVFZenIndex":
        """Open a tile-pool snapshot (of either package) served from
        ``device`` ("cuda" unless told otherwise); with ``mmap`` the cold
        tiles never materialise in RAM, only probed blocks are read. The
        hot set is the largest clusters, as in :meth:`from_index`."""
        arrays, meta = index_io.load_state(
            directory, expect_kind=TILE_POOL_SNAPSHOT_KIND, mmap=mmap)
        host_ids = arrays["tile_ids"]
        C, T = int(meta["n_clusters"]), int(meta["tiles_per_cluster"])
        live = (np.asarray(host_ids) >= 0).reshape(C, -1).sum(axis=1)
        H = (max(0, min(int(hot_clusters), C)) if hot_clusters is not None
             else max(1, int(C * hot_fraction)))
        hot = np.sort(np.argsort(live, kind="stable")[::-1][:H])
        return cls(
            index_io.to_tensor(arrays["centroids"], resolve_device(device)),
            arrays["tile_coords"],
            host_ids,
            n_clusters=C,
            tiles_per_cluster=T,
            tile_rows=int(meta["tile_rows"]),
            n_valid=int(meta["n_valid"]),
            storage=meta.get("storage", "float32"),
            host_scales=arrays.get("cluster_scales"),
            hot_clusters=hot,
            prefetch_cols=prefetch_cols,
            n_shards=(int(meta.get("n_shards", 1)) if n_shards is None
                      else n_shards),
            generation=int(meta.get("generation", 0)),
        )


def _empty_result(n_queries: int, n_neighbors: int,
                  device) -> Tuple[Tensor, Tensor]:
    """The all-unfilled search result: (Q, n_neighbors) of (+inf, -1)."""
    return (torch.full((n_queries, n_neighbors), float("inf"),
                       device=device),
            torch.full((n_queries, n_neighbors), -1, dtype=torch.int32,
                       device=device))


def _probe_clusters(queries: Tensor, centroids: Tensor, nprobe: int,
                    mode: str) -> Tensor:
    """The ``nprobe`` estimator-nearest centroids per query, ascending by
    distance, the lower centroid id first on ties (``lax.top_k``'s order:
    a stable sort, since the probe kernels' tie order follows it). The
    estimates are row-invariant (``zen.estimate_pdist_rows``)."""
    cd = zen_lib.estimate_pdist_rows(queries, centroids, mode)
    order = torch.sort(cd, dim=1, stable=True).indices
    return order[:, :nprobe].to(torch.int32)


def _ivf_search(index: IVFZenIndex, queries: Tensor, *, n_neighbors: int,
                nprobe: int, mode: str) -> Tuple[Tensor, Tensor]:
    queries = queries.to(device=index.device, dtype=torch.float32)
    probes = _probe_clusters(queries, index.centroids, nprobe, mode)
    if index.codebooks is not None:
        # fold the mode into per-(query, cluster) tables once, then stream
        # the uint8 code tiles through the table-gather probe
        luts = pq_lib.build_luts(queries, index.centroids, index.codebooks,
                                 probes, MODE_IDS[mode])
        return kernel_ops.ivf_probe_pq(
            index.tile_coords, index.tile_ids, probes, luts, n_neighbors,
            tiles_per_cluster=index.tiles_per_cluster)
    return kernel_ops.ivf_probe(
        queries, index.tile_coords, index.tile_ids, probes, n_neighbors,
        mode, tiles_per_cluster=index.tiles_per_cluster,
        tile_scales=index.tile_scales)


#: queries a re-rank block holds: every library call of the re-rank sees
#: this many rows whatever the batch, so its kernel (and each row's bits)
#: cannot change with the batch size
RERANK_BLOCK = 64


def _batched_pdist(name: str, q: Tensor, c: Tensor) -> Tensor:
    """(Q, C) distances between each query (Q, m) and its own candidates
    (Q, C, m) under the metric's pairwise function (inputs normalised).

    The Euclidean family uses the norm expansion of ``sqeuclidean_pdist``
    batched over queries, in blocks of ``RERANK_BLOCK`` queries (the last
    block padded with copies of its first row), so a row's distances do
    not depend on how many rows share the batch; any other metric calls
    its pairwise function once per query.
    """
    if name in ("euclidean", "sqeuclidean", "cosine"):
        n_q = q.shape[0]
        pad = -n_q % RERANK_BLOCK
        if pad:
            q = torch.cat([q, q[-1:].expand(pad, -1)])
            c = torch.cat([c, c[-1:].expand(pad, -1, -1)])
        out = []
        for lo in range(0, q.shape[0], RERANK_BLOCK):
            qb, cb = q[lo:lo + RERANK_BLOCK], c[lo:lo + RERANK_BLOCK]
            x2 = torch.sum(qb * qb, dim=-1)[:, None]        # (B, 1)
            y2 = torch.sum(cb * cb, dim=-1)                 # (B, C)
            xy = torch.bmm(cb, qb[:, :, None])[..., 0]      # (B, C)
            out.append(torch.clamp_min(x2 + y2 - 2.0 * xy, 0.0))
        d2 = torch.cat(out)[:n_q]
        return d2 if name == "sqeuclidean" else torch.sqrt(d2)
    m = metrics_lib.get_metric(name)
    return torch.stack([m.pdist(q[i:i + 1], c[i])[0]
                        for i in range(q.shape[0])])


def exact_rerank(
    queries: Tensor,
    corpus: Tensor,
    cand_ids: Tensor,
    n_neighbors: int,
    *,
    metric: str = "euclidean",
) -> Tuple[Tensor, Tensor]:
    """Refine a (Q, C) candidate pool with true distances.

    Gathers the candidates' original vectors, scores them exactly under
    ``metric`` and returns the best ``n_neighbors``, ascending, in
    ``lax.top_k``'s tie order (a stable sort). Padding candidates
    (id == -1) are masked to +inf and never returned unless the pool holds
    fewer than ``n_neighbors`` valid candidates.
    """
    m = metrics_lib.get_metric(metric)
    safe_ids = torch.clamp_min(cand_ids, 0).long()
    cands = corpus[safe_ids]                              # (Q, C, m)
    qn = m.normalize(queries) if m.normalize is not None else queries
    cn = m.normalize(cands) if m.normalize is not None else cands
    d = _batched_pdist(metric, qn.to(torch.float32), cn.to(torch.float32))
    d = torch.where(cand_ids >= 0, d, torch.full_like(d, float("inf")))
    n_neighbors = min(n_neighbors, cand_ids.shape[1])
    d, pos = torch.sort(d, dim=1, stable=True)
    return d[:, :n_neighbors], torch.gather(cand_ids, 1, pos[:, :n_neighbors])
