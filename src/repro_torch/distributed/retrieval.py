"""Sharded nSimplex-Zen retrieval: per-shard streaming (or clustered IVF)
top-k and one merge.

PyTorch counterpart of ``repro.distributed.retrieval``, single-controller
as the reference is: one process drives every device of a
``distributed.mesh.Mesh``. A row-sharded array (:class:`ShardedRows`) is
the list of its S row blocks, block ``s`` on the mesh's ``s``-th shard
device. Each shard runs ``kernels.ops.zen_topk`` (or ``ivf_probe``) over
its own block on its own device: the Hopper kernels for CUDA blocks, which
launch without waiting on the host, so the shards of a mesh of cards
overlap; their plain versions on the CPU. Each shard emits its candidates
with *global* row ids (local id + shard offset), and the candidate lists
meet on the mesh's first device through ``Tensor.to`` copies (peer copies
between cards).

The reference rings the candidates between devices (``lax.ppermute``) and
folds each hop by the key (distance, global id). The smallest n of the
union of every shard's candidates by that key does not depend on the order
they are folded in, so one gather and one selection by the key
(:func:`_lex_topk`) give the ring's answer, bit for bit.

Both entry points take an optional per-shard ``alive`` mask (degraded
serving, ``distributed.fault``): a dead shard contributes only (+inf, -1)
candidates, so queries keep answering from the survivors. Its device is
not touched at all (it may be the one that failed). A shard whose launch
fails fails the query: nothing falls back.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import ops as kernel_ops

from .mesh import AxisNames, Mesh

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedRows:
    """A row-sharded (N, ...) array.

    Attributes:
      blocks: the S row blocks, of equal length, block ``s`` on shard
              ``s``'s device.
      n_rows: rows before the zero padding that made N a multiple of S;
              the padding is the tail of the last blocks.
    """

    blocks: Tuple[Tensor, ...]
    n_rows: int

    @property
    def n_shards(self) -> int:
        return len(self.blocks)

    @property
    def shard_rows(self) -> int:
        return int(self.blocks[0].shape[0])

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.n_shards * self.shard_rows,) + tuple(
            self.blocks[0].shape[1:])

    @property
    def device(self) -> torch.device:
        """The first shard's device."""
        return self.blocks[0].device


def resolve_axis_names(mesh: Mesh, axis: Optional[AxisNames]
                       ) -> Tuple[str, ...]:
    """Normalise an ``axis`` argument: None -> all mesh axes, str -> 1-tuple."""
    if axis is None:
        return tuple(mesh.axis_names)
    if isinstance(axis, str):
        return (axis,)
    return tuple(axis)


def shard_rows(x: Tensor, *, mesh: Mesh, axis: Optional[AxisNames] = None
               ) -> Tuple[ShardedRows, int]:
    """Row-shard ``x`` over ``mesh``, zero-padding to a divisible row count.

    Returns ``(ShardedRows, n_valid)`` where ``n_valid`` is the original N
    (also the result's ``n_rows``); pass it to :func:`sharded_knn_search` so
    the padded rows are masked. Every block is its own allocation on its
    shard's device, even where that is ``x``'s device.
    """
    devices = mesh.shard_devices(resolve_axis_names(mesh, axis))
    n_shards = len(devices)
    n_valid = int(x.shape[0])
    pad = (-n_valid) % n_shards
    rows = (n_valid + pad) // n_shards
    blocks = []
    for s, dev in enumerate(devices):
        blk = x[s * rows:(s + 1) * rows].to(dev, copy=True)
        short = rows - blk.shape[0]
        if short:
            blk = torch.cat([blk, blk.new_zeros((short,) + blk.shape[1:])])
        blocks.append(blk.contiguous())
    return ShardedRows(tuple(blocks), n_valid), n_valid


def host_rows(x: Union[ShardedRows, Tensor], n_valid: Optional[int] = None
              ) -> Tensor:
    """Gather a (possibly row-sharded) array to one CPU tensor.

    Used by the snapshot path (``ZenServer.save``): snapshots store
    canonical unsharded rows, so the shard count is a load-time choice.
    ``n_valid`` (default: a ``ShardedRows``' ``n_rows``, else every row)
    strips the shard padding.
    """
    if isinstance(x, ShardedRows):
        n_valid = x.n_rows if n_valid is None else n_valid
        out = torch.cat([b.cpu() for b in x.blocks])
    else:
        out = x.cpu()
    return out if n_valid is None else out[:n_valid]


def _as_sharded(x: Union[ShardedRows, Tensor], mesh: Mesh,
                axis_names: Tuple[str, ...]) -> ShardedRows:
    if isinstance(x, ShardedRows):
        if x.n_shards != len(mesh.shard_devices(axis_names)):
            raise ValueError(f"{x.n_shards} row blocks for a mesh of "
                             f"{len(mesh.shard_devices(axis_names))} shards")
        return x
    return shard_rows(x, mesh=mesh, axis=axis_names)[0]


def _host_alive(alive, n_shards: int) -> Tuple[bool, ...]:
    if alive is None:
        return (True,) * n_shards
    if isinstance(alive, Tensor):
        alive = alive.cpu().tolist()
    flags = tuple(bool(a) for a in alive)
    if len(flags) != n_shards:
        raise ValueError(f"alive has {len(flags)} entries for {n_shards} "
                         f"shards")
    return flags


def _lex_topk(d: Tensor, ids: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Smallest-k columns of (Q, w) candidates by the (distance, id) key.

    ``jnp.lexsort((ids, d))``'s order: a stable sort by id, then a stable
    sort by distance (NaN last, -0.0 equal to 0.0, as both sorts take
    them). The id tie-break makes the selection canonical: any permutation
    of the candidate columns gives the same output.
    """
    by_id = torch.sort(ids, dim=-1, stable=True).indices
    by_d = torch.sort(torch.gather(d, -1, by_id), dim=-1, stable=True).indices
    order = torch.gather(by_id, -1, by_d)[..., :k]
    return torch.gather(d, -1, order), torch.gather(ids, -1, order)


def _ring_merge(parts, n_neighbors: int, home: torch.device
                ) -> Tuple[Tensor, Tensor]:
    """Merge per-shard (Q, w) candidates into the global top-n on ``home``.

    The counterpart of the reference's ``_ring_merge``: the lists are
    gathered on ``home`` and selected once by (distance, global id), which
    is the ring's answer (see the module docstring). Even one shard's list
    goes through the selection, as in the reference.
    """
    d = torch.cat([p[0].to(home) for p in parts], dim=1)
    ids = torch.cat([p[1].to(home) for p in parts], dim=1)
    return _lex_topk(d, ids, n_neighbors)


def _dead_candidates(n_queries: int, width: int, device
                     ) -> Tuple[Tensor, Tensor]:
    """A dead shard's (+inf, -1) candidates, made on ``device`` (the
    merge's) without touching the shard: the counterpart of the
    reference's ``_apply_alive_mask``."""
    return (torch.full((n_queries, width), float("inf"), device=device),
            torch.full((n_queries, width), -1, dtype=torch.int32,
                       device=device))


def _replicate(t: Optional[Tensor], blocks, flags
               ) -> Dict[torch.device, Optional[Tensor]]:
    """One copy of a replicated tensor (or None) on each live shard's
    device."""
    return {b.device: None if t is None else t.to(b.device)
            for b, ok in zip(blocks, flags) if ok}


def sharded_knn_search(
    queries: Tensor,
    index: Union[ShardedRows, Tensor],
    n_neighbors: int = 10,
    mode: str = "zen",
    *,
    mesh: Mesh,
    axis: Optional[AxisNames] = None,
    chunk: int = 4096,
    n_valid: Optional[int] = None,
    scales: Optional[Union[ShardedRows, Tensor]] = None,
    alive=None,
) -> Tuple[Tensor, Tensor]:
    """Top-k of ``queries`` in a row-sharded ``index`` over ``mesh``.

    Args:
      queries: (Q, k) projected queries (copied to every shard's device).
      index:   (N, k) projected index as :class:`ShardedRows` (or a tensor,
               sharded here), stored f32, bf16 or int8.
      mesh:    the device mesh.
      axis:    mesh axis name (or names) the rows are sharded over;
               defaults to all mesh axes.
      chunk:   row tile of the plain per-shard scan (CPU).
      n_valid: real index rows; later rows are padding, never searched.
               Defaults to a ``ShardedRows``' ``n_rows``, else every row.
      scales:  (N, 1) f32 per-row scales when ``index`` is int8, sharded
               like the index rows.
      alive:   (n_shards,) bools, linearised in ``axis`` order; a False
               shard contributes nothing (degraded serving).

    Returns (distances, indices), each (Q, n_neighbors), ascending by
    (distance, global row id), on the mesh's first device.
    """
    names = resolve_axis_names(mesh, axis)
    sharded = _as_sharded(index, mesh, names)
    if n_valid is None:
        n_valid = sharded.n_rows if isinstance(index, ShardedRows) \
            else int(index.shape[0])
    scl = None if scales is None else _as_sharded(scales, mesh, names)
    n_shards, rows = sharded.n_shards, sharded.shard_rows
    n_neighbors = min(n_neighbors, n_valid)
    flags = _host_alive(alive, n_shards)
    q = _replicate(queries, sharded.blocks, flags)
    parts = []
    for s, blk in enumerate(sharded.blocks):
        # Only the shard's real rows are searched. The reference searches
        # the zero padding too (shard_map runs one shape on every device)
        # and so fetches n + n_pad candidates a shard, then masks the
        # padded ids; the same real candidates reach the merge either way,
        # and here the width stays n (at the serving width 64, n + 1 would
        # move zen_topk from its MMA plan to its slower SIMT plan).
        real = min(rows, max(0, n_valid - s * rows))
        if not (flags[s] and real):
            parts.append(_dead_candidates(queries.shape[0], n_neighbors,
                                          mesh.first_device))
            continue
        k_fetch = min(n_neighbors, real)
        d, ids = kernel_ops.zen_topk(
            q[blk.device], blk[:real], k_fetch, mode,
            scales=None if scl is None else scl.blocks[s][:real],
            chunk=chunk)
        gids = ids + s * rows
        if k_fetch < n_neighbors:  # a short shard: widen to the merge width
            fill = n_neighbors - k_fetch
            d = torch.nn.functional.pad(d, (0, fill), value=float("inf"))
            gids = torch.nn.functional.pad(gids, (0, fill), value=-1)
        parts.append((d, gids))
    return _ring_merge(parts, n_neighbors, mesh.first_device)


def sharded_ivf_probe(
    queries: Tensor,
    tile_coords: Union[ShardedRows, Tensor],
    tile_ids: Union[ShardedRows, Tensor],
    probes: Tensor,
    n_neighbors: int = 10,
    mode: str = "zen",
    *,
    mesh: Mesh,
    axis: Optional[AxisNames] = None,
    tiles_per_cluster: int,
    tile_scales: Optional[Tensor] = None,
    alive=None,
) -> Tuple[Tensor, Tensor]:
    """Clustered top-k of ``queries`` in mesh-sharded inverted-list tiles.

    Args:
      queries:     (Q, k) projected queries (copied to every shard).
      tile_coords: (S*C*T, tile_rows, k) packed tiles, row-sharded over
                   ``axis``: each shard holds its own (C*T, ...) inverted
                   lists (``index.ivf.ShardedIVFZenIndex``); f32, bf16 or
                   int8.
      tile_ids:    (S*C*T, tile_rows) int32 *global* row ids, -1 = padding,
                   sharded like the tiles.
      probes:      (Q, nprobe) int32 cluster ids, replicated (one global
                   coarse quantizer).
      tiles_per_cluster: T of the packed layout.
      tile_scales: (C, 1) f32 per-cluster int8 scales, replicated (they
                   follow the global assignment, like the centroids).
      alive:       (n_shards,) bools, linearised in ``axis`` order; a
                   False shard's tiles are dropped from the merge.

    Returns (distances, indices), each (Q, n_neighbors), ascending, global
    ids, on the mesh's first device; slots the probed clusters cannot fill
    are (+inf, -1).
    """
    names = resolve_axis_names(mesh, axis)
    n_shards = len(mesh.shard_devices(names))
    if not isinstance(tile_coords, ShardedRows) and \
            tile_coords.shape[0] % n_shards:
        raise ValueError(f"{tile_coords.shape[0]} tile blocks do not split "
                         f"over {n_shards} shards")
    tc = _as_sharded(tile_coords, mesh, names)
    ti = _as_sharded(tile_ids, mesh, names)
    flags = _host_alive(alive, n_shards)
    q, pr, ts = (_replicate(t, tc.blocks, flags)
                 for t in (queries, probes, tile_scales))
    parts = []
    for s, blk in enumerate(tc.blocks):
        dev = blk.device
        if not flags[s]:
            parts.append(_dead_candidates(queries.shape[0], n_neighbors,
                                          mesh.first_device))
            continue
        # local padding already carries (+inf, -1): no compensation needed
        parts.append(kernel_ops.ivf_probe(
            q[dev], blk, ti.blocks[s], pr[dev], n_neighbors, mode,
            tiles_per_cluster=tiles_per_cluster, tile_scales=ts[dev]))
    return _ring_merge(parts, n_neighbors, mesh.first_device)
