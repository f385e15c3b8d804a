"""Tensors laid out on a mesh by a partition spec, and the collectives
between their shards: what GSPMD does for the JAX package, done by one
process that owns every device of the mesh.

* **placement**: a leaf of spec ``P(None, "model")`` on a (data, model)
  mesh is cut along its second dimension into ``model`` equal blocks; the
  mesh position with model coordinate m holds block m, and every position
  along the other axes holds its own copy (:class:`ShardedTensor`,
  :func:`place`, :meth:`ShardedTensor.gather`);
* **collectives** are fixed-order sums and concatenations of
  ``Tensor.to`` copies (:func:`all_sum`, :func:`all_gather`,
  :func:`all_max`, :func:`sum_to`, :func:`sum_scatter`), and a
  re-layout from one sharded dimension to another (:func:`all_to_all`,
  copies alone). A sum is taken
  once, on the first part's device, in part order, and copied to every
  holder; its backward sums the cotangents the same way. So the result
  never depends on a communication schedule, a step gives the same bits
  every time, and every device holding a replicated value holds the same
  bits: replicas cannot drift apart. :func:`sum_scatter` sums block j of
  every part on block j's owner alone (in part order, in f32), so no
  device takes the whole sum; its backward is the matching gather;
* **holders**: after a backward, each shard's gradient is the fixed-order
  sum of what its holders computed (:func:`reduce_holders_`), copied back
  to all of them.

Each collective runs inside a ``torch.profiler.record_function`` range
named ``mesh.*``, so a profiled step shows what the cross-shard copies and
sums cost. Inside :func:`recording` each collective (forward and
backward) also reports its kind and the bytes each receiving position
takes in: host arithmetic on shapes, no sync, nothing else changed. The
kinds take the reference's HLO names where one exists (``all_sum``
all-reduce, ``all_gather`` all-gather, ``sum_scatter`` reduce-scatter,
``all_to_all`` all-to-all, ``send`` collective-permute; an all-gather's
backward is a reduce-scatter and the reverse); ``all_max``, ``sum_to``
and ``reduce_holders`` keep their own (``sum_to``'s backward is
autograd's own copies, not recorded).

Autograd spans the devices in one graph. Every cross-device flow of the
model goes through these functions, whose backward sums in part order, so
no gradient is accumulated across devices in the order the autograd
engine's per-device threads happen to finish.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from .mesh import Mesh
from .sharding import P

Tensor = torch.Tensor


def coords(mesh: Mesh, pos: int) -> Dict[str, int]:
    """Axis name -> coordinate of mesh position ``pos`` (row-major over
    ``mesh.devices``)."""
    idx = np.unravel_index(pos, mesh.devices.shape)
    return dict(zip(mesh.axis_names, (int(i) for i in idx)))


def _axis_index(mesh: Mesh, axes: Tuple[str, ...], c: Dict[str, int]
                ) -> Tuple[int, int]:
    """(linear index, count) of coordinates ``c`` over ``axes``, the first
    axis slowest."""
    idx, n = 0, 1
    for a in axes:
        if a not in mesh.shape:
            raise ValueError(f"axis {a!r} is not in the mesh's "
                             f"{mesh.axis_names}")
        idx, n = idx * mesh.shape[a] + c[a], n * mesh.shape[a]
    return idx, n


def block(shape: Sequence[int], spec: P, mesh: Mesh, pos: int
          ) -> Tuple[slice, ...]:
    """The slices of a ``shape`` leaf that mesh position ``pos`` holds."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape "
                         f"{tuple(shape)}")
    c = coords(mesh, pos)
    out = []
    for d, size in enumerate(shape):
        i, n = _axis_index(mesh, spec.axes(d), c)
        if size % n:
            raise ValueError(f"dimension {d} of {tuple(shape)} ({size}) "
                             f"does not split into {n} shards ({spec})")
        w = size // n
        out.append(slice(i * w, (i + 1) * w))
    return tuple(out)


def shard_key(spec: P, mesh: Mesh, pos: int) -> Tuple[int, ...]:
    """Which shard position ``pos`` holds: its index along each sharded
    dimension."""
    c = coords(mesh, pos)
    return tuple(_axis_index(mesh, spec.axes(d), c)[0]
                 for d in range(len(spec)))


def holder_groups(spec: P, mesh: Mesh) -> List[List[int]]:
    """Positions grouped by the shard they hold, each group in ascending
    order, the groups in the order of their first position."""
    groups: Dict[Tuple[int, ...], List[int]] = {}
    for pos in range(mesh.size):
        groups.setdefault(shard_key(spec, mesh, pos), []).append(pos)
    return list(groups.values())


def axis_groups(mesh: Mesh, axis: str) -> List[List[int]]:
    """Positions grouped along ``axis``: one group for each coordinate of
    the other axes (in row-major order), each listing the positions at
    ``axis`` coordinate 0, 1, ..."""
    k = mesh.axis_names.index(axis)
    pos = np.arange(mesh.size).reshape(mesh.devices.shape)
    return [list(map(int, row)) for row in
            np.moveaxis(pos, k, -1).reshape(-1, mesh.shape[axis])]


class ShardedTensor:
    """A ``shape`` x ``dtype`` tensor laid out on ``mesh`` by ``spec``:
    ``shards[i]`` is the block mesh position i holds, on that position's
    device."""

    def __init__(self, mesh: Mesh, spec: P, shape, dtype: torch.dtype,
                 shards: List[Tensor]):
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of "
                             f"{mesh.size} positions")
        self.mesh, self.spec, self.dtype = mesh, spec, dtype
        self.shape = tuple(shape)
        self.shards = list(shards)

    def __repr__(self) -> str:
        return (f"ShardedTensor({self.shape}, {self.dtype}, {self.spec}, "
                f"mesh {dict(self.mesh.shape)})")

    def device(self, pos: int) -> torch.device:
        return self.mesh.devices.flat[pos]

    def holders(self) -> List[List[int]]:
        return holder_groups(self.spec, self.mesh)

    def distinct(self) -> List[Tensor]:
        """One shard of each group of holders (its first holder's)."""
        return [self.shards[g[0]] for g in self.holders()]

    def gather(self, device=None) -> Tensor:
        """The whole tensor on ``device`` (the first position's device by
        default), assembled from the first holder of each shard."""
        dev = self.device(0) if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for g in self.holders():
            out[block(self.shape, self.spec, self.mesh, g[0])] = \
                self.shards[g[0]].detach().to(dev)
        return out

    def map(self, fn, dtype: Optional[torch.dtype] = None
            ) -> "ShardedTensor":
        """``fn`` of every shard, laid out alike (``dtype`` if it
        changes)."""
        return ShardedTensor(self.mesh, self.spec, self.shape,
                             self.dtype if dtype is None else dtype,
                             [fn(s) for s in self.shards])


def zeros(shape, spec: P, mesh: Mesh, dtype: torch.dtype) -> ShardedTensor:
    """Zeros laid out on ``mesh`` by ``spec``, each block made where it
    lives."""
    return ShardedTensor(mesh, spec, shape, dtype, [
        torch.zeros(tuple(b.stop - b.start for b in block(shape, spec, mesh,
                                                           pos)),
                    dtype=dtype, device=mesh.devices.flat[pos])
        for pos in range(mesh.size)])


def place(x: Tensor, spec: P, mesh: Mesh) -> ShardedTensor:
    """``x`` laid out on ``mesh`` by ``spec``: every position gets its own
    copy of its block, on its device."""
    shards = [x[block(x.shape, spec, mesh, pos)].to(
        mesh.devices.flat[pos], copy=True).contiguous()
        for pos in range(mesh.size)]
    return ShardedTensor(mesh, spec, x.shape, x.dtype, shards)


def synchronize(mesh: Mesh) -> None:
    """Wait for every card of the mesh."""
    for dev in dict.fromkeys(mesh.devices.flat):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


# -- the collective recorder ------------------------------------------------------

_RECORDS: List[dict] = []


@contextlib.contextmanager
def recording() -> Iterator[dict]:
    """Within the block, every collective adds to the yielded record:
    kind -> {"count": receiving positions, "bytes": what they take in},
    summed over the calls. Off (one list check a call) outside any such
    block; blocks may nest, each counting everything inside it."""
    rec: dict = {}
    _RECORDS.append(rec)
    try:
        yield rec
    finally:
        _RECORDS.remove(rec)


def _note(kind: str, received: Sequence[Tensor]) -> None:
    """Record one collective: ``received[i]`` is what receiving position i
    takes in."""
    if not _RECORDS:
        return
    nbytes = sum(int(t.numel()) * t.element_size() for t in received)
    for rec in _RECORDS:
        e = rec.setdefault(kind, {"count": 0, "bytes": 0})
        e["count"] += len(received)
        e["bytes"] += nbytes


# -- collectives ------------------------------------------------------------------


def _fixed_sum(parts: Sequence[Tensor], dev: torch.device) -> Tensor:
    """((p0 + p1) + p2) + ... on ``dev``."""
    acc = parts[0].to(dev)
    for p in parts[1:]:
        acc = acc + p.to(dev)
    return acc


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *parts):
        ctx.devices = [p.device for p in parts]
        with record_function("mesh.all_sum"):
            total = _fixed_sum(parts, ctx.devices[0])
            out = tuple(total.to(d, copy=True) for d in ctx.devices)
        _note("all-reduce", out)
        return out

    @staticmethod
    def backward(ctx, *grads):
        with record_function("mesh.all_sum"):
            total = _fixed_sum(grads, ctx.devices[0])
            out = tuple(total.to(d, copy=True) for d in ctx.devices)
        _note("all-reduce", out)
        return out


def all_sum(parts: Sequence[Tensor]) -> List[Tensor]:
    """The sum of ``parts`` (one a device of a group) on every part's
    device: taken once in part order on the first part's device and
    copied, so every copy is the same bits. Its backward sums the copies'
    cotangents the same way. One part is returned as it is."""
    if len(parts) == 1:
        return [parts[0]]
    return list(_AllSum.apply(*parts))


class _SumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, dtype, *parts):
        ctx.dim = dim
        ctx.devices = [p.device for p in parts]
        ctx.dtypes = [p.dtype for p in parts]
        w = parts[0].shape[dim] // len(parts)
        out = []
        with record_function("mesh.sum_scatter"):
            for j, d in enumerate(ctx.devices):
                blocks = [p.narrow(dim, j * w, w) for p in parts]
                acc = blocks[0].to(d, torch.float32, copy=True)
                for b in blocks[1:]:
                    acc += b.to(d, torch.float32)
                out.append(acc.to(dtype))
        _note("reduce-scatter", out)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        with record_function("mesh.sum_scatter"):
            out = [torch.cat([g.to(d, t) for g in grads], ctx.dim)
                   for d, t in zip(ctx.devices, ctx.dtypes)]
        _note("all-gather", out)
        return (None, None, *out)


def sum_scatter(parts: Sequence[Tensor], dim: int,
                dtype: Optional[torch.dtype] = None) -> List[Tensor]:
    """Block j (of ``len(parts)`` equal blocks along ``dim``) of the sum of
    ``parts`` (one a device of a group, each whole along ``dim``), on part
    j's device: block j of every part summed there in part order, in f32,
    and cast once to ``dtype`` (the parts' own by default). So no device
    receives more than its own block of each part. Its backward is the
    matching gather: part i's cotangent is the blocks' cotangents
    concatenated on part i's device."""
    dtype = parts[0].dtype if dtype is None else dtype
    if parts[0].shape[dim] % len(parts):
        raise ValueError(f"dimension {dim} of {tuple(parts[0].shape)} does "
                         f"not split into {len(parts)} blocks")
    return list(_SumScatter.apply(dim, dtype, *parts))


def all_max(parts: Sequence[Tensor]) -> List[Tensor]:
    """The elementwise max of ``parts`` on every part's device (no
    gradient)."""
    if len(parts) == 1:
        return [parts[0].detach()]
    dev = parts[0].device
    with record_function("mesh.all_max"):
        acc = parts[0].detach().to(dev)
        for p in parts[1:]:
            acc = torch.maximum(acc, p.detach().to(dev))
        out = [acc.to(p.device, copy=True) for p in parts]
    _note("all_max", out)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, *parts):
        ctx.dim = dim
        ctx.devices = [p.device for p in parts]
        ctx.sizes = [p.shape[dim] for p in parts]
        with record_function("mesh.all_gather"):
            out = tuple(torch.cat([p.to(d) for p in parts], dim)
                        for d in ctx.devices)
        _note("all-gather", out)
        return out

    @staticmethod
    def backward(ctx, *grads):
        out, lo = [None], 0
        with record_function("mesh.all_gather"):
            for d, w in zip(ctx.devices, ctx.sizes):
                out.append(_fixed_sum([g.narrow(ctx.dim, lo, w)
                                       for g in grads], d).contiguous())
                lo += w
        _note("reduce-scatter", out[1:])
        return tuple(out)


def all_gather(parts: Sequence[Tensor], dim: int) -> List[Tensor]:
    """``parts`` concatenated along ``dim``, on every part's device; the
    backward gives each part the fixed-order sum, over the holders, of
    its block of their cotangents. One part is returned as it is."""
    if len(parts) == 1:
        return [parts[0]]
    return list(_AllGather.apply(dim, *parts))


def _relayout(parts: Sequence[Tensor], split_dim: Optional[int],
              cat_dim: int, src: Sequence[int]) -> List[Tensor]:
    """Part m: block m of ``split_dim`` (whole with None) of each of
    ``src``'s parts, concatenated along ``cat_dim`` on part m's device."""
    w = None if split_dim is None else parts[0].shape[split_dim] // len(parts)
    out = []
    with record_function("mesh.all_to_all"):
        for m, p in enumerate(parts):
            blocks = [parts[j] if w is None else
                      parts[j].narrow(split_dim, m * w, w) for j in src]
            out.append(torch.cat([b.to(p.device) for b in blocks], cat_dim))
    _note("all-to-all", out)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, split_dim, cat_dim, *parts):
        ctx.dims = split_dim, cat_dim
        return tuple(_relayout(parts, split_dim, cat_dim,
                               range(len(parts))))

    @staticmethod
    def backward(ctx, *grads):
        split_dim, cat_dim = ctx.dims
        return (None, None, *_relayout(grads, cat_dim, split_dim,
                                       range(len(grads))))


def all_to_all(parts: Sequence[Tensor], split_dim: Optional[int],
               cat_dim: int, sources: Optional[Sequence[int]] = None
               ) -> List[Tensor]:
    """A re-layout along one mesh axis, from a tensor sharded along
    ``cat_dim`` to one sharded along ``split_dim``. ``parts`` (one a
    device of the axis, in axis order) hold the blocks of ``cat_dim``:
    ``sources`` names, for each block in order, the part that holds it
    (every part its own block by default; where several parts hold
    copies of one block, name its first holder). Part m of the result, on
    part m's device, is block m of ``split_dim`` (``len(parts)`` equal
    blocks) of each source, concatenated along ``cat_dim`` in order; with
    ``split_dim`` None every part takes the sources whole (an all-gather
    of distinct blocks). Copies only, in a fixed order. With every part
    its own source and a ``split_dim``, the re-layout carries a gradient
    (its backward the inverse re-layout); otherwise none."""
    n = len(parts)
    if split_dim is not None and parts[0].shape[split_dim] % n:
        raise ValueError(f"dimension {split_dim} of {tuple(parts[0].shape)} "
                         f"does not split into {n} blocks")
    if sources is None and split_dim is not None:
        return list(_AllToAll.apply(split_dim, cat_dim, *parts))
    src = list(range(n)) if sources is None else list(sources)
    return _relayout([p.detach() for p in parts], split_dim, cat_dim, src)


def send(x: Tensor, device) -> Tensor:
    """``x`` copied to ``device`` (no gradient): a point-to-point transfer,
    the reference's collective-permute."""
    with record_function("mesh.send"):
        out = x.detach().to(device, copy=True)
    _note("collective-permute", [out])
    return out


def sum_to(parts: Sequence[Tensor], device) -> Tensor:
    """The fixed-order sum of ``parts`` on ``device`` (autograd's own
    copies and adds: each part is read once)."""
    with record_function("mesh.sum_to"):
        out = _fixed_sum(parts, torch.device(device))
    if len(parts) > 1:
        _note("sum_to", [out])
    return out


# -- holders -------------------------------------------------------------------------


@torch.no_grad()
def reduce_holders_(st: ShardedTensor) -> ShardedTensor:
    """In place: every shard becomes the fixed-order sum (ascending
    position) of what its holders hold, the same bits on each."""
    with record_function("mesh.reduce_holders"):
        for g in st.holders():
            if len(g) == 1:
                continue
            total = _fixed_sum([st.shards[p] for p in g], st.device(g[0]))
            for p in g:
                st.shards[p].copy_(total)
            _note("reduce_holders", [total] * len(g))
    return st


def replicas_equal(st: ShardedTensor) -> bool:
    """Whether every holder of each shard holds the same bits."""
    for g in st.holders():
        first = st.shards[g[0]].detach()
        for p in g[1:]:
            if not torch.equal(st.shards[p].detach().to(first.device),
                               first):
                return False
    return True
