"""Tensors laid out on a mesh by a partition spec, and the collectives
between their shards: what GSPMD does for the JAX package, done by the
process that owns every device of the mesh, or by one process a host
(``--multihost``), each owning its own positions.

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

**Across processes** (a mesh whose positions several processes own,
``launch.mesh.make_host_mesh`` after ``distributed.process.initialize``)
every function here is called by every process alike; a position another
process owns is a ``process.Remote`` placeholder. A sum is still taken
once, on its first part's device, in part order and dtype, by that
device's process; only the copies cross processes, as point-to-point
transfers (``process.send``/``recv``) keyed by the collective's sequence
number (counted alike in every process) and the copy's index in it, in
forward and backward. So the bits are the one-process mesh's.
:func:`place` and :func:`zeros` make only this process's blocks (``place``
takes a value every process holds: weights drawn from one seed, a batch
from (seed, step), a checkpoint's file); :func:`everywhere` copies a
value to every process (the loss, the clip's scale).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from . import process
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

    def gather(self, device=None, *, root: Optional[int] = None
               ) -> Optional[Tensor]:
        """The whole tensor on ``device`` (the first position's device by
        default; across processes this process's first device),
        assembled from the first holder of each shard. Across processes
        every process calls it; each gets the whole tensor, or with
        ``root`` only that process does (the others get None)."""
        mesh, me = self.mesh, self.mesh.process
        dev = mesh.local_device if device is None else torch.device(device)
        takers = range(mesh.process_count) if root is None else [root]
        out = (torch.empty(self.shape, dtype=self.dtype, device=dev)
               if me in takers else None)
        keys = _Keys()
        with record_function("mesh.gather"):
            for g in self.holders():
                blk = block(self.shape, self.spec, mesh, g[0])
                src, shard = mesh.owner(g[0]), self.shards[g[0]].detach()
                for r in takers:
                    key = keys()
                    if r == src == me:
                        out[blk] = shard.to(dev)
                    elif src == me:
                        _send(shard, r, key)
                    elif r == me:
                        out[blk] = _recv(shard, dev, src, key)
        return out

    def map(self, fn, dtype: Optional[torch.dtype] = None
            ) -> "ShardedTensor":
        """``fn`` of every shard, laid out alike (``dtype`` if it
        changes)."""
        return ShardedTensor(self.mesh, self.spec, self.shape,
                             self.dtype if dtype is None else dtype,
                             [fn(s) for s in self.shards])


def _block_shape(shape, spec: P, mesh: Mesh, pos: int) -> tuple:
    return tuple(b.stop - b.start for b in block(shape, spec, mesh, pos))


def zeros(shape, spec: P, mesh: Mesh, dtype: torch.dtype) -> ShardedTensor:
    """Zeros laid out on ``mesh`` by ``spec``, each block made where it
    lives (another process's a placeholder)."""
    return ShardedTensor(mesh, spec, shape, dtype, [
        torch.zeros(_block_shape(shape, spec, mesh, pos), dtype=dtype,
                    device=mesh.devices.flat[pos]) if mesh.is_local(pos)
        else process.remote(_block_shape(shape, spec, mesh, pos), dtype,
                            mesh.owner(pos))
        for pos in range(mesh.size)])


def place(x: Tensor, spec: P, mesh: Mesh) -> ShardedTensor:
    """``x`` laid out on ``mesh`` by ``spec``: every position gets its own
    copy of its block, on its device. Across processes ``x`` is a value
    every process holds, and each makes only its own positions' blocks."""
    shards = [x[block(x.shape, spec, mesh, pos)].to(
        mesh.devices.flat[pos], copy=True).contiguous()
        if mesh.is_local(pos) else
        process.remote(_block_shape(x.shape, spec, mesh, pos), x.dtype,
                       mesh.owner(pos))
        for pos in range(mesh.size)]
    return ShardedTensor(mesh, spec, x.shape, x.dtype, shards)


def synchronize(mesh: Mesh) -> None:
    """Wait for every card of the mesh (this process's); across processes
    also for every process, checking that each pair matched its
    transfers in order."""
    for dev in dict.fromkeys(mesh.devices.flat):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    if mesh.process_count > 1:
        process.check_transfers()


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


# -- copies within and between processes -------------------------------------------

#: collectives called so far: the same count in every process, since every
#: process calls them alike
_SEQ = [0]

#: a place: (device, the process owning it); another process's device is
#: ``meta``
Place = Tuple[torch.device, int]


class _Keys:
    """The keys of one collective's copies: its sequence number (taken in
    the forward, where every process takes them in one order), the
    direction (0 forward, 1 backward) and the copy's index. Every process
    draws a key for every copy, whether it sends, receives or neither."""

    def __init__(self, seq: Optional[int] = None, direction: int = 0):
        if seq is None:
            seq = _SEQ[0]
            _SEQ[0] += 1
        self.seq = seq
        self.base = (seq * 2 + direction) * 8192
        self.i = 0

    def __call__(self) -> int:
        self.i += 1
        return self.base + self.i - 1

    def backward(self) -> "_Keys":
        return _Keys(self.seq, 1)


def _place_of(t: Tensor) -> Place:
    return t.device, process.owner(t)


def _send(x: Tensor, dst: int, key: int) -> None:
    if x.numel():
        process.send(x, dst, key)


def _recv(like: Tensor, device, src: int, key: int) -> Tensor:
    """What ``src`` sends under ``key``, shaped as ``like``."""
    if not like.numel():
        return torch.empty(like.shape, dtype=like.dtype, device=device)
    return process.recv(like.shape, like.dtype, device, src, key)


def _move(x: Tensor, src: int, dst: Place, keys: _Keys,
          dtype: Optional[torch.dtype] = None, copy: bool = False) -> Tensor:
    """``x`` (held by process ``src``) at place ``dst``: ``Tensor.to``
    within a process, a transfer between two, and a placeholder where
    this process holds neither end."""
    key = keys()
    dev, owner = dst
    me = process.process_index()
    if src == owner == me:
        return (x.to(dev, copy=copy) if dtype is None
                else x.to(dev, dtype, copy=copy))
    if src == me:
        _send(x, owner, key)
    elif owner == me:
        out = _recv(x, dev, src, key)
        return out if dtype is None else out.to(dtype)
    return process.remote(x.shape, x.dtype if dtype is None else dtype,
                          owner)


# -- collectives ------------------------------------------------------------------


def _fixed_sum(parts: Sequence[Tensor], owners: Sequence[int], dst: Place,
               keys: _Keys) -> Tensor:
    """((p0 + p1) + p2) + ... at ``dst``."""
    acc = _move(parts[0], owners[0], dst, keys)
    for p, o in zip(parts[1:], owners[1:]):
        acc = acc + _move(p, o, dst, keys)
    return acc


def _owners(places: Sequence[Place]) -> List[int]:
    return [o for _, o in places]


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *parts):
        ctx.places = [_place_of(p) for p in parts]
        ctx.keys = keys = _Keys()
        owners = _owners(ctx.places)
        with record_function("mesh.all_sum"):
            total = _fixed_sum(parts, owners, ctx.places[0], keys)
            out = tuple(_move(total, owners[0], pl, keys, copy=True)
                        for pl in ctx.places)
        _note("all-reduce", out)
        return out

    @staticmethod
    def backward(ctx, *grads):
        keys, owners = ctx.keys.backward(), _owners(ctx.places)
        with record_function("mesh.all_sum"):
            total = _fixed_sum(grads, owners, ctx.places[0], keys)
            out = tuple(_move(total, owners[0], pl, keys, copy=True)
                        for pl in ctx.places)
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
        ctx.places = [_place_of(p) for p in parts]
        ctx.dtypes = [p.dtype for p in parts]
        ctx.keys = keys = _Keys()
        owners = _owners(ctx.places)
        w = parts[0].shape[dim] // len(parts)
        out = []
        with record_function("mesh.sum_scatter"):
            for j, pl in enumerate(ctx.places):
                blocks = [p.narrow(dim, j * w, w) for p in parts]
                acc = _move(blocks[0], owners[0], pl, keys, torch.float32,
                            copy=True)
                for b, o in zip(blocks[1:], owners[1:]):
                    acc += _move(b, o, pl, keys, torch.float32)
                out.append(acc.to(dtype))
        _note("reduce-scatter", out)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        keys, owners = ctx.keys.backward(), _owners(ctx.places)
        with record_function("mesh.sum_scatter"):
            out = [torch.cat([_move(g, o, pl, keys, t)
                              for g, o in zip(grads, owners)], ctx.dim)
                   for pl, t in zip(ctx.places, ctx.dtypes)]
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
    places = [_place_of(p) for p in parts]
    owners, keys = _owners(places), _Keys()
    with record_function("mesh.all_max"):
        acc = _move(parts[0].detach(), owners[0], places[0], keys)
        for p, o in zip(parts[1:], owners[1:]):
            acc = torch.maximum(acc, _move(p.detach(), o, places[0], keys))
        out = [_move(acc, owners[0], pl, keys, copy=True) for pl in places]
    _note("all_max", out)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, *parts):
        ctx.dim = dim
        ctx.places = [_place_of(p) for p in parts]
        ctx.sizes = [p.shape[dim] for p in parts]
        ctx.keys = keys = _Keys()
        owners = _owners(ctx.places)
        with record_function("mesh.all_gather"):
            out = tuple(torch.cat([_move(p, o, pl, keys)
                                   for p, o in zip(parts, owners)], dim)
                        for pl in ctx.places)
        _note("all-gather", out)
        return out

    @staticmethod
    def backward(ctx, *grads):
        keys, owners = ctx.keys.backward(), _owners(ctx.places)
        out, lo = [None], 0
        with record_function("mesh.all_gather"):
            for pl, w in zip(ctx.places, ctx.sizes):
                out.append(_fixed_sum([g.narrow(ctx.dim, lo, w)
                                       for g in grads], owners, pl,
                                      keys).contiguous())
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
              cat_dim: int, src: Sequence[int], places: Sequence[Place],
              keys: _Keys) -> List[Tensor]:
    """Part m: block m of ``split_dim`` (whole with None) of each of
    ``src``'s parts, concatenated along ``cat_dim`` at part m's place."""
    w = None if split_dim is None else parts[0].shape[split_dim] // len(parts)
    owners = _owners(places)
    out = []
    with record_function("mesh.all_to_all"):
        for m, pl in enumerate(places):
            out.append(torch.cat([
                _move(parts[j] if w is None else
                      parts[j].narrow(split_dim, m * w, w), owners[j], pl,
                      keys) for j in src], cat_dim))
    _note("all-to-all", out)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, split_dim, cat_dim, *parts):
        ctx.dims = split_dim, cat_dim
        ctx.places = [_place_of(p) for p in parts]
        ctx.keys = _Keys()
        return tuple(_relayout(parts, split_dim, cat_dim,
                               range(len(parts)), ctx.places, ctx.keys))

    @staticmethod
    def backward(ctx, *grads):
        split_dim, cat_dim = ctx.dims
        return (None, None, *_relayout(grads, cat_dim, split_dim,
                                       range(len(grads)), ctx.places,
                                       ctx.keys.backward()))


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
    return _relayout([p.detach() for p in parts], split_dim, cat_dim, src,
                     [_place_of(p) for p in parts], _Keys())


def _dest(to) -> Place:
    """The place of ``to``: a tensor at the destination position, or a
    device of this process."""
    if isinstance(to, Tensor):
        return _place_of(to)
    return torch.device(to), process.process_index()


def send(x: Tensor, to, *, copy: bool = True) -> Tensor:
    """``x`` copied to ``to`` (no gradient): a point-to-point transfer,
    the reference's collective-permute. ``to``: a tensor at the
    destination position (across processes), or a device of this
    process. ``copy=False`` returns ``x`` itself where it already is
    there."""
    with record_function("mesh.send"):
        out = _move(x.detach(), process.owner(x), _dest(to), _Keys(),
                    copy=copy)
    _note("collective-permute", [out])
    return out


class _SumTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dst_device, dst_owner, *parts):
        ctx.places = [_place_of(p) for p in parts]
        ctx.dtypes = [p.dtype for p in parts]
        ctx.dst = (dst_device, dst_owner)
        ctx.keys = _Keys()
        with record_function("mesh.sum_to"):
            return _fixed_sum(parts, _owners(ctx.places), ctx.dst, ctx.keys)

    @staticmethod
    def backward(ctx, g):
        keys = ctx.keys.backward()
        with record_function("mesh.sum_to"):
            out = [_move(g, ctx.dst[1], pl, keys, t)
                   for pl, t in zip(ctx.places, ctx.dtypes)]
        _note("sum_to", out)
        return (None, None, *out)


def sum_to(parts: Sequence[Tensor], device) -> Tensor:
    """The fixed-order sum of ``parts`` on ``device`` (each part is read
    once); its backward copies the cotangent to every part. ``device``: a
    device of this process, or a tensor at the destination; a device
    another process owns (``meta``) is the first part's position."""
    if isinstance(device, Tensor):
        dev, owner = _place_of(device)
    else:
        dev = torch.device(device)
        owner = (process.owner(parts[0]) if dev.type == "meta"
                 else process.process_index())
    if len(parts) == 1 and process.owner(parts[0]) == owner:
        return parts[0].to(dev)
    out = _SumTo.apply(dev, owner, *parts)
    if len(parts) > 1:
        _note("sum_to", [out])
    return out


def everywhere(x: Tensor, mesh: Mesh) -> Tensor:
    """``x`` (one position's value) on every process, on its first device
    (no gradient): the value a process reads where another holds it,
    such as the loss. On a one-process mesh ``x`` itself."""
    if mesh.process_count == 1:
        return x
    src, me, keys = process.owner(x), mesh.process, _Keys()
    with record_function("mesh.everywhere"):
        for r in range(mesh.process_count):
            key = keys()
            if r == src:
                continue
            if src == me:
                _send(x.detach(), r, key)
            elif r == me:
                out = _recv(x, mesh.local_device, src, key)
        if src == me:
            out = x.detach().to(mesh.local_device, copy=True)
    return out


@torch.no_grad()
def copy_into(dst: Tensor, x: Tensor, mesh: Mesh, pos: int) -> None:
    """In place: ``dst`` (mesh position ``pos``'s tensor) takes ``x`` (one
    position's value), copied across processes where they differ; a
    no-op where this process does not own ``pos``."""
    keys = _Keys()
    src, owner = process.owner(x), mesh.owner(pos)
    if src == owner == mesh.process:
        dst.copy_(x)
        return
    moved = _move(x.detach(), src, (mesh.devices.flat[pos], owner), keys)
    if owner == mesh.process:
        dst.copy_(moved)


def held(x: Tensor, mesh: Mesh, pos: int) -> Tensor:
    """A value every process holds (``x``, on one of its devices) at mesh
    position ``pos``: a copy there, or another process's placeholder."""
    if mesh.is_local(pos):
        return x.to(mesh.devices.flat[pos])
    return process.remote(x.shape, x.dtype, mesh.owner(pos))


# -- holders -------------------------------------------------------------------------


@torch.no_grad()
def reduce_holders_(st: ShardedTensor) -> ShardedTensor:
    """In place: every shard becomes the fixed-order sum (ascending
    position) of what its holders hold, the same bits on each."""
    mesh, me = st.mesh, st.mesh.process
    with record_function("mesh.reduce_holders"):
        for g in st.holders():
            if len(g) == 1:
                continue
            keys = _Keys()
            places = [(st.device(p), mesh.owner(p)) for p in g]
            owners = _owners(places)
            total = _fixed_sum([st.shards[p] for p in g], owners, places[0],
                               keys)
            for p, pl in zip(g, places):
                if pl[1] == owners[0] == me:
                    keys()
                    st.shards[p].copy_(total)
                    continue
                moved = _move(total, owners[0], pl, keys)
                if pl[1] == me:
                    st.shards[p].copy_(moved)
            _note("reduce_holders", [total] * len(g))
    return st


def replicas_equal(st: ShardedTensor) -> bool:
    """Whether every holder of each shard holds the same bits (across
    processes: every process's answer, agreed)."""
    mesh = st.mesh
    ok = True
    for g in st.holders():
        keys, src = _Keys(), mesh.owner(g[0])
        for p in g[1:]:
            pl = (st.device(p), mesh.owner(p))
            first = _move(st.shards[g[0]].detach(), src, pl, keys)
            if pl[1] == mesh.process:
                ok = ok and torch.equal(st.shards[p].detach(), first)
    return all(process.all_gather_object(ok))
