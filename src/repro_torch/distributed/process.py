"""The processes of a multi-host run (PyTorch counterpart of
``jax.distributed.initialize()``): one process a host, each owning its
host's cards, together holding one mesh.

:func:`initialize` reads the standard environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, as ``python -m torch.distributed.run`` sets them)
and starts a ``torch.distributed`` process group with a finite timeout,
so a transfer nobody matches fails the run instead of hanging it.

* **Cards.** The host's visible cards are split evenly by ``LOCAL_RANK``
  / ``LOCAL_WORLD_SIZE``: two processes on a four-card host own cards 0-1
  and 2-3; one process a host owns them all. With fewer cards than
  processes on a host, the processes share a card (logical shards of it).
* **Backend.** NCCL when every process owns distinct cards; gloo
  otherwise (the CPU, or processes sharing a card). The rule decides,
  once; nothing switches backend after a failure. A host-side gloo group
  (``control``) carries the small agreements (step times, flags,
  barriers) whatever the backend.
* **Transfers.** Only byte copies cross processes (:func:`send`,
  :func:`recv`): every sum stays where the one-process mesh takes it
  (``distributed.partition``). Each transfer carries a key from the
  forward's fixed order; gloo matches it by ``tag``, and on NCCL, which
  matches a pair's transfers by issue order, both ends fold the keys
  into a digest that :func:`check_transfers` compares at every
  synchronisation: a transfer matched out of order fails the run. NCCL
  transfers go through the process's first card (one communicator a
  process); gloo's through host memory.
* **One backward thread.** :func:`initialize` turns the autograd engine's
  per-device threads off for the process, so every backward runs on the
  calling thread in descending sequence-number order: the reverse of the
  forward's order, the same in every process, so each pair of processes
  reaches its transfers in the same order whatever the cards' timing.

A position of the mesh another process owns is held here as a
:class:`Remote` placeholder: a ``meta`` tensor (shape and dtype, no
storage) that carries its owner through every operation, so the models'
per-position loops run unchanged and only real positions do work.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch import resolve_device

Tensor = torch.Tensor

#: the environment :func:`initialize` reads (``MASTER_*`` unless an
#: ``init_method`` is given)
ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK",
       "LOCAL_WORLD_SIZE")

#: seconds a collective may wait before the run fails
TIMEOUT_S = 600

_TAG_MOD = 2**31 - 1
_DIGEST_MOD = 2**61 - 1


@dataclasses.dataclass
class World:
    """This process's place among the processes of the run."""
    index: int
    count: int
    backend: str
    cards: Tuple[torch.device, ...]    # the cards it owns (none on the CPU)
    device: torch.device               # its first device
    control: object                    # a gloo group for host-side values
    sent: Dict[int, int] = dataclasses.field(default_factory=dict)
    received: Dict[int, int] = dataclasses.field(default_factory=dict)


_WORLD: Optional[World] = None


def _env_int(name: str) -> int:
    return int(os.environ[name])


def owned_cards(local_rank: int, local_count: int) -> Tuple[Tuple[int, ...],
                                                              bool]:
    """(the card indices the process owns, whether they are its alone):
    the visible cards split evenly over the host's processes, or, with
    fewer cards than processes, one card shared."""
    n = torch.cuda.device_count()
    if n >= local_count:
        k = n // local_count
        return tuple(range(local_rank * k, (local_rank + 1) * k)), True
    return (local_rank * n // local_count,), False


def initialize(device=None, *, init_method: Optional[str] = None,
               timeout_s: Optional[float] = None, log=print) -> World:
    """Join the run's process group (idempotent: a second call returns the
    first's ``World``). ``device`` "cuda" (the default) or "cpu";
    ``init_method`` replaces ``env://`` (a test's ``file://``)."""
    global _WORLD
    if _WORLD is not None:
        return _WORLD
    need = [k for k in ENV if init_method is None or
            not k.startswith("MASTER_")]
    missing = [k for k in need if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--multihost needs {', '.join(missing)} in the environment "
            "(python -m torch.distributed.run sets them)")
    rank, count = _env_int("RANK"), _env_int("WORLD_SIZE")
    local_rank, local_count = _env_int("LOCAL_RANK"), \
        _env_int("LOCAL_WORLD_SIZE")
    dev = resolve_device(device)
    if dev.type == "cuda":
        idx, alone = owned_cards(local_rank, local_count)
        cards = tuple(torch.device("cuda", i) for i in idx)
        torch.cuda.set_device(cards[0])
        backend = "nccl" if alone else "gloo"
    else:
        cards, backend = (), "gloo"
    timeout = datetime.timedelta(seconds=timeout_s or TIMEOUT_S)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=count, timeout=timeout)
    control = (dist.new_group(backend="gloo", timeout=timeout)
               if backend != "gloo" else dist.group.WORLD)
    torch.autograd.set_multithreading_enabled(False)
    _WORLD = World(rank, count, backend, cards, cards[0] if cards else dev,
                   control)
    log(f"[process {rank}/{count}] backend {backend}, cards "
        f"{[str(c) for c in cards] or ['cpu']}")
    return _WORLD


def shutdown() -> None:
    """Leave the process group (a test's worker ends with it)."""
    global _WORLD
    if _WORLD is not None:
        dist.destroy_process_group()
        torch.autograd.set_multithreading_enabled(True)
        _WORLD = None


def world() -> Optional[World]:
    return _WORLD


def process_index() -> int:
    return 0 if _WORLD is None else _WORLD.index


def process_count() -> int:
    return 1 if _WORLD is None else _WORLD.count


# -- transfers ----------------------------------------------------------------


def _fold(table: Dict[int, int], peer: int, key: int, t: Tensor) -> None:
    d = table.get(peer, 0)
    table[peer] = (d * 1_000_003 + key * 31 + t.numel() * t.element_size()
                   ) % _DIGEST_MOD


def send(t: Tensor, dst: int, key: int) -> None:
    """Copy ``t``'s bytes to process ``dst`` under ``key``."""
    w = _WORLD
    if w.backend == "nccl":
        buf = t.detach().to(w.device).contiguous()
    else:
        buf = t.detach().to("cpu").contiguous()
    _fold(w.sent, dst, key, buf)
    dist.send(buf, dst, tag=key % _TAG_MOD)


def recv(shape, dtype: torch.dtype, device, src: int, key: int) -> Tensor:
    """The tensor process ``src`` sent under ``key``, on ``device``."""
    w = _WORLD
    buf = torch.empty(tuple(shape), dtype=dtype,
                      device=w.device if w.backend == "nccl" else "cpu")
    _fold(w.received, src, key, buf)
    dist.recv(buf, src, tag=key % _TAG_MOD)
    return buf.to(device)


def all_gather_object(obj) -> list:
    """Every process's ``obj``, in process order (host-side, small)."""
    if _WORLD is None:
        return [obj]
    out = [None] * _WORLD.count
    dist.all_gather_object(out, obj, group=_WORLD.control)
    return out


def barrier() -> None:
    if _WORLD is not None:
        dist.barrier(group=_WORLD.control)


def check_transfers() -> None:
    """Raise unless every process received, from each peer, the keys and
    sizes that peer sent it, in the same order."""
    if _WORLD is None:
        return
    books = all_gather_object((dict(_WORLD.sent), dict(_WORLD.received)))
    bad = [(a, b) for a, (sent, _) in enumerate(books)
           for b in sent if books[b][1].get(a) != sent[b]]
    if bad:
        raise RuntimeError(f"transfers matched out of order between "
                           f"processes {bad}")


# -- positions another process owns ----------------------------------------------


class Remote(torch.Tensor):
    """A mesh position's tensor that process ``owner`` holds: its shape,
    dtype and strides on the ``meta`` device, no storage. Every operation
    on it runs on ``meta`` and gives a ``Remote`` of the same owner, so a
    per-position loop runs here on such positions at no cost. A
    ``Remote`` meeting a tensor of a real device (other than a 0-d
    constant), or one of another owner, raises: the only way between
    processes is ``distributed.partition``'s transfers."""

    @staticmethod
    def __new__(cls, elem: Tensor, owner: int):
        out = torch.Tensor._make_wrapper_subclass(
            cls, elem.shape, strides=elem.stride(),
            storage_offset=elem.storage_offset(), dtype=elem.dtype,
            device=elem.device, requires_grad=elem.requires_grad)
        out.elem, out.owner = elem, owner
        return out

    def __repr__(self) -> str:
        return (f"Remote(owner={self.owner}, shape={tuple(self.shape)}, "
                f"dtype={self.dtype})")

    __torch_function__ = torch._C._disabled_torch_function_impl

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        flat, spec = tree_flatten((args, kwargs or {}))
        owners, key, elems = set(), [func, spec], []
        for x in flat:
            if isinstance(x, Remote):
                owners.add(x.owner)
                x = x.elem
            elif isinstance(x, Tensor) and x.device.type != "meta":
                if x.dim():
                    raise RuntimeError(
                        f"{func}: a tensor on {x.device} meets a position "
                        "of another process; cross-process copies go "
                        "through distributed.partition")
                x = x.to("meta")
            elems.append(x)
            key.append(_meta_key(x) if isinstance(x, Tensor) else x)
        if len(owners) > 1:
            raise RuntimeError(f"{func} mixes positions of processes "
                               f"{sorted(owners)}")
        (owner,) = owners
        dest = (kwargs or {}).get("device")
        if dest is not None and torch.device(dest).type != "meta":
            raise RuntimeError(
                f"{func}: a position of process {owner} copied to {dest}; "
                "cross-process copies go through distributed.partition")
        try:
            key = tuple(key)
            made = _MADE.get(key)
        except TypeError:  # an argument that does not hash: no memo
            key, made = None, None
        if made is None:
            made = _run_on_meta(func, elems, spec)
            if key is not None:
                _MADE[key] = made
        out_spec, outs = made
        leaves = []
        for kind, what in outs:
            if kind == "alias":      # an in-place or out= result
                leaves.append(flat[what])
            elif kind == "new":
                leaves.append(Remote(_meta_like(*what), owner))
            else:
                leaves.append(what)
        return tree_unflatten(leaves, out_spec)


#: what an operation on meta tensors gives, by its arguments' metadata: a
#: meta output is a function of them alone, so a repeated operation (every
#: layer's, every step's) is answered without running the meta kernel
_MADE: dict = {}


def _meta_key(t: Tensor) -> tuple:
    return ("tensor", tuple(t.shape), t.stride(), t.storage_offset(),
            t.dtype)


def _meta_like(shape, stride, offset, dtype) -> Tensor:
    size = offset + sum((n - 1) * st for n, st in zip(shape, stride)) + 1 \
        if all(shape) else 0
    base = torch.empty((max(size, 0),), dtype=dtype, device="meta")
    return base.as_strided(shape, stride, offset if size else 0)


def _run_on_meta(func, elems: list, spec) -> tuple:
    """(the output's tree spec, each output leaf: ("alias", argument
    index), ("new", tensor metadata) or ("value", v))."""
    args, kwargs = tree_unflatten(elems, spec)
    if func is torch.ops.aten.nonzero.default:
        # data-dependent: no rows (the shapes after it are static)
        out = torch.empty((0, args[0].dim()), dtype=torch.long,
                          device="meta")
    else:
        out = func(*args, **kwargs)
    flat, out_spec = tree_flatten(out)
    ids = {id(e): i for i, e in enumerate(elems) if isinstance(e, Tensor)}
    outs = []
    for x in flat:
        if isinstance(x, Tensor):
            if id(x) in ids:
                outs.append(("alias", ids[id(x)]))
            else:
                outs.append(("new", (tuple(x.shape), x.stride(),
                                     x.storage_offset(), x.dtype)))
        else:
            outs.append(("value", x))
    return out_spec, outs


def remote(shape, dtype: torch.dtype, owner: int) -> Tensor:
    """A placeholder for a ``shape`` x ``dtype`` tensor process ``owner``
    holds."""
    return Remote(torch.empty(tuple(shape), dtype=dtype, device="meta"),
                  owner)


def owner(t: Tensor) -> int:
    """The process holding ``t``: a ``Remote``'s owner, else this one."""
    return t.owner if isinstance(t, Remote) else process_index()


def is_remote(t) -> bool:
    return isinstance(t, Remote)
