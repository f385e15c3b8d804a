"""A device mesh for sharded retrieval and training.

PyTorch counterpart of what the serving path reads from
``jax.sharding.Mesh`` (``devices``, ``devices.size``, ``axis_names``,
``shape[axis]``) and of ``repro.launch.mesh.make_host_mesh``. One process
owns every device of the mesh, as in the reference: the per-shard kernels
launch on each shard's device and the candidate lists meet on the first
(``distributed.retrieval``).

A mesh may also span processes (``--multihost``: one process a host,
:func:`make_process_mesh`): each position has an owning process
(``owner(pos)``), laid out process-major, and a position another process
owns is listed on the ``meta`` device, a placeholder. The serving path's
meshes stay single-controller.

A mesh may list one device more than once. :func:`make_mesh` puts S
logical shards on one device (one card, or the CPU) when fewer cards than
shards are present; this is the counterpart of XLA's
``--xla_force_host_platform_device_count``, and it is how the CPU tests
and a one-card run drive an S-shard merge.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device

AxisNames = Union[str, Sequence[str]]


class Mesh:
    """Devices laid out on named axes.

    Attributes:
      devices:    numpy object array of ``torch.device``, shaped as the mesh
                  (one axis a name); ``meta`` at another process's position.
      axis_names: the axes' names, in the order of ``devices``' axes.
      owners:     the process owning each position (row-major; all 0 on
                  one process).
      process:    this process's index.
    """

    def __init__(self, devices, axis_names: AxisNames, *,
                 owners: Optional[Sequence[int]] = None, process: int = 0):
        names = (axis_names,) if isinstance(axis_names, str) \
            else tuple(axis_names)
        arr = np.asarray(devices, dtype=object)
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [torch.device(d) for d in arr.ravel()]
        if arr.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(f"a mesh of shape {arr.shape} needs {arr.ndim} "
                             f"distinct axis names, got {names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = flat.reshape(arr.shape)
        self.axis_names = names
        self.owners = (np.zeros(arr.size, dtype=np.int64) if owners is None
                       else np.asarray(owners, dtype=np.int64).reshape(-1))
        self.process = process
        self.process_count = int(self.owners.max()) + 1

    def owner(self, pos: int) -> int:
        """The process owning mesh position ``pos``."""
        return int(self.owners[pos])

    def is_local(self, pos: int) -> bool:
        return int(self.owners[pos]) == self.process

    @property
    def local_positions(self) -> Tuple[int, ...]:
        """The positions this process owns, in order."""
        return tuple(int(p) for p in
                     np.flatnonzero(self.owners == self.process))

    @property
    def local_device(self) -> torch.device:
        """This process's first device (the mesh's first device on one
        process): where it draws weights and batches."""
        return self.devices.flat[self.local_positions[0]]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first_device(self) -> torch.device:
        """Where the merged answers of a sharded search live."""
        return self.devices.flat[0]

    def shard_devices(self, axis_names: Optional[AxisNames] = None
                      ) -> Tuple[torch.device, ...]:
        """The device of each shard of rows sharded over ``axis_names``
        (default all axes), the shards linearised in that order, the first
        axis slowest; the mesh's other axes are taken at their first
        index, as rows are replicated along them."""
        names = self.axis_names if axis_names is None else (
            (axis_names,) if isinstance(axis_names, str)
            else tuple(axis_names))
        unknown = [a for a in names if a not in self.axis_names]
        if unknown:
            raise ValueError(f"axes {unknown} are not in the mesh's "
                             f"{self.axis_names}")
        lead = [self.axis_names.index(a) for a in names]
        rest = [i for i in range(self.devices.ndim) if i not in lead]
        n = math.prod(self.devices.shape[i] for i in lead)
        arr = np.transpose(self.devices, lead + rest).reshape(n, -1)
        return tuple(arr[:, 0])

    def __repr__(self) -> str:
        extra = (f", process {self.process} of {self.process_count}"
                 if self.process_count > 1 else "")
        return (f"Mesh({dict(self.shape)}, devices="
                f"{[str(d) for d in self.devices.flat]}{extra})")


def make_mesh(shape: Union[int, Sequence[int]] = 1, axis: AxisNames = "shard",
              device=None) -> Mesh:
    """A mesh of ``shape`` (an int for one axis) with axes ``axis``.

    ``device`` "cuda" (the default, which raises without a card) spans the
    first cards when there are at least as many as the mesh has shards,
    else puts every shard on the current card; an explicit device
    ("cpu", "cuda:1") puts every shard on it.
    """
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    n = math.prod(shape)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {shape}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        if torch.cuda.device_count() >= n:
            devices = [torch.device("cuda", i) for i in range(n)]
        else:
            devices = [torch.device("cuda", torch.cuda.current_device())] * n
    else:
        devices = [dev] * n
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), names)


def make_process_mesh(shape: Sequence[int], axis: AxisNames, *, process: int,
                      count: int, devices: Sequence[torch.device]) -> Mesh:
    """A mesh of ``shape`` over ``count`` processes, this one ``process``
    owning ``devices``: positions laid out process-major, as
    ``jax.devices()`` orders them (process r owns positions r L .. (r + 1)
    L - 1, L = positions / count). Its L positions go over its devices by
    :func:`make_mesh`'s rule: distinct devices when it has that many,
    else logical shards of the first; another process's positions are
    ``meta``."""
    n = math.prod(shape)
    if n % count:
        raise ValueError(f"a mesh of {tuple(shape)} ({n} positions) does not "
                         f"split over {count} processes")
    L = n // count
    devices = list(devices)
    mine = devices[:L] if len(devices) >= L else [devices[0]] * L
    flat = np.empty(n, dtype=object)
    flat[:] = [torch.device("meta")] * n
    flat[process * L:(process + 1) * L] = mine
    return Mesh(flat.reshape(tuple(shape)), axis,
                owners=np.arange(n) // L, process=process)
