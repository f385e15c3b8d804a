"""Meshes for the trainer, the plans and the dry-run (PyTorch counterpart
of ``repro.launch.mesh``).

``make_host_mesh(data, model)`` lays a (data, model) mesh with axes
``("data", "model")`` over the cards there are (``distributed.mesh.
make_mesh``): on data x model distinct cards when there are that many,
else as logical shards of the current card, or of the CPU with
``device="cpu"``. After ``distributed.process.initialize`` (``--multihost``)
it spans every process: process r owns positions r L .. (r + 1) L - 1
(L = data x model / processes), on its own cards by the same rule
(``distributed.mesh.make_process_mesh``).

``make_production_mesh`` is the reference's production mesh: (16, 16) =
256 cards with axes ("data", "model"), or with ``multi_pod`` (2, 16, 16)
= 512 cards with axes ("pod", "data", "model"), the ``pod`` axis
extending data parallelism across pods. On cards it needs that many;
with ``device="meta"`` its positions are placeholders that hold no
storage, on which the dry-run (``launch.dryrun``) traces the plans: the
counterpart of the reference's ``--xla_force_host_platform_device_count=
512``. It is a function, never a module-level constant, so importing this
module touches no device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.distributed import process
from repro_torch.distributed.mesh import Mesh, make_mesh, make_process_mesh


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A (data, model) mesh over whatever devices exist (every process's,
    after ``process.initialize``)."""
    w = process.world()
    if w is not None:
        return make_process_mesh(
            (data, model), ("data", "model"), process=w.index,
            count=w.count, devices=w.cards or [w.device])
    return make_mesh((data, model), ("data", "model"), device=device)


def production_shape(multi_pod: bool = False) -> tuple:
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The production mesh: 256 (or, ``multi_pod``, 512) positions.

    ``device`` "cuda" (the default) takes the first 256 / 512 cards and
    raises, naming the count, when there are fewer; "meta" gives
    placeholder positions (no storage: the dry-run's fake shards)."""
    shape, axes = production_shape(multi_pod)
    n = math.prod(shape)
    if device is not None and torch.device(device).type == "meta":
        devices = [torch.device("meta")] * n
    else:
        dev = resolve_device(device)
        found = torch.cuda.device_count() if dev.type == "cuda" else 0
        if found < n:
            raise RuntimeError(
                f"mesh {shape} needs {n} cards, found {found}; the dry-run "
                "traces it on placeholder positions "
                "(make_production_mesh(device='meta'))")
        devices = [torch.device("cuda", i) for i in range(n)]
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axes)
