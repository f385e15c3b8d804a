"""Host meshes for the trainer (PyTorch counterpart of
``repro.launch.mesh``).

``make_host_mesh(data, model)`` lays a (data, model) mesh with axes
``("data", "model")`` over the cards there are (``distributed.mesh.
make_mesh``): on data x model distinct cards when there are that many,
else as logical shards of the current card, or of the CPU with
``device="cpu"``. The reference's production mesh (``make_production_mesh``,
16 x 16 and 2 x 16 x 16 chips) comes with the dry-run (ROADMAP A, item 3b).
"""
from __future__ import annotations

from repro_torch.distributed.mesh import Mesh, make_mesh


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A (data, model) mesh over whatever devices exist."""
    return make_mesh((data, model), ("data", "model"), device=device)
