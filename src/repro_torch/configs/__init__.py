"""Architecture registry of the port (``--arch <id>``): the LM, GNN and
recsys families, every architecture of the JAX package."""
from __future__ import annotations

from . import (
    autoint,
    dlrm_rm2,
    gemma2_2b,
    granite_8b,
    granite_moe_3b_a800m,
    mace,
    qwen1_5_0_5b,
    qwen2_moe_a2_7b,
    wide_deep,
    xdeepfm,
)
from .base import ArchSpec, ShapeCell, TensorSpec, input_specs

_MODULES = {
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "qwen1.5-0.5b": qwen1_5_0_5b,
    "gemma2-2b": gemma2_2b,
    "granite-8b": granite_8b,
    "mace": mace,
    "autoint": autoint,
    "wide-deep": wide_deep,
    "dlrm-rm2": dlrm_rm2,
    "xdeepfm": xdeepfm,
}


def list_archs() -> list[str]:
    return sorted(_MODULES)


def get_arch(arch_id: str) -> ArchSpec:
    try:
        return _MODULES[arch_id].spec()
    except KeyError:
        raise ValueError(
            f"unknown arch {arch_id!r}; available: {list_archs()}"
        ) from None


def all_cells() -> list[tuple[str, str]]:
    """Every (arch_id, shape) pair in the assignment grid (40 total), in
    the reference's order: what the dry-run's ``--all`` walks."""
    return [(aid, cell.shape) for aid in list_archs()
            for cell in get_arch(aid).cells]


__all__ = [
    "ArchSpec",
    "ShapeCell",
    "TensorSpec",
    "input_specs",
    "get_arch",
    "list_archs",
    "all_cells",
]
