"""Architecture registry of the port (``--arch <id>``): the LM and recsys
families. The JAX package's GNN architecture (``mace``) waits for ROADMAP
A, item 2; asking for it raises."""
from __future__ import annotations

from . import (
    autoint,
    dlrm_rm2,
    gemma2_2b,
    granite_8b,
    granite_moe_3b_a800m,
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
    "autoint": autoint,
    "wide-deep": wide_deep,
    "dlrm-rm2": dlrm_rm2,
    "xdeepfm": xdeepfm,
}

#: the JAX package's other architectures, by family, with the ROADMAP item
#: that ports them
_NOT_PORTED = {
    "mace": ("gnn", "ROADMAP A, item 2"),
}


def list_archs() -> list[str]:
    return sorted(_MODULES)


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id in _NOT_PORTED:
        family, item = _NOT_PORTED[arch_id]
        raise ValueError(
            f"arch {arch_id!r} is of the {family} family, which the port "
            f"does not have yet ({item}); ported: {list_archs()}")
    try:
        return _MODULES[arch_id].spec()
    except KeyError:
        raise ValueError(
            f"unknown arch {arch_id!r}; available: {list_archs()}"
        ) from None


__all__ = [
    "ArchSpec",
    "ShapeCell",
    "TensorSpec",
    "input_specs",
    "get_arch",
    "list_archs",
]
