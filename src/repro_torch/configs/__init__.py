"""Architecture registry of the port (``--arch <id>``): the recsys family.
The LM and GNN architectures of the JAX package's registry wait for ROADMAP
A8; asking for one raises."""
from __future__ import annotations

from . import autoint, dlrm_rm2, wide_deep, xdeepfm
from .base import ArchSpec, ShapeCell, TensorSpec, input_specs

_MODULES = {
    "autoint": autoint,
    "wide-deep": wide_deep,
    "dlrm-rm2": dlrm_rm2,
    "xdeepfm": xdeepfm,
}

#: the JAX package's other architectures, by family: not ported yet
_NOT_PORTED = {
    "qwen2-moe-a2.7b": "lm",
    "granite-moe-3b-a800m": "lm",
    "qwen1.5-0.5b": "lm",
    "gemma2-2b": "lm",
    "granite-8b": "lm",
    "mace": "gnn",
}


def list_archs() -> list[str]:
    return sorted(_MODULES)


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id in _NOT_PORTED:
        raise ValueError(
            f"arch {arch_id!r} is of the {_NOT_PORTED[arch_id]} family, which "
            f"the port does not have yet (ROADMAP A8); ported: {list_archs()}")
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
