"""Index helpers shared by the flat path (the IVF index is not ported yet)."""
from .ivf import exact_rerank

__all__ = ["exact_rerank"]
