"""Clustered (IVF) index: k-means quantizer, packed inverted-list tiles,
the exact re-rank."""
from .ivf import IVFZenIndex, ShardedIVFZenIndex, TieredIVFZenIndex
from .ivf import exact_rerank
from .kmeans import kmeans_assign, kmeans_fit

__all__ = ["IVFZenIndex", "ShardedIVFZenIndex", "TieredIVFZenIndex",
           "exact_rerank", "kmeans_assign", "kmeans_fit"]
