"""Clustered (IVF) index: k-means quantizer, packed inverted-list tiles,
the exact re-rank."""
from .ivf import (
    IVF_SNAPSHOT_KIND,
    IVFZenIndex,
    ShardedIVFZenIndex,
    TieredIVFZenIndex,
    exact_rerank,
)
from .kmeans import kmeans_assign, kmeans_fit

__all__ = ["IVF_SNAPSHOT_KIND", "IVFZenIndex", "ShardedIVFZenIndex",
           "TieredIVFZenIndex", "exact_rerank", "kmeans_assign",
           "kmeans_fit"]
