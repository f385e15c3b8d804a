"""Shape-bucketed dispatch of the serving path (the scheduler is not ported yet)."""
from .scheduler import (
    DEFAULT_NEIGHBOR_MENU, MIN_Q_BUCKET, bucket_neighbors, bucket_q,
)

__all__ = ["DEFAULT_NEIGHBOR_MENU", "MIN_Q_BUCKET", "bucket_neighbors",
           "bucket_q"]
