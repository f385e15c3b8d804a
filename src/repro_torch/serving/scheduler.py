"""Shape-bucketed dispatch: the part of ``repro.serving.scheduler`` that the
direct serving path uses.

Every query is served at bucketed shapes: the row count is padded to a
power-of-two Q bucket (floor 2) and ``n_neighbors`` is rounded up to a
fixed width menu, then sliced back. The micro-batching scheduler itself is
not ported yet.
"""
from __future__ import annotations

from typing import Optional, Sequence

#: fixed output-width menu: requested n_neighbors is rounded up to the next
#: entry (and to the next power of two beyond the menu)
DEFAULT_NEIGHBOR_MENU = (8, 16, 32, 64, 128)

#: smallest dispatched row count, as in the JAX package
MIN_Q_BUCKET = 2


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def bucket_q(q: int, max_batch: Optional[int] = None) -> int:
    """Power-of-two row bucket for a dispatch of ``q`` real rows.

    >>> [bucket_q(q) for q in (1, 2, 3, 8, 9)]
    [2, 2, 4, 8, 16]
    """
    b = max(_next_pow2(max(q, 1)), MIN_Q_BUCKET)
    return min(b, max_batch) if max_batch else b


def bucket_neighbors(
    n: int, menu: Sequence[int] = DEFAULT_NEIGHBOR_MENU
) -> int:
    """Round a requested ``n_neighbors`` up to the fixed width menu.

    >>> [bucket_neighbors(n) for n in (1, 8, 10, 100, 200)]
    [8, 8, 16, 128, 256]
    """
    for m in menu:
        if n <= m:
            return int(m)
    return _next_pow2(n)
