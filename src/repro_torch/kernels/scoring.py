"""Shared Zen/Lwb/Upb scoring + running-top-k helpers (plain PyTorch).

PyTorch counterpart of ``repro.kernels.scoring``: the estimator and the
top-k merge that every streaming search shares, so the plain versions of
the kernels cannot drift apart numerically. The Hopper kernels carry the
same two pieces in ``csrc/scoring.cuh``.

The estimator is the norm expansion over full squared norms (altitude
included) and a dot product over the first k-1 columns, plus a rank-1
altitude term for Lwb (-) and Upb (+); everything accumulates in f32 after
an in-register dequantisation (``scale``). Product-quantised tiles are
scored by a table gather instead (``lut_estimate_rows``).

Every sum here runs in an order fixed by its length alone (a pairwise tree
of elementwise adds), never a matmul or a library reduction, whose order
moves with the number of rows: a query row's distances then have the same
bits whatever batch it rides in, as the serving path requires.

The merge keeps ``lax.top_k``'s tie order: among equal distances the lower
position wins, and the running best sits before the new candidates. A
stable ascending sort of the concatenation gives exactly that order;
``torch.topk`` does not promise it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def fixed_sum(x: Tensor, dim: int = -1) -> Tensor:
    """Sum over ``dim`` in an order fixed by that axis's length alone.

    A pairwise tree of elementwise adds in float64 (the axis zero-padded to
    a power of two), rounded once to the input's f32 (or wider) dtype.
    Unlike ``torch.sum`` or a matmul, whose plan depends on how many
    outputs share the call, each output's bits depend only on its own
    inputs, on every device; and accumulating in f64 leaves only the final
    rounding, so the result sits as close to the JAX package's f32 sums as
    any order could.
    """
    out_dtype = torch.promote_types(x.dtype, torch.float32)
    x = x.movedim(dim, -1).to(torch.float64)
    n = x.shape[-1]
    if n == 0:
        return x.new_zeros(x.shape[:-1], dtype=out_dtype)
    width = 1 << (n - 1).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while width > 1:
        width //= 2
        x = x[..., :width] + x[..., width:]
    return x[..., 0].to(out_dtype)


def fixed_dot(a: Tensor, b: Tensor, dim: int = -1) -> Tensor:
    """:func:`fixed_sum` of the elementwise products ``a * b`` (broadcast),
    each product exact in float64."""
    out_dtype = torch.promote_types(torch.promote_types(a.dtype, b.dtype),
                                    torch.float32)
    return fixed_sum(a.to(torch.float64) * b.to(torch.float64),
                     dim).to(out_dtype)


#: estimator name -> integer id used inside kernel bodies
MODE_IDS = {"zen": 0, "lwb": 1, "upb": 2}


def _finish(z2: Tensor, qa: Tensor, xa: Tensor, mode: int) -> Tensor:
    if mode != 0:
        cross = 2.0 * qa * xa
        z2 = z2 - cross if mode == 1 else z2 + cross
    return torch.sqrt(torch.clamp_min(z2, 0.0))


def estimate_tile(q: Tensor, x: Tensor, *, mode: int,
                  scale: Optional[Tensor] = None) -> Tensor:
    """Estimator distances between (bq, k) queries and a (bn, k) tile, f32.

    ``mode`` is the id from :data:`MODE_IDS`; ``scale`` (scalar or (bn, 1))
    dequantises the tile right after its cast to f32.
    """
    q = q.to(torch.float32)
    x = x.to(torch.float32)
    if scale is not None:
        x = x * scale.to(torch.float32)
    nq = fixed_dot(q, q)[:, None]                  # (bq, 1) full norms
    nx = fixed_dot(x, x)[None, :]                  # (1, bn)
    # altitude left out
    dot = fixed_dot(q[:, None, :-1], x[None, :, :-1])
    z2 = nq + nx - 2.0 * dot
    return _finish(z2, q[:, -1:], x[:, -1][None, :], mode)


def estimate_rows(q: Tensor, blk: Tensor, *, mode: int,
                  scale: Optional[Tensor] = None) -> Tensor:
    """Estimator distances between queries (Q, k) and per-query row tiles
    (Q, R, k) — the gathered shape of the clustered (IVF) search."""
    if scale is not None:
        blk = blk * scale
    qn = fixed_dot(q, q)[:, None]                  # (Q, 1)
    xn = fixed_dot(blk, blk)                       # (Q, R)
    dot = fixed_dot(q[:, None, :-1], blk[..., :-1])
    z2 = qn + xn - 2.0 * dot
    return _finish(z2, q[:, -1:], blk[..., -1], mode)


def lut_estimate_rows(luts: Tensor, codes: Tensor) -> Tensor:
    """PQ estimator distances from per-query tables: (Q, M, E) f32 ADC
    tables of the probed cluster and (Q, R, M) integer codes -> (Q, R).

    ``sum_m luts[q, m, codes[q, r, m]]`` is the squared estimator distance
    (the mode is folded into the tables by ``pq.build_luts``).
    """
    idx = codes.long().transpose(1, 2)                   # (Q, M, R)
    g = torch.gather(luts.to(torch.float32), 2, idx)
    return torch.sqrt(torch.clamp_min(fixed_sum(g, dim=1), 0.0))


def mask_invalid(d: Tensor, ids: Tensor) -> Tensor:
    """+inf out candidate slots whose id is negative (padding, tombstones)."""
    return torch.where(ids >= 0, d, torch.full_like(d, float("inf")))


def merge_topk(best_d: Tensor, best_i: Tensor, d: Tensor, ids: Tensor,
               k: int) -> Tuple[Tensor, Tensor]:
    """Merge new candidates into the running best-k, ascending.

    ``best_d``/``best_i`` are the (Q, w) running state, ``d``/``ids`` the
    new (Q, r) candidates (``ids`` may be (1, r) and is broadcast). A
    stable sort of ``[best, new]`` keeps ``lax.top_k``'s tie order.
    """
    cat_d = torch.cat([best_d, d], dim=1)
    cat_i = torch.cat([best_i, ids.expand(d.shape[0], -1)], dim=1)
    cat_d, pos = torch.sort(cat_d, dim=1, stable=True)
    return cat_d[:, :k], torch.gather(cat_i, 1, pos[:, :k])
