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

The merge keeps ``lax.top_k``'s tie order: among equal distances the lower
position wins, and the running best sits before the new candidates. A
stable ascending sort of the concatenation gives exactly that order;
``torch.topk`` does not promise it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor

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
    nq = torch.sum(q * q, dim=1, keepdim=True)     # (bq, 1) full norms
    nx = torch.sum(x * x, dim=1)[None, :]          # (1, bn)
    dot = q[:, :-1] @ x[:, :-1].T                  # altitude left out
    z2 = nq + nx - 2.0 * dot
    return _finish(z2, q[:, -1:], x[:, -1][None, :], mode)


def estimate_rows(q: Tensor, blk: Tensor, *, mode: int,
                  scale: Optional[Tensor] = None) -> Tensor:
    """Estimator distances between queries (Q, k) and per-query row tiles
    (Q, R, k) — the gathered shape of the clustered (IVF) search."""
    if scale is not None:
        blk = blk * scale
    qn = torch.sum(q * q, dim=1, keepdim=True)     # (Q, 1)
    xn = torch.sum(blk * blk, dim=-1)              # (Q, R)
    dot = torch.einsum("qk,qrk->qr", q[:, :-1], blk[..., :-1])
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
    return torch.sqrt(torch.clamp_min(torch.sum(g, dim=1), 0.0))


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
