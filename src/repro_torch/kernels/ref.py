"""Plain PyTorch oracles of the dense kernels, in the reference's own form.

PyTorch counterpart of ``repro.kernels.ref`` (its three dense oracles):
broadcasting formulas that reuse nothing of the kernels or of their plain
versions, so the tests can hold both to an independent statement of what
each computes. They build the (N, M, m) or (N, M, k) broadcast: small
inputs only.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def pdist_sq_ref(X: Tensor, Y: Tensor) -> Tensor:
    X = X.to(torch.float32)
    Y = Y.to(torch.float32)
    d2 = (torch.sum(X * X, 1)[:, None] + torch.sum(Y * Y, 1)[None, :]
          - 2.0 * (X @ Y.T))
    return torch.clamp_min(d2, 0.0)


def zen_estimate_ref(X: Tensor, Y: Tensor, mode: str = "zen") -> Tensor:
    X = X.to(torch.float32)
    Y = Y.to(torch.float32)
    base = torch.sum((X[:, None, :-1] - Y[None, :, :-1]) ** 2, dim=-1)
    xa, ya = X[:, -1], Y[:, -1]
    if mode == "zen":
        z2 = base + (xa ** 2)[:, None] + (ya ** 2)[None, :]
    elif mode == "lwb":
        z2 = base + (xa[:, None] - ya[None, :]) ** 2
    elif mode == "upb":
        z2 = base + (xa[:, None] + ya[None, :]) ** 2
    else:
        raise ValueError(mode)
    return torch.sqrt(torch.clamp_min(z2, 0.0))


def _h(t: Tensor) -> Tensor:
    safe = torch.where(t > 0, t, torch.ones_like(t))
    return torch.where(t > 0, -t * torch.log2(safe), torch.zeros_like(t))


def jsd_pdist_ref(X: Tensor, Y: Tensor) -> Tensor:
    X = X.to(torch.float32)
    Y = Y.to(torch.float32)
    hx = torch.sum(_h(X), dim=1)
    hy = torch.sum(_h(Y), dim=1)
    cross = torch.sum(_h(X[:, None, :] + Y[None, :, :]), dim=-1)
    K = 1.0 - 0.5 * (hx[:, None] + hy[None, :] - cross)
    return torch.sqrt(torch.clamp(K, 0.0, 1.0))
