"""Pairwise Jensen-Shannon distances: Hopper kernel + plain version.

PyTorch counterpart of ``repro.kernels.jsd`` (``jsd_pdist``,
``src/repro/kernels/jsd.py:72``): l1-normalised rows (N, m) x (K, m) ->
(N, K) f32,

  D = sqrt(clip(1 - 0.5 * sum_l [h(v_l) + h(w_l) - h(v_l + w_l)], 0, 1)),
  h(t) = -t log2(t), h(0) = 0  (paper App. A.3).

The clip to [0, 1] is the TPU kernel's; ``core.metrics.jsd_pdist`` clamps
at 0 only, and both keep their own.

  ``jsd_pdist``        the wrapper of the CUDA kernel ``csrc/jsd.cu``
                       (Hopper, sm_90a). CUDA tensors only; launches are
                       counted in ``jsd_pdist.launches``.
  ``jsd_pdist_plain``  the plain PyTorch version: the broadcast formula,
                       one block of X's rows at a time.

``kernels.ops.jsd_pdist`` picks between them by the tensors' device.
"""
from __future__ import annotations

import torch

from . import _build
from .pdist import kernel_operands

Tensor = torch.Tensor


def jsd_pdist(X: Tensor, Y: Tensor) -> Tensor:
    """Hopper kernel: (N, m) x (K, m) l1-normalised rows -> (N, K) f32
    Jensen-Shannon distances. Raises for CPU tensors, a dtype other than
    f32/bf16, and when the launch fails."""
    X, Y, dtype = kernel_operands(X, Y, "jsd_pdist", "jsd_pdist_plain")
    n, m = X.shape
    k = Y.shape[0]
    out = torch.empty((n, k), dtype=torch.float32, device=X.device)
    if n == 0 or k == 0:
        return out
    lib = _build.load("jsd")
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.jsd_pdist_launch(X.data_ptr(), Y.data_ptr(), dtype, n, k, m,
                                   out.data_ptr(), stream)
    _build.check(lib, err, "jsd_pdist launch")
    jsd_pdist.launches += 1
    return out


jsd_pdist.launches = 0


def _h(t: Tensor) -> Tensor:
    safe = torch.where(t > 0, t, torch.ones_like(t))
    return torch.where(t > 0, -t * torch.log2(safe), torch.zeros_like(t))


def jsd_pdist_plain(X: Tensor, Y: Tensor, *, budget: int = 1 << 26
                    ) -> Tensor:
    """Plain PyTorch version: the broadcast formula in f32 over blocks of
    X's rows, each block's (rows, K, m) term tensor at most ``budget``
    entries."""
    X = X.to(torch.float32)
    Y = Y.to(torch.float32)
    hx = torch.sum(_h(X), dim=1)
    hy = torch.sum(_h(Y), dim=1)
    out = torch.empty((X.shape[0], Y.shape[0]), dtype=torch.float32,
                      device=X.device)
    chunk = max(1, budget // max(Y.shape[0] * Y.shape[1], 1))
    for s in range(0, X.shape[0], chunk):
        cross = torch.sum(_h(X[s:s + chunk, None, :] + Y[None, :, :]), dim=-1)
        K = 1.0 - 0.5 * (hx[s:s + chunk, None] + hy[None, :] - cross)
        out[s:s + chunk] = torch.sqrt(torch.clamp(K, 0.0, 1.0))
    return out
