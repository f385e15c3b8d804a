"""Pairwise squared Euclidean distances: Hopper kernel + plain version.

PyTorch counterpart of ``repro.kernels.pdist`` (``pdist_sq``,
``src/repro/kernels/pdist.py:52``): (N, m) x (K, m) -> (N, K) f32,
``max(|x|^2 + |y|^2 - 2 <x, y>, 0)``, inputs f32 or bf16 cast to f32.

  ``pdist_sq``        the wrapper of the CUDA kernel ``csrc/pdist.cu``
                      (Hopper, sm_90a). It takes CUDA tensors only and
                      counts its launches in ``pdist_sq.launches``.
  ``pdist_sq_plain``  the plain PyTorch version: the same f32 norm
                      expansion, one block of rows at a time. The CPU path
                      and the kernel's checks use it.

``kernels.ops.pdist_sq`` picks between them by the tensors' device. This
module also holds the operand checks the three dense kernels share.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build

Tensor = torch.Tensor

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_operands(X: Tensor, Y: Tensor, what: str,
                    plain: str) -> Tuple[Tensor, Tensor, int]:
    """(X, Y, dtype code) of a dense kernel's launch: both CUDA tensors on
    one device, 2-d of equal width, f32 or bf16 (X's dtype; Y is cast to
    it), contiguous. Raises on what the kernels do not take."""
    if not (X.is_cuda and Y.is_cuda):
        raise ValueError(f"{what} launches the CUDA kernel and takes CUDA "
                         f"tensors; {plain} is the plain version")
    if X.device != Y.device:
        raise ValueError(f"{what}: X on {X.device}, Y on {Y.device}")
    if X.dim() != 2 or Y.dim() != 2 or X.shape[1] != Y.shape[1]:
        raise ValueError(f"{what} takes (N, m) and (K, m), got "
                         f"{tuple(X.shape)} and {tuple(Y.shape)}")
    if X.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what} takes {tuple(_DTYPE_CODES)}, got "
                         f"{X.dtype}")
    if X.shape[1] >= 2 ** 31:
        raise ValueError(f"{what} takes m < 2**31 features, got "
                         f"{tuple(Y.shape)}")
    return (X.contiguous(), Y.to(X.dtype).contiguous(),
            _DTYPE_CODES[X.dtype])


def pdist_sq(X: Tensor, Y: Tensor) -> Tensor:
    """Hopper kernel: (N, m) x (K, m) -> (N, K) f32 squared distances.

    Raises for CPU tensors, a dtype other than f32/bf16, and when the
    launch fails.
    """
    X, Y, dtype = kernel_operands(X, Y, "pdist_sq", "pdist_sq_plain")
    n, m = X.shape
    k = Y.shape[0]
    out = torch.empty((n, k), dtype=torch.float32, device=X.device)
    if n == 0 or k == 0:
        return out
    lib = _build.load("pdist")
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.pdist_sq_launch(X.data_ptr(), Y.data_ptr(), dtype, n, k, m,
                                  out.data_ptr(), stream)
    _build.check(lib, err, "pdist_sq launch")
    pdist_sq.launches += 1
    return out


pdist_sq.launches = 0


def pdist_sq_plain(X: Tensor, Y: Tensor, *, chunk: int = 65_536) -> Tensor:
    """Plain PyTorch version: ``|x|^2 + |y|^2 - 2 x @ y.T`` in f32, clamped
    at 0, ``chunk`` rows of X at a time (its memory bound)."""
    Y = Y.to(torch.float32)
    y2 = torch.sum(Y * Y, dim=1)
    out = torch.empty((X.shape[0], Y.shape[0]), dtype=torch.float32,
                      device=X.device)
    for s in range(0, X.shape[0], chunk):
        x = X[s:s + chunk].to(torch.float32)
        d2 = torch.sum(x * x, dim=1)[:, None] + y2[None, :] - 2.0 * (x @ Y.T)
        out[s:s + chunk] = torch.clamp_min(d2, 0.0)
    return out
