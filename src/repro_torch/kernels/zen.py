"""Dense Zen/Lwb/Upb estimator matrix: Hopper kernel + plain version.

PyTorch counterpart of ``repro.kernels.zen`` (``zen_estimate``,
``src/repro/kernels/zen.py:60``): projected points (N, k) x (M, k), last
column the altitude -> (N, M) f32 estimator distances (paper §4.1).

  ``zen_estimate``        the wrapper of the CUDA kernel
                          ``csrc/zen_estimate.cu`` (Hopper, sm_90a), which
                          scores with ``csrc/scoring.cuh`` as ``zen_topk``
                          does. CUDA tensors only; launches are counted in
                          ``zen_estimate.launches``.
  ``zen_estimate_plain``  the plain PyTorch version: ``scoring.estimate_tile``
                          (the estimator the top-k plain versions use), one
                          block of rows at a time.

``kernels.ops.zen_estimate`` picks between them by the tensors' device.
"""
from __future__ import annotations

import torch

from . import _build
from .pdist import kernel_operands
from .scoring import MODE_IDS
from .scoring import estimate_tile

Tensor = torch.Tensor


def _check_mode(mode: str) -> None:
    if mode not in MODE_IDS:
        raise ValueError(f"mode must be one of {tuple(MODE_IDS)}, got "
                         f"{mode!r}")


def zen_estimate(X: Tensor, Y: Tensor, mode: str = "zen") -> Tensor:
    """Hopper kernel: (N, k) x (M, k) -> (N, M) f32 estimator distances.

    Takes f32 or bf16 coordinates of any width k >= 1 (the kernel stages
    256 columns at a time). Raises for CPU tensors, k = 0, and when the
    launch fails.
    """
    _check_mode(mode)
    X, Y, dtype = kernel_operands(X, Y, "zen_estimate", "zen_estimate_plain")
    n, k = X.shape
    m = Y.shape[0]
    if k < 1:
        raise ValueError(f"the zen_estimate kernel takes k >= 1, got k={k}")
    out = torch.empty((n, m), dtype=torch.float32, device=X.device)
    if n == 0 or m == 0:
        return out
    lib = _build.load("zen_estimate")
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.zen_estimate_launch(X.data_ptr(), Y.data_ptr(), dtype, n, m,
                                      k, MODE_IDS[mode], out.data_ptr(),
                                      stream)
    _build.check(lib, err, "zen_estimate launch")
    zen_estimate.launches += 1
    return out


zen_estimate.launches = 0


def zen_estimate_plain(X: Tensor, Y: Tensor, mode: str = "zen", *,
                       budget: int = 1 << 26) -> Tensor:
    """Plain PyTorch version: the norm expansion of
    ``scoring.estimate_tile`` over blocks of X's rows, each block's
    (rows, M, k) products at most ``budget`` entries."""
    _check_mode(mode)
    out = torch.empty((X.shape[0], Y.shape[0]), dtype=torch.float32,
                      device=X.device)
    chunk = max(1, budget // max(Y.shape[0] * Y.shape[1], 1))
    for s in range(0, X.shape[0], chunk):
        out[s:s + chunk] = estimate_tile(X[s:s + chunk], Y,
                                         mode=MODE_IDS[mode])
    return out
