"""Synthetic data generators (PyTorch counterpart of ``repro.data.synthetic``).

Draws come from a ``torch.Generator``: the distributions are the JAX
package's, the bits are not (``jax.random`` streams cannot be replayed).
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def manifold_space(n: int, dim: int, intrinsic: int, noise: float = 0.01,
                   *, generator: torch.Generator) -> Tensor:
    """Data on an ``intrinsic``-dimensional nonlinear manifold embedded in
    R^dim — the GloVe/CNN-feature stand-in (paper §5.4).

    Drawn on the generator's device, so a CUDA generator builds a large
    corpus on the card without a host round trip.
    """
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    z = normal(n, intrinsic)
    w1 = normal(intrinsic, 2 * intrinsic) / math.sqrt(intrinsic)
    w2 = normal(2 * intrinsic, dim) / math.sqrt(2 * intrinsic)
    x = torch.tanh(z @ w1) @ w2
    return x + noise * normal(n, dim)
