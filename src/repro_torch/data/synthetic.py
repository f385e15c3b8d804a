"""Synthetic data generators (PyTorch counterpart of ``repro.data.synthetic``).

Draws come from a ``torch.Generator``: the distributions are the JAX
package's, the bits are not (``jax.random`` streams cannot be replayed).
"""
from __future__ import annotations

import math
from typing import Optional

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


def uniform_space(n: int, dim: int, *, generator: torch.Generator) -> Tensor:
    """Uniform [0, 1) vectors, on the generator's device (paper §5.3)."""
    return torch.rand((n, dim), generator=generator, device=generator.device)


def gaussian_space(n: int, dim: int, *, generator: torch.Generator) -> Tensor:
    """Standard normal vectors, on the generator's device (paper §5.3)."""
    return torch.randn((n, dim), generator=generator,
                       device=generator.device)


def relu_feature_space(n: int, dim: int, intrinsic: int, *,
                       generator: torch.Generator) -> Tensor:
    """Non-negative CNN-activation-like data (the cosine experiments)."""
    return torch.relu(manifold_space(n, dim, intrinsic, generator=generator))


def probability_space(n: int, dim: int, intrinsic: Optional[int] = None, *,
                      generator: torch.Generator) -> Tensor:
    """l1-normalised positive vectors, the Jensen-Shannon domain (paper
    §5.6): uniform draws, or softplus of a manifold when ``intrinsic`` is
    given; on the generator's device."""
    if intrinsic is None:
        x = uniform_space(n, dim, generator=generator)
    else:
        x = torch.nn.functional.softplus(
            manifold_space(n, dim, intrinsic, generator=generator))
    return x / torch.clamp_min(torch.sum(x, dim=1, keepdim=True), 1e-12)
