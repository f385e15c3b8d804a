"""PyTorch + CUDA port of the nSimplex Zen serving stack (Hopper kernels).

Mirrors the layout of the JAX package ``repro`` (``core/``, ``kernels/``,
``index/``, ``launch/``, ``serving/``, ``data/``) so each module has an
obvious counterpart; the JAX package stays the numerical reference. This
package imports neither ``jax`` nor anything of ``repro``.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; with no card they raise instead of falling back quietly.

The JAX reference accumulates every matmul in full float32
(``preferred_element_type``), so TF32 is switched off for both the matmul
and the cuDNN paths here, explicitly, at import.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or
    by default) and none is present: the port never drops to the CPU
    without being told to.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev

