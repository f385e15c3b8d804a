"""Hopper kernels, their plain PyTorch versions and the storage codec.

Importing this package builds nothing: a kernel is compiled (``_build``)
the first time a CUDA tensor reaches it. The dense distance matrices are
exported here, as ``repro.kernels`` exports them; each dispatches by the
tensors' device (``ops``). The name ``pdist`` here is that function, as
in ``repro.kernels.ops``; the kernel module of the same name is reached as
``from repro_torch.kernels.pdist import pdist_sq, pdist_sq_plain``.
"""
from .ops import jsd_pdist, pdist, pdist_sq, zen_estimate

__all__ = ["pdist_sq", "pdist", "zen_estimate", "jsd_pdist"]
