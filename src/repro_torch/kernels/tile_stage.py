"""Host -> device staging of packed tile blocks: Hopper kernel + plain version.

PyTorch counterpart of ``repro.kernels.tile_stage``. The tiered tile store
(``index.ivf.TieredIVFZenIndex``) keeps most packed tiles in a host pool and
uploads only the blocks a probe batch needs; :func:`stage_blocks` is its one
upload primitive. It dispatches by the *target* device, since the source is
always host memory:

  * ``cuda``: :func:`dma_copy_blocks`, the CUDA kernel of
    ``csrc/tile_stage.cu``, which reads a pinned (page-locked, device-
    addressable) host tensor over the host link and writes a new device
    tensor, byte for byte, on the current stream. It launches or raises:
    nothing falls back to a library copy.
  * ``cpu``: :func:`dma_copy_blocks_plain`, a plain copy.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from . import _build

Tensor = torch.Tensor


def dma_copy_blocks(src: Tensor, device=None) -> Tensor:
    """Hopper kernel: a new tensor on the CUDA ``device`` holding the bytes
    of the (B, ...) pinned host tensor ``src``.

    The copy runs asynchronously on ``device``'s current stream and reads
    ``src`` while it runs: the caller keeps ``src`` alive and unwritten
    until the stream has passed the copy. Raises for a non-CUDA target, a
    source that is not a contiguous pinned CPU tensor, and when the launch
    fails.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError("dma_copy_blocks launches the CUDA kernel and takes "
                         "a CUDA target; dma_copy_blocks_plain is the plain "
                         "version")
    if src.device.type != "cpu" or not src.is_pinned():
        raise ValueError("dma_copy_blocks reads page-locked host memory: "
                         "give it a pinned CPU tensor (pin_memory=True), not "
                         "pageable memory")
    if src.dim() < 1 or not src.is_contiguous():
        raise ValueError(f"dma_copy_blocks takes a contiguous (B, ...) block "
                         f"array, got shape {tuple(src.shape)}")
    out = torch.empty(src.shape, dtype=src.dtype, device=dev)
    if src.numel() == 0:
        return out
    n_blocks = src.shape[0]
    block_bytes = src.numel() // n_blocks * src.element_size()
    lib = _build.load("tile_stage")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tile_stage_launch(src.data_ptr(), out.data_ptr(),
                                    block_bytes, n_blocks, stream)
    _build.check(lib, err, "tile_stage launch")
    dma_copy_blocks.launches += 1
    return out


dma_copy_blocks.launches = 0


def dma_copy_blocks_plain(src: Union[np.ndarray, Tensor], device) -> Tensor:
    """Plain version of :func:`dma_copy_blocks`: ``src`` (host array or
    tensor) copied onto ``device``; a CPU target gets a copy of its own."""
    dev = torch.device(device)
    out = torch.as_tensor(src).to(dev)
    if dev.type == "cpu":
        out = out.clone()
    return out


def pinned_like(host_vals: np.ndarray) -> Tensor:
    """A pinned CPU tensor holding a copy of ``host_vals`` (a host-side
    memcpy; a memory-mapped array is read here)."""
    host_vals = np.asarray(host_vals)
    dtype = torch.from_numpy(np.empty(0, host_vals.dtype)).dtype
    pinned = torch.empty(host_vals.shape, dtype=dtype, pin_memory=True)
    pinned.numpy()[...] = host_vals
    return pinned


def stage_blocks(host_vals: Union[np.ndarray, Tensor], device) -> Tensor:
    """Upload one (B, ...) block buffer to ``device``.

    A CUDA target launches :func:`dma_copy_blocks`: a tensor (which must be
    pinned) is copied as it is and asynchronously (the caller keeps it
    unwritten until the stream passes the copy); a numpy array is first
    copied into a fresh pinned buffer on the host, and the call then waits
    for the copy, since the buffer is freed on return. A CPU target takes
    the plain version.
    """
    dev = torch.device(device)
    if dev.type != "cuda":
        return dma_copy_blocks_plain(host_vals, dev)
    if isinstance(host_vals, Tensor):
        return dma_copy_blocks(host_vals, dev)
    out = dma_copy_blocks(pinned_like(host_vals), dev)
    torch.cuda.current_stream(out.device).synchronize()
    return out
