"""Pairwise squared Euclidean distances: Hopper kernel + plain version.

PyTorch counterpart of ``repro.kernels.pdist`` (``pdist_sq``,
``src/repro/kernels/pdist.py:52``): (N, m) x (K, m) -> (N, K) f32,
``max(|x|^2 + |y|^2 - 2 <x, y>, 0)``, inputs f32 or bf16 cast to f32.

  ``pdist_sq``        the wrapper of the CUDA kernel ``csrc/pdist.cu``
                      (Hopper, sm_90a). It takes CUDA tensors only and
                      counts its launches in ``pdist_sq.launches``.
  ``pdist_plan``      the launch planner: which of the kernel's three plans
                      (``"mma"``, ``"narrow"``, ``"simt"``) a shape takes,
                      and its tile, stages and grid.
  ``pdist_sq_plain``  the plain PyTorch version: the same f32 norm
                      expansion, one block of rows at a time. The CPU path
                      and the kernel's checks use it.

``kernels.ops.pdist_sq`` picks between them by the tensors' device. This
module also holds the operand checks the three dense kernels share.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import _build

Tensor = torch.Tensor

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_operands(X: Tensor, Y: Tensor, what: str,
                    plain: str) -> Tuple[Tensor, Tensor, int]:
    """(X, Y, dtype code) of a dense kernel's launch: both CUDA tensors on
    one device, 2-d of equal width, each f32 or bf16, contiguous. Operands
    of one dtype launch in it; where they differ, both launch as f32 (bf16
    to f32 is exact), so each keeps its own values, as in the TPU kernels,
    which cast each operand to f32 on its own. Raises on what the kernels
    do not take."""
    if not (X.is_cuda and Y.is_cuda):
        raise ValueError(f"{what} launches the CUDA kernel and takes CUDA "
                         f"tensors; {plain} is the plain version")
    if X.device != Y.device:
        raise ValueError(f"{what}: X on {X.device}, Y on {Y.device}")
    if X.dim() != 2 or Y.dim() != 2 or X.shape[1] != Y.shape[1]:
        raise ValueError(f"{what} takes (N, m) and (K, m), got "
                         f"{tuple(X.shape)} and {tuple(Y.shape)}")
    for A in (X, Y):
        if A.dtype not in _DTYPE_CODES:
            raise ValueError(f"{what} takes {tuple(_DTYPE_CODES)}, got "
                             f"{A.dtype}")
    if X.shape[1] >= 2 ** 31:
        raise ValueError(f"{what} takes m < 2**31 features, got "
                         f"{tuple(Y.shape)}")
    return launch_operands(X, Y)


def launch_operands(X: Tensor, Y: Tensor) -> Tuple[Tensor, Tensor, int]:
    """(X, Y, dtype code) as a dense kernel launches f32 or bf16 operands:
    in their dtype where they share one, else both as f32 (never an operand
    rounded down), contiguous."""
    if X.dtype != Y.dtype:
        X, Y = X.float(), Y.float()
    return X.contiguous(), Y.contiguous(), _DTYPE_CODES[X.dtype]


# -- the launch plan -----------------------------------------------------------

#: the SMs of an H100 SXM: the default of the planner's ``n_sms``
H100_SMS = 132
#: the MMA plan (csrc/pdist.cu, namespace mma): 128 x 128 output tiles,
#: 128 bytes of each row a stage (X's rows, Y's rows and, in f32, the low
#: parts of Y's split), at most 4 stages, a tile's distances 64 KB in
#: shared memory on their way to the TMA stores
MMA_TILE = 128
MMA_ROW_BYTES = 128
MMA_MAX_STAGES = 4
MMA_OUT_BYTES = MMA_TILE * MMA_TILE * 4
#: shared memory a block may take (H100: 227 KB)
SMEM_LIMIT = 232_448
#: the dense tiles of csrc/dense_tile.cuh: (rows, columns) of a block's
#: output, 32 feature columns a step; grid y holds at most 65,535 column
#: tiles a launch
NARROW_TILE = (256, 16)
SIMT_TILE = (64, 64)
DENSE_CHUNK = 32
_KERNELS = {"simt": 0, "narrow": 0, "mma": 1}  # narrow iff K <= 16


def mma_stage_bytes(es: int) -> int:
    """Bytes of an MMA-plan stage for operands of ``es`` bytes: 128 rows of
    X and of Y, 128 bytes each, and in f32 the low parts of Y's split
    (csrc/pdist.cu, mma::stage_bytes)."""
    return (3 if es == 4 else 2) * MMA_TILE * MMA_ROW_BYTES


def mma_smem(es: int, stages: int) -> int:
    """Dynamic shared bytes of an MMA-plan block: 1 KB of alignment slack,
    the ring of ``stages`` stages, the output tile, two tiles' row norms and
    the mbarriers (csrc/pdist.cu, mma::smem_bytes)."""
    return (1024 + stages * mma_stage_bytes(es) + MMA_OUT_BYTES
            + 2 * 2 * MMA_TILE * 4 + 8 * MMA_MAX_STAGES)


@dataclass(frozen=True)
class PdistPlan:
    """The geometry of one ``pdist_sq`` launch; the launcher takes every
    field the kernel needs as an argument.

    ``kernel`` names the plan. ``"mma"``: a persistent grid of ``grid``
    blocks (one an SM) walks the ``tile`` (rows x columns) output tiles
    through a ring of ``stages`` TMA stages of ``chunk`` features; two
    warpgroups take the products with wgmma on the tensor cores
    (``route``: split TF32 for f32, one bf16 product for bf16); a tile's
    distances leave by TMA stores from an output tile in shared memory;
    ``smem`` bytes of dynamic shared memory. ``"narrow"`` (K <= 16) and
    ``"simt"`` (rows the TMA cannot read or write: operand rows or bases,
    or output rows, off 16 bytes): the dense tiles of csrc/dense_tile.cuh
    on the CUDA cores in f32, ``grid`` blocks of one 256-thread tile each,
    ``chunk`` features a step; ``stages`` and ``smem`` are 0.
    """
    kernel: str
    tile: Tuple[int, int]
    chunk: int
    stages: int
    grid: int
    smem: int
    route: str


def _blocks(n: int, k: int, tile: Tuple[int, int]) -> int:
    return -(-n // tile[0]) * -(-k // tile[1])


def dense_plan(n: int, k: int, m: int) -> PdistPlan:
    """The dense tile that serves (n, k, m) on the CUDA cores: the narrow
    tile for K <= 16, else the SIMT square tile."""
    kernel, tile = ("narrow", NARROW_TILE) if k <= 16 else \
        ("simt", SIMT_TILE)
    return PdistPlan(kernel=kernel, tile=tile, chunk=DENSE_CHUNK, stages=0,
                     grid=_blocks(n, k, tile), smem=0,
                     route="f32 on the CUDA cores")


@functools.lru_cache(maxsize=1024)
def pdist_plan(n: int, k: int, m: int, dtype: torch.dtype = torch.float32,
               aligned: bool = True, *, n_sms: int = H100_SMS) -> PdistPlan:
    """The plan of a launch of (n, m) x (k, m) operands of ``dtype`` on a
    card of ``n_sms`` SMs; cached. ``aligned``: both operands start on a
    16-byte boundary (their rows then do too where ``m`` allows).

    K <= 16 takes the narrow tile (the transform's references). Otherwise
    the MMA plan, where the TMA can read the operands' rows and write the
    output's: 16-byte aligned bases and rows (m % 4 == 0 in f32, m % 8 == 0
    in bf16; K % 4 == 0), m >= 1, and n and k below 2**31 (32-bit box
    coordinates); every other shape takes the SIMT tile. The MMA plan's
    shared memory holds a ring and the output tile: three stages in f32
    (48 KB each), four in bf16 (32 KB each).
    """
    es = 4 if dtype == torch.float32 else 2
    if k <= 16 or not aligned or m < 1 or (m * es) % 16 or k % 4 \
            or max(n, k) >= 2 ** 31:
        return dense_plan(n, k, m)
    stages = 3 if es == 4 else 4
    return PdistPlan(kernel="mma", tile=(MMA_TILE, MMA_TILE),
                     chunk=MMA_ROW_BYTES // es, stages=stages,
                     grid=min(_blocks(n, k, (MMA_TILE, MMA_TILE)), n_sms),
                     smem=mma_smem(es, stages),
                     route="3xTF32 on the tensor cores" if es == 4
                     else "bf16 on the tensor cores")


def operands_aligned(X: Tensor, Y: Tensor) -> bool:
    """Both operands start on a 16-byte boundary."""
    return X.data_ptr() % 16 == 0 and Y.data_ptr() % 16 == 0


@functools.lru_cache(maxsize=None)
def _n_sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def pdist_sq(X: Tensor, Y: Tensor, *,
             plan: Optional[PdistPlan] = None) -> Tensor:
    """Hopper kernel: (N, m) x (K, m) -> (N, K) f32 squared distances.

    ``plan`` replaces the planner's (tests and timings compare the plans).
    Raises for CPU tensors, a dtype other than f32/bf16, and when the
    launch fails.
    """
    X, Y, dtype = kernel_operands(X, Y, "pdist_sq", "pdist_sq_plain")
    n, m = X.shape
    k = Y.shape[0]
    out = torch.empty((n, k), dtype=torch.float32, device=X.device)
    if n == 0 or k == 0:
        return out
    dev = X.device
    if plan is None:
        plan = pdist_plan(n, k, m, X.dtype, operands_aligned(X, Y),
                          n_sms=_n_sms(dev))
    lib = _build.load("pdist")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pdist_sq_launch(X.data_ptr(), Y.data_ptr(), dtype, n, k, m,
                                  _KERNELS[plan.kernel], plan.grid,
                                  plan.stages, plan.smem, out.data_ptr(),
                                  stream)
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
