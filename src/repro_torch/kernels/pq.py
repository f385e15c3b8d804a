"""Per-cluster-residual product quantizer — the "pq" storage mode.

PyTorch counterpart of ``repro.kernels.pq``. Each IVF member stores, in
place of its k f32 coordinates, M uint8 codes: its residual against its
coarse centroid is split into M subspaces of ``ds = ceil(k / M)`` columns
(zero-padded to M * ds) and each sub-vector is snapped to the nearest of
256 codebook entries, trained per subspace by ``index.kmeans``.

At query time :func:`build_luts` makes, for every (query, probed cluster)
pair, an (M, 256) table of per-subspace squared distances, so that the
estimator's squared distance to a member decoding to ``c + decode(code)``
is ``sum_m lut[m, code[m]]``. The Lwb/Upb altitude term is folded into the
table of the subspace that holds the altitude column, so the probe kernel
needs no mode. Everything but ``build_luts`` runs on the control plane.
"""
from __future__ import annotations

from typing import Optional

import torch

from .scoring import fixed_sum

Tensor = torch.Tensor

#: codebook entries per subspace — one uint8 code addresses exactly this
PQ_ENTRIES = 256

#: target subspace width of :func:`default_m` (4 dims per code byte)
_TARGET_DS = 4


def default_m(kdim: int) -> int:
    """The default subspace count: ``max(1, k // 4)`` (k=16 -> M=4)."""
    return max(1, kdim // _TARGET_DS)


def subspace_dims(kdim: int, m: int) -> int:
    """ds = ceil(k / M), the per-subspace width (columns padded to M*ds)."""
    if not 1 <= m <= kdim:
        raise ValueError(f"pq_m must be in [1, k={kdim}], got {m}")
    return -(-kdim // m)


def split_subspaces(x: Tensor, m: int) -> Tensor:
    """(n, k) -> (n, M, ds) f32 subspace view, zero-padded to M*ds."""
    x = x.to(torch.float32)
    n, kdim = x.shape
    ds = subspace_dims(kdim, m)
    x = torch.nn.functional.pad(x, (0, m * ds - kdim))
    return x.reshape(n, m, ds)


def train_codebooks(
    residuals: Tensor,
    m: int,
    *,
    generator: Optional[torch.Generator] = None,
    init: Optional[Tensor] = None,
    n_iters: int = 15,
) -> Tensor:
    """Fit (M, 256, ds) f32 codebooks on (n, k) residuals, one Lloyd's fit
    per subspace (``index.kmeans.kmeans_fit``).

    ``init`` (M, min(n, 256), ds) gives each subspace's initial centroids;
    otherwise they are k-means++ draws from ``generator``. With fewer than
    256 rows the trailing entries repeat entry 0: a duplicate entry never
    wins an ``argmin`` tie (the first occurrence does), so codes stay in
    the trained range.
    """
    from repro_torch.index.kmeans import kmeans_fit  # index imports kernels

    sub = split_subspaces(residuals, m)          # (n, M, ds)
    n, _, ds = sub.shape
    books = torch.zeros((m, PQ_ENTRIES, ds), dtype=torch.float32,
                        device=residuals.device)
    if n == 0:
        return books
    entries = min(PQ_ENTRIES, n)
    for i in range(m):
        books[i, :entries], _ = kmeans_fit(
            sub[:, i, :], entries, generator=generator,
            init=None if init is None else init[i], n_iters=n_iters)
        if entries < PQ_ENTRIES:
            books[i, entries:] = books[i, 0]
    return books


def encode(residuals: Tensor, codebooks: Tensor) -> Tensor:
    """(n, k) f32 residuals -> (n, M) uint8 nearest-entry codes."""
    from repro_torch.index.kmeans import kmeans_assign

    m, entries, _ = codebooks.shape
    if entries != PQ_ENTRIES:
        raise ValueError(f"codebooks must have {PQ_ENTRIES} entries, got "
                         f"{tuple(codebooks.shape)}")
    sub = split_subspaces(residuals, m)
    codes = torch.zeros((sub.shape[0], m), dtype=torch.uint8,
                        device=residuals.device)
    if sub.shape[0] == 0:
        return codes
    for i in range(m):
        codes[:, i] = kmeans_assign(sub[:, i, :], codebooks[i]).to(
            torch.uint8)
    return codes


def decode(codes: Tensor, codebooks: Tensor, kdim: int) -> Tensor:
    """(n, M) uint8 codes -> (n, k) f32 reconstructed residuals."""
    m, _, ds = codebooks.shape
    if codes.dim() != 2 or codes.shape[1] != m:
        raise ValueError(f"codes must be (n, {m}), got {tuple(codes.shape)}")
    sub = torch.arange(m, device=codes.device)[None, :]
    gathered = codebooks.to(torch.float32)[sub, codes.long()]  # (n, M, ds)
    return gathered.reshape(codes.shape[0], m * ds)[:, :kdim]


def code_bytes(n: int, m: int) -> int:
    """Resident bytes of n members' codes (the compression numerator)."""
    return n * m


def build_luts(queries: Tensor, centroids: Tensor, codebooks: Tensor,
               probes: Tensor, mode: int) -> Tensor:
    """Per-(query, probed cluster) ADC tables — (Q, P, M, 256) f32.

    ``sum_m lut[q, p, m, code[m]]`` is the squared estimator distance
    (``mode`` an id of ``scoring.MODE_IDS``) between query q and a member of
    cluster ``probes[q, p]`` that decodes to ``centroid + decode(code)``.
    The base table is the squared Euclidean distance, which is the Lwb
    estimator; Zen adds ``2 q_alt x_alt`` and Upb ``4 q_alt x_alt``, folded
    into the table of the subspace that holds the altitude column
    (``x_alt`` is affine in the codeword).
    """
    q_n, kdim = queries.shape
    m, _, ds = codebooks.shape
    kp = m * ds
    qf = queries.to(torch.float32)
    cf = centroids.to(torch.float32)
    qp = torch.nn.functional.pad(qf, (0, kp - kdim))
    cp = torch.nn.functional.pad(cf, (0, kp - kdim))
    cb = codebooks.to(torch.float32)
    pr = probes.long()
    r = (qp[:, None, :] - cp[pr]).reshape(q_n, pr.shape[1], m, ds)
    # the squared distances in their difference form, summed in float64
    # in a fixed order (scoring.fixed_sum): a query's tables keep their
    # bits whatever batch it rides in
    diff = (r[:, :, :, None, :].to(torch.float64)
            - cb[None, None].to(torch.float64))           # (Q, P, M, E, ds)
    lut = fixed_sum(diff * diff).to(torch.float32)       # (Q, P, M, E)
    if mode != 1:
        ma, da = (kdim - 1) // ds, (kdim - 1) % ds
        qa = qf[:, -1]                                   # (Q,)
        ca = cf[:, -1][pr]                               # (Q, P)
        cba = cb[ma, :, da]                              # (E,)
        cross = qa[:, None, None] * (ca[..., None] + cba[None, None])
        mult = 2.0 if mode == 0 else 4.0
        lut[:, :, ma, :] += mult * cross
    return lut
