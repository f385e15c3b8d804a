"""Tie-aware comparison of top-k results, for the tests and the smoke run.

Two correct top-k searches over the same data may disagree where two
candidates' distances tie within float noise: their order, or which one
fills the last slot, can swap. ``topk_mismatch`` accepts exactly those
swaps and nothing else.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def topk_mismatch(d, ids, d_ref, ids_ref, *, rtol: float,
                  atol: float) -> Optional[str]:
    """Why (d, ids) is not the top-k (d_ref, ids_ref) up to near-ties, or
    ``None`` when it is.

    Distances must agree slot by slot within ``atol + rtol * |d_ref|``.
    Where the ids differ, the id found must either sit elsewhere in the
    reference row at a distance within that tolerance of this slot, or be
    absent from it with a distance that ties the reference's last slot.
    """
    d, ids, d_ref, ids_ref = map(_np, (d, ids, d_ref, ids_ref))
    if d.shape != d_ref.shape or ids.shape != ids_ref.shape:
        return f"shapes differ: {d.shape}/{ids.shape} vs {d_ref.shape}"
    close = np.isclose(d, d_ref, rtol=rtol, atol=atol)
    if not close.all():
        r, c = np.argwhere(~close)[0]
        return (f"{int((~close).sum())} distances differ, first at "
                f"[{r}, {c}]: {d[r, c]!r} vs {d_ref[r, c]!r}")
    for r in range(ids.shape[0]):
        live = ids[r][ids[r] >= 0]
        if live.size != np.unique(live).size:
            return f"row {r} repeats an id: {ids[r]}"
        for c in np.flatnonzero(ids[r] != ids_ref[r]):
            tol = atol + rtol * abs(d_ref[r, c])
            where = np.flatnonzero(ids_ref[r] == ids[r, c])
            if where.size:
                ok = abs(d_ref[r, where[0]] - d_ref[r, c]) <= tol
            else:
                ok = d[r, c] >= d_ref[r, -1] - tol
            if not ok:
                return (f"row {r} slot {c}: id {ids[r, c]} instead of "
                        f"{ids_ref[r, c]} is not a near-tie "
                        f"(d {d[r, c]!r}, reference {d_ref[r, c]!r})")
    return None


# -- the dense kernels against their plain versions --------------------------

#: pdist_sq and zen_estimate agree in squared space within SQ_RTOL x
#: (|x|^2 + |y|^2): both evaluate the f32 norm expansion, whose two sums
#: (norms, dot) round in another order on each path; their error is a few
#: 2^-24 of that scale per chunk of summed terms, ~1e-6 at m = 1000.
SQ_RTOL = 1e-5
#: jsd_pdist agrees on K = D^2 within JSD_KTOL absolute: K is one minus half
#: a difference of three f32 sums of m entropy terms (each sum at most
#: log2(m) + 1, ~11 at m = 1000), rounded in another order on each path.
JSD_KTOL = 1e-5
#: the distances themselves then agree within sqrt(tolerance), since
#: |sqrt(a) - sqrt(b)| <= sqrt(|a - b|): near D = 0 (close or identical
#: rows) the square root turns an error e in D^2 into up to sqrt(e) in D.

#: (N, K, m) shapes of the pdist_sq sweep: aligned, ragged everything, m
#: off the 32-column chunk, N or K of 1, and K <= 16 (the narrow tile)
PDIST_CASES = [(8, 8, 16), (128, 128, 512), (100, 37, 129), (256, 64, 1000),
               (1, 5, 3), (130, 257, 640), (1000, 16, 256), (777, 13, 33),
               (5, 1, 70)]
#: (N, K, m) shapes at the edges of pdist_sq's launch plans
#: (kernels/pdist.py::pdist_plan), in f32 and bf16: K = 16 (narrow tile),
#: 17 and 130 (output rows off 16 bytes: SIMT tile) and 20 (MMA plan); m %
#: 4 != 0 (f32: SIMT tile) and m % 8 != 0 (bf16: SIMT tile, f32: MMA plan
#: with a last k-step half zero fill); N or K of 1; m past one 32- or
#: 64-feature stage with a ragged last stage; ragged tiles of 128; more
#: tiles (160) than the persistent grid's blocks; and m = 4,096 (128 stages
#: of the MMA plan)
PDIST_PLAN_CASES = [(300, 16, 64), (300, 17, 64), (300, 20, 64),
                    (300, 130, 64), (200, 132, 70), (200, 132, 36),
                    (1, 300, 64), (300, 1, 64), (1, 132, 36), (300, 200, 12),
                    (300, 200, 40), (129, 260, 100), (2048, 1200, 32),
                    (256, 256, 4096)]
#: (N, M, k) shapes of the zen_estimate sweep, k in {1, 2, 16, 130}
ZEN_CASES = [(n, m, k) for k in (1, 2, 16, 130)
             for n, m in ((16, 16), (100, 300), (7, 1), (65, 129))]
#: (N, K, m) shapes of the jsd_pdist sweep
JSD_CASES = [(8, 8, 48), (64, 64, 256), (40, 100, 100), (16, 16, 48),
             (128, 128, 513), (333, 16, 256), (1, 7, 513)]


def dense_inputs(kind: str, shape, seed: int, dtype, device):
    """(X, Y) of one case of a dense sweep, drawn from ``seed`` with numpy:
    normal rows for "pdist", normal coordinates with a non-negative last
    column (an altitude) for "zen", l1-normalised rows for "jsd", a
    third of whose entries are zero (0 log 0), and for "near" rows of norm
    ~1,000 that all lie within ~0.03 of one another (the norm expansion
    cancels |x|^2 + |y|^2 ~ 2e6 down to distances ~1e-3)."""
    import torch

    n, k, m = shape
    rng = np.random.default_rng(seed)
    if kind == "jsd":
        X, Y = rng.uniform(size=(n, m)), rng.uniform(size=(k, m))
        X[rng.uniform(size=X.shape) < 1 / 3] = 0.0
        Y[rng.uniform(size=Y.shape) < 1 / 3] = 0.0
        X[:, 0] += 1e-3  # no all-zero row
        Y[:, 0] += 1e-3
        X, Y = X / X.sum(1, keepdims=True), Y / Y.sum(1, keepdims=True)
    elif kind == "near":
        base = rng.standard_normal(m)
        base *= 1e3 / np.linalg.norm(base)
        X = base + 1e-3 * rng.standard_normal((n, m))
        Y = base + 1e-3 * rng.standard_normal((k, m))
    else:
        X, Y = rng.standard_normal((n, m)), rng.standard_normal((k, m))
        if kind == "zen":
            X[:, -1], Y[:, -1] = np.abs(X[:, -1]), np.abs(Y[:, -1])

    def tensor(a):
        return torch.from_numpy(a.astype(np.float32)).to(device, dtype)

    return tensor(X), tensor(Y)


def dense_errors(kind: str, X, Y, got, want):
    """(max error in squared space, max error on the distances, why they
    disagree or ``None``) of a dense kernel's output ``got`` against its
    plain version's ``want``. ``kind`` "pdist" compares squared distances
    as given; "zen" and "jsd" compare distances, squared for the check."""
    import torch

    got, want = got.double(), want.double()
    if got.shape != want.shape:
        return float("inf"), float("inf"), \
            f"shapes differ: {tuple(got.shape)} vs {tuple(want.shape)}"
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        return float("inf"), float("inf"), "a value is not finite"
    if kind == "pdist":
        sq, sq_want = got, want
        d_err = (got.sqrt() - want.sqrt()).abs().max()
    else:
        sq, sq_want = got * got, want * want
        d_err = (got - want).abs().max()
    if kind == "jsd":
        tol = torch.full_like(sq, JSD_KTOL)
    else:
        x2 = X.double().pow(2).sum(1)
        y2 = Y.double().pow(2).sum(1)
        tol = SQ_RTOL * (x2[:, None] + y2[None, :])
    err = (sq - sq_want).abs()
    bad = err > tol
    why = None
    if bad.any():
        r, c = (int(i) for i in torch.nonzero(bad)[0])
        why = (f"{int(bad.sum())} entries differ in squared space, first at "
               f"[{r}, {c}]: {float(sq[r, c])!r} vs "
               f"{float(sq_want[r, c])!r} (tolerance {float(tol[r, c]):.3g})")
    return float(err.max()) if err.numel() else 0.0, \
        float(d_err) if err.numel() else 0.0, why


# -- the LM's bf16 products --------------------------------------------------

#: ``models.layers.matmul_f32`` on bf16 operands against f32 products of the
#: same (bf16) values. The result is f32: within ACCUM_RTOL x (|a| @ |b|)
#: of the f32 product (the two sum the same exact products in another
#: order). Each gradient is that product with the cotangent (rounded to
#: bf16 on the card, where the gradient products are the same mixed call),
#: rounded once to bf16: within 2^-8 of its value (half a bf16 ulp, 8
#: significant bits) plus the accumulation term.
ACCUM_RTOL = 2**-16
BF16_ROUND = 2**-8


def matmul_f32_errors(a, b, g) -> dict:
    """For bf16 ``a`` (..., m, k) and ``b`` (k, n) or batched (z, k, n), and
    an f32 cotangent ``g`` of the result's shape: each of ``matmul_f32``'s
    result and two gradients as the largest ratio of its error to its
    bound (above). A ratio above 1 is a mismatch; a wrong dtype, shape or
    non-finite value gives ``inf``."""
    import torch

    from repro_torch.models.layers import matmul_f32

    a = a.detach().requires_grad_(True)
    b = b.detach().requires_grad_(True)
    out = matmul_f32(a, b)
    ga, gb = torch.autograd.grad(out, (a, b), g)
    af, bf = a.detach().double(), b.detach().double()
    gr = (g.to(a.dtype) if a.is_cuda else g).double()

    def ratio(got, dtype, want, bound):
        if (got.dtype != dtype or got.shape != want.shape
                or not torch.isfinite(got).all()):
            return float("inf")
        err = (got.detach().double() - want).abs()
        return float((err / bound.clamp_min(1e-30)).max())

    def t(x):
        return x.transpose(-1, -2)

    if b.dim() == 2:  # the leading dimensions of a flatten into rows
        af2, gr2 = af.reshape(-1, a.shape[-1]), gr.reshape(-1, b.shape[-1])
        want_ga = (gr2 @ t(bf)).reshape(a.shape)
        acc_ga = (gr2.abs() @ t(bf).abs()).reshape(a.shape)
        want_gb, acc_gb = t(af2) @ gr2, t(af2).abs() @ gr2.abs()
    else:
        want_ga, acc_ga = gr @ t(bf), gr.abs() @ t(bf).abs()
        want_gb, acc_gb = t(af) @ gr, t(af).abs() @ gr.abs()
    return {
        "out": ratio(out, torch.float32, af @ bf,
                     ACCUM_RTOL * (af.abs() @ bf.abs())),
        "grad_a": ratio(ga, a.dtype, want_ga,
                        BF16_ROUND * want_ga.abs() + ACCUM_RTOL * acc_ga),
        "grad_b": ratio(gb, b.dtype, want_gb,
                        BF16_ROUND * want_gb.abs() + ACCUM_RTOL * acc_gb),
    }


#: a bf16 LM against the same bf16 model and tokens on another backend:
#: where two f32 products, summed in another order, land either side of a
#: bf16 rounding boundary the bf16 results differ by one ulp (2^-8
#: relative), which the residual stream carries on. Logits within
#: BF16_LOGITS_TOL of the largest |logit| (mean |diff| within
#: BF16_LOGITS_MEAN_TOL of it), the loss within rtol BF16_LOSS_RTOL, every
#: gradient leaf within BF16_GRAD_TOL of its largest |g|
BF16_LOGITS_TOL, BF16_LOGITS_MEAN_TOL = 2**-7, 2**-9
BF16_LOSS_RTOL, BF16_GRAD_TOL = 2**-10, 2**-5


def bf16_lm_mismatch(logits, loss, grads, want_logits, want_loss,
                     want_grads) -> Optional[str]:
    """Why a bf16 LM's (logits, loss, {leaf: gradient}) is not the
    reference's within the tolerances above, or ``None`` when it is."""
    logits, want_logits = _np(logits).astype(np.float64), \
        _np(want_logits).astype(np.float64)
    if logits.shape != want_logits.shape or not np.isfinite(logits).all():
        return f"logits {logits.shape} are not finite of {want_logits.shape}"
    scale = np.abs(want_logits).max()
    diff = np.abs(logits - want_logits)
    if diff.max() > BF16_LOGITS_TOL * scale:
        return f"logits max |diff| {diff.max():.4g} (scale {scale:.4g})"
    if diff.mean() > BF16_LOGITS_MEAN_TOL * scale:
        return f"logits mean |diff| {diff.mean():.4g} (scale {scale:.4g})"
    loss, want_loss = float(_np(loss)), float(_np(want_loss))
    if not abs(loss - want_loss) <= BF16_LOSS_RTOL * abs(want_loss):
        return f"loss {loss!r} against {want_loss!r}"
    if set(grads) != set(want_grads):
        return f"gradient leaves {sorted(grads)} vs {sorted(want_grads)}"
    for name, w in want_grads.items():
        g = grads[name]
        if str(g.dtype) != str(w.dtype):
            return f"gradient {name} is {g.dtype}, not {w.dtype}"
        g, w = (_np(x.float()).astype(np.float64) for x in (g, w))
        err = np.abs(g - w).max()
        if not err <= BF16_GRAD_TOL * np.abs(w).max():
            return (f"gradient {name}: max |diff| {err:.4g} (largest |g| "
                    f"{np.abs(w).max():.4g})")
    return None


#: (a's shape, b's shape, b a transposed view) of the ``matmul_f32`` checks:
#: a 2-D product, leading dimensions, a batched product, and the tied LM
#: head's transposed embedding
MATMUL_CASES = [((37, 64), (64, 48), False), ((2, 37, 64), (64, 48), False),
                ((3, 37, 64), (3, 64, 48), False),
                ((2, 19, 64), (64, 200), True)]


def matmul_inputs(a_shape, b_shape, transposed: bool, seed: int, device):
    """bf16 operands and an f32 cotangent for ``matmul_f32_errors``, drawn
    on ``device`` from ``seed``; ``b`` a transposed view when asked."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    b = draw(b_shape[::-1]).t() if transposed else draw(b_shape)
    out = (a_shape[:-1] + b_shape[-1:] if len(b_shape) == 2
           else (b_shape[0], a_shape[-2], b_shape[-1]))
    return draw(a_shape), b, draw(out, torch.float32)


def lm_outputs(cfg, model, tokens):
    """An LM's forward logits (no gradient), then its loss and the gradient
    of every leaf by name: the three things ``bf16_lm_mismatch``
    compares."""
    import torch

    from repro_torch.models import transformer

    with torch.no_grad():
        logits = transformer.forward(cfg, model, tokens)
    loss, _ = transformer.loss_fn(cfg, model, {"tokens": tokens})
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return logits, loss.detach(), dict(zip(
        [n for n, _ in model.named_parameters()], grads))
