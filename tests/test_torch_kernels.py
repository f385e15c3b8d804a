"""Parity of the port's dense kernel dispatch (pdist_sq, pdist,
zen_estimate, jsd_pdist) with the JAX package on the CPU.

The same seeded numpy inputs go to the JAX Pallas kernels in interpret mode
(as tests/test_kernels.py runs them), to ``repro.kernels.ref``, and to the
port's plain versions, its ``ops`` dispatch and its ``ref`` oracles, over
the shape and dtype sweeps of tests/test_kernels.py.

Tolerances (``repro_torch.testing``): pdist_sq and zen_estimate agree in
squared space within SQ_RTOL = 1e-5 x (|x|^2 + |y|^2), and jsd_pdist within
JSD_KTOL = 1e-5 on K = D^2. All paths evaluate the same f32 formulas; only
the summation order differs (XLA:CPU, the Pallas blocks, ATen). bf16 inputs
are the same bf16 values in both packages and are computed in f32 after
the cast, so they keep the f32 tolerance. The oracles' agreement with
core/metrics (independent implementations) is checked at rtol/atol 1e-5.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")  # absent where only the port is installed

import jax.numpy as jnp  # noqa: E402

from repro.kernels import jsd as jjsd  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import pdist as jpdist  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import zen as jzen  # noqa: E402
import repro_torch.kernels as tkernels  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.kernels import jsd as tjsd  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import zen as tzen  # noqa: E402
from repro_torch.testing import dense_errors  # noqa: E402

# the package exports the function ``pdist``, which shadows the module name
tpdist = importlib.import_module("repro_torch.kernels.pdist")

F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _x32():
    """Other test modules flip ``jax_enable_x64`` on at import; the parity
    is defined at the default f32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _pair(X, Y, dtype):
    """The same values as JAX and torch arrays of ``dtype``, and their f32
    torch copies (what the tolerance is scaled by)."""
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    Xj, Yj = jnp.asarray(X, jd), jnp.asarray(Y, jd)
    Xt = torch.from_numpy(np.array(Xj.astype(jnp.float32))).to(td)
    Yt = torch.from_numpy(np.array(Yj.astype(jnp.float32))).to(td)
    return Xj, Yj, Xt, Yt


def _check(kind, Xt, Yt, got, want):
    _, _, why = dense_errors(kind, Xt.float(), Yt.float(), got,
                             torch.from_numpy(np.asarray(want)))
    assert why is None, why


SHAPES_PDIST = [(8, 8, 16), (128, 128, 512), (100, 37, 129), (256, 64, 1000),
                (1, 5, 3), (130, 257, 640), (300, 16, 256)]


@pytest.mark.parametrize("n,k,m", SHAPES_PDIST)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pdist_sq_matches_jax_kernel(n, k, m, dtype):
    rng = np.random.default_rng(n * 1000 + k + m)
    Xj, Yj, Xt, Yt = _pair(rng.normal(size=(n, m)), rng.normal(size=(k, m)),
                           dtype)
    want = jpdist.pdist_sq(Xj, Yj, interpret=True)
    for got in (tpdist.pdist_sq_plain(Xt, Yt), tops.pdist_sq(Xt, Yt),
                tref.pdist_sq_ref(Xt, Yt)):
        _check("pdist", Xt, Yt, got, want)
    _check("pdist", Xt, Yt, tpdist.pdist_sq_plain(Xt, Yt, chunk=7),
           jref.pdist_sq_ref(Xj, Yj))


SHAPES_ZEN = [(16, 16, 4), (256, 256, 32), (100, 300, 17), (7, 1, 2),
              (64, 128, 130), (5, 9, 1)]


@pytest.mark.parametrize("n,m,k", SHAPES_ZEN)
@pytest.mark.parametrize("mode", ["zen", "lwb", "upb"])
def test_zen_estimate_matches_jax_kernel(n, m, k, mode):
    rng = np.random.default_rng(n + m + k)
    X, Y = rng.normal(size=(n, k)), rng.normal(size=(m, k))
    X[:, -1], Y[:, -1] = np.abs(X[:, -1]), np.abs(Y[:, -1])  # altitudes
    Xj, Yj, Xt, Yt = _pair(X, Y, "float32")
    want = jzen.zen_estimate(Xj, Yj, mode, interpret=True)
    for got in (tzen.zen_estimate_plain(Xt, Yt, mode),
                tops.zen_estimate(Xt, Yt, mode),
                tref.zen_estimate_ref(Xt, Yt, mode)):
        _check("zen", Xt, Yt, got, want)
    _check("zen", Xt, Yt, tzen.zen_estimate_plain(Xt, Yt, mode, budget=50),
           jref.zen_estimate_ref(Xj, Yj, mode))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zen_estimate_dtypes(dtype):
    rng = np.random.default_rng(3)
    Xj, Yj, Xt, Yt = _pair(rng.normal(size=(64, 16)),
                           rng.normal(size=(96, 16)), dtype)
    want = jzen.zen_estimate(Xj, Yj, "zen", interpret=True)
    _check("zen", Xt, Yt, tops.zen_estimate(Xt, Yt), want)


SHAPES_JSD = [(8, 8, 32), (64, 64, 256), (40, 100, 100), (16, 16, 48),
              (128, 128, 513), (33, 16, 256)]


def _simplex_rows(rng, n, m, sparse=False):
    x = rng.uniform(size=(n, m))
    if sparse:  # a third of the entries zero: 0 log 0 on every path
        x[rng.uniform(size=x.shape) < 1 / 3] = 0.0
        x[:, 0] += 1e-3
    return x / x.sum(1, keepdims=True)


@pytest.mark.parametrize("n,k,m", SHAPES_JSD)
@pytest.mark.parametrize("sparse", [False, True])
def test_jsd_pdist_matches_jax_kernel(n, k, m, sparse):
    rng = np.random.default_rng(n + k * 7 + m)
    Xj, Yj, Xt, Yt = _pair(_simplex_rows(rng, n, m, sparse),
                           _simplex_rows(rng, k, m, sparse), "float32")
    want = jjsd.jsd_pdist(Xj, Yj, interpret=True)
    for got in (tjsd.jsd_pdist_plain(Xt, Yt), tops.jsd_pdist(Xt, Yt),
                tref.jsd_pdist_ref(Xt, Yt)):
        _check("jsd", Xt, Yt, got, want)
    _check("jsd", Xt, Yt, tjsd.jsd_pdist_plain(Xt, Yt, budget=1000),
           jref.jsd_pdist_ref(Xj, Yj))


def test_jsd_sparse_rows():
    """0 log 0, and disjoint supports giving exactly 1, on both packages."""
    X = np.asarray([[0.5, 0.5, 0.0, 0.0], [0.25, 0.25, 0.25, 0.25]],
                   np.float32)
    Y = np.asarray([[0.0, 0.0, 0.5, 0.5]], np.float32)
    want = np.asarray(jjsd.jsd_pdist(jnp.asarray(X), jnp.asarray(Y),
                                     interpret=True))
    got = tops.jsd_pdist(torch.from_numpy(X), torch.from_numpy(Y)).numpy()
    assert np.isfinite(got).all()
    assert got[0, 0] == 1.0 == want[0, 0]
    np.testing.assert_allclose(got, want, **F32)


def test_ops_dispatch_cpu_matches_jax_ops():
    rng = np.random.default_rng(5)
    X, Y = rng.normal(size=(50, 64)), rng.normal(size=(30, 64))
    Xj, Yj, Xt, Yt = _pair(X, Y, "float32")
    _check("pdist", Xt, Yt, tops.pdist_sq(Xt, Yt), jops.pdist_sq(Xj, Yj))
    np.testing.assert_allclose(tops.pdist(Xt, Yt).numpy(),
                               np.asarray(jops.pdist(Xj, Yj)), **F32)
    Z = np.abs(X[:, :8])
    Zj, _, Zt, _ = _pair(Z, Z, "float32")
    _check("zen", Zt, Zt, tops.zen_estimate(Zt, Zt, "lwb"),
           jops.zen_estimate(Zj, Zj, "lwb"))
    P = _simplex_rows(rng, 20, 40)
    Pj, _, Pt, _ = _pair(P, P, "float32")
    _check("jsd", Pt, Pt, tops.jsd_pdist(Pt, Pt), jops.jsd_pdist(Pj, Pj))


def _mixed(kind, rng, dtypes):
    """(JAX X, JAX Y, torch X, torch Y) of one dense case with X and Y in
    the two dtypes of ``dtypes``: the same values on both sides."""
    if kind == "jsd":
        X, Y = _simplex_rows(rng, 40, 96), _simplex_rows(rng, 24, 96)
    else:
        X, Y = rng.normal(size=(40, 96)), rng.normal(size=(24, 96))
        if kind == "zen":
            X[:, -1], Y[:, -1] = np.abs(X[:, -1]), np.abs(Y[:, -1])
    Xj, _, Xt, _ = _pair(X, X, dtypes[0])
    Yj, _, Yt, _ = _pair(Y, Y, dtypes[1])
    return Xj, Yj, Xt, Yt


@pytest.mark.parametrize("kind", ["pdist", "zen", "jsd"])
@pytest.mark.parametrize("dtypes", [("bfloat16", "float32"),
                                    ("float32", "bfloat16")])
def test_dense_kernels_keep_each_operands_dtype(kind, dtypes):
    """X and Y in different dtypes: the TPU kernels cast each operand to
    f32 on its own, so an f32 operand keeps its f32 values (rounding it to
    the other's bf16 moves d^2 by ~1e-3 relative, 100x the tolerance)."""
    rng = np.random.default_rng(len(kind) * 10 + len(dtypes[0]))
    Xj, Yj, Xt, Yt = _mixed(kind, rng, dtypes)
    if kind == "pdist":
        want = jpdist.pdist_sq(Xj, Yj, interpret=True)
        got = tops.pdist_sq(Xt, Yt)
    elif kind == "zen":
        want = jzen.zen_estimate(Xj, Yj, "zen", interpret=True)
        got = tops.zen_estimate(Xt, Yt, "zen")
    else:
        want = jjsd.jsd_pdist(Xj, Yj, interpret=True)
        got = tops.jsd_pdist(Xt, Yt)
    _check(kind, Xt, Yt, got, want)
    # and the f32 operand rounded to bf16 gives another answer
    if kind == "pdist":
        rounded = tops.pdist_sq(Xt.bfloat16(), Yt.bfloat16())
        assert not np.allclose(rounded.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtypes,code", [
    (("bfloat16", "float32"), 0), (("float32", "bfloat16"), 0),
    (("float32", "float32"), 0), (("bfloat16", "bfloat16"), 1)])
def test_launch_operands_never_round_an_operand_down(dtypes, code):
    """The operands as a dense kernel launches them
    (``launch_operands``, the end of ``kernel_operands``): in their dtype
    where they share one, else both as f32, each with its own values,
    contiguous."""
    rng = np.random.default_rng(7)
    X = torch.from_numpy(rng.standard_normal((5, 8)).astype(np.float32))
    Y = torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32))
    X, Y = X.to(getattr(torch, dtypes[0])), Y.to(getattr(torch, dtypes[1])).T
    Xl, Yl, got = tpdist.launch_operands(X, Y)
    assert got == code
    assert Xl.dtype == Yl.dtype == (torch.bfloat16 if code else torch.float32)
    assert Xl.is_contiguous() and Yl.is_contiguous()
    assert torch.equal(Xl.float(), X.float())
    assert torch.equal(Yl.float(), Y.float())


#: (n, k, m, dtype, operands aligned) -> the plan's kernel: the K = 16 / 17
#: boundary, K % 4 != 0 (output rows off 16 bytes), m off 16 bytes (f32
#: m % 4, bf16 m % 8), operands off 16 bytes, m = 0, n or K of 1, K past
#: 65,535 tiles of 128 (no grid-y limit: the MMA plan's grid is persistent)
PLAN_CASES = [
    (2048, 2048, 256, "float32", True, "mma"),
    (2048, 2048, 16, "float32", True, "mma"),
    (2048, 2048, 256, "bfloat16", True, "mma"),
    (2048, 2048, 64, "bfloat16", True, "mma"),
    (2048, 2049, 256, "float32", True, "simt"),
    (1_000_000, 16, 256, "float32", True, "narrow"),
    (300, 16, 64, "float32", True, "narrow"),
    (300, 17, 64, "float32", True, "simt"),
    (300, 20, 64, "float32", True, "mma"),
    (200, 130, 64, "float32", True, "simt"),
    (200, 132, 70, "float32", True, "simt"),
    (200, 132, 36, "float32", True, "mma"),
    (200, 132, 36, "bfloat16", True, "simt"),
    (200, 132, 40, "bfloat16", True, "mma"),
    (200, 132, 64, "float32", False, "simt"),
    (200, 132, 0, "float32", True, "simt"),
    (1, 300, 64, "float32", True, "mma"),
    (300, 1, 64, "float32", True, "narrow"),
    (3, 65_535 * 128 + 4, 8, "float32", True, "mma"),
]


@pytest.mark.parametrize("n,k,m,dtype,aligned,kernel", PLAN_CASES)
def test_pdist_plan_picks_the_kernel(n, k, m, dtype, aligned, kernel):
    td = getattr(torch, dtype)
    plan = tpdist.pdist_plan(n, k, m, td, aligned, n_sms=132)
    assert plan.kernel == kernel
    tiles = -(-n // plan.tile[0]) * -(-k // plan.tile[1])
    if kernel == "mma":
        es = 4 if td == torch.float32 else 2
        assert plan.tile == (128, 128) and plan.chunk * es == 128
        assert plan.grid == min(tiles, 132)  # persistent: at most one an SM
        assert 2 <= plan.stages <= tpdist.MMA_MAX_STAGES
        assert plan.smem == tpdist.mma_smem(es, plan.stages)
        assert plan.smem <= tpdist.SMEM_LIMIT
        # the TMA stores need 16-byte output rows
        assert k % 4 == 0
        assert "tensor cores" in plan.route
    else:
        assert plan.tile == (tpdist.NARROW_TILE if k <= 16
                             else tpdist.SIMT_TILE)
        assert plan.grid == tiles
        assert plan.stages == plan.smem == 0
        assert plan.route == "f32 on the CUDA cores"


def test_pdist_plan_is_cached_and_follows_the_card():
    tpdist.pdist_plan.cache_clear()
    a = tpdist.pdist_plan(2048, 2048, 256, torch.float32, True, n_sms=132)
    b = tpdist.pdist_plan(2048, 2048, 256, torch.float32, True, n_sms=132)
    assert a is b and tpdist.pdist_plan.cache_info().hits == 1
    assert tpdist.pdist_plan(2048, 2048, 256, torch.float32, True,
                             n_sms=114).grid == 114
    assert tpdist.pdist_plan(100, 100, 256, torch.float32, True,
                             n_sms=132).grid == 1  # one tile
    assert tpdist.dense_plan(300, 17, 64).kernel == "simt"


def test_operands_aligned_on_offset_views():
    base = torch.zeros(300 * 64 + 4)
    X = base[:300 * 64].view(300, 64)
    assert tpdist.operands_aligned(X, X)
    off = base[1:300 * 64 + 1].view(300, 64)  # 4 bytes in
    assert off.is_contiguous() and not tpdist.operands_aligned(off, X)
    rows = X[1:]  # one 256-byte row in: still on a 16-byte boundary
    assert tpdist.operands_aligned(rows, X)
    n, m = off.shape
    assert tpdist.pdist_plan(n, 200, m, torch.float32,
                             tpdist.operands_aligned(off, X)).kernel == "simt"


def test_package_exports_the_dispatch():
    assert tkernels.pdist_sq is tops.pdist_sq
    assert tkernels.pdist is tops.pdist
    assert tkernels.zen_estimate is tops.zen_estimate
    assert tkernels.jsd_pdist is tops.jsd_pdist


def test_kernel_wrappers_refuse_cpu_tensors():
    X = torch.rand((4, 8))
    for fn in (tpdist.pdist_sq, tzen.zen_estimate, tjsd.jsd_pdist):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(X, X)
    with pytest.raises(ValueError, match="mode"):
        tops.zen_estimate(X, X, "exact")


def test_port_oracles_match_core_metrics_and_jax_oracles():
    # kernels/ref.py and core/metrics.py agree (independent implementations)
    rng = np.random.default_rng(6)
    X = rng.uniform(size=(20, 40)).astype(np.float32)
    Y = rng.uniform(size=(10, 40)).astype(np.float32)
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
    np.testing.assert_allclose(tref.pdist_sq_ref(Xt, Yt).numpy(),
                               tmetrics.sqeuclidean_pdist(Xt, Yt).numpy(),
                               **F32)
    Xn, Yn = tmetrics.l1_normalize(Xt), tmetrics.l1_normalize(Yt)
    np.testing.assert_allclose(
        tref.jsd_pdist_ref(Xn, Yn).numpy(),
        tmetrics.jsd_pdist(Xn, Yn, assume_normalized=True).numpy(), **F32)
    np.testing.assert_allclose(
        tref.jsd_pdist_ref(Xn, Yn).numpy(),
        np.asarray(jref.jsd_pdist_ref(jnp.asarray(Xn.numpy()),
                                      jnp.asarray(Yn.numpy()))), **F32)
    for mode in ("zen", "lwb", "upb"):
        np.testing.assert_allclose(
            tref.zen_estimate_ref(Xt, Yt, mode).numpy(),
            np.asarray(jref.zen_estimate_ref(jnp.asarray(X), jnp.asarray(Y),
                                             mode)), **F32)
