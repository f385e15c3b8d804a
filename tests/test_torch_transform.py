"""Parity of the PyTorch port's transform (metrics, simplex, projection)
with the JAX package on the same seeded numpy inputs, on the CPU.

Tolerances: the two packages run the same f32 formulas with different
reduction orders (XLA:CPU vs ATen), so results agree to a few f32 ulps of
the largest intermediate: rtol 1e-5 / atol 1e-5 for distances and
coordinates of O(1) data. The Cholesky factor and the triangular solve
amplify that noise by the simplex's conditioning, so the projection
allows 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")  # absent where only the port is installed

import jax.numpy as jnp  # noqa: E402

from repro.core import metrics as jmetrics  # noqa: E402
from repro.core import projection as jprojection  # noqa: E402
from repro.core import simplex as jsimplex  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.core import projection as tprojection  # noqa: E402
from repro_torch.core import simplex as tsimplex  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
SOLVE = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _x32():
    """Other test modules flip ``jax_enable_x64`` on at import; the parity
    is defined at the default f32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _assert_apex_close(got, want):
    """Base coordinates within SOLVE; the altitude through its square,
    since sqrt amplifies the f32 noise of an altitude near zero (a point
    in the span of the references, such as a reference itself)."""
    np.testing.assert_allclose(got[:, :-1], want[:, :-1], **SOLVE)
    np.testing.assert_allclose(got[:, -1] ** 2, want[:, -1] ** 2, **SOLVE)


def _data(seed, n, m, positive=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, m)).astype(np.float32)
    return np.abs(x) if positive else x


@pytest.mark.parametrize("name", ["euclidean", "sqeuclidean", "cosine",
                                  "jsd", "triangular", "qform"])
def test_pairwise_metrics_match_jax(name):
    pos = name in ("jsd", "triangular")
    X, Y = _data(0, 9, 6, pos), _data(1, 7, 6, pos)
    want = np.asarray(jmetrics.pairwise(name, jnp.asarray(X), jnp.asarray(Y)))
    got = tmetrics.pairwise(name, torch.from_numpy(X), torch.from_numpy(Y))
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("name", ["euclidean", "cosine", "qform"])
def test_self_pairwise_keeps_exact_zero_diagonal(name):
    X = _data(2, 12, 5)
    got = tmetrics.self_pairwise(name, torch.from_numpy(X))
    assert torch.all(torch.diagonal(got) == 0.0)
    want = np.asarray(jmetrics.self_pairwise(name, jnp.asarray(X)))
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_normalizers_and_registry():
    X = _data(3, 8, 5)
    np.testing.assert_allclose(
        tmetrics.l2_normalize(torch.from_numpy(X)).numpy(),
        np.asarray(jmetrics.l2_normalize(jnp.asarray(X))), **F32)
    np.testing.assert_allclose(
        tmetrics.l1_normalize(torch.from_numpy(X)).numpy(),
        np.asarray(jmetrics.l1_normalize(jnp.asarray(X))), **F32)
    for name in ("euclidean", "sqeuclidean", "cosine", "jsd", "triangular",
                 "qform"):
        t, j = tmetrics.get_metric(name), jmetrics.get_metric(name)
        assert (t.hilbert_embeddable, t.has_coordinates) == (
            j.hilbert_embeddable, j.has_coordinates)
        assert (t.normalize is None) == (j.normalize is None)
    with pytest.raises(ValueError, match="unknown metric"):
        tmetrics.get_metric("nope")


def test_base_simplex_matches_jax_and_paper_oracle():
    refs = _data(4, 6, 10)
    D = np.array(jmetrics.euclidean_pdist(jnp.asarray(refs),
                                          jnp.asarray(refs)))
    np.fill_diagonal(D, 0.0)
    jb = jsimplex.build_base_simplex(jnp.asarray(D))
    tb = tsimplex.build_base_simplex(torch.from_numpy(D))
    np.testing.assert_allclose(
        tsimplex.gram_from_distances(torch.from_numpy(D)).numpy(),
        np.asarray(jsimplex.gram_from_distances(jnp.asarray(D))), **F32)
    np.testing.assert_allclose(tb.chol.numpy(), np.asarray(jb.chol), **F32)
    np.testing.assert_allclose(tb.diag_g.numpy(), np.asarray(jb.diag_g),
                               **F32)
    np.testing.assert_allclose(tb.d0.numpy(), np.asarray(jb.d0), **F32)
    # the Cholesky vertices are the paper's inductively built simplex
    np.testing.assert_allclose(
        tb.vertices().numpy(), jsimplex.nsimplex_build_reference(D), **SOLVE)
    assert tb.k == 6 and not tsimplex.simplex_is_degenerate(tb)


def test_apex_project_matches_jax_and_oracle():
    refs, X = _data(5, 5, 8), _data(6, 20, 8)
    Dr = np.array(jmetrics.euclidean_pdist(jnp.asarray(refs),
                                           jnp.asarray(refs)))
    np.fill_diagonal(Dr, 0.0)
    Dx = np.array(jmetrics.euclidean_pdist(jnp.asarray(X),
                                           jnp.asarray(refs)))
    got = tsimplex.apex_project(
        tsimplex.build_base_simplex(torch.from_numpy(Dr)),
        torch.from_numpy(Dx)).numpy()
    want = np.asarray(jsimplex.apex_project(
        jsimplex.build_base_simplex(jnp.asarray(Dr)), jnp.asarray(Dx)))
    np.testing.assert_allclose(got, want, **SOLVE)
    np.testing.assert_allclose(
        got, jsimplex.apex_project_reference(Dr, Dx), **SOLVE)
    assert (got[:, -1] >= 0).all()


def test_degenerate_reference_set_is_flagged_not_raised():
    """A repeated reference makes the Gram matrix singular: jnp's Cholesky
    returns NaN, torch's would raise; the port writes NaN and flags it."""
    refs = _data(7, 5, 6)
    refs[3] = refs[1]
    jt = jprojection.NSimplexTransform(k=5).fit(jnp.asarray(refs))
    tt = tprojection.NSimplexTransform(k=5).fit(torch.from_numpy(refs))
    assert bool(jt.degenerate()) and tt.degenerate()
    # collinear references: PD in exact arithmetic only by roundoff
    line = np.outer(np.arange(1, 5), np.ones(6)).astype(np.float32)
    tl = tprojection.NSimplexTransform(k=4).fit(torch.from_numpy(line))
    assert tl.degenerate()


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "jsd"])
def test_transform_matches_jax(metric):
    pos = metric == "jsd"
    refs, X = _data(8, 6, 12, pos), _data(9, 30, 12, pos)
    jt = jprojection.NSimplexTransform(k=6, metric=metric).fit(
        jnp.asarray(refs))
    tt = tprojection.NSimplexTransform(k=6, metric=metric).fit(
        torch.from_numpy(refs))
    np.testing.assert_allclose(tt.refs.numpy(), np.asarray(jt.refs), **F32)
    np.testing.assert_allclose(
        tt.transform(torch.from_numpy(X)).numpy(),
        np.asarray(jt.transform(jnp.asarray(X))), **SOLVE)


def test_from_distances_matches_jax():
    refs, X = _data(10, 5, 7, True), _data(11, 15, 7, True)
    Dr = np.array(jmetrics.pairwise("jsd", jnp.asarray(refs),
                                    jnp.asarray(refs)))
    np.fill_diagonal(Dr, 0.0)
    Dx = np.array(jmetrics.pairwise("jsd", jnp.asarray(X),
                                    jnp.asarray(refs)))
    jt = jprojection.NSimplexTransform.from_distances(jnp.asarray(Dr))
    tt = tprojection.NSimplexTransform.from_distances(torch.from_numpy(Dr))
    np.testing.assert_allclose(
        tt.transform_from_distances(torch.from_numpy(Dx)).numpy(),
        np.asarray(jt.transform_from_distances(jnp.asarray(Dx))), **SOLVE)
    with pytest.raises(ValueError, match="coordinate references"):
        tt.transform(torch.from_numpy(X))


def test_select_references_by_ids_and_by_generator():
    X = _data(12, 40, 9)
    ids = [3, 17, 5, 30]
    tt = tprojection.select_references(torch.from_numpy(X), 4, ids=ids)
    np.testing.assert_array_equal(tt.refs.numpy(), X[ids])
    jt = jprojection.NSimplexTransform(k=4).fit(jnp.asarray(X[ids]))
    _assert_apex_close(tt.transform(torch.from_numpy(X)).numpy(),
                       np.asarray(jt.transform(jnp.asarray(X))))
    a = tprojection.select_references(
        torch.from_numpy(X), 4, generator=torch.Generator().manual_seed(3))
    b = tprojection.select_references(
        torch.from_numpy(X), 4, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.refs, b.refs) and not a.degenerate()
    with pytest.raises(ValueError, match="expected 4 references"):
        tprojection.NSimplexTransform(k=4).fit(torch.from_numpy(X[:3]))
