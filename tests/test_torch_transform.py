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


# -- the core API remainder: fit_transform, verify_base_simplex, oracles -----


@pytest.mark.parametrize("pivots", ["random", "farthest_first", "maxvol"])
def test_fit_transform_from_the_references_ids(pivots):
    """fit_transform with the JAX package's chosen rows: the same
    references and projection; the strategy chooses them itself."""
    X = _data(13, 60, 10)
    jt, jy = jprojection.fit_transform(jnp.asarray(X), 5,
                                       jax.random.PRNGKey(1), pivots=pivots)
    refs = np.asarray(jt.refs)
    ids = [int(np.flatnonzero((X == r).all(1))[0]) for r in refs]
    tt, ty = tprojection.fit_transform(torch.from_numpy(X), 5, ids=ids)
    np.testing.assert_array_equal(tt.refs.numpy(), refs)
    _assert_apex_close(ty.numpy(), np.asarray(jy))
    # without ids the strategy picks (a generator for the random draws)
    gt, gy = tprojection.fit_transform(
        torch.from_numpy(X), 5, pivots=pivots,
        generator=torch.Generator().manual_seed(2))
    assert gy.shape == (60, 5) and not gt.degenerate()
    if pivots != "random":  # deterministic strategies: the same rows
        from repro_torch.core import pivots as tpivots
        want = tpivots.select_references(torch.from_numpy(X), 5,
                                         strategy=pivots)
        assert torch.equal(gt.refs, want.refs)
    with pytest.raises(ValueError):
        tprojection.fit_transform(torch.from_numpy(X), 5, pivots="nope")


@pytest.mark.parametrize("perturb", [0.0, 1e-3, 0.5])
def test_verify_base_simplex_matches_jax(perturb):
    refs = _data(14, 7, 12)
    D = np.array(jmetrics.euclidean_pdist(jnp.asarray(refs),
                                          jnp.asarray(refs)))
    np.fill_diagonal(D, 0.0)
    jb = jsimplex.build_base_simplex(jnp.asarray(D))
    tb = tsimplex.build_base_simplex(torch.from_numpy(D))
    Dc = D.copy()
    Dc[2, 5] += perturb
    Dc[5, 2] += perturb
    j_ok, j_err = jsimplex.verify_base_simplex(jnp.asarray(Dc), jb)
    t_ok, t_err = tsimplex.verify_base_simplex(torch.from_numpy(Dc), tb)
    assert t_ok == j_ok == (perturb <= 1e-4)
    assert t_err == pytest.approx(j_err, abs=1e-5)
    assert tsimplex.verify_base_simplex(Dc, tb, atol=1.0)[0]


@pytest.mark.parametrize("k", [2, 3, 6, 11])
def test_paper_oracles_equal_the_jax_packages(k):
    """The numpy oracles (Algorithms 1 and 2) are a copy: equal outputs."""
    refs, X = _data(15 + k, k, 14), _data(16 + k, 13, 14)
    D = np.array(jmetrics.euclidean_pdist(jnp.asarray(refs),
                                          jnp.asarray(refs)), np.float64)
    np.fill_diagonal(D, 0.0)
    Dx = np.array(jmetrics.euclidean_pdist(jnp.asarray(X),
                                           jnp.asarray(refs)), np.float64)
    sigma = tsimplex.nsimplex_build_reference(D)
    np.testing.assert_array_equal(sigma,
                                  jsimplex.nsimplex_build_reference(D))
    np.testing.assert_array_equal(
        tsimplex.apex_addition_reference(sigma, Dx[0]),
        jsimplex.apex_addition_reference(sigma, Dx[0]))
    got = tsimplex.apex_project_reference(D, Dx)
    np.testing.assert_array_equal(got,
                                  jsimplex.apex_project_reference(D, Dx))
    # and the port's batched projection agrees with its own oracle
    tb = tsimplex.build_base_simplex(torch.from_numpy(D.astype(np.float32)))
    _assert_apex_close(tsimplex.apex_project(
        tb, torch.from_numpy(Dx.astype(np.float32))).numpy(), got)


def test_core_exports_mirror_the_jax_package():
    import repro.core as jcore
    import repro.index as jindex
    import repro_torch.core as tcore
    import repro_torch.index as tindex

    assert set(jcore.__all__) <= set(tcore.__all__)
    for name in jcore.__all__:
        assert hasattr(tcore, name), name
    assert tindex.IVF_SNAPSHOT_KIND == jindex.IVF_SNAPSHOT_KIND
    assert set(jindex.__all__) <= set(tindex.__all__)
