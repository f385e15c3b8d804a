"""Parity of the port's evaluation path (core/pivots, core/baselines,
core/reducers, core/quality, the paper-space generators) with the JAX
package on the CPU, on the same seeded inputs.

What is held equal, and why each tolerance:
- pivot ids of farthest_first and maxvol: exactly, on one distance matrix
  handed to both packages, and on the committed golden arrays (which the
  reference still passes here). kmeanspp and random take the reference's
  own draws (``jax.random`` cannot be replayed in torch) and must then
  choose the same ids.
- baselines fitted from one converted state: transforms within rtol/atol
  1e-5 (the same f32 matmuls in another order). Fitted independently, SVD
  and eigh pick eigenvector signs per backend, so they are compared by the
  distances of their projections, within rtol 1e-4 / atol 1e-4 x the
  largest distance (f32 noise of the decompositions).
- quality measures: the same float64 numpy on the same delta and zeta, so
  rtol 1e-12; the pair order of pairwise_sample/flatten_upper exactly.
- the small end-to-end evaluation against benchmarks/paper_quality.py
  (all five reducers, Euclidean and JSD): each measure within atol 1e-3.
  zeta carries the f32 noise of each fit (~1e-5 relative), which moves
  stress and Spearman's rho by ~1e-5 on these ~7,000 pairs; the margin
  covers a rank swap of near-tied pairs.
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")  # absent where only the port is installed

import jax.numpy as jnp  # noqa: E402

from repro.core import baselines as jbaselines  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.core import pivots as jpivots  # noqa: E402
from repro.core import projection as jprojection  # noqa: E402
from repro.core import quality as jquality  # noqa: E402
from repro.core import reducers as jreducers  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import baselines as tbaselines  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.core import pivots as tpivots  # noqa: E402
from repro_torch.core import quality as tquality  # noqa: E402
from repro_torch.core import reducers as treducers  # noqa: E402
from repro_torch.core.projection import NSimplexTransform  # noqa: E402
from repro_torch.core.zen import zen_pdist  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "serving_golden.npz")
F32 = dict(rtol=1e-5, atol=1e-5)
E2E_ATOL = 1e-3


@pytest.fixture(autouse=True)
def _x32():
    """Other test modules flip ``jax_enable_x64`` on at import; the parity
    is defined at the default f32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


@pytest.fixture(scope="module")
def paper_quality():
    path = os.path.join(ROOT, "benchmarks", "paper_quality.py")
    spec = importlib.util.spec_from_file_location("paper_quality_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _dist_matrix(seed, n, m, metric="euclidean"):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, m)).astype(np.float32)
    if metric == "jsd":
        X = np.abs(X)
    D = np.array(jmetrics.pairwise(metric, jnp.asarray(X), jnp.asarray(X)),
                 np.float64)
    np.fill_diagonal(D, 0.0)
    return X, D


def _first_draw(key, n, k):
    """The ids ``repro.core.projection.select_references`` draws first."""
    _, sub = jax.random.split(key)
    return np.array(jax.random.choice(sub, n, (k,), replace=False))


def _assert_same_distances(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.max(want)))


# -- pivots ---------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["farthest_first", "maxvol"])
@pytest.mark.parametrize("seed,n,m,k,metric", [
    (0, 200, 16, 8, "euclidean"), (1, 300, 32, 16, "euclidean"),
    (2, 64, 16, 12, "euclidean"), (3, 150, 24, 10, "jsd"),
    (4, 50, 8, 1, "euclidean"), (5, 40, 8, 2, "jsd")])
def test_deterministic_pivots_equal_the_reference(strategy, seed, n, m, k,
                                                  metric):
    _, D = _dist_matrix(seed, n, m, metric)
    want = jpivots.select_pivot_indices(D, k, strategy)
    got = tpivots.select_pivot_indices(D, k, strategy)
    np.testing.assert_array_equal(got, want)
    # a tensor matrix (on the way from a device) gives the same ids
    got = tpivots.select_pivot_indices(torch.from_numpy(D), k, strategy)
    np.testing.assert_array_equal(got, want)


def test_deterministic_pivots_on_duplicate_witnesses():
    X = np.repeat(np.random.default_rng(6).standard_normal((3, 5)), 4, 0)
    D = np.array(jmetrics.euclidean_pdist(jnp.asarray(X), jnp.asarray(X)),
                 np.float64)
    np.fill_diagonal(D, 0.0)
    for strategy in ("farthest_first", "maxvol"):
        np.testing.assert_array_equal(
            tpivots.select_pivot_indices(D, 6, strategy),
            jpivots.select_pivot_indices(D, 6, strategy))


@pytest.mark.parametrize("strategy", ["farthest_first", "maxvol"])
def test_pivot_ids_match_the_golden_arrays(strategy):
    golden = np.load(GOLDEN)
    corpus = torch.from_numpy(golden["corpus_euclid"])
    want = golden[f"pivots_{strategy}_ids"]
    got = tpivots.pivot_ids(corpus, want.shape[0], strategy=strategy)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("strategy", ["farthest_first", "maxvol"])
def test_pivot_ids_with_the_reference_witnesses(strategy):
    """A witness subsample (n > max_witness) taken from the reference's
    own draw, then the same ids."""
    X = np.random.default_rng(7).standard_normal((300, 12)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jpivots.pivot_ids(jnp.asarray(X), 6, key, strategy=strategy,
                             max_witness=64)
    wkey, _ = jax.random.split(key)
    wit = np.sort(np.asarray(jax.random.choice(wkey, 300, (64,),
                                               replace=False)))
    got = tpivots.pivot_ids(torch.from_numpy(X), 6, strategy=strategy,
                            max_witness=64, witness_ids=wit)
    np.testing.assert_array_equal(got, want)


def _recorded_kmeanspp(monkeypatch, D, k, key):
    """The reference's kmeanspp ids and the raw draws it made."""
    draws = []
    randint, choice = jax.random.randint, jax.random.choice

    def rec_randint(*a, **kw):
        out = randint(*a, **kw)
        draws.append(int(out))
        return out

    def rec_choice(*a, **kw):
        out = choice(*a, **kw)
        draws.append(int(out))
        return out

    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "randint", rec_randint)
        mp.setattr(jax.random, "choice", rec_choice)
        ids = jpivots.kmeanspp_indices(D, k, key)
    return ids, draws


@pytest.mark.parametrize("seed,k", [(0, 8), (1, 16), (2, 1)])
def test_kmeanspp_from_the_reference_draws(monkeypatch, seed, k):
    _, D = _dist_matrix(seed, 120, 10)
    want, draws = _recorded_kmeanspp(monkeypatch, D, k,
                                     jax.random.PRNGKey(seed))
    got = tpivots.kmeanspp_indices(D, k, draws=draws)
    np.testing.assert_array_equal(got, want)
    got = tpivots.select_pivot_indices(D, k, "kmeanspp", draws=draws)
    np.testing.assert_array_equal(got, want)


def test_kmeanspp_duplicate_tail_and_generator(monkeypatch):
    """Duplicates everywhere: the deterministic fill, as the reference's."""
    X = np.repeat(np.random.default_rng(8).standard_normal((3, 4)), 5, 0)
    D = np.array(jmetrics.euclidean_pdist(jnp.asarray(X), jnp.asarray(X)),
                 np.float64)
    np.fill_diagonal(D, 0.0)
    want, draws = _recorded_kmeanspp(monkeypatch, D, 7, jax.random.PRNGKey(1))
    np.testing.assert_array_equal(
        tpivots.kmeanspp_indices(D, 7, draws=draws), want)
    ids = tpivots.kmeanspp_indices(D, 7,
                                   generator=torch.Generator().manual_seed(1))
    assert len(set(ids.tolist())) == 7


def test_random_pivots_and_references_from_the_reference_draw():
    X = np.random.default_rng(9).standard_normal((200, 12)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    ids = _first_draw(key, 200, 8)
    want = jprojection.select_references(jnp.asarray(X), 8, key)
    np.testing.assert_array_equal(np.asarray(want.refs), X[ids])
    D = np.zeros((200, 200))
    np.testing.assert_array_equal(
        tpivots.select_pivot_indices(D, 8, "random", draws=ids), ids)
    got = tpivots.select_references(torch.from_numpy(X), 8, ids=ids)
    np.testing.assert_array_equal(got.refs.numpy(), np.asarray(want.refs))
    # the altitude through its square: sqrt amplifies the f32 noise of an
    # altitude near zero (the references themselves)
    got = got.transform(torch.from_numpy(X)).numpy()
    want = np.asarray(want.transform(jnp.asarray(X)))
    np.testing.assert_allclose(got[:, :-1], want[:, :-1], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got[:, -1] ** 2, want[:, -1] ** 2, rtol=1e-4,
                               atol=1e-4)
    drawn = tpivots.select_pivot_indices(
        D, 8, "random", generator=torch.Generator().manual_seed(0))
    assert len(set(drawn.tolist())) == 8


@pytest.mark.parametrize("strategy", ["farthest_first", "maxvol", "kmeanspp"])
def test_strategy_select_references_fits_the_chosen_pivots(strategy):
    golden = np.load(GOLDEN)
    corpus = torch.from_numpy(golden["corpus_euclid"])
    gen = torch.Generator().manual_seed(0)
    tr = tpivots.select_references(corpus, 8, strategy=strategy,
                                   generator=gen)
    assert not tr.degenerate()
    if strategy != "kmeanspp":
        ids = golden[f"pivots_{strategy}_ids"]
        np.testing.assert_array_equal(tr.refs.numpy(),
                                      golden["corpus_euclid"][ids])
    with pytest.raises(ValueError, match="unknown pivot strategy"):
        tpivots.select_references(corpus, 8, strategy="best")


# -- baselines --------------------------------------------------------------------


def _witness(seed, n=160, m=24):
    return np.random.default_rng(seed).standard_normal((n, m)).astype(
        np.float32)


def test_baselines_from_converted_state_transform_alike():
    W, X = _witness(10), _witness(11, 50)
    Wj, Xj, Xt = jnp.asarray(W), jnp.asarray(X), torch.from_numpy(X)
    pca = jbaselines.PCATransform(k=6).fit(Wj)
    rp = jbaselines.RandomProjection(k=6).fit(24, key=jax.random.PRNGKey(2))
    mds = jbaselines.MDSTransform(k=6).fit(Wj)
    cases = [
        (pca, convert.baseline_from_arrays(
            "pca", k=6, mean=pca.mean, components=pca.components,
            explained_variance=pca.explained_variance, device="cpu")),
        (rp, convert.baseline_from_arrays("rp", k=6, matrix=rp.matrix,
                                          device="cpu")),
        (mds, convert.baseline_from_arrays(
            "mds", k=6, mean=mds.mean, linear=mds.linear,
            stress_coords=mds.stress_coords, device="cpu")),
    ]
    for ref, port in cases:
        np.testing.assert_allclose(port.transform(Xt).numpy(),
                                   np.asarray(ref.transform(Xj)), **F32)
    assert cases[0][1].dims_for_variance(0.8) == pca.dims_for_variance(0.8)
    assert cases[0][1].dims_for_variance(1.0) == pca.dims_for_variance(1.0)
    D = np.array(jmetrics.euclidean_pdist(Wj[:20], Wj[:20]))
    np.fill_diagonal(D, 0.0)
    lm = jbaselines.LMDSTransform(k=6).fit_from_distances(jnp.asarray(D))
    port = convert.baseline_from_arrays("lmds", k=6,
                                        pinv_coords=lm.pinv_coords,
                                        mean_sq=lm.mean_sq, device="cpu")
    dx = np.asarray(jmetrics.euclidean_pdist(Xj, Wj[:20]))
    np.testing.assert_allclose(
        port.transform_from_distances(torch.from_numpy(dx)).numpy(),
        np.asarray(lm.transform_from_distances(jnp.asarray(dx))), **F32)
    with pytest.raises(ValueError, match="no fields"):
        convert.baseline_from_arrays("rp", k=6, components=rp.matrix)


def test_baselines_fitted_independently_give_the_same_distances():
    W, X = _witness(12), _witness(13, 60)
    Wj, Xj = jnp.asarray(W), jnp.asarray(X)
    Wt, Xt = torch.from_numpy(W), torch.from_numpy(X)

    def dists(Y):
        Y = np.asarray(Y, np.float64)
        return np.sqrt(np.maximum(((Y[:, None] - Y[None]) ** 2).sum(-1), 0))

    pj, pt = jbaselines.PCATransform(k=5).fit(Wj), \
        tbaselines.PCATransform(k=5).fit(Wt)
    _assert_same_distances(dists(pt.transform(Xt)), dists(pj.transform(Xj)))
    np.testing.assert_allclose(np.abs(pt.components.numpy()),
                               np.abs(np.asarray(pj.components)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pt.explained_variance.numpy(),
                               np.asarray(pj.explained_variance), rtol=1e-4)
    mj, mt = jbaselines.MDSTransform(k=5).fit(Wj), \
        tbaselines.MDSTransform(k=5).fit(Wt)
    _assert_same_distances(dists(mt.transform(Xt)), dists(mj.transform(Xj)))
    D = np.array(jmetrics.euclidean_pdist(Wj[:30], Wj[:30]))
    np.fill_diagonal(D, 0.0)
    cj, ej, sj = jbaselines.classical_mds_embed(jnp.asarray(D), 5)
    ct, et, st = tbaselines.classical_mds_embed(torch.from_numpy(D), 5)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **F32)
    _assert_same_distances(dists(ct), dists(cj))
    lj = jbaselines.LMDSTransform(k=5).fit_from_distances(jnp.asarray(D))
    lt = tbaselines.LMDSTransform(k=5).fit_from_distances(torch.from_numpy(D))
    dx = np.asarray(jmetrics.euclidean_pdist(Xj, Wj[:30]))
    _assert_same_distances(
        dists(lt.transform_from_distances(torch.from_numpy(dx))),
        dists(lj.transform_from_distances(jnp.asarray(dx))))


def test_random_projection_from_the_reference_uniforms():
    key = jax.random.PRNGKey(5)
    want = jbaselines.RandomProjection(k=7).fit(40, key=key)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (40, 7))))
    got = tbaselines.RandomProjection(k=7).fit(40, uniforms=u)
    np.testing.assert_array_equal(got.matrix.numpy(), np.asarray(want.matrix))
    drawn = tbaselines.RandomProjection(k=7).fit(
        torch.zeros(3, 40), generator=torch.Generator().manual_seed(0))
    vals = set(np.round(drawn.matrix.numpy().ravel() * np.sqrt(7 / 3), 5))
    assert vals <= {-1.0, 0.0, 1.0}
    with pytest.raises(ValueError, match="uniforms"):
        tbaselines.RandomProjection(k=7).fit(41, uniforms=u)


def test_lmds_drops_dead_directions_like_the_reference():
    """l ~ k: near-zero eigenvalues get zero triangulation rows."""
    W = _witness(14, 8, 3)
    D = np.array(jmetrics.euclidean_pdist(jnp.asarray(W), jnp.asarray(W)))
    np.fill_diagonal(D, 0.0)
    lj = jbaselines.LMDSTransform(k=6).fit_from_distances(jnp.asarray(D))
    lt = tbaselines.LMDSTransform(k=6).fit_from_distances(torch.from_numpy(D))
    dead_j = np.all(np.asarray(lj.pinv_coords) == 0, axis=1)
    dead_t = np.all(lt.pinv_coords.numpy() == 0, axis=1)
    np.testing.assert_array_equal(dead_t, dead_j)
    assert dead_t.sum() >= 3  # 3-d data: directions 4..6 carry nothing


# -- reducers ---------------------------------------------------------------------


def test_reducer_menu_and_routing():
    assert treducers.REDUCER_NAMES == jreducers.REDUCER_NAMES
    assert treducers.DISTANCE_ONLY == jreducers.DISTANCE_ONLY
    with pytest.raises(ValueError, match="unknown reducer"):
        treducers.make_reducer("umap", 4)
    W = torch.from_numpy(_witness(15))
    for name in ("pca", "rp", "mds"):
        with pytest.raises(ValueError, match="Euclidean-coordinate"):
            treducers.make_reducer(name, 4, metric="jsd").fit(W)
    P = tmetrics.l1_normalize(W.abs())
    for name in treducers.DISTANCE_ONLY:
        r = treducers.make_reducer(name, 4, metric="jsd").fit(
            P, generator=torch.Generator().manual_seed(0))
        Pr = r.transform(P[:10])
        assert Pr.shape == (10, 4) and torch.isfinite(r.pdist(Pr, Pr)).all()


def test_reducers_match_the_reference_protocol():
    W, X = _witness(16), _witness(17, 40)
    Wj, Xj = jnp.asarray(W), jnp.asarray(X)
    Wt, Xt = torch.from_numpy(W), torch.from_numpy(X)
    key = jax.random.PRNGKey(4)
    for name in ("pca", "mds", "lmds"):  # deterministic fits
        rj = jreducers.make_reducer(name, 5).fit(Wj)
        rt = treducers.make_reducer(name, 5).fit(Wt)
        Xr, Yr = rj.transform(Xj), rt.transform(Xt)
        _assert_same_distances(rt.pdist(Yr, Yr), rj.pdist(Xr, Xr))
    rj = jreducers.make_reducer("zen", 5).fit(Wj, key=key)
    ids = _first_draw(key, W.shape[0], 5)
    rt = dataclasses.replace(treducers.make_reducer("zen", 5),
                             transform_=tpivots.select_references(
                                 Wt, 5, ids=ids))
    Xr, Yr = rj.transform(Xj), rt.transform(Xt)
    _assert_same_distances(rt.pdist(Yr, Yr), rj.pdist(Xr, Xr))
    rj = jreducers.make_reducer("rp", 5).fit(Wj, key=key)
    rt = treducers.make_reducer("rp", 5)
    rt = dataclasses.replace(rt, transform_=tbaselines.RandomProjection(
        k=5).fit(24, uniforms=_t(jax.random.uniform(key, (24, 5)))))
    Xr, Yr = rj.transform(Xj), rt.transform(Xt)
    _assert_same_distances(rt.pdist(Yr, Yr), rj.pdist(Xr, Xr))


# -- quality ----------------------------------------------------------------------


def _delta_zeta(seed, n=400, ties=False):
    rng = np.random.default_rng(seed)
    delta = rng.uniform(0.1, 2.0, n)
    zeta = delta * rng.uniform(0.7, 1.3, n)
    if ties:
        delta, zeta = np.round(delta, 1), np.round(zeta, 1)
    return delta, zeta


@pytest.mark.parametrize("ties", [False, True])
def test_quality_measures_equal_the_reference(ties):
    delta, zeta = _delta_zeta(20, ties=ties)
    for name in ("kruskal_stress", "sammon_stress", "quadratic_loss",
                 "spearman_rho"):
        want = getattr(jquality, name)(delta, zeta)
        assert getattr(tquality, name)(delta, zeta) == pytest.approx(
            want, rel=1e-12)
        # tensors (as a device run hands them over) give the same number
        assert getattr(tquality, name)(
            torch.from_numpy(delta).float(),
            torch.from_numpy(zeta).float()) == pytest.approx(
            getattr(jquality, name)(delta.astype(np.float32),
                                    zeta.astype(np.float32)), rel=1e-12)
    np.testing.assert_allclose(tquality._pava(zeta), jquality._pava(zeta),
                               rtol=1e-12)
    np.testing.assert_allclose(tquality.isotonic_fit(zeta, delta),
                               jquality.isotonic_fit(zeta, delta), rtol=1e-12)
    got = tquality.quality_profile(delta, zeta, qmax=50.0)
    want = jquality.quality_profile(delta, zeta, qmax=50.0)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12)


def test_quality_edge_cases_match_the_reference():
    for d, z in (([1.0], [2.0]), ([1.0, 1.0], [2.0, 3.0]),
                 ([1.0, 2.0], [0.0, 0.0])):
        for name in ("spearman_rho", "kruskal_stress"):
            a = getattr(tquality, name)(d, z)
            b = getattr(jquality, name)(d, z)
            assert (np.isnan(a) and np.isnan(b)) or a == b


def test_recall_measures_equal_the_reference():
    rng = np.random.default_rng(21)
    true = np.stack([rng.permutation(200)[:20] for _ in range(6)])
    approx = true.copy()
    approx[:, ::3] = rng.integers(200, 400, approx[:, ::3].shape)
    approx[0, 5] = -1
    assert tquality.batch_dcg_recall(true, approx) == pytest.approx(
        jquality.batch_dcg_recall(true, approx), rel=1e-12)
    assert tquality.dcg_recall(true[1], approx[1]) == pytest.approx(
        jquality.dcg_recall(true[1], approx[1]), rel=1e-12)
    assert tquality.recall_at_k(torch.from_numpy(true),
                                torch.from_numpy(approx)) == \
        jquality.recall_at_k(true, approx)
    np.testing.assert_allclose(tquality.rank_relevance(np.arange(1, 30), 20),
                               jquality.rank_relevance(np.arange(1, 30), 20),
                               rtol=1e-12)
    with pytest.raises(ValueError, match="query counts"):
        tquality.recall_at_k(true, approx[:2])


def test_pair_order_equals_the_reference():
    X = np.random.default_rng(22).standard_normal((30, 4)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    sub_j, (rj, cj) = jquality.pairwise_sample(jnp.asarray(X), 12, key)
    ids = np.asarray(jax.random.choice(key, 30, (12,), replace=False))
    sub_t, (rt, ct) = tquality.pairwise_sample(torch.from_numpy(X), 12,
                                               ids=ids)
    np.testing.assert_array_equal(sub_t.numpy(), np.asarray(sub_j))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    D = np.random.default_rng(23).standard_normal((9, 9)).astype(np.float32)
    np.testing.assert_array_equal(
        tquality.flatten_upper(torch.from_numpy(D)).numpy(),
        np.asarray(jquality.flatten_upper(jnp.asarray(D))))
    sub, (r, c) = tquality.pairwise_sample(
        torch.from_numpy(X), 50, generator=torch.Generator().manual_seed(0))
    assert sub.shape == (30, 4) and r.shape == (30 * 29 // 2,)


# -- generators -------------------------------------------------------------------


def test_paper_spaces_have_the_reference_form():
    gen = torch.Generator().manual_seed(0)
    P = tsyn.probability_space(50, 16, generator=gen)
    Q = tsyn.probability_space(50, 16, 4, generator=gen)
    for S in (P, Q):
        assert (S >= 0).all()
        torch.testing.assert_close(S.sum(1), torch.ones(50))
    U = tsyn.uniform_space(1000, 4, generator=gen)
    assert 0 <= float(U.min()) and float(U.max()) < 1
    assert abs(float(tsyn.gaussian_space(4000, 4, generator=gen).std())
               - 1) < 0.05
    assert float(tsyn.relu_feature_space(100, 8, 4, generator=gen).min()) \
        == 0.0


# -- the evaluation end to end --------------------------------------------------


def _measures(delta, zeta, qloss=False):
    out = {"kruskal": tquality.kruskal_stress(delta, zeta),
           "sammon": tquality.sammon_stress(delta, zeta),
           "spearman": tquality.spearman_rho(delta, zeta)}
    if qloss:
        out["qloss"] = tquality.quadratic_loss(delta, zeta) / delta.numel()
    return out


def _port_euclidean(space, n_witness, n_eval, m, k, seed):
    """benchmarks/paper_quality.py::euclidean_comparison with the port's
    modules, on the reference's data and draws."""
    key = jax.random.PRNGKey(seed)
    intrinsic = max(m // 8, 4)
    maker = {
        "manifold": lambda kk, n: jsyn.manifold_space(kk, n, m, intrinsic),
        "relu": lambda kk, n: jsyn.relu_feature_space(kk, n, m, intrinsic),
    }[space]
    W = _t(maker(key, n_witness))
    X = _t(maker(jax.random.fold_in(key, 1), n_eval))
    metric = "cosine" if space == "relu" else "euclidean"
    if metric == "cosine":
        W, X = tmetrics.l2_normalize(W), tmetrics.l2_normalize(X)
    delta = tquality.flatten_upper(tmetrics.pairwise(metric, X, X))
    ids = _first_draw(jax.random.fold_in(key, 2), n_witness, k)
    tr = tpivots.select_references(W, k, metric=metric, ids=ids)
    out = {}
    Xz = tr.transform(X)
    out["zen"] = _measures(delta, tquality.flatten_upper(zen_pdist(Xz, Xz)),
                           True)
    rp = tbaselines.RandomProjection(k=k).fit(m, uniforms=_t(
        jax.random.uniform(jax.random.fold_in(key, 3), (m, k))))
    for name, tr in (("pca", tbaselines.PCATransform(k=k).fit(W)), ("rp", rp),
                     ("mds", tbaselines.MDSTransform(k=k).fit(
                         W[:min(400, n_witness)]))):
        Y = tr.transform(X)
        out[name] = _measures(delta, tquality.flatten_upper(
            tops.pdist(Y, Y)), True)
    return out


def _port_jsd(n_eval, m, k, seed):
    """benchmarks/paper_quality.py::jsd_comparison with the port's modules
    and its dense dispatch, on the reference's data."""
    X = _t(jsyn.probability_space(jax.random.PRNGKey(seed), n_eval + k, m))
    R, X = X[:k], X[k:]
    D_refs = tops.jsd_pdist(R, R).fill_diagonal_(0.0)
    D_xr = tops.jsd_pdist(X, R)
    delta = tquality.flatten_upper(tops.jsd_pdist(X, X))
    Xz = NSimplexTransform.from_distances(D_refs).transform_from_distances(
        D_xr)
    Xl = tbaselines.LMDSTransform(k=k).fit_from_distances(
        D_refs).transform_from_distances(D_xr)
    return {
        "zen": _measures(delta, tquality.flatten_upper(tops.zen_estimate(
            Xz, Xz))),
        "lmds": _measures(delta, tquality.flatten_upper(tops.pdist(Xl, Xl))),
    }


def _assert_measures_close(got, want):
    assert got.keys() == want.keys()
    for method in want:
        for measure, value in want[method].items():
            assert got[method][measure] == pytest.approx(
                value, abs=E2E_ATOL), (method, measure)


@pytest.mark.parametrize("space", ["manifold", "relu"])
def test_euclidean_evaluation_agrees_with_paper_quality(paper_quality,
                                                        space):
    args = (space, 240, 120, 32, 8, 0)
    _assert_measures_close(_port_euclidean(*args),
                           paper_quality.euclidean_comparison(*args))


def test_jsd_evaluation_agrees_with_paper_quality(paper_quality):
    _assert_measures_close(_port_jsd(120, 48, 8, 0),
                           paper_quality.jsd_comparison(120, 48, 8, 0))


@pytest.mark.parametrize("strategy", ["farthest_first", "maxvol"])
def test_build_index_takes_the_pivot_strategies(strategy):
    """``build_index(pivots=...)`` fits the strategy's references, the
    reference's (and the golden file's) ids."""
    from repro_torch.launch import serve as tserve

    golden = np.load(GOLDEN)
    corpus = golden["corpus_euclid"]
    index = tserve.build_index(torch.from_numpy(corpus), 8, pivots=strategy,
                               device="cpu")
    np.testing.assert_array_equal(index.transform.refs.numpy(),
                                  corpus[golden[f"pivots_{strategy}_ids"]])
    with pytest.raises(ValueError, match="unknown pivot strategy"):
        tserve.build_index(torch.from_numpy(corpus), 8, pivots="best",
                           device="cpu")
