"""The port's IVF serving slice against the JAX package, on the CPU.

Inputs are seeded numpy arrays or the committed golden corpus
(``tests/golden/serving_golden.npz``) handed to both packages. The JAX
Pallas probe runs in interpret mode, its scan as it is.

Tolerances, and why:
  * probes and served results: rtol 1e-5 / atol 1e-5 on distances. Both
    sides evaluate the same f32 norm expansion on O(1) coordinates in
    different reduction orders; ids must be equal except where a swap is a
    near-tie within that tolerance (``repro_torch.testing.topk_mismatch``).
  * k-means iterates: rtol 1e-5 / atol 1e-5 on centroids and inertia. The
    segment sums add the same members in another order (``index_add_`` vs
    XLA's scatter-add); assignments must be equal except at near-ties.
  * packing, int8 codes and scales, ids and every count after churn: exact.
"""
import os
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")  # absent where only the port is installed

import jax.numpy as jnp  # noqa: E402

from repro.index import IVFZenIndex as JIVFZenIndex  # noqa: E402
from repro.index import ivf as jivf  # noqa: E402
from repro.index import kmeans as jkmeans  # noqa: E402
from repro.kernels import ivf_probe as jip  # noqa: E402
from repro.kernels import quantize as jquant  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import zen as tzen  # noqa: E402
from repro_torch.index import ivf as tivf  # noqa: E402
from repro_torch.index import kmeans as tkmeans  # noqa: E402
from repro_torch.kernels import ivf_probe as tip  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.testing import topk_mismatch  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "serving_golden.npz")
STORAGES = ["float32", "bfloat16", "int8"]


@pytest.fixture(autouse=True)
def _x32():
    """Other test modules flip ``jax_enable_x64`` on at import."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _coords(seed, n, k):
    """Apex-like rows: signed base coordinates, non-negative altitude."""
    x = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    x[:, -1] = np.abs(x[:, -1])
    return x


def _queries(seed, x, q, noise=0.05):
    rng = np.random.default_rng(seed)
    return (x[:q] + noise * rng.standard_normal((q, x.shape[1]))).astype(
        np.float32)


def _np(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype == jquant.BFLOAT16 else a


def _check(got, want, tol=TOL):
    msg = topk_mismatch(got[0], got[1], np.asarray(want[0]),
                        np.asarray(want[1]), **tol)
    assert msg is None, msg


def _port_ivf(jidx, **kw):
    """The JAX index's exact state in the port (an ``IVFZenIndex``)."""
    return convert.ivf_index_from_arrays(
        None, centroids=np.asarray(jidx.centroids),
        tile_coords=np.asarray(jidx.tile_coords),
        tile_ids=np.asarray(jidx.tile_ids),
        tiles_per_cluster=jidx.tiles_per_cluster, tile_rows=jidx.tile_rows,
        n_valid=jidx.n_valid, n_deleted=jidx.n_deleted, storage=jidx.storage,
        tile_scales=(None if jidx.tile_scales is None
                     else np.asarray(jidx.tile_scales)),
        codebooks=(None if jidx.codebooks is None
                   else np.asarray(jidx.codebooks)),
        generation=int(jidx.generation), device="cpu", **kw).ivf


def _assert_same_state(t, j):
    """Every field of two IVF indexes, bytes included."""
    assert (t.n_clusters, t.tiles_per_cluster, t.tile_rows, t.n_valid,
            t.n_deleted, t.storage, t.generation) == (
        j.n_clusters, j.tiles_per_cluster, j.tile_rows, j.n_valid,
        j.n_deleted, j.storage, int(j.generation))
    np.testing.assert_array_equal(_np(t.tile_ids), _np(j.tile_ids))
    np.testing.assert_array_equal(_np(t.tile_coords), _np(j.tile_coords))
    np.testing.assert_array_equal(_np(t.centroids), _np(j.centroids))
    for a, b in ((t.tile_scales, j.tile_scales), (t.codebooks, j.codebooks)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(_np(a), _np(b))
    np.testing.assert_array_equal(t.cluster_sizes(), j.cluster_sizes())


# -- k-means -------------------------------------------------------------------


def _jax_lloyd(x, init, n_clusters, n_iters, chunk):
    """The reference's own Lloyd loop, started from ``init``: its seeding
    is swapped for the given centroids and the jit is bypassed, so the
    trace is fresh for each call."""
    with mock.patch.object(jkmeans, "_seed_plus_plus",
                           lambda c, n, key: jnp.asarray(init)):
        return jkmeans.kmeans_fit.__wrapped__(
            jnp.asarray(x), n_clusters, key=jax.random.PRNGKey(0),
            n_iters=n_iters, chunk=chunk)


@pytest.mark.parametrize("seeds", ["jax_plus_plus", "far_centroids"])
@pytest.mark.parametrize("n_iters", [1, 2, 5])
def test_kmeans_iterates_match_jax(seeds, n_iters):
    """Each Lloyd iterate from the same seeds, with a clamped tail chunk
    (n = 300, chunk = 128) and, for ``far_centroids``, three clusters that
    start empty and are reseeded to the farthest points in order."""
    x = _coords(1, 300, 6)
    c = 12
    if seeds == "jax_plus_plus":
        init = np.array(jkmeans._seed_plus_plus(
            jnp.asarray(x), c, jax.random.PRNGKey(3)))
    else:
        init = x[:c].copy()
        init[[2, 5, 9]] = 1.0e3 + np.arange(3)[:, None]
    want_c, want_i = _jax_lloyd(x, init, c, n_iters, 128)
    got_c, got_i = tkmeans.kmeans_fit(torch.from_numpy(x), c,
                                      init=torch.from_numpy(init),
                                      n_iters=n_iters, chunk=128)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **TOL)
    np.testing.assert_allclose(float(got_i), float(want_i), **TOL)
    # assignment to the final centroids: equal outside near-ties
    cents = np.asarray(want_c)
    want_a = np.asarray(jkmeans.kmeans_assign(jnp.asarray(x),
                                              jnp.asarray(cents), chunk=128))
    got_a = tkmeans.kmeans_assign(torch.from_numpy(x),
                                  torch.from_numpy(cents), chunk=128).numpy()
    d2 = ((x[:, None, :] - cents[None]) ** 2).sum(-1)
    diff = np.flatnonzero(got_a != want_a)
    np.testing.assert_allclose(d2[diff, got_a[diff]], d2[diff, want_a[diff]],
                               **TOL)
    assert diff.size <= 1


@pytest.mark.parametrize("case", ["spread", "empty_clusters",
                                  "one_cluster_holds_every_row"])
def test_segment_sums_match_a_float64_sum(case):
    """The Lloyd update's per-cluster sums (a stable sort, then fixed-shape
    float64 partial sums) equal a float64 numpy sum within f32 rounding,
    with empty clusters and with one cluster of 3,000 rows (past one
    fold of ``FOLD`` rows, so two levels); counts exact."""
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((3000, 5))
         * 10.0 ** rng.uniform(-3, 3, (3000, 1))).astype(np.float32)
    n_seg = 40
    lab = rng.integers(0, n_seg, 3000)
    if case == "empty_clusters":
        lab[lab == 7] = 8
        lab[lab == n_seg - 1] = 0
    elif case == "one_cluster_holds_every_row":
        lab[:] = 5
    assert 3000 > tkmeans.FOLD
    sums, counts = tkmeans.segment_sums(torch.from_numpy(x),
                                        torch.from_numpy(lab), n_seg)
    want = np.zeros((n_seg, 5))
    np.add.at(want, lab, x.astype(np.float64))
    mass = np.zeros((n_seg, 5))
    np.add.at(mass, lab, np.abs(x.astype(np.float64)))
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(lab, minlength=n_seg))
    got = sums.to(torch.float32).numpy().astype(np.float64)
    assert (np.abs(got - want) <= 2.0 ** -24 * mass + 1e-30).all()
    empty = np.bincount(lab, minlength=n_seg) == 0
    assert (sums.numpy()[empty] == 0).all()
    again = tkmeans.segment_sums(torch.from_numpy(x), torch.from_numpy(lab),
                                 n_seg)[0]
    assert torch.equal(again, sums)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 5000])
def test_prefix_sums_match_cumsum(n):
    """The seeding's prefix sums (block scans of FOLD-row pieces, then of
    the piece totals) are the float64 cumulative sums."""
    w = np.random.default_rng(n).uniform(0, 3, n).astype(np.float32)
    got = tkmeans.prefix_sums(torch.from_numpy(w))
    assert got.dtype == torch.float64 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), np.cumsum(w.astype(np.float64)),
                               rtol=1e-13, atol=0)


def test_kmeans_seeding_draws_distinct_rows_from_the_generator():
    x = torch.from_numpy(_coords(2, 500, 5))
    g = torch.Generator().manual_seed(4)
    a = tkmeans._seed_plus_plus(x, 20, g)
    b = tkmeans._seed_plus_plus(x, 20, torch.Generator().manual_seed(4))
    assert torch.equal(a, b)
    rows = {int(torch.nonzero((x == r).all(1))[0]) for r in a}
    assert len(rows) == 20  # D^2 sampling never redraws a chosen row
    with pytest.raises(ValueError, match="n_clusters"):
        tkmeans.kmeans_fit(x[:3], 4)


# -- packing -------------------------------------------------------------------


@pytest.mark.parametrize("min_tiles", [1, 3])
@pytest.mark.parametrize("storage", STORAGES)
def test_pack_tiles_byte_identical(storage, min_tiles):
    """Same assignment -> the same tiles, ids, T, codes and scales."""
    x = _coords(3, 700, 7)
    rng = np.random.default_rng(4)
    assign = rng.choice(9, size=700, p=np.r_[[0.3], np.full(8, 0.7 / 8)])
    assign[assign == 4] = 5  # one empty cluster
    ids = rng.permutation(10_000)[:700]
    jp, jids, jT = jivf._pack_tiles(x, assign, ids, 9, 32,
                                    min_tiles=min_tiles)
    tp, tids, tT = tivf._pack_tiles(
        torch.from_numpy(x), torch.from_numpy(assign),
        torch.from_numpy(ids), 9, 32, min_tiles=min_tiles)
    assert tT == jT
    np.testing.assert_array_equal(tids.numpy(), jids)
    np.testing.assert_array_equal(tp.numpy(), jp)
    jv, js = jivf._encode_packed(jp, storage)
    tv, ts = tivf._encode_packed(tp, storage)
    np.testing.assert_array_equal(_np(tv), _np(jv))
    assert (ts is None) == (js is None)
    if ts is not None:
        np.testing.assert_array_equal(ts.numpy(), js)
        np.testing.assert_array_equal(
            ts.numpy(), jquant.cluster_scales(x, assign, 9))


# -- the probe -----------------------------------------------------------------


def _probe_case(storage):
    """A JAX IVF index with multi-tile clusters, padding and tombstones,
    6 queries, probes at nprobe = 2, and one query whose probed clusters
    hold fewer live rows than n (its probes are two nearly empty
    clusters)."""
    x = _coords(5, 600, 8)
    idx = JIVFZenIndex.build(jnp.asarray(x), 7, key=jax.random.PRNGKey(5),
                             tile_rows=64, storage=storage)
    sizes = idx.cluster_sizes()
    tids = np.asarray(idx.tile_ids).reshape(7, -1)
    small = np.argsort(sizes)[:2]
    # keep 3 live rows in each of the two smallest clusters, delete the rest
    dead = np.concatenate([tids[c][tids[c] >= 0][3:] for c in small])
    dead = np.concatenate([dead, np.arange(0, 600, 11)])
    idx = idx.delete(dead)
    q = _queries(6, x, 6)
    probes = np.array(idx.probe_clusters(jnp.asarray(q), 2))
    probes[-1] = small
    return idx, q, probes


@pytest.mark.parametrize("mode", ["zen", "lwb", "upb"])
@pytest.mark.parametrize("storage", STORAGES)
def test_probe_scan_matches_jax_kernel_and_scan(storage, mode):
    idx, q, probes = _probe_case(storage)
    T, n = idx.tiles_per_cluster, 9
    assert T >= 2
    args = (jnp.asarray(q), idx.tile_coords, idx.tile_ids,
            jnp.asarray(probes), n, mode)
    kw = dict(tiles_per_cluster=T, tile_scales=idx.tile_scales)
    want_k = jip.ivf_probe(*args, interpret=True, **kw)
    want_s = jip.ivf_probe_scan(*args, **kw)
    tidx = _port_ivf(idx)
    targs = (torch.from_numpy(q), tidx.tile_coords, tidx.tile_ids,
             torch.from_numpy(probes), n, mode)
    tkw = dict(tiles_per_cluster=T, tile_scales=tidx.tile_scales)
    got = tip.ivf_probe_scan(*targs, **tkw)
    assert got[1].dtype == torch.int32 and got[0].shape == (6, n)
    _check(got, want_k)
    _check(got, want_s)
    _check(tops.ivf_probe(*targs, **tkw), want_k)  # CPU dispatch: the scan
    # the last query's two probed clusters hold 6 live rows: the rest of
    # its slots are unfilled
    assert (got[1][-1, 6:] == -1).all() and torch.isinf(got[0][-1, 6:]).all()
    assert (got[1][-1, :6] >= 0).all()
    returned = set(got[1].numpy().ravel().tolist()) - {-1}
    assert not returned & set(range(0, 600, 11))


def test_probe_kernel_wrappers_take_cuda_tensors_only():
    idx, q, probes = _probe_case("float32")
    tidx = _port_ivf(idx)
    with pytest.raises(ValueError, match="CUDA"):
        tip.ivf_probe(torch.from_numpy(q), tidx.tile_coords, tidx.tile_ids,
                      torch.from_numpy(probes), 5,
                      tiles_per_cluster=tidx.tiles_per_cluster)
    codes = torch.zeros((4, 8, 2), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        tip.ivf_probe_pq(codes, torch.zeros((4, 8), dtype=torch.int32),
                         torch.zeros((3, 1), dtype=torch.int32),
                         torch.zeros((3, 1, 2, 256)), 5, tiles_per_cluster=2)


def test_probe_clusters_keep_lax_top_k_tie_order():
    """Equal centroid distances: the lower centroid id comes first."""
    cents = np.array([[1, 0, 1], [0, 1, 1], [1, 0, 1], [0, 0, 1],
                      [0, 1, 1]], np.float32)
    q = np.array([[0.5, 0.5, 1.0], [1.0, 0.0, 1.0]], np.float32)
    for mode in ("zen", "lwb", "upb"):
        want = np.asarray(jivf._probe_clusters(
            jnp.asarray(q), jnp.asarray(cents), 5, mode))
        got = tivf._probe_clusters(torch.from_numpy(q),
                                   torch.from_numpy(cents), 5, mode)
        np.testing.assert_array_equal(got.numpy(), want)


# -- the index: build, churn, search -------------------------------------------


@pytest.mark.parametrize("storage", STORAGES + ["pq"])
def test_churn_from_one_converted_state_matches_jax(storage):
    """delete -> upsert (replace, duplicates, enough rows to grow T) ->
    compact, from one state: the same bytes, counts and answers."""
    x = _coords(7, 500, 8)
    j = JIVFZenIndex.build(jnp.asarray(x), 6, key=jax.random.PRNGKey(8),
                           tile_rows=32, storage=storage, pq_m=4)
    t = _port_ivf(j)
    _assert_same_state(t, j)
    q = _queries(9, x, 5)
    rng = np.random.default_rng(10)
    # rows around one point land in one cluster and overflow it
    fresh = (x[:1] + 0.01 * _coords(11, 160, 8)).astype(np.float32)
    up_ids = np.r_[[3, 17, 17], 600 + np.arange(157)]
    steps = [
        ("delete", np.r_[np.arange(0, 500, 7), [10 ** 6]]),
        ("upsert", (up_ids, fresh)),
        ("delete", rng.choice(500, 40, replace=False)),
        ("compact", None),
    ]
    for op, arg in steps:
        if op == "delete":
            j, t = j.delete(arg), t.delete(arg)
        elif op == "upsert":
            T0 = t.tiles_per_cluster
            j = j.upsert(arg[0], jnp.asarray(arg[1]))
            t = t.upsert(arg[0], torch.from_numpy(arg[1]))
            assert t.tiles_per_cluster > T0  # grew by whole tiles
        else:
            j, t = j.compact(), t.compact()
        _assert_same_state(t, j)
        assert t.needs_compact() == j.needs_compact()
        assert t.tombstone_ratio == j.tombstone_ratio
        assert t.imbalance == pytest.approx(j.imbalance)
        for nprobe in (2, 6):
            _check(t.search(torch.from_numpy(q), 10, nprobe=nprobe),
                   j.search(jnp.asarray(q), 10, nprobe=nprobe))
    assert t.compact() is t  # nothing left to reclaim
    assert t.delete([10 ** 7]) is t and t.upsert([], np.zeros((0, 8))) is t


def test_recluster_keeps_ids_and_never_returns_deleted():
    x = torch.from_numpy(_coords(12, 400, 6))
    idx = tivf.IVFZenIndex.build(x, 8, tile_rows=16,
                                 generator=torch.Generator().manual_seed(1))
    dead = list(range(0, 400, 3))
    idx = idx.delete(dead)
    assert idx.needs_compact()
    for storage in ("float32", "int8", "pq"):
        base = tivf.IVFZenIndex.build(
            x, 8, tile_rows=16, storage=storage, pq_m=3,
            generator=torch.Generator().manual_seed(1)).delete(dead)
        new = base.compact(recluster=True, n_clusters=5,
                           generator=torch.Generator().manual_seed(2))
        assert (new.n_clusters, new.n_valid, new.n_deleted) == (5, 266, 0)
        live = set(new.tile_ids[new.tile_ids >= 0].tolist())
        assert live == set(range(400)) - set(dead)
        d, ids = new.search(x[:20], 10, nprobe=5)
        assert not set(ids.ravel().tolist()) & set(dead)
        assert torch.isfinite(d).all()


def test_full_probe_equals_flat_search():
    """nprobe = n_clusters scans every list: the flat estimator answer."""
    x = _coords(13, 900, 10)
    q = torch.from_numpy(_queries(14, x, 8))
    idx = tivf.IVFZenIndex.build(torch.from_numpy(x), 9, tile_rows=64,
                                 generator=torch.Generator().manual_seed(3))
    assert idx.tiles_per_cluster >= 2
    for mode in ("zen", "lwb", "upb"):
        got = idx.search(q, 12, nprobe=9, mode=mode)
        want = tzen.knn_search(q, torch.from_numpy(x), 12, mode)
        _check(got, want)


def test_search_shape_contract():
    x = torch.from_numpy(_coords(15, 64, 6))
    idx = tivf.IVFZenIndex.build(x, 64, generator=torch.Generator())
    d, ids = idx.search(x[:4], 10, nprobe=1)  # one row per cluster
    assert (ids[:, 0] >= 0).all() and (ids[:, 1:] == -1).all()
    assert torch.isinf(d[:, 1:]).all()
    empty = idx.delete(range(64))
    d, ids = empty.search(x[:3], 5)
    assert d.shape == (3, 5) and (ids == -1).all()
    assert empty.search(x[:2], 100)[0].shape == (2, 100)
    with pytest.raises(ValueError):
        idx.search(x[:2], 0)


# -- serving ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


#: the golden configurations of ``tools/make_golden.py`` (k = 8, 16
#: clusters, 10 neighbours) that run the IVF path
GOLDEN_IVF = {
    "ivf_exact": dict(nprobe=16),
    "ivf_probe4": dict(nprobe=4),
    "ivf_int8": dict(storage="int8", nprobe=16),
    "ivf_qform": dict(metric="qform", nprobe=16, rerank_factor=4),
    "ivf_pq": dict(storage="pq", pq_m=2, nprobe=16),
    "ivf_pq_rerank": dict(storage="pq", pq_m=2, nprobe=4, rerank_factor=4),
}


def _converted(jidx):
    tr = jidx.transform
    ptr = convert.transform_from_arrays(
        refs=np.asarray(tr.refs), chol=np.asarray(tr.base.chol),
        diag_g=np.asarray(tr.base.diag_g), d0=np.asarray(tr.base.d0),
        k=tr.k, metric=tr.metric, jitter=tr.jitter, device="cpu")
    iv = jidx.ivf
    return convert.ivf_index_from_arrays(
        ptr, centroids=np.asarray(iv.centroids),
        tile_coords=np.asarray(iv.tile_coords),
        tile_ids=np.asarray(iv.tile_ids),
        tiles_per_cluster=iv.tiles_per_cluster, tile_rows=iv.tile_rows,
        n_valid=iv.n_valid, n_deleted=iv.n_deleted, storage=iv.storage,
        tile_scales=(None if iv.tile_scales is None
                     else np.asarray(iv.tile_scales)),
        codebooks=None if iv.codebooks is None else np.asarray(iv.codebooks),
        generation=jidx.generation, corpus=np.asarray(jidx.corpus),
        device="cpu")


@pytest.mark.parametrize("name", sorted(GOLDEN_IVF))
def test_golden_ivf_config_served_like_live_jax(golden, name):
    """The golden IVF configurations, served end to end from one converted
    state, against the reference computed live here (the stored arrays
    drift on some hosts)."""
    cfg = dict(GOLDEN_IVF[name])
    build_kw = dict(metric=cfg.pop("metric", "euclidean"), index="ivf",
                    n_clusters=16, storage=cfg.pop("storage", "float32"),
                    pq_m=cfg.pop("pq_m", None), key=jax.random.PRNGKey(7))
    jidx = jserve.build_index(jnp.asarray(golden["corpus_euclid"]), 8,
                              **build_kw)
    q = golden["queries_euclid"]
    want = jserve.ZenServer(jidx, **cfg).query(jnp.asarray(q), 10)
    server = tserve.ZenServer(_converted(jidx), **cfg)
    got = server.query(torch.from_numpy(q), 10)
    assert got[0].shape == (16, 10) and got[1].dtype == torch.int32
    _check(got, want)


def test_server_churn_matches_jax(golden):
    """ZenServer delete -> upsert -> maybe_compact over one converted IVF
    state, re-rank on: the same answers and counters after each step."""
    corpus, q = golden["corpus_euclid"], golden["queries_euclid"]
    jidx = jserve.build_index(jnp.asarray(corpus), 8, index="ivf",
                              n_clusters=16, key=jax.random.PRNGKey(7))
    js = jserve.ZenServer(jidx, nprobe=4, rerank_factor=4)
    ts = tserve.ZenServer(_converted(jidx), nprobe=4, rerank_factor=4)
    served = np.asarray(js.query(jnp.asarray(q), 10)[1])[:, :2].ravel()
    dead = sorted(set(served.tolist()) | set(range(0, 512, 5)))
    fresh = np.random.default_rng(16).standard_normal(
        (6, corpus.shape[1])).astype(np.float32)
    for op in ("delete", "upsert", "compact"):
        for srv, lib in ((js, jnp), (ts, torch)):
            if op == "delete":
                srv.delete(dead)
            elif op == "upsert":
                vecs = (jnp.asarray(fresh) if lib is jnp
                        else torch.from_numpy(fresh))
                srv.upsert([512, 513, 514, 5, 10, 512], vecs)
            else:
                assert srv.maybe_compact()
        assert ts.index.size == js.index.size
        assert ts.index.generation == js.index.generation
        assert ts.index.ivf.n_deleted == js.index.ivf.n_deleted
        np.testing.assert_array_equal(_np(ts.index.ivf.tile_ids),
                                      _np(js.index.ivf.tile_ids))
        got = ts.query(torch.from_numpy(q), 10)
        _check(got, js.query(jnp.asarray(q), 10))
        back = set(got[1].numpy().ravel().tolist()) & (set(dead) - {5, 10})
        assert not back, (op, back)
    assert ts.stats()["deletes"] == js.stats()["deletes"]


def test_build_index_ivf_on_the_cpu():
    gen = torch.Generator().manual_seed(0)
    corpus = torch.randn((2_000, 24), generator=gen)
    pivots = list(range(0, 2_000, 250))
    flat = tserve.build_index(corpus, 8, pivot_ids=pivots, device="cpu")
    for storage in STORAGES + ["pq"]:
        index = tserve.build_index(
            corpus, 8, index="ivf", storage=storage, pivot_ids=pivots,
            device="cpu", generator=torch.Generator().manual_seed(1))
        assert index.ivf.n_clusters == round(4 * 2_000 ** 0.5)
        assert index.ivf.storage == storage and index.coords is None
        assert index.size == 2_000 and index.device.type == "cpu"
        server = tserve.ZenServer(index, nprobe=index.ivf.n_clusters,
                                  rerank_factor=4)
        got = server.query(corpus[:16], 10)
        moved = tserve.ZenServer(index.to("cpu"), nprobe=index.ivf.n_clusters,
                                 rerank_factor=4).query(corpus[:16], 10)
        assert torch.equal(moved[0], got[0]) and torch.equal(moved[1], got[1])
        # every list probed + an exact re-rank of a 40-candidate pool
        want = tserve.ZenServer(flat, rerank_factor=4).query(corpus[:16], 10)
        assert torch.isfinite(got[0]).all() and (got[1] >= 0).all()
        if storage == "float32":
            _check(got, want)
        else:  # quantised candidates, exactly re-ranked: mostly the same
            same = (got[1][:, :, None] == want[1][:, None, :]).any(-1)
            assert same.float().mean() > 0.8
    with pytest.raises(ValueError, match="IVF-only"):
        tserve.build_index(corpus, 8, storage="pq", device="cpu")


def test_cli_ivf_cpu_rehearsal(capsys):
    tserve.main(["--device", "cpu", "--index", "ivf", "--nprobe", "16",
                 "--n", "3000", "--dim", "64", "--k", "12", "--queries", "8",
                 "--batches", "2", "--storage", "pq"])
    out = capsys.readouterr().out
    assert "ivf: 219 clusters" in out and "storage=pq" in out
    rec = float(out.split("recall@10: ")[1].split()[0])
    assert rec > 0.5, out


#: (cluster, cols, splits) the warp plan gives nq queries over P probed
#: clusters of 384 rows (T = 3 tiles of 128) on an H100's 132 SMs: as many
#: blocks a query as the SMs share among the queries (at most 8), more
#: where a warp would take more than two items; splits of whole 64-row
#: steps that give the blocks' 16 warps about an item each
_WARP_GEOMETRY = {
    (64, 1): (1, 1, 6), (64, 2): (2, 1, 6), (64, 8): (2, 4, 3),
    (64, 64): (2, 32, 1), (64, 512): (8, 64, 1),
    (2, 1): (1, 1, 6), (2, 2): (2, 1, 6), (2, 8): (8, 1, 6),
    (2, 64): (8, 8, 2), (2, 512): (8, 64, 1),
}


@pytest.mark.parametrize("n", [1, 10, 64, 65, 2048, 16384])
@pytest.mark.parametrize("nq", [1, 2, 64])
def test_probe_plan_picks_the_plan(nq, n):
    """Lists up to 64 wide take the warp plan (one launch), wider ones the
    block plan (pass 1 and pass 2), at every Q and nprobe."""
    w = 1 << max(n - 1, 0).bit_length()
    for n_probe in (1, 2, 8, 64, 512):
        plan = tip.probe_plan(n, n_probe, k=16, nq=nq, cluster_rows=384)
        assert plan.w == w and plan.smem <= tip.SMEM_LIMIT
        if n > 64:
            assert plan == tip.block_plan(n, n_probe, k=16)
            assert plan.kernel == "block"  # pass 1 and pass 2
            assert plan.group >= 1 and plan.warps == plan.cluster == 0
            continue
        assert plan.kernel == "warp" and plan.cap == 0
        assert plan.group == plan.merge_smem == 0  # one launch, no pass 2
        geometry = (plan.cluster, plan.cols, plan.splits)
        assert geometry == _WARP_GEOMETRY[(max(nq, 2), n_probe)]
        assert plan.warps == min(16, plan.cols * plan.splits)
        assert plan.split_rows * plan.splits >= 384
        assert plan.split_rows * (plan.splits - 1) < 384
        # a candidate slot for every row of the block's columns
        assert plan.smem == tip.warp_smem(plan.cols * 384, plan.cols, 0,
                                          plan.cluster)
        # the plan is cached: the same object for the same arguments
        assert tip.probe_plan(n, n_probe, k=16, nq=nq,
                              cluster_rows=384) is plan


@pytest.mark.parametrize("cluster_rows", [1, 100, 384, 3_000, 29_000])
def test_probe_plan_past_shared_memory_takes_the_block_plan(cluster_rows):
    """A block's candidate slots (8 bytes a row of its columns' clusters)
    must fit shared memory: the planner gives a query more blocks first,
    then takes the block plan."""
    plan = tip.probe_plan(64, 8, k=16, nq=64, cluster_rows=cluster_rows)
    if tip.warp_smem(cluster_rows, 1, 0, 8) > tip.SMEM_LIMIT:
        assert plan.kernel == "block"
    else:
        assert plan.kernel == "warp"
        assert plan.smem == tip.warp_smem(plan.cols * cluster_rows,
                                          plan.cols, 0, plan.cluster)
        assert plan.smem <= tip.SMEM_LIMIT
