"""The port's product quantiser and PQ probe against the JAX package, on the
CPU.

Inputs are seeded numpy arrays handed to both packages; codebooks are
trained by the reference (or from the same injected seeds in both), so the
comparison starts from one state. The JAX Pallas probe runs in interpret
mode (``ops.ivf_probe_pq(..., force_kernel=True)``), its scan as it is.

Tolerances, and why:
  * codes, decoded rows, split views and the geometry helpers: exact. The
    encoder is an argmin over the same few-column distances and the decoder
    a gather.
  * tables and probe distances: rtol 1e-5 / atol 1e-5. Both sides evaluate
    the same f32 expansion in different reduction orders; ids must be equal
    except at near-ties within that tolerance
    (``repro_torch.testing.topk_mismatch``).
  * codebooks trained from injected seeds: rtol 1e-5 / atol 1e-5 (the
    segment sums add the same members in another order).
"""
import itertools
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")  # absent where only the port is installed

import jax.numpy as jnp  # noqa: E402

from repro.index import IVFZenIndex as JIVFZenIndex  # noqa: E402
from repro.index import kmeans as jkmeans  # noqa: E402
from repro.kernels import ivf_probe as jip  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import pq as jpq  # noqa: E402
from repro.kernels import scoring as jscoring  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import zen as tzen  # noqa: E402
from repro_torch.index import ivf as tivf  # noqa: E402
from repro_torch.kernels import ivf_probe as tip  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import pq as tpq  # noqa: E402
from repro_torch.kernels import scoring as tscoring  # noqa: E402
from repro_torch.testing import topk_mismatch  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
MODES = ["zen", "lwb", "upb"]
#: (k, M): M divides k; M does not (padded subspace columns); one subspace
GEOMETRIES = [(8, 2), (10, 3), (6, 1)]


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


def _check(got, want):
    msg = topk_mismatch(got[0], got[1], np.asarray(want[0]),
                        np.asarray(want[1]), **TOL)
    assert msg is None, msg


def _jax_books(residuals, m):
    """Codebooks the reference trains (seed 0), as numpy."""
    return np.asarray(jpq.train_codebooks(residuals, m, n_iters=4))


# -- geometry, encode, decode -------------------------------------------------


@pytest.mark.parametrize("k", [1, 4, 7, 16, 33])
def test_geometry_helpers_match_jax(k):
    assert tpq.default_m(k) == jpq.default_m(k)
    for m in range(1, k + 1):
        assert tpq.subspace_dims(k, m) == jpq.subspace_dims(k, m)
        assert tpq.code_bytes(1000, m) == jpq.code_bytes(1000, m)
    x = _coords(k, 5, k)
    m = max(1, k // 3)
    np.testing.assert_array_equal(
        tpq.split_subspaces(torch.from_numpy(x), m).numpy(),
        jpq.split_subspaces(x, m))
    with pytest.raises(ValueError, match="pq_m"):
        tpq.subspace_dims(k, k + 1)


@pytest.mark.parametrize("n_train", [90, 400])
@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_encode_decode_byte_identical_from_the_same_codebooks(k, m,
                                                              n_train):
    """The reference's codebooks (with fewer than 256 training rows the
    trailing entries repeat entry 0) encode fresh rows to the same bytes
    and decode them to the same floats."""
    books = _jax_books(_coords(1, n_train, k), m)
    if n_train < tpq.PQ_ENTRIES:
        np.testing.assert_array_equal(books[:, n_train:],
                                      np.repeat(books[:, :1],
                                                256 - n_train, 1))
    rows = _coords(2, 300, k)
    want = jpq.encode(rows, books)
    got = tpq.encode(torch.from_numpy(rows), torch.from_numpy(books))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    if n_train < tpq.PQ_ENTRIES:  # a repeated entry never wins a tie
        assert int(got.max()) < n_train
    np.testing.assert_array_equal(
        tpq.decode(got, torch.from_numpy(books), k).numpy(),
        jpq.decode(want, books, k))
    assert tpq.encode(torch.zeros((0, k)), torch.from_numpy(books)).shape \
        == (0, m)
    with pytest.raises(ValueError, match="codes"):
        tpq.decode(torch.zeros((3, m + 1), dtype=torch.uint8),
                   torch.from_numpy(books), k)


@pytest.mark.parametrize("n", [90, 400])
def test_train_codebooks_from_injected_seeds_match_jax(n):
    """Each subspace's Lloyd fit from the same initial entries: the same
    codebooks, including the repeat-entry-0 tail when n < 256."""
    k, m = 10, 3
    res = _coords(3, n, k)
    sub = jpq.split_subspaces(res, m)
    entries = min(n, tpq.PQ_ENTRIES)
    inits = [np.array(jkmeans._seed_plus_plus(
        jnp.asarray(sub[:, i]), entries, jax.random.PRNGKey(20 + i)))
        for i in range(m)]
    calls = itertools.count()
    lloyd = jkmeans.kmeans_fit.__wrapped__  # the un-jitted reference fit

    def seeded_fit(x, n_clusters, *, key, n_iters):
        init = inits[next(calls)]
        with mock.patch.object(jkmeans, "_seed_plus_plus",
                               lambda c, n, key: jnp.asarray(init)):
            return lloyd(x, n_clusters, key=key, n_iters=n_iters)

    with mock.patch.object(jkmeans, "kmeans_fit", seeded_fit):
        want = jpq.train_codebooks(res, m, n_iters=3)
    got = tpq.train_codebooks(torch.from_numpy(res), m,
                              init=torch.from_numpy(np.stack(inits)),
                              n_iters=3)
    assert got.shape == (m, tpq.PQ_ENTRIES, 4)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the padded fourth column of the last subspace stays exactly zero
    assert (got[-1, :, 2:] == 0).all()
    empty = tpq.train_codebooks(torch.zeros((0, k)), m)
    assert empty.shape == (m, 256, 4) and not empty.any()


# -- tables -------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_build_luts_match_jax(k, m, mode):
    rng = np.random.default_rng(4)
    q = _coords(5, 6, k)
    cents = _coords(6, 7, k)
    books = _jax_books(_coords(7, 300, k) - cents[rng.integers(0, 7, 300)],
                       m)
    probes = np.stack([rng.permutation(7)[:3] for _ in range(6)]).astype(
        np.int32)
    mid = tscoring.MODE_IDS[mode]
    want = jpq.build_luts(jnp.asarray(q), jnp.asarray(cents),
                          jnp.asarray(books), jnp.asarray(probes), mid)
    got = tpq.build_luts(torch.from_numpy(q), torch.from_numpy(cents),
                         torch.from_numpy(books), torch.from_numpy(probes),
                         mid)
    assert got.shape == (6, 3, m, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the gathered sum is the estimator on the decoded member
    codes = rng.integers(0, 256, (4, m)).astype(np.uint8)
    for qi, pi in ((0, 0), (5, 2)):
        c = probes[qi, pi]
        xhat = cents[c] + tpq.decode(torch.from_numpy(codes),
                                     torch.from_numpy(books), k).numpy()
        est = tzen.estimate_pdist(torch.from_numpy(q[qi:qi + 1]),
                                  torch.from_numpy(xhat), mode)[0] ** 2
        z2 = got[qi, pi].gather(1, torch.from_numpy(codes.T).long()).sum(0)
        np.testing.assert_allclose(z2.numpy(), est.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_lut_estimate_rows_matches_jax():
    rng = np.random.default_rng(8)
    luts = (rng.standard_normal((5, 3, 256)) ** 2).astype(np.float32)
    luts[0, :, :] -= 10.0  # negative sums clamp to zero
    codes = rng.integers(0, 256, (5, 40, 3)).astype(np.uint8)
    want = jscoring.lut_estimate_rows(jnp.asarray(luts), jnp.asarray(codes))
    got = tscoring.lut_estimate_rows(torch.from_numpy(luts),
                                     torch.from_numpy(codes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got[0] == 0).all()


# -- the PQ probe -------------------------------------------------------------


def _pq_case(k=8, m=4):
    """A JAX PQ index with multi-tile clusters, padding and tombstones,
    6 queries probing 2 clusters, the last one probing the two smallest
    clusters, which keep 3 live rows each."""
    x = _coords(9, 500, k)
    idx = JIVFZenIndex.build(jnp.asarray(x), 6, key=jax.random.PRNGKey(3),
                             tile_rows=48, storage="pq", pq_m=m, n_iters=4)
    idx = idx.delete(np.arange(1, 500, 13))
    tids = np.asarray(idx.tile_ids).reshape(6, -1)
    small = np.argsort(idx.cluster_sizes())[:2]
    idx = idx.delete(np.concatenate([tids[c][tids[c] >= 0][3:]
                                     for c in small]))
    q = _queries(10, x, 6)
    probes = np.array(idx.probe_clusters(jnp.asarray(q), 2))
    probes[-1] = small
    return idx, q, probes


@pytest.mark.parametrize("mode", MODES)
def test_pq_probe_scan_matches_jax_kernel_and_scan(mode):
    idx, q, probes = _pq_case()
    T, n = idx.tiles_per_cluster, 9
    assert T >= 2
    luts = jpq.build_luts(jnp.asarray(q), idx.centroids, idx.codebooks,
                          jnp.asarray(probes), tscoring.MODE_IDS[mode])
    jargs = (idx.tile_coords, idx.tile_ids, jnp.asarray(probes), luts, n)
    want_k = jops.ivf_probe_pq(*jargs, tiles_per_cluster=T,
                               force_kernel=True)
    want_s = jip.ivf_probe_pq_scan(*jargs, tiles_per_cluster=T)
    targs = (torch.from_numpy(np.asarray(idx.tile_coords)),
             torch.from_numpy(np.asarray(idx.tile_ids)),
             torch.from_numpy(probes), torch.from_numpy(np.asarray(luts)), n)
    got = tip.ivf_probe_pq_scan(*targs, tiles_per_cluster=T)
    assert got[0].shape == (6, n) and got[1].dtype == torch.int32
    _check(got, want_k)
    _check(got, want_s)
    _check(tops.ivf_probe_pq(*targs, tiles_per_cluster=T), want_k)
    # 6 live rows under the last query's probes: the rest stay unfilled
    assert (got[1][-1, 6:] == -1).all() and torch.isinf(got[0][-1, 6:]).all()
    assert (got[1][-1, :6] >= 0).all()
    assert not set(got[1].numpy().ravel().tolist()) & set(range(1, 500, 13))


@pytest.mark.parametrize("mode", MODES)
def test_pq_index_search_matches_jax(mode):
    """The converted PQ index searched end to end (probe order, tables,
    probe) at a few nprobe, against the reference's own search."""
    idx, q, _ = _pq_case(k=10, m=3)
    t = convert.ivf_index_from_arrays(
        None, centroids=np.asarray(idx.centroids),
        tile_coords=np.asarray(idx.tile_coords),
        tile_ids=np.asarray(idx.tile_ids),
        tiles_per_cluster=idx.tiles_per_cluster, tile_rows=idx.tile_rows,
        n_valid=idx.n_valid, n_deleted=idx.n_deleted, storage="pq",
        codebooks=np.asarray(idx.codebooks), device="cpu").ivf
    for nprobe in (1, 3, 6):
        _check(t.search(torch.from_numpy(q), 12, nprobe=nprobe, mode=mode),
               idx.search(jnp.asarray(q), 12, nprobe=nprobe, mode=mode))


def test_pq_full_probe_is_the_flat_search_over_decoded_rows():
    """nprobe = n_clusters: the table path equals the flat estimator search
    over what the index stores (each member decoded against its
    centroid)."""
    x = torch.from_numpy(_coords(11, 700, 12))
    idx = tivf.IVFZenIndex.build(x, 10, tile_rows=64, storage="pq",
                                 generator=torch.Generator().manual_seed(2),
                                 n_iters=5)
    decoded = torch.zeros_like(x)
    tiles = idx._host_tiles_f32().reshape(-1, 12)
    ids = idx.tile_ids.reshape(-1).long()
    decoded[ids[ids >= 0]] = tiles[ids >= 0]
    q = torch.from_numpy(_queries(12, x.numpy(), 7))
    for mode in MODES:
        got = idx.search(q, 10, nprobe=10, mode=mode)
        want = tzen.knn_search(q, decoded, 10, mode)
        msg = topk_mismatch(got[0], got[1], want[0], want[1], rtol=1e-4,
                            atol=1e-4)
        assert msg is None, msg


@pytest.mark.parametrize("n", [1, 10, 64, 65, 2048, 16384])
@pytest.mark.parametrize("pq_m", [1, 4, 256])
def test_pq_probe_plan_picks_the_plan(pq_m, n):
    """The PQ probe's plans at every Q and nprobe: the warp plan (one
    launch) up to width 64, with the tables of as many of each column's
    first subspaces as fit beside the block's candidates in shared memory
    (all 4 at the serving shape), the rest read from global memory; the
    block plan (two launches) past it."""
    w = 1 << max(n - 1, 0).bit_length()
    for nq, n_probe in itertools.product((1, 2, 64), (1, 2, 8, 64, 512)):
        plan = tip.probe_plan(n, n_probe, pq_m=pq_m, nq=nq,
                              cluster_rows=384)
        assert plan.w == w and plan.smem <= tip.SMEM_LIMIT
        assert 0 <= plan.m_smem <= pq_m
        if n > 64:
            assert plan == tip.block_plan(n, n_probe, pq_m=pq_m)
            assert plan.kernel == "block" and plan.m_smem >= 1
            continue
        assert plan.kernel == "warp" and plan.group == 0  # one launch
        slots = plan.cols * 384
        assert plan.smem == tip.warp_smem(slots, plan.cols, plan.m_smem,
                                          plan.cluster)
        # as many tables as fit: one more subspace of every column would not
        if plan.m_smem < pq_m:
            assert tip.warp_smem(slots, plan.cols, plan.m_smem + 1,
                                 plan.cluster) > tip.SMEM_LIMIT
    serving = tip.probe_plan(64, 8, pq_m=pq_m, nq=64, cluster_rows=384)
    assert serving.m_smem == min(pq_m, 52)
