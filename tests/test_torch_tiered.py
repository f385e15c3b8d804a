"""The port's tiered (host-offloaded) IVF store against the JAX package, on
the CPU.

One state feeds both packages: the JAX package builds and offloads an IVF
index, and ``repro_torch.convert.tiered_index_from_arrays`` hands its host
pool, hot set and geometry to the port. The JAX Pallas staging copy runs in
interpret mode.

Tolerances, and why:
  * tiered search against the JAX tiered search: ids equal, distances to
    rtol 1e-5 / atol 1e-5. The same probe scores the same tiles in the same
    passes, merged in the same order; only the f32 reduction order of the
    estimator differs. Its norm expansion |q|^2 + |x|^2 - 2 q.x cancels
    terms of ~|x|^2 down to O(1) distances, so that order moves a distance
    by up to ~6e-6 relative here (measured): 1e-6 does not hold.
  * tiered against the port's resident index: ids equal outside exact ties
    and distances bit-equal (``topk_mismatch`` at rtol 0 / atol 0): one
    probe, one f32 arithmetic, other passes.
  * counters, byte accounting, hot sets and staged bytes: exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")  # absent where only the port is installed

import jax.numpy as jnp  # noqa: E402

from repro.index import ivf as jivf  # noqa: E402
from repro.kernels import tile_stage as jtile_stage  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.index import ivf as tivf  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import tile_stage as ttile_stage  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.testing import topk_mismatch  # noqa: E402

STORAGES = ["float32", "bfloat16", "int8"]
NEAR = dict(rtol=1e-5, atol=1e-5)
EXACT = dict(rtol=0.0, atol=0.0)


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


def _jax_tiered(seed=17, n=1500, k=8, c=16, storage="float32", hot=3,
                **kw):
    x = _coords(seed, n, k)
    jidx = jivf.IVFZenIndex.build(jnp.asarray(x), c,
                                  key=jax.random.PRNGKey(seed),
                                  storage=storage)
    jt = jivf.TieredIVFZenIndex.from_index(jidx, hot_clusters=hot,
                                           prefetch_cols=2, **kw)
    return x, jidx, jt


def _port_tiered(jt):
    """The JAX tiered store's exact state in the port."""
    return convert.tiered_index_from_arrays(
        None, centroids=np.asarray(jt.centroids), host_coords=jt.host_coords,
        host_ids=jt.host_ids, host_scales=jt.host_scales,
        hot_clusters=jt.hot_clusters, tiles_per_cluster=jt.tiles_per_cluster,
        tile_rows=jt.tile_rows, n_valid=jt.n_valid, storage=jt.storage,
        prefetch_cols=jt.prefetch_cols, n_shards=jt.n_shards,
        generation=jt.generation, device="cpu").ivf


def _port_resident(jidx):
    return convert.ivf_index_from_arrays(
        None, centroids=np.asarray(jidx.centroids),
        tile_coords=np.asarray(jidx.tile_coords),
        tile_ids=np.asarray(jidx.tile_ids),
        tiles_per_cluster=jidx.tiles_per_cluster, tile_rows=jidx.tile_rows,
        n_valid=jidx.n_valid, storage=jidx.storage,
        tile_scales=(None if jidx.tile_scales is None
                     else np.asarray(jidx.tile_scales)),
        device="cpu").ivf


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def _same_answers(got, want):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **NEAR)


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("nprobe", [1, 4, 16])
def test_tiered_search_matches_jax_tiered(storage, nprobe):
    """One converted state: equal answers and equal counters, batch after
    batch (the staging slots alternate and are reused)."""
    x, _, jt = _jax_tiered(storage=storage)
    pt = _port_tiered(jt)
    for b in range(3):
        q = _queries(b, x, 12)
        _same_answers(pt.search(torch.from_numpy(q), 10, nprobe),
                      jt.search(jnp.asarray(q), n_neighbors=10,
                                nprobe=nprobe))
        assert pt.stats() == jt.stats()
    assert pt.stats()["cold_uploads"] > 0 and pt.stats()["hot_hits"] > 0
    for nq in (1, 12, 64, 1000):
        assert pt.provisioned_device_bytes(nq) == \
            jt.provisioned_device_bytes(nq)
    assert pt.host_bytes() == jt.host_bytes()
    np.testing.assert_array_equal(pt._traffic, jt._traffic)


@pytest.mark.parametrize("storage", STORAGES)
def test_tiered_search_matches_port_resident(storage):
    """Hot pass + cold chunks give the resident probe's answer."""
    x, jidx, jt = _jax_tiered(seed=11, storage=storage)
    pt, resident = _port_tiered(jt), _port_resident(jidx)
    q = torch.from_numpy(_queries(3, x, 16))
    for nprobe in (1, 4, 16):
        got = pt.search(q, 10, nprobe)
        want = resident.search(q, 10, nprobe)
        msg = topk_mismatch(got[0], got[1], want[0], want[1], **EXACT)
        assert msg is None, (nprobe, msg)


@pytest.mark.parametrize("hot", [0, 12])
def test_tiered_all_hot_and_all_cold_extremes(hot):
    x = _coords(18, 900, 8)
    jidx = jivf.IVFZenIndex.build(jnp.asarray(x), 12,
                                  key=jax.random.PRNGKey(18))
    jt = jivf.TieredIVFZenIndex.from_index(jidx, hot_clusters=hot)
    pt = tivf.TieredIVFZenIndex.from_index(_port_resident(jidx),
                                           hot_clusters=hot)
    np.testing.assert_array_equal(pt.hot_clusters, jt.hot_clusters)
    q = _queries(2, x, 8)
    got = pt.search(torch.from_numpy(q), 10, 12)
    _same_answers(got, jt.search(jnp.asarray(q), n_neighbors=10, nprobe=12))
    want = _port_resident(jidx).search(torch.from_numpy(q), 10, 12)
    assert topk_mismatch(got[0], got[1], want[0], want[1], **EXACT) is None
    st = pt.stats()
    assert st == jt.stats()
    if hot == 0:
        assert st["cold_uploads"] > 0 and st["hot_hits"] == 0
    else:
        assert st["cold_uploads"] == 0 and st["hot_hits"] > 0
    assert pt.provisioned_device_bytes(8) >= st["device_bytes"]


def test_refresh_hot_picks_the_reference_hot_set():
    x, _, jt = _jax_tiered(seed=22)
    pt = _port_tiered(jt)
    q = _queries(5, x, 16)
    before = pt.search(torch.from_numpy(q), 10, 4)
    jt.search(jnp.asarray(q), n_neighbors=10, nprobe=4)
    for h in (None, 5):
        pt.refresh_hot(h)
        jt.refresh_hot(h)
        np.testing.assert_array_equal(pt.hot_clusters, jt.hot_clusters)
    after = pt.search(torch.from_numpy(q), 10, 4)
    _same_answers(after, jt.search(jnp.asarray(q), n_neighbors=10, nprobe=4))
    assert topk_mismatch(after[0], after[1], before[0], before[1],
                         **EXACT) is None
    assert pt.stats() == jt.stats()


def test_dead_shards_never_return_their_members():
    x, jidx, jt = _jax_tiered(seed=23, n=1200, hot=4, n_shards=4)
    pt = _port_tiered(jt)
    q = _queries(6, x, 12)
    for t in (pt, jt):
        t.set_dead_shards([1])
    d, ids = pt.search(torch.from_numpy(q), 10, 16)
    _same_answers((d, ids), jt.search(jnp.asarray(q), n_neighbors=10,
                                      nprobe=16))
    dead = np.flatnonzero(pt.shard_of_cluster() == 1)
    members = set(np.asarray(jidx.tile_ids).reshape(16, -1)[dead].ravel()
                  .tolist()) - {-1}
    assert members and not set(ids.numpy().ravel().tolist()) & members
    assert pt.stats()["masked_clusters"] == 4 and pt.stats() == jt.stats()
    with pytest.raises(ValueError, match="out of range"):
        pt.set_dead_shards([4])
    pt.set_dead_shards([])  # recovery restores the full answer
    got = pt.search(torch.from_numpy(q), 10, 16)
    want = _port_resident(jidx).search(torch.from_numpy(q), 10, 16)
    assert topk_mismatch(got[0], got[1], want[0], want[1], **EXACT) is None


@pytest.mark.parametrize("storage", STORAGES)
def test_tile_pool_snapshot_roundtrips_across_packages(tmp_path, storage):
    """The port's pool snapshot equals the reference's file for file;
    ``load(mmap=True)`` serves it straight off disk in both packages."""
    x, _, jt = _jax_tiered(seed=21, storage=storage)
    pt = _port_tiered(jt)
    q = _queries(4, x, 8)
    want = pt.search(torch.from_numpy(q), 10, 16)
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    pt.save(pdir)
    jt.save(jdir)
    for name in ("manifest.json", "centroids.npy", "tile_coords.npy",
                 "tile_ids.npy"):
        with open(f"{pdir}/{name}", "rb") as a, \
                open(f"{jdir}/{name}", "rb") as b:
            assert a.read() == b.read(), name
    for path in (pdir, jdir):
        back = tivf.TieredIVFZenIndex.load(path, mmap=True, hot_clusters=3,
                                           device="cpu")
        assert isinstance(back.host_coords, np.memmap)
        assert (back.size, back.storage) == (pt.size, storage)
        got = back.search(torch.from_numpy(q), 10, 16)
        np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
        np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    jback = jivf.TieredIVFZenIndex.load(pdir, mmap=True, hot_clusters=3)
    np.testing.assert_array_equal(_bits(jback.host_coords),
                                  _bits(jt.host_coords))
    _same_answers(want, jback.search(jnp.asarray(q), n_neighbors=10,
                                     nprobe=16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int32",
                                   "uint8"])
@pytest.mark.parametrize("block", [(128, 16), (128,), (128, 13), (5, 7, 3)])
def test_dma_copy_blocks_plain_matches_jax_interpret(dtype, block):
    """The plain staging copy is byte-equal to the Pallas kernel (interpret
    mode) on the dtypes and block shapes the card run checks; bf16 as its
    uint16 bits, taken from finite f32 values (the interpret mode rewrites
    NaN payloads, which tiles never hold)."""
    rng = np.random.default_rng(30)
    vals = (rng.standard_normal((3,) + block) * 50).astype(np.float32)
    src = ((vals.view(np.uint32) >> 16).astype(np.uint16)
           if dtype == "bfloat16" else vals.astype(dtype))
    jsrc = jnp.asarray(src.view(jnp.bfloat16) if dtype == "bfloat16"
                       else src)
    want = np.asarray(jtile_stage.dma_copy_blocks(jsrc, interpret=True))
    for got in (ttile_stage.dma_copy_blocks_plain(src, "cpu"),
                tops.dma_copy_blocks(src, "cpu"),
                ttile_stage.stage_blocks(src, "cpu")):
        assert got.numpy().tobytes() == want.tobytes()


def test_stage_blocks_on_the_cpu_copies():
    src = torch.arange(24, dtype=torch.int32).reshape(2, 3, 4)
    out = ttile_stage.stage_blocks(src, "cpu")
    src.zero_()
    assert out.flatten().tolist() == list(range(24))
    with pytest.raises(ValueError, match="CUDA target"):
        ttile_stage.dma_copy_blocks(src, "cpu")


def test_pq_offload_raises_as_the_reference():
    x = _coords(24, 600, 8)
    jidx = jivf.IVFZenIndex.build(jnp.asarray(x), 6,
                                  key=jax.random.PRNGKey(24), storage="pq")
    with pytest.raises(NotImplementedError, match="pq"):
        jivf.TieredIVFZenIndex.from_index(jidx)
    pidx = convert.ivf_index_from_arrays(
        None, centroids=np.asarray(jidx.centroids),
        tile_coords=np.asarray(jidx.tile_coords),
        tile_ids=np.asarray(jidx.tile_ids),
        tiles_per_cluster=jidx.tiles_per_cluster, tile_rows=jidx.tile_rows,
        n_valid=jidx.n_valid, storage="pq",
        codebooks=np.asarray(jidx.codebooks), device="cpu").ivf
    with pytest.raises(NotImplementedError, match="pq"):
        tivf.TieredIVFZenIndex.from_index(pidx)
    with pytest.raises(NotImplementedError, match="pq"):
        tserve.build_index(torch.from_numpy(x), 4, index="ivf", storage="pq",
                           offload=True, device="cpu")


def test_offloaded_server_is_serve_only_and_matches_resident():
    gen = torch.Generator().manual_seed(3)
    corpus = torch.randn((3_000, 24), generator=gen)
    queries = torch.randn((10, 24), generator=gen)
    kw = dict(index="ivf", pivot_ids=list(range(0, 3_000, 300)),
              device="cpu")
    resident = tserve.build_index(corpus, 10,
                                  generator=torch.Generator().manual_seed(0),
                                  **kw)
    tiered = tserve.build_index(corpus, 10, offload=True, hot_clusters=20,
                                offload_shards=2,
                                generator=torch.Generator().manual_seed(0),
                                **kw)
    assert isinstance(tiered.ivf, tivf.TieredIVFZenIndex)
    assert (tiered.ivf.hot_clusters.size, tiered.ivf.n_shards) == (20, 2)
    server = tserve.ZenServer(tiered, nprobe=16, rerank_factor=4)
    got = server.query(queries, 10)
    want = tserve.ZenServer(resident, nprobe=16, rerank_factor=4).query(
        queries, 10)
    assert topk_mismatch(got[0], got[1], want[0], want[1], **EXACT) is None
    tier = server.stats()["tier"]
    assert tier["cold_uploads"] > 0 and tier["host_bytes"] > 0
    assert not tiered.needs_compact()
    for call in (lambda: server.delete([1]),
                 lambda: server.upsert([5], corpus[:1]),
                 lambda: server.compact()):
        with pytest.raises(NotImplementedError, match="serve-only"):
            call()
    with pytest.raises(ValueError, match="index='ivf'"):
        tserve.build_index(corpus, 10, offload=True, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        tserve.build_index(corpus, 10, index="ivf", offload=True,
                           mesh=object(), device="cpu")


def test_churn_on_a_tiered_jax_state_raises_in_both():
    x, jidx, jt = _jax_tiered(seed=25)
    zi = convert.tiered_index_from_arrays(
        None, centroids=np.asarray(jt.centroids), host_coords=jt.host_coords,
        host_ids=jt.host_ids, hot_clusters=jt.hot_clusters,
        tiles_per_cluster=jt.tiles_per_cluster, tile_rows=jt.tile_rows,
        n_valid=jt.n_valid, device="cpu")
    jzi = jserve.ZenIndex(transform=None, coords=None, corpus=None, ivf=jt)
    for index in (zi, jzi):
        assert index._is_tiered()
        with pytest.raises(NotImplementedError, match="serve-only"):
            index.delete([0])
        with pytest.raises(NotImplementedError, match="serve-only"):
            index.compact()


def test_tiered_index_moves_between_devices_and_members_match():
    x, jidx, jt = _jax_tiered(seed=26, storage="int8")
    pt = _port_tiered(jt)
    moved = pt.to("cpu")
    np.testing.assert_array_equal(moved.hot_clusters, pt.hot_clusters)
    for raw in (True, False):
        got = pt._live_members(raw=raw)
        want = jt._live_members(raw=raw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
