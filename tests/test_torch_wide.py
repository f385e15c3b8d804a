"""Wide result lists: the port's servers against the JAX package, on the CPU,
and the launch planners of the Hopper search kernels.

A request for ``n`` neighbours with re-rank 4 fetches
``bucket_neighbors(4 n)`` candidates: 512 for n = 65 and 128, 2,048 for
n = 300, wider than the 256 the card's kernels once took. The reference
serves every width; so must the port. One fitted state feeds both
packages (``repro_torch.convert``), so the search, re-rank and id mapping
see the same bytes.

Data: numpy-seeded apex-like corpora (N = 3,000, dim 32; k = 8, and
k = 300 over dim 320 for the flat index), 16 queries next to corpus rows.
Tolerance on the re-ranked distances: rtol 1e-5 and atol 1e-5 x the
median query norm. Only the f32 reduction order differs, but the queries
sit next to corpus rows, so the expansion |q|^2 + |x|^2 - 2 q.x cancels
terms ~|x|^2 down to a small distance and its rounding scales with the
norms, not with the distance (as in ``tests/test_torch_gpu.py``). Ids
equal outside near-ties (``repro_torch.testing.topk_mismatch``).

The planners (``zen_topk.launch_geometry``, ``ivf_probe.probe_plan``) are
pure Python: every power-of-two width from 1 to 2**18 must give a launch
whose shared memory fits one block of an H100 (232,448 B, less 1 KB for
the kernels' static shared variables), whose candidate buffer
holds a whole list, and whose pass 2 fits; ``zen_topk``'s plan is the
MMA plan wherever that fits, for every storage width.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")  # absent where only the port is installed

import jax.numpy as jnp  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ivf_probe as tip  # noqa: E402
from repro_torch.kernels import zen_topk as tzt  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.testing import topk_mismatch  # noqa: E402

WIDE_N = [65, 128, 300]
RTOL = 1e-5
N_ROWS, DIM, K, N_CLUSTERS, NPROBE = 3_000, 32, 8, 16, 12


@pytest.fixture(autouse=True)
def _x32():
    """Other test modules flip ``jax_enable_x64`` on at import."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _corpus(seed, n, dim):
    return np.random.default_rng(seed).standard_normal((n, dim)).astype(
        np.float32)


def _queries(seed, corpus, q=16, noise=0.05):
    rng = np.random.default_rng(seed)
    return (corpus[:q] + noise * rng.standard_normal(
        (q, corpus.shape[1]))).astype(np.float32)


def _transform(jidx):
    tr = jidx.transform
    return convert.transform_from_arrays(
        refs=np.asarray(tr.refs), chol=np.asarray(tr.base.chol),
        diag_g=np.asarray(tr.base.diag_g), d0=np.asarray(tr.base.d0),
        k=tr.k, metric=tr.metric, jitter=tr.jitter, device="cpu")


def _opt(a):
    return None if a is None else np.asarray(a)


def _port_flat(jidx):
    return convert.index_from_arrays(
        _transform(jidx), coords=np.asarray(jidx.coords),
        storage=jidx.storage, coord_scales=_opt(jidx.coord_scales),
        row_ids=_opt(jidx.row_ids), n_valid=jidx.n_valid,
        n_deleted=jidx.n_deleted, corpus=np.asarray(jidx.corpus),
        generation=jidx.generation, device="cpu")


def _port_ivf(jidx):
    iv = jidx.ivf
    return convert.ivf_index_from_arrays(
        _transform(jidx), centroids=np.asarray(iv.centroids),
        tile_coords=np.asarray(iv.tile_coords),
        tile_ids=np.asarray(iv.tile_ids),
        tiles_per_cluster=iv.tiles_per_cluster, tile_rows=iv.tile_rows,
        n_valid=iv.n_valid, n_deleted=iv.n_deleted, storage=iv.storage,
        tile_scales=_opt(iv.tile_scales), codebooks=_opt(iv.codebooks),
        generation=jidx.generation, corpus=np.asarray(jidx.corpus),
        device="cpu")


def _port_tiered(jidx):
    jt = jidx.ivf
    return convert.tiered_index_from_arrays(
        _transform(jidx), centroids=np.asarray(jt.centroids),
        host_coords=jt.host_coords, host_ids=jt.host_ids,
        host_scales=jt.host_scales, hot_clusters=jt.hot_clusters,
        tiles_per_cluster=jt.tiles_per_cluster, tile_rows=jt.tile_rows,
        n_valid=jt.n_valid, storage=jt.storage,
        prefetch_cols=jt.prefetch_cols, n_shards=jt.n_shards,
        generation=jt.generation, corpus=np.asarray(jidx.corpus),
        device="cpu")


_BUILT = {}


def _built(name):
    """(JAX index, port index, queries) of one configuration, built once."""
    if name not in _BUILT:
        dim, k = (320, 300) if name == "flat_k300" else (DIM, K)
        corpus = _corpus(3, N_ROWS, dim)
        kw = dict(key=jax.random.PRNGKey(3))
        if name.startswith("ivf") or name == "tiered":
            kw.update(index="ivf", n_clusters=N_CLUSTERS)
        if name == "flat_int8":
            kw["storage"] = "int8"
        if name == "ivf_pq":
            kw.update(storage="pq", pq_m=4)
        if name == "tiered":
            kw.update(offload=True, hot_clusters=4)
        jidx = jserve.build_index(jnp.asarray(corpus), k, **kw)
        port = {"ivf_f32": _port_ivf, "ivf_pq": _port_ivf,
                "tiered": _port_tiered}.get(name, _port_flat)(jidx)
        _BUILT[name] = (jidx, port, _queries(4, corpus))
    return _BUILT[name]


@pytest.mark.parametrize("n", WIDE_N)
@pytest.mark.parametrize("name", ["flat_f32", "flat_int8", "ivf_f32",
                                  "ivf_pq", "tiered", "flat_k300"])
def test_server_serves_wide_lists_like_jax(name, n):
    """n in {65, 128, 300} at re-rank 4 (fetch widths 512, 512, 2,048):
    the port's server gives the reference's answers."""
    jidx, port, q = _built(name)
    kw = dict(rerank_factor=4)
    if not name.startswith("flat"):
        kw["nprobe"] = NPROBE
    got = tserve.ZenServer(port, **kw).query(torch.from_numpy(q), n)
    want = jserve.ZenServer(jidx, **kw).query(jnp.asarray(q), n)
    assert got[0].shape == (q.shape[0], n) and got[1].dtype == torch.int32
    assert tserve.ZenServer(port, **kw)._query_geometry(n)[1] == (
        2_048 if n == 300 else 512)
    wd, wi = np.array(want[0]), np.array(want[1])
    atol = RTOL * float(np.median(np.linalg.norm(q, axis=1)))
    msg = topk_mismatch(got[0], got[1], torch.from_numpy(wd),
                        torch.from_numpy(wi), rtol=RTOL, atol=atol)
    assert msg is None, msg


# -- the launch planners ------------------------------------------------------

WIDTHS = [1 << e for e in range(19)]   # 1 .. 2**18


@pytest.mark.parametrize("k", [1, 16, 256, 300, 1024])
@pytest.mark.parametrize("w", WIDTHS)
def test_topk_plan_fits_every_width(w, k):
    """Every width, k and storage (4, 2 and 1 bytes a coordinate) gets a
    plan that fits shared memory and covers the index: the MMA plan where
    its lists and a two-stage ring fit, the SIMT plan elsewhere."""
    for nq, n_index in ((64, 1_000_000), (1, w), (7, 3 * w + 5)):
        for es in (4, 2, 1):
            plan = tzt.launch_geometry(nq, n_index, w, k, 132, es)
            assert plan.w == w and plan.cap >= w
            assert plan.cap & (plan.cap - 1) == 0
            assert plan.smem <= tzt.SMEM_LIMIT
            assert plan.n_split >= 1
            assert plan.split_rows % plan.tile_rows == 0
            assert plan.n_split * plan.split_rows >= n_index
            assert (plan.n_split - 1) * plan.split_rows < n_index
            assert plan.n_lists >= plan.n_split
            assert plan.n_lists & (plan.n_lists - 1) == 0
            if plan.merge_smem:  # pass 2 in shared memory
                assert plan.merge_smem == 8 * plan.n_lists * w
                assert plan.merge_smem <= tzt.SMEM_LIMIT
            else:                # pass 2 in place in global memory
                assert 8 * plan.n_lists * w > tzt.SMEM_LIMIT
            mma_fits = w <= tzt.MMA_MAX_W and k <= tzt.MMA_MAX_K
            assert (plan.kernel == "mma") == mma_fits
            if plan.kernel == "mma":
                assert plan.smem == tzt.mma_smem(k, es, w, plan.warps,
                                                 plan.tile_rows, plan.stages)
                assert plan.cap == 64 and not plan.global_lists
                assert 1 <= plan.warps <= 16 and 2 <= plan.stages <= 8
                assert plan.tile_rows == 128
                streams, groups = plan.streams, plan.warps // plan.streams
                assert streams in (1, 2, 4) and plan.stages % streams == 0
                assert plan.warps == groups * streams
                assert plan.queries_per_block == 8 * groups
                assert groups == min(8, -(-nq // 8)) or tzt.mma_smem(
                    k, es, w, 2 * groups, plan.tile_rows,
                    2) > tzt.SMEM_LIMIT
                assert plan.blocks_per_sm * (plan.smem + 1_024) <= \
                    tzt.SMEM_SM or plan.blocks_per_sm == 1
                assert plan.blocks_per_sm * plan.warps <= 16
                assert plan.merge_smem > 0
            else:
                assert plan.smem == tzt.simt_smem(k, w, plan.cap,
                                                  plan.queries_per_block,
                                                  plan.global_lists)
                assert plan.queries_per_block in (8, 4, 2, 1)
                assert not plan.global_lists or plan.queries_per_block == 1
                assert plan.blocks_per_sm == (
                    2 if plan.smem <= tzt.SMEM_TWO_BLOCKS else 1)
                assert plan.tile_rows == 512 and plan.warps == 0
                assert not plan.shares_bound(w)


def test_topk_plan_keeps_the_serving_geometry():
    """The 1e6-row serving batch (Q = 64, k = 16, width 64) takes the MMA
    plan: 16 consumer warps in two row streams (64 queries) a block, one
    block an SM of 200,832 bytes, a ring of 8 stages of 128 rows, 131
    splits of 7,680 rows merged in shared memory, and a bound shared
    across its 262 lists. Widths 512, 2,048 and 16,384 take the SIMT plan
    (8 queries a block, one block an SM of 133,760 bytes; 4 queries a
    block; one, with lists in global memory)."""
    plan = tzt.launch_geometry(64, 1_000_000, 64, 16, 132)
    assert (plan.kernel, plan.warps, plan.streams, plan.queries_per_block,
            plan.smem, plan.blocks_per_sm, plan.tile_rows, plan.stages,
            plan.n_split, plan.split_rows, plan.n_lists,
            plan.merge_smem) == ("mma", 16, 2, 64, 200_832, 1, 128, 8, 131,
                                 7_680, 256, 131_072)
    assert plan.shares_bound(64) and not plan.shares_bound(300)
    for es in (2, 1):
        plan = tzt.launch_geometry(64, 1_000_000, 64, 16, 132, es)
        assert (plan.kernel, plan.stages, plan.n_split) == ("mma", 8, 131)
    plan = tzt.launch_geometry(64, 1_000_000, 512, 16, 132)
    assert (plan.kernel, plan.queries_per_block, plan.smem,
            plan.blocks_per_sm) == ("simt", 8, 133_760, 1)
    plan = tzt.launch_geometry(64, 1_000_000, 2_048, 16, 132)
    assert plan.kernel == "simt" and plan.queries_per_block == 4
    assert not plan.global_lists
    plan = tzt.launch_geometry(64, 100_000, 16_384, 16, 132)
    assert plan.kernel == "simt" and plan.global_lists
    assert plan.merge_smem == 0


@pytest.mark.parametrize("k", [1, 2, 3, 5, 13, 15, 16])
@pytest.mark.parametrize("nq", [1, 2, 3, 64])
def test_topk_mma_plan_pads_queries_and_rows(nq, k):
    """Q = 1, 2, 3 fill one consumer warp's 8 query slots (the rest are
    padding, never written), Q = 64 all 8 warps. Rows of k x element size
    not a multiple of 16 bytes take the same TMA bulk copies: a tile of
    consecutive rows is one byte range, and every split and tile starts on
    a 16-byte boundary (tiles are multiples of 32 rows); only the tail
    under 16 bytes of a ragged last tile is copied by the producer."""
    for es in (4, 2, 1):
        plan = tzt.launch_geometry(nq, 1_000_003, 16, k, 132, es)
        assert plan.kernel == "mma"
        assert plan.warps // plan.streams == min(8, -(-nq // 8))
        assert plan.queries_per_block >= min(nq, 64)
        assert (plan.tile_rows * k * es) % 16 == 0
        assert (plan.split_rows * k * es) % 16 == 0
        assert (plan.split_rows * 4) % 16 == 0       # the row scales
        stage = tzt.mma_stage_bytes(plan.tile_rows, k, es)
        assert stage % 16 == 0 and stage >= plan.tile_rows * (k * es + 4)
        tail = (1_000_003 - (plan.n_split - 1) * plan.split_rows)
        assert 0 < tail <= plan.split_rows
        assert plan.blocks_per_sm * plan.warps <= 16
        assert plan.stages >= min(8, 2 * plan.streams)


@pytest.mark.parametrize("w", WIDTHS)
def test_probe_plan_fits_every_width(w):
    for n_probe in (1, 8, 64):
        for k, pq_m in ((1, 0), (16, 0), (300, 0), (1024, 0), (0, 4),
                        (0, 192), (0, 256), (0, 300)):
            plan = tip.probe_plan(w, n_probe, k=k, pq_m=pq_m, nq=64)
            assert plan.w == w and plan.smem <= tzt.SMEM_LIMIT
            if w <= tip.WARP_MAX_W:  # the warp plan: lists in registers
                assert plan.kernel == "warp" and not plan.global_lists
                assert 1 <= plan.warps <= 16 and 1 <= plan.cluster <= 8
                assert plan.smem == tip.warp_smem(plan.cols * 384, plan.cols,
                                                  plan.m_smem, plan.cluster)
                assert plan.m_smem == 0 if not pq_m else \
                    0 <= plan.m_smem <= pq_m
                # every block of a cluster gets a column, every column a
                # block
                assert plan.cols * plan.cluster >= n_probe
                assert plan.cols * (plan.cluster - 1) < n_probe
                assert plan.split_rows % 64 == 0
                assert plan.splits * plan.split_rows >= 384
                assert (plan.splits - 1) * plan.split_rows < 384
                assert plan.group == plan.merge_smem == 0  # no pass 2
            else:  # the block plan
                assert plan.kernel == "block"
                assert plan.cap >= max(w, 1024)
                lists = 0 if plan.global_lists else 8 * (w + plan.cap)
                if pq_m:
                    assert 1 <= plan.m_smem <= pq_m
                    assert plan.smem == lists + 1024 * plan.m_smem
                else:
                    assert plan.m_smem == 0 and plan.smem == (
                        0 if plan.global_lists else lists + 4 * k)
                assert plan.group >= 1
                if plan.merge_smem:
                    assert plan.merge_smem == 8 * (plan.group + 1) * w
                    assert plan.merge_smem <= tzt.SMEM_LIMIT
                    assert plan.group <= max(1, 2 * n_probe - 1)
                else:
                    assert 16 * w > tzt.SMEM_LIMIT


def test_probe_plan_keeps_the_serving_geometry():
    """nprobe 8 at width 64 over 64 queries is one launch of 64 clusters of
    2 blocks (4 probe columns each) of 12 warps, each warp a third of one
    probed cluster, with a candidate slot for each of a block's 1,536 rows
    and an inbox for the other block's list; M = 256 keeps the tables of
    the first 52 subspaces of a block's 4 columns in shared memory and
    reads the rest from global memory. Width 128 takes the block plan,
    which merges all 8 lists at once."""
    plan = tip.probe_plan(64, 8, k=16, nq=64, cluster_rows=384)
    assert (plan.kernel, plan.cluster, plan.cols, plan.warps, plan.splits,
            plan.split_rows, plan.smem) == ("warp", 2, 4, 12, 3, 128,
                                            8 * (1536 + 128 + 64) + 1024)
    plan = tip.probe_plan(64, 8, pq_m=256, nq=64, cluster_rows=384)
    assert plan.m_smem == 52 and not plan.global_lists
    plan = tip.probe_plan(128, 8, k=16, nq=64)
    assert plan.kernel == "block"
    assert (plan.group, plan.global_lists, plan.smem) == (8, False,
                                                          8 * 1152 + 64)
