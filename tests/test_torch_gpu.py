"""Hopper kernel tests: they need a CUDA card and skip without one.

Run them on the card with ``python -m pytest -m gpu tests/test_torch_*.py``.
Whether a card is present is decided inside each test (the ``cuda``
fixture), never at import or collection, so every test worker collects the
same tests.

Each kernel is held to its plain PyTorch version on the same CUDA tensors,
ids equal outside near-ties (the staging copy: byte for byte). ``zen_topk``:
rtol 1e-5 / atol 1e-5 on
distances of O(1) coordinates (the same f32 norm expansion, in another
order). The probes: rtol 1e-5 / atol 1e-5 x the median row norm, as in
``chip_smoke.py``. Their queries sit next to index rows, so the expansion
``|q|^2 + |x|^2 - 2 q.x`` cancels terms ~|x|^2 down to a small distance,
and its rounding error scales with the norms, not with the distance. The
tiered store against the resident index on the card: the same probe kernel
scores the same rows, so distances are bit-equal and ids equal outside
exact ties.
"""
import contextlib
import ctypes
import functools
import importlib
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.index import ivf  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ivf_probe as ip  # noqa: E402
from repro_torch.kernels import jsd as jk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pq  # noqa: E402
from repro_torch.kernels import quantize as quant  # noqa: E402
from repro_torch.kernels import tile_stage as ts  # noqa: E402
from repro_torch.kernels import zen as zk  # noqa: E402
from repro_torch.kernels.scoring import MODE_IDS  # noqa: E402
from repro_torch.kernels import zen_topk as zt  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.testing import (  # noqa: E402
    JSD_CASES, JSD_KTOL, PDIST_CASES, PDIST_PLAN_CASES, SQ_RTOL, ZEN_CASES,
    dense_errors, dense_inputs, topk_mismatch)

# the package exports the function ``pdist``, which shadows the module name
pk = importlib.import_module("repro_torch.kernels.pdist")

pytestmark = pytest.mark.gpu

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernels cannot run here)")
    return torch.device("cuda")


def _coords(seed, n, k, dev):
    x = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    x[:, -1] = np.abs(x[:, -1])
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("mode", ["zen", "lwb", "upb"])
@pytest.mark.parametrize("nq,n_index,k,n", [
    (64, 100_003, 16, 64), (2, 5_000, 16, 10), (9, 70, 8, 128),
    (5, 3_000, 40, 256), (64, 20_000, 256, 16), (3, 1, 4, 5)])
def test_kernel_matches_plain(cuda, storage, mode, nq, n_index, k, n):
    q = _coords(0, nq, k, cuda)
    x, s = quant.encode_rows(_coords(1, n_index, k, cuda), storage)
    before = zt.zen_topk.launches
    got = zt.zen_topk(q, x, n, mode, scales=s)
    torch.cuda.synchronize()
    assert zt.zen_topk.launches == before + 1
    want = zt.zen_topk_scan(q, x, n, mode, scales=s)
    msg = topk_mismatch(got[0], got[1], want[0], want[1], **TOL)
    assert msg is None, msg


def test_dead_rows_never_win(cuda):
    x = _coords(2, 9_000, 16, cuda)
    index = serve.ZenIndex(None, x, None).delete(list(range(0, 9_000, 3)))
    d, ids = ops.zen_topk(_coords(3, 16, 16, cuda), index.coords, 64)
    assert (ids % 3 != 0).all() and torch.isfinite(d).all()


def test_kernel_rejects_what_it_does_not_take(cuda):
    """No width or k is refused any more (k = 300 and n = 300 are held to
    the plain version); a dtype the kernel cannot read still is."""
    q = _coords(4, 4, 300, cuda)
    got = zt.zen_topk(q, q, 3)
    want = zt.zen_topk_scan(q, q, 3)
    msg = topk_mismatch(got[0], got[1], want[0], want[1], **TOL)
    assert msg is None, msg
    q = _coords(5, 4, 8, cuda)
    x = _coords(6, 1000, 8, cuda)
    got = zt.zen_topk(q, x, 300)
    want = zt.zen_topk_scan(q, x, 300)
    msg = topk_mismatch(got[0], got[1], want[0], want[1], **TOL)
    assert msg is None, msg
    with pytest.raises(ValueError, match="dtype"):
        zt.zen_topk(q, q.double(), 3)


@pytest.mark.parametrize("nq,n_index,k,n", [
    (64, 200_003, 16, 300), (64, 200_003, 16, 600), (9, 60_000, 16, 1_500),
    (5, 50_000, 8, 3_000), (3, 40_000, 16, 6_000), (64, 100_003, 16, 10_000),
    (2, 70_000, 300, 65), (4, 30_000, 1_024, 16)])
def test_kernel_matches_plain_at_wide_widths(cuda, nq, n_index, k, n):
    """Widths 512 to 16,384 (1 query a block past 8,192: lists in global
    memory, pass 2 in place there) and k = 300 and 1,024."""
    q = _coords(20, nq, k, cuda)
    x = _coords(21, n_index, k, cuda)
    plan = zt.launch_geometry(nq, n_index, n, k, torch.cuda
                              .get_device_properties(cuda)
                              .multi_processor_count)
    before = zt.zen_topk.launches
    got = zt.zen_topk(q, x, n, "zen")
    torch.cuda.synchronize()
    assert zt.zen_topk.launches == before + 1
    want = zt.zen_topk_scan(q, x, n, "zen")
    msg = topk_mismatch(got[0], got[1], want[0], want[1], **TOL)
    assert msg is None, (plan, msg)


def _check_topk(q, x, n, mode="zen", scales=None, plan=None):
    before = zt.zen_topk.launches
    got = zt.zen_topk(q, x, n, mode, scales=scales, plan=plan)
    torch.cuda.synchronize()
    assert zt.zen_topk.launches == before + 1
    want = zt.zen_topk_scan(q, x, n, mode, scales=scales)
    msg = topk_mismatch(got[0], got[1], want[0], want[1], **TOL)
    assert msg is None, msg
    return got, want


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_duplicated_rows_keep_the_lower_id_first(cuda, storage):
    """Every row of 1,000 appears 37 times: ties in distance are exact, and
    the ids must equal the plain version's exactly (lax.top_k's order: the
    lower id first), under both plans."""
    base = _coords(30, 1_000, 16, cuda)
    x, s = quant.encode_rows(base.repeat(37, 1), storage)
    q = _coords(31, 64, 16, cuda)
    for plan in (None, zt.simt_plan(64, x.shape[0], 64, 16, 132)):
        got, want = _check_topk(q, x, 64, scales=s, plan=plan)
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0], want[0]) or \
            float((got[0] - want[0]).abs().max()) <= 1e-5


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("k", [1, 2, 13, 130, 300])
def test_kernel_matches_plain_at_odd_k(cuda, storage, k):
    """Row widths whose bytes are not a multiple of 16 (the TMA bulk copy's
    tail), k = 1 (no dot, the altitude alone) and wide rows (the SIMT
    plan). Zen and Upb: at k <= 2, 20,011 random rows put Lwb's nearest
    within ~1e-3 of a query, where the norm expansion cancels terms ~4 and
    any two f32 summation orders differ by more than 1e-5 (the SIMT plan as
    much as the MMA plan); the two plans' Lwb results are held to each
    other in ``test_mma_and_simt_plans_agree``."""
    q = _coords(32, 64, k, cuda)
    x, s = quant.encode_rows(_coords(33, 20_011, k, cuda), storage)
    for mode in ("zen", "upb"):
        _check_topk(q, x, 64, mode, scales=s)


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("k", [1, 2, 3, 13, 16])
def test_mma_and_simt_plans_agree(cuda, storage, k):
    """The MMA plan (3xTF32 dots on the tensor cores) against the SIMT plan
    (f32 FMAs) on the same inputs, with dead rows: within the tolerance,
    ids equal outside near-ties. Zen and Upb at every k; Lwb from k = 13,
    where its nearest rows stay ~1 off each query (at k <= 3 they come
    within ~1e-2, where the expansion's f32 roundings alone, ~1e-6 on z2,
    move the distance by more than 1e-5 in either plan, as against the
    plain version)."""
    q = _coords(40, 64, k, cuda)
    x = _coords(41, 3_011, k, cuda)
    x[::5] = serve._DEAD_COORD
    x, s = quant.encode_rows(x, storage)
    for n in (10, 64):
        plan = zt.launch_geometry(64, x.shape[0], n, k, 132, x.element_size())
        assert plan.kernel == "mma"
        for mode in ("zen", "upb") + (("lwb",) if k >= 13 else ()):
            got = zt.zen_topk(q, x, n, mode, scales=s)
            want = zt.zen_topk(q, x, n, mode, scales=s,
                               plan=zt.simt_plan(64, x.shape[0], n, k, 132))
            msg = topk_mismatch(got[0], got[1], want[0], want[1], **TOL)
            assert msg is None, (n, mode, msg)


def _n_index_past_a_split(nq, n):
    """The smallest N = 1 (mod the tile) whose MMA plan leaves one row past
    a whole number of splits."""
    for n_index in range(128 * 131 + 1, 128 * 131 * 40, 128):
        plan = zt.launch_geometry(nq, n_index, n, 16, 132)
        if (n_index - 1) % plan.split_rows == 0:
            return n_index
    raise AssertionError("no such N")


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_ragged_tiles_and_splits(cuda, storage):
    """N under one tile, N one past a multiple of the tile, N one past a
    multiple of the split (its last split holds one row), and n > N."""
    q = _coords(34, 64, 16, cuda)
    n_split_edge = _n_index_past_a_split(64, 64)
    for n_index, n in ((37, 10), (100, 128), (128 * 37 + 1, 64),
                       (n_split_edge, 64), (5_000, 6_000)):
        x, s = quant.encode_rows(_coords(35, n_index, 16, cuda), storage)
        plan = zt.launch_geometry(64, n_index, n, 16, 132, x.element_size())
        _check_topk(q, x, n, "zen", scales=s)
        if n_index == n_split_edge:
            assert plan.kernel == "mma"
            assert (n_index - 1) % plan.split_rows == 0


@pytest.mark.parametrize("n", [10, 64, 128, 300, 600, 5_000, 10_000])
def test_dead_rows_never_win_at_every_width(cuda, n):
    """Dead rows (the mutable index's 1e15 sentinel) under every plan: the
    MMA plan's widths and the SIMT plan's shared and global lists."""
    x = _coords(36, 60_000, 16, cuda)
    index = serve.ZenIndex(None, x, None).delete(list(range(0, 60_000, 3)))
    q = _coords(37, 16, 16, cuda)
    got, _ = _check_topk(q, index.coords, n, "lwb")
    assert (got[1] % 3 != 0).all() and torch.isfinite(got[0]).all()


@pytest.mark.parametrize("nq", [1, 2, 3, 9, 33, 64, 65])
def test_query_padding(cuda, nq):
    """Q = 1, 2, 3 fill one warp's 8 query slots (four row streams); 9 and
    33 leave a group part-filled; 65 takes two query blocks, the second with
    one query. 600,000 rows give each block more tiles than its ring has
    stages, so every stage serves its stream several times."""
    x = _coords(39, 600_000, 16, cuda)
    plan = zt.launch_geometry(nq, x.shape[0], 64, 16, 132)
    assert plan.split_rows > plan.stages * plan.tile_rows
    _check_topk(_coords(38, nq, 16, cuda), x, 64)


def test_server_on_card_matches_cpu(cuda):
    gen = torch.Generator().manual_seed(0)
    corpus = torch.randn((6_000, 48), generator=gen)
    queries = torch.randn((20, 48), generator=gen)
    pivots = list(range(0, 6_000, 500))
    for storage in quant.SCALAR_STORAGE_DTYPES:
        got = serve.ZenServer(serve.build_index(
            corpus, 12, storage=storage, pivot_ids=pivots, device=cuda),
            rerank_factor=4).query(queries, 10)
        want = serve.ZenServer(serve.build_index(
            corpus, 12, storage=storage, pivot_ids=pivots, device="cpu"),
            rerank_factor=4, chunk=1024).query(queries, 10)
        msg = topk_mismatch(got[0], got[1], want[0], want[1], rtol=1e-4,
                            atol=1e-4)
        assert msg is None, (storage, msg)


# -- the clustered probes -----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ivf_index(dev, storage: str, k: int = 16, pq_m: int = 4):
    """A 30,000-row IVF index on ``dev`` (60 clusters of 128-row tiles,
    T >= 2) with every ninth row tombstoned, and 64 queries."""
    x = _coords(7, 30_000, k, dev)
    idx = ivf.IVFZenIndex.build(
        x, 60, tile_rows=128, storage=storage, pq_m=pq_m, n_iters=5,
        generator=torch.Generator().manual_seed(7))
    q = x[:64] + 0.05 * _coords(8, 64, k, dev)
    return idx.delete(range(0, 30_000, 9)), q


def _check_probe(fn, plain, q, *args, **kw):
    """Kernel vs plain version; ``q`` are the (projected) queries, whose
    median norm scales the distance tolerance."""
    before = fn.launches
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(*args, **kw)
    atol = 1e-5 * float(q.norm(dim=1).median())
    msg = topk_mismatch(got[0], got[1], want[0], want[1], rtol=1e-5,
                        atol=atol)
    assert msg is None, msg
    return got


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("mode", ["zen", "lwb", "upb"])
@pytest.mark.parametrize("nq,n,nprobe", [
    (64, 64, 8), (2, 10, 1), (5, 256, 60), (9, 128, 3)])
def test_ivf_probe_matches_plain(cuda, storage, mode, nq, n, nprobe):
    idx, q = _ivf_index(cuda, storage)
    assert idx.tiles_per_cluster >= 2
    probes = idx.probe_clusters(q[:nq], nprobe, mode)
    d, ids = _check_probe(
        ip.ivf_probe, ip.ivf_probe_scan, q, q[:nq], idx.tile_coords,
        idx.tile_ids, probes, n, mode,
        tiles_per_cluster=idx.tiles_per_cluster, tile_scales=idx.tile_scales)
    assert not (ids[ids >= 0] % 9 == 0).any()  # tombstones never come back


@pytest.mark.parametrize("mode", ["zen", "lwb", "upb"])
@pytest.mark.parametrize("k,pq_m", [(16, 4), (16, 16), (12, 5)])
@pytest.mark.parametrize("nq,n,nprobe", [
    (64, 64, 8), (2, 10, 1), (5, 256, 60)])
def test_ivf_probe_pq_matches_plain(cuda, mode, k, pq_m, nq, n, nprobe):
    idx, q = _ivf_index(cuda, "pq", k, pq_m)
    probes = idx.probe_clusters(q[:nq], nprobe, mode)
    luts = pq.build_luts(q[:nq], idx.centroids, idx.codebooks, probes,
                         MODE_IDS[mode])
    d, ids = _check_probe(
        ip.ivf_probe_pq, ip.ivf_probe_pq_scan, q, idx.tile_coords,
        idx.tile_ids, probes, luts, n, tiles_per_cluster=idx.tiles_per_cluster)
    assert not (ids[ids >= 0] % 9 == 0).any()


@pytest.mark.parametrize("storage", ["float32", "int8", "pq"])
def test_ivf_probe_fills_what_the_probed_clusters_hold(cuda, storage):
    """Every query probes one cluster holding 3 live rows: 3 answers, then
    (+inf, -1)."""
    idx, q = _ivf_index(cuda, storage)
    tids = idx.tile_ids.reshape(idx.n_clusters, -1)[0]
    idx = idx.delete(tids[tids >= 0][3:].tolist())
    probes = torch.zeros((8, 2), dtype=torch.int32, device=cuda)
    kw = dict(tiles_per_cluster=idx.tiles_per_cluster)
    if storage == "pq":
        luts = pq.build_luts(q[:8], idx.centroids, idx.codebooks, probes, 0)
        d, ids = ops.ivf_probe_pq(idx.tile_coords, idx.tile_ids, probes[:, :1],
                                  luts[:, :1], 10, **kw)
    else:
        d, ids = ops.ivf_probe(q[:8], idx.tile_coords, idx.tile_ids,
                               probes[:, :1], 10, tile_scales=idx.tile_scales,
                               **kw)
    assert (ids[:, :3] >= 0).all() and torch.isfinite(d[:, :3]).all()
    assert (ids[:, 3:] == -1).all() and torch.isinf(d[:, 3:]).all()


def test_ivf_probes_reject_what_they_do_not_take(cuda):
    """n = 300, k = 300 and M = 256 are served (held to the plain versions
    here); bad layouts and tables are still refused."""
    idx, q = _ivf_index(cuda, "float32")
    probes = idx.probe_clusters(q[:4], 2)
    kw = dict(tiles_per_cluster=idx.tiles_per_cluster)
    _check_probe(ip.ivf_probe, ip.ivf_probe_scan, q, q[:4], idx.tile_coords,
                 idx.tile_ids, probes, 300, **kw)
    wide = _coords(22, 4, 300, cuda)
    tiles = _coords(23, 4 * 8, 300, cuda).reshape(4, 8, 300)
    ids = torch.arange(32, dtype=torch.int32, device=cuda).reshape(4, 8)
    probes2 = torch.tensor([[0, 1], [1, 0], [0, 1], [1, 0]],
                           dtype=torch.int32, device=cuda)
    _check_probe(ip.ivf_probe, ip.ivf_probe_scan, wide, wide, tiles, ids,
                 probes2, 5, tiles_per_cluster=2)
    with pytest.raises(ValueError, match="tile_ids"):
        ip.ivf_probe(q[:4], idx.tile_coords, idx.tile_ids[:, :5], probes, 5,
                     **kw)
    with pytest.raises(ValueError, match="whole number"):
        ip.ivf_probe(q[:4], idx.tile_coords[:-1], idx.tile_ids[:-1], probes,
                     5, **kw)
    codes = torch.randint(0, 256, (4, 8, 256), dtype=torch.uint8,
                          device=cuda, generator=torch.Generator(cuda)
                          .manual_seed(0))
    luts = torch.rand((4, 2, 256, 256), device=cuda,
                      generator=torch.Generator(cuda).manual_seed(1))
    _check_probe(ip.ivf_probe_pq, ip.ivf_probe_pq_scan, q, codes, ids,
                 probes2, luts, 5, tiles_per_cluster=2)
    with pytest.raises(ValueError, match="luts"):
        ip.ivf_probe_pq(codes[..., :4], ids, probes2,
                        torch.zeros((4, 2, 4, 255), device=cuda), 5,
                        tiles_per_cluster=2)


@pytest.mark.parametrize("n", [300, 600, 2_048, 10_000])
@pytest.mark.parametrize("storage", ["float32", "pq"])
def test_ivf_probes_match_plain_at_wide_widths(cuda, storage, n):
    """Widths 512 to 16,384: pass 2 in shared memory up to 8,192, lists and
    the running best in global memory past it."""
    idx, q = _ivf_index(cuda, storage)
    probes = idx.probe_clusters(q, 16)
    kw = dict(tiles_per_cluster=idx.tiles_per_cluster)
    if storage == "pq":
        luts = pq.build_luts(q, idx.centroids, idx.codebooks, probes, 0)
        _check_probe(ip.ivf_probe_pq, ip.ivf_probe_pq_scan, q,
                     idx.tile_coords, idx.tile_ids, probes, luts, n, **kw)
    else:
        _check_probe(ip.ivf_probe, ip.ivf_probe_scan, q, q, idx.tile_coords,
                     idx.tile_ids, probes, n, **kw)


@pytest.mark.parametrize("pq_m", [192, 256, 300])
def test_ivf_probe_pq_matches_plain_past_shared_tables(cuda, pq_m):
    """M past what shared memory holds: the first tables staged, the rest
    read from global memory, summed in the same ascending order."""
    gen = torch.Generator(cuda).manual_seed(pq_m)
    ct, rows, n_probe = 40, 64, 6
    codes = torch.randint(0, 256, (ct, rows, pq_m), dtype=torch.uint8,
                          device=cuda, generator=gen)
    ids = torch.arange(ct * rows, dtype=torch.int32,
                       device=cuda).reshape(ct, rows)
    ids[:, ::5] = -1
    probes = torch.randperm(20, generator=gen, device=cuda)[
        :n_probe].to(torch.int32).repeat(8, 1)
    luts = torch.rand((8, n_probe, pq_m, 256), device=cuda, generator=gen)
    q = torch.ones((8, 1), device=cuda)
    _check_probe(ip.ivf_probe_pq, ip.ivf_probe_pq_scan, q, codes, ids,
                 probes, luts, 64, tiles_per_cluster=2)


def _tiles(dev, seed, n_clusters, tiles_per_cluster, rows, k, storage,
           dead=0.2):
    """Random packed tiles (C*T, rows, k) in ``storage`` with their ids
    (a fraction ``dead`` of the slots -1, the rest unique) and per-cluster
    scales (int8)."""
    slots = n_clusters * tiles_per_cluster * rows
    x = _coords(seed, slots, k, dev).reshape(n_clusters, -1, k)
    values, scales = ivf._encode_packed(x, storage)
    gen = np.random.default_rng(seed + 1)
    ids = np.arange(slots, dtype=np.int32)
    ids[gen.random(slots) < dead] = -1
    ids = torch.from_numpy(ids).to(dev).reshape(-1, rows)
    return values.reshape(-1, rows, k), ids, scales


def _warp_vs_plain(q, tiles, ids, probes, n, tiles_per_cluster, scales=None,
                   mode="zen"):
    """The warp plan against the plain version (ids equal outside
    near-ties); returns both results."""
    plan = ip.probe_plan(n, probes.shape[1], k=q.shape[1], nq=q.shape[0],
                         cluster_rows=tiles_per_cluster * tiles.shape[1],
                         n_sms=torch.cuda.get_device_properties(
                             q.device).multi_processor_count)
    assert plan.kernel == "warp"
    got = _check_probe(ip.ivf_probe, ip.ivf_probe_scan, q, q, tiles, ids,
                       probes, n, mode, tiles_per_cluster=tiles_per_cluster,
                       tile_scales=scales)
    want = ip.ivf_probe_scan(q, tiles, ids, probes, n, mode,
                             tiles_per_cluster=tiles_per_cluster,
                             tile_scales=scales)
    return got, want


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_ivf_probe_duplicated_rows_keep_the_lower_visit_position(cuda,
                                                                 storage):
    """Cluster 3 holds exact copies of cluster 0's rows (other ids, the
    same scale) and is probed first; queries sit next to cluster 0's rows
    (Lwb: its row's copies are nearest). Each query's two nearest are the
    copies of its row, tied exactly, the one at the lower visit position
    (cluster 3's) first, as in the plain version."""
    tiles, ids, scales = _tiles(cuda, 31, 6, 2, 64, 16, storage)
    tiles = tiles.reshape(6, 128, 16).clone()
    tiles[3] = tiles[0]
    tiles = tiles.reshape(12, 64, 16)
    if scales is not None:
        scales = scales.clone()
        scales[3] = scales[0]
    q = (tiles.reshape(6, 128, 16)[0, :40].float()
         * (1.0 if scales is None else scales[0]))
    q = q + 0.1 * _coords(32, 40, 16, cuda)  # off the row: no cancellation
    q[:, -1].abs_()
    probes = torch.tensor([3, 0, 1, 5], dtype=torch.int32,
                          device=cuda).repeat(40, 1)
    got, want = _warp_vs_plain(q, tiles, ids, probes, 64, 2, scales,
                               mode="lwb")
    ids0 = ids.reshape(6, 128)
    both = (ids0[0, :40] >= 0) & (ids0[3, :40] >= 0)
    assert int(both.sum()) >= 20
    first = got[1][both, :2]
    assert torch.equal(first[:, 0], ids0[3, :40][both])
    assert torch.equal(first[:, 1], ids0[0, :40][both])
    assert torch.equal(got[0][both, 0], got[0][both, 1])  # an exact tie
    assert torch.equal(want[1][both, :2], first)


@pytest.mark.parametrize("storage", ["float32", "int8", "pq"])
def test_ivf_probe_all_tombstone_and_dummy_clusters(cuda, storage):
    """A probed cluster whose rows are all tombstoned, and probe columns
    pointing at an always-empty trailing cluster (the tiered store's dummy
    slot), whole queries of them: no row of theirs is returned, and the
    unfilled slots are (+inf, -1)."""
    n_clusters = 9
    if storage == "pq":
        idx, q = _ivf_index(cuda, "pq")
        codes = idx.tile_coords
        ids = idx.tile_ids.clone().reshape(idx.n_clusters, -1)
        ids[2] = -1  # every row of cluster 2 tombstoned
        ids[-1] = -1  # the last cluster empty: the dummy slot
        ids = ids.reshape(codes.shape[:2])
        dummy = idx.n_clusters - 1
        probes = idx.probe_clusters(q, 8)
        probes[:, 1] = 2
        probes[:, 3:] = dummy
        probes[:8] = dummy  # queries that probe nothing but it
        luts = pq.build_luts(q, idx.centroids, idx.codebooks, probes, 0)
        got = _check_probe(ip.ivf_probe_pq, ip.ivf_probe_pq_scan, q, codes,
                           ids, probes, luts, 40,
                           tiles_per_cluster=idx.tiles_per_cluster)
    else:
        tiles, ids, scales = _tiles(cuda, 41, n_clusters, 3, 128, 16,
                                    storage)
        ids = ids.reshape(n_clusters, -1).clone()
        ids[2] = -1
        ids[-1] = -1
        ids = ids.reshape(-1, 128)
        q = _coords(42, 64, 16, cuda)
        probes = torch.tensor([0, 2, 4, 8, 8, 8, 1, 8], dtype=torch.int32,
                              device=cuda).repeat(64, 1)
        probes[:8] = n_clusters - 1
        got, _ = _warp_vs_plain(q, tiles, ids, probes, 40, 3, scales)
    d, i = got
    assert (i[:8] == -1).all() and torch.isinf(d[:8]).all()
    assert (i[8:] >= 0).any()


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("k", [1, 2, 13, 16, 130])
def test_ivf_probe_warp_plan_at_odd_k(cuda, storage, k):
    """Every k, also where rows start off a 16-byte boundary (13, 130) and
    past one 16-column chunk (130); int8 with per-cluster scales."""
    tiles, ids, scales = _tiles(cuda, 50 + k, 12, 2, 128, k, storage)
    q = _coords(60 + k, 33, k, cuda)
    probes = torch.randperm(12, generator=torch.Generator(cuda).manual_seed(
        k), device=cuda)[:5].to(torch.int32).repeat(33, 1)
    _warp_vs_plain(q, tiles, ids, probes, 20, 2, scales)


@pytest.mark.parametrize("rows,tiles_per_cluster", [(48, 3), (100, 1),
                                                    (13, 5), (128, 7)])
def test_ivf_probe_warp_plan_at_ragged_tiles(cuda, rows, tiles_per_cluster):
    """T * rows off the 64-row step (144, 100, 65) and longer than a split
    (896): the last step of a split is partial."""
    tiles, ids, _ = _tiles(cuda, 70 + rows, 10, tiles_per_cluster, rows, 16,
                           "float32")
    q = _coords(71, 64, 16, cuda)
    probes = torch.rand((64, 10), generator=torch.Generator(
        cuda).manual_seed(rows), device=cuda).argsort(1)[:, :6].to(
            torch.int32)  # 6 distinct clusters a query
    for mode in ("zen", "lwb", "upb"):
        _warp_vs_plain(q, tiles, ids, probes, 64, tiles_per_cluster,
                       mode=mode)


@pytest.mark.parametrize("storage", ["float32", "int8", "pq"])
@pytest.mark.parametrize("n", [33, 64])
def test_ivf_probe_plans_agree_at_the_boundary_width(cuda, storage, n):
    """The widest lists of the warp plan (33 to 64) served by both plans:
    the same answers (ids equal outside near-ties)."""
    idx, q = _ivf_index(cuda, storage)
    probes = idx.probe_clusters(q, 8)
    kw = dict(tiles_per_cluster=idx.tiles_per_cluster)
    if storage == "pq":
        luts = pq.build_luts(q, idx.centroids, idx.codebooks, probes, 0)
        args = (idx.tile_coords, idx.tile_ids, probes, luts, n)
        fn, plan = ip.ivf_probe_pq, ip.block_plan(n, 8, pq_m=4)
    else:
        args = (q, idx.tile_coords, idx.tile_ids, probes, n)
        kw["tile_scales"] = idx.tile_scales
        fn, plan = ip.ivf_probe, ip.block_plan(n, 8, k=16)
    warp = fn(*args, **kw)
    block = fn(*args, plan=plan, **kw)
    torch.cuda.synchronize()
    atol = 1e-5 * float(q.norm(dim=1).median())
    msg = topk_mismatch(warp[0], warp[1], block[0], block[1], rtol=1e-5,
                        atol=atol)
    assert msg is None, msg


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8", "pq"])
def test_ivf_server_on_card_matches_cpu(cuda, storage):
    """One IVF index, built once on the CPU and moved to the card: the same
    served answers on both devices."""
    gen = torch.Generator().manual_seed(0)
    corpus = torch.randn((6_000, 48), generator=gen)
    queries = torch.randn((20, 48), generator=gen)
    index = serve.build_index(corpus, 12, index="ivf", storage=storage,
                              pivot_ids=list(range(0, 6_000, 500)),
                              device="cpu", generator=gen)
    before = (ip.ivf_probe_pq if storage == "pq" else ip.ivf_probe).launches
    got = serve.ZenServer(index.to(cuda), nprobe=8,
                          rerank_factor=4).query(queries, 10)
    assert (ip.ivf_probe_pq if storage == "pq"
            else ip.ivf_probe).launches == before + 1
    want = serve.ZenServer(index, nprobe=8, rerank_factor=4).query(queries,
                                                                   10)
    msg = topk_mismatch(got[0], got[1], want[0], want[1], rtol=1e-4,
                        atol=1e-4)
    assert msg is None, (storage, msg)


# -- the staging copy and the tiered store ------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "uint16", "int8", "int32",
                                   "uint8"])
@pytest.mark.parametrize("block", [(128, 16), (128,), (128, 13), (5, 7, 3)])
@pytest.mark.parametrize("n_blocks", [1, 3, 257])
def test_dma_copy_blocks_matches_plain(cuda, dtype, block, n_blocks):
    rng = np.random.default_rng(n_blocks)
    src = ts.pinned_like(rng.integers(0, 256, (n_blocks,) + block
                                      + (np.dtype(dtype).itemsize,),
                                      dtype=np.uint8).view(dtype)[..., 0])
    before = ts.dma_copy_blocks.launches
    got = ts.dma_copy_blocks(src, cuda)
    torch.cuda.synchronize()
    assert ts.dma_copy_blocks.launches == before + 1
    assert got.is_cuda and got.dtype == src.dtype and got.shape == src.shape
    want = ts.dma_copy_blocks_plain(src, cuda)
    assert got.cpu().numpy().tobytes() == want.cpu().numpy().tobytes()


def test_dma_copy_blocks_unaligned_views(cuda):
    """Views that start off a 16-byte boundary, and sizes that are no
    multiple of 16, go through the byte-wise head and tail."""
    base = ts.pinned_like(np.random.default_rng(1).integers(
        0, 256, 1 << 18, dtype=np.uint8))
    for off, n in ((1, 1000), (3, 65_537), (16, 4096 * 5 + 7), (5, 9)):
        view = base[off:off + n]
        got = ts.dma_copy_blocks(view, cuda)
        torch.cuda.synchronize()
        assert got.cpu().numpy().tobytes() == view.numpy().tobytes(), off


@pytest.mark.parametrize("n", [1, 15, 16, 17, 4_097, 196_608, 196_609,
                               3_145_728, 64 << 20])
@pytest.mark.parametrize("off", [0, 5, 16])
def test_dma_copy_blocks_partial_warps_and_blocks(cuda, n, off):
    """Sizes that leave the last thread, warp or block of the copy partial
    (1 byte to 64 MB, the tiered chunk's 196,608-byte ids and 3 MB coords),
    from an aligned start, one off it (a head and a tail) and one 16 bytes
    in: 0 mismatching bytes."""
    base = ts.pinned_like(np.random.default_rng(n).integers(
        0, 256, n + 32, dtype=np.uint8))
    view = base[off:off + n]
    got = ts.dma_copy_blocks(view, cuda)
    torch.cuda.synchronize()
    assert got.cpu().numpy().tobytes() == view.numpy().tobytes()


def test_pageable_source_raises(cuda):
    with pytest.raises(ValueError, match="pinned"):
        ts.dma_copy_blocks(torch.zeros((4, 8)), cuda)
    with pytest.raises(ValueError, match="pinned"):
        ops.dma_copy_blocks(torch.zeros((4, 8)), cuda)
    # the launcher itself refuses a pageable pointer, never copies it
    from repro_torch.kernels import _build

    lib = _build.load("tile_stage")
    host = np.zeros(4096, np.uint8)
    dst = torch.empty(4096, dtype=torch.uint8, device=cuda)
    err = lib.tile_stage_launch(host.ctypes.data, dst.data_ptr(), 4096, 1,
                                torch.cuda.current_stream().cuda_stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="tile_stage"):
        _build.check(lib, err, "tile_stage launch")


def _tiered_pair(dev, storage, hot):
    idx, q = _ivf_index(dev, storage)
    return ivf.TieredIVFZenIndex.from_index(idx, hot_clusters=hot), idx, q


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("hot", [0, 6, 60])
def test_tiered_search_on_card_matches_resident(cuda, storage, hot):
    tiered, idx, q = _tiered_pair(cuda, storage, hot)
    assert tiered._hot_coords.is_cuda
    before = ts.dma_copy_blocks.launches
    for nprobe in (1, 8, 60):
        got = tiered.search(q, 64, nprobe)
        want = idx.search(q, 64, nprobe)
        msg = topk_mismatch(got[0], got[1], want[0], want[1], rtol=0.0,
                            atol=0.0)
        assert msg is None, (nprobe, msg)
    assert ts.dma_copy_blocks.launches - before == \
        2 * tiered.stats()["cold_uploads"]


def test_tiered_slot_reuse_has_no_race(cuda):
    """20 back-to-back searches, each of 8 cold chunks alternating the two
    pinned staging buffers: every answer equals the resident one."""
    tiered, idx, _ = _tiered_pair(cuda, "float32", 4)
    x = _coords(9, 64 * 20, 16, cuda)
    answers = [(tiered.search(x[i * 64:(i + 1) * 64], 64, 16),
                x[i * 64:(i + 1) * 64]) for i in range(20)]
    assert tiered.stats()["cold_uploads"] >= 20 * 7
    for (d, ids), q in answers:
        want = idx.search(q, 64, 16)
        msg = topk_mismatch(d, ids, want[0], want[1], rtol=0.0, atol=0.0)
        assert msg is None, msg


def test_tiered_server_on_card_matches_cpu(cuda):
    gen = torch.Generator().manual_seed(0)
    corpus = torch.randn((6_000, 48), generator=gen)
    queries = torch.randn((20, 48), generator=gen)
    index = serve.build_index(corpus, 12, index="ivf", offload=True,
                              pivot_ids=list(range(0, 6_000, 500)),
                              device=cuda, generator=gen)
    got = serve.ZenServer(index, nprobe=8, rerank_factor=4).query(queries, 10)
    want = serve.ZenServer(index.to("cpu"), nprobe=8,
                           rerank_factor=4).query(queries, 10)
    msg = topk_mismatch(got[0], got[1], want[0], want[1], rtol=1e-4,
                        atol=1e-4)
    assert msg is None, msg


@pytest.mark.parametrize("n", [65, 128, 300])
@pytest.mark.parametrize("kind", ["flat", "ivf", "ivf_pq", "tiered"])
def test_server_on_card_matches_cpu_at_wide_widths(cuda, kind, n):
    """Re-rank 4 fetches 512, 512 and 2,048 candidates: the card's kernels
    answer as the CPU path does."""
    gen = torch.Generator().manual_seed(1)
    corpus = torch.randn((6_000, 48), generator=gen)
    queries = torch.randn((20, 48), generator=gen)
    kw = dict(pivot_ids=list(range(0, 6_000, 500)), device="cpu",
              generator=gen)
    if kind != "flat":
        kw.update(index="ivf", storage="pq" if kind == "ivf_pq"
                  else "float32", offload=kind == "tiered")
    index = serve.build_index(corpus, 12, **kw)
    skw = dict(rerank_factor=4) if kind == "flat" else dict(
        rerank_factor=4, nprobe=16)
    want = serve.ZenServer(index, **skw).query(queries, n)
    got = serve.ZenServer(index.to(cuda), **skw).query(queries.to(cuda), n)
    msg = topk_mismatch(got[0], got[1], want[0], want[1], rtol=1e-4,
                        atol=1e-4)
    assert msg is None, (kind, n, msg)


# -- the dense matrices -------------------------------------------------------
# Kernel against plain on the sweep of chip_smoke.py phase 14, in squared
# space (repro_torch.testing: SQ_RTOL x (|x|^2 + |y|^2) for pdist_sq and
# zen_estimate, JSD_KTOL on K = D^2 for jsd_pdist; the distances then agree
# within the square root of that).

_DTYPES = [torch.float32, torch.bfloat16]


def _check_dense(kind, kernel, plain, X, Y, *args):
    before = kernel.launches
    got = kernel(X, Y, *args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = plain(X, Y, *args)
    _, _, why = dense_errors(kind, X, Y, got, want)
    assert why is None, why
    return got


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("shape", PDIST_CASES)
def test_pdist_sq_matches_plain(cuda, dtype, shape):
    X, Y = dense_inputs("pdist", shape, sum(shape), dtype, cuda)
    _check_dense("pdist", pk.pdist_sq, pk.pdist_sq_plain, X, Y)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("mode", ["zen", "lwb", "upb"])
@pytest.mark.parametrize("shape", ZEN_CASES)
def test_zen_estimate_matches_plain(cuda, dtype, mode, shape):
    X, Y = dense_inputs("zen", shape, sum(shape), dtype, cuda)
    _check_dense("zen", zk.zen_estimate, zk.zen_estimate_plain, X, Y, mode)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("shape", JSD_CASES)
def test_jsd_pdist_matches_plain(cuda, dtype, shape):
    X, Y = dense_inputs("jsd", shape, sum(shape), dtype, cuda)
    _check_dense("jsd", jk.jsd_pdist, jk.jsd_pdist_plain, X, Y)


def test_dense_self_matrices(cuda):
    """X against itself, where the norm expansion and K cancel to ~0 on the
    diagonal: the check is in squared space."""
    X, _ = dense_inputs("pdist", (300, 1, 513), 1, torch.float32, cuda)
    d2 = _check_dense("pdist", pk.pdist_sq, pk.pdist_sq_plain, X, X)
    assert float(d2.diagonal().max()) <= SQ_RTOL * 2 * float(
        (X * X).sum(1).max())
    Z, _ = dense_inputs("zen", (200, 1, 16), 2, torch.float32, cuda)
    _check_dense("zen", zk.zen_estimate, zk.zen_estimate_plain, Z, Z, "lwb")
    P, _ = dense_inputs("jsd", (300, 1, 256), 3, torch.float32, cuda)
    d = _check_dense("jsd", jk.jsd_pdist, jk.jsd_pdist_plain, P, P)
    assert float(d.diagonal().max()) <= JSD_KTOL ** 0.5


def test_jsd_sparse_rows(cuda):
    """0 log 0 inside the kernel, and disjoint supports give exactly 1."""
    X = torch.tensor([[0.5, 0.5, 0.0, 0.0], [0.25, 0.25, 0.25, 0.25]],
                     device=cuda)
    Y = torch.tensor([[0.0, 0.0, 0.5, 0.5]], device=cuda)
    got = jk.jsd_pdist(X, Y)
    assert torch.isfinite(got).all()
    assert float(got[0, 0]) == 1.0
    _check_dense("jsd", jk.jsd_pdist, jk.jsd_pdist_plain, X, Y)


@pytest.mark.parametrize("k", [300, 513, 1_024])
def test_zen_estimate_matches_plain_past_one_chunk(cuda, k):
    """k past the 256 columns one chunk stages."""
    X, Y = dense_inputs("zen", (130, 70, k), k, torch.float32, cuda)
    for mode in ("zen", "lwb", "upb"):
        _check_dense("zen", zk.zen_estimate, zk.zen_estimate_plain, X, Y,
                     mode)


def test_dense_kernels_take_more_column_tiles_than_grid_y(cuda):
    """K past 65,535 column tiles of 64 (4,194,240 columns): the kernels
    loop over the tiles grid y cannot hold."""
    k = 65_535 * 64 + 1_000
    X, Y = dense_inputs("pdist", (3, k, 8), 7, torch.float32, cuda)
    _check_dense("pdist", pk.pdist_sq, pk.pdist_sq_plain, X, Y)
    P, Q = dense_inputs("jsd", (2, k, 4), 8, torch.float32, cuda)
    _check_dense("jsd", jk.jsd_pdist, jk.jsd_pdist_plain, P, Q)
    Z, W = dense_inputs("zen", (3, k, 8), 9, torch.float32, cuda)
    _check_dense("zen", zk.zen_estimate, zk.zen_estimate_plain, Z, W, "zen")


def test_dense_ops_dispatch_on_card(cuda):
    X, Y = dense_inputs("pdist", (50, 30, 64), 5, torch.float32, cuda)
    before = pk.pdist_sq.launches
    d = ops.pdist(X, Y)
    assert pk.pdist_sq.launches == before + 1
    torch.testing.assert_close(d * d, pk.pdist_sq_plain(X, Y), rtol=1e-5,
                               atol=SQ_RTOL * float((X * X).sum(1).max()
                                                    + (Y * Y).sum(1).max()))
    before = (zk.zen_estimate.launches, jk.jsd_pdist.launches)
    ops.zen_estimate(X, Y, "upb")
    P, Q = dense_inputs("jsd", (20, 10, 48), 6, torch.float32, cuda)
    ops.jsd_pdist(P, Q)
    assert (zk.zen_estimate.launches, jk.jsd_pdist.launches) == (
        before[0] + 1, before[1] + 1)


def _plan(X, Y):
    return pk.pdist_plan(X.shape[0], Y.shape[0], X.shape[1], X.dtype,
                         pk.operands_aligned(X, Y),
                         n_sms=torch.cuda.get_device_properties(
                             X.device).multi_processor_count)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("shape", PDIST_PLAN_CASES)
def test_pdist_sq_plans_match_plain(cuda, dtype, shape):
    """Each plan at its boundaries against the plain version; where the
    shape takes the MMA plan, also against the SIMT tile on the same
    inputs."""
    X, Y = dense_inputs("pdist", shape, sum(shape), dtype, cuda)
    got = _check_dense("pdist", pk.pdist_sq, pk.pdist_sq_plain, X, Y)
    if _plan(X, Y).kernel == "mma":
        simt = pk.pdist_sq(X, Y, plan=pk.dense_plan(*shape))
        _, _, why = dense_errors("pdist", X, Y, got, simt)
        assert why is None, why


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("kind,shape", [
    ("pdist", (300, 260, 4096)), ("near", (256, 200, 256)),
    ("near", (130, 140, 4096))])
def test_pdist_sq_mma_plan_holds_long_and_near_rows(cuda, dtype, kind, shape):
    """m = 4,096 (128 stages: each stage's tensor-core partial goes into an
    f32 total, so the truncating accumulation does not grow with m), and
    nearly equal rows of norm ~1,000 (|x|^2 + |y|^2 ~ 2e6 cancels down to
    distances ~1e-3), within SQ_RTOL x (|x|^2 + |y|^2)."""
    X, Y = dense_inputs(kind, shape, 11, dtype, cuda)
    assert _plan(X, Y).kernel == "mma"
    _check_dense("pdist", pk.pdist_sq, pk.pdist_sq_plain, X, Y)


@pytest.mark.parametrize("dtype", _DTYPES)
def test_pdist_sq_mma_plan_self_matrix(cuda, dtype):
    """X against X in the MMA plan: the diagonal cancels to ~0."""
    X, _ = dense_inputs("pdist", (300, 1, 256), 4, dtype, cuda)
    assert _plan(X, X).kernel == "mma"
    d2 = _check_dense("pdist", pk.pdist_sq, pk.pdist_sq_plain, X, X)
    assert float(d2.diagonal().max()) <= SQ_RTOL * 2 * float(
        (X.float() ** 2).sum(1).max())


@pytest.fixture(scope="module")
def smem_fill(tmp_path_factory):
    """probes/smem_fill.cu built and loaded: ``smem_fill_launch(byte,
    stream)`` fills every SM's shared memory with ``byte``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernels cannot run here)")
    src = Path(pk.__file__).parent / "probes" / "smem_fill.cu"
    out = tmp_path_factory.mktemp("smem_fill") / "smem_fill.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.smem_fill_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.smem_fill_launch.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("dtype,shape", [
    (torch.float32, (200, 132, 36)), (torch.float32, (129, 260, 100)),
    (torch.float32, (300, 200, 12)), (torch.float32, (300, 200, 4)),
    (torch.bfloat16, (300, 200, 40))])
def test_pdist_sq_mma_plan_reads_no_stale_shared_memory(cuda, smem_fill,
                                                       dtype, shape):
    """A last stage whose last k-step is half zero fill (f32 m % 8 == 4,
    bf16 m % 16 == 8), launched on shared memory filled with 0xff bytes
    (NaN words) first: the wgmmas read only what the stage's TMA copy and
    preparation wrote, so the distances stay finite and match the plain
    version."""
    X, Y = dense_inputs("pdist", shape, 5, dtype, cuda)
    assert _plan(X, Y).kernel == "mma"
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert smem_fill.smem_fill_launch(0xff, stream) == 0
    got = _check_dense("pdist", pk.pdist_sq, pk.pdist_sq_plain, X, Y)
    assert bool(torch.isfinite(got).all())


def test_pdist_sq_offset_views(cuda):
    """A contiguous view 4 bytes off a 16-byte boundary takes the SIMT tile
    (the TMA cannot read it); one whole row in stays in the MMA plan."""
    base = torch.randn(300 * 64 + 4, device=cuda)
    X = base[:300 * 64].view(300, 64)
    off = base[1:300 * 64 + 1].view(300, 64)
    Y = X[100:]
    assert _plan(off, X).kernel == "simt" and _plan(Y, X).kernel == "mma"
    _check_dense("pdist", pk.pdist_sq, pk.pdist_sq_plain, off, X)
    _check_dense("pdist", pk.pdist_sq, pk.pdist_sq_plain, Y, X)


def test_pdist_sq_wide_cols_through_the_mma_plan(cuda):
    """phase 14's 4,195,240 columns: 32,776 column tiles walked by the
    persistent grid (no grid-y limit), and the same on the SIMT tile."""
    k = 65_535 * 64 + 1_000
    X, Y = dense_inputs("pdist", (3, k, 8), 7, torch.float32, cuda)
    assert _plan(X, Y).kernel == "mma"
    got = _check_dense("pdist", pk.pdist_sq, pk.pdist_sq_plain, X, Y)
    simt = pk.pdist_sq(X, Y, plan=pk.dense_plan(3, k, 8))
    _, _, why = dense_errors("pdist", X, Y, got, simt)
    assert why is None, why


@pytest.mark.parametrize("kind", ["pdist", "zen", "jsd"])
@pytest.mark.parametrize("dtypes", [(torch.bfloat16, torch.float32),
                                    (torch.float32, torch.bfloat16)])
def test_dense_kernels_keep_each_operands_dtype(cuda, kind, dtypes):
    """X and Y in different dtypes: both launch as f32, so each keeps its
    own values, as the plain versions and the TPU kernels do (a launch in
    X's bf16 would round an f32 Y, ~1e-3 relative)."""
    fn, plain, extra = {
        "pdist": (pk.pdist_sq, pk.pdist_sq_plain, ()),
        "zen": (zk.zen_estimate, zk.zen_estimate_plain, ("zen",)),
        "jsd": (jk.jsd_pdist, jk.jsd_pdist_plain, ())}[kind]
    X, _ = dense_inputs(kind, (130, 72, 64), 3, dtypes[0], cuda)
    _, Y = dense_inputs(kind, (130, 72, 64), 3, dtypes[1], cuda)
    _check_dense(kind, fn, plain, X, Y, *extra)


def test_dense_kernels_reject_what_they_do_not_take(cuda):
    X = torch.rand((8, 16))
    for fn in (pk.pdist_sq, zk.zen_estimate, jk.jsd_pdist):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(X, X)
        with pytest.raises(ValueError, match="takes"):
            fn(X.to(cuda).double(), X.to(cuda).double())
        with pytest.raises(ValueError, match=r"\(N, m\) and \(K, m\)"):
            fn(X.to(cuda), X[:, :5].to(cuda))
    wide = torch.rand((4, 300), device=cuda)
    _check_dense("zen", zk.zen_estimate, zk.zen_estimate_plain, wide, wide)
    with pytest.raises(ValueError, match="mode"):
        zk.zen_estimate(X.to(cuda), X.to(cuda), "exact")


# -- batch invariance, the frontend and replication on the card ----------------

#: query counts a served row must keep its bits across: alone (bucket 2),
#: odd buckets, a full max_batch, one past it (two dispatch blocks), and 200
INVARIANT_Q = (1, 2, 3, 17, 64, 65, 200)


@pytest.fixture(scope="module")
def card_servers():
    """The 1,000,000 x 256 manifold corpus (k = 16) as the smoke run serves
    it: flat, IVF f32 and PQ (4,000 clusters of 128-row tiles) and the f32
    index tiered (hot fraction 0.1); 200 queries. Built once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernels cannot run here)")
    import dataclasses

    from repro_torch.data import synthetic as syn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    corpus = syn.manifold_space(1_000_000, 256, 32, generator=gen)
    queries = syn.manifold_space(200, 256, 32, generator=gen)

    def build(**kw):
        return serve.build_index(corpus, 16, device=dev,
                                 generator=torch.Generator().manual_seed(0),
                                 **kw)

    ivf_kw = dict(index="ivf", n_clusters=4_000, tile_rows=128)
    indexes = {"flat": build(), "ivf": build(**ivf_kw),
               "ivf_pq": build(storage="pq", **ivf_kw)}
    indexes["tiered"] = dataclasses.replace(
        indexes["ivf"], ivf=ivf.TieredIVFZenIndex.from_index(
            indexes["ivf"].ivf, hot_fraction=0.1, n_shards=4))
    return indexes, queries


def _bits(res):
    d, ids = res
    return d.contiguous().view(torch.int32).cpu(), ids.cpu()


@pytest.mark.parametrize("rerank", [0, 4])
@pytest.mark.parametrize("kind", ["flat", "ivf", "ivf_pq", "tiered"])
def test_rows_keep_their_bits_in_any_batch_on_card(card_servers, kind,
                                                   rerank):
    """Every served row has the same bits at Q = 1, 2, 3, 17, 64, 65 and
    200 (past max_batch: blocks of 64) as in the 200-row batch."""
    indexes, queries = card_servers
    server = serve.ZenServer(indexes[kind], nprobe=8, rerank_factor=rerank)
    wd, wi = _bits(server.query(queries, 10))
    assert torch.isfinite(wd.view(torch.float32)).all()
    for nq in INVARIANT_Q:
        for lo in sorted({0, 200 - nq, (200 - nq) // 2}):
            d, ids = _bits(server.query(queries[lo:lo + nq], 10))
            assert torch.equal(d, wd[lo:lo + nq]), (kind, nq, lo)
            assert torch.equal(ids, wi[lo:lo + nq]), (kind, nq, lo)


@pytest.mark.parametrize("kind", ["flat", "ivf", "ivf_pq"])
def test_coalesced_and_cached_rows_equal_direct_on_card(card_servers, kind):
    indexes, queries = card_servers
    server = serve.ZenServer(indexes[kind], nprobe=8, rerank_factor=4,
                             frontend=True, cache_size=1_024)
    sched = server.frontend
    handles = [sched.submit(queries[i], 10) for i in range(64)]
    assert sched.tick() == 1
    hits = [sched.submit(queries[i], 10) for i in range(64)]
    assert all(h.done() for h in hits) and sched.stats.cache_hits == 64
    for i, (h, c) in enumerate(zip(handles, hits)):
        alone = _bits(server.query(queries[i:i + 1], 10, direct=True))
        got = h.result()  # (1, 10) host arrays
        assert np.array_equal(got[0].view(np.int32), alone[0].numpy())
        assert np.array_equal(got[1], alone[1].numpy())
        assert np.array_equal(c.result()[0], got[0])
        assert np.array_equal(c.result()[1], got[1])


@contextlib.contextmanager
def _plain_search():
    """``kernels.ops`` sends CUDA tensors to the search kernels' plain
    versions (the reference of the concurrency test)."""
    saved = ops.zen_topk, ops.ivf_probe, ops.ivf_probe_pq
    ops.zen_topk = zt.zen_topk_scan
    ops.ivf_probe, ops.ivf_probe_pq = ip.ivf_probe_scan, ip.ivf_probe_pq_scan
    try:
        yield
    finally:
        ops.zen_topk, ops.ivf_probe, ops.ivf_probe_pq = saved


def test_ticker_and_direct_callers_on_a_tiered_index_on_card(card_servers):
    """The ticker thread and 16 direct or frontend callers search one
    tiered index at once: every answer equals the same query served alone
    (bit for bit) and the plain versions' (within the tolerance)."""
    import threading

    indexes, queries = card_servers
    server = serve.ZenServer(indexes["tiered"], nprobe=8, rerank_factor=4,
                             frontend=True, tick_interval=0.0005)
    alone = {i: _bits(server.query(queries[i:i + 1], 10, direct=True))
             for i in range(16)}
    with _plain_search():
        plain = server.query(queries[:16], 10, direct=True)
    launches = ip.ivf_probe.launches
    server.frontend.start()
    got, errors = {}, []

    def caller(i):
        try:
            for r in range(4):
                got[(i, r)] = _bits(server.query(
                    queries[i:i + 1], 10, direct=(i + r) % 2 == 0))
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=caller, args=(i,))
               for i in range(16)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        server.frontend.stop()
    assert not errors, errors
    assert len(got) == 64 and ip.ivf_probe.launches > launches
    atol = 1e-5 * float(queries[:16].norm(dim=1).median())
    for (i, _), (d, ids) in got.items():
        assert torch.equal(d, alone[i][0]) and torch.equal(ids, alone[i][1])
        msg = topk_mismatch(d.view(torch.float32), ids, plain[0][i:i + 1],
                            plain[1][i:i + 1], rtol=1e-5, atol=atol)
        assert msg is None, (i, msg)


def test_replica_swap_with_queries_in_flight_on_card(card_servers,
                                                     tmp_path):
    """A card replica hot-swaps under a thread that keeps querying it:
    every in-flight answer is one generation's, bit for bit, the old
    generation is released once idle, and the new one equals the leader."""
    import threading

    from repro_torch.launch.replicate import IndexLeader, QueryReplica

    indexes, queries = card_servers
    leader_srv = serve.ZenServer(indexes["ivf"], nprobe=8, rerank_factor=4)
    leader = IndexLeader(leader_srv, str(tmp_path))
    leader.publish()
    rep = QueryReplica(str(tmp_path))
    assert rep.poll() and rep.server.index.device.type == "cuda"
    q = queries[:64]
    gen0 = _bits(leader_srv.query(q, 10, direct=True))
    assert all(torch.equal(a, b) for a, b in zip(_bits(rep.query(q, 10)),
                                                gen0))
    stop, seen, errors = threading.Event(), [], []

    def reader():
        try:
            while not stop.is_set():
                seen.append(_bits(rep.query(q, 10)))
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    t = threading.Thread(target=reader)
    t.start()
    try:
        victims = gen0[1][:, 0].tolist()[:8]
        leader.delete(victims)
        leader.publish()
        assert rep.poll()
    finally:
        stop.set()
        t.join(timeout=120)
    assert not errors, errors
    gen1 = _bits(leader_srv.query(q, 10, direct=True))
    assert rep.generation == leader.generation == 1
    assert all(torch.equal(a, b) for a, b in zip(_bits(rep.query(q, 10)),
                                                gen1))
    for d, ids in seen:
        assert any(torch.equal(d, g[0]) and torch.equal(ids, g[1])
                   for g in (gen0, gen1))
    assert rep.released_generations() == (0,)
    assert not set(gen1[1].ravel().tolist()) & set(victims)


# -- a reproducible IVF build, and sharded serving on the card -------------------


def _snapshot_arrays(path):
    from repro_torch.checkpoint import index_io

    arrays, meta = index_io.load_state(str(path),
                                       expect_kind=serve.SERVER_SNAPSHOT_KIND)
    return {k: np.asarray(v) for k, v in arrays.items()}, meta


@pytest.mark.parametrize("storage", ["float32", "int8", "pq"])
def test_ivf_build_is_reproducible_on_the_card(cuda, storage, tmp_path):
    """Two IVF builds of 100,000 rows from equal generators save the same
    bytes: the k-means sums (and so the centroids, lists, int8 scales, PQ
    codebooks and codes) do not depend on the order the card's threads
    run in."""
    from repro_torch.data import synthetic as syn

    corpus = syn.manifold_space(
        100_000, 64, 8, generator=torch.Generator(device=cuda).manual_seed(1))
    snaps = []
    for i in range(2):
        index = serve.build_index(
            corpus, 16, index="ivf", storage=storage, n_clusters=1_000,
            generator=torch.Generator().manual_seed(0), device=cuda)
        serve.ZenServer(index, nprobe=8).save(str(tmp_path / f"b{i}"))
        snaps.append(_snapshot_arrays(tmp_path / f"b{i}"))
    (a, meta_a), (b, meta_b) = snaps
    assert meta_a == meta_b and sorted(a) == sorted(b)
    for name in a:
        assert a[name].tobytes() == b[name].tobytes(), name


@pytest.fixture(scope="module")
def sharded_corpus():
    from repro_torch.data import synthetic as syn

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernels cannot run here)")
    gen = torch.Generator(device="cuda").manual_seed(2)
    return (syn.manifold_space(200_003, 64, 8, generator=gen),
            syn.manifold_space(64, 64, 8, generator=gen))


@pytest.mark.parametrize("kind", ["flat", "flat_int8", "ivf", "ivf_int8"])
def test_sharded_server_on_card_matches_single_device(sharded_corpus, kind,
                                                      tmp_path):
    """A 4-shard server (every card when there are four, else 4 logical
    shards of cuda:0) answers as the single-device server, up to near
    ties, launching the search kernel once a shard a batch: the flat one
    reloaded from the single-device snapshot, the IVF one built from the
    same generator (the same centroids, bytes and all)."""
    from repro_torch.distributed import make_mesh

    corpus, queries = sharded_corpus
    storage = "int8" if kind.endswith("int8") else "float32"
    kw = dict(index="ivf", n_clusters=500) if kind.startswith("ivf") else {}
    single = serve.build_index(corpus, 16, storage=storage,
                               generator=torch.Generator().manual_seed(0),
                               device="cuda", **kw)
    mesh = make_mesh(4)
    if kind.startswith("ivf"):
        sharded = serve.build_index(
            corpus, 16, storage=storage, mesh=mesh,
            generator=torch.Generator().manual_seed(0), **kw)
        assert torch.equal(sharded.ivf.centroids, single.ivf.centroids)
        kernel = ip.ivf_probe
    else:
        serve.ZenServer(single).save(str(tmp_path / "flat"))
        sharded = serve.load_index_snapshot(str(tmp_path / "flat"),
                                            mesh=mesh)[0]
        kernel = zt.zen_topk
    want = serve.ZenServer(single, nprobe=8, rerank_factor=4).query(
        queries, 10)
    server = serve.ZenServer(sharded, nprobe=8, rerank_factor=4)
    before = kernel.launches
    got = server.query(queries, 10)
    torch.cuda.synchronize()
    assert kernel.launches == before + 4
    assert got[0].device == mesh.first_device
    msg = topk_mismatch(got[0], got[1], want[0], want[1], **TOL)
    assert msg is None, msg


# -- the recsys trainer on the card ----------------------------------------------


LM_ARCHS = ["qwen1.5-0.5b", "gemma2-2b", "granite-8b",
            "granite-moe-3b-a800m", "qwen2-moe-a2.7b"]


def _reduced_trainer(arch, device):
    """The reduced ``arch`` from weights drawn on the CPU (seed 0), moved
    to ``device``, and its batch maker (recsys B = 256; LM B = 8, S = 64;
    GNN 16 graphs of 16 nodes and 48 edges) drawing on the CPU."""
    import functools

    from repro_torch import configs as C
    from repro_torch.launch import train
    from repro_torch.models import mace, recsys, transformer

    spec = C.get_arch(arch)
    cfg = spec.make_reduced()
    lib = {"lm": transformer, "gnn": mace, "recsys": recsys}[spec.family]
    model = lib.init_params(cfg, generator=torch.Generator().manual_seed(0))
    trainer = train.Trainer(model.to(device),
                            functools.partial(lib.loss_fn, cfg))
    make = train.family_batch_fn(
        spec.family, cfg, seed=0,
        batch={"lm": 8, "gnn": 16}.get(spec.family, 256), seq=64,
        device="cpu")
    return trainer, make


def _to(batch, dev):
    """A batch's tensors on ``dev``; its other entries as they are."""
    return {k: v.to(dev) if isinstance(v, torch.Tensor) else v
            for k, v in batch.items()}


def _loss_and_grads(trainer, batch):
    loss, _ = trainer.loss_fn(trainer.model, batch)
    return loss.detach(), dict(zip(trainer.params, torch.autograd.grad(
        loss, list(trainer.params.values()), materialize_grads=True)))


@pytest.mark.parametrize("arch", ["dlrm-rm2", "autoint", "wide-deep",
                                  "xdeepfm", "mace"] + LM_ARCHS)
def test_reduced_train_step_on_card_matches_cpu(cuda, arch):
    """Two steps of the reduced model on the card and on the CPU from equal
    weights and batches: losses and parameters within the CPU parity
    tests' step tolerance (rtol 1e-4, atol 1e-6).

    An LM or MACE step is held in its two parts: the losses and each
    step's gradients (rtol 1e-4, atol 1e-6), then both sides' AdamW
    updates of the card's gradients (parameters rtol 1e-4, atol 1e-6).
    AdamW divides each gradient by its own root mean square, so an element
    whose f32 sum cancels to ~1e-5 of its leaf's scale (its last digits
    set by the summation order, ~1% apart on the two backends) moves by
    ~1% of the learning rate apart: a few of the LMs' 16,384-element
    leaves do."""
    from repro_torch import configs as C
    from repro_torch.optim import apply_updates

    split = C.get_arch(arch).family != "recsys"
    cpu, make = _reduced_trainer(arch, "cpu")
    card, _ = _reduced_trainer(arch, cuda)
    for s in range(2):
        batch = make(s)
        if not split:
            want = cpu.step(batch)[0].item()
            got = card.step(_to(batch, cuda))[0].item()
            np.testing.assert_allclose(got, want, rtol=1e-4)
            continue
        want, want_g = _loss_and_grads(cpu, batch)
        got, got_g = _loss_and_grads(card, _to(batch, cuda))
        np.testing.assert_allclose(got.item(), want.item(), rtol=1e-4)
        for name, g in want_g.items():
            np.testing.assert_allclose(got_g[name].cpu().numpy(), g.numpy(),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {s} grad {name}")
        for tr, grads in ((cpu, {n: g.cpu().clone() for n, g in got_g.items()}),
                          (card, got_g)):
            upd, tr.opt_state = tr.opt.update(grads, tr.opt_state,
                                              tr.params)
            apply_updates(tr.params, upd)
    for name, p in cpu.params.items():
        np.testing.assert_allclose(card.params[name].detach().cpu().numpy(),
                                   p.detach().numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("case", testing.MATMUL_CASES)
def test_matmul_f32_bf16_result_and_gradients(cuda, case):
    """``matmul_f32``'s card branch on bf16 operands (``torch.mm``/``bmm``
    with an f32 result; its gradients the same call on the cotangent
    rounded to bf16): an f32 result and bf16 gradients within
    ``testing.matmul_f32_errors``' bounds of f64 products of the same
    values (a wrong transpose, dimension or rounding is off by O(1))."""
    errs = testing.matmul_f32_errors(*testing.matmul_inputs(*case, 0, cuda))
    assert max(errs.values()) <= 1, errs


def test_bf16_lm_on_card_matches_cpu(cuda):
    """qwen1.5-0.5b's reduced config in bf16, one set of weights drawn on
    the CPU: the card (every product through ``matmul_f32``'s mixed-
    precision branch) against the CPU (f32 products of the same values):
    forward logits, loss and every gradient leaf within the bf16
    tolerances of the CPU parity test (``testing.bf16_lm_mismatch``)."""
    import dataclasses

    from repro_torch import configs as C
    from repro_torch.models import transformer

    cfg = dataclasses.replace(C.get_arch("qwen1.5-0.5b").make_reduced(),
                              dtype=torch.bfloat16)
    cpu = transformer.init_params(cfg,
                                  generator=torch.Generator().manual_seed(1))
    card = transformer.init_params(
        cfg, generator=torch.Generator().manual_seed(1)).to(cuda)
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 96)).astype(np.int32))
    msg = testing.bf16_lm_mismatch(
        *testing.lm_outputs(cfg, card, toks.to(cuda)),
        *testing.lm_outputs(cfg, cpu, toks))
    assert msg is None, msg


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen2-moe-a2.7b"])
def test_moe_gradients_are_deterministic_on_card(cuda, arch):
    """An MoE step's gradients on the card, 3 times from the same weights
    and batch (B = 8, S = 256: 32 groups of 64 tokens, capacity drops and
    tokens routed to the same experts): the same bits every time (the
    dispatch's backward is an expand's fixed-order sum, the combine's the
    deterministic row gather's), in f32 and in bf16 (the products'
    mixed-precision branch)."""
    import dataclasses

    from repro_torch import configs as C
    from repro_torch.data import synthetic as syn
    from repro_torch.models import transformer

    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(C.get_arch(arch).make_reduced(),
                                  dtype=dtype)
        model = transformer.init_params(
            cfg, generator=torch.Generator().manual_seed(1)).to(cuda)
        batch = syn.lm_batch(8, 256, cfg.vocab_size,
                             generator=syn.batch_generator(0, 0, cuda))
        grads = []
        for _ in range(3):
            loss, _ = transformer.loss_fn(cfg, model, batch)
            grads.append(torch.autograd.grad(loss, list(model.parameters())))
        for g in grads[1:]:
            for (name, _), a, b in zip(model.named_parameters(), grads[0], g):
                assert a.dtype == dtype and torch.equal(a, b), (dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mace_gradients_are_deterministic_on_card(cuda, dtype):
    """A reduced MACE's gradients on the card, 3 times from the same
    weights and graphs (64 graphs, 1,024 nodes, 3,072 edges; graph- and
    node-level; 1 edge chunk, and 4 under remat): the same bits every time
    (the sender gathers' backward is the deterministic row gather's, the
    edge -> node sums are ``segment_sum``'s sequential segments, its
    backward a gather)."""
    import dataclasses

    from repro_torch import configs as C
    from repro_torch.data import synthetic as syn
    from repro_torch.models import mace

    for node_level, chunks in ((False, 1), (True, 4)):
        cfg = dataclasses.replace(C.get_arch("mace").make_reduced(),
                                  dtype=getattr(torch, dtype),
                                  edge_chunks=chunks, remat=chunks > 1)
        model = mace.init_params(
            cfg, generator=torch.Generator().manual_seed(1)).to(cuda)
        batch = dict(syn.geometric_graph_batch(
            5, 1_024, 3_072, cfg.d_feat, n_graphs=64, node_level=node_level,
            device=cuda), n_graphs=64, node_level=node_level)
        grads = []
        for _ in range(3):
            loss, _ = mace.loss_fn(cfg, model, batch)
            grads.append(torch.autograd.grad(loss, list(model.parameters()),
                                             materialize_grads=True))
        for g in grads[1:]:
            for (name, _), a, b in zip(model.named_parameters(), grads[0], g):
                assert a.dtype == cfg.dtype and torch.equal(a, b), name


def test_bf16_mace_on_card_within_bounds_of_f64(cuda):
    """The reduced MACE in bf16 on the card (bf16 GEMMs, f32 promotion of
    the l = 2 paths): energies, loss and every gradient leaf within
    ``testing.bf16_gnn_mismatch``'s bounds of an f64 evaluation of the same
    parameters on the CPU."""
    import dataclasses

    from repro_torch import configs as C
    from repro_torch.data import synthetic as syn
    from repro_torch.models import mace

    cfg = dataclasses.replace(C.get_arch("mace").make_reduced(),
                              dtype=torch.bfloat16)
    model = mace.init_params(cfg, generator=torch.Generator().manual_seed(2))
    f64 = dataclasses.replace(cfg, dtype=torch.float64)
    ref = mace.MACE(f64)
    ref.load_state_dict({k: v.double() for k, v in
                         model.state_dict().items()})
    for node_level in (False, True):
        batch = dict(syn.geometric_graph_batch(
            6, 256, 768, cfg.d_feat, n_graphs=16, node_level=node_level,
            device="cpu"), n_graphs=16, node_level=node_level)
        msg = testing.bf16_gnn_mismatch(
            *testing.gnn_outputs(cfg, model.to(cuda), _to(batch, cuda)),
            *testing.gnn_outputs(f64, ref, batch))
        assert msg is None, (node_level, msg)


def test_segment_sum_is_deterministic_on_card(cuda):
    """``layers.segment_sum`` on the card: ids that repeat ~60 times and
    segments with no row, f32 and bf16, 1-D and (E, 9) rows: the same bits
    in three runs, empty segments exact zeros, and the CPU's sequential
    sums within 1e-6 (f32; bf16 within one bf16 ulp of the largest)."""
    from repro_torch.models import layers

    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 4_000, 250_000) * 2)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((250_000,), (250_000, 9)):
            x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                 ).to(dtype)
            got = [layers.segment_sum(x.to(cuda), ids.to(cuda), 8_001)
                   for _ in range(3)]
            assert torch.equal(got[0], got[1]) and torch.equal(got[0],
                                                               got[2])
            assert not got[0][1::2].any()
            want = layers.segment_sum(x, ids, 8_001).float()
            tol = 1e-6 if dtype == torch.float32 else \
                2**-8 * float(want.abs().max())
            np.testing.assert_allclose(got[0].float().cpu().numpy(),
                                       want.numpy(), rtol=1e-6, atol=tol)


def test_gather_backward_is_deterministic_on_card(cuda):
    """The recsys gather's backward on ids that repeat ~500 times: the same
    bits in three runs, and the CPU's sequential sums within 1e-6."""
    from repro_torch.models import recsys

    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (32_768, 8))).to(cuda)
    go = torch.randn((32_768, 8, 16), device=cuda)
    table = torch.zeros((600, 16), device=cuda, requires_grad=True)
    grads = [torch.autograd.grad(recsys.gather_rows(table, ids), table,
                                 go)[0] for _ in range(3)]
    assert torch.equal(grads[0], grads[1]) and torch.equal(grads[0],
                                                           grads[2])
    cpu_table = table.detach().cpu().requires_grad_(True)
    want = torch.autograd.grad(recsys.gather_rows(cpu_table, ids.cpu()),
                               cpu_table, go.cpu())[0]
    np.testing.assert_allclose(grads[0].cpu().numpy(), want.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert not grads[0][512:].any()


@pytest.mark.parametrize("arch", ["dlrm-rm2", "wide-deep", "mace"]
                         + LM_ARCHS)
def test_resumed_training_on_card_is_bit_exact(cuda, arch, tmp_path):
    """The trainer's CLI on the card: 6 steps with a checkpoint at 3, then a
    run resumed from it; the resumed steps' losses and the final parameters
    are the uninterrupted run's bits (the gathers' backwards, the
    reductions and the GEMMs are deterministic on one stream). The batch
    is large enough that ids repeat (duplicated rows in the backward):
    recsys B = 4,096; LM B = 16 x S = 256 tokens of a 512-token
    vocabulary; MACE 64 graphs (1,024 nodes, 3,072 edges)."""
    from repro_torch import configs as C
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train

    batch = {"lm": "16", "gnn": "64"}.get(C.get_arch(arch).family, "4096")
    args = ["--arch", arch, "--reduced", "--device", "cuda", "--batch",
            batch, "--seq", "256", "--ckpt-every", "3"]
    full = train.main(args + ["--steps", "6", "--ckpt-dir",
                              str(tmp_path / "a")])
    mgr = CheckpointManager(str(tmp_path / "a"))
    assert mgr.all_steps() == [3, 6]
    # resume from step 3: keep only that checkpoint in a second directory
    CheckpointManager(str(tmp_path / "b")).save(
        3, mgr.restore(3, like=full["trainer"].state_tree())[1])
    resumed = train.main(args + ["--steps", "6", "--resume", "--ckpt-dir",
                                 str(tmp_path / "b")])
    assert resumed["start_step"] == 3
    assert resumed["losses"] == full["losses"][3:]
    for name, p in full["trainer"].params.items():
        assert torch.equal(resumed["trainer"].params[name], p), name


# -- the LM trainer on a (data, model) mesh on the card -------------------------


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_sharded_lm_on_card_matches_unsharded(cuda, arch):
    """A reduced bf16 LM laid out on ``make_host_mesh(2, 2)`` (four cards
    where there are four, else four logical shards of the card) against
    the same weights unsharded on the card: forward logits, loss and every
    gradient leaf within ``testing.bf16_lm_mismatch`` (an MoE's single
    device routed as the mesh routed: a near-tie of the top-k may go the
    other way where the row-parallel sums round differently); the sharded
    gradients twice the same bits; after a step every holder of every
    shard holds the same bits."""
    import contextlib
    import dataclasses

    from repro_torch import configs as C
    from repro_torch.distributed import partition
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer

    cfg = dataclasses.replace(C.get_arch(arch).make_reduced(),
                              dtype=torch.bfloat16)
    model = transformer.init_params(
        cfg, generator=torch.Generator().manual_seed(1)).to(cuda)
    mesh = make_host_mesh(2, 2)
    specs = transformer.param_specs(cfg)
    placed = {}
    for name, p in model.named_parameters():
        placed[name] = partition.place(p.detach(), specs[name], mesh)
        for s in placed[name].shards:
            s.requires_grad_(True)
    sharded = transformer.ShardedTransformer(cfg, mesh, placed)
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (4, 96)).astype(np.int32)).to(cuda)
    tr = train.ShardedTrainer(sharded)
    runs = [tr.reduced_grads({"tokens": toks}) for _ in range(2)]
    for name in placed:
        for a, b in zip(runs[0][2][name].shards, runs[1][2][name].shards):
            assert torch.equal(a, b), name
    loss, _, grads = runs[0]
    with testing.recorded_routes([]) as routes:
        logits = transformer.sharded_logits(cfg, sharded, toks)
    # one data replica's routing a layer, then the other's: the rows of
    # the whole batch, in the unsharded model's groups
    routing = contextlib.nullcontext()
    if cfg.is_moe:
        M, L_ = mesh.shape["model"], cfg.n_layers
        per_replica = [routes[d * M * L_:(d + 1) * M * L_:M]
                       for d in range(mesh.shape["data"])]
        routing = testing.routed_as(model, [torch.cat(
            [rep[l].to(cuda) for rep in per_replica]) for l in range(L_)])
    with routing:
        want = testing.lm_outputs(cfg, model, toks)
    msg = testing.bf16_lm_mismatch(
        logits, loss.detach(), {n: g.gather() for n, g in grads.items()},
        *want)
    assert msg is None, msg
    del runs, grads
    tr.step({"tokens": toks})
    for t in (*tr.params.values(), *tr.opt_state.mu.values(),
              *tr.opt_state.nu.values()):
        assert partition.replicas_equal(t)


# -- MACE on a (data, model) mesh on the card ------------------------------------


def test_sharded_sum_scatter_on_card_is_an_f32_sum_in_part_order(cuda):
    """``partition.sum_scatter`` over ``make_host_mesh(1, 4)``'s devices
    (four cards where there are four, else four logical shards of the
    card): block j of the bf16 and f32 parts summed on part j's device in
    part order, in f32, then cast once; the same bits as the CPU's
    elementwise sums, and the backward the blocks' cotangents gathered,
    bit for bit."""
    from repro_torch.distributed import partition
    from repro_torch.launch.mesh import make_host_mesh

    devs = list(make_host_mesh(1, 4).devices.flat)
    gen = torch.Generator().manual_seed(4)
    host = [torch.randn((1_000, 64, 13), generator=gen,
                        dtype=torch.float32 if i % 2 else torch.bfloat16)
            for i in range(4)]
    parts = [h.to(d).requires_grad_(True) for h, d in zip(host, devs)]
    cpu = [h.clone().requires_grad_(True) for h in host]
    for out in (torch.float32, torch.bfloat16):
        got = partition.sum_scatter(parts, 1, out)
        want = partition.sum_scatter(cpu, 1, out)
        for g, w, d in zip(got, want, devs):
            assert g.device == d and torch.equal(g.cpu(), w)
        cot = [torch.randn(w.shape, generator=gen).to(out) for w in want]
        grads = torch.autograd.grad(got, parts, [c.to(d) for c, d in
                                                 zip(cot, devs)])
        for g, p in zip(grads, parts):
            assert g.device == p.device
            assert torch.equal(g.cpu(), torch.cat(cot, 1).to(p.dtype))


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_sharded_mace_on_card_matches_unsharded(cuda, shape):
    """A reduced bf16 MACE (2 edge chunks, remat) on ``make_host_mesh``
    (four cards where there are four, else four logical shards of the
    card) against an f64 evaluation of the same weights and graph on the
    card, within ``testing.bf16_gnn_mismatch``'s bounds; its gradients
    twice the same bits; after a step every holder of every shard holds
    the same bits."""
    import dataclasses

    from repro_torch import configs as C
    from repro_torch.distributed import partition
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import mace

    cfg = dataclasses.replace(C.get_arch("mace").make_reduced(),
                              dtype=torch.bfloat16, edge_chunks=2,
                              remat=True)
    batch = dict(train.gnn_batch_fn(cfg, seed=3, batch=64, device=cuda)(0),
                 node_level=True)
    batch["target_nodes"] = torch.randn(
        batch["positions"].shape[0], generator=torch.Generator().manual_seed(
            3)).to(cuda)
    mesh = make_host_mesh(*shape)
    # the sharded trainer's draws: seed 1 on the mesh's first card
    model = mace.init_params(cfg, generator=torch.Generator(
        device=mesh.first_device).manual_seed(1))
    tr = train.sharded_mace_trainer(cfg, mesh=mesh, seed=1)
    runs = [tr.reduced_grads(batch) for _ in range(2)]
    for name in runs[0][2]:
        for a, b in zip(runs[0][2][name].shards, runs[1][2][name].shards):
            assert torch.equal(a, b), name
    loss, _, grads = runs[0]
    with torch.no_grad():
        energies = mace.sharded_forward(cfg, tr.model, batch)
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64, remat=False)
    m64 = mace.MACE(cfg64, device=cuda)
    m64.load_state_dict({k: v.double().to(cuda)
                         for k, v in model.state_dict().items()})
    want = testing.gnn_outputs(cfg64, m64, batch)
    msg = testing.bf16_gnn_mismatch(
        energies, loss.detach(), {n: g.gather().float()
                                  for n, g in grads.items()}, *want)
    assert msg is None, msg
    del runs, grads
    tr.step(batch)
    for t in (*tr.params.values(), *tr.opt_state.mu.values(),
              *tr.opt_state.nu.values()):
        assert partition.replicas_equal(t)


# -- the recsys family on a (data, model) mesh on the card ------------------------


@pytest.mark.parametrize("M", [2, 4])
def test_sharded_recsys_table_gradient_is_bit_equal_on_card(cuda, M):
    """Reduced DLRM on ``make_host_mesh(1, M)`` (M cards where there are
    M, else logical shards of the card) against the same weights on the
    card alone: the loss, and the table's gradient bit for bit (each shard
    scatters its own ids' rows, each row's duplicates summed in the order
    they occur, from the single device's cotangent: the dense work runs
    whole on the first shard)."""
    from repro_torch import configs as C
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import recsys

    cfg = C.get_arch("dlrm-rm2").make_reduced()
    mesh = make_host_mesh(1, M)
    batch = train.batch_fn(cfg, seed=2, batch=4_096,
                           device=mesh.first_device)(0)
    model = recsys.init_params(cfg, generator=torch.Generator(
        device=mesh.first_device).manual_seed(1))
    loss, _ = recsys.loss_fn(cfg, model, batch)
    (want,) = torch.autograd.grad(loss, [model.table])
    tr = train.sharded_recsys_trainer(cfg, mesh=mesh, seed=1)
    got_loss, _, grads = tr.reduced_grads(batch)
    np.testing.assert_allclose(got_loss.item(), loss.item(), rtol=1e-6)
    assert torch.equal(grads["table"].gather(), want)


def test_sharded_recsys_step_is_the_same_bits_twice_on_card(cuda):
    """Reduced xDeepFM (the CIN's rows split over model) on
    ``make_host_mesh(2, 2)`` (four cards where there are four, else four
    logical shards of the card): two trainers from one seed take the same
    two steps, the same bits (losses, every shard of the parameters and
    moments), and every holder of every shard holds the same bits."""
    from repro_torch import configs as C
    from repro_torch.distributed import partition
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh

    cfg = C.get_arch("xdeepfm").make_reduced()
    mesh = make_host_mesh(2, 2)
    make = train.batch_fn(cfg, seed=3, batch=4_096, device=mesh.first_device)
    runs = []
    for _ in range(2):
        tr = train.sharded_recsys_trainer(cfg, mesh=mesh, seed=3)
        runs.append(([float(tr.step(make(s))[0]) for s in range(2)], tr))
    (la, a), (lb, b) = runs
    assert la == lb and np.isfinite(la).all()
    for x, y in ((a.params, b.params), (a.opt_state.mu, b.opt_state.mu),
                 (a.opt_state.nu, b.opt_state.nu)):
        for n in x:
            assert all(torch.equal(s, t) for s, t in zip(x[n].shards,
                                                         y[n].shards)), n
    for t in (*a.params.values(), *a.opt_state.mu.values(),
              *a.opt_state.nu.values()):
        assert partition.replicas_equal(t)


# -- the LM's prefill and decode plans on a (data, model) mesh on the card -------


@pytest.mark.parametrize("arch,cell,shape", [
    ("gemma2-2b", "decode_32k", (2, 2)), ("gemma2-2b", "long_500k", (2, 2)),
    ("granite-8b", "decode_32k", (1, 4)),
    ("qwen1.5-0.5b", "decode_32k", (1, 4))])
def test_sharded_decode_plan_on_card_matches_unsharded(cuda, arch, cell,
                                                       shape):
    """A reduced bf16 LM's decode plan on ``make_host_mesh(*shape)`` (four
    cards where there are four, else four logical shards of the card)
    from the single device's padded prefill cache, laid out by the plan's
    in specs, against the single device's ``decode_step`` over the same
    six tokens (the ring wraps, the sequence's blocks each take a slot):
    each step's logits and the final cache within
    ``testing.bf16_lm_mismatch``'s logits bounds, the slots no step wrote
    the prefill's bits; a second run from the same placement is the same
    bits (logits and every cache shard)."""
    import dataclasses

    from repro_torch import configs as C
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer

    over = {"dtype": torch.bfloat16}
    cfg = dataclasses.replace(C.get_arch(arch).make_reduced(), **over)
    model = transformer.init_params(
        cfg, generator=torch.Generator().manual_seed(2)).to(cuda)
    rows = 1 if cell == "long_500k" else 4
    S, pad, n_steps = 24, 64, 6
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (rows, S + n_steps)).astype(np.int32)).to(cuda)
    with torch.no_grad():
        _, cache0 = transformer.prefill(cfg, model, toks[:, :S], pad_to=pad)
    plan = steps.build_plan(arch, cell, reduced=True, overrides=over)
    mesh = make_host_mesh(*shape)
    params = steps.place_args(plan, mesh, dict(model.named_parameters()))
    single = {p: {k: v.clone() for k, v in c.items()}
              for p, c in cache0.items()}
    want = []
    for j in range(n_steps):
        lg, single = transformer.decode_step(cfg, model, single,
                                             toks[:, S + j:S + j + 1], S + j)
        want.append(lg)
    runs = []
    for _ in range(2):
        (cache,) = steps.place_inputs(plan, mesh, cache0)
        got = []
        for j in range(n_steps):
            lg, cache = plan.fn(params, cache, toks[:, S + j:S + j + 1],
                                S + j)
            assert lg.spec == plan.out_specs[0]
            got.append(lg.gather(cuda))
        runs.append((torch.stack(got), {f"{p}.{k}": st for p, c in
                                        cache.items()
                                        for k, st in c.items()}))
    msg = testing.bf16_lm_mismatch(runs[0][0], 0.0, {}, torch.stack(want),
                                   0.0, {})
    assert msg is None, msg
    written = set(range(S, S + n_steps))
    for name, st in runs[0][1].items():
        p, k = name.split(".")
        whole, w = st.gather(cuda), single[p][k]
        slots = sorted({n % w.shape[2] if cfg.layer_pattern[int(p[3:])]
                        else min(n, w.shape[2] - 1) for n in written})
        msg = testing.bf16_lm_mismatch(whole[:, :, slots], 0.0, {},
                                       w[:, :, slots], 0.0, {})
        assert msg is None, (name, msg)
        rest = [i for i in range(w.shape[2]) if i not in slots]
        assert torch.equal(whole[:, :, rest], cache0[p][k][:, :, rest]), name
    assert torch.equal(runs[0][0], runs[1][0])
    for name, st in runs[0][1].items():
        assert all(torch.equal(a, b) for a, b in zip(
            st.shards, runs[1][1][name].shards)), name


def _old_gather_backward(grad, ids, n_rows):
    """The row gather's backward before its lengths came from
    ``searchsorted``: ``unique_consecutive`` counts, read on the host."""
    out = grad.new_zeros((n_rows, grad.shape[-1]))
    flat = ids.reshape(-1)
    if flat.numel() == 0:
        return out
    order = torch.argsort(flat, stable=True)
    rows, counts = torch.unique_consecutive(flat[order], return_counts=True)
    out[rows] = torch.segment_reduce(grad.reshape(flat.numel(), -1)[order],
                                     "sum", lengths=counts)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_static_run_lengths_keep_the_cards_bits(cuda, dtype):
    """On the card, the gather's backward and ``segment_sum`` with their
    lengths from ``layers.run_lengths`` (no host read) give the bits of
    the ``unique_consecutive`` / ``bincount`` forms they replaced:
    repeated, absent and out-of-order rows, an empty shard, a table of a
    million rows."""
    from repro_torch.models import layers as L

    gen = torch.Generator(device=cuda).manual_seed(0)
    for n_ids, n_rows, width in ((200_000, 37, 64), (0, 9, 8),
                                 (50_000, 1_000_000, 16)):
        ids = torch.randint(0, n_rows, (n_ids,), generator=gen, device=cuda)
        grad = torch.randn((n_ids, width), generator=gen,
                           device=cuda).to(dtype)
        table = torch.zeros((n_rows, width), dtype=dtype, device=cuda,
                            requires_grad=True)
        (got,) = torch.autograd.grad(L.gather_rows(table, ids), table, grad)
        assert torch.equal(got, _old_gather_backward(grad, ids, n_rows))
        data = torch.randn((n_ids, width), generator=gen,
                           device=cuda).to(dtype)
        want = torch.segment_reduce(
            data[torch.argsort(ids, stable=True)], "sum",
            lengths=torch.bincount(ids, minlength=n_rows))
        assert torch.equal(L.segment_sum(data, ids, n_rows), want)
