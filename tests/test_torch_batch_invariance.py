"""The port's answers do not depend on the batch a query rides in.

A served row must have the same bits whether it is served alone (Q bucket
2), inside a batch of any size up to ``max_batch``, or past it, as the JAX
package's rows do: the serving frontend coalesces 1-row callers and its
cache hands out answers computed in other batches, so anything else shows
as wrong answers. Every case serves the same 64 rows (numpy, seeded) as
one batch, in batches of 1 to 17 rows, as 100 rows (past ``max_batch``:
two dispatches of 64) and one at a time, and asks for equal bits: no
tolerance.

Grid: flat (f32, bf16, int8) and IVF (f32, bf16, int8, PQ) and tiered
storage at re-rank 0 and 4 under the Euclidean metric, and the five
metrics on the flat and IVF f32 indexes at re-rank 0 and 4; all three
estimator modes on the flat index. ``chunk`` is below the corpus size, so
the flat index streams through ``kernels.ops.zen_topk`` (on the CPU its
plain version), as it does on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.core import projection as tprojection  # noqa: E402
from repro_torch.core import zen as tzen  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

N, DIM, K, NN = 700, 256, 16, 10
CHUNK, N_CLUSTERS, NPROBE = 256, 16, 4
#: batch sizes the 64 rows are cut into (1 to 17, then the rest)
SIZES = (1, 2, 3, 4, 5, 6, 7, 8, 9, 17)


def _data(metric, seed, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, DIM)).astype(np.float32)
    if metric in ("jsd", "triangular"):
        x = np.abs(x)
        x[rng.uniform(size=x.shape) < 0.2] = 0.0
        x[:, 0] += 1e-3
    return torch.from_numpy(x)


_INDEX = {}


def _index(kind, storage, metric):
    key = (kind, storage, metric)
    if key not in _INDEX:
        kw = {}
        if kind != "flat":
            kw = dict(index="ivf", n_clusters=N_CLUSTERS,
                      offload=kind == "tiered", hot_clusters=4)
        _INDEX[key] = tserve.build_index(
            _data(metric, 0, N), K, metric=metric, storage=storage,
            pivot_ids=list(range(0, N, N // K))[:K],
            generator=torch.Generator().manual_seed(0), device="cpu", **kw)
    return _INDEX[key]


def _bits(t):
    return t.contiguous().view(torch.int32).numpy() \
        if t.dtype == torch.float32 else t.numpy()


def _check_rows(server, queries):
    whole = server.query(queries, NN)
    wd, wi = _bits(whole[0]), _bits(whole[1])
    # one at a time (each row alone is Q bucket 2)
    for i in range(queries.shape[0]):
        d, ids = server.query(queries[i:i + 1], NN)
        assert np.array_equal(_bits(d)[0], wd[i]), f"row {i} alone: d"
        assert np.array_equal(_bits(ids)[0], wi[i]), f"row {i} alone: ids"
    # batches of 1 to 17 rows
    lo = 0
    for size in SIZES:
        d, ids = server.query(queries[lo:lo + size], NN)
        assert np.array_equal(_bits(d), wd[lo:lo + size]), f"Q={size}: d"
        assert np.array_equal(_bits(ids), wi[lo:lo + size]), f"Q={size}"
        lo += size
    # past max_batch: 100 rows go out as two dispatches of 64
    big = torch.cat([queries, queries[:36].flip(0)])
    d, ids = server.query(big, NN)
    assert np.array_equal(_bits(d)[:64], wd)
    assert np.array_equal(_bits(ids)[:64], wi)
    assert np.array_equal(_bits(d)[64:], wd[:36][::-1])


@pytest.mark.parametrize("rerank", [0, 4])
@pytest.mark.parametrize("kind,storage", [
    ("flat", "float32"), ("flat", "bfloat16"), ("flat", "int8"),
    ("ivf", "float32"), ("ivf", "bfloat16"), ("ivf", "int8"),
    ("ivf", "pq"), ("tiered", "float32")])
def test_rows_alone_equal_rows_in_a_batch(kind, storage, rerank):
    server = tserve.ZenServer(_index(kind, storage, "euclidean"),
                              rerank_factor=rerank, chunk=CHUNK,
                              nprobe=NPROBE)
    _check_rows(server, _data("euclidean", 1, 64))


@pytest.mark.parametrize("rerank", [0, 4])
@pytest.mark.parametrize("kind", ["flat", "ivf"])
@pytest.mark.parametrize("metric", ["euclidean", "cosine", "jsd",
                                    "triangular", "qform"])
def test_every_metric_is_batch_invariant(metric, kind, rerank):
    server = tserve.ZenServer(_index(kind, "float32", metric),
                              rerank_factor=rerank, chunk=CHUNK,
                              nprobe=NPROBE)
    _check_rows(server, _data(metric, 1, 64))


@pytest.mark.parametrize("mode", ["lwb", "upb"])
def test_every_estimator_mode_is_batch_invariant(mode):
    server = tserve.ZenServer(_index("flat", "float32", "euclidean"),
                              mode=mode, chunk=CHUNK)
    _check_rows(server, _data("euclidean", 1, 64))


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "jsd",
                                    "triangular", "qform"])
def test_projection_rows_do_not_depend_on_the_batch(metric):
    tr = tprojection.select_references(_data(metric, 0, 200), K,
                                       ids=list(range(K)), metric=metric)
    q = _data(metric, 2, 64)
    whole = tr.transform(q)
    for i in (0, 1, 37, 63):
        assert torch.equal(tr.transform(q[i:i + 1])[0], whole[i])
        assert torch.equal(tr.transform(q[i:i + 2])[0], whole[i])
    # and the row-invariant pairwise form agrees with the matmul form
    m = tmetrics.get_metric(metric)
    x, y = _data(metric, 3, 9), _data(metric, 4, 7)
    if m.normalize is not None:
        x, y = m.normalize(x), m.normalize(y)
    torch.testing.assert_close(m.rows(x, y), m.pdist(x, y), rtol=1e-5,
                               atol=1e-5)


def test_row_chunks_and_fixed_sum():
    x = _data("euclidean", 5, 40)
    torch.testing.assert_close(tmetrics.fixed_sum(x), x.sum(-1),
                               rtol=1e-6, atol=1e-5)
    assert tmetrics.fixed_sum(x[:, :0]).shape == (40,)
    # a product block larger than ROW_BLOCK_ELEMS goes out in row chunks
    # with the same bits as one block
    prev = tmetrics.ROW_BLOCK_ELEMS
    whole = tmetrics.row_dot(x, x[:5])
    try:
        tmetrics.ROW_BLOCK_ELEMS = 3 * 5 * DIM
        assert torch.equal(tmetrics.row_dot(x, x[:5]), whole)
    finally:
        tmetrics.ROW_BLOCK_ELEMS = prev
    coords = _data("euclidean", 6, 41)[:, :K].abs()
    for mode in ("zen", "lwb", "upb"):  # in squared space (no sqrt blow-up)
        est = tzen.estimate_pdist_rows(coords[:30], coords[30:], mode)
        torch.testing.assert_close(est ** 2, tzen.estimate_pdist(
            coords[:30], coords[30:], mode) ** 2, rtol=1e-5, atol=1e-4)
