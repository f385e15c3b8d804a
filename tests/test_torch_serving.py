"""The port's flat serving slice against the JAX package, on the CPU.

Data: the committed golden corpus ``tests/golden/serving_golden.npz``
(``corpus_euclid``/``queries_euclid``: N = 512, dim 32, 16 queries), k = 8,
10 neighbours, ``key=PRNGKey(7)`` as in ``tools/make_golden.py``.

Two ways in:
  * convert: the JAX package's fitted state (transform + flat index) goes
    into the port through ``repro_torch.convert``, so the search, re-rank,
    id mapping and churn paths see the same bytes. Tolerance rtol 1e-5 /
    atol 1e-5: only reduction order differs.
  * pivots: the port fits its own transform from the same reference rows
    (recovered by matching the JAX ``tr.refs`` rows in the corpus).
    Tolerance rtol 1e-4 / atol 1e-4: the Cholesky factor and triangular
    solve are recomputed in another library, which moves coordinates by
    ~1e-5 relative.
Ids must be equal except where a swap is a near-tie within the tolerance
(``repro_torch.testing.topk_mismatch``). ``chunk=128`` makes both packages
stream (the index is longer than one chunk).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")  # absent where only the port is installed

import jax.numpy as jnp  # noqa: E402

from repro.core import metrics as jmetrics  # noqa: E402
from repro.core import projection as jprojection  # noqa: E402
from repro.index import exact_rerank as jexact_rerank  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.index import exact_rerank as texact_rerank  # noqa: E402
from repro_torch.index import ivf as tivf  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.testing import topk_mismatch  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "serving_golden.npz")
K, NN, CHUNK = 8, 10, 128
SAME = dict(rtol=1e-5, atol=1e-5)
FIT = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _x32():
    """Other test modules flip ``jax_enable_x64`` on at import; the golden
    bits and the parity are defined at the default f32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


_JAX_INDEX = {}


def _jax_index(golden, storage):
    """The JAX package's flat index as the golden cases build it."""
    if storage not in _JAX_INDEX:
        prev = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", False)
        try:
            _JAX_INDEX[storage] = jserve.build_index(
                jnp.asarray(golden["corpus_euclid"]), K, storage=storage,
                key=jax.random.PRNGKey(7))
        finally:
            jax.config.update("jax_enable_x64", prev)
    return _JAX_INDEX[storage]


def _port_index(jidx):
    """The same fitted state in the port, through ``convert``."""
    tr = jidx.transform
    ptr = convert.transform_from_arrays(
        refs=np.asarray(tr.refs), chol=np.asarray(tr.base.chol),
        diag_g=np.asarray(tr.base.diag_g), d0=np.asarray(tr.base.d0),
        k=tr.k, metric=tr.metric, jitter=tr.jitter, device="cpu")
    return convert.index_from_arrays(
        ptr, coords=np.asarray(jidx.coords), storage=jidx.storage,
        coord_scales=(None if jidx.coord_scales is None
                      else np.asarray(jidx.coord_scales)),
        row_ids=None if jidx.row_ids is None else np.asarray(jidx.row_ids),
        n_valid=jidx.n_valid, n_deleted=jidx.n_deleted,
        corpus=np.asarray(jidx.corpus), generation=jidx.generation,
        device="cpu")


def _pivot_ids(golden, tr):
    """Row ids of a JAX transform's references, matched in the corpus."""
    corpus, refs = golden["corpus_euclid"], np.asarray(tr.refs)
    ids = [int(np.flatnonzero((corpus == r).all(1))[0]) for r in refs]
    assert len(set(ids)) == K
    return ids


def _golden_pivot_ids(golden):
    """The references the golden cases were built on. ``jax.random``'s
    stream depends on ``jax_threefry_partitionable``, whose default flipped
    after the golden file was written, so they are redrawn under the
    setting of that time, whatever the ambient one."""
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        tr = jprojection.select_references(
            jnp.asarray(golden["corpus_euclid"]), K, jax.random.PRNGKey(7))
    finally:
        jax.config.update("jax_threefry_partitionable", prev)
    return _pivot_ids(golden, tr)


def _check(got, want, tol):
    msg = topk_mismatch(got[0], got[1], np.asarray(want[0]),
                        np.asarray(want[1]), **tol)
    assert msg is None, msg


@pytest.mark.parametrize("rerank", [0, 4])
@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("mode", ["zen", "lwb", "upb"])
def test_server_matches_jax(golden, mode, storage, rerank):
    jidx = _jax_index(golden, storage)
    q = golden["queries_euclid"]
    want = jserve.ZenServer(jidx, mode=mode, rerank_factor=rerank,
                            chunk=CHUNK).query(jnp.asarray(q), NN)
    server = tserve.ZenServer(_port_index(jidx), mode=mode,
                              rerank_factor=rerank, chunk=CHUNK)
    got = server.query(torch.from_numpy(q), NN)
    assert got[0].shape == (16, NN) and got[1].dtype == torch.int32
    _check(got, want, SAME)
    assert server.stats()["queries"] == 16


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_fit_from_recovered_pivots_matches_jax(golden, storage):
    jidx = _jax_index(golden, storage)
    index = tserve.build_index(torch.from_numpy(golden["corpus_euclid"]), K,
                               storage=storage,
                               pivot_ids=_pivot_ids(golden, jidx.transform),
                               device="cpu")
    want_c = np.asarray(jidx.coords.astype(jnp.float32))
    got_c = index.coords.to(torch.float32).numpy()
    if storage == "float32":
        np.testing.assert_allclose(got_c[:, :-1], want_c[:, :-1], **FIT)
        np.testing.assert_allclose(got_c[:, -1] ** 2, want_c[:, -1] ** 2,
                                   **FIT)
    else:  # codes may sit one rounding step apart
        assert np.mean(got_c == want_c) > 0.99
    q = golden["queries_euclid"]
    for rerank in (0, 4):
        want = jserve.ZenServer(jidx, rerank_factor=rerank,
                                chunk=CHUNK).query(jnp.asarray(q), NN)
        got = tserve.ZenServer(index, rerank_factor=rerank,
                               chunk=CHUNK).query(torch.from_numpy(q), NN)
        # estimator distances over quantised rows inherit a code that may
        # sit one step apart (bf16 2^-8, int8 1/127 of the row's absmax);
        # the exact re-rank does not
        step = storage != "float32" and not rerank
        _check(got, want, dict(rtol=1e-2, atol=1e-2) if step else FIT)


@pytest.mark.parametrize("name,cfg", [
    ("flat_zen", {}), ("flat_lwb", {"mode": "lwb"}),
    ("flat_int8", {"storage": "int8"}), ("flat_rerank", {"rerank": 4})])
def test_matches_golden_arrays(golden, name, cfg):
    """The stored golden outputs (which the reference still reproduces)."""
    storage = cfg.get("storage", "float32")
    index = tserve.build_index(
        torch.from_numpy(golden["corpus_euclid"]), K, storage=storage,
        pivot_ids=_golden_pivot_ids(golden), device="cpu")
    server = tserve.ZenServer(index, mode=cfg.get("mode", "zen"),
                              rerank_factor=cfg.get("rerank", 0))
    got = server.query(torch.from_numpy(golden["queries_euclid"]), NN)
    _check(got, (golden[f"{name}_d"], golden[f"{name}_ids"]), FIT)


def _state(index):
    """Comparable host view of a flat index (either package)."""
    coords = np.asarray(index.coords.astype(jnp.float32)) \
        if hasattr(index.coords, "astype") and not isinstance(
            index.coords, torch.Tensor) \
        else index.coords.to(torch.float32).numpy()
    row_ids = index.row_ids
    row_ids = None if row_ids is None else np.asarray(
        row_ids.numpy() if isinstance(row_ids, torch.Tensor) else row_ids)
    return coords, row_ids, index.size, index.n_deleted, index.generation


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_churn_sequence_matches_jax(golden, storage):
    """delete -> upsert (replace + insert, duplicate ids) -> compact, with a
    query after each step; deleted ids never come back."""
    jidx = _jax_index(golden, storage)
    corpus, q = golden["corpus_euclid"], golden["queries_euclid"]
    js = jserve.ZenServer(jidx, rerank_factor=4, chunk=CHUNK)
    ts = tserve.ZenServer(_port_index(jidx), rerank_factor=4, chunk=CHUNK)
    n = corpus.shape[0]
    fresh = np.random.default_rng(5).standard_normal(
        (5, corpus.shape[1])).astype(np.float32)
    dead = [int(i) for i in np.asarray(js.query(jnp.asarray(q), NN)[1])[:, 0]]
    steps = [
        ("delete", dead + [10 ** 6]),
        ("upsert", ([n + 1, n + 2, 7, n + 2, 3], fresh)),
        ("compact", None),
    ]
    for op, arg in steps:
        for srv, lib in ((js, jnp), (ts, torch)):
            if op == "delete":
                srv.delete(arg)
            elif op == "upsert":
                vecs = (jnp.asarray(arg[1]) if lib is jnp
                        else torch.from_numpy(arg[1]))
                srv.upsert(arg[0], vecs)
            else:
                srv.compact()
        jc, jr, jn, jd, jg = _state(js.index)
        tc, tr_, tn, td, tg = _state(ts.index)
        assert (tn, td, tg) == (jn, jd, jg)
        np.testing.assert_array_equal(tr_, jr)
        assert tc.shape == jc.shape
        # rows are the same bytes but for the upserted ones, which each
        # package projects itself (one storage rounding step apart at most)
        np.testing.assert_allclose(tc, jc, rtol=1e-2, atol=1e-2)
        got = ts.query(torch.from_numpy(q), NN)
        _check(got, js.query(jnp.asarray(q), NN), SAME)
        returned = set(got[1].numpy().ravel().tolist())
        assert not returned & (set(dead) - {3, 7}), (op, returned)
    assert ts.stats()["deletes"] == js.stats()["deletes"] == len(set(dead))
    assert ts.index.n_deleted == 0 and not ts.maybe_compact()


def test_upsert_grows_capacity_and_reuses_dead_slots():
    gen = torch.Generator().manual_seed(0)
    corpus = torch.randn((300, 12), generator=gen)
    server = tserve.ZenServer(tserve.build_index(
        corpus, 6, pivot_ids=[0, 50, 100, 150, 200, 250], device="cpu"),
        rerank_factor=2)
    server.delete([1, 2, 3])
    assert server.index.needs_compact(0.005)
    server.upsert([400, 401], corpus[1:3] + 0.01)  # refills two dead slots
    assert server.index.coords.shape[0] == 300
    server.upsert(list(range(500, 504)), corpus[10:14])  # 1 slot + growth
    assert server.index.coords.shape[0] == 300 + tserve._GROW_ROWS
    assert server.index.size == 300 - 3 + 2 + 4
    d, ids = server.query(corpus, 3)
    assert torch.isfinite(d).all()
    assert not set(ids.ravel().tolist()) & {1, 2, 3}
    assert torch.equal(server.index.corpus[503], corpus[13])
    assert server.index.corpus.shape[0] == 504


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "jsd"])
def test_exact_rerank_matches_jax(metric):
    rng = np.random.default_rng(2)
    corpus = np.abs(rng.standard_normal((50, 9))).astype(np.float32)
    q = np.abs(rng.standard_normal((4, 9))).astype(np.float32)
    cand = np.stack([rng.permutation(50)[:12] for _ in range(4)])
    cand = cand.astype(np.int32)
    cand[:, 5] = -1
    want = jexact_rerank(jnp.asarray(q), jnp.asarray(corpus),
                         jnp.asarray(cand), 6, metric=metric)
    got = texact_rerank(torch.from_numpy(q), torch.from_numpy(corpus),
                        torch.from_numpy(cand), 6, metric=metric)
    _check(got, want, SAME)
    assert not (got[1] == -1).any()


def test_unported_options_raise_naming_the_roadmap_item():
    """Mesh sharding (ROADMAP A4), the frontend (A2) and fault tolerance
    (A3), which once raised here, now serve: flat and IVF indexes built on
    a CPU mesh of 2 logical shards answer as the unsharded ones from the
    same generator; PQ storage on a mesh raises the reference's
    ``NotImplementedError``, as the JAX package does."""
    from repro_torch.distributed import make_mesh

    x = torch.randn((40, 6), generator=torch.Generator().manual_seed(1))
    mesh = make_mesh(2, device="cpu")
    for kw in [{}, {"index": "ivf", "n_clusters": 4}]:
        built = [tserve.build_index(
            x, 4, generator=torch.Generator().manual_seed(2), **kw, **where)
            for where in ({"device": "cpu"}, {"mesh": mesh})]
        assert built[1].mesh is mesh and built[1].size == 40
        want, got = (tserve.ZenServer(b, nprobe=4).query(x[:3], 5)
                     for b in built)
        assert torch.equal(got[1], want[1])
        np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), **SAME)
    with pytest.raises(NotImplementedError, match="single-host"):
        tserve.build_index(x, 4, index="ivf", storage="pq", mesh=mesh)
    with pytest.raises(NotImplementedError, match="single-host"):
        tivf.ShardedIVFZenIndex.build(x, 4, mesh=mesh, storage="pq")
    index = tserve.build_index(x, 4, device="cpu")
    q = x[:3]
    frontend = tserve.ZenServer(index, frontend=True)
    direct = tserve.ZenServer(index).query(q, 5)
    got = frontend.query(q, 5)
    assert torch.equal(got[0], direct[0]) and torch.equal(got[1], direct[1])
    assert frontend.stats()["frontend"]["completed"] == 3
    server = tserve.ZenServer(index)
    reg = server.enable_fault_tolerance()
    assert reg.expected() == ["shard0"]
    server.heartbeat(0)
    assert server.stats()["degraded_shards"] == []


def test_entry_points_run_on_the_card_unless_told_otherwise():
    x = torch.randn((40, 6), generator=torch.Generator().manual_seed(2))
    if torch.cuda.is_available():
        assert tserve.build_index(x, 4).coords.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.build_index(x, 4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.main(["--n", "100"])


def test_cli_cpu_rehearsal(capsys):
    tserve.main(["--device", "cpu", "--n", "3000", "--dim", "64", "--k",
                 "12", "--queries", "8", "--batches", "2"])
    out = capsys.readouterr().out
    rec = float(out.split("recall@10: ")[1].split()[0])
    assert rec > 0.8, out
    assert "'batches': 2" in out


def test_recall_helper_matches_brute_force(golden):
    corpus = golden["corpus_euclid"]
    q = golden["queries_euclid"]
    true_ids = tserve.exact_topk(torch.from_numpy(q),
                                 torch.from_numpy(corpus), NN)
    want = np.argsort(np.asarray(jmetrics.euclidean_pdist(
        jnp.asarray(q), jnp.asarray(corpus))), 1, kind="stable")[:, :NN]
    np.testing.assert_array_equal(true_ids.numpy(), want)
    assert tserve.recall(true_ids, true_ids) == 1.0
