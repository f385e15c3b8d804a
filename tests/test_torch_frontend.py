"""The port's micro-batching serving frontend (``repro_torch.serving``),
driven step by step on the CPU: the cases of ``tests/test_frontend.py`` on
the port, and the port against the JAX package.

The scheduler never sleeps on its own: ``tick()`` is synchronous and the
clock is injected, so every case submits, advances a fake clock, ticks and
observes, with no real threads (except the ticker-thread cases). The
contract: every scheduled, coalesced, padded or cached answer is
**bit-identical** to the same query served directly, for every estimator
mode, flat and IVF, with and without re-rank, across interleavings of
queries and churn.

Against the JAX package: a JAX frontend server is saved and loaded into
the port (the snapshots are one format), the same rows are submitted to
both on the same fake-clock schedule, and the answers agree within the
parity bar (rtol / atol 1e-5, ids equal outside near-ties,
``repro_torch.testing.topk_mismatch``), the frontend's counters exactly.
Data: numpy, seeded (a low-rank manifold plus noise).
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional dep: fixed-seed replay keeps the suite green
    from _hypothesis_fallback import given, settings, st

from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    FrontendOverloadError,
    FrontendStats,
    LRUCache,
    bucket_neighbors,
    bucket_q,
    query_fingerprint,
)
from repro_torch.testing import topk_mismatch  # noqa: E402

N, DIM, K = 600, 48, 10
N_CLUSTERS = 24
SAME = dict(rtol=1e-5, atol=1e-5)


class FakeClock:
    """Deterministic injectable time source."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _manifold(seed, n, dim, intrinsic):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, intrinsic))
    w = rng.standard_normal((intrinsic, dim)) / np.sqrt(intrinsic)
    x = np.tanh(z @ w) + 0.01 * rng.standard_normal((n, dim))
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    return _manifold(0, N, DIM, 8)


@pytest.fixture(scope="module")
def queries():
    return _manifold(1, 32, DIM, 8)


@pytest.fixture(scope="module")
def base_index(corpus):
    x = torch.from_numpy(corpus)
    kw = dict(generator=torch.Generator().manual_seed(0), device="cpu")
    return {
        "flat": tserve.build_index(x, K, index="flat", **kw),
        "ivf": tserve.build_index(x, K, index="ivf", n_clusters=N_CLUSTERS,
                                  **kw),
    }


def _frontend_server(index, **kw):
    kw.setdefault("nprobe", 8)
    kw.setdefault("frontend", True)
    kw.setdefault("clock", kw.pop("clock", None) or FakeClock())
    return tserve.ZenServer(index, **kw)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rows_equal(a, b):
    return (np.array_equal(_np(a[0]), _np(b[0]))
            and np.array_equal(_np(a[1]), _np(b[1])))


def _direct(server, row, nn=10):
    return server.query(torch.from_numpy(np.asarray(row)[None]), nn,
                        direct=True)


# -- bucket helpers -----------------------------------------------------------


def test_bucket_q_power_of_two_floor_two():
    assert [bucket_q(q) for q in (1, 2, 3, 4, 5, 8, 9, 100)] == \
        [2, 2, 4, 4, 8, 8, 16, 128]
    assert bucket_q(100, max_batch=32) == 32


def test_bucket_neighbors_menu_then_pow2():
    assert [bucket_neighbors(n) for n in (1, 8, 9, 16, 100, 128)] == \
        [8, 8, 16, 16, 128, 128]
    assert bucket_neighbors(129) == 256  # off-menu stays bounded
    assert bucket_neighbors(5, menu=(4, 32)) == 32


# -- coalescing / splitting ---------------------------------------------------


def test_coalescing_k_submitters_one_dispatch(base_index, queries):
    """K concurrent single-row submitters collapse into one dispatch."""
    server = _frontend_server(base_index["flat"])
    sched = server.frontend
    handles = [sched.submit(queries[i], 10) for i in range(5)]
    assert sched.backlog == 5
    assert not any(h.done() for h in handles)
    assert sched.tick() == 1                      # one coalesced dispatch
    assert sched.backlog == 0
    st_ = sched.stats
    assert st_.dispatches == 1
    assert st_.dispatched_rows == 5 and st_.padded_rows == 8  # bucket 8
    assert st_.occupancy == pytest.approx(5 / 8)
    for i, h in enumerate(handles):
        assert h.done()
        assert _rows_equal(h.result(), _direct(server, queries[i]))


def test_split_at_max_batch(base_index, queries):
    """Oversized coalesced groups split into max_batch-row dispatches."""
    server = _frontend_server(base_index["flat"], max_batch=4)
    sched = server.frontend
    handles = [sched.submit(queries[i], 10) for i in range(11)]
    assert sched.tick() == 3                      # ceil(11 / 4)
    assert sched.stats.dispatches == 3
    assert max(s[0] for s in sched.stats.dispatch_shapes) <= 4
    for i, h in enumerate(handles):
        assert _rows_equal(h.result(), _direct(server, queries[i]))


def test_mixed_n_neighbors_group_by_geometry(base_index, queries):
    """Requests with different bucketed widths dispatch separately."""
    server = _frontend_server(base_index["flat"])
    sched = server.frontend
    h10 = sched.submit(queries[0], 10)   # n_bucket 16
    h9 = sched.submit(queries[1], 9)     # n_bucket 16: same group
    h40 = sched.submit(queries[2], 40)   # n_bucket 64: another group
    assert sched.tick() == 2
    assert _rows_equal(h10.result(), _direct(server, queries[0], 10))
    assert _rows_equal(h9.result(), _direct(server, queries[1], 9))
    assert _rows_equal(h40.result(), _direct(server, queries[2], 40))


@pytest.mark.parametrize("kind", ["flat", "ivf"])
@pytest.mark.parametrize("mode", ["zen", "lwb", "upb"])
def test_bucket_padding_parity(base_index, queries, kind, mode):
    """Padded coalesced dispatches are bit-identical to per-query direct
    calls: every estimator mode, flat and IVF."""
    server = _frontend_server(base_index[kind], mode=mode)
    sched = server.frontend
    handles = [sched.submit(queries[i], 10) for i in range(7)]  # pads to 8
    sched.tick()
    for i, h in enumerate(handles):
        assert _rows_equal(h.result(), _direct(server, queries[i])), \
            (kind, mode, i)


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_bucket_padding_parity_with_rerank(base_index, queries, kind):
    """Parity survives the exact re-rank stage (wider bucketed pools)."""
    server = _frontend_server(base_index[kind], rerank_factor=4)
    handles = [server.frontend.submit(queries[i], 10) for i in range(5)]
    server.frontend.tick()
    for i, h in enumerate(handles):
        assert _rows_equal(h.result(), _direct(server, queries[i]))


def test_query_through_frontend_matches_direct(base_index, queries):
    """ZenServer.query as a thin scheduler client (inline ticking)."""
    server = _frontend_server(base_index["flat"])
    q = torch.from_numpy(queries[:6])
    got = server.query(q, 10)
    want = server.query(q, 10, direct=True)
    assert _rows_equal(got, want)
    assert isinstance(got[0], torch.Tensor) and got[1].dtype == torch.int32
    assert server.frontend.stats.completed >= 6


def test_direct_escape_hatch_bypasses_scheduler(base_index, queries):
    server = _frontend_server(base_index["flat"])
    before = server.frontend.stats.submitted
    server.query(torch.from_numpy(queries[:3]), 10, direct=True)
    assert server.frontend.stats.submitted == before
    assert server.frontend.backlog == 0


def test_batch_past_queue_limit_takes_the_direct_path(base_index, queries):
    server = _frontend_server(base_index["flat"], queue_limit=4)
    got = server.query(torch.from_numpy(queries[:9]), 10)
    assert server.frontend.stats.submitted == 0
    assert _rows_equal(got, server.query(torch.from_numpy(queries[:9]), 10,
                                         direct=True))


# -- backpressure -------------------------------------------------------------


def test_reject_on_full_backpressure(base_index, queries):
    server = _frontend_server(base_index["flat"], queue_limit=4)
    sched = server.frontend
    for i in range(4):
        sched.submit(queries[i], 10)
    with pytest.raises(FrontendOverloadError):
        sched.submit(queries[4], 10)
    assert sched.stats.rejected == 1
    assert sched.backlog == 4                 # the reject enqueued nothing
    # a multi-row submit that cannot fully fit is rejected atomically
    sched.tick()
    sched.submit(queries[:3], 10)
    with pytest.raises(FrontendOverloadError):
        sched.submit(queries[3:6], 10)        # 3 rows, 1 slot free
    assert sched.backlog == 3
    with pytest.raises(FrontendOverloadError, match="queue_limit"):
        sched.submit(queries[:5], 10)         # can never fit: says so
    sched.flush()
    assert sched.backlog == 0


# -- cache --------------------------------------------------------------------


def test_lru_cache_eviction_order():
    c = LRUCache(2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1        # refreshes "a": "b" is now the LRU
    c.put("c", 3)                 # evicts "b"
    assert c.get("b") is None and c.get("a") == 1 and c.get("c") == 3
    assert c.evictions == 1
    assert len(c) == 2
    assert c.info()["hit_rate"] == pytest.approx(3 / 4)
    c.clear()
    assert len(c) == 0 and c.hits == 0


def test_lru_cache_disabled_at_zero_capacity():
    c = LRUCache(0)
    c.put("a", 1)
    assert c.get("a") is None and len(c) == 0


def test_query_fingerprint_canonicalises():
    row64 = np.arange(4, dtype=np.float64)
    assert query_fingerprint(row64) == query_fingerprint(
        row64.astype(np.float32))
    assert query_fingerprint(row64) != query_fingerprint(row64 + 1e-6)
    # a tensor row hits the entry of the same f32 values
    assert query_fingerprint(torch.arange(4.0).numpy()) == \
        query_fingerprint(row64)


def test_cache_hit_resolves_without_tick(base_index, queries):
    server = _frontend_server(base_index["flat"], cache_size=64)
    sched = server.frontend
    h1 = sched.submit(queries[0], 10)
    sched.tick()
    h2 = sched.submit(torch.from_numpy(queries[0]), 10)  # a tensor row
    assert h2.done()                          # no tick needed
    assert sched.stats.cache_hits == 1
    assert _rows_equal(h1.result(), h2.result())
    # a different n_neighbors in the same bucket also hits, sliced
    h3 = sched.submit(queries[0], 9)
    assert h3.done() and sched.stats.cache_hits == 2
    d9, i9 = h3.result()
    d10, i10 = h1.result()
    assert np.array_equal(i9[0], i10[0, :9])
    assert np.array_equal(d9[0], d10[0, :9])


def test_cache_miss_on_new_query(base_index, queries):
    server = _frontend_server(base_index["flat"], cache_size=64)
    sched = server.frontend
    sched.submit(queries[0], 10)
    sched.tick()
    h = sched.submit(queries[1], 10)
    assert not h.done()                       # a new row: a miss
    assert sched.stats.cache_misses == 2
    sched.flush()


@pytest.mark.parametrize("churn", ["upsert", "delete", "compact"])
def test_cache_invalidation_on_churn(base_index, queries, corpus, churn):
    """upsert/delete/compact bump the index generation; stale entries can
    no longer be looked up, and the re-served answer is a fresh direct
    query of the churned index."""
    server = _frontend_server(base_index["flat"], cache_size=64)
    sched = server.frontend
    sched.submit(queries[0], 10)
    sched.tick()
    assert sched.stats.cache_misses == 1
    gen0 = server.index.generation
    if churn == "upsert":
        server.upsert([N + 1], torch.from_numpy(corpus[:1] * 0.5))
    elif churn == "delete":
        server.delete([int(sched.submit(queries[0], 10).result()[1][0, 0])])
    else:
        server.delete([3])                    # make compact non-trivial
        server.compact()
    assert server.index.generation > gen0
    h = sched.submit(queries[0], 10)
    assert not h.done()                       # old-generation entry ignored
    sched.tick()
    assert _rows_equal(h.result(), _direct(server, queries[0]))


def test_generation_counter_no_bump_on_noop(base_index):
    idx = base_index["flat"]
    assert idx.generation == 0
    assert idx.delete([10 ** 6]).generation == 0        # unknown id: no-op
    assert idx.upsert([], torch.zeros((0, K))).generation == 0
    assert idx.compact().generation == 0                # untouched index
    ivf = base_index["ivf"]
    assert ivf.compact() is ivf


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_generation_counter_bumps(base_index, kind):
    idx = base_index[kind]
    rows = torch.ones((1, K))
    up = idx.upsert([N + 7], rows)
    assert up.generation == idx.generation + 1
    de = up.delete([N + 7])
    assert de.generation > up.generation
    co = de.compact()
    assert co.generation > de.generation
    if kind == "ivf":  # the counter is threaded through IVFZenIndex too
        assert up.ivf.generation == idx.ivf.generation + 1
        assert co.ivf.generation > de.ivf.generation


def test_empty_index_through_frontend(base_index, queries):
    server = _frontend_server(base_index["flat"])
    server.delete(np.arange(N))
    assert server.index.size == 0
    d, ids = server.query(torch.from_numpy(queries[:3]), 10)
    assert d.shape == (3, 10) and bool(torch.isinf(d).all())
    assert bool((ids == -1).all())


def test_cache_stores_row_copies_not_views(base_index, queries):
    """Entries are per-row host copies: a view would pin the whole (Qp,
    n_bucket) dispatch arrays for as long as one row survives."""
    server = _frontend_server(base_index["flat"], cache_size=8)
    sched = server.frontend
    sched.submit(queries[0], 10)
    sched.tick()
    ((d_row, id_row),) = list(sched.cache._data.values())
    assert isinstance(d_row, np.ndarray) and isinstance(id_row, np.ndarray)
    assert d_row.base is None and id_row.base is None
    assert d_row.shape == (16,)               # stored at the bucketed width


# -- dispatch failures --------------------------------------------------------


def test_dispatch_failure_resolves_waiters_and_ticker_survives(
        base_index, queries):
    """A raising dispatch fails its waiters (result() re-raises) instead
    of hanging them, and the scheduler keeps serving afterwards."""
    server = _frontend_server(base_index["flat"])
    sched = server.frontend
    good = sched.submit(queries[0], 10)
    bad = sched.submit(np.ones(7, np.float32), 10)  # wrong query dim
    sched.tick()                                    # ragged group: raises
    assert good.done() and bad.done()               # resolved, not hung
    with pytest.raises(Exception):
        bad.result(timeout=1)
    with pytest.raises(Exception):                  # same failed chunk
        good.result(timeout=1)
    assert sched.stats.failures == 2
    h = sched.submit(queries[1], 10)                # still alive
    sched.tick()
    assert _rows_equal(h.result(), _direct(server, queries[1]))


def test_tick_dispatch_count_excludes_failed_dispatches(base_index, queries):
    """tick() counts the dispatches issued; a raising one issued nothing."""
    server = _frontend_server(base_index["flat"])
    sched = server.frontend
    sched.submit(np.ones(7, np.float32), 10)  # wrong query dim: raises
    assert sched.tick() == 0
    assert sched.stats.failures == 1
    sched.submit(queries[0], 10)
    assert sched.tick() == 1


def test_unresolved_handle_times_out(base_index, queries):
    server = _frontend_server(base_index["flat"])
    h = server.frontend.submit(queries[0], 10)
    with pytest.raises(TimeoutError, match="ticking"):
        h.result(timeout=0.01)
    server.frontend.flush()
    assert h.done()


# -- clock / latency instrumentation ------------------------------------------


def test_fake_clock_drives_latency_stats(base_index, queries):
    clock = FakeClock()
    server = _frontend_server(base_index["flat"], clock=clock)
    sched = server.frontend
    h = sched.submit(queries[0], 10)
    clock.advance(0.25)                       # the request waits 0.25 s
    sched.tick()
    assert h.latency_s == pytest.approx(0.25)
    pct = sched.stats.latency_percentiles()
    assert pct["p50_ms"] == pytest.approx(250.0)
    assert pct["p99_ms"] == pytest.approx(250.0)
    h2 = sched.submit(queries[1], 10)
    clock.advance(0.05)
    sched.tick()
    assert h2.latency_s == pytest.approx(0.05)


def test_stats_snapshot_keys(base_index, queries):
    server = _frontend_server(base_index["flat"], cache_size=8)
    server.query(torch.from_numpy(queries[:4]), 10)
    out = server.stats()
    fe = out["frontend"]
    for key in ("submitted", "completed", "rejected", "dispatches",
                "batch_occupancy", "cache_hit_rate", "compile_count",
                "p50_ms", "p95_ms", "p99_ms"):
        assert key in fe, key
    assert out["cache"]["capacity"] == 8
    assert fe["submitted"] == 4 and fe["completed"] == 4
    assert out["queries"] == 4 and out["batches"] == 1


def test_latency_percentiles_empty_window_is_nan_not_crash():
    """No sample yet: the percentiles are NaN and snapshot() omits them
    rather than reporting a fabricated 0 ms."""
    stats = FrontendStats()
    pct = stats.latency_percentiles()
    assert set(pct) == {"p50_ms", "p95_ms", "p99_ms"}
    assert all(np.isnan(v) for v in pct.values())
    snap = stats.snapshot()
    assert not any(k in snap for k in ("p50_ms", "p95_ms", "p99_ms"))
    stats.record_complete(1, 0.1)
    assert stats.snapshot()["p50_ms"] == pytest.approx(100.0)
    stats.record_swap(3)
    assert stats.snapshot()["swaps"] == 1
    assert stats.snapshot()["serving_generation"] == 3


# -- dispatch shapes stay bounded ----------------------------------------------


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_dispatch_shapes_bounded_over_odd_shapes(base_index, queries, kind):
    """20 odd-shaped (Q, n_neighbors) batches dispatch at a handful of
    bucketed shapes (the launch plans a query path can ask for)."""
    server = tserve.ZenServer(base_index[kind], nprobe=8)
    shapes = []
    orig = server._query_block

    def spy(q, width, n_bucket, index=None):
        shapes.append((q.shape[0], width, n_bucket))
        return orig(q, width, n_bucket, index)

    server._query_block = spy
    for i in range(20):
        server.query(torch.from_numpy(queries[:1 + i]), 3 + (i % 9))
    assert len(shapes) == 20
    assert len(set(shapes)) <= 10             # 5 Q buckets x 2 widths
    assert {s[0] for s in shapes} <= {2, 4, 8, 16, 32}


def test_max_batch_sets_the_direct_paths_padding(base_index, queries):
    server = tserve.ZenServer(base_index["flat"], max_batch=8)
    shapes = []
    orig = server._query_block
    server._query_block = lambda q, w, n, index=None: (
        shapes.append(q.shape[0]) or orig(q, w, n, index))
    server.query(torch.from_numpy(queries[:20]), 10)
    server.query(torch.from_numpy(queries[:5]), 10)
    assert shapes == [24, 8]                  # a multiple of 8, then 8


# -- ticker thread ------------------------------------------------------------


def test_ticker_thread_serves_concurrent_callers(base_index, queries):
    """Real threads + the background ticker: concurrent queries coalesce
    and every caller gets its direct-path bits."""
    server = tserve.ZenServer(base_index["flat"], frontend=True,
                              tick_interval=0.001)
    server.frontend.start()
    try:
        results = {}

        def caller(i):
            results[i] = server.query(torch.from_numpy(queries[i][None]),
                                      10)

        threads = [threading.Thread(target=caller, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert len(results) == 8
        for i in range(8):
            assert _rows_equal(results[i], _direct(server, queries[i]))
    finally:
        server.frontend.stop()
    assert not server.frontend.running


def test_ticker_and_direct_callers_share_a_tiered_index(corpus, queries):
    """The ticker thread and direct callers search one tiered index at
    once (its staging slots and hot-set state are shared): every answer
    equals the same query served alone, before the threads started."""
    index = tserve.build_index(
        torch.from_numpy(corpus), K, index="ivf", n_clusters=N_CLUSTERS,
        offload=True, hot_clusters=0, offload_shards=2, prefetch_cols=1,
        device="cpu", generator=torch.Generator().manual_seed(0))
    server = tserve.ZenServer(index, frontend=True, nprobe=N_CLUSTERS,
                              rerank_factor=2, tick_interval=0.0005)
    want = {i: _direct(server, queries[i]) for i in range(16)}
    server.frontend.start()
    errors, got = [], {}

    def caller(i, direct):
        try:
            for _ in range(6):
                got[(i, direct)] = server.query(
                    torch.from_numpy(queries[i][None]), 10, direct=direct)
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=caller, args=(i, i % 2 == 0))
               for i in range(16)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        server.frontend.stop()
    assert not errors, errors
    assert len(got) == 16
    for (i, _), res in got.items():
        assert _rows_equal(res, want[i]), i
    assert server.stats()["tier"]["cold_uploads"] > 0


def test_tiered_searches_take_turns(corpus, queries):
    """A second search of a tiered index waits while the first is inside
    its staging: the slots and the stream are the index's own."""
    index = tserve.build_index(
        torch.from_numpy(corpus), K, index="ivf", n_clusters=N_CLUSTERS,
        offload=True, hot_clusters=0, device="cpu",
        generator=torch.Generator().manual_seed(0))
    tiered = index.ivf
    q = index.transform.transform(torch.from_numpy(queries[:4]))
    inside, release, entered = threading.Event(), threading.Event(), []
    orig = tiered._stage_chunk

    def gated(*args):
        entered.append(threading.current_thread().name)
        if threading.current_thread().name == "first":
            inside.set()
            assert release.wait(10), "test deadlock"
        return orig(*args)

    tiered._stage_chunk = gated
    first = threading.Thread(target=tiered.search, args=(q, 5, 8),
                             name="first")
    second = threading.Thread(target=tiered.search, args=(q, 5, 8),
                              name="second")
    first.start()
    assert inside.wait(10)
    second.start()
    second.join(timeout=0.3)
    assert second.is_alive() and set(entered) == {"first"}
    release.set()
    first.join(10)
    second.join(10)
    assert not second.is_alive() and "second" in entered


# -- property: random submit/churn interleavings ------------------------------


_PROP_STATE = {}


def _prop_index(kind):
    """Module-cached small index for the property examples."""
    if kind not in _PROP_STATE:
        _PROP_STATE[kind] = tserve.build_index(
            torch.from_numpy(_manifold(5, 300, 24, 6)), 8, index=kind,
            n_clusters=12 if kind == "ivf" else None, device="cpu",
            generator=torch.Generator().manual_seed(5))
    return _PROP_STATE[kind]


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10 ** 6))
def test_random_interleaving_matches_direct(seed):
    """Any interleaving of submits, churn and ticks: every response is
    bit-identical to a fresh direct query at resolution time."""
    rng = np.random.default_rng(seed)
    kind = "ivf" if seed % 2 else "flat"
    server = tserve.ZenServer(_prop_index(kind), frontend=True,
                              cache_size=32, nprobe=6, clock=FakeClock())
    sched = server.frontend
    qpool = rng.normal(size=(16, 24)).astype(np.float32)
    pending = []          # (handle, qrow, n_neighbors), not yet verified
    next_id = 10_000

    def verify_resolved():
        still = []
        for h, qrow, nn in pending:
            if h.done():
                assert _rows_equal(h.result(), _direct(server, qrow, nn))
            else:
                still.append((h, qrow, nn))
        pending[:] = still

    for _ in range(rng.integers(8, 20)):
        op = rng.choice(["submit", "submit", "submit", "tick", "upsert",
                         "delete", "compact"])
        if op == "submit":
            qrow = qpool[rng.integers(0, len(qpool))]
            nn = int(rng.integers(1, 12))
            try:
                h = sched.submit(qrow, nn)
            except FrontendOverloadError:
                continue
            pending.append((h, qrow, nn))
            verify_resolved()         # cache hits resolve at submit time
        elif op == "tick":
            sched.tick()
            verify_resolved()
        elif op == "upsert":
            sched.tick()              # drain, verify, then churn
            verify_resolved()
            server.upsert([next_id], torch.from_numpy(
                rng.normal(size=(1, 24)).astype(np.float32)))
            next_id += 1
        elif op == "delete":
            sched.tick()
            verify_resolved()
            server.delete([int(rng.integers(0, 300))])
        else:
            sched.tick()
            verify_resolved()
            server.compact()
    sched.flush()
    verify_resolved()
    assert not pending


# -- snapshots and the CLI ----------------------------------------------------


def test_snapshot_carries_the_frontend_settings(tmp_path, base_index,
                                                queries):
    server = _frontend_server(base_index["ivf"], max_batch=16,
                              cache_size=32, rerank_factor=2)
    server.save(str(tmp_path / "s"))
    back = tserve.ZenServer.load(str(tmp_path / "s"), device="cpu")
    assert back.frontend is not None
    assert (back.max_batch, back.cache_size) == (16, 32)
    assert back.frontend.max_batch == 16
    assert back.frontend.cache.capacity == 32
    q = torch.from_numpy(queries[:5])
    assert _rows_equal(back.query(q, 10), server.query(q, 10, direct=True))
    plain = tserve.ZenServer.load(str(tmp_path / "s"), device="cpu",
                                  frontend=False)
    assert plain.frontend is None and "frontend" not in plain.stats()


def test_cli_frontend_rehearsal(capsys):
    tserve.main(["--device", "cpu", "--n", "3000", "--dim", "64", "--k",
                 "12", "--queries", "8", "--batches", "3", "--frontend",
                 "--cache", "64", "--max-batch", "16"])
    out = capsys.readouterr().out
    assert float(out.split("recall@10: ")[1].split()[0]) > 0.8, out
    assert "'frontend'" in out and "'cache'" in out


# -- against the JAX package ----------------------------------------------------


@pytest.fixture(scope="module")
def jax_mods():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.launch import serve as jserve
    return jax, jnp, jserve


def _jax_frontend_pair(jax_mods, tmp_path, kind, **kw):
    """A JAX frontend server and the port's load of its snapshot, each on
    its own fake clock."""
    jax, jnp, jserve = jax_mods
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        extra = dict(index="ivf", n_clusters=N_CLUSTERS) \
            if kind == "ivf" else {}
        jidx = jserve.build_index(jnp.asarray(_manifold(0, N, DIM, 8)), K,
                                  key=jax.random.PRNGKey(3), **extra)
        jsv = jserve.ZenServer(jidx, frontend=True, clock=FakeClock(),
                               nprobe=8, **kw)
        jsv.save(str(tmp_path / kind))
    finally:
        jax.config.update("jax_enable_x64", prev)
    psv = tserve.ZenServer.load(str(tmp_path / kind), device="cpu",
                                clock=FakeClock())
    return jsv, psv


@pytest.mark.parametrize("rerank", [0, 4])
@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_scheduled_answers_and_counters_match_jax(jax_mods, tmp_path,
                                                  queries, kind, rerank):
    jax, jnp, _ = jax_mods
    jsv, psv = _jax_frontend_pair(jax_mods, tmp_path, kind,
                                  rerank_factor=rerank, cache_size=16,
                                  max_batch=8)
    assert psv.frontend is not None and psv.max_batch == 8
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        schedule = [(0, 10), (1, 10), (2, 9), (3, 40), (0, 10), (4, 10)] \
            + [(i, 10) for i in range(5, 17)]
        for step in range(3):
            jh = [jsv.frontend.submit(queries[i], nn)
                  for i, nn in schedule[step::3]]
            th = [psv.frontend.submit(queries[i], nn)
                  for i, nn in schedule[step::3]]
            assert jsv.frontend.tick() == psv.frontend.tick()
            for a, b in zip(jh, th):
                msg = topk_mismatch(b.result()[0], b.result()[1],
                                    *a.result(), **SAME)
                assert msg is None, msg
        js, ps = jsv.frontend.stats.snapshot(), psv.frontend.stats.snapshot()
        for key in ("submitted", "completed", "dispatches",
                    "batch_occupancy", "cache_hits", "cache_misses",
                    "compile_count", "ticks"):
            assert js[key] == ps[key], key
        assert jsv.frontend.stats.dispatch_shapes == \
            psv.frontend.stats.dispatch_shapes
    finally:
        jax.config.update("jax_enable_x64", prev)


def test_port_frontend_snapshot_loads_in_jax(jax_mods, tmp_path, base_index,
                                             queries):
    jax, jnp, jserve = jax_mods
    server = _frontend_server(base_index["flat"], max_batch=32,
                              cache_size=128)
    server.save(str(tmp_path / "p"))
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        jsv = jserve.ZenServer.load(str(tmp_path / "p"))
        assert jsv.frontend is not None
        assert (jsv.max_batch, jsv.cache_size) == (32, 128)
        want = jsv.query(jnp.asarray(queries[:6]), 10)
    finally:
        jax.config.update("jax_enable_x64", prev)
    got = server.query(torch.from_numpy(queries[:6]), 10)
    msg = topk_mismatch(got[0], got[1], np.asarray(want[0]),
                        np.asarray(want[1]), **SAME)
    assert msg is None, msg
