"""The port's replicated serving tier (``repro_torch.launch.replicate``),
driven step by step on the CPU: the cases of ``tests/test_replication.py``
on the port, and the tier across the two packages.

A leader churns and publishes atomic generation-tagged snapshots; replicas
hot-swap to them without dropping in-flight queries and serve
**bit-identical** answers to a direct leader query at the replica's
current generation, never a generation they have not fully swapped to.
Fake clocks, explicit poll/publish interleavings and a property over
random schedules (a fixed-seed fallback without hypothesis); the one
in-flight pinning case blocks on events, not time. Replicas load onto
``device="cpu"`` here.

Across packages: a JAX leader's published generation is served by a port
replica with the JAX leader's answers within the parity bar (rtol / atol
1e-5, ids equal outside near-ties) and bit-identical to the port server
loaded from the same snapshot; a port leader's generation is served by a
JAX replica. Data: numpy, seeded.
"""
import json
import os
import shutil
import tempfile
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional dep: fixed-seed replay keeps the suite green
    from _hypothesis_fallback import given, settings, st

from repro_torch.checkpoint.index_io import CheckpointFormatError  # noqa
from repro_torch.distributed.fault import ReplicaTracker  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.replicate import (  # noqa: E402
    PUBLISH_POINTER,
    IndexLeader,
    LeaderHandedOff,
    QueryReplica,
    ReplicaNotReady,
    read_pointer,
)
from repro_torch.serving import LRUCache, run_open_loop  # noqa: E402
from repro_torch.serving.cache import result_key  # noqa: E402
from repro_torch.serving.loadgen import poisson_arrivals  # noqa: E402
from repro_torch.testing import topk_mismatch  # noqa: E402

N, DIM, K = 400, 24, 8
N_CLUSTERS = 12
SAME = dict(rtol=1e-5, atol=1e-5)
ZenServer = tserve.ZenServer


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _manifold(seed, n, dim, intrinsic):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, intrinsic))
    w = rng.standard_normal((intrinsic, dim)) / np.sqrt(intrinsic)
    x = np.tanh(z @ w) + 0.01 * rng.standard_normal((n, dim))
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    return _manifold(0, N, DIM, 6)


@pytest.fixture(scope="module")
def queries():
    return torch.from_numpy(_manifold(1, 12, DIM, 6))


@pytest.fixture(scope="module")
def base_index(corpus):
    x = torch.from_numpy(corpus)
    kw = dict(generator=torch.Generator().manual_seed(0), device="cpu")
    return {
        "flat": tserve.build_index(x, K, index="flat", **kw),
        "ivf": tserve.build_index(x, K, index="ivf", n_clusters=N_CLUSTERS,
                                  **kw),
    }


def _fresh_vectors(seed, count):
    return torch.from_numpy(_manifold(seed, count, DIM, 6))


def _rows_equal(a, b):
    return (np.array_equal(np.asarray(a[0]), np.asarray(b[0]))
            and np.array_equal(np.asarray(a[1]), np.asarray(b[1])))


def _replica(root, **kw):
    return QueryReplica(root, device="cpu", **kw)


def _load(path, **kw):
    return ZenServer.load(path, device="cpu", **kw)


# -- publish pointer protocol --------------------------------------------------


def test_pointer_absent_before_first_publish(tmp_path):
    root = str(tmp_path / "pub")
    assert read_pointer(root) is None
    rep = _replica(root)
    assert rep.poll() is False
    with pytest.raises(ReplicaNotReady):
        rep.query(torch.zeros((1, DIM)))


def test_publish_writes_generation_tagged_snapshot(tmp_path, base_index):
    leader = IndexLeader(ZenServer(base_index["flat"]), str(tmp_path))
    pub = leader.publish()
    assert pub.generation == 0
    assert os.path.basename(pub.snapshot) == "gen-000000000000"
    assert read_pointer(str(tmp_path)) == pub
    assert leader.publish() == pub  # republish is idempotent
    assert leader.published_generation == 0


def test_unknown_pointer_format_is_rejected_loudly(tmp_path):
    os.makedirs(tmp_path, exist_ok=True)
    with open(tmp_path / PUBLISH_POINTER, "w") as f:
        json.dump({"format": "someone-elses", "version": 9,
                   "generation": 3, "snapshot": "x"}, f)
    with pytest.raises(CheckpointFormatError):
        read_pointer(str(tmp_path))
    rep = _replica(str(tmp_path))  # survives it: counted, not raised
    assert rep.poll() is False
    assert rep.poll_errors == 1 and "someone-elses" in rep.last_error


def test_torn_pointer_file_is_counted_not_raised(tmp_path):
    os.makedirs(tmp_path, exist_ok=True)
    (tmp_path / PUBLISH_POINTER).write_text('{"format": "zen-pub')
    rep = _replica(str(tmp_path))
    assert rep.poll() is False and rep.poll_errors == 1


def test_publish_prunes_old_generations_but_never_current(
        tmp_path, base_index):
    leader = IndexLeader(ZenServer(base_index["flat"]), str(tmp_path),
                         keep=2)
    leader.publish()
    for seed in (10, 11, 12):
        leader.upsert([N + seed], _fresh_vectors(seed, 1))
        leader.publish()
    gens = sorted(d for d in os.listdir(tmp_path) if d.startswith("gen-")
                  and not d.endswith(".pool"))
    assert len(gens) == 2
    ptr = read_pointer(str(tmp_path))
    assert os.path.basename(ptr.snapshot) == gens[-1]
    with pytest.raises(ValueError, match="keep"):
        IndexLeader(ZenServer(base_index["flat"]), str(tmp_path), keep=0)


# -- hot-swap bit parity -------------------------------------------------------


@pytest.mark.parametrize("kind", ["flat", "ivf"])
@pytest.mark.parametrize("mmap", [False, True])
def test_replica_serves_bit_identical_to_leader(tmp_path, base_index,
                                                queries, kind, mmap):
    leader_srv = ZenServer(base_index[kind], nprobe=6, rerank_factor=2)
    leader = IndexLeader(leader_srv, str(tmp_path))
    leader.publish()
    rep = _replica(str(tmp_path), mmap=mmap)
    assert rep.poll() is True
    assert rep.generation == 0
    assert rep.server.index.device == torch.device("cpu")
    assert _rows_equal(rep.query(queries, 5),
                       leader_srv.query(queries, 5, direct=True))


def test_churn_publish_swap_loop_zero_errors_bit_parity(
        tmp_path, base_index, queries):
    """churn -> publish -> swap -> query, many rounds: zero replica errors,
    every answer bit-equal to the leader's."""
    leader_srv = ZenServer(base_index["ivf"], nprobe=N_CLUSTERS)
    leader = IndexLeader(leader_srv, str(tmp_path), keep=3)
    leader.publish()
    rep = _replica(str(tmp_path), mmap=True, frontend=True, cache_size=64)
    assert rep.poll()
    for round_ in range(5):
        ids = [N + 10 * round_ + j for j in range(3)]
        leader.upsert(ids, _fresh_vectors(100 + round_, 3))
        leader.delete([round_, round_ + 20])
        leader.publish()
        assert rep.poll() is True
        assert rep.generation == leader.generation
        assert _rows_equal(rep.query(queries, 7),
                           leader_srv.query(queries, 7, direct=True))
    assert rep.poll_errors == 0
    assert rep.swaps == 6
    st_ = rep.stats()["server"]["frontend"]
    assert st_["failures"] == 0 and st_["swaps"] == 6


def test_replica_never_serves_an_unswapped_generation(
        tmp_path, base_index, queries):
    leader_srv = ZenServer(base_index["flat"])
    leader = IndexLeader(leader_srv, str(tmp_path), keep=4)
    leader.publish()
    rep = _replica(str(tmp_path))
    rep.poll()
    oracle_g0 = _load(read_pointer(str(tmp_path)).snapshot)
    leader.delete([0, 1, 2, 3])
    leader.publish()
    leader.upsert([N + 1], _fresh_vectors(3, 1))
    leader.publish()
    assert rep.generation == 0
    assert _rows_equal(rep.query(queries, 6),
                       oracle_g0.query(queries, 6, direct=True))
    assert rep.poll() is True
    assert rep.generation == leader.generation
    assert _rows_equal(rep.query(queries, 6),
                       leader_srv.query(queries, 6, direct=True))


def test_swap_does_not_drop_in_flight_queries(tmp_path, base_index, queries):
    """A query in flight across a hot-swap resolves, and its generation
    stays pinned until it does (event-gated, no timing)."""
    leader_srv = ZenServer(base_index["flat"])
    leader = IndexLeader(leader_srv, str(tmp_path), keep=4)
    leader.publish()
    rep = _replica(str(tmp_path), mmap=True)
    rep.poll()
    entered, release = threading.Event(), threading.Event()
    orig = rep.server._query_block

    def gated(*args, **kw):
        entered.set()
        assert release.wait(10), "test deadlock"
        return orig(*args, **kw)

    rep.server._query_block = gated
    out = []
    t = threading.Thread(
        target=lambda: out.append(rep.query(queries, 5, direct=True)))
    t.start()
    assert entered.wait(10)
    leader.upsert([N + 7], _fresh_vectors(9, 1))
    leader.publish()
    assert rep.poll() is True
    assert rep.pinned_generations() == (0, leader.generation)
    assert rep.released_generations() == ()
    release.set()
    t.join(10)
    assert out, "the swap dropped the in-flight query"
    assert rep.pinned_generations() == (leader.generation,)
    assert rep.released_generations() == (0,)
    rep.server._query_block = orig
    assert _rows_equal(out[0], leader_srv.query(queries, 5, direct=True))


# -- the generation is the coherence key ---------------------------------------


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_loaded_snapshot_preserves_published_generation(
        tmp_path, base_index, kind):
    srv = ZenServer(base_index[kind])
    srv.upsert([N + 1, N + 2], _fresh_vectors(21, 2))
    srv.delete([N + 1])
    assert srv.index.generation == 2
    path = str(tmp_path / "snap")
    srv.save(path)
    restored = _load(path)
    assert restored.index.generation == 2
    if kind == "ivf":
        assert restored.index.ivf.generation == 2


def test_pre_swap_cache_entry_is_unreachable_after_hot_swap(
        tmp_path, base_index, queries):
    leader_srv = ZenServer(base_index["flat"])
    leader = IndexLeader(leader_srv, str(tmp_path), keep=4)
    leader.publish()
    rep = _replica(str(tmp_path), frontend=True, cache_size=128)
    rep.poll()
    d_old, ids_old = rep.query(queries, 5)
    cache = rep.server.frontend.cache
    assert cache.misses > 0 and len(cache) > 0
    victim = int(ids_old[0, 0])
    leader.delete([victim])
    leader.publish()
    assert rep.poll()
    assert cache.stale_evictions > 0 and len(cache) == 0
    d_new, ids_new = rep.query(queries, 5)
    assert victim not in ids_new[0].tolist()
    assert _rows_equal((d_new, ids_new),
                       leader_srv.query(queries, 5, direct=True))


def test_lru_evict_stale_drops_only_other_generations():
    cache = LRUCache(8)
    k0 = result_key(b"q", "zen", 16, 8, 4, 0, 0)
    k1 = result_key(b"q", "zen", 16, 8, 4, 0, 1)
    cache.put(k0, "old")
    cache.put(k1, "new")
    assert cache.evict_stale(1) == 1
    assert cache.get(k1) == "new" and cache.get(k0) is None
    assert cache.stale_evictions == 1


# -- fault injection -----------------------------------------------------------


def test_leader_killed_mid_publish_leaves_only_loadable_snapshots(
        tmp_path, base_index, queries):
    """The crash windows of a publish: whatever is left on disk, the
    pointer aims at a complete snapshot and no replica loads a torn one."""
    leader_srv = ZenServer(base_index["flat"])
    leader = IndexLeader(leader_srv, str(tmp_path), keep=4)
    leader.publish()
    rep = _replica(str(tmp_path))
    rep.poll()
    oracle_g0 = _load(read_pointer(str(tmp_path)).snapshot)

    # window 1: killed while writing the snapshot (a tmp.* sibling)
    torn = tmp_path / "tmp.gen-000000000099"
    os.makedirs(torn)
    (torn / "refs.npy").write_bytes(b"partial garbage")
    assert rep.poll() is False
    assert rep.generation == 0 and rep.poll_errors == 0

    # window 2: the snapshot is complete, the pointer did not move
    leader.upsert([N + 5], _fresh_vectors(5, 1))
    leader_srv.save(str(tmp_path / "gen-000000000001"))
    assert rep.poll() is False
    assert rep.generation == 0
    assert _rows_equal(rep.query(queries, 5),
                       oracle_g0.query(queries, 5, direct=True))

    # recovery: the restarted leader republishes; the replica swaps
    leader.publish()
    assert rep.poll() is True
    assert rep.generation == leader.generation
    assert _rows_equal(rep.query(queries, 5),
                       leader_srv.query(queries, 5, direct=True))


def test_pointer_to_vanished_snapshot_keeps_replica_serving(
        tmp_path, base_index, queries):
    leader_srv = ZenServer(base_index["flat"])
    leader = IndexLeader(leader_srv, str(tmp_path), keep=4)
    leader.publish()
    rep = _replica(str(tmp_path))
    rep.poll()
    leader.upsert([N + 9], _fresh_vectors(8, 1))
    pub = leader.publish()
    shutil.rmtree(pub.snapshot)  # pruned under the pointer
    assert rep.poll() is False
    assert rep.poll_errors == 1 and rep.generation == 0
    d, ids = rep.query(queries, 5)  # still serving, just lagged
    assert tuple(ids.shape) == (len(queries), 5)


def test_lagging_replica_and_tracker_verdicts(tmp_path, base_index):
    clock = FakeClock()
    leader = IndexLeader(ZenServer(base_index["flat"]), str(tmp_path),
                         keep=4)
    with pytest.raises(RuntimeError, match="track_replicas"):
        leader.fleet_status()
    tracker = leader.track_replicas(deadline_s=10.0, clock=clock)
    assert isinstance(tracker, ReplicaTracker)
    leader.publish()
    rep_a = _replica(str(tmp_path), name="a")
    rep_b = _replica(str(tmp_path), name="b")
    rep_a.poll(), rep_b.poll()
    for r in (rep_a, rep_b):
        leader.replica_report(r.name, r.generation)
    assert leader.fleet_status()["lagging"] == []
    leader.delete([0])
    leader.publish()
    rep_a.poll()
    leader.replica_report("a", rep_a.generation)
    leader.replica_report("b", rep_b.generation)
    assert leader.fleet_status()["lagging"] == ["b"]
    assert not tracker.coherent(leader.generation)
    clock.advance(11.0)
    leader.replica_report("a", rep_a.generation)
    status = leader.fleet_status()
    assert status["dead"] == ["b"] and status["lagging"] == []
    assert tracker.coherent(leader.generation)


def test_preemption_guard_hands_off_cleanly(tmp_path, base_index, queries):
    leader_srv = ZenServer(base_index["flat"])
    leader = IndexLeader(leader_srv, str(tmp_path), keep=4)
    leader.enable_preemption()
    leader.publish()
    rep = _replica(str(tmp_path))
    rep.poll()
    leader.upsert([N + 3], _fresh_vectors(4, 1))
    assert leader.maybe_handoff() is False  # no notice yet
    leader.preemption.request()
    assert leader.maybe_handoff() is True
    assert leader.handed_off
    with pytest.raises(LeaderHandedOff):
        leader.upsert([N + 4], _fresh_vectors(5, 1))
    with pytest.raises(LeaderHandedOff):
        leader.compact()
    assert rep.poll() is True
    assert rep.generation == leader.generation
    assert _rows_equal(rep.query(queries, 5),
                       leader_srv.query(queries, 5, direct=True))
    successor = IndexLeader(_load(read_pointer(str(tmp_path)).snapshot),
                            str(tmp_path), keep=4)
    assert successor.generation == leader.generation
    successor.upsert([N + 4], _fresh_vectors(5, 1))
    successor.publish()
    assert rep.poll() is True
    assert rep.generation == successor.generation


def test_published_tile_pool_serves_the_leaders_answers(
        tmp_path, base_index, queries):
    """``publish_pool``: the replica serves the IVF tier off the published
    tile pool (memory-mapped, tiered), with the leader's answers."""
    leader_srv = ZenServer(base_index["ivf"], nprobe=6, rerank_factor=2)
    leader = IndexLeader(leader_srv, str(tmp_path), publish_pool=True)
    pub = leader.publish()
    assert pub.pool is not None and os.path.isdir(pub.pool)
    rep = _replica(str(tmp_path), mmap=True, use_pool=True,
                   pool_kw=dict(hot_clusters=3))
    assert rep.poll()
    assert rep.server.index._is_tiered()
    assert rep.server.index.ivf.hot_clusters.size == 3
    got = rep.query(queries, 5)
    msg = topk_mismatch(got[0], got[1],
                        *leader_srv.query(queries, 5, direct=True), **SAME)
    assert msg is None, msg
    with pytest.raises(ValueError, match="publish_pool"):
        IndexLeader(ZenServer(base_index["flat"]), str(tmp_path / "x"),
                    publish_pool=True)


# -- property: random interleavings match a per-generation oracle -------------

_PROP_STATE = {}


def _prop_index(kind):
    if kind not in _PROP_STATE:
        _PROP_STATE[kind] = tserve.build_index(
            torch.from_numpy(_manifold(5, 300, 16, 4)), 6, index=kind,
            n_clusters=10 if kind == "ivf" else None, device="cpu",
            generator=torch.Generator().manual_seed(5))
    return _PROP_STATE[kind]


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10 ** 6))
def test_random_replication_schedule_matches_oracle(seed):
    """Any interleaving of churn, publish, per-replica poll and query:
    every replica answer bit-equals a direct query against a server loaded
    from the snapshot of the replica's current generation."""
    rng = np.random.default_rng(seed)
    kind = "ivf" if seed % 2 else "flat"
    root = tempfile.mkdtemp(prefix="zen-repl-prop-")
    try:
        leader_srv = ZenServer(_prop_index(kind), nprobe=10)
        leader = IndexLeader(leader_srv, root, keep=50)  # no pruning
        leader.publish()
        oracles = {0: _load(read_pointer(root).snapshot, nprobe=10)}
        reps = [_replica(root, name=f"r{i}", mmap=bool(rng.integers(2)),
                         frontend=True, cache_size=int(rng.integers(0, 33)))
                for i in range(2)]
        for r in reps:
            r.poll()
        qpool = rng.normal(size=(8, 16)).astype(np.float32)
        next_id = 10_000
        for _ in range(int(rng.integers(10, 24))):
            op = rng.choice(["churn", "publish", "poll", "query", "query"])
            if op == "churn":
                if rng.integers(2):
                    leader.upsert([next_id], torch.from_numpy(
                        rng.normal(size=(1, 16)).astype(np.float32)))
                    next_id += 1
                else:
                    leader.delete([int(rng.integers(0, 300))])
            elif op == "publish":
                pub = leader.publish()
                if pub.generation not in oracles:
                    oracles[pub.generation] = _load(pub.snapshot, nprobe=10)
            elif op == "poll":
                reps[int(rng.integers(2))].poll()
            else:
                rep = reps[int(rng.integers(2))]
                q = torch.from_numpy(qpool[rng.integers(0, len(qpool))][None])
                nn = int(rng.integers(1, 8))
                got = rep.query(q, nn)
                want = oracles[rep.generation].query(q, nn, direct=True)
                assert _rows_equal(got, want), (
                    f"replica {rep.name} diverged from its generation "
                    f"{rep.generation} oracle (seed {seed})")
        for rep in reps:
            assert rep.poll_errors == 0
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -- open-loop load generator (deterministic, fake clock) ---------------------


def test_poisson_arrivals_fixed_seed_and_rate():
    a = poisson_arrivals(200.0, 5.0, seed=3)
    b = poisson_arrivals(200.0, 5.0, seed=3)
    np.testing.assert_array_equal(a, b)
    assert (a >= 0).all() and (a < 5.0).all()
    assert np.all(np.diff(a) >= 0)
    assert a.size == pytest.approx(1000, rel=0.25)
    other = poisson_arrivals(200.0, 5.0, seed=4)
    assert other.size != a.size or not np.array_equal(other, a)
    with pytest.raises(ValueError):
        poisson_arrivals(0.0, 1.0)


def test_poisson_arrivals_equal_the_jax_packages():
    pytest.importorskip("jax")
    from repro.serving.loadgen import poisson_arrivals as jarrivals
    np.testing.assert_array_equal(poisson_arrivals(321.0, 2.0, seed=7),
                                  jarrivals(321.0, 2.0, seed=7))


def test_open_loop_under_capacity_completes_everything(base_index, queries):
    clock = FakeClock()
    server = ZenServer(base_index["flat"], frontend=True, max_batch=16,
                       queue_limit=256, tick_interval=0.01, clock=clock)
    report = run_open_loop(server, queries.numpy(), offered_qps=100.0,
                           duration_s=0.5, n_neighbors=5, seed=1,
                           clock=clock, sleep=clock.advance)
    assert report.rejected == 0 and report.failures == 0
    assert report.timeouts == 0
    assert report.completed == report.submitted > 0
    assert report.p99_ms == report.p99_ms  # not NaN
    assert report.row()["reject_rate"] == 0.0
    clock2 = FakeClock()
    server2 = ZenServer(base_index["flat"], frontend=True, max_batch=16,
                        queue_limit=256, tick_interval=0.01, clock=clock2)
    report2 = run_open_loop(server2, queries.numpy(), offered_qps=100.0,
                            duration_s=0.5, n_neighbors=5, seed=1,
                            clock=clock2, sleep=clock2.advance)
    assert report2 == report
    with pytest.raises(ValueError, match="frontend"):
        run_open_loop(ZenServer(base_index["flat"]), queries.numpy(),
                      offered_qps=10.0, duration_s=0.1)


def test_open_loop_overload_sheds_load_and_keeps_latency_bounded(
        base_index, queries):
    clock = FakeClock()
    server = ZenServer(base_index["flat"], frontend=True, max_batch=8,
                       queue_limit=8, tick_interval=0.01, clock=clock)
    report = run_open_loop(server, queries.numpy(), offered_qps=3200.0,
                           duration_s=0.25, n_neighbors=5, seed=2,
                           clock=clock, sleep=clock.advance)
    assert report.rejected > 0, "overload never tripped backpressure"
    assert report.completed > 0 and report.timeouts == 0
    assert report.achieved_qps < report.offered_qps
    assert report.p99_ms < 100.0


def test_open_loop_replica_fleet_scales_admission_budget(
        tmp_path, base_index, queries):
    leader = IndexLeader(ZenServer(base_index["ivf"], nprobe=6),
                         str(tmp_path))
    leader.publish()

    def fleet(n, clock):
        reps = [_replica(str(tmp_path), name=f"r{i}", frontend=True,
                         max_batch=8, queue_limit=8, tick_interval=0.01,
                         cache_size=0, clock=clock, nprobe=6)
                for i in range(n)]
        for r in reps:
            assert r.poll()
        return [r.server for r in reps]

    results = {}
    for n in (1, 3):
        clock = FakeClock()
        report = run_open_loop(fleet(n, clock), queries.numpy(),
                               offered_qps=2400.0, duration_s=0.25,
                               n_neighbors=5, seed=4, clock=clock,
                               sleep=clock.advance)
        assert report.timeouts == 0 and report.failures == 0
        results[n] = report.completed
    assert results[3] >= 2 * results[1], results


def test_open_loop_counts_match_the_jax_package(tmp_path, base_index,
                                                 queries):
    """The same fake-clock open-loop run through a JAX server and a port
    server loaded from its snapshot: the same admission, reject and
    completion counts."""
    jax = pytest.importorskip("jax")
    from repro.launch import serve as jserve
    from repro.serving import run_open_loop as jrun

    ZenServer(base_index["flat"], max_batch=8).save(str(tmp_path / "s"))
    reports = []
    for mod, run in ((jserve, jrun), (tserve, run_open_loop)):
        clock = FakeClock()
        kw = dict(frontend=True, max_batch=8, queue_limit=8,
                  tick_interval=0.01, clock=clock)
        if mod is tserve:
            kw["device"] = "cpu"
        prev = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", False)
        try:
            server = mod.ZenServer.load(str(tmp_path / "s"), **kw)
            reports.append(run(server, queries.numpy(), offered_qps=1600.0,
                               duration_s=0.2, n_neighbors=5, seed=3,
                               clock=clock, sleep=clock.advance))
        finally:
            jax.config.update("jax_enable_x64", prev)
    j, p = reports
    assert (j.submitted, j.rejected, j.completed, j.timeouts) == \
        (p.submitted, p.rejected, p.completed, p.timeouts)
    assert j.p99_ms == pytest.approx(p.p99_ms)


# -- across the two packages ------------------------------------------------------


def _jax_leader(jax_mods, root, kind):
    jax, jnp, jserve, jrep = jax_mods
    extra = dict(index="ivf", n_clusters=N_CLUSTERS) if kind == "ivf" else {}
    jidx = jserve.build_index(jnp.asarray(_manifold(0, N, DIM, 6)), K,
                              key=jax.random.PRNGKey(4), **extra)
    return jrep.IndexLeader(jserve.ZenServer(jidx, nprobe=6,
                                             rerank_factor=2), root)


@pytest.fixture(scope="module")
def jax_mods():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.launch import replicate as jrep
    from repro.launch import serve as jserve
    return jax, jnp, jserve, jrep


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_port_replica_serves_a_jax_leaders_generations(jax_mods, tmp_path,
                                                       queries, kind):
    jax, jnp, _, _ = jax_mods
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        leader = _jax_leader(jax_mods, str(tmp_path), kind)
        rep = _replica(str(tmp_path), frontend=True, cache_size=32)
        for round_ in range(3):
            if round_:
                leader.upsert([N + round_],
                              jnp.asarray(_fresh_vectors(30 + round_, 1)
                                          .numpy()))
                leader.delete([round_ * 7])
            pub = leader.publish()
            assert rep.poll() is True
            assert rep.generation == pub.generation == leader.generation
            want = leader.server.query(jnp.asarray(queries.numpy()), 6,
                                       direct=True)
            got = rep.query(queries, 6)
            msg = topk_mismatch(got[0], got[1], np.asarray(want[0]),
                                np.asarray(want[1]), **SAME)
            assert msg is None, msg
            oracle = _load(pub.snapshot)
            assert _rows_equal(got, oracle.query(queries, 6, direct=True))
        assert rep.poll_errors == 0
    finally:
        jax.config.update("jax_enable_x64", prev)


def test_jax_replica_serves_a_port_leaders_generation(jax_mods, tmp_path,
                                                      base_index, queries):
    jax, jnp, _, jrep = jax_mods
    leader_srv = ZenServer(base_index["ivf"], nprobe=6, rerank_factor=2)
    leader = IndexLeader(leader_srv, str(tmp_path))
    leader.upsert([N + 1], _fresh_vectors(40, 1))
    leader.publish()
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        rep = jrep.QueryReplica(str(tmp_path))
        assert rep.poll() is True and rep.generation == 1
        want = rep.query(jnp.asarray(queries.numpy()), 6)
    finally:
        jax.config.update("jax_enable_x64", prev)
    got = leader_srv.query(queries, 6, direct=True)
    msg = topk_mismatch(got[0], got[1], np.asarray(want[0]),
                        np.asarray(want[1]), **SAME)
    assert msg is None, msg


def test_replica_defaults_to_the_card():
    if torch.cuda.is_available():
        assert QueryReplica("unused").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            QueryReplica("unused")
