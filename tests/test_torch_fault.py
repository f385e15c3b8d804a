"""The port's fault-tolerance hooks (``repro_torch.distributed.fault``) and
the server's degraded serving, driven by fake clocks on the CPU.

The cases of ``tests/test_fault.py`` on the port; the same scripted event
sequences through both packages' hooks, which must give the same verdicts
(pure Python: exact equality); and ``ZenServer.enable_fault_tolerance``: a
tiered index whose shard goes silent past its deadline answers exactly as
the same index with ``set_dead_shards`` applied directly, reports the
outage in ``stats()``, recovers when the shard beats again, matches the
JAX package's degraded answers within the parity bar (rtol / atol 1e-5,
ids equal outside near-ties), and a preemption notice writes a snapshot
that reloads to the same answers. Data: numpy, seeded.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed import (  # noqa: E402
    HeartbeatRegistry,
    PreemptionGuard,
    ReplicaTracker,
    StepMonitor,
)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.testing import topk_mismatch  # noqa: E402

SAME = dict(rtol=1e-5, atol=1e-5)
N, DIM, K, N_CLUSTERS, N_SHARDS = 800, 24, 8, 12, 3


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# ----------------------------- StepMonitor -----------------------------------


def test_step_monitor_flags_straggler_after_warmup():
    mon = StepMonitor(warmup_steps=3, threshold=2.0)
    for s in range(6):
        assert mon.record(s, 1.0) is None
    ev = mon.record(6, 5.0)
    assert ev is not None
    assert ev.ratio == pytest.approx(5.0)
    assert mon.events == [ev]


def test_step_monitor_warmup_straggler_never_inflates_ema():
    mon = StepMonitor(warmup_steps=5, threshold=2.0, ema_decay=0.9)
    mon.record(0, 1.0)
    assert mon.record(1, 10.0) is None  # warmup: not flagged...
    assert mon.ema == pytest.approx(1.0)  # ...and not averaged in
    for s in range(2, 6):
        mon.record(s, 1.0)
    assert mon.record(6, 3.0) is not None


def test_step_monitor_escalates_after_patience():
    mon = StepMonitor(warmup_steps=1, threshold=2.0, patience=3)
    for s in range(4):
        mon.record(s, 1.0)
    for s in range(4, 6):
        mon.record(s, 5.0)
        assert not mon.should_escalate
    mon.record(6, 5.0)
    assert mon.should_escalate


def test_step_monitor_normal_step_resets_patience():
    mon = StepMonitor(warmup_steps=1, threshold=2.0, patience=2)
    for s in range(4):
        mon.record(s, 1.0)
    mon.record(4, 5.0)
    mon.record(5, 1.0)  # recovered: the count resets
    mon.record(6, 5.0)
    assert not mon.should_escalate


def test_step_monitor_ema_tracks_normal_steps():
    mon = StepMonitor(warmup_steps=0, ema_decay=0.5)
    mon.record(0, 1.0)
    mon.record(1, 2.0)  # within threshold: folds in
    assert mon.ema == pytest.approx(1.5)


# --------------------------- HeartbeatRegistry --------------------------------


def test_registry_alive_and_dead_transitions():
    clock = FakeClock()
    reg = HeartbeatRegistry(deadline_s=10.0, now=clock)
    reg.beat("a")
    reg.beat("b")
    assert reg.alive() == ["a", "b"] and reg.dead_hosts() == []
    clock.advance(11.0)
    reg.beat("a")
    assert reg.dead_hosts() == ["b"]
    assert reg.alive() == ["a"]
    reg.beat("b")  # b recovers
    assert reg.dead_hosts() == []


def test_registry_registered_but_never_beat_is_reported_dead():
    clock = FakeClock()
    reg = HeartbeatRegistry(deadline_s=5.0, now=clock)
    reg.register("ghost")
    reg.beat("live")
    assert reg.expected() == ["ghost", "live"]
    assert reg.dead_hosts() == []
    clock.advance(6.0)
    reg.beat("live")
    assert reg.dead_hosts() == ["ghost"]


def test_registry_register_is_idempotent():
    clock = FakeClock()
    reg = HeartbeatRegistry(deadline_s=5.0, now=clock)
    reg.register("a")
    clock.advance(4.0)
    reg.register("a")  # must not refresh the registration deadline
    clock.advance(2.0)
    assert reg.dead_hosts() == ["a"]


def test_registry_beat_implicitly_registers():
    clock = FakeClock()
    reg = HeartbeatRegistry(deadline_s=5.0, now=clock)
    reg.beat("x")
    assert reg.expected() == ["x"]
    clock.advance(6.0)
    assert reg.dead_hosts() == ["x"]


def test_registry_empty_membership():
    reg = HeartbeatRegistry(deadline_s=1.0, now=FakeClock())
    assert reg.expected() == [] and reg.dead_hosts() == [] \
        and reg.alive() == []


# ---------------------------- PreemptionGuard ---------------------------------


def test_preemption_guard_request_save_clear_cycle():
    guard = PreemptionGuard(install_signal=False)
    assert not guard.should_save()
    guard.request()
    assert guard.should_save()
    assert guard.should_save()  # sticky until cleared
    guard.clear()
    assert not guard.should_save()


# ----------------------------- ReplicaTracker ---------------------------------


def test_replica_tracker_lag_and_death():
    clock = FakeClock()
    tr = ReplicaTracker(deadline_s=10.0, now=clock)
    tr.report("a", 3)
    tr.report("b", 2)
    assert tr.lagging(3) == ["b"] and not tr.coherent(3)
    assert tr.generation_of("a") == 3 and tr.generation_of("zz") is None
    clock.advance(11.0)
    tr.report("a", 3)
    st = tr.status(3)
    assert st["dead"] == ["b"] and st["alive"] == ["a"]
    assert st["lagging"] == [] and tr.coherent(3)
    assert st["replicas"] == {"a": 3, "b": 2}


# ------------------- the same event scripts through both packages -------------

SCRIPTS = {
    "monitor": [("record", 1.0)] * 6 + [("record", 5.0), ("record", 1.2),
                                        ("record", 4.0), ("record", 4.5),
                                        ("record", 6.0), ("record", 0.9)],
    "registry": [("register", "a"), ("beat", "b"), ("advance", 4.0),
                 ("beat", "a"), ("advance", 3.0), ("register", "c"),
                 ("advance", 2.5), ("beat", "b"), ("advance", 5.5),
                 ("beat", "c"), ("advance", 0.5)],
    "tracker": [("report", "r0", 1), ("report", "r1", 1), ("advance", 6.0),
                ("report", "r0", 2), ("advance", 5.0), ("report", "r2", 0),
                ("advance", 1.0)],
}


def _run_script(mod, name):
    clock = FakeClock()
    out = []
    if name == "monitor":
        mon = mod.StepMonitor(warmup_steps=3, threshold=2.0, patience=2)
        for i, (_, t) in enumerate(SCRIPTS[name]):
            ev = mon.record(i, t)
            out.append((None if ev is None else (ev.step, ev.ratio),
                        mon.ema, mon.should_escalate))
        return out
    if name == "registry":
        reg = mod.HeartbeatRegistry(deadline_s=5.0, now=clock)
        for op, arg in SCRIPTS[name]:
            if op == "advance":
                clock.advance(arg)
            else:
                getattr(reg, op)(arg)
            out.append((reg.expected(), reg.alive(), reg.dead_hosts()))
        return out
    tr = mod.ReplicaTracker(deadline_s=10.0, now=clock)
    for step in SCRIPTS[name]:
        if step[0] == "advance":
            clock.advance(step[1])
        else:
            tr.report(step[1], step[2])
        out.append(tr.status(2))
    return out


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_same_verdicts_as_jax_package(name):
    pytest.importorskip("jax")
    from repro.distributed import fault as jfault
    from repro_torch.distributed import fault as tfault

    assert _run_script(tfault, name) == _run_script(jfault, name)


# ------------------------ the server's degraded serving ------------------------


def _corpus(seed, n):
    return np.random.default_rng(seed).standard_normal((n, DIM)).astype(
        np.float32)


def _tiered_index():
    return tserve.build_index(
        torch.from_numpy(_corpus(0, N)), K, index="ivf",
        n_clusters=N_CLUSTERS, offload=True, hot_clusters=4,
        offload_shards=N_SHARDS, device="cpu",
        generator=torch.Generator().manual_seed(0))


def _bits(res):
    return res[0].numpy().view(np.int32), res[1].numpy()


def _equal(a, b):
    return all(np.array_equal(x, y) for x, y in zip(_bits(a), _bits(b)))


@pytest.mark.parametrize("frontend", [False, True])
def test_silent_shard_is_masked_like_set_dead_shards(frontend):
    clock = FakeClock()
    q = torch.from_numpy(_corpus(1, 9))
    server = tserve.ZenServer(_tiered_index(), nprobe=N_CLUSTERS,
                              rerank_factor=2, frontend=frontend,
                              clock=FakeClock())
    healthy = server.query(q, 10, direct=True)
    reg = server.enable_fault_tolerance(deadline_s=10.0, clock=clock)
    assert reg.expected() == ["shard0", "shard1", "shard2"]
    for s in range(N_SHARDS):
        server.heartbeat(s)
    clock.advance(6.0)
    server.heartbeat(0)
    server.heartbeat("shard2")
    assert _equal(server.query(q, 10), healthy)  # all alive
    assert server.stats()["degraded_shards"] == []
    clock.advance(6.0)                           # shard1 silent for 12 s
    server.heartbeat(0)
    server.heartbeat(2)
    degraded = server.query(q, 10)
    assert server.stats()["degraded_shards"] == ["shard1"]
    assert server.index.ivf.dead_shards == [1]
    # the same index with the shard masked directly
    oracle = tserve.ZenServer(_tiered_index(), nprobe=N_CLUSTERS,
                              rerank_factor=2)
    oracle.index.ivf.set_dead_shards([1])
    assert _equal(degraded, oracle.query(q, 10))
    assert not _equal(degraded, healthy)
    # no id of shard 1's clusters comes back
    ivf = server.index.ivf
    dead_ids = set(ivf.host_ids[np.repeat(
        ivf.shard_of_cluster() == 1, ivf.tiles_per_cluster)].ravel()) - {-1}
    assert not set(degraded[1].numpy().ravel()) & dead_ids
    # the shard beats again: full answers
    server.heartbeat(1)
    assert _equal(server.query(q, 10), healthy)
    assert server.stats()["degraded_shards"] == []


def test_frontend_ticks_refresh_the_verdicts():
    clock = FakeClock()
    server = tserve.ZenServer(_tiered_index(), nprobe=6, frontend=True,
                              clock=FakeClock())
    server.enable_fault_tolerance(deadline_s=1.0, clock=clock)
    clock.advance(2.0)                 # nobody beat: every shard dead
    server.frontend.tick()             # a tick alone refreshes the mask
    assert server.index.ivf.dead_shards == [0, 1, 2]
    d, ids = server.query(torch.from_numpy(_corpus(1, 3)), 5)
    assert bool(torch.isinf(d).all()) and bool((ids == -1).all())


def test_fault_tolerance_on_a_flat_index_tracks_without_masking():
    clock = FakeClock()
    index = tserve.build_index(torch.from_numpy(_corpus(0, 300)), K,
                               device="cpu",
                               generator=torch.Generator().manual_seed(0))
    server = tserve.ZenServer(index)
    with pytest.raises(RuntimeError, match="enable_fault_tolerance"):
        server.heartbeat(0)
    server.enable_fault_tolerance(["replica-a", "replica-b"], deadline_s=5,
                                  clock=clock)
    q = torch.from_numpy(_corpus(1, 4))
    want = server.query(q, 5)
    clock.advance(6.0)
    server.heartbeat("replica-a")
    assert _equal(server.query(q, 5), want)  # nothing to mask
    assert server.stats()["degraded_shards"] == ["replica-b"]


def test_preemption_request_writes_a_snapshot_that_reloads(tmp_path):
    server = tserve.ZenServer(_tiered_index(), nprobe=8, rerank_factor=2)
    q = torch.from_numpy(_corpus(1, 6))
    server.enable_fault_tolerance(snapshot_dir=str(tmp_path / "pre"),
                                  clock=FakeClock())
    want = server.query(q, 10)
    assert not (tmp_path / "pre").exists()
    server.preemption.request()
    server.query(q, 10)                          # the next tick saves
    assert (tmp_path / "pre" / "manifest.json").exists()
    assert not server.preemption.should_save()
    back = tserve.ZenServer.load(str(tmp_path / "pre"), device="cpu")
    got = back.query(q, 10)
    # the reload packs resident tiles: the same rows, scored in one pass
    msg = topk_mismatch(got[0], got[1], want[0], want[1], **SAME)
    assert msg is None, msg


def test_degraded_answers_match_jax(tmp_path):
    """A JAX tiered server and the port's load of its snapshot over the
    same tile pool (``load_index_snapshot(pool_kw=)`` sets the shards and
    the hot set): the same shard goes silent in both, the answers
    agree."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.launch import serve as jserve

    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        jidx = jserve.build_index(
            jnp.asarray(_corpus(0, N)), K, index="ivf",
            n_clusters=N_CLUSTERS, offload=True, hot_clusters=4,
            offload_shards=N_SHARDS, key=jax.random.PRNGKey(2))
        jsv = jserve.ZenServer(jidx, nprobe=N_CLUSTERS, rerank_factor=2)
        jsv.save(str(tmp_path / "server"))
        jidx.ivf.save(str(tmp_path / "pool"))
        jclock = FakeClock()
        jsv.enable_fault_tolerance(deadline_s=5.0, clock=jclock)
        q = _corpus(1, 8)
        jclock.advance(6.0)
        for s in (0, 2):
            jsv.heartbeat(s)
        want = jsv.query(jnp.asarray(q), 10)
        assert jsv.stats()["degraded_shards"] == ["shard1"]
    finally:
        jax.config.update("jax_enable_x64", prev)
    index, saved = tserve.load_index_snapshot(
        str(tmp_path / "server"), pool=str(tmp_path / "pool"), device="cpu",
        pool_kw=dict(n_shards=N_SHARDS, hot_clusters=4))
    psv = tserve.ZenServer(index, **saved)
    assert psv.index.ivf.n_shards == N_SHARDS
    assert psv.index.ivf.hot_clusters.size == 4
    pclock = FakeClock()
    psv.enable_fault_tolerance(deadline_s=5.0, clock=pclock)
    pclock.advance(6.0)
    for s in (0, 2):
        psv.heartbeat(s)
    got = psv.query(torch.from_numpy(q), 10)
    assert psv.stats()["degraded_shards"] == ["shard1"]
    msg = topk_mismatch(got[0], got[1], np.asarray(want[0]),
                        np.asarray(want[1]), **SAME)
    assert msg is None, msg
