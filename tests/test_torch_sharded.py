"""The port's sharded retrieval against the JAX package's, on the CPU.

The JAX package shards over a ``jax.sharding.Mesh`` of devices; the test
worker's JAX has one CPU device, so the reference runs once per module in
a subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(as ``tests/test_topk_retrieval.py`` does) and writes its answers to an
``.npz``. The port runs in-process on CPU meshes of logical shards
(``repro_torch.distributed.make_mesh(..., device="cpu")``).

Data: numpy, seeded; coordinates of width k = 8, up to 1,500 rows; server
corpora 1,200 x 32. Tolerances: distances rtol = atol = 1e-5, ids exact,
except the servers' answers, which go through
``repro_torch.testing.topk_mismatch`` at the same tolerance (near-ties at
the cutoff may swap: the unsharded port scans the index in one dense pass,
the sharded reference per shard). Packing and snapshots: byte-equal.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")  # absent where only the port is installed

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from repro.distributed import retrieval as jretrieval  # noqa: E402
from repro.index import ivf as jivf  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch.checkpoint import index_io  # noqa: E402
from repro_torch.distributed import make_mesh  # noqa: E402
from repro_torch.distributed import retrieval as tretrieval  # noqa: E402
from repro_torch.index import ivf as tivf  # noqa: E402
from repro_torch.kernels import quantize as tquant  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.testing import topk_mismatch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, NN = 8, 10
TOL = dict(rtol=1e-5, atol=1e-5)
STORAGES = ("float32", "bfloat16", "int8")
DEAD = [True, True, False, True]  # shard 2 silent

#: sharded_knn_search cases: (n, shift, storage, mode, mesh, dead shard 2).
#: The padding cases are the reference's own (test_topk_retrieval.py):
#: with the corpus shifted far from the origin and the queries near it,
#: padding rows would win every local slot unless masked and compensated.
KNN_CASES = (
    [(n, shift, "float32", "zen", "4", False)
     for n, shift in [(1000, 0.0), (1001, 0.0), (37, 0.0), (5, 100.0),
                      (1001, 100.0)]]
    + [(1001, 0.0, st, mode, "4", False) for st in STORAGES
       for mode in ("zen", "lwb", "upb") if (st, mode) != ("float32", "zen")]
    + [(1001, 100.0, "int8", "zen", "2x2", False),
       (1000, 0.0, "float32", "lwb", "2x2", False),
       (1001, 0.0, "float32", "zen", "4", True),
       (1001, 100.0, "int8", "upb", "4", True),
       (1001, 0.0, "bfloat16", "zen", "2x2", True)])

_SCRIPT = textwrap.dedent(r"""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.distributed.retrieval import sharded_knn_search
    from repro.index.ivf import ShardedIVFZenIndex
    from repro.kernels import quantize as quant
    from repro.launch.serve import ZenServer, build_index

    inp, outp, work = sys.argv[1:4]
    data = dict(np.load(inp))
    cases = json.loads(sys.argv[4])
    devs = np.array(jax.devices()[:4])
    meshes = {"4": Mesh(devs.reshape(4), ("shard",)),
              "2x2": Mesh(devs.reshape(2, 2), ("a", "b"))}
    dead = jnp.asarray(np.array([True, True, False, True]))
    out = {}
    for i, (n, shift, st, mode, mesh, is_dead) in enumerate(cases):
        x = data["knn_x"][:n] + np.float32(shift)
        vals, scales = quant.encode_rows(x, st)
        d, ids = sharded_knn_search(
            jnp.asarray(data["knn_q"]), jnp.asarray(vals), 10, mode,
            mesh=meshes[mesh],
            scales=None if scales is None else jnp.asarray(scales),
            alive=dead if is_dead else None)
        out[f"knn{i}_d"], out[f"knn{i}_i"] = np.asarray(d), np.asarray(ids)

    q = jnp.asarray(data["ivf_q"])
    for st in ("float32", "bfloat16", "int8"):
        idx = ShardedIVFZenIndex._from_members(
            data["ivf_coords"], data["ivf_ids"], data["ivf_assign"],
            jnp.asarray(data["ivf_cents"]), 12, 16, mesh=meshes["4"],
            storage=st)
        for tag, kw in (("", {}), ("_dead", {"alive": dead})):
            d, ids = idx.search(q, 10, nprobe=3, mode="zen", **kw)
            out[f"ivf_{st}{tag}_d"] = np.asarray(d)
            out[f"ivf_{st}{tag}_i"] = np.asarray(ids)
        idx.save(os.path.join(work, f"ivf_{st}"))

    class Clock:
        t = 0.0
        def __call__(self):
            return self.t

    corpus = jnp.asarray(data["corpus"])
    sq = jnp.asarray(data["server_q"])
    for kind, kw, srv_kw in (
            ("flat", {}, {"rerank_factor": 2}),
            ("flat_int8", {"storage": "int8"}, {}),
            ("ivf", {"index": "ivf", "n_clusters": 12}, {"nprobe": 4})):
        index = build_index(corpus, 8, mesh=meshes["4"],
                            key=jax.random.PRNGKey(3), **kw)
        srv = ZenServer(index, **srv_kw)
        d, ids = srv.query(sq, 10)
        out[f"srv_{kind}_d"], out[f"srv_{kind}_i"] = (np.asarray(d),
                                                      np.asarray(ids))
        srv.save(os.path.join(work, f"srv_{kind}"))
        # degraded: the snapshot reloaded onto the 4 devices (a reload
        # deals IVF members to shards from the snapshot's order)
        srv = ZenServer.load(os.path.join(work, f"srv_{kind}"),
                             mesh=meshes["4"])
        clock = Clock()
        srv.enable_fault_tolerance(deadline_s=5.0, clock=clock)
        for s in range(4):
            srv.heartbeat(s)
        clock.t = 6.0
        for s in (0, 1, 3):
            srv.heartbeat(s)
        d, ids = srv.query(sq, 10)
        assert srv.stats()["degraded_shards"] == ["shard2"]
        out[f"srv_{kind}_dead_d"] = np.asarray(d)
        out[f"srv_{kind}_dead_i"] = np.asarray(ids)
    np.savez(outp, **out)
    print("REFERENCE-OK")
""")


def _coords(seed, n, k=K):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, k)).astype(np.float32)
    x[:, -1] = np.abs(x[:, -1])  # the altitude column is non-negative
    return x


def _ivf_members():
    x = _coords(3, 1500)
    cents = x[:12].copy()
    assign = ((x[:, None, :] - cents[None]) ** 2).sum(-1).argmin(1)
    ids = np.random.default_rng(4).permutation(1500).astype(np.int64) + 7
    return x, ids, assign.astype(np.int64), cents


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's sharded answers and snapshots, from one
    subprocess with four forced host devices."""
    work = tmp_path_factory.mktemp("sharded_ref")
    x, ids, assign, cents = _ivf_members()
    rng = np.random.default_rng(5)
    data = dict(
        knn_x=_coords(1, 1001), knn_q=_coords(2, 6) * 0.1,
        ivf_coords=x, ivf_ids=ids, ivf_assign=assign, ivf_cents=cents,
        ivf_q=_coords(6, 7),
        corpus=rng.standard_normal((1200, 32)).astype(np.float32),
        server_q=rng.standard_normal((8, 32)).astype(np.float32))
    inp, outp = str(work / "in.npz"), str(work / "out.npz")
    np.savez(inp, **data)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", _SCRIPT, inp, outp, str(work),
         json.dumps(KNN_CASES)],
        capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0 and "REFERENCE-OK" in r.stdout, r.stderr[-3000:]
    with np.load(outp) as f:
        out = {k: f[k] for k in f.files}
    return dict(out=out, data=data, work=work)


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _equal(got, want_d, want_i):
    np.testing.assert_array_equal(_np(got[1]), want_i)
    np.testing.assert_allclose(_np(got[0]), want_d, **TOL)


def _mesh(name):
    return make_mesh(4 if name == "4" else (2, 2),
                     axis="shard" if name == "4" else ("a", "b"),
                     device="cpu")


# -- sharded_knn_search ---------------------------------------------------------


@pytest.mark.parametrize("case", range(len(KNN_CASES)),
                         ids=["-".join(map(str, c)) for c in KNN_CASES])
def test_sharded_knn_search_matches_jax(ref, case):
    n, shift, st, mode, mesh, dead = KNN_CASES[case]
    x = torch.from_numpy(ref["data"]["knn_x"][:n] + np.float32(shift))
    vals, scales = tquant.encode_rows(x, st)
    got = tretrieval.sharded_knn_search(
        torch.from_numpy(ref["data"]["knn_q"]), vals, NN, mode,
        mesh=_mesh(mesh), scales=scales, alive=DEAD if dead else None)
    _equal(got, ref["out"][f"knn{case}_d"], ref["out"][f"knn{case}_i"])


def test_presharded_rows_and_host_rows():
    """A ``ShardedRows`` from ``shard_rows`` searches as the tensor does
    (its ``n_rows`` masks the padding), ``host_rows`` strips the padding,
    and a mesh sharded over one of two axes uses that axis' devices."""
    x = torch.from_numpy(_coords(7, 1001))
    q = torch.from_numpy(_coords(8, 5))
    mesh = _mesh("4")
    rows, n_valid = tretrieval.shard_rows(x, mesh=mesh)
    assert n_valid == rows.n_rows == 1001 and rows.shape == (1004, K)
    assert [b.shape[0] for b in rows.blocks] == [251] * 4
    assert torch.equal(tretrieval.host_rows(rows), x)
    assert tretrieval.host_rows(rows, 1004).shape[0] == 1004
    a = tretrieval.sharded_knn_search(q, rows, NN, mesh=mesh)
    b = tretrieval.sharded_knn_search(q, x, NN, mesh=mesh)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    m22 = _mesh("2x2")
    assert len(m22.shard_devices("a")) == 2
    half = tretrieval.sharded_knn_search(q, x, NN, mesh=m22, axis="a")
    assert torch.equal(half[1], b[1])
    with pytest.raises(ValueError, match="row blocks"):
        tretrieval.sharded_knn_search(q, rows, NN, mesh=m22, axis="a")


def test_shards_search_only_their_real_rows(monkeypatch):
    """Each shard's kernel sees its real rows alone, at the merge width:
    the zero padding (the tail of the last block) is never searched, so
    no shard fetches past n (the width that picks the card's plan)."""
    from repro_torch.kernels import ops

    calls = []
    real = ops.zen_topk

    def recording(q, x, n, *a, **kw):
        calls.append((x.shape[0], n))
        return real(q, x, n, *a, **kw)

    monkeypatch.setattr(ops, "zen_topk", recording)
    x = torch.from_numpy(_coords(7, 1001))
    q = torch.from_numpy(_coords(8, 5))
    got = tretrieval.sharded_knn_search(q, x, NN, mesh=_mesh("4"))
    assert calls == [(251, NN)] * 3 + [(248, NN)]
    calls.clear()
    tretrieval.sharded_knn_search(q, x[:5], NN, mesh=_mesh("4"))
    assert calls == [(2, 2), (2, 2), (1, 1)]  # shard 3 holds only padding
    one = tretrieval.sharded_knn_search(q, x, NN,
                                        mesh=make_mesh(1, device="cpu"))
    assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])


# -- the merge's selection ---------------------------------------------------------


def _candidates(seed, q=5, w=24):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 6, (q, w)).astype(np.float32)  # many exact ties
    ids = rng.permutation(q * w).reshape(q, w).astype(np.int32)
    fill = rng.uniform(size=(q, w)) < 0.3               # (+inf, -1) slots
    d[fill], ids[fill] = np.inf, -1
    d[0, :3] = np.inf                                   # +inf, real ids
    return d, ids


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lex_topk_equals_jnp_lexsort_order(seed):
    d, ids = _candidates(seed)
    for k in (1, 7, 24):
        want = jretrieval._lex_topk(jnp.asarray(d), jnp.asarray(ids), k)
        got = tretrieval._lex_topk(torch.from_numpy(d), torch.from_numpy(ids),
                                   k)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("seed", [3, 4])
def test_lex_topk_is_invariant_under_column_permutations(seed):
    d, ids = _candidates(seed)
    want = tretrieval._lex_topk(torch.from_numpy(d), torch.from_numpy(ids), 9)
    rng = np.random.default_rng(seed)
    for _ in range(5):
        p = rng.permutation(d.shape[1])
        got = tretrieval._lex_topk(torch.from_numpy(d[:, p]),
                                   torch.from_numpy(ids[:, p]), 9)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# -- packing -----------------------------------------------------------------------


@pytest.mark.parametrize("order", ["input", "by_cluster"])
@pytest.mark.parametrize("n_shards", [1, 3, 4])
@pytest.mark.parametrize("storage", STORAGES)
def test_pack_sharded_tiles_bytes_equal_jax(storage, n_shards, order):
    x, ids, assign, _ = _ivf_members()
    if order == "by_cluster":
        o = np.argsort(assign, kind="stable")
        x, ids, assign = x[o], ids[o], assign[o]
    vals, _ = tquant.encode_rows(torch.from_numpy(x), storage)
    tc, ti, T = tivf._pack_sharded_tiles(vals, torch.from_numpy(assign),
                                         torch.from_numpy(ids), 12, n_shards,
                                         16)
    jvals = jivf._coerce_member_storage(x, assign, 12, storage, None)[0] \
        if storage != "int8" else vals.numpy()
    wc, wi, wT = jivf._pack_sharded_tiles(np.asarray(jvals), assign, ids, 12,
                                          n_shards, 16)
    assert T == wT and tc.shape[0] == n_shards * 12 * T
    np.testing.assert_array_equal(ti.numpy(), wi)
    if storage == "bfloat16":
        np.testing.assert_array_equal(tc.view(torch.int16).numpy(),
                                      wc.view(np.int16))
    else:
        np.testing.assert_array_equal(tc.numpy(), wc)


# -- ShardedIVFZenIndex --------------------------------------------------------------


def _port_sharded_ivf(storage, mesh=None):
    x, ids, assign, cents = _ivf_members()
    return tivf.ShardedIVFZenIndex._from_members(
        torch.from_numpy(x), ids, assign, torch.from_numpy(cents), 12, 16,
        mesh=mesh or _mesh("4"), storage=storage)


@pytest.mark.parametrize("storage", STORAGES)
def test_sharded_ivf_search_matches_jax(ref, storage):
    idx = _port_sharded_ivf(storage)
    q = torch.from_numpy(ref["data"]["ivf_q"])
    for tag, kw in (("", {}), ("_dead", {"alive": DEAD})):
        _equal(idx.search(q, NN, nprobe=3, mode="zen", **kw),
               ref["out"][f"ivf_{storage}{tag}_d"],
               ref["out"][f"ivf_{storage}{tag}_i"])
    # shard 2 dead: none of its tile ids answers
    held = set(idx.tile_ids.blocks[2].ravel().tolist()) - {-1}
    got = idx.search(q, NN, nprobe=3, alive=DEAD)[1]
    assert not held & set(got.ravel().tolist())


@pytest.mark.parametrize("storage", STORAGES)
def test_sharded_ivf_save_bytes_equal_jax(ref, storage, tmp_path):
    """The port's save from 4 shards writes the arrays the reference's
    save from 4 devices wrote, byte for byte; it reloads onto 2 shards and
    onto one device with the same answers."""
    idx = _port_sharded_ivf(storage)
    idx.save(str(tmp_path / "ivf"))
    got, gmeta = index_io.load_state(str(tmp_path / "ivf"),
                                     expect_kind=tivf.IVF_SNAPSHOT_KIND)
    want, wmeta = index_io.load_state(str(ref["work"] / f"ivf_{storage}"),
                                      expect_kind=tivf.IVF_SNAPSHOT_KIND)
    assert gmeta == wmeta and sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(np.asarray(got[name]),
                                      np.asarray(want[name]), err_msg=name)
    q = torch.from_numpy(ref["data"]["ivf_q"])
    base = idx.search(q, NN, nprobe=3)
    two = tivf.ShardedIVFZenIndex.load(str(tmp_path / "ivf"),
                                       mesh=make_mesh(2, device="cpu"))
    one = tivf.IVFZenIndex.load(str(tmp_path / "ivf"), device="cpu")
    for other in (two.search(q, NN, nprobe=3), one.search(q, NN, nprobe=3)):
        msg = topk_mismatch(other[0], other[1], base[0], base[1], **TOL)
        assert msg is None, msg


# -- servers -------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["flat", "flat_int8", "ivf"])
def test_jax_sharded_snapshot_serves_on_any_shard_count(ref, kind, tmp_path):
    """A snapshot of the JAX package's 4-device sharded server, loaded on
    no mesh, 2 shards and 4 shards, answers as the JAX server did, and on
    4 shards with shard 2 silent as the JAX package's reload of it onto 4
    devices did with shard 2 silent; the port's 4-shard save reloads onto
    2 shards with the same bits."""
    snap = str(ref["work"] / f"srv_{kind}")
    q = torch.from_numpy(ref["data"]["server_q"])
    want = (ref["out"][f"srv_{kind}_d"], ref["out"][f"srv_{kind}_i"])
    servers = {}
    for name, kw in (("none", {"device": "cpu"}),
                     ("2", {"mesh": make_mesh(2, device="cpu")}),
                     ("4", {"mesh": make_mesh(4, device="cpu")})):
        servers[name] = tserve.ZenServer.load(snap, **kw)
        got = servers[name].query(q, NN)
        msg = topk_mismatch(got[0], got[1], *want, **TOL)
        assert msg is None, (name, msg)
    srv = servers["4"]
    clock = _Clock()
    srv.enable_fault_tolerance(deadline_s=5.0, clock=clock)
    for s in range(4):
        srv.heartbeat(s)
    clock.t = 6.0
    for s in (0, 1, 3):
        srv.heartbeat(s)
    got = srv.query(q, NN)
    assert srv.stats()["degraded_shards"] == ["shard2"]
    msg = topk_mismatch(got[0], got[1], ref["out"][f"srv_{kind}_dead_d"],
                        ref["out"][f"srv_{kind}_dead_i"], **TOL)
    assert msg is None, msg
    for s in range(4):
        srv.heartbeat(s)
    healthy = srv.query(q, NN)
    srv.save(str(tmp_path / "port4"))
    back = tserve.ZenServer.load(str(tmp_path / "port4"),
                                 mesh=make_mesh(2, device="cpu"))
    again = back.query(q, NN)
    assert torch.equal(again[0], healthy[0])
    assert torch.equal(again[1], healthy[1])


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_degraded_mesh_flat_serving():
    """The reference's degraded-mesh flat test, on the port: the dead
    shard's rows vanish from the answers and queries never raise."""
    from repro_torch.data import synthetic as syn

    gen = torch.Generator().manual_seed(31)
    corpus = syn.manifold_space(1024, 32, 4, generator=gen)
    index = tserve.build_index(corpus, 8, mesh=make_mesh(4, device="cpu"),
                               generator=torch.Generator().manual_seed(0))
    srv = tserve.ZenServer(index)
    clock = _Clock()
    srv.enable_fault_tolerance(deadline_s=5.0, clock=clock)
    for s in range(4):
        srv.heartbeat(s)
    q = syn.manifold_space(8, 32, 4, generator=gen)
    d0, i0 = srv.query(q, 10)
    clock.t = 6.0
    for s in (0, 1, 3):
        srv.heartbeat(s)
    d1, i1 = srv.query(q, 10)
    assert srv.stats()["degraded_shards"] == ["shard2"]
    assert torch.isfinite(d1).any()
    # shard 2 owns rows [512, 768): none may appear while it is dead
    hits = i1.ravel()
    assert not ((hits >= 512) & (hits < 768)).any()
    assert not torch.equal(i0, i1)


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_frontend_answers_are_bit_equal_on_a_sharded_server(kind):
    """Coalesced, cached and direct answers on a 4-shard server carry the
    same bits, as on a single-device one."""
    rng = np.random.default_rng(9)
    corpus = torch.from_numpy(rng.standard_normal((900, 32))
                              .astype(np.float32))
    queries = torch.from_numpy(rng.standard_normal((6, 32))
                               .astype(np.float32))
    kw = {"index": "ivf", "n_clusters": 10} if kind == "ivf" else {}
    index = tserve.build_index(corpus, 8, mesh=make_mesh(4, device="cpu"),
                               generator=torch.Generator().manual_seed(0),
                               **kw)
    server = tserve.ZenServer(index, frontend=True, cache_size=64, nprobe=4,
                              rerank_factor=2, clock=_Clock())
    sched = server.frontend
    handles = [sched.submit(queries[i], NN) for i in range(6)]
    assert sched.tick() == 1  # one coalesced dispatch
    whole = server.query(queries, NN, direct=True)
    for i, h in enumerate(handles):
        d, ids = h.result()
        direct = server.query(queries[i:i + 1], NN, direct=True)
        for got in ((torch.from_numpy(d), torch.from_numpy(ids)), direct):
            assert torch.equal(got[0].reshape(-1), whole[0][i])
            assert torch.equal(got[1].reshape(-1), whole[1][i])
    hits = sched.cache.hits
    again = [sched.submit(queries[i], NN) for i in range(6)]
    sched.tick()
    assert sched.cache.hits == hits + 6
    for i, h in enumerate(again):
        assert np.array_equal(h.result()[1].reshape(-1), whole[1][i].numpy())


# -- refusals --------------------------------------------------------------------


def _raised(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value), str(e.value)


def test_refusals_raise_as_the_jax_package_does():
    """Mutating a sharded index, PQ storage on a mesh and offload with a
    mesh raise the reference's exceptions, message for message."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((64, 12)).astype(np.float32)
    jmesh = JMesh(np.array(jax.devices()[:1]), ("shard",))
    tmesh = make_mesh(1, device="cpu")
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for kw in ({"index": "ivf", "storage": "pq"},
               {"index": "ivf", "offload": True}):
        assert _raised(lambda: jserve.build_index(jx, 4, mesh=jmesh, **kw)) \
            == _raised(lambda: tserve.build_index(tx, 4, mesh=tmesh, **kw))
    members = (x, np.arange(64), np.zeros(64, np.int64))
    assert _raised(lambda: jivf.ShardedIVFZenIndex._from_members(
        *members, jnp.asarray(x[:1]), 1, 16, mesh=jmesh, storage="pq")) == \
        _raised(lambda: tivf.ShardedIVFZenIndex._from_members(
            torch.from_numpy(x), *members[1:], torch.from_numpy(x[:1]), 1,
            16, mesh=tmesh, storage="pq"))
    for kw in ({}, {"index": "ivf", "n_clusters": 4}):
        jsrv = jserve.ZenServer(jserve.build_index(jx, 4, mesh=jmesh, **kw))
        tsrv = tserve.ZenServer(tserve.build_index(
            tx, 4, mesh=tmesh, generator=torch.Generator().manual_seed(0),
            **kw))
        for op in (lambda s: s.delete([1]),
                   lambda s: s.upsert([70], x[:1]),
                   lambda s: s.compact()):
            want = _raised(lambda: op(jsrv))
            assert want[0] is NotImplementedError
            assert _raised(lambda: op(tsrv)) == want
        assert not tsrv.index.needs_compact()
    with pytest.raises(NotImplementedError, match="reloading"):
        tsrv.index.to("cpu")
