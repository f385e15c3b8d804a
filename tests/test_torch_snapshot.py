"""The port's snapshots against the JAX package's, on the CPU.

``repro_torch.checkpoint.index_io`` is held to the behaviour of
``repro.checkpoint.index_io`` (atomic publish, version/kind/corruption
checks, crash windows), and the two packages' snapshots to each other in
both directions: one state handed to both (``repro_torch.convert``) writes
byte-equal files, a directory either package wrote loads in the other and
answers as the writer did, and a load followed by a save gives the same
bytes again. Inputs are seeded numpy arrays.

Tolerances: files, manifests and restored arrays are compared byte for
byte. Answers of the two packages on one state: ids equal except where a
swap is a near-tie, distances to rtol 1e-5 / atol 1e-5 (the same f32
estimator and re-rank in another reduction order;
``repro_torch.testing.topk_mismatch``). Answers of one package before and
after its own save/load: bit-equal.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")  # absent where only the port is installed

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import index_io as jio  # noqa: E402
from repro.index import ivf as jivf  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    INDEX_FORMAT_VERSION, CheckpointFormatError, load_state, save_state,
    write_json_atomic,
)
from repro_torch.checkpoint import index_io as tio  # noqa: E402
from repro_torch.index import ivf as tivf  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.testing import topk_mismatch  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
K, NN, N_CLUSTERS = 8, 10, 12
SERVER_KW = dict(rerank_factor=4, nprobe=4, chunk=128)


@pytest.fixture(autouse=True)
def _x32():
    """Other test modules flip ``jax_enable_x64`` on at import."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _files(directory):
    """name -> bytes of every file of a snapshot directory."""
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as f:
            out[name] = f.read()
    return out


def _assert_same_files(a, b):
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    for name in fa:
        assert fa[name] == fb[name], name


def _np(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _close(got, want, tol=TOL):
    msg = topk_mismatch(got[0], got[1], _np(want[0]), _np(want[1]), **tol)
    assert msg is None, msg


def _bit_equal(got, want):
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))


# -- the generic store ---------------------------------------------------------


def test_index_io_roundtrip_and_atomic_overwrite(tmp_path):
    d = str(tmp_path / "snap")
    arrays = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
              "b.x-1": np.ones(4, np.float32)}
    save_state(d, arrays, {"note": "v1"}, kind="test")
    back, meta = load_state(d, expect_kind="test")
    assert meta == {"note": "v1"}
    assert np.array_equal(back["a"], arrays["a"])
    assert np.array_equal(back["b.x-1"], arrays["b.x-1"])
    save_state(d, {"a": np.zeros(1, np.int8)}, {"note": "v2"}, kind="test")
    back, meta = load_state(d)
    assert meta == {"note": "v2"} and list(back) == ["a"]
    assert not any(p.startswith(("tmp.", "old.")) for p in
                   os.listdir(tmp_path))


def test_index_io_rejects_unsafe_names_and_missing(tmp_path):
    with pytest.raises(ValueError, match="unsafe"):
        save_state(str(tmp_path / "s"), {"../evil": np.zeros(1)}, {},
                   kind="test")
    with pytest.raises(FileNotFoundError):
        load_state(str(tmp_path / "nothing"))


def _tamper(directory, **updates):
    path = os.path.join(directory, "manifest.json")
    with open(path) as f:
        m = json.load(f)
    m.update(updates)
    with open(path, "w") as f:
        json.dump(m, f)


def test_index_io_version_and_kind_rejection(tmp_path):
    d = str(tmp_path / "snap")
    save_state(d, {"a": np.zeros(2)}, {}, kind="test")
    _tamper(d, version=INDEX_FORMAT_VERSION + 1)
    with pytest.raises(CheckpointFormatError, match="version"):
        load_state(d)
    _tamper(d, version=1)  # v1 is a strict subset of v3 and still loads
    back, _ = load_state(d)
    assert list(back) == ["a"]
    _tamper(d, version=INDEX_FORMAT_VERSION, format="something-else")
    with pytest.raises(CheckpointFormatError, match="format"):
        load_state(d)
    _tamper(d, format="zen-index")
    with pytest.raises(CheckpointFormatError, match="kind"):
        load_state(d, expect_kind="other-kind")


def test_index_io_detects_corrupt_array(tmp_path):
    d = str(tmp_path / "snap")
    save_state(d, {"a": np.zeros((3, 3), np.float32),
                   "h": torch.zeros(4, dtype=torch.bfloat16)}, {},
               kind="test")
    np.save(os.path.join(d, "a.npy"), np.zeros(2, np.int16))
    with pytest.raises(CheckpointFormatError, match="'a'"):
        load_state(d)
    save_state(d, {"h": torch.zeros(4, dtype=torch.bfloat16)}, {},
               kind="test")
    np.save(os.path.join(d, "h.npy"), np.zeros(4, np.float16))
    with pytest.raises(CheckpointFormatError, match="'h'"):
        load_state(d)


def test_write_json_atomic_replaces_without_torn_state(tmp_path):
    path = str(tmp_path / "PUBLISHED.json")
    write_json_atomic(path, {"generation": 1})
    with open(path) as f:
        assert json.load(f) == {"generation": 1}
    with open(path + ".crashed", "w") as f:
        f.write('{"generation":')  # torn JSON, never renamed into place
    (tmp_path / "tmp.PUBLISHED.json").write_text("{half")
    write_json_atomic(path, {"generation": 2})
    with open(path) as f:
        assert json.load(f) == {"generation": 2}
    assert not (tmp_path / "tmp.PUBLISHED.json").exists()


def test_snapshot_publish_crash_windows_leave_loadable_state(tmp_path):
    d = str(tmp_path / "gen-000000000007")
    arrays = {"a": np.arange(12, dtype=np.float32)}
    save_state(d, arrays, {"generation": 7}, kind="test")
    staging = tmp_path / "tmp.gen-000000000008"  # killed while staging
    os.makedirs(staging)
    np.save(staging / "a.npy", np.zeros(3, np.float32))
    backup = tmp_path / "old.gen-000000000007"  # killed between renames
    os.makedirs(backup)
    (backup / "manifest.json").write_text("{}")
    (tmp_path / "tmp.PUBLISHED.json").write_text('{"generation": 8, "snap')
    back, meta = load_state(d, expect_kind="test")
    assert meta == {"generation": 7}
    np.testing.assert_array_equal(back["a"], arrays["a"])
    with pytest.raises(FileNotFoundError):
        load_state(str(staging))
    # the next publish over the same name replaces the stale backup
    save_state(d, {"a": np.ones(2, np.float32)}, {"generation": 8},
               kind="test")
    assert load_state(d)[1] == {"generation": 8}
    assert not backup.exists()


def test_index_io_files_equal_the_reference_bf16_included(tmp_path):
    """The same arrays and meta give byte-equal files, manifest included;
    bf16 goes to disk as its uint16 bits under a "bfloat16" entry and comes
    back as those bits (the reference views them as ml_dtypes bf16)."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((5, 3)).astype(np.float32)
    bf = jnp.asarray(f32).astype(jnp.bfloat16)
    meta = {"n": 3, "storage": "bfloat16", "nested": {"x": [1, 2]}}
    common = {"i8": np.arange(-4, 4, dtype=np.int8),
              "u8": np.arange(7, dtype=np.uint8),
              "i32": np.arange(6, dtype=np.int32).reshape(2, 3)}
    jio.save_state(str(tmp_path / "j"), {**common, "f": f32,
                                         "h": np.asarray(bf)}, meta,
                   kind="test")
    save_state(str(tmp_path / "t"), {**common, "f": torch.from_numpy(f32),
                                     "h": torch.from_numpy(f32).to(
                                         torch.bfloat16)}, meta, kind="test")
    _assert_same_files(tmp_path / "j", tmp_path / "t")
    back, _ = load_state(str(tmp_path / "j"))
    assert back["h"].dtype == np.uint16
    np.testing.assert_array_equal(back["h"], _np(bf))
    t = tio.to_tensor(back["h"], "cpu", bfloat16=True)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(t), _np(bf))
    jback, _ = jio.load_state(str(tmp_path / "t"), mmap=True)
    np.testing.assert_array_equal(_np(jback["h"]), _np(bf))


# -- IVF index snapshots -------------------------------------------------------


def _coords(seed, n, k):
    x = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    x[:, -1] = np.abs(x[:, -1])
    return x


def _jax_ivf(storage, churn, seed=3):
    x = _coords(seed, 900, K)
    idx = jivf.IVFZenIndex.build(jnp.asarray(x), N_CLUSTERS,
                                 key=jax.random.PRNGKey(seed),
                                 storage=storage, pq_m=4)
    if churn:
        idx = idx.delete(list(range(0, 900, 7)))
        idx = idx.upsert(list(range(900, 960)) + [1, 2],
                         jnp.asarray(_coords(seed + 1, 62, K)))
    return x, idx


def _port_ivf(jidx):
    return convert.ivf_index_from_arrays(
        None, centroids=np.asarray(jidx.centroids),
        tile_coords=np.asarray(jidx.tile_coords),
        tile_ids=np.asarray(jidx.tile_ids),
        tiles_per_cluster=jidx.tiles_per_cluster, tile_rows=jidx.tile_rows,
        n_valid=jidx.n_valid, n_deleted=jidx.n_deleted, storage=jidx.storage,
        tile_scales=(None if jidx.tile_scales is None
                     else np.asarray(jidx.tile_scales)),
        codebooks=(None if jidx.codebooks is None
                   else np.asarray(jidx.codebooks)),
        generation=int(jidx.generation), device="cpu").ivf


@pytest.mark.parametrize("churn", [False, True])
@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8", "pq"])
def test_ivf_snapshot_across_packages(tmp_path, storage, churn):
    x, jidx = _jax_ivf(storage, churn)
    pidx = _port_ivf(jidx)
    jdir, pdir, again = (str(tmp_path / n) for n in ("j", "p", "again"))
    jidx.save(jdir)
    pidx.save(pdir)
    _assert_same_files(jdir, pdir)
    q = x[:8] + 0.05 * _coords(9, 8, K)
    # a JAX snapshot in the port: the reference's answers, and the same
    # bytes when saved again
    back = tivf.IVFZenIndex.load(jdir, device="cpu")
    assert (back.size, back.storage, back.generation) == (
        jidx.n_valid, storage, int(jidx.generation))
    want = jidx.search(jnp.asarray(q), n_neighbors=NN, nprobe=6)
    _close(back.search(torch.from_numpy(q), NN, 6), want)
    back.save(again)
    _assert_same_files(jdir, again)
    # the port's snapshot in JAX
    jback = jivf.IVFZenIndex.load(pdir)
    _bit_equal(jback.search(jnp.asarray(q), n_neighbors=NN, nprobe=6),
               jivf.IVFZenIndex.load(jdir).search(
                   jnp.asarray(q), n_neighbors=NN, nprobe=6))
    with pytest.raises(CheckpointFormatError, match="kind"):
        tivf.TieredIVFZenIndex.load(pdir, device="cpu")


def test_ivf_load_overrides_tile_rows(tmp_path):
    _, jidx = _jax_ivf("int8", False)
    _port_ivf(jidx).save(str(tmp_path / "s"))
    back = tivf.IVFZenIndex.load(str(tmp_path / "s"), tile_rows=32,
                                 device="cpu")
    assert back.tile_rows == 32 and back.size == jidx.n_valid
    want = jivf.IVFZenIndex.load(str(tmp_path / "s"), tile_rows=32)
    np.testing.assert_array_equal(_np(back.tile_coords),
                                  _np(want.tile_coords))
    np.testing.assert_array_equal(_np(back.tile_ids), _np(want.tile_ids))


# -- server snapshots ----------------------------------------------------------


def _jax_server(index, storage, churn):
    rng = np.random.default_rng(5)
    corpus = rng.standard_normal((800, 24)).astype(np.float32)
    kw = dict(n_clusters=N_CLUSTERS) if index == "ivf" else {}
    jidx = jserve.build_index(jnp.asarray(corpus), K, index=index,
                              storage=storage, key=jax.random.PRNGKey(7),
                              **kw)
    server = jserve.ZenServer(jidx, **SERVER_KW)
    if churn:
        server.delete(list(range(0, 800, 9)))
        server.upsert(list(range(3, 8)) + [800, 801, 805],
                      jnp.asarray(rng.standard_normal((8, 24)).astype(
                          np.float32)))
    queries = rng.standard_normal((6, 24)).astype(np.float32)
    return server, queries


def _port_server(jserver):
    """The JAX server's exact state (transform, index, corpus, settings)
    in the port."""
    j = jserver.index
    tr = j.transform
    ptr = convert.transform_from_arrays(
        refs=np.asarray(tr.refs), chol=np.asarray(tr.base.chol),
        diag_g=np.asarray(tr.base.diag_g), d0=np.asarray(tr.base.d0),
        k=tr.k, metric=tr.metric, jitter=tr.jitter, device="cpu")
    if j.ivf is not None:
        iv = j.ivf
        index = convert.ivf_index_from_arrays(
            ptr, centroids=np.asarray(iv.centroids),
            tile_coords=np.asarray(iv.tile_coords),
            tile_ids=np.asarray(iv.tile_ids),
            tiles_per_cluster=iv.tiles_per_cluster, tile_rows=iv.tile_rows,
            n_valid=iv.n_valid, n_deleted=iv.n_deleted, storage=iv.storage,
            tile_scales=(None if iv.tile_scales is None
                         else np.asarray(iv.tile_scales)),
            codebooks=(None if iv.codebooks is None
                       else np.asarray(iv.codebooks)),
            generation=int(iv.generation), corpus=np.asarray(j.corpus),
            device="cpu")
        index = dataclasses.replace(index, generation=int(j.generation))
    else:
        index = convert.index_from_arrays(
            ptr, coords=np.asarray(j.coords), storage=j.storage,
            coord_scales=(None if j.coord_scales is None
                          else np.asarray(j.coord_scales)),
            row_ids=None if j.row_ids is None else np.asarray(j.row_ids),
            n_valid=j.n_valid, n_deleted=j.n_deleted,
            corpus=np.asarray(j.corpus), generation=int(j.generation),
            device="cpu")
    return tserve.ZenServer(index, **SERVER_KW)


SERVER_CASES = ([("flat", s) for s in ("float32", "bfloat16", "int8")]
                + [("ivf", s) for s in ("float32", "bfloat16", "int8",
                                        "pq")])


@pytest.mark.parametrize("churn", [False, True])
@pytest.mark.parametrize("index,storage", SERVER_CASES)
def test_server_snapshot_across_packages(tmp_path, index, storage, churn):
    jsv, q = _jax_server(index, storage, churn)
    psv = _port_server(jsv)
    jdir, pdir, again = (str(tmp_path / n) for n in ("j", "p", "again"))
    jsv.save(jdir)
    psv.save(pdir)
    _assert_same_files(jdir, pdir)
    want = jsv.query(jnp.asarray(q), NN)
    _close(psv.query(torch.from_numpy(q), NN), want)
    # the JAX snapshot served by the port, saved again byte for byte
    back = tserve.ZenServer.load(jdir, device="cpu")
    assert (back.rerank_factor, back.nprobe, back.chunk) == (4, 4, 128)
    assert back.index.generation == jsv.index.generation
    got = back.query(torch.from_numpy(q), NN)
    _close(got, want)
    _bit_equal(got, psv.query(torch.from_numpy(q), NN))
    back.save(again)
    _assert_same_files(jdir, again)
    # the port's snapshot served by JAX
    _bit_equal(jserve.ZenServer.load(pdir).query(jnp.asarray(q), NN), want)


@pytest.mark.parametrize("index", ["flat", "ivf"])
def test_port_built_server_loads_in_jax(tmp_path, index):
    """A server the port fitted itself: its snapshot loads in JAX with the
    same answers, and JAX writes it back byte for byte."""
    rng = np.random.default_rng(8)
    corpus = torch.from_numpy(rng.standard_normal((700, 20)).astype(
        np.float32))
    q = rng.standard_normal((5, 20)).astype(np.float32)
    pidx = tserve.build_index(corpus, K, index=index, storage="int8",
                              n_clusters=10, device="cpu",
                              generator=torch.Generator().manual_seed(2))
    psv = tserve.ZenServer(pidx, **SERVER_KW)
    psv.delete([3, 4, 5])
    psv.save(str(tmp_path / "p"))
    jsv = jserve.ZenServer.load(str(tmp_path / "p"))
    _close(psv.query(torch.from_numpy(q), NN),
           jsv.query(jnp.asarray(q), NN))
    jsv.save(str(tmp_path / "j"))
    _assert_same_files(tmp_path / "p", tmp_path / "j")
    back = tserve.ZenServer.load(str(tmp_path / "p"), device="cpu",
                                 mmap=True, rerank_factor=0)
    assert back.rerank_factor == 0 and back.nprobe == 4
    _bit_equal(back.index.transform.transform(torch.from_numpy(q)),
               psv.index.transform.transform(torch.from_numpy(q)))


def test_server_restores_a_tiered_pool(tmp_path):
    """``load(pool=...)`` serves the IVF tier off a memory-mapped tile
    pool: the answers of the tiered server that was saved."""
    jsv, q = _jax_server("ivf", "float32", False)
    psv = _port_server(jsv)
    tiered = tivf.TieredIVFZenIndex.from_index(psv.index.ivf,
                                               hot_clusters=3)
    tsv = tserve.ZenServer(dataclasses.replace(psv.index, ivf=tiered),
                           **SERVER_KW)
    want = tsv.query(torch.from_numpy(q), NN)
    tsv.save(str(tmp_path / "server"))
    tiered.save(str(tmp_path / "pool"))
    _assert_same_files(tmp_path / "server", _saved(psv, tmp_path / "res"))
    back = tserve.ZenServer.load(str(tmp_path / "server"), mmap=True,
                                 pool=str(tmp_path / "pool"), device="cpu")
    assert isinstance(back.index.ivf, tivf.TieredIVFZenIndex)
    assert isinstance(back.index.ivf.host_coords, np.memmap)
    _bit_equal(back.query(torch.from_numpy(q), NN), want)
    assert back.stats()["tier"]["cold_uploads"] > 0
    flat, _ = _jax_server("flat", "float32", False)
    _port_server(flat).save(str(tmp_path / "flat"))
    with pytest.raises(ValueError, match="flat index"):
        tserve.ZenServer.load(str(tmp_path / "flat"),
                              pool=str(tmp_path / "pool"), device="cpu")


def _saved(server, path):
    server.save(str(path))
    return path


def test_unported_snapshot_options_raise(tmp_path):
    """A snapshot of a JAX server with the frontend on loads with its
    frontend settings (it raised while the frontend was unported), and
    onto a CPU mesh of 2 logical shards (it raised while mesh sharding,
    ROADMAP A4, was unported) with the same answers."""
    jsv, q = _jax_server("flat", "float32", False)
    jsv.frontend = object()  # saved as a server with the frontend on
    jsv.max_batch, jsv.cache_size = 32, 256
    jsv.save(str(tmp_path / "fe"))
    back = tserve.ZenServer.load(str(tmp_path / "fe"), device="cpu")
    assert back.frontend is not None
    assert (back.max_batch, back.cache_size) == (32, 256)
    assert back.frontend.cache.capacity == 256
    jsv.frontend = None
    _close(back.query(torch.from_numpy(q), NN),
           jsv.query(jnp.asarray(q), NN))
    from repro_torch.distributed import make_mesh

    sharded = tserve.ZenServer.load(str(tmp_path / "fe"),
                                    mesh=make_mesh(2, device="cpu"))
    assert sharded.index.mesh is not None and sharded.frontend is not None
    _close(sharded.query(torch.from_numpy(q), NN),
           jsv.query(jnp.asarray(q), NN))


def test_cli_checkpoint_roundtrip_with_offload(tmp_path, capsys):
    """First run builds (tiered) and saves; the second restores the same
    server from the snapshot and reaches the same recall."""
    args = ["--device", "cpu", "--index", "ivf", "--offload", "--checkpoint",
            str(tmp_path / "ck"), "--n", "2000", "--dim", "32", "--k", "8",
            "--queries", "8", "--batches", "2"]
    tserve.main(args)
    first = capsys.readouterr().out
    assert "saved snapshot" in first and "'tier'" in first
    tserve.main(args)
    second = capsys.readouterr().out
    assert "restored server" in second

    def rec(out):
        return float(out.split("recall@10: ")[1].split()[0])

    assert rec(first) == rec(second) > 0.5
