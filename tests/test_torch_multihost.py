"""The trainer's mesh spread over processes (``--multihost``) on the CPU:
two processes of two logical shards each, and four of one, over gloo,
against one process of four shards, and against the JAX package's step.

The processes are spawned once for the file (the ``runs`` fixture): a
``torch.multiprocessing`` pair through a ``file://`` store runs every job
below in one process group (``tests/_multihost_worker.py``), while this
process runs the one-process side and the reference step; the CLI is
started meanwhile as two ``python -m repro_torch.launch.train
--multihost`` processes with the launcher's environment. Every spawn has
a wall-clock limit below the process group's timeout.

* **bits**: the reduced granite-8b and qwen2-moe-a2.7b (the MoE path),
  MACE and dlrm-rm2 for 3 steps through ``train()``, on 1 x 4 (the model
  axis crosses the processes) and 2 x 2 (the data axis crosses), the
  latter also with ``--compress-grads``: every loss on both processes
  and every leaf of the final ``state_tree`` ``torch.equal`` to one
  process's; granite-8b on 1 x 4 and 2 x 2 and qwen2-moe-a2.7b on 1 x 4
  also on four processes (a second spawn, beside the first);
* **the reference**: one 1 x 4 step on the reference's weights
  (``convert.transformer_from_arrays``) against its value_and_grad +
  AdamW step, at ``tests/test_torch_sharded_train.py``'s tolerances (loss
  rtol 1e-5, step rtol 1e-4 / atol 1e-6, elements whose gradient is
  within 1e-6 of zero within 2 lr);
* **checkpoints**: the two processes' files byte-equal to one process's;
  each layout resumes the other's save to the same next-step bits;
* **agreed decisions**: a preemption announced on process 1 alone makes
  both save at the same step and stop;
* **the CLI** prints one process's losses on both processes.
"""
import os
import re
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
mp = pytest.importorskip("torch.multiprocessing")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _multihost_worker as worker  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.checkpoint import flat_state, leaf_paths  # noqa: E402,E501
from repro_torch.distributed import partition, process  # noqa: E402
from repro_torch.distributed.mesh import make_process_mesh  # noqa: E402
from repro_torch.distributed.sharding import P  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
#: seconds a spawn may take (below the worker's process-group timeout)
WALL_S = 120
ENV_NAMES = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
             "MASTER_ADDR", "MASTER_PORT")

LM = ["--seq", "16", "--batch", "2"]
MOE = ["--seq", "32"]  # a data replica holds whole MoE groups
BIT_CASES = {
    "granite-1x4": ["--arch", "granite-8b", "--data-shards", "1",
                    "--model-shards", "4", *LM],
    "granite-2x2": ["--arch", "granite-8b", "--data-shards", "2",
                    "--model-shards", "2", *LM],
    "granite-2x2-compressed": ["--arch", "granite-8b", "--data-shards", "2",
                               "--model-shards", "2", "--compress-grads",
                               *LM],
    "moe-1x4": ["--arch", "qwen2-moe-a2.7b", "--data-shards", "1",
                "--model-shards", "4", *MOE],
    "moe-2x2-compressed": ["--arch", "qwen2-moe-a2.7b", "--data-shards", "2",
                           "--model-shards", "2", "--compress-grads", *MOE],
    "mace-1x4": ["--arch", "mace", "--data-shards", "1", "--model-shards",
                 "4", "--batch", "2"],
    "mace-2x2-compressed": ["--arch", "mace", "--data-shards", "2",
                            "--model-shards", "2", "--compress-grads",
                            "--batch", "2"],
    "dlrm-1x4": ["--arch", "dlrm-rm2", "--data-shards", "1",
                 "--model-shards", "4"],
    "dlrm-2x2-compressed": ["--arch", "dlrm-rm2", "--data-shards", "2",
                            "--model-shards", "2", "--compress-grads"],
}
#: the cases also run on four processes of one logical shard each
FOUR_CASES = ("granite-1x4", "granite-2x2", "moe-1x4")
COMMON = ["--reduced", "--device", "cpu", "--steps", "3"]
CKPT = BIT_CASES["granite-1x4"]
REF_ARCH, REF_B, REF_S = "granite-8b", 4, 32
STEP = dict(rtol=1e-4, atol=1e-6)
GRAD_FLOOR = 1e-6


def _argv(case, *extra):
    return [*COMMON, *BIT_CASES[case], *extra]


def _one_process(argv):
    out = ttrain.train(ttrain.parse_args(argv), log=lambda *a: None)
    return {"losses": out["losses"], "start": out["start_step"],
            "leaves": {n: x.gather("cpu") for n, x in
                       leaf_paths(out["trainer"].state_tree())}}


def _arrays():
    """Weights in the reference's pytree layout (the port's
    ``init_params`` from a seed, as numpy) and tokens (numpy draws)."""
    from repro_torch import configs
    from repro_torch.checkpoint.checkpoint import nest_state
    from repro_torch.models import transformer

    cfg = configs.get_arch(REF_ARCH).make_reduced()
    model = transformer.init_params(
        cfg, generator=torch.Generator().manual_seed(7))
    params = nest_state({n: p.detach().numpy().copy()
                         for n, p in model.named_parameters()})
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (REF_B, REF_S)).astype(np.int32)
    return params, toks


def _reference_step(params, toks):
    """The reference's value_and_grad + AdamW step on ``params`` (numpy
    out): one compiled program."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import transformer as jtfm
    from repro.optim import AdamW as JaxAdamW

    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        jcfg = jconfigs.get_arch(REF_ARCH).make_reduced()
        opt = JaxAdamW(learning_rate=ttrain.LEARNING_RATE)

        @jax.jit
        def step(p, st, b):
            (loss, _), g = jax.value_and_grad(
                lambda q: jtfm.loss_fn(jcfg, q, b), has_aux=True)(p)
            upd, st = opt.update(g, st, p)
            return jax.tree.map(lambda a, u: a + u, p, upd), st, loss, g

        p = jax.tree.map(jnp.asarray, params)
        p_j, st_j, loss_j, g_j = step(p, opt.init(p),
                                      {"tokens": jnp.asarray(toks)})
        return (flat_state(jax.tree.map(np.asarray, p_j)),
                flat_state(jax.tree.map(np.asarray, st_j.mu)),
                float(loss_j), flat_state(jax.tree.map(np.asarray, g_j)))
    finally:
        jax.config.update("jax_enable_x64", prev)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_cli(argv):
    """Two ``--multihost`` CLI processes with the launcher's environment."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=SRC, RANK=str(rank),
                   WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train",
             "--multihost", *argv], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _finish(procs, deadline):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.time(), 1))
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            p.kill()
    return outs


def _spawn_workers(jobs, tmp, count=2):
    """``count`` worker processes of one gloo group (its store and the
    workers' result files in ``tmp``)."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = f"file://{tmp}/store"
    procs = [ctx.Process(target=worker.run, args=(r, count, init, jobs,
                                                  str(tmp), q))
             for r in range(count)]
    for p in procs:
        p.start()
    return procs, q


def _collect(procs, q, tmp, deadline):
    try:
        for _ in procs:
            rank, err = q.get(timeout=max(deadline - time.time(), 1))
            assert err is None, f"process {rank}:\n{err}"
        for p in procs:
            p.join(timeout=max(deadline - time.time(), 1))
        return [torch.load(tmp / f"{r}.pt", weights_only=False)
                for r in range(len(procs))]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()


@pytest.fixture(scope="module")
def four_started(tmp_path_factory):
    """Four worker processes of one logical shard each, started before
    ``runs`` so they run beside it: FOUR_CASES with ``--multihost``."""
    tmp = tmp_path_factory.mktemp("four")
    jobs = [{"name": c, "kind": "train", "argv": _argv(c, "--multihost")}
            for c in FOUR_CASES]
    procs, q = _spawn_workers(jobs, tmp, count=4)
    yield procs, q, tmp, time.time() + WALL_S
    for p in procs:
        if p.is_alive():
            p.kill()


@pytest.fixture(scope="module")
def four(four_started):
    """The four workers' results by rank."""
    return _collect(*four_started)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, four_started):
    """Every spawned layout, run once: (the workers' results by rank, the
    one-process results, the reference, the CLI's outputs, dirs)."""
    tmp = tmp_path_factory.mktemp("multihost")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    deadline = time.time() + WALL_S
    try:
        torch.save(_arrays(), tmp / "arrays.pt")
        # granite-1x4 saves its step 3 on either side; the one-process
        # save comes first: the two processes resume from it
        one = {"granite-1x4": _one_process(_argv(
            "granite-1x4", "--ckpt-dir", str(tmp / "one"), "--ckpt-every",
            "3"))}
        shutil.copytree(tmp / "one", tmp / "one_r")
        jobs = [{"name": c, "kind": "train", "argv": _argv(
            c, "--multihost", *(("--ckpt-dir", str(tmp / "two"),
                                 "--ckpt-every", "3")
                                if c == "granite-1x4" else ()))}
            for c in BIT_CASES]
        jobs += [
            {"name": "reference", "kind": "reference", "arch": REF_ARCH,
             "arrays": str(tmp / "arrays.pt")},
            {"name": "resume", "kind": "train", "argv": [
                *COMMON[:-1], "4", *CKPT, "--multihost", "--ckpt-dir",
                str(tmp / "one_r"), "--resume"]},
            {"name": "preempt", "kind": "train", "preempt_rank": 1,
             "argv": [*COMMON[:-1], "5", *CKPT, "--multihost",
                      "--ckpt-dir", str(tmp / "pre"), "--ckpt-every", "10"]},
        ]
        procs, q = _spawn_workers(jobs, tmp)
        cli = _start_cli(_argv("granite-1x4"))
        one.update({c: _one_process(_argv(c)) for c in BIT_CASES
                    if c not in one})
        ref = _reference_step(*torch.load(tmp / "arrays.pt",
                                          weights_only=False))
        two = _collect(procs, q, tmp, deadline)
        cli_out = _finish(cli, deadline)
        shutil.copytree(tmp / "two", tmp / "two_r")
        one["resume"] = _one_process([*COMMON[:-1], "4", *CKPT, "--ckpt-dir",
                                      str(tmp / "two_r"), "--resume"])
        return two, one, ref, cli_out, tmp
    finally:
        torch.set_num_threads(prev)


# -- in one process: the layout, the environment, the transfers -----------------------


@pytest.mark.parametrize("shape,count,me", [((1, 4), 2, 0), ((1, 4), 2, 1),
                                            ((2, 2), 2, 1), ((2, 4), 4, 2)])
def test_mesh_is_process_major(shape, count, me):
    mesh = make_process_mesh(shape, ("data", "model"), process=me,
                             count=count, devices=[torch.device("cpu")])
    L = mesh.size // count
    assert [mesh.owner(p) for p in range(mesh.size)] == \
        [p // L for p in range(mesh.size)]
    assert mesh.local_positions == tuple(range(me * L, (me + 1) * L))
    assert mesh.process_count == count and mesh.process == me
    assert [d.type for d in mesh.devices.flat] == [
        "cpu" if mesh.is_local(p) else "meta" for p in range(mesh.size)]
    assert mesh.local_device == torch.device("cpu")
    st = partition.place(torch.arange(float(4 * mesh.size)).reshape(
        mesh.size, 4), P(("data", "model"), None), mesh)
    for pos, s in enumerate(st.shards):
        assert process.is_remote(s) != mesh.is_local(pos)
        if mesh.is_local(pos):
            assert torch.equal(s[0], torch.arange(4.0) + 4 * pos)
        else:
            assert s.owner == mesh.owner(pos) and s.shape == (1, 4)


def test_mesh_refuses_positions_that_do_not_split():
    with pytest.raises(ValueError, match=r"\(3, 1\).*split over 2"):
        make_process_mesh((3, 1), ("data", "model"), process=0, count=2,
                          devices=[torch.device("cpu")])


def test_initialize_names_the_missing_variable(monkeypatch):
    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="needs RANK, WORLD_SIZE, "
                       "MASTER_ADDR, MASTER_PORT, LOCAL_RANK, "
                       "LOCAL_WORLD_SIZE"):
        process.initialize("cpu")
    for name in ENV_NAMES[:3]:
        monkeypatch.setenv(name, "0")
    with pytest.raises(RuntimeError, match="needs LOCAL_WORLD_SIZE in"):
        process.initialize("cpu", init_method="file:///nonexistent")
    assert process.world() is None


def test_no_library_reduction_in_the_port():
    """Only byte copies cross processes: no all_reduce, reduce_scatter or
    reduce of torch.distributed anywhere in the port (their summation
    order is the library's)."""
    pat = re.compile(r"all_reduce|reduce_scatter|dist\.reduce")
    hits = []
    for base, _, files in os.walk(os.path.join(SRC, "repro_torch")):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(base, f)
                with open(path) as fh:
                    hits += [f"{path}:{i}" for i, line in enumerate(fh, 1)
                             if pat.search(line)]
    assert not hits


def test_a_remote_position_meets_no_local_tensor():
    r = process.remote((2, 3), torch.float32, 1)
    assert process.is_remote(r * 2 + torch.tensor(1.0))
    assert (r @ process.remote((3, 4), torch.float32, 1)).shape == (2, 4)
    with pytest.raises(RuntimeError, match="another process"):
        r + torch.ones(2, 3)
    with pytest.raises(RuntimeError, match="partition"):
        r.to("cpu")
    with pytest.raises(RuntimeError, match="mixes positions"):
        r + process.remote((2, 3), torch.float32, 2)


# -- two processes against one --------------------------------------------------------


@pytest.mark.parametrize("case", list(BIT_CASES))
def test_two_processes_are_one_process_bits(runs, case):
    two, one, *_ = runs
    want = one[case]
    assert len(want["losses"]) == 3 and np.isfinite(want["losses"]).all()
    for rank in range(2):
        got = two[rank][case]
        assert got["losses"] == want["losses"], rank
        assert got["backend"] == "gloo"
        assert got["local"] == [2 * rank, 2 * rank + 1]
    leaves = two[0][case]["leaves"]
    assert set(leaves) == set(want["leaves"])
    assert not two[1][case]["leaves"]   # gathered onto process 0 alone
    bad = [n for n, w in want["leaves"].items()
           if not torch.equal(leaves[n], w)]
    assert not bad, bad
    if "compressed" in case:
        assert any(n.startswith("2__") for n in leaves)


@pytest.mark.parametrize("case", FOUR_CASES)
def test_four_processes_are_one_process_bits(runs, four, case):
    """Four processes, one position each: every transfer pairs processes
    by its key (gloo's tag), whichever pairs are busy, and the sums keep
    the one-process order."""
    want = runs[1][case]
    for rank in range(4):
        got = four[rank][case]
        assert got["losses"] == want["losses"], rank
        assert got["backend"] == "gloo"
        assert got["local"] == [rank]
    leaves = four[0][case]["leaves"]
    assert set(leaves) == set(want["leaves"])
    assert not any(four[r][case]["leaves"] for r in (1, 2, 3))
    bad = [n for n, w in want["leaves"].items()
           if not torch.equal(leaves[n], w)]
    assert not bad, bad


def test_two_process_step_matches_the_reference(runs):
    two, _, ref, *_ = runs
    p_j, mu_j, loss_j, g_j = ref
    got = two[0]["reference"]
    assert two[1]["reference"]["loss"] == got["loss"]
    np.testing.assert_allclose(got["loss"], loss_j, rtol=1e-5)
    assert got["ntokens"] == REF_B * (REF_S - 1)
    lr = ttrain.LEARNING_RATE
    for name, w in p_j.items():
        g = got["leaves"]["0__" + name.replace(".", "__")].numpy()
        small = np.abs(g_j[name]) < GRAD_FLOOR
        np.testing.assert_allclose(g[~small], w[~small], **STEP,
                                   err_msg=name)
        assert np.all(np.abs(g[small] - w[small]) <= 2 * lr + STEP["atol"])
    for name, m in mu_j.items():
        np.testing.assert_allclose(
            got["leaves"]["1__.mu__" + name.replace(".", "__")].numpy(), m,
            **STEP, err_msg=name)


def _files(d):
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            with open(os.path.join(root, f), "rb") as fh:
                out[os.path.relpath(os.path.join(root, f), d)] = fh.read()
    return out


def test_checkpoint_files_are_the_one_process_bytes(runs):
    *_, tmp = runs
    a, b = _files(tmp / "two"), _files(tmp / "one")
    assert sorted(a) == sorted(b) and "step_0000000003/manifest.json" in a
    assert [n for n in a if a[n] != b[n]] == []


@pytest.mark.parametrize("who", ["two-resume-one", "one-resume-two"])
def test_each_layout_restores_the_others_save(runs, who):
    """A 4-step run resumed at step 3 from the other layout's save: its
    step 3 and its final state the same bits on either side."""
    two, one, *_ = runs
    got = two[0]["resume"] if who == "two-resume-one" else one["resume"]
    other = one["resume"] if who == "two-resume-one" else two[0]["resume"]
    assert len(got["losses"]) == 1 and got["losses"] == other["losses"]
    if who == "two-resume-one":
        assert two[1]["resume"]["losses"] == got["losses"]
    else:
        assert one["resume"]["start"] == 3
    bad = [n for n, w in other["leaves"].items()
           if not torch.equal(got["leaves"][n], w)]
    assert not bad, bad


def test_preemption_on_one_process_stops_both(runs):
    two, one, _, _, tmp = runs
    a, b = two[0]["preempt"], two[1]["preempt"]
    assert len(a["losses"]) == len(b["losses"]) == 2
    assert a["losses"] == b["losses"] == one["granite-1x4"]["losses"][:2]
    assert CheckpointManager(str(tmp / "pre")).all_steps() == [2]


def test_cli_prints_the_one_process_losses(runs):
    _, one, _, cli_out, _ = runs
    want = [f"loss={x:.4f}" for i, x in enumerate(one["granite-1x4"]
                                                  ["losses"]) if i in (0, 2)]
    for rank, (rc, out) in enumerate(cli_out):
        assert rc == 0, out
        assert f"[process {rank}/2] backend gloo" in out
        got = re.findall(rf"\[process {rank}\] step \d+: (loss=[\d.]+)", out)
        assert got == want, out
