"""The port's MACE trainer on a (data, model) mesh against the JAX
package's GNN train plan and the port's unsharded trainer, on the CPU.

Reduced MACE (f32, C = 16: 4 channels a shard at M = 4) on CPU meshes of
logical shards 1 x 2, 2 x 1, 2 x 2 and 1 x 4 (``launch.mesh.
make_host_mesh(..., device="cpu")``), on graphs of 64 nodes and 192 to
256 edges: the smallest that still split the channels over ``model`` and
each edge chunk over ``data``. The ogb_products plan chunks its edges in
16 (``edge_chunks > 1``: the node side then runs in 16 blocks too), and
the trainer cases add ``edge_chunks = 2`` with remat. Weights come from
the reference's ``init_params`` through ``convert.mace_from_arrays(
mesh=)`` or ``steps.place_args``, or from the port's ``init_params`` and
``init_sharded`` on one seed; graphs are the reference's numpy draws
(``geometric_graph_batch``).

Tolerances (``tests/test_torch_sharded_train.py``'s): the loss rtol 1e-5;
parameters and moments after a step rtol 1e-4 / atol 1e-6, where an
element whose gradient is within GRAD_FLOOR of zero is held to 2 lr a
step (AdamW's first update is g / (|g| + eps), its size there set by the
summation order's rounding); gradients within GRAD_TOL of their leaf's
largest |g|. The sharded init, the collective, remat against no remat,
replicas, reruns and resumed runs on one mesh: exact.
"""
import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402,E501
from repro.data import synthetic as jsyn  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import mace as jmace  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.checkpoint import flat_state  # noqa: E402
from repro_torch.configs.base import pad_edges  # noqa: E402
from repro_torch.distributed import partition  # noqa: E402
from repro_torch.distributed.sharding import P  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import mace as tmace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
#: the reference plan's cells: graph-level (molecule), node-level
#: (minibatch_lg), and node-level with 16 edge chunks (ogb_products)
PLAN_CELLS = {"molecule": 192, "minibatch_lg": 192, "ogb_products": 256}
N_NODES = 64
STEP = dict(rtol=1e-4, atol=1e-6)
GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-6
LR = ttrain.LEARNING_RATE


@pytest.fixture(autouse=True)
def _one_thread():
    """The shards here are small: one intra-op thread runs them faster,
    and keeps the workers of a parallel test run from oversubscribing the
    cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _x32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _mesh(shape):
    return make_host_mesh(*shape, device="cpu")


def _cfg(**over):
    return dataclasses.replace(tconfigs.get_arch("mace").make_reduced(),
                               **over)


def _graph(seed, n_edges, d_feat, n_graphs=1, node_level=False):
    """The reference's numpy graph draws (without the static entries)."""
    return jsyn.geometric_graph_batch(seed, N_NODES, n_edges, d_feat,
                                      n_graphs=n_graphs,
                                      node_level=node_level)


def _torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) if hasattr(v, "shape") else v
            for k, v in b.items()}


def _assert_grads_close(got: dict, want: dict):
    for name, w in want.items():
        g = np.asarray(got[name])
        err = np.abs(g - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), (name, err)


def _assert_steps_close(got: dict, want: dict, grads: list):
    """Parameters after len(grads) AdamW steps within STEP, except where a
    step's gradient is within GRAD_FLOOR of zero: there within 2 lr a
    step."""
    for name, w in want.items():
        g = np.asarray(got[name])
        small = np.zeros(w.shape, bool)
        for gr in grads:
            small |= np.abs(gr[name]) < GRAD_FLOOR
        np.testing.assert_allclose(g[~small], w[~small], **STEP,
                                   err_msg=name)
        assert np.all(np.abs(g[small] - w[small])
                      <= 2 * LR * len(grads) + STEP["atol"]), name


def _all_replicas_equal(tr):
    st = tr.opt_state
    return all(partition.replicas_equal(t) for t in (
        *tr.params.values(), *st.mu.values(), *st.nu.values(), st.step))


# -- the collective ----------------------------------------------------------


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
def test_sum_scatter_is_an_f32_sum_in_part_order(M, out):
    """Block j of the result is block j of every part summed in part
    order in f32 and cast once; the backward gives each part the blocks'
    cotangents concatenated, in its own dtype. Parts mix f32 and bf16."""
    gen = torch.Generator().manual_seed(M)
    parts = [torch.randn((5, 4 * M, 3), generator=gen,
                         dtype=torch.float32 if i % 2 else torch.bfloat16)
             .requires_grad_(True) for i in range(M)]
    got = partition.sum_scatter(parts, 1, out)
    for j, g in enumerate(got):
        acc = parts[0][:, 4 * j:4 * j + 4].float()
        for p in parts[1:]:
            acc = acc + p[:, 4 * j:4 * j + 4].float()
        assert g.dtype == out and torch.equal(g, acc.to(out)), j
    cot = [torch.randn(g.shape, generator=gen).to(out) for g in got]
    grads = torch.autograd.grad(got, parts, cot)
    for p, g in zip(parts, grads):
        assert g.dtype == p.dtype
        assert torch.equal(g, torch.cat(cot, 1).to(p.dtype))
    with pytest.raises(ValueError, match="does not split"):
        partition.sum_scatter([torch.zeros(2, 3)] * 2, 1)


# -- placement, the plan's step, the trainer's steps ----------------------------


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_init_is_init_params(shape):
    cfg = _cfg()
    want = tmace.init_params(cfg, generator=torch.Generator().manual_seed(3))
    got = tmace.init_sharded(cfg, _mesh(shape),
                             generator=torch.Generator().manual_seed(3))
    specs = tmace.param_specs(cfg)
    assert specs == tsteps.shard_lib.gnn_param_specs(dict(
        want.named_parameters()))
    for name, p in want.named_parameters():
        st = got.params[name]
        assert st.spec == specs[name]
        for pos, s in enumerate(st.shards):
            blk = partition.block(st.shape, st.spec, st.mesh, pos)
            assert torch.equal(s.detach(), p.detach()[blk]), (name, pos)


def test_meshes_the_model_cannot_split_on_raise():
    with pytest.raises(ValueError, match=r"channels % M"):
        tmace.init_sharded(_cfg(), _mesh((1, 3)),
                           generator=torch.Generator().manual_seed(0))
    model = tmace.init_sharded(_cfg(edge_chunks=5), _mesh((2, 1)),
                               generator=torch.Generator().manual_seed(0))
    batch = ttrain.gnn_batch_fn(model.cfg, seed=0, batch=1,
                                device="cpu")(0)  # 48 edges, not 5 x 2 runs
    with pytest.raises(ValueError, match="pad_edges"):
        tmace.sharded_loss_fn(model.cfg, model, batch)


@pytest.mark.parametrize("cell", list(PLAN_CELLS))
def test_plan_on_every_cell(cell):
    """``build_plan("mace", cell)`` at published width: the cell's
    feature width, 16 edge chunks on ogb_products alone (an override
    keeps its own count), the rules' specs and the cell's input specs on
    the meta device."""
    plan = tsteps.build_plan("mace", cell)
    jplan = jsteps.build_plan("mace", cell)
    assert (plan.kind, plan.cfg.d_feat, plan.cfg.edge_chunks,
            plan.cfg.channels) == ("train", jplan.cfg.d_feat,
                                   jplan.cfg.edge_chunks, 128)
    assert plan.cfg.edge_chunks == (16 if cell == "ogb_products" else 1)
    params, opt_state, batch = plan.args
    pspecs, ospecs, bspecs = plan.in_specs
    assert pspecs == tmace.param_specs(plan.cfg)
    assert ospecs.mu == pspecs and ospecs.step == P()
    assert all(t.device.type == "meta" for t in (
        *params.values(), *opt_state.mu.values(), *batch.values()))
    assert {k: tuple(v.shape) for k, v in batch.items()} == {
        k: tuple(v.shape) for k, v in jplan.args[2].items()}
    assert bspecs["senders"] == P("data") and bspecs["positions"] == P()
    if cell == "ogb_products":
        assert batch["senders"].shape == (pad_edges(61_859_140),)
        over = tsteps.build_plan("mace", cell, overrides={"edge_chunks": 32})
        assert over.cfg.edge_chunks == 32



@functools.lru_cache(maxsize=None)
def _reference_plan_step(cell):
    """The reference plan's weights, graph and one step (numpy)."""
    jplan = jsteps.build_plan("mace", cell, reduced=True)
    static_graphs = jplan.args[2]["target_energy"].shape[0] \
        if "target_energy" in jplan.args[2] else 1
    graph = _graph(9, PLAN_CELLS[cell], jplan.cfg.d_feat, static_graphs,
                   node_level="target_nodes" in jplan.args[2])
    params = jax.jit(lambda k: jmace.init_params(jplan.cfg, k))(
        jax.random.PRNGKey(7))
    jb = {k: jnp.asarray(v) for k, v in graph.items()}
    with jmesh.make_host_mesh(1, 1):
        p_j, st_j, aux_j = jax.jit(jplan.fn)(
            params, jsteps.make_optimizer().init(params), jb)
    return (_np(params), graph, _np(p_j), _np(st_j.mu),
            float(aux_j["loss"]), int(st_j.step))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("cell", list(PLAN_CELLS))
def test_plan_step_matches_the_reference_plan(cell, shape):
    """``build_plan("mace", cell, reduced=True)``'s fn on a mesh, its
    arguments laid out by the plan's specs (``place_args``, the batch by
    its input specs), against the reference plan's fn (under a 1 x 1
    host mesh) on the same weights and graph: the loss, the parameters
    and the moments after the step; and the mesh's gradients against the
    unsharded port's."""
    params, graph, p_j, mu_j, loss_j, step_j = _reference_plan_step(cell)
    plan = tsteps.build_plan("mace", cell, reduced=True)
    cfg = plan.cfg
    mesh = _mesh(shape)
    whole = {k: convert._leaf_tensor(v, cfg.dtype, "cpu")
             for k, v in flat_state(params).items()}
    placed, ost = tsteps.place_args(plan, mesh, whole)
    batch = {k: partition.place(v, plan.in_specs[2][k], mesh)
             for k, v in _torch_batch(graph).items()}
    # the unsharded port's gradient at these weights, and the mesh's
    full = dict(_torch_batch(graph), **tconfigs.input_specs(
        tconfigs.get_arch("mace"), cfg,
        tconfigs.get_arch("mace").cell(cell))["static"])
    model = convert.mace_from_arrays(cfg, params, device="cpu")
    loss, _ = tmace.loss_fn(cfg, model, full)
    grads = {n: g.numpy() for (n, _), g in zip(
        model.named_parameters(), torch.autograd.grad(
            loss, list(model.parameters()), materialize_grads=True))}
    sharded = convert.mace_from_arrays(cfg, params, mesh=mesh)
    _, _, got = ttrain.sharded_grads(sharded, full)
    _assert_grads_close({n: g.gather().numpy() for n, g in got.items()},
                        grads)
    p_t, st_t, aux_t = plan.fn(placed, ost, batch)
    np.testing.assert_allclose(aux_t["loss"].item(), loss_j, rtol=1e-5)
    _assert_steps_close({n: p.gather().numpy() for n, p in p_t.items()},
                        flat_state(p_j), [grads])
    for name, m in flat_state(mu_j).items():
        np.testing.assert_allclose(st_t.mu[name].gather().numpy(), m,
                                   **STEP, err_msg=name)
    assert int(st_t.step.gather()) == step_j == 1


@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("shape", MESHES)
def test_two_steps_match_the_unsharded_trainer(shape, chunks):
    """Two steps of the CLI's sharded trainer against the port's unsharded
    trainer from the same seed on the reference trainer's batches (16 B
    nodes, 48 B edges, B graphs); with 2 edge chunks, under remat. Then
    every holder of every shard of the parameters, moments and step
    holds the same bits, and a rerun is the same bits."""
    cfg = _cfg(edge_chunks=chunks, remat=chunks > 1)
    make = ttrain.gnn_batch_fn(cfg, seed=5, batch=4, device="cpu")
    runs = []
    for _ in range(2):
        tr = ttrain.sharded_mace_trainer(cfg, mesh=_mesh(shape), seed=5)
        runs.append(([tr.step(make(s))[0] for s in range(2)], tr))
    (losses, tr), (again, tr2) = runs
    ref = ttrain.mace_trainer(cfg, seed=5, device="cpu")
    ref_grads = []
    for s in range(2):
        loss, _ = tmace.loss_fn(cfg, ref.model, make(s))
        ref_grads.append({n: g.numpy() for n, g in zip(
            ref.params, torch.autograd.grad(loss, list(ref.params.values()),
                                            materialize_grads=True))})
        want, _ = ref.step(make(s))
        np.testing.assert_allclose(losses[s].item(), want.item(), rtol=1e-5)
    _assert_steps_close(
        {n: p.gather().numpy() for n, p in tr.params.items()},
        {n: p.detach().numpy() for n, p in ref.params.items()}, ref_grads)
    assert int(tr.opt_state.step.gather()) == 2
    assert _all_replicas_equal(tr)
    assert [x.item() for x in again] == [x.item() for x in losses]
    for n, p in tr.params.items():
        assert all(torch.equal(a, b) for a, b in zip(
            p.shards, tr2.params[n].shards)), n


@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("shape", MESHES)
def test_sharded_remat_recomputes_the_same_bits(shape, chunks):
    """Remat (each layer, and with 2 edge chunks each chunk and node
    block, through ``layers.RematGroup``) gives the loss and gradients of
    no remat, bit for bit: a tensor that several chunks or node blocks
    read sums their gradients in chunk (block) order either way
    (``layers.fan_out``)."""
    out = []
    for remat in (False, True):
        cfg = _cfg(edge_chunks=chunks, remat=remat)
        model = tmace.init_sharded(cfg, _mesh(shape),
                                   generator=torch.Generator().manual_seed(6))
        batch = ttrain.gnn_batch_fn(cfg, seed=6, batch=4, device="cpu")(0)
        loss, _, grads = ttrain.sharded_grads(model, batch)
        out.append((loss, {n: g.gather() for n, g in grads.items()}))
    assert torch.equal(out[0][0], out[1][0])
    for name, g in out[0][1].items():
        assert torch.equal(out[1][1][name], g), name


def test_padded_edges_change_nothing():
    """A graph padded by ``pad_edges`` (padding edges node 0 -> 0 with
    edge_mask 0, as phase 27 pads ogb_products) gives the unpadded
    graph's loss on a 2 x 2 mesh with 4 edge chunks."""
    cfg = _cfg(edge_chunks=4)
    graph = _torch_batch(_graph(3, 200, cfg.d_feat, node_level=True))
    E = pad_edges(200, 64)
    padded = dict(graph)
    for k in ("senders", "receivers", "edge_mask"):
        padded[k] = torch.cat([graph[k], torch.zeros(E - 200,
                                                     dtype=graph[k].dtype)])
    model = tmace.init_sharded(cfg, _mesh((2, 2)),
                               generator=torch.Generator().manual_seed(1))
    want, _ = tmace.loss_fn(dataclasses.replace(cfg, edge_chunks=1),
                            tmace.init_params(cfg, generator=torch.Generator()
                                              .manual_seed(1)),
                            dict(graph, n_graphs=1, node_level=True))
    got, _ = tmace.sharded_loss_fn(cfg, model, dict(padded, n_graphs=1,
                                                    node_level=True))
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-5)


# -- the CLI and checkpoints both ways -------------------------------------------


def _cli(tmp, shape, steps, *extra):
    return ttrain.main(["--arch", "mace", "--reduced", "--device", "cpu",
                        "--steps", str(steps), "--batch", "4",
                        "--data-shards", str(shape[0]), "--model-shards",
                        str(shape[1]), "--ckpt-dir", str(tmp),
                        "--ckpt-every", "2", *extra])


def test_cli_resumes_onto_another_mesh(tmp_path):
    """--data-shards 2 --model-shards 2: a resume on 2 x 2 from a 2 x 2
    save is the uninterrupted run, bit for bit; a resume on 1 x 4 matches
    it within the loss rtol; the manifest carries the reference rules'
    specs (``gnn_param_specs``, the moments alike, the step P())."""
    whole = _cli(tmp_path / "w", (2, 2), 4)
    assert whole["mesh"].shape == {"data": 2, "model": 2}
    _cli(tmp_path / "a", (2, 2), 2)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    specs = CheckpointManager(str(tmp_path / "a")).specs()
    rules = tmace.param_specs(_cfg())
    want = {f"0__{n.replace('.', '__')}": sp for n, sp in rules.items()}
    want.update({f"1__.{m}__{n.replace('.', '__')}": sp
                 for n, sp in rules.items() for m in ("mu", "nu")})
    want["1__.step"] = P()
    assert specs == want
    assert specs["0__layers__0__msg0"] == P(None, "model", None)
    resumed = _cli(tmp_path / "a", (2, 2), 4, "--resume")
    assert resumed["start_step"] == 2
    assert resumed["losses"] == whole["losses"][2:]
    for n, p in whole["trainer"].params.items():
        assert torch.equal(resumed["trainer"].params[n].gather(),
                           p.gather()), n
    moved = _cli(tmp_path / "b", (1, 4), 4, "--resume")
    assert moved["start_step"] == 2
    np.testing.assert_allclose(moved["losses"], whole["losses"][2:],
                               rtol=1e-5)


def test_port_restores_a_reference_checkpoint_onto_its_mesh(tmp_path):
    """The reference's CheckpointManager saves MACE's (params, AdamWState)
    with ``gnn_param_specs``; the port lays each leaf out on a 2 x 2 mesh
    by the stored spec and loads it into a sharded trainer, bit for
    bit."""
    _, _, p_j, mu_j, _, _ = _reference_plan_step("molecule")
    jp = jax.tree.map(jnp.asarray, p_j)
    st = JaxAdamW(learning_rate=LR).init(jp)
    st = st._replace(step=jnp.int32(3), mu=jax.tree.map(jnp.asarray, mu_j))
    pspecs = jsharding.gnn_param_specs(jax.eval_shape(lambda: jp))
    JaxCheckpointManager(str(tmp_path)).save(
        3, (jp, st), (pspecs, jsharding.opt_state_specs(pspecs)))
    mesh = _mesh((2, 2))
    cfg = tsteps.build_plan("mace", "molecule", reduced=True).cfg
    tr = ttrain.sharded_mace_trainer(cfg, mesh=mesh, seed=0)
    step, tree = CheckpointManager(str(tmp_path)).restore(
        like=tr.state_tree(), mesh=mesh)
    assert step == 3
    for name, leaf in flat_state(tree[0]).items():
        assert leaf.spec == tr.params[name].spec, name
    tr.load_state_tree(tree)
    for name, p in flat_state(p_j).items():
        np.testing.assert_array_equal(tr.params[name].gather().numpy(), p,
                                      err_msg=name)
    for name, m in flat_state(mu_j).items():
        np.testing.assert_array_equal(tr.opt_state.mu[name].gather().numpy(),
                                      m, err_msg=name)
    assert int(tr.opt_state.step.gather()) == 3
    assert _all_replicas_equal(tr)


_JAX_RESTORE = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    from repro import configs
    from repro.checkpoint import CheckpointManager
    from repro.checkpoint.checkpoint import _leaf_paths
    from repro.launch.mesh import make_host_mesh
    from repro.models import mace
    from repro.optim import AdamW

    ckpt, out = sys.argv[1], sys.argv[2]
    assert len(jax.devices()) == 4, jax.devices()
    cfg = configs.get_arch("mace").make_reduced()
    params = jax.eval_shape(lambda: mace.init_params(cfg,
                                                     jax.random.PRNGKey(0)))
    like = (params, jax.eval_shape(AdamW(learning_rate=3e-4).init, params))
    step, tree = CheckpointManager(ckpt).restore(
        mesh=make_host_mesh(1, 4), like=like)
    meta, arrays = {"step": step}, {}
    for name, leaf in _leaf_paths(tree):
        arrays[name] = np.asarray(leaf)
        meta[name] = {"spec": [list(a) if isinstance(a, tuple) else a
                               for a in leaf.sharding.spec],
                      "devices": len(leaf.sharding.device_set),
                      "shard": list(leaf.addressable_shards[0].data.shape)}
    np.savez(out + ".npz", **arrays)
    with open(out + ".json", "w") as f:
        json.dump(meta, f)
""")


def test_reference_restores_a_port_checkpoint_onto_four_devices(tmp_path):
    """A port MACE checkpoint saved on a 1 x 4 mesh after a step, restored
    by the reference's CheckpointManager onto a forced 4-device CPU mesh
    (a subprocess with XLA_FLAGS=--xla_force_host_platform_device_count=
    4): the same values, and each leaf sharded by its spec."""
    cfg = _cfg()
    tr = ttrain.sharded_mace_trainer(cfg, mesh=_mesh((1, 4)), seed=1)
    tr.step(ttrain.gnn_batch_fn(cfg, seed=1, batch=4, device="cpu")(0))
    CheckpointManager(str(tmp_path / "ck")).save(
        1, tr.state_tree(), ttrain.state_specs(tr.specs()))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = str(tmp_path / "restored")
    run = subprocess.run([sys.executable, "-c", _JAX_RESTORE,
                          str(tmp_path / "ck"), out], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(out + ".json") as f:
        meta = json.load(f)
    arrays = np.load(out + ".npz")
    assert meta.pop("step") == 1
    for prefix, tree in (("0__", tr.params), ("1__.mu__", tr.opt_state.mu),
                         ("1__.nu__", tr.opt_state.nu)):
        for name, st in tree.items():
            key = prefix + name.replace(".", "__")
            np.testing.assert_array_equal(arrays[key],
                                          st.gather().detach().numpy(),
                                          err_msg=key)
            assert meta[key]["spec"] == [list(a) if isinstance(a, tuple)
                                         else a for a in st.spec], key
            assert meta[key]["devices"] == 4
            assert tuple(meta[key]["shard"]) == tuple(st.shards[0].shape)
    assert int(arrays["1__.step"]) == 1
