"""The port's recsys family on a (data, model) mesh against the JAX
package's models and recsys plans and the port's single device, on the
CPU.

The four reduced ranking models (f32), and xDeepFM at ``n_sparse`` 7 (its
CIN's rows, 7 x 7 and 16 x 7, do not split evenly over 2 or 4 model
shards), on CPU meshes of logical shards 1 x 2, 2 x 1, 2 x 2 and 1 x 4
(``launch.mesh.make_host_mesh(..., device="cpu")``). Weights come from
the reference's ``init_params`` through ``convert.
recsys_params_from_arrays(mesh=)`` or ``steps.place_args``, or from the
port's ``init_params`` and ``init_sharded`` on one seed; batches are the
reference's numpy draws (``recsys_batch``).

Tolerances (``tests/test_torch_sharded_gnn.py``'s): the loss rtol 1e-5;
gradients within GRAD_TOL of their leaf's largest |g|; parameters and
moments after a step rtol 1e-4 / atol 1e-6, where an element whose
gradient is within GRAD_FLOOR of zero is held to 2 lr a step; served
logits rtol 1e-5 / atol 1e-6. Exact: the row gathers (forward and
backward, against ``gather_rows`` of the whole table), the sharded init,
replicas, reruns and resumed runs on one mesh, and on a 1 x M mesh the
table's gradient of DLRM and AutoInt against the port's single device
(their dense work runs whole on the first model shard). Wide&Deep's and
xDeepFM's column-split first layer and xDeepFM's CIN partials sum in
another order, so their table gradients are held to GRAD_TOL. The
retrieval cases score integer-valued embeddings, so every score is exact
and ties are exact: ids and scores equal the reference's, ties included.
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

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402,E501
from repro.core import simplex as jsimplex  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.checkpoint import flat_state  # noqa: E402
from repro_torch.distributed import partition  # noqa: E402
from repro_torch.distributed.sharding import P  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import recsys as trec  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["dlrm-rm2", "autoint", "wide-deep", "xdeepfm"]
#: xDeepFM at 7 fields: the CIN's padded split
ODD = "xdeepfm-7"
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
STEP = dict(rtol=1e-4, atol=1e-6)
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-6
LR = ttrain.LEARNING_RATE
B = 16


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


def _cfgs(arch):
    """(reference config, port config) of a reduced arch (``ODD``: xDeepFM
    at 7 fields)."""
    name = "xdeepfm" if arch == ODD else arch
    jcfg = jconfigs.get_arch(name).make_reduced()
    tcfg = tconfigs.get_arch(name).make_reduced()
    if arch == ODD:
        over = dict(n_sparse=7, vocab_sizes=tuple([64] * 7))
        jcfg = dataclasses.replace(jcfg, **over)
        tcfg = dataclasses.replace(tcfg, **over)
    return jcfg, tcfg


def _batch(jcfg, seed, n=B):
    return _np(jsyn.recsys_batch(seed, 0, n, jcfg.vocab_sizes, jcfg.n_dense))


def _torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _grads_of(loss, model) -> dict:
    return {n: g for (n, _), g in zip(model.named_parameters(),
                                      torch.autograd.grad(
                                          loss, list(model.parameters())))}


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


# -- the row gather ----------------------------------------------------------------


@pytest.mark.parametrize("to", [None, "cpu"])
@pytest.mark.parametrize("shape", [(13, 5), (13, 5, 3), (40, 1)])
@pytest.mark.parametrize("M", [2, 4])
def test_gather_rows_sharded_is_gather_rows(M, shape, to, monkeypatch):
    """A table split in M row blocks: the rows, and each block's gradient
    from a cotangent, the bits of ``gather_rows`` of the whole table
    (duplicates summed in the order they occur); each shard gathers only
    the ids it holds. Shapes: (B, F) ids of a (rows, d) table, (B, F, L)
    bags, and the (rows, 1) tables' (wide, linear)."""
    rng = np.random.default_rng(M)
    d = 1 if shape == (40, 1) else 6
    rows = 8 * M
    table = torch.from_numpy(rng.standard_normal((rows, d)).astype(
        np.float32)).requires_grad_(True)
    ids = torch.from_numpy(rng.integers(0, rows // 2 + 1, shape))
    ids.view(-1)[::7] = rows - 1
    blocks = [t.detach().clone().requires_grad_(True)
              for t in table.detach().split(8)]
    seen = []
    real = tlayers.gather_rows
    monkeypatch.setattr(tlayers, "gather_rows",
                        lambda t, i: seen.append(i.clone()) or real(t, i))
    got = tlayers.gather_rows_sharded(blocks, [ids] * M, to=to)
    want = real(table, ids)
    cot = torch.from_numpy(rng.standard_normal(want.shape).astype(
        np.float32))
    outs = [got] if to is not None else got
    assert len(outs) == (1 if to is not None else M)
    for o in outs:
        assert torch.equal(o, want)
    (g_want,) = torch.autograd.grad(want, table, cot)
    g_got = torch.autograd.grad(outs[0], blocks, cot)
    assert torch.equal(torch.cat(g_got), g_want)
    flat = ids.reshape(-1)
    for m, i in enumerate(seen):
        mine = flat[(flat >= 8 * m) & (flat < 8 * (m + 1))] - 8 * m
        assert torch.equal(i, mine), m


@pytest.mark.parametrize("kind", ["one_hot", "multi_hot", "weighted"])
def test_embedding_bag_sharded_is_embedding_bag(kind):
    """``embedding_bag_sharded`` over 4 row blocks: the bits of the port's
    ``embedding_bag`` of the whole table (which the recsys parity tests
    hold to the reference's), on every shard and on one device."""
    rng = np.random.default_rng(1)
    offsets = (0, 7, 30, 31)
    table = torch.from_numpy(rng.standard_normal((40, 6)).astype(
        np.float32))
    shape = (9, 4) if kind == "one_hot" else (9, 4, 3)
    idx = torch.from_numpy(rng.integers(0, 7, shape).astype(np.int32))
    w = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
         if kind == "weighted" else None)
    want = trec.embedding_bag(table, idx, offsets, weights=w)
    blocks = list(table.split(10))
    got = trec.embedding_bag_sharded(blocks, [idx] * 4, offsets,
                                     weights=None if w is None else [w] * 4)
    one = trec.embedding_bag_sharded(blocks, [idx] * 4, offsets, weights=w,
                                     to="cpu")
    for g in (*got, one):
        assert g.dtype == torch.float32 and torch.equal(g, want)


# -- placement --------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_init_is_init_params(arch, shape):
    _, cfg = _cfgs(arch)
    want = trec.init_params(cfg, generator=torch.Generator().manual_seed(3))
    got = trec.init_sharded(cfg, _mesh(shape),
                            generator=torch.Generator().manual_seed(3))
    specs = trec.param_specs(cfg)
    assert specs == tsteps.shard_lib.recsys_param_specs(dict(
        want.named_parameters()))
    for name, p in want.named_parameters():
        st = got.params[name]
        assert st.spec == specs[name]
        for pos, s in enumerate(st.shards):
            blk = partition.block(st.shape, st.spec, st.mesh, pos)
            assert torch.equal(s.detach(), p.detach()[blk]), (name, pos)


def test_meshes_the_model_cannot_split_on_raise():
    _, cfg = _cfgs("wide-deep")
    with pytest.raises(ValueError, match=r"padded_rows % M"):
        trec.init_sharded(cfg, _mesh((1, 3)),
                          generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match=r"first MLP width % M"):
        trec.init_sharded(dataclasses.replace(cfg, mlp=(30, 16)),
                          _mesh((1, 4)),
                          generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="two-tower"):
        convert.recsys_params_from_arrays(cfg, {"table": 0, "items": 0},
                                          mesh=_mesh((1, 2)))


# -- the loss and gradients against the reference -------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_grads(arch):
    """The reference's weights, batch, loss and gradients (numpy)."""
    jcfg, _ = _cfgs(arch)
    params = jrec.init_params(jcfg, jax.random.PRNGKey(5))
    batch = _batch(jcfg, 5)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jrec.loss_fn(jcfg, p, b), has_aux=True))(
            params, jax.tree.map(jnp.asarray, batch))
    return _np(params), batch, float(loss), flat_state(_np(grads))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS + [ODD])
def test_loss_and_gradients_match_the_reference(arch, shape):
    """The sharded loss and every gradient leaf against the reference's
    ``loss_fn`` on the same weights and batch; on 1 x M DLRM's and
    AutoInt's table gradients are the port's single device's bits."""
    params, batch, loss_j, grads_j = _reference_grads(arch)
    _, cfg = _cfgs(arch)
    model = convert.recsys_params_from_arrays(cfg, params, mesh=_mesh(shape))
    tb = _torch_batch(batch)
    loss, _, grads = ttrain.sharded_grads(model, tb)
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-5)
    got = {n: g.gather().numpy() for n, g in grads.items()}
    _assert_grads_close(got, grads_j)
    one = convert.recsys_params_from_arrays(cfg, params, device="cpu")
    single = _grads_of(trec.loss_fn(cfg, one, tb)[0], one)
    if shape[0] == 1 and cfg.model in ("dlrm", "autoint"):
        assert torch.equal(grads["table"].gather(), single["table"])
    logits = trec.sharded_forward(cfg, model, tb).detach()
    np.testing.assert_allclose(
        logits.numpy(), trec.forward(cfg, one, tb).detach().numpy(), **FWD)


# -- the reference's plans ------------------------------------------------------------

PLAN_MESH = {"dlrm-rm2": (1, 4), "autoint": (2, 2), "wide-deep": (2, 1),
             "xdeepfm": (2, 2)}


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_train_step_matches_the_reference_plan(arch):
    """``build_plan(arch, "train_batch", reduced=True)``'s fn on a mesh,
    its arguments laid out by the plan's specs (``place_args``, the batch
    by its input specs), against the reference plan's fn (under a 1 x 1
    host mesh) on the same weights and batch: the loss, the parameters
    and the moments after the step."""
    params, batch, _, grads_j = _reference_grads(arch)
    jplan = jsteps.build_plan(arch, "train_batch", reduced=True)
    jp = jax.tree.map(jnp.asarray, params)
    with jmesh.make_host_mesh(1, 1):
        p_j, st_j, aux_j = jax.jit(jplan.fn)(
            jp, jsteps.make_optimizer().init(jp),
            jax.tree.map(jnp.asarray, batch))
    plan = tsteps.build_plan(arch, "train_batch", reduced=True)
    assert plan.kind == "train" and plan.in_specs[2] == {
        k: P("data", None) if k != "labels" else P("data") for k in batch}
    for name, meta in plan.args[0].items():
        assert meta.device.type == "meta", name
    mesh = _mesh(PLAN_MESH[arch])
    whole = {k: torch.from_numpy(np.array(v))
             for k, v in flat_state(params).items()}
    placed, ost = tsteps.place_args(plan, mesh, whole)
    tb = {k: partition.place(v, plan.in_specs[2][k], mesh)
          for k, v in _torch_batch(batch).items()}
    p_t, st_t, aux_t = plan.fn(placed, ost, tb)
    np.testing.assert_allclose(aux_t["loss"].item(), float(aux_j["loss"]),
                               rtol=1e-5)
    _assert_steps_close({n: p.gather().numpy() for n, p in p_t.items()},
                        flat_state(_np(p_j)), [grads_j])
    for name, m in flat_state(_np(st_j.mu)).items():
        np.testing.assert_allclose(st_t.mu[name].gather().numpy(), m,
                                   **STEP, err_msg=name)
    assert int(st_t.step.gather()) == int(st_j.step) == 1


@pytest.mark.parametrize("arch,cell", [("dlrm-rm2", "serve_p99"),
                                       ("xdeepfm", "serve_bulk")])
def test_plan_serve_matches_the_reference_plan(arch, cell):
    """The serve plan's logits on 2 x 2, laid out over ``data``, against
    the reference plan's."""
    params, _, _, _ = _reference_grads(arch)
    jcfg, _ = _cfgs(arch)
    batch = {k: v for k, v in _batch(jcfg, 8, 24).items() if k != "labels"}
    jplan = jsteps.build_plan(arch, cell, reduced=True)
    with jmesh.make_host_mesh(1, 1):
        want = np.asarray(jax.jit(jplan.fn)(
            jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, batch)))
    plan = tsteps.build_plan(arch, cell, reduced=True)
    assert plan.out_specs == P("data") and "labels" not in plan.args[1]
    mesh = _mesh((2, 2))
    placed = tsteps.place_args(plan, mesh, {
        k: torch.from_numpy(np.array(v))
        for k, v in flat_state(params).items()})
    got = plan.fn(placed, _torch_batch(batch))
    assert got.spec == P("data") and got.shards[1].shape == (12,)
    np.testing.assert_allclose(got.gather().numpy(), want, **FWD)


def _integer_weights(seed):
    """Reference weights whose table holds small integers: the mean of 8
    fields' rows is exact, and so is every dot product with integer
    candidates (ties are exact ties on both sides)."""
    jcfg = jconfigs.get_arch("dlrm-rm2").make_reduced()
    params = _np(jrec.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    params["table"] = rng.integers(-3, 4, params["table"].shape).astype(
        np.float32)
    return jcfg, params


@pytest.mark.parametrize("mode", ["dense", "zen"])
def test_plan_retrieval_matches_the_reference_plan(mode):
    """``retrieval_cand``'s plan on 2 x 2 (dense candidates and the zen
    index's coords over ``data``, as the reference's plan lays them: two
    blocks) against the reference plan's: ids and scores equal, ties
    included.
    Candidate rows repeat across block boundaries, so an exact tie spans
    two shards and must go to the lower id. Zen: the reduced index fitted
    by the reference (k = zen_k references), the coords its projection of
    the candidates."""
    jcfg, params = _integer_weights(4)
    rng = np.random.default_rng(4)
    n = 400
    cands = rng.integers(-3, 4, (n, jcfg.embed_dim)).astype(np.float32)
    cands[100:110] = cands[95:105]     # repeats inside block 0 (of 200)
    cands[200:210] = cands[:10]        # block 0 again in block 1
    cands[395:400] = cands[300:305]
    batch = {k: v for k, v in _batch(jcfg, 4, 3).items() if k != "labels"}
    over = {"retrieval_mode": mode}
    jplan = jsteps.build_plan("dlrm-rm2", "retrieval_cand", reduced=True,
                              overrides=over)
    plan = tsteps.build_plan("dlrm-rm2", "retrieval_cand", reduced=True,
                             overrides=over)
    if mode == "zen":
        k = jcfg.zen_k
        refs = cands[rng.choice(n, k, replace=False)] + 0.25
        dr = np.sqrt(((refs[:, None] - refs[None]) ** 2).sum(-1))
        base = jsimplex.build_base_simplex(jnp.asarray(dr))
        dc = np.sqrt(((cands[:, None] - refs[None]) ** 2).sum(-1))
        coords = np.array(jsimplex.apex_project(base, jnp.asarray(dc)))
        coords[100:110] = coords[95:105]
        coords[200:210] = coords[:10]
        index = {"coords": coords, "refs": refs,
                 "chol": np.asarray(base.chol),
                 "diag_g": np.asarray(base.diag_g), "d0": np.asarray(base.d0)}
        assert plan.in_specs[2]["coords"] == P("data", None)
    else:
        index = cands
        assert plan.in_specs[2] == P("data", None)
    with jmesh.make_host_mesh(1, 1):
        want = _np(jax.jit(jplan.fn)(jax.tree.map(jnp.asarray, params),
                                     jax.tree.map(jnp.asarray, batch),
                                     jax.tree.map(jnp.asarray, index)))
    mesh = _mesh((2, 2))
    placed = tsteps.place_args(plan, mesh, {
        k: torch.from_numpy(np.array(v))
        for k, v in flat_state(params).items()})
    tindex = ({k: partition.place(torch.from_numpy(np.array(v)),
                                  plan.in_specs[2][k], mesh)
               for k, v in index.items()}
              if mode == "zen" else partition.place(
                  torch.from_numpy(index), plan.in_specs[2], mesh))
    got = plan.fn(placed, _torch_batch(batch), tindex)
    assert got["ids"].dtype == torch.int32 and got["ids"].shape == (3, 100)
    if mode == "dense":
        np.testing.assert_array_equal(got["scores"].numpy(), want["scores"])
    else:
        np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got["ids"].numpy(), want["ids"])


def test_sharded_topk_keeps_lax_top_k_order():
    """Integer scores full of ties over rows split in 4 blocks of 2 x 2:
    the ids of ``lax.top_k``, largest first and (negated) smallest
    first."""
    rng = np.random.default_rng(2)
    rows = rng.integers(0, 3, (64, 2)).astype(np.float32)
    q = np.ones((5, 2), np.float32)
    q[1:] = rng.integers(-2, 3, (4, 2))
    st = partition.place(torch.from_numpy(rows), P(("data", "model"), None),
                         _mesh((2, 2)))
    for largest in (True, False):
        s, ids = trec.sharded_topk(torch.from_numpy(q), st, 20,
                                   trec.retrieval_scores, largest=largest)
        scores = q @ rows.T
        vals, want = jax.lax.top_k(jnp.asarray(scores if largest
                                               else -scores), 20)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            s.numpy(), np.asarray(vals) * (1 if largest else -1))


# -- the trainer, the CLI and checkpoints --------------------------------------------


@pytest.mark.parametrize("shape", MESHES)
def test_two_steps_match_the_unsharded_trainer(shape):
    """Two steps of the CLI's sharded trainer (xDeepFM at 7 fields, the
    padded CIN split) against the port's unsharded trainer from the same
    seed on the trainer's batches; then every holder of every shard holds
    the same bits, and a rerun is the same bits."""
    _, cfg = _cfgs(ODD)
    make = ttrain.batch_fn(cfg, seed=5, batch=B, device="cpu")
    runs = []
    for _ in range(2):
        tr = ttrain.sharded_recsys_trainer(cfg, mesh=_mesh(shape), seed=5)
        runs.append(([tr.step(make(s))[0] for s in range(2)], tr))
    (losses, tr), (again, tr2) = runs
    ref = ttrain.recsys_trainer(cfg, seed=5, device="cpu")
    ref_grads = []
    for s in range(2):
        loss, _ = trec.loss_fn(cfg, ref.model, make(s))
        ref_grads.append({n: g.numpy() for n, g in _grads_of(
            loss, ref.model).items()})
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


def _cli(tmp, arch, shape, steps, *extra):
    return ttrain.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--steps", str(steps), "--batch", str(B),
                        "--data-shards", str(shape[0]), "--model-shards",
                        str(shape[1]), "--ckpt-dir", str(tmp),
                        "--ckpt-every", "2", *extra])


@pytest.mark.parametrize("extra", [(), ("--compress-grads",)],
                         ids=["plain", "compressed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_on_2x2(arch, extra, tmp_path):
    """``--data-shards 2 --model-shards 2 --steps 6`` for every ranking
    model (plain and with --compress-grads): the single device's losses
    (rtol 1e-5; compressed: finite), the batch laid out over data."""
    out = _cli(tmp_path, arch, (2, 2), 6, *extra)
    assert out["mesh"].shape == {"data": 2, "model": 2}
    assert out["batch_shapes"]["sparse"][0] == (B, 8)
    assert len(out["losses"]) == 6 and np.isfinite(out["losses"]).all()
    if not extra:
        one = ttrain.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--steps", "6", "--batch", str(B)])
        np.testing.assert_allclose(out["losses"], one["losses"], rtol=1e-5)


def test_cli_resumes_onto_another_mesh(tmp_path):
    """xDeepFM on 2 x 2: a resume on 2 x 2 from a 2 x 2 save is the
    uninterrupted run, bit for bit; a resume on 1 x 4 matches it within
    the loss rtol; the manifest carries the reference rules' specs
    (``recsys_param_specs``, the moments alike, the step P())."""
    whole = _cli(tmp_path / "w", "xdeepfm", (2, 2), 4)
    _cli(tmp_path / "a", "xdeepfm", (2, 2), 2)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    specs = CheckpointManager(str(tmp_path / "a")).specs()
    rules = trec.param_specs(_cfgs("xdeepfm")[1])
    want = {f"0__{n.replace('.', '__')}": sp for n, sp in rules.items()}
    want.update({f"1__.{m}__{n.replace('.', '__')}": sp
                 for n, sp in rules.items() for m in ("mu", "nu")})
    want["1__.step"] = P()
    assert specs == want
    assert specs["0__table"] == P("model", None)
    assert specs["0__dnn__0__w"] == P(None, "model")
    resumed = _cli(tmp_path / "a", "xdeepfm", (2, 2), 4, "--resume")
    assert resumed["start_step"] == 2
    assert resumed["losses"] == whole["losses"][2:]
    for n, p in whole["trainer"].params.items():
        assert torch.equal(resumed["trainer"].params[n].gather(),
                           p.gather()), n
    moved = _cli(tmp_path / "b", "xdeepfm", (1, 4), 4, "--resume")
    assert moved["start_step"] == 2
    np.testing.assert_allclose(moved["losses"], whole["losses"][2:],
                               rtol=1e-5)


def test_port_restores_a_reference_checkpoint_onto_its_mesh(tmp_path):
    """The reference's CheckpointManager saves Wide&Deep's (params,
    AdamWState) with ``recsys_param_specs``; the port lays each leaf out
    on a 2 x 2 mesh by the stored spec and loads it into a sharded
    trainer, bit for bit."""
    params, _, _, grads = _reference_grads("wide-deep")
    jp = jax.tree.map(jnp.asarray, params)
    st = JaxAdamW(learning_rate=LR).init(jp)
    st = st._replace(step=jnp.int32(3), mu=jax.tree.map(
        lambda g: jnp.asarray(g) * 0.1, jrec.init_params(
            _cfgs("wide-deep")[0], jax.random.PRNGKey(9))))
    pspecs = jsharding.recsys_param_specs(jax.eval_shape(lambda: jp))
    JaxCheckpointManager(str(tmp_path)).save(
        3, (jp, st), (pspecs, jsharding.opt_state_specs(pspecs)))
    mesh = _mesh((2, 2))
    tr = ttrain.sharded_recsys_trainer(_cfgs("wide-deep")[1], mesh=mesh,
                                       seed=0)
    step, tree = CheckpointManager(str(tmp_path)).restore(
        like=tr.state_tree(), mesh=mesh)
    assert step == 3
    for name, leaf in flat_state(tree[0]).items():
        assert leaf.spec == tr.params[name].spec, name
    tr.load_state_tree(tree)
    for name, p in flat_state(params).items():
        np.testing.assert_array_equal(tr.params[name].gather().numpy(), p,
                                      err_msg=name)
    for name, m in flat_state(_np(st.mu)).items():
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
    from repro.models import recsys
    from repro.optim import AdamW

    ckpt, out = sys.argv[1], sys.argv[2]
    assert len(jax.devices()) == 4, jax.devices()
    cfg = configs.get_arch("xdeepfm").make_reduced()
    params = jax.eval_shape(lambda: recsys.init_params(
        cfg, jax.random.PRNGKey(0)))
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


def test_reference_restores_a_port_recsys_checkpoint_onto_four_devices(
        tmp_path):
    """A port xDeepFM checkpoint saved on a 1 x 4 mesh after a step,
    restored by the reference's CheckpointManager onto a forced 4-device
    CPU mesh (a subprocess with XLA_FLAGS=
    --xla_force_host_platform_device_count=4): the same values, and each
    leaf sharded by its spec (the table's rows and the first DNN layer's
    columns over the four devices)."""
    _, cfg = _cfgs("xdeepfm")
    tr = ttrain.sharded_recsys_trainer(cfg, mesh=_mesh((1, 4)), seed=1)
    tr.step(ttrain.batch_fn(cfg, seed=1, batch=B, device="cpu")(0))
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
    assert meta["0__table"]["shard"][0] == cfg.padded_rows // 4
    assert meta["0__dnn__0__w"]["shard"][1] == cfg.mlp[0] // 4
    assert int(arrays["1__.step"]) == 1
