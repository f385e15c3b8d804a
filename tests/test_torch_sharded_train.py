"""The port's LM trainer on a (data, model) mesh against the JAX package's
step and the port's unsharded trainer, on the CPU.

The five LM architectures, reduced (f32; gemma2-2b covers tied
embeddings, both softcaps and the sliding windows, granite-8b and gemma2
the gathered-KV path at M = 4), on CPU meshes of logical shards 1 x 2,
2 x 1, 2 x 2 and 1 x 4 (``launch.mesh.make_host_mesh(..., device=
"cpu")``); the reduced granite-moe-3b-a800m (6 heads) cannot split over 4
model shards and must say so. Weights come from the reference's
``init_params`` through ``convert.transformer_from_arrays(mesh=)``, or
from the port's ``init_params`` and ``init_sharded`` on one seed; tokens
are numpy draws or ``lm_batch``.

Tolerances (``tests/test_torch_lm_train.py``'s): the loss rtol 1e-5,
parameters and moments after a step rtol 1e-4 / atol 1e-6; the sharded
init, routing and slots, replicas and resumed runs on one mesh exact; the
global norm rtol 1e-6. Gradients: every leaf within GRAD_TOL of its
largest |g|. AdamW's update is (m / bc1) / (sqrt(v / bc2) + eps): for a
gradient within GRAD_FLOOR (100 eps) of zero the summation order's
rounding sets the update's size anywhere in (-lr, lr) (on the reduced
configs about one element in 20,000 of a leaf), so such elements are held
to 2 lr a step from the reference instead of the step tolerance
(``_assert_steps_close``).
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
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.checkpoint import flat_state  # noqa: E402
from repro_torch.distributed import partition  # noqa: E402
from repro_torch.distributed.sharding import P  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402
from repro_torch.optim.adamw import clip_by_global_norm  # noqa: E402
from repro_torch.optim.adamw import clip_by_global_norm_sharded  # noqa: E402,E501

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_ARCHS = ["qwen1.5-0.5b", "gemma2-2b", "granite-8b",
            "granite-moe-3b-a800m", "qwen2-moe-a2.7b"]
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
CASES = [(a, m) for a in LM_ARCHS for m in MESHES
         if (a, m) != ("granite-moe-3b-a800m", (1, 4))]
STEP = dict(rtol=1e-4, atol=1e-6)
GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-6
B, S = 4, 32


@pytest.fixture(autouse=True)
def _one_thread():
    """The shards here are small: one intra-op thread runs them faster,
    and keeps the workers of a parallel test run from oversubscribing the
    cores (the file took 870 s of a 6-worker run at the default)."""
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


def _cfg(arch):
    return tconfigs.get_arch(arch).make_reduced()


def _tokens(cfg, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference_step(arch):
    """The reference's weights, tokens and one value_and_grad + AdamW
    step (numpy)."""
    jcfg = jconfigs.get_arch(arch).make_reduced()
    params = jax.jit(lambda k: jtfm.init_params(jcfg, k))(
        jax.random.PRNGKey(7))
    toks = _tokens(jcfg, 7)
    opt = JaxAdamW(learning_rate=ttrain.LEARNING_RATE)

    @jax.jit
    def step(p, st, b):
        (loss, _), g = jax.value_and_grad(
            lambda q: jtfm.loss_fn(jcfg, q, b), has_aux=True)(p)
        upd, st = opt.update(g, st, p)
        return jax.tree.map(lambda a, u: a + u, p, upd), st, loss, g

    p_j, st_j, loss_j, g_j = step(params, opt.init(params),
                                  {"tokens": jnp.asarray(toks)})
    return (_np(params), toks, _np(p_j), _np(st_j.mu), float(loss_j),
            flat_state(_np(g_j)))


def _assert_grads_close(got: dict, want: dict):
    for name, w in want.items():
        g = np.asarray(got[name])
        err = np.abs(g - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), (name, err)


def _assert_steps_close(got: dict, want: dict, grads: list, lr: float):
    """Parameters after len(grads) AdamW steps within STEP, except where a
    step's gradient (any of ``grads``, leaf name -> array) is within
    GRAD_FLOOR of zero: there within 2 lr a step."""
    for name, w in want.items():
        g = np.asarray(got[name])
        small = np.zeros(w.shape, bool)
        for gr in grads:
            small |= np.abs(gr[name]) < GRAD_FLOOR
        np.testing.assert_allclose(g[~small], w[~small], **STEP,
                                   err_msg=name)
        assert np.all(np.abs(g[small] - w[small])
                      <= 2 * lr * len(grads) + STEP["atol"]), name


def _all_replicas_equal(tr):
    st = tr.opt_state
    return all(partition.replicas_equal(t) for t in (
        *tr.params.values(), *st.mu.values(), *st.nu.values(), st.step))


# -- placement and the step --------------------------------------------------------


@pytest.mark.parametrize("arch,shape", CASES)
def test_sharded_init_is_init_params(arch, shape):
    cfg = _cfg(arch)
    want = ttfm.init_params(cfg, generator=torch.Generator().manual_seed(3))
    got = ttfm.init_sharded(cfg, _mesh(shape),
                            generator=torch.Generator().manual_seed(3))
    specs = ttfm.param_specs(cfg)
    for name, p in want.named_parameters():
        st = got.params[name]
        assert st.spec == specs[name]
        assert torch.equal(st.gather(), p.detach()), name
        for pos, s in enumerate(st.shards):
            blk = partition.block(st.shape, st.spec, st.mesh, pos)
            assert torch.equal(s.detach(), p.detach()[blk]), (name, pos)


def test_granite_moe_does_not_split_over_four_model_shards():
    """granite-moe-reduced's 6 heads do not split over 4 model shards: the
    leaves keep the reference's layout and attention runs re-laid out over
    the sequence; the step's loss and gradients are the reference's."""
    arch, shape = "granite-moe-3b-a800m", (1, 4)
    cfg = _cfg(arch)
    assert cfg.n_heads % 4 and ttfm._column_attention(cfg, 4)
    params, toks, _, _, loss_j, g_j = _reference_step(arch)
    model = convert.transformer_from_arrays(cfg, params, mesh=_mesh(shape))
    loss, _, grads = ttrain.ShardedTrainer(model).reduced_grads(
        {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-5)
    _assert_grads_close({n: g.gather().numpy() for n, g in grads.items()},
                        g_j)


@pytest.mark.parametrize("arch,shape", CASES)
def test_step_matches_the_reference(arch, shape):
    """One ``ShardedTrainer.step`` against the reference's value_and_grad
    + AdamW step on the same weights and tokens."""
    cfg = _cfg(arch)
    params, toks, p_j, mu_j, loss_j, g_j = _reference_step(arch)
    model = convert.transformer_from_arrays(cfg, params, mesh=_mesh(shape))
    tr = ttrain.ShardedTrainer(model)
    batch = {"tokens": torch.from_numpy(toks)}
    _, _, grads = tr.reduced_grads(batch)
    _assert_grads_close({n: g.gather().numpy() for n, g in grads.items()},
                        g_j)
    del grads
    loss, aux = tr.step(batch)
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-5)
    assert aux["ntokens"].item() == B * (S - 1)
    _assert_steps_close({n: p.gather().numpy() for n, p in tr.params.items()},
                        flat_state(p_j), [g_j], ttrain.LEARNING_RATE)
    for name, m in flat_state(mu_j).items():
        np.testing.assert_allclose(tr.opt_state.mu[name].gather().numpy(),
                                   m, **STEP, err_msg=name)


@pytest.mark.parametrize("arch,shape", CASES)
def test_two_steps_match_the_unsharded_trainer(arch, shape):
    """Two steps on the mesh against the port's unsharded trainer from the
    same seed on the same batches; then every holder of every shard of
    the parameters, moments and step holds the same bits."""
    cfg = _cfg(arch)
    tr = ttrain.sharded_lm_trainer(cfg, mesh=_mesh(shape), seed=5)
    ref = ttrain.lm_trainer(cfg, seed=5, device="cpu")
    make = ttrain.lm_batch_fn(cfg, seed=5, batch=B, seq=S, device="cpu")
    ref_grads = []
    for step in range(2):
        batch = make(step)
        loss, _ = ttfm.loss_fn(cfg, ref.model, batch)
        ref_grads.append({n: g.numpy() for n, g in zip(
            ref.params, torch.autograd.grad(loss, list(ref.params.values())))})
        got, _ = tr.step(batch)
        want, _ = ref.step(batch)
        np.testing.assert_allclose(got.item(), want.item(), rtol=1e-5)
    _assert_steps_close(
        {n: p.gather().numpy() for n, p in tr.params.items()},
        {n: p.detach().numpy() for n, p in ref.params.items()}, ref_grads,
        ttrain.LEARNING_RATE)
    assert int(tr.opt_state.step.gather()) == 2
    assert _all_replicas_equal(tr)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_sharded_remat_recomputes_the_same_bits(arch):
    """Remat "minimal" on a 2 x 2 mesh (each layer group through
    ``layers.RematGroup``: recomputed and differentiated in one
    call) gives the loss and gradients of no remat, bit for bit."""
    base = _cfg(arch)
    out = []
    for policy in ("none", "minimal"):
        cfg = dataclasses.replace(base, remat_policy=policy)
        model = ttfm.init_sharded(cfg, _mesh((2, 2)),
                                  generator=torch.Generator().manual_seed(6))
        batch = ttrain.lm_batch_fn(cfg, seed=6, batch=B, seq=S,
                                   device="cpu")(0)
        loss, _, grads = ttrain.sharded_grads(model, batch)
        out.append((loss, {n: g.gather() for n, g in grads.items()}))
    assert torch.equal(out[0][0], out[1][0])
    for name, g in out[0][1].items():
        assert torch.equal(out[1][1][name], g), name
    with pytest.raises(ValueError, match="no sharded form"):
        ttfm.sharded_loss_fn(
            dataclasses.replace(base, remat_policy="dots"),
            ttfm.init_sharded(base, _mesh((1, 2)),
                              generator=torch.Generator().manual_seed(6)),
            batch)


@pytest.mark.parametrize("arch,M", [("granite-moe-3b-a800m", 2),
                                    ("qwen2-moe-a2.7b", 2),
                                    ("qwen2-moe-a2.7b", 4)])
def test_moe_routing_is_exact(arch, M, monkeypatch):
    """``moe_ffn_sharded`` on M model shards routes every token and claims
    every slot exactly as ``moe_ffn`` does on the same input, and its
    output agrees."""
    cfg = _cfg(arch)
    model = ttfm.init_params(cfg, generator=torch.Generator().manual_seed(2))
    mesh = _mesh((1, M))
    specs = ttfm.param_specs(cfg)
    sharded = ttfm.ShardedTransformer(cfg, mesh, {
        n: partition.place(p.detach(), specs[n], mesh)
        for n, p in model.named_parameters()})
    x = torch.randn((2, 64, cfg.d_model),
                    generator=torch.Generator().manual_seed(9))
    calls = []
    orig = tmoe.route

    def recording(c, router, xt):
        out = orig(c, router, xt)
        calls.append(out)
        return out

    monkeypatch.setattr(tmoe, "route", recording)
    with torch.no_grad():
        want = tmoe.moe_ffn(cfg, ttfm.layer_params(cfg, model)[0][0], x)
        (gate_u, idx_u), = calls
        calls.clear()
        ps = [ttfm._local_layers(cfg, sharded, i)[0][0] for i in range(M)]
        got = tmoe.moe_ffn_sharded(cfg, ps, [x] * M, total_tokens=2 * 64)
    E = tmoe.padded_experts(cfg.n_experts)
    C = tmoe.capacity(min(cfg.moe_group_size, 128), cfg.top_k, E,
                      cfg.capacity_factor)
    assert len(calls) == M
    for gate, idx in calls:
        assert torch.equal(idx, idx_u) and torch.equal(gate, gate_u)
        assert all(torch.equal(a, b) for a, b in zip(
            tmoe.slots(idx, E, C), tmoe.slots(idx_u, E, C)))
    for out in got:
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_clip_counts_a_replicated_leaf_once():
    """On a 2 x 2 mesh a replicated leaf has four holders and a
    model-sharded one two a shard: the global norm is the unsharded
    one's, where summing every holder's squares would read larger. The
    clip is active and every holder gets the same scaled bits."""
    mesh = _mesh((2, 2))
    gen = torch.Generator().manual_seed(1)
    whole = {"rep": torch.randn((6,), generator=gen),
             "col": torch.randn((3, 8), generator=gen)}
    specs = {"rep": P(), "col": P(None, "model")}
    grads = {n: partition.place(g, specs[n], mesh) for n, g in whole.items()}
    gn = clip_by_global_norm_sharded(grads, 1.0)
    ref = {n: g.clone() for n, g in whole.items()}
    _, gn_ref = clip_by_global_norm(ref, 1.0)
    assert float(gn_ref) > 1.0
    np.testing.assert_allclose(float(gn), float(gn_ref), rtol=1e-6)
    every_holder = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(s) for g in grads.values()
         for s in g.shards]))
    assert not np.isclose(float(every_holder), float(gn_ref), rtol=1e-2)
    for n, g in grads.items():
        assert partition.replicas_equal(g)
        np.testing.assert_allclose(g.gather().numpy(), ref[n].numpy(),
                                   rtol=1e-6, atol=1e-7)


# -- the plan ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape", [("qwen1.5-0.5b", (2, 2)),
                                        ("qwen2-moe-a2.7b", (1, 2))])
def test_plan_matches_the_reference_plan(arch, shape):
    """``build_plan(..., "train_4k", n_microbatches=2)``'s fn on a mesh
    against the reference plan's fn (under a 1 x 1 host mesh) on the same
    weights and tokens."""
    over = {"n_microbatches": 2}
    jplan = jsteps.build_plan(arch, "train_4k", reduced=True,
                              overrides=over)
    tplan = tsteps.build_plan(arch, "train_4k", reduced=True,
                              overrides=over)
    assert (tplan.kind, tplan.cfg.n_microbatches) == ("train", 2)
    for (name, meta), (_, spec) in zip(tplan.args[0].items(),
                                       tplan.in_specs[0].items()):
        assert meta.device.type == "meta" and isinstance(spec, P), name
    params = _reference_step(arch)[0]
    toks = np.random.default_rng(11).integers(
        0, tplan.cfg.vocab_size, (B, S)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, params)
    with jmesh.make_host_mesh(1, 1):
        p_j, st_j, aux_j = jax.jit(jplan.fn)(
            jp, jsteps.make_optimizer().init(jp),
            {"tokens": jnp.asarray(toks)})
    mesh = _mesh(shape)
    cfg = tplan.cfg
    whole = {k: convert._leaf_tensor(v, cfg.dtype, "cpu")
             for k, v in flat_state(params).items()}
    placed, ost = tsteps.place_args(tplan, mesh, whole)
    p_t, st_t, aux_t = tplan.fn(placed, ost, {"tokens": torch.from_numpy(
        toks)})
    np.testing.assert_allclose(aux_t["loss"].item(), float(aux_j["loss"]),
                               rtol=1e-5)
    # the accumulated gradient, for _assert_steps_close's floor
    model = convert.transformer_from_arrays(cfg, params, device="cpu")
    mean = {n: 0.0 for n, _ in model.named_parameters()}
    for mb in np.split(toks, 2):
        loss, _ = ttfm.loss_fn(cfg, model, {"tokens": torch.from_numpy(mb)})
        for (n, _), g in zip(model.named_parameters(), torch.autograd.grad(
                loss, list(model.parameters()))):
            mean[n] = mean[n] + g.numpy() / 2
    _assert_steps_close({n: p.gather().numpy() for n, p in p_t.items()},
                        flat_state(_np(p_j)), [mean], 3e-4)
    for name, m in flat_state(_np(st_j.mu)).items():
        np.testing.assert_allclose(st_t.mu[name].gather().numpy(), m,
                                   **STEP, err_msg=name)
    assert int(st_t.step.gather()) == int(st_j.step) == 1


def test_plans_not_ported_raise():
    """Nothing raises any more: the multi-pod plans are built, their
    inputs over ("pod", "data"); the LM prefill and decode plans, MACE's
    train plan and every recsys plan are built (their steps are held to
    the reference's in tests/test_torch_sharded_lm_serve.py,
    tests/test_torch_sharded_gnn.py, tests/test_torch_sharded_recsys.py
    and, on the (pod, data, model) mesh, tests/test_torch_dryrun.py)."""
    for cell in tconfigs.get_arch("qwen1.5-0.5b").cells:
        plan = tsteps.build_plan("qwen1.5-0.5b", cell.shape, reduced=True)
        assert (plan.kind, plan.skip) == (cell.kind, cell.skip)
    dp = ("pod", "data")
    for arch, shape, key in (("qwen1.5-0.5b", "train_4k", "tokens"),
                             ("mace", "molecule", "senders"),
                             ("dlrm-rm2", "train_batch", "sparse")):
        plan = tsteps.build_plan(arch, shape, reduced=True, multi_pod=True)
        assert plan.in_specs[2][key].axes(0) == dp
    plan = tsteps.build_plan("mace", "molecule", reduced=True)
    assert (plan.kind, plan.cfg.d_feat, plan.cfg.edge_chunks) == (
        "train", 16, 1)
    for cell in ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand"):
        plan = tsteps.build_plan("dlrm-rm2", cell, reduced=True)
        assert plan.kind == tconfigs.get_arch("dlrm-rm2").cell(cell).kind
    zen = tsteps.build_plan("dlrm-rm2", "retrieval_cand",
                            overrides={"retrieval_mode": "zen"})
    assert set(zen.in_specs[2]) == {"coords", "refs", "chol", "diag_g", "d0"}
    opt = tsteps.make_optimizer()
    assert (opt.learning_rate, opt.weight_decay, opt.clip_norm) == (
        3e-4, 0.01, 1.0)


# -- compression over data replicas -------------------------------------------------


def test_compression_mean_matches_the_reference_vmap():
    """``error_feedback_mean`` over 4 replicas against the reference's
    ``error_feedback_update(..., axis_name="d")`` under ``jax.vmap``."""
    rng = np.random.default_rng(0)
    D = 4
    shapes = {"a": (8, 16), "b": {"c": (5,)}}
    leaf = lambda s: isinstance(s, tuple)
    g = jax.tree.map(lambda s: rng.standard_normal((D,) + s)
                     .astype(np.float32), shapes, is_leaf=leaf)
    e = jax.tree.map(lambda s: (rng.standard_normal((D,) + s) * 0.01)
                     .astype(np.float32), shapes, is_leaf=leaf)
    jg, jst = jax.vmap(lambda g, e: jcomp.error_feedback_update(
        g, jcomp.CompressionState(e), axis_name="d"), axis_name="d")(g, e)
    fg, fe = flat_state(g), flat_state(e)
    tg, tst = tcomp.error_feedback_mean(
        [{k: torch.from_numpy(v[r]) for k, v in fg.items()}
         for r in range(D)],
        [tcomp.CompressionState({k: torch.from_numpy(v[r])
                                 for k, v in fe.items()})
         for r in range(D)])
    want_g, want_e = flat_state(_np(jg)), flat_state(_np(jst.error))
    for r in range(D):
        for k in fg:
            np.testing.assert_allclose(tg[r][k].numpy(), want_g[k][r],
                                       rtol=1e-6, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(tst[r].error[k].numpy(),
                                       want_e[k][r], rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        for k in fg:  # every replica holds the same mean
            assert torch.equal(tg[r][k], tg[0][k])


def test_sharded_compression_is_the_replica_mean():
    """On 2 x 2, the trainer's compressed gradients are
    ``error_feedback_mean`` of the data replicas' own gradients (D times
    each replica's share, summed over its model holders), one scale a
    whole tensor across its model shards."""
    cfg = _cfg("qwen1.5-0.5b")
    mesh = _mesh((2, 2))
    tr = ttrain.sharded_lm_trainer(cfg, mesh=mesh, seed=4,
                                   compress_grads=True)
    batch = ttrain.lm_batch_fn(cfg, seed=4, batch=B, seq=S,
                               device="cpu")(0)
    _, _, grads = tr.grads(batch)
    rows = partition.axis_groups(mesh, "model")
    replicas = []
    for row in rows:
        mine = {}
        for n, g in grads.items():
            part = {}
            for pos in row:
                key = partition.shard_key(g.spec, mesh, pos)
                part[key] = (part[key] + g.shards[pos]) if key in part \
                    else g.shards[pos].clone()
            whole = torch.empty(g.shape)
            for pos in row:
                key = partition.shard_key(g.spec, mesh, pos)
                whole[partition.block(g.shape, g.spec, mesh, pos)] = part[key]
            mine[n] = whole * 2
        replicas.append(mine)
    zeros = {n: torch.zeros(g.shape) for n, g in grads.items()}
    want, _ = tcomp.error_feedback_mean(
        replicas, [tcomp.CompressionState(zeros)] * 2)
    tr._compress(grads)
    for n, g in grads.items():
        assert partition.replicas_equal(g)
        np.testing.assert_allclose(g.gather().numpy(), want[0][n].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=n)


# -- the CLI, its checkpoints, and checkpoints both ways ----------------------------------


def _cli(tmp, shape, steps, *extra, arch="granite-8b"):
    return ttrain.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--steps", str(steps), "--seq", str(S), "--batch",
                        str(B), "--data-shards", str(shape[0]),
                        "--model-shards", str(shape[1]), "--ckpt-dir",
                        str(tmp), "--ckpt-every", "2", *extra])


def test_cli_resumes_onto_another_mesh(tmp_path):
    """granite-8b (reduced: 8 heads, 2 KV heads, so the gathered-KV path
    on 1 x 4): a 2 x 2 resume from a 2 x 2 save is the uninterrupted 2 x 2
    run, bit for bit; a 2 x 2 resume from a 1 x 4 save matches the
    uninterrupted 1 x 4 run within the loss rtol; the manifest carries
    the rules' specs."""
    whole = _cli(tmp_path / "w", (2, 2), 5)
    assert whole["mesh"].shape == {"data": 2, "model": 2}
    _cli(tmp_path / "a", (2, 2), 3)
    resumed = _cli(tmp_path / "a", (2, 2), 5, "--resume")
    assert resumed["start_step"] == 2
    assert resumed["losses"] == whole["losses"][2:]
    for n, p in whole["trainer"].params.items():
        assert torch.equal(resumed["trainer"].params[n].gather(),
                           p.gather()), n
    wide = _cli(tmp_path / "m", (1, 4), 5)
    _cli(tmp_path / "b", (1, 4), 3)
    specs = CheckpointManager(str(tmp_path / "b")).specs()
    assert specs["0__layers__wq"] == P(None, None, None, "model")
    assert specs["1__.mu__embed"] == P("model", None)
    assert specs["1__.step"] == P()
    moved = _cli(tmp_path / "b", (2, 2), 5, "--resume")
    assert moved["start_step"] == 2
    np.testing.assert_allclose(moved["losses"], wide["losses"][2:],
                               rtol=1e-5)
    assert np.isfinite(whole["losses"]).all()


def test_cli_with_compression_on_a_mesh(tmp_path):
    out = _cli(tmp_path, (2, 2), 3, "--compress-grads",
               arch="qwen2-moe-a2.7b")
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert out["trainer"].comp_state is not None


def test_shards_for_other_families_and_multihost_raise(monkeypatch):
    """--multihost without the launcher's environment raises for every
    family, naming the missing variables (its runs are held in
    tests/test_torch_multihost.py); MACE and the recsys family train on a
    mesh (their runs are held in tests/test_torch_sharded_gnn.py and
    tests/test_torch_sharded_recsys.py)."""
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    for arch in ("qwen1.5-0.5b", "mace", "dlrm-rm2"):
        with pytest.raises(RuntimeError, match="MASTER_ADDR, MASTER_PORT"):
            ttrain.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--multihost"])
    for arch in ("mace", "dlrm-rm2"):
        out = ttrain.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--model-shards", "2", "--steps", "1"])
        assert out["mesh"].shape == {"data": 1, "model": 2}
        assert len(out["losses"]) == 1 and np.isfinite(out["losses"]).all()


def test_port_restores_a_reference_checkpoint_onto_its_mesh(tmp_path):
    """The reference's CheckpointManager saves (params, AdamWState) with
    the rules' specs; the port lays each leaf out on a 2 x 2 mesh by the
    stored spec and loads it into a sharded trainer, bit for bit."""
    arch = "granite-8b"
    _, _, p_j, mu_j, _, _ = _reference_step(arch)
    jp = jax.tree.map(jnp.asarray, p_j)
    st = JaxAdamW(learning_rate=3e-4).init(jp)
    st = st._replace(step=jnp.int32(3), mu=jax.tree.map(jnp.asarray, mu_j))
    pspecs = jsharding.lm_param_specs(jax.eval_shape(lambda: jp))
    JaxCheckpointManager(str(tmp_path)).save(
        3, (jp, st), (pspecs, jsharding.opt_state_specs(pspecs)))
    mesh = _mesh((2, 2))
    tr = ttrain.sharded_lm_trainer(_cfg(arch), mesh=mesh, seed=0)
    step, tree = CheckpointManager(str(tmp_path)).restore(
        like=tr.state_tree(), mesh=mesh)
    assert step == 3
    for name, leaf in flat_state(tree[0]).items():
        assert leaf.spec == tr.params[name].spec, name
        assert leaf.shards[1].shape == tr.params[name].shards[1].shape
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
    from repro.models import transformer as tfm
    from repro.optim import AdamW

    ckpt, out = sys.argv[1], sys.argv[2]
    assert len(jax.devices()) == 4, jax.devices()
    cfg = configs.get_arch("granite-8b").make_reduced()
    params = jax.eval_shape(lambda: tfm.init_params(cfg,
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
    """A port checkpoint saved on a 1 x 4 mesh, restored by the reference's
    CheckpointManager onto a forced 4-device CPU mesh (a subprocess with
    XLA_FLAGS=--xla_force_host_platform_device_count=4): the same values,
    and each leaf sharded by its spec."""
    cfg = _cfg("granite-8b")
    tr = ttrain.sharded_lm_trainer(cfg, mesh=_mesh((1, 4)), seed=1)
    tr.step(ttrain.lm_batch_fn(cfg, seed=1, batch=B, seq=S,
                               device="cpu")(0))
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


def test_compressed_cli_resumes_bit_exact_on_its_mesh(tmp_path):
    """With --compress-grads on 2 x 2 the data replicas' error buffers are
    a checkpoint leaf each ((D, ...) laid out P("data", ...)): a resume on
    2 x 2 is the uninterrupted run, bit for bit; a resume on 1 x 4 (one
    data replica) starts its buffers from zero and stays within the loss
    rtol."""
    args = ("--compress-grads",)
    whole = _cli(tmp_path / "w", (2, 2), 4, *args, arch="qwen1.5-0.5b")
    _cli(tmp_path / "a", (2, 2), 3, *args, arch="qwen1.5-0.5b")
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    specs = CheckpointManager(str(tmp_path / "a")).specs()
    assert specs["2__error__layers__wq"] == P("data", None, None, None,
                                              "model")
    resumed = _cli(tmp_path / "a", (2, 2), 4, "--resume", *args,
                   arch="qwen1.5-0.5b")
    assert resumed["start_step"] == 2
    assert resumed["losses"] == whole["losses"][2:]
    for n, p in whole["trainer"].params.items():
        assert torch.equal(resumed["trainer"].params[n].gather(),
                           p.gather()), n
    moved = _cli(tmp_path / "b", (1, 4), 4, "--resume", *args,
                 arch="qwen1.5-0.5b")
    assert moved["start_step"] == 2
    np.testing.assert_allclose(moved["losses"], whole["losses"][2:],
                               rtol=1e-5)


def test_cli_cuts_depth_and_repeats_a_batch():
    """--layers keeps the widths at a cut depth; --fixed-batch takes step
    0's batch every step, and the loss falls on it."""
    out = ttrain.main(["--arch", "granite-8b", "--reduced", "--device",
                       "cpu", "--steps", "4", "--seq", str(S), "--batch",
                       str(B), "--model-shards", "2", "--layers", "1",
                       "--fixed-batch"])
    cfg = out["trainer"].cfg
    assert cfg.n_layers == 1 and cfg.d_model == _cfg("granite-8b").d_model
    losses = out["losses"]
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    fresh = ttrain.main(["--arch", "granite-8b", "--reduced", "--device",
                         "cpu", "--steps", "1", "--seq", str(S), "--batch",
                         str(B), "--model-shards", "2", "--layers", "1"])
    assert fresh["losses"] == losses[:1]
    with pytest.raises(ValueError, match="--layers"):
        ttrain.main(["--arch", "mace", "--reduced", "--device", "cpu",
                     "--layers", "1"])
