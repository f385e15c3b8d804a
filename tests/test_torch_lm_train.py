"""The port's LM training and its JSD leg against the JAX package, on the
CPU: one ``Trainer.step`` against the reference's ``value_and_grad`` +
AdamW step, AdamW and the clip on bf16 leaves, the trainer CLI and its
resume, checkpoints of bf16 LM state both ways, ``train_lm`` and
``next_token_distributions`` (``repro_torch.launch.train_lm`` against
``examples/train_lm.py``); the reduced JSD serving leg is in
``tests/test_torch_lm_jsd.py``.

Weights come from the reference's ``init_params`` through
``convert.transformer_from_arrays``; tokens are numpy draws. Tolerances:
the trainer step's loss rtol 1e-5 and its parameters rtol 1e-4 / atol
1e-6 (the recsys trainer tests'); one AdamW update on bf16 leaves: the
moments rtol 1e-6 (with a floor of two f32 ulps of the leaf's largest
value), the bf16 updates and clipped gradients within one bf16 ulp (each
is one rounding of f32 values that agree to an f32 ulp), ``p + u`` exact;
next-token rows rtol 1e-5 / atol 1e-7; the CLI's resumed losses and
checkpoints bit for bit.
"""
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402,E501
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.optim.adamw import AdamWState as JaxAdamWState  # noqa: E402
from repro.optim.adamw import clip_by_global_norm as jclip  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.checkpoint import flat_state  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch import train_lm as ttrain_lm  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.optim import AdamW, apply_updates  # noqa: E402
from repro_torch.optim import clip_by_global_norm as tclip  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP = dict(rtol=1e-4, atol=1e-6)
BF16_ULP = 2**-8


@pytest.fixture(autouse=True)
def _x32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


@pytest.fixture(scope="module")
def example():
    """``examples/train_lm.py``, the reference of ``launch/train_lm.py``."""
    spec = importlib.util.spec_from_file_location(
        "train_lm_reference", os.path.join(ROOT, "examples", "train_lm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _reduced(arch, dtype=None):
    jcfg = jconfigs.get_arch(arch).make_reduced()
    tcfg = tconfigs.get_arch(arch).make_reduced()
    if dtype == "bfloat16":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    return jcfg, tcfg


# -- the train step --------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-3b-a800m"])
def test_trainer_step_matches_the_reference(arch):
    jcfg, tcfg = _reduced(arch)
    params = jax.jit(lambda k: jtfm.init_params(jcfg, k))(
        jax.random.PRNGKey(4))
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    opt = JaxAdamW(learning_rate=ttrain.LEARNING_RATE)

    @jax.jit
    def step(p, st, b):
        (loss, _), g = jax.value_and_grad(
            lambda q: jtfm.loss_fn(jcfg, q, b), has_aux=True)(p)
        upd, st = opt.update(g, st, p)
        return jax.tree.map(lambda a, u: a + u, p, upd), st, loss

    p_j, st_j, loss_j = step(params, opt.init(params),
                             {"tokens": jnp.asarray(toks)})
    model = convert.transformer_from_arrays(tcfg, _np(params), device="cpu")
    trainer = ttrain.Trainer(model, lambda m, b: ttfm.loss_fn(tcfg, m, b))
    loss_t, aux = trainer.step({"tokens": _t(toks)})
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    assert aux["ntokens"].item() == 2 * 63
    assert int(trainer.opt_state.step) == int(st_j.step) == 1
    for name, p in flat_state(_np(p_j)).items():
        np.testing.assert_allclose(trainer.params[name].detach().numpy(), p,
                                   **STEP, err_msg=name)
    for name, m in flat_state(_np(st_j.mu)).items():
        np.testing.assert_allclose(trainer.opt_state.mu[name].numpy(), m,
                                   **STEP, err_msg=name)


def _bf16_state(seed):
    """bf16 params and gradients, f32 moments at step 4, drawn in numpy
    (bf16 as the reference rounds f32 draws)."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": (64, 16), "layers": {"wq": (2, 1, 16, 16),
                                            "ln1": (2, 1, 16)}}

    def draw(scale, positive=False):
        return jax.tree.map(
            lambda s: (np.abs if positive else np.asarray)(
                rng.standard_normal(s).astype(np.float32) * scale),
            shapes, is_leaf=lambda s: isinstance(s, tuple))

    bf = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), t)
    params, grads = bf(draw(1.0)), bf(draw(2.0))
    state = JaxAdamWState(step=jnp.int32(4), mu=jax.tree.map(
        jnp.asarray, draw(0.01)), nu=jax.tree.map(jnp.asarray,
                                                  draw(1e-4, True)))
    return params, grads, state


def _bits(x):
    return x.detach().view(torch.int16).numpy().view(np.uint16)


def _to_port(tree):
    return {k: convert._leaf_tensor(v, torch.bfloat16, "cpu")
            for k, v in flat_state(_np(tree)).items()}


def test_adamw_update_on_bf16_leaves_matches_the_reference():
    """f32 moments, the clip and the update computed in f32 and cast once
    to bf16, ``p + u`` in bf16; the clip is active (global norm > 1)."""
    params, grads, state = _bf16_state(0)
    clipped_j, gn_j = jclip(grads, 1.0)
    assert float(gn_j) > 1.0
    clipped_t, gn_t = tclip(_to_port(grads), 1.0)
    np.testing.assert_allclose(float(gn_t), float(gn_j), rtol=1e-6)
    for name, g in flat_state(_np(clipped_j)).items():
        assert clipped_t[name].dtype == torch.bfloat16
        np.testing.assert_allclose(clipped_t[name].float().numpy(),
                                   g.astype(np.float32), rtol=BF16_ULP,
                                   atol=0, err_msg=name)

    upd_j, st_j = JaxAdamW(learning_rate=1e-3).update(grads, state, params)
    st_t = convert.adamw_state_from_arrays(
        (np.asarray(state.step), _np(state.mu), _np(state.nu)),
        device="cpu")
    p_t = _to_port(params)
    upd_t, st_t2 = AdamW(learning_rate=1e-3).update(_to_port(grads), st_t,
                                                    p_t)
    for which in ("mu", "nu"):
        for name, m in flat_state(_np(getattr(st_j, which))).items():
            np.testing.assert_allclose(
                getattr(st_t2, which)[name].numpy(), m, rtol=1e-6,
                atol=2 * 2**-23 * np.abs(m).max(), err_msg=name)
    for name, u in flat_state(_np(upd_j)).items():
        assert upd_t[name].dtype == torch.bfloat16
        np.testing.assert_allclose(upd_t[name].float().numpy(),
                                   u.astype(np.float32), rtol=BF16_ULP,
                                   atol=0, err_msg=name)
    # p + u in bf16: the port's sum of the port's updates is the
    # reference's sum of the same two bf16 tensors, bit for bit
    want = {name: np.asarray(jnp.asarray(p) + jnp.asarray(
        upd_t[name].float().numpy(), jnp.bfloat16))
        for name, p in flat_state(_np(params)).items()}
    apply_updates(p_t, upd_t)
    for name, w in want.items():
        np.testing.assert_array_equal(_bits(p_t[name]), w.view(np.uint16),
                                      err_msg=name)


# -- the CLI and checkpoints -----------------------------------------------------


def _cli(tmp, steps, *extra):
    return ttrain.main(["--arch", "qwen1.5-0.5b", "--reduced", "--device",
                        "cpu", "--steps", str(steps), "--seq", "64",
                        "--batch", "4", "--ckpt-dir", str(tmp),
                        "--ckpt-every", "5", *extra])


def test_lm_cli_resume_is_bit_exact(tmp_path):
    """12 steps with checkpoints at 5 and 10, then a resume from 10 to 14:
    its losses are an uninterrupted 14-step run's, bit for bit, and so are
    its final parameters; the batches are --batch x --seq tokens."""
    first = _cli(tmp_path / "a", 12)
    assert first["batch_shapes"] == {"tokens": ((4, 64), torch.int32)}
    assert sorted(os.listdir(tmp_path / "a")) == ["step_0000000005",
                                                  "step_0000000010"]
    resumed = _cli(tmp_path / "a", 14, "--resume")
    assert resumed["start_step"] == 10
    whole = _cli(tmp_path / "b", 14)
    assert first["losses"] == whole["losses"][:12]
    assert resumed["losses"] == whole["losses"][10:]
    assert np.isfinite(whole["losses"]).all()
    for name, p in whole["trainer"].params.items():
        assert torch.equal(resumed["trainer"].params[name], p), name


def test_lm_cli_refuses_what_is_not_ported(monkeypatch):
    # the GNN family is ported: one reduced step on the CPU
    out = ttrain.main(["--arch", "mace", "--reduced", "--device", "cpu",
                       "--steps", "1", "--batch", "2"])
    assert out["batch_shapes"]["n_graphs"] == 2
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"]).all()
    # every family trains on a mesh (tests/test_torch_sharded_train.py,
    # tests/test_torch_sharded_gnn.py, tests/test_torch_sharded_recsys.py);
    # one process a host needs the launcher's environment
    # (tests/test_torch_multihost.py)
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="needs RANK"):
        ttrain.main(["--arch", "dlrm-rm2", "--reduced", "--device", "cpu",
                     "--model-shards", "2", "--multihost"])


def test_lm_checkpoints_are_the_same_bytes_both_ways(tmp_path):
    """A bf16 LM's (params, AdamWState) written by the port and by the
    reference: the same files, byte for byte; each restores the other's."""
    jcfg, tcfg = _reduced("gemma2-2b", "bfloat16")
    params = jax.jit(lambda k: jtfm.init_params(jcfg, k))(
        jax.random.PRNGKey(6))
    rng = np.random.default_rng(6)
    mu = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
        a.shape).astype(np.float32)), params)
    nu = jax.tree.map(lambda a: jnp.abs(a) * 1e-3, mu)
    jtree = (params, JaxAdamWState(step=jnp.int32(7), mu=mu, nu=nu))
    trainer = ttrain.Trainer(convert.transformer_from_arrays(
        tcfg, _np(params), device="cpu"), None)
    trainer.opt_state = convert.adamw_state_from_arrays(
        (np.int32(7), _np(mu), _np(nu)), device="cpu")
    dj = JaxCheckpointManager(str(tmp_path / "jax")).save(7, jtree)
    dt = CheckpointManager(str(tmp_path / "port")).save(
        7, trainer.state_tree())
    files = sorted(os.listdir(dj))
    assert files == sorted(os.listdir(dt))
    assert "0__layers__wq.npy" in files and "1__.mu__embed.npy" in files
    for f in files:
        if f.endswith(".npy"):
            with open(os.path.join(dj, f), "rb") as a, \
                    open(os.path.join(dt, f), "rb") as b:
                assert a.read() == b.read(), f
    mj = json.load(open(os.path.join(dj, "manifest.json")))
    mt = json.load(open(os.path.join(dt, "manifest.json")))
    assert mj == mt
    assert {e["dtype"] for e in mt["leaves"]} == {"bfloat16", "float32",
                                                  "int32"}
    # the reference's checkpoint into a fresh port trainer
    fresh = ttrain.lm_trainer(tcfg, seed=3, device="cpu")
    step, tree = CheckpointManager(str(tmp_path / "jax")).restore(
        like=fresh.state_tree())
    fresh.load_state_tree(tree)
    assert step == 7 and int(fresh.opt_state.step) == 7
    for name, p in flat_state(_np(params)).items():
        np.testing.assert_array_equal(_bits(fresh.params[name]),
                                      p.view(np.uint16), err_msg=name)
    # the port's checkpoint into the reference
    like = jax.tree.map(jnp.zeros_like, jtree)
    step, back = JaxCheckpointManager(str(tmp_path / "port")).restore(
        like=like)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- train_lm and the next-token rows -------------------------------------------


def test_next_token_distributions_match_the_reference(example):
    """On the same weights and tokens, with the vocabulary padded (500 ->
    512): the rows, their sums, and exact zeros in the padded columns."""
    jcfg, tcfg = _reduced("qwen1.5-0.5b")
    jcfg = dataclasses.replace(jcfg, vocab_size=500)
    tcfg = dataclasses.replace(tcfg, vocab_size=500)
    assert tcfg.padded_vocab == 512
    params = jax.jit(lambda k: jtfm.init_params(jcfg, k))(
        jax.random.PRNGKey(8))
    model = convert.transformer_from_arrays(tcfg, _np(params), device="cpu")
    toks = np.asarray(jsyn.lm_markov_batch(1, 0, 12, 16, 500)["tokens"])
    for temp in (1.0, 6.0):
        want = np.asarray(example.next_token_distributions(
            jcfg, params, jnp.asarray(toks), temperature=temp))
        got = ttrain_lm.next_token_distributions(tcfg, model, _t(toks),
                                                 temperature=temp).numpy()
        assert got.shape == (12, 512) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        assert (got[:, 500:] == 0).all()
        np.testing.assert_allclose(got.sum(1), np.ones(12), atol=1e-5)


def test_train_lm_trains_resumes_and_defaults_to_reduced_qwen(tmp_path):
    cfg, model, losses = ttrain_lm.train_lm(
        20, batch=4, seq=32, data="markov", device="cpu",
        ckpt_dir=str(tmp_path))
    assert cfg == tconfigs.get_arch("qwen1.5-0.5b").make_reduced()
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert os.listdir(tmp_path) == ["step_0000000020"]
    _, again, more = ttrain_lm.train_lm(
        22, batch=4, seq=32, data="markov", device="cpu",
        ckpt_dir=str(tmp_path), resume=True)
    assert len(more) == 2
    whole = ttrain_lm.train_lm(22, batch=4, seq=32, data="markov",
                               device="cpu")[2]
    assert more == whole[20:]
    with pytest.raises(ValueError, match="markov"):
        ttrain_lm.train_lm(1, data="zipf", device="cpu")
