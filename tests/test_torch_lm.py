"""The port's LM (``repro_torch.models.transformer``) against the JAX
package, on the CPU: parameter layout, forward, loss and gradients of the
five LM architectures, bf16, the remat policies, prefill + decode and
embeddings (the layers, the MoE, the configs and the batch makers are in
``tests/test_torch_lm_layers.py``).

Both packages take one set of weights (the reference's ``init_params``
through ``convert.transformer_from_arrays``) and the same numpy tokens, on
the reduced configs (f32). Tolerances:

* ``forward`` logits and ``loss_fn``: rtol 1e-5 / atol 1e-5 (logits reach
  ~60 on the reduced configs, whose embeddings are drawn at scale 1);
  every gradient leaf rtol 1e-4 / atol 1e-6 (the recsys tests' step
  tolerance: backward sums longer chains);
* ``prefill`` + ``decode_step`` and ``embeddings``: rtol 1e-5 / atol 1e-5;
* bf16 (qwen1.5's reduced config in bf16; the reference cannot run a bf16
  MoE on the CPU): a value rounded to bf16 keeps 8 significant bits, and
  where the two libraries' f32 products, summed in another order, land on
  either side of a rounding boundary the bf16 results differ by one ulp
  (2^-8 relative), which the residual stream carries on. Logits within
  2^-7 of the largest |logit| (mean |diff| within 2^-9 of it), the loss
  within rtol 2^-10, every gradient leaf within 2^-5 of its largest |g|.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint.checkpoint import flat_state  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402

LM_ARCHS = ["qwen1.5-0.5b", "gemma2-2b", "granite-8b",
            "granite-moe-3b-a800m", "qwen2-moe-a2.7b"]
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _x32():
    """Other test modules flip ``jax_enable_x64`` on at import; the
    reference's LM is defined at the default f32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rng(seed):
    return np.random.default_rng(seed)


_PARAMS = {}


def _pair(arch, seed=0, dtype=None):
    """(reference cfg, port cfg, reference params, port model), the
    weights drawn once by the reference's ``init_params``."""
    jcfg = jconfigs.get_arch(arch).make_reduced()
    tcfg = tconfigs.get_arch(arch).make_reduced()
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    key = (arch, seed, dtype)
    if key not in _PARAMS:
        _PARAMS[key] = jax.jit(lambda k: jtfm.init_params(jcfg, k))(
            jax.random.PRNGKey(seed))
    params = _PARAMS[key]
    model = convert.transformer_from_arrays(tcfg, _np(params), device="cpu")
    return jcfg, tcfg, params, model


def _tokens(cfg, seed, B=2, S=96):
    return _rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_init_params_layout_matches_the_reference():
    for arch in LM_ARCHS:
        jcfg, tcfg, params, _ = _pair(arch)
        model = ttfm.init_params(tcfg, generator=torch.Generator()
                                 .manual_seed(0))
        want = {k: (tuple(v.shape), str(v.dtype))
                for k, v in flat_state(_np(params)).items()}
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in model.state_dict().items()}
        assert got == want, arch
        # norms start at the reference's values, biases at zero
        for name, v in flat_state(_np(params)).items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.startswith(("ln", "final_norm", "b")):
                np.testing.assert_array_equal(
                    model.state_dict()[name].numpy(), v, err_msg=name)


# -- the model ---------------------------------------------------------------


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_loss_and_gradients_match_the_reference(arch):
    jcfg, tcfg, params, model = _pair(arch)
    toks = _tokens(jcfg, 7)
    mask = (_rng(8).random(toks.shape) < 0.8).astype(np.float32)
    batch = {"tokens": jnp.asarray(toks), "loss_mask": jnp.asarray(mask)}
    logits_j, ((loss_j, aux_j), grads_j) = jax.jit(lambda p, b: (
        jtfm.forward(jcfg, p, b["tokens"]),
        jax.value_and_grad(lambda q: jtfm.loss_fn(jcfg, q, b),
                           has_aux=True)(p)))(params, batch)
    tb = {"tokens": _t(toks), "loss_mask": _t(mask)}
    logits_t = ttfm.forward(tcfg, model, tb["tokens"])
    assert logits_t.dtype == torch.float32
    np.testing.assert_allclose(logits_t.detach().numpy(),
                               np.asarray(logits_j), **FWD)
    loss_t, aux = ttfm.loss_fn(tcfg, model, tb)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), **FWD)
    assert aux["ntokens"].item() == float(aux_j["ntokens"])
    names = [n for n, _ in model.named_parameters()]
    grads_t = torch.autograd.grad(loss_t, list(model.parameters()))
    want = flat_state(_np(grads_j))
    assert set(names) == set(want)
    for name, g in zip(names, grads_t):
        np.testing.assert_allclose(g.numpy(), want[name], **GRAD,
                                   err_msg=name)


def test_bf16_forward_loss_and_gradients_match_the_reference():
    jcfg, tcfg, params, model = _pair("qwen1.5-0.5b", seed=1,
                                      dtype="bfloat16")
    assert model.embed.dtype == torch.bfloat16
    # the bits came across unchanged
    np.testing.assert_array_equal(
        model.embed.detach().view(torch.int16).numpy().view(np.uint16),
        np.asarray(params["embed"]).view(np.uint16))
    toks = _tokens(jcfg, 9)
    logits_j, ((loss_j, _), grads_j) = jax.jit(lambda p, t: (
        jtfm.forward(jcfg, p, t),
        jax.value_and_grad(lambda q: jtfm.loss_fn(jcfg, q, {"tokens": t}),
                           has_aux=True)(p)))(params, jnp.asarray(toks))
    logits_j = np.asarray(logits_j)
    scale = np.abs(logits_j).max()
    with torch.no_grad():
        logits_t = ttfm.forward(tcfg, model, _t(toks)).numpy()
    diff = np.abs(logits_t - logits_j)
    assert diff.max() <= 2**-7 * scale, (diff.max(), scale)
    assert diff.mean() <= 2**-9 * scale, (diff.mean(), scale)
    loss_t, _ = ttfm.loss_fn(tcfg, model, {"tokens": _t(toks)})
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=2**-10)
    grads_t = dict(zip([n for n, _ in model.named_parameters()],
                       torch.autograd.grad(loss_t, list(model.parameters()))))
    for name, w in flat_state(_np(grads_j)).items():
        w = w.astype(np.float32)
        assert grads_t[name].dtype == torch.bfloat16, name
        err = np.abs(grads_t[name].float().numpy() - w).max()
        assert err <= 2**-5 * np.abs(w).max(), (name, err, np.abs(w).max())


@pytest.mark.parametrize("policy", ["minimal", "dots"])
def test_remat_policies_give_the_plain_gradients(policy):
    """The checkpointed forms recompute the same operations: their
    gradients are the bits of ``"none"``'s."""
    _, tcfg, params, _ = _pair("gemma2-2b")
    toks = _t(_tokens(tcfg, 10, S=40))
    out = []
    for remat in ("none", policy):
        cfg = dataclasses.replace(tcfg, remat_policy=remat)
        model = convert.transformer_from_arrays(cfg, _np(params),
                                                device="cpu")
        loss, _ = ttfm.loss_fn(cfg, model, {"tokens": toks})
        out.append((loss, torch.autograd.grad(loss, list(
            model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        cfg = dataclasses.replace(tcfg, remat_policy="all")
        ttfm.forward(cfg, ttfm.init_params(
            cfg, generator=torch.Generator().manual_seed(0)), toks)


def test_prefill_and_decode_match_the_reference():
    """gemma's reduced config (local window 16, then global): a 24-token
    prompt wraps the ring buffer, then 12 decode steps wrap it again; each
    step's logits and the caches against the reference's, and against the
    port's own forward over the whole sequence at that position."""
    jcfg, tcfg, params, model = _pair("gemma2-2b", seed=2)
    S, steps = 24, 12
    toks = _tokens(jcfg, 11, B=2, S=S + steps)
    logits_j, cache_j = jax.jit(lambda p, t: jtfm.prefill(
        jcfg, p, t, pad_to=S + steps))(params, jnp.asarray(toks[:, :S]))
    with torch.no_grad():
        logits_t, cache_t = ttfm.prefill(tcfg, model, _t(toks[:, :S]),
                                         pad_to=S + steps)
        full = ttfm.forward(tcfg, model, _t(toks))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **FWD)
    np.testing.assert_allclose(logits_t.numpy(), full[:, S - 1].numpy(),
                               **FWD)
    assert cache_t["pos0"]["k"].shape == (2, 2, 16, 2, 32)  # the ring
    assert cache_t["pos1"]["k"].shape == (2, 2, S + steps, 2, 32)
    step_j = jax.jit(lambda p, c, t, n: jtfm.decode_step(jcfg, p, c, t, n))
    for i in range(steps):
        n = S + i
        tok = toks[:, n:n + 1]
        lj, cache_j = step_j(params, cache_j, jnp.asarray(tok),
                             jnp.int32(n))
        lt, cache_t = ttfm.decode_step(tcfg, model, cache_t, _t(tok), n)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **FWD,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(lt.numpy(), full[:, n].numpy(), **FWD,
                                   err_msg=f"step {i} vs forward")
    for pos in cache_t:
        for kv in ("k", "v"):
            np.testing.assert_allclose(cache_t[pos][kv].numpy(),
                                       np.asarray(cache_j[pos][kv]), **FWD)


def test_init_kv_cache_matches_the_reference():
    jcfg, tcfg, _, _ = _pair("gemma2-2b")
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        jtfm.init_kv_cache(jcfg, 3, 40))
    got = ttfm.init_kv_cache(tcfg, 3, 40, device="cpu")
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).replace(
        "torch.", "")), got) == want
    pos = ttfm._ring_positions(21, 16, 1, "cpu")[0].numpy()
    np.testing.assert_array_equal(
        pos, np.asarray(jtfm._ring_positions(jnp.int32(21), 16, 1))[0])
    assert (ttfm._ring_positions(0, 4, 1, "cpu") == 1 << 30).all()


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-3b-a800m"])
def test_embeddings_match_the_reference(arch):
    jcfg, tcfg, params, model = _pair(arch)
    toks = _tokens(jcfg, 12, B=2, S=64)
    want = jax.jit(lambda p, t: jtfm.embeddings(jcfg, p, t))(
        params, jnp.asarray(toks))
    with torch.no_grad():
        got = ttfm.embeddings(tcfg, model, _t(toks))
    assert got.shape == (2, jcfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


