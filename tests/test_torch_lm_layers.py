"""The port's LM layers (``repro_torch.models.layers``), MoE
(``repro_torch.models.moe``), LM configs and LM batch makers against the
JAX package, on the CPU.

Tolerances: ``rms_norm`` (f32), ``rope``, ``attention``, ``mlp_glu`` and
``moe_ffn``: rtol 1e-5 / atol 1e-6 (the same f32 operations, sums in
another order); ``rms_norm`` in bf16 within one bf16 ulp (rtol 2^-8); the
MoE's expert choices and slot positions exact, its gradients rtol 1e-4 /
atol 1e-6. The batch makers draw from ``torch.Generator``s (``jax.random``
cannot be replayed), so they are held to the reference's contract: shape,
dtype, range, determinism in (seed, step), Markov structure.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402

LM_ARCHS = ["qwen1.5-0.5b", "gemma2-2b", "granite-8b",
            "granite-moe-3b-a800m", "qwen2-moe-a2.7b"]
LAYER = dict(rtol=1e-5, atol=1e-6)
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


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# -- configs -------------------------------------------------------------------


def _port_fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "dtype"}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_configs_equal_the_reference(arch):
    jspec, tspec = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    assert (tspec.family, tspec.source) == (jspec.family, jspec.source) \
        == ("lm", jspec.source)
    dtypes = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    for make in ("make_config", "make_reduced"):
        jcfg, tcfg = getattr(jspec, make)(), getattr(tspec, make)()
        assert _port_fields(jcfg) == _port_fields(tcfg)
        assert dtypes[jcfg.dtype] == tcfg.dtype
        for prop in ("head_dim", "padded_vocab", "pattern_len", "n_groups",
                     "is_moe"):
            assert getattr(jcfg, prop) == getattr(tcfg, prop), prop
        assert jcfg.param_count() == tcfg.param_count()
        assert jcfg.active_param_count() == tcfg.active_param_count()
    assert [(c.shape, c.kind, c.dims, c.skip) for c in tspec.cells] == \
        [(c.shape, c.kind, c.dims, c.skip) for c in jspec.cells]
    cfg = jspec.make_config()
    for jcell, tcell in zip(jspec.cells, tspec.cells):
        want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                            jconfigs.input_specs(jspec, cfg, jcell))
        got = jax.tree.map(
            lambda s: (tuple(s.shape), str(s.dtype).replace("torch.", "")),
            tconfigs.input_specs(tspec, tspec.make_config(), tcell),
            is_leaf=lambda s: isinstance(s, tconfigs.TensorSpec))
        assert got == want


def test_qwen_widths_and_padding():
    cfg = tconfigs.get_arch("qwen1.5-0.5b").make_config()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff,
            cfg.vocab_size, cfg.padded_vocab) == (24, 1024, 16, 2816,
                                                  151_936, 152_064)
    assert cfg.dtype == torch.bfloat16 and cfg.remat_policy == "minimal"
    gemma = tconfigs.get_arch("gemma2-2b").make_config()
    assert gemma.padded_vocab == 256_000 == gemma.vocab_size
    granite = tconfigs.get_arch("granite-moe-3b-a800m").make_config()
    assert tmoe.padded_experts(granite.n_experts) == 48
    assert tmoe.capacity(4096, granite.top_k, 48,
                         granite.capacity_factor) == 856


# -- layers --------------------------------------------------------------------


@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches(plus_one, dtype):
    rng = _rng(1)
    x, w = _normal(rng, 3, 5, 48), _normal(rng, 48)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    want = jlayers.rms_norm(jnp.asarray(x).astype(jd), jnp.asarray(w)
                            .astype(jd), 1e-6, plus_one=plus_one)
    td = getattr(torch, dtype)
    got = tlayers.rms_norm(_t(x).to(td), _t(w).to(td), 1e-6,
                           plus_one=plus_one)
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **(LAYER if dtype == "float32"
                                  else dict(rtol=2**-8, atol=0)))


def test_rope_matches():
    rng = _rng(2)
    x = _normal(rng, 2, 7, 3, 16)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta=1e6)
    got = tlayers.rope(_t(x), _t(pos), theta=1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)


@pytest.mark.parametrize("case", [
    dict(),                                         # causal, H = KV
    dict(window=5),                                 # sliding window
    dict(attn_softcap=50.0, scale=0.3),             # softcap
    dict(kv=2),                                     # GQA: 2 groups of 2
    dict(kv=2, sq=23, query_chunk=8, window=6),     # chunked, ragged
    dict(causal=False, sq=9, skv=13),               # no mask, Sq != Skv
])
def test_attention_matches(case):
    case = dict(case)
    B, H, dh = 2, 4, 8
    sq = case.pop("sq", 11)
    skv = case.pop("skv", sq)
    kv = case.pop("kv", H)
    rng = _rng(3)
    q, k, v = (_normal(rng, B, sq, H, dh), _normal(rng, B, skv, kv, dh),
               _normal(rng, B, skv, kv, dh))
    qp = np.broadcast_to(np.arange(skv - sq, skv), (B, sq)).astype(np.int32)
    kp = np.broadcast_to(np.arange(skv), (B, skv)).astype(np.int32)
    want = jlayers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             q_positions=jnp.asarray(qp),
                             kv_positions=jnp.asarray(kp), **case)
    got = tlayers.attention(_t(q), _t(k), _t(v), q_positions=_t(qp),
                            kv_positions=_t(kp), **case)
    assert got.shape == (B, sq, H, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)


@pytest.mark.parametrize("case", testing.MATMUL_CASES)
def test_matmul_f32_bf16_result_and_gradients(case):
    """``matmul_f32`` on bf16 operands (2-D, leading dimensions, batched, a
    transposed view): an f32 result and bf16 gradients within
    ``testing.matmul_f32_errors``' bounds of f64 products of the same
    values (the card test of the same name holds the card's mixed-precision
    branch to them)."""
    errs = testing.matmul_f32_errors(*testing.matmul_inputs(*case, 0, "cpu"))
    assert max(errs.values()) <= 1, errs


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_mlp_glu_matches(act):
    rng = _rng(4)
    x, wg, wu, wd = (_normal(rng, 2, 5, 16), _normal(rng, 16, 24),
                     _normal(rng, 16, 24), _normal(rng, 24, 16))
    want = jlayers.mlp_glu(*map(jnp.asarray, (x, wg, wu, wd)),
                           jlayers.ActFn(act))
    got = tlayers.mlp_glu(*map(_t, (x, wg, wu, wd)), tlayers.ActFn(act))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)


# -- MoE ------------------------------------------------------------------------


def _moe_case(tie: bool):
    """A MoE layer of 8 experts (padded to 16), top-2, groups of 64 tokens
    at capacity 8 (128 assignments a group over 8 experts: drops), with
    router columns 0 = 1 and 2 = 3 when ``tie`` (equal probabilities)."""
    cfg = dict(name="moe", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
               d_ff=8, vocab_size=64, n_experts=8, top_k=2, moe_d_ff=8,
               moe_group_size=64, capacity_factor=0.25)
    jcfg = jtfm.TransformerConfig(**cfg, dtype=jnp.float32)
    tcfg = ttfm.TransformerConfig(**cfg, dtype=torch.float32)
    rng = _rng(5)
    E = jmoe.padded_experts(8)
    # fan-in scaled, as init_params draws them
    p = {"router": _normal(rng, 16, E), "we_gate": _normal(rng, E, 16, 8) / 4,
         "we_up": _normal(rng, E, 16, 8) / 4,
         "we_down": _normal(rng, E, 8, 16) / 8**0.5}
    if tie:
        p["router"][:, 1] = p["router"][:, 0]
        p["router"][:, 3] = p["router"][:, 2]
        p["router"][:, :4] *= 3.0  # make the tied pairs win often
    x = _normal(rng, 2, 64, 16)
    return jcfg, tcfg, p, x


def _reference_slots(jcfg, p, x):
    """The reference's top-k choices and slots (``moe_ffn``'s first half,
    its one-hot prefix count taken in numpy)."""
    G, gs = x.shape[0] * x.shape[1] // jcfg.moe_group_size, \
        jcfg.moe_group_size
    E = p["we_gate"].shape[0]
    C = jmoe.capacity(gs, jcfg.top_k, E, jcfg.capacity_factor)
    logits = jnp.einsum("gtd,de->gte", jnp.asarray(x.reshape(G, gs, -1)),
                        jnp.asarray(p["router"]),
                        preferred_element_type=jnp.float32)
    logits = jnp.where(jnp.arange(E) >= jcfg.n_experts, -1e30, logits)
    probs = jax.nn.softmax(logits, axis=-1)
    gate, idx = jax.lax.top_k(probs, jcfg.top_k)
    flat_e = np.asarray(idx).reshape(G, -1)
    onehot = np.eye(E, dtype=np.int64)[flat_e]
    pos = np.cumsum(onehot, axis=1) - onehot
    pos_in_e = np.take_along_axis(pos, flat_e[..., None], 2)[..., 0]
    keep = pos_in_e < C
    slot = np.where(keep, flat_e * C + pos_in_e, E * C)
    return np.asarray(probs), np.asarray(idx), slot, keep, C


@pytest.mark.parametrize("tie", [False, True])
def test_moe_ffn_matches_with_drops_and_ties(tie):
    jcfg, tcfg, p, x = _moe_case(tie)
    probs, idx, slot, keep, C = _reference_slots(jcfg, p, x)
    assert (~keep).any()  # capacity drops happen
    if tie:  # exact ties, which lax.top_k breaks toward the lower expert
        assert (probs[..., 0] == probs[..., 1]).all()
        both = (idx == 0).any(-1) & (idx == 1).any(-1)
        assert both.any()
        assert (idx[both][:, 0] == 0).all()
    G, gs = 2, 64
    xt = _t(x).reshape(G, gs, 16)
    gate, t_idx = tmoe.route(tcfg, _t(p["router"]), xt)
    np.testing.assert_array_equal(t_idx.numpy(), idx)
    t_slot, t_keep = tmoe.slots(t_idx, p["we_gate"].shape[0], C)
    np.testing.assert_array_equal(t_slot.numpy(), slot)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    cot = _normal(_rng(15), *x.shape) / 8  # a cotangent of O(1) grads
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want, gj = jax.jit(lambda q, xx: (
        jmoe.moe_ffn(jcfg, q, xx),
        jax.grad(lambda r: jnp.sum(jmoe.moe_ffn(jcfg, r, xx) * cot))(q)))(
            jp, jnp.asarray(x))
    tp = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    got = tmoe.moe_ffn(tcfg, tp, _t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **LAYER)
    # gradients through the dispatch, the experts and the combine
    gt = torch.autograd.grad(torch.sum(got * _t(cot)), list(tp.values()))
    for (name, _), g in zip(tp.items(), gt):
        np.testing.assert_allclose(g.numpy(), np.asarray(gj[name]), **GRAD,
                                   err_msg=name)


def test_pad_expert_weights_matches():
    rng = _rng(6)
    layer = {"router": _normal(rng, 3, 16, 40),
             "we_gate": _normal(rng, 3, 40, 16, 8),
             "we_up": _normal(rng, 3, 40, 16, 8),
             "we_down": _normal(rng, 3, 40, 8, 16)}
    want = jmoe.pad_expert_weights({k: jnp.asarray(v)
                                    for k, v in layer.items()}, 40)
    got = tmoe.pad_expert_weights({k: _t(v) for k, v in layer.items()}, 40)
    for name in layer:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
    assert got["we_gate"].shape[1] == 48


# -- batches -------------------------------------------------------------------


def test_lm_batch_contract():
    b1 = tsyn.lm_batch(8, 32, 512, generator=tsyn.batch_generator(3, 5))
    b2 = tsyn.lm_batch(8, 32, 512, generator=tsyn.batch_generator(3, 5))
    b3 = tsyn.lm_batch(8, 32, 512, generator=tsyn.batch_generator(3, 6))
    want = jsyn.lm_batch(3, 5, 8, 32, 512)["tokens"]
    t = b1["tokens"]
    assert torch.equal(t, b2["tokens"]) and not torch.equal(t, b3["tokens"])
    assert tuple(t.shape) == want.shape and t.dtype == torch.int32
    assert int(t.min()) >= 0 and int(t.max()) < 512
    assert len(torch.unique(t)) > 200  # uniform over the vocabulary


def test_lm_markov_batch_contract():
    """The reference's own contract (tests/test_retrieval_e2e.py), for the
    port's stream."""
    b1 = tsyn.lm_markov_batch(5, 3, 16, 32, 64)
    b2 = tsyn.lm_markov_batch(5, 3, 16, 32, 64)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"],
                           tsyn.lm_markov_batch(5, 4, 16, 32, 64)["tokens"])
    t = b1["tokens"].numpy()
    assert t.shape == (16, 32) and t.dtype == np.int32
    assert t.min() >= 0 and t.max() < 64
    pairs = {}
    for row in t:
        for a, b in zip(row[:-1], row[1:]):
            pairs[(int(a), int(b))] = pairs.get((int(a), int(b)), 0) + 1
    n_pairs = 16 * 31
    assert max(pairs.values()) >= 3 or len(pairs) < 0.8 * n_pairs
    # the same transition matrix at every step of the stream
    A, B = tsyn.markov_factors(5, 64)
    A2, B2 = tsyn.markov_factors(5, 64)
    assert torch.equal(A, A2) and torch.equal(B, B2)
    assert A.shape == (64, 4) and B.shape == (4, 64)  # rank max(4, 64 // 32)


def test_markov_rows_are_the_dense_matrix_rows():
    """The lazily evaluated rows equal the dense A @ B / (sqrt(rank) * c)
    (the reference's form) at a small vocabulary."""
    vocab, conc = 640, 0.7
    A, B = tsyn.markov_factors(2, vocab)
    assert A.shape[1] == 16 == max(4, min(16, vocab // 32))
    dense = (A @ B) / (np.sqrt(16) * conc)
    toks = torch.tensor([0, 5, 639, 5, 100])
    np.testing.assert_allclose(tsyn.markov_logits(A, B, toks, conc).numpy(),
                               dense[toks].numpy(), rtol=1e-6, atol=1e-6)


def test_markov_sampling_follows_the_rows(monkeypatch):
    """The next tokens follow their rows: with a very peaked matrix
    (concentration 1e-4) every next token is its row's argmax, whatever
    the block of rows evaluated at once."""
    t = tsyn.lm_markov_batch(4, 0, 6, 9, 96, concentration=1e-4)["tokens"]
    A, B = tsyn.markov_factors(4, 96)
    rows = tsyn.markov_logits(A, B, t[:, :-1].reshape(-1), 1e-4)
    np.testing.assert_array_equal(t[:, 1:].reshape(-1).numpy(),
                                  rows.argmax(-1).numpy())
    monkeypatch.setattr(tsyn, "MARKOV_BLOCK_ELEMS", 96 * 2)
    small = tsyn.lm_markov_batch(4, 0, 6, 9, 96, concentration=1e-4)
    assert torch.equal(small["tokens"], t)
