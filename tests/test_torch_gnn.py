"""The port's MACE (``repro_torch.models.mace``) and its segment sum against
the JAX package, on the CPU: the irrep algebra and the radial basis
(values and result dtypes), the parameter layout, forward, loss and every
gradient (graph- and node-level, ``edge_chunks`` 1 and 4, remat on and
off), node descriptors, bf16, invariances and masking.

Both packages take one set of weights (the reference's ``init_params``
through ``convert.mace_from_arrays``) and the same numpy graphs, on the
reduced config. Tolerances:

* the irrep functions: bf16 results bit for bit (each is one rounding of
  the same f32 value, or a sum accumulated in f32 and rounded once); f32
  rtol 1e-6 / atol 1e-6 (XLA contracts some products into FMAs);
* ``layers.segment_sum``: bit for bit in f32 and bf16 (each segment adds
  its rows in order from 0, as the reference's scatter-add);
* forward energies and the loss rtol 1e-5 / atol 1e-5, every gradient
  leaf rtol 1e-4 / atol 1e-6 (the LM tests'), descriptors rtol 1e-5 /
  atol 1e-5;
* bf16: the forward is the reference's op-by-op bits once the port's silu
  is swapped for XLA's CPU expansion of ``lax.logistic`` (each of its four
  steps rounded to bf16; the port rounds ``x * sigmoid(x)`` twice, as the
  TPU does): that pins every other rounding point, the f32 promotion of
  the l = 2 paths included. Compiled, the reference rounds elsewhere (XLA
  fuses bf16 chains: its jitted energies differ from its own op-by-op
  ones at 18 of 64 nodes, by up to 0.012), and the chunked path's scan
  body is always compiled, so that path and both packages' bf16 are held
  to an f64 evaluation of the same parameters within
  ``testing.bf16_gnn_mismatch``'s bounds (the reference's energies and
  loss; the port's gradients too);
* invariances (a rotation and translation of the positions, a permutation
  of the edges) rtol 1e-5 / atol 1e-6 in f32 (the same sums in another
  rounding); masked edges and nodes change nothing past rtol 1e-6.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import mace as jmace  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert, testing  # noqa: E402
from repro_torch.checkpoint.checkpoint import flat_state  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import mace as tmace  # noqa: E402

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
IRREP = dict(rtol=1e-6, atol=1e-6)
N_GRAPHS = 4


@pytest.fixture(autouse=True)
def _x32():
    """Other test modules flip ``jax_enable_x64`` on at import; the
    reference's MACE is defined at the default f32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


_PARAMS = {}


def _pair(dtype=None, seed=0, **over):
    """(reference cfg, port cfg, reference params, port model), the
    weights drawn once by the reference's ``init_params``."""
    jcfg = dataclasses.replace(jconfigs.get_arch("mace").make_reduced(),
                               **over)
    tcfg = dataclasses.replace(tconfigs.get_arch("mace").make_reduced(),
                               **over)
    if dtype == "bfloat16":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    key = (seed, dtype)
    if key not in _PARAMS:
        _PARAMS[key] = jmace.init_params(jcfg, jax.random.PRNGKey(seed))
    params = _PARAMS[key]
    return jcfg, tcfg, params, convert.mace_from_arrays(tcfg, _np(params),
                                                        device="cpu")


def _graph(seed, node_level, *, d_feat=8, pad=True):
    """A batch of N_GRAPHS graphs (64 nodes, 192 edges) as numpy arrays
    and its static entries; with ``pad`` the last 8 edges are padding
    (edge_mask 0, sender = receiver = 0), nodes 5, 17 and 40 are masked
    out, and graph 2 is left out of the graph-level loss."""
    arrays = {k: np.asarray(v) for k, v in jsyn.geometric_graph_batch(
        seed, 64, 192, d_feat, n_graphs=N_GRAPHS,
        node_level=node_level).items()}
    if pad:
        for k in ("senders", "receivers"):
            arrays[k] = arrays[k].copy()
            arrays[k][-8:] = 0
        arrays["edge_mask"] = arrays["edge_mask"].copy()
        arrays["edge_mask"][-8:] = 0.0
        arrays["node_mask"] = arrays["node_mask"].copy()
        arrays["node_mask"][[5, 17, 40]] = 0.0
        if node_level:
            arrays["loss_node_mask"] = arrays["node_mask"].copy()
        else:
            arrays["graph_mask"] = np.array([1, 1, 0, 1], np.float32)
    return arrays, {"n_graphs": N_GRAPHS, "node_level": node_level}


def _jb(arrays, static):
    return dict({k: jnp.asarray(v) for k, v in arrays.items()}, **static)


def _tb(arrays, static):
    return dict({k: torch.from_numpy(np.array(v)) for k, v in arrays.items()},
                **static)


def _port_grads(model, loss):
    return dict(zip([n for n, _ in model.named_parameters()],
                    torch.autograd.grad(loss, list(model.parameters()),
                                        materialize_grads=True)))


# -- the irrep algebra -----------------------------------------------------------


_RNG = np.random.default_rng(0)
_V = _RNG.normal(size=(2, 50, 7, 3)).astype(np.float32)
_T = _RNG.normal(size=(2, 50, 7, 3, 3)).astype(np.float32)
_IRREP_ARGS = {"outer11": (_V[0], _V[1]), "dot11": (_V[0], _V[1]),
               "cross11": (_V[0], _V[1]), "ddot22": (_T[0], _T[1]),
               "mat21": (_T[0], _V[1]), "mat22": (_T[0], _T[1]),
               "sym_traceless": (_T[0],)}


def _cast(args, mode):
    """The arguments as (reference, port) arrays: all f32, all bf16, or
    the first f32 and the rest bf16."""
    jd = {"float32": [jnp.float32] * 2, "bfloat16": [jnp.bfloat16] * 2,
          "mixed": [jnp.float32, jnp.bfloat16]}[mode]
    ja = [jnp.asarray(a, jd[min(i, 1)]) for i, a in enumerate(args)]
    ta = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
        for a in ja]
    return ja, ta


def _check_same(got, want, what):
    assert str(got.dtype).replace("torch.", "") == str(want.dtype), (
        what, got.dtype, want.dtype)
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    if got.dtype == torch.bfloat16:
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        np.testing.assert_allclose(g, w, **IRREP, err_msg=what)


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "mixed"])
@pytest.mark.parametrize("fn", sorted(_IRREP_ARGS) + ["product_paths",
                                                      "bessel_basis"])
def test_irrep_functions_match_the_reference(fn, mode):
    """Values and result dtypes: in bf16 ``outer11`` and ``mat22`` return
    f32 (the f32 identity of ``sym_traceless``), ``mat21``, ``cross11``,
    ``dot11`` and ``ddot22`` stay bf16; a mixed pair promotes to f32."""
    if fn == "bessel_basis":
        d = np.concatenate([_RNG.uniform(0, 7, 200), [0.0, 5.0, 1e-12]])
        d = d.astype(np.float32)
        for n_rbf, r_cut in ((8, 5.0), (4, 3.0)):
            _check_same(tmace.bessel_basis(torch.from_numpy(d), n_rbf, r_cut),
                        jmace.bessel_basis(jnp.asarray(d), n_rbf, r_cut),
                        f"bessel_basis {n_rbf} {r_cut}")
        return
    if fn == "product_paths":
        args = (_V[0, :, :1, 0], _V[0, :, :1], _T[0, :, :1],
                _V[1, :, :, 0], _V[1], _T[1])
        ja, ta = _cast(args, mode)
        want = jmace._product_paths(tuple(ja[:3]), tuple(ja[3:]))
        got = tmace.product_paths(tuple(ta[:3]), tuple(ta[3:]))
        assert [len(got[l]) for l in range(3)] == [3, 5, 4]
        for l in range(3):
            for i, (g, w) in enumerate(zip(got[l], want[l])):
                _check_same(g, w, f"to{l}[{i}]")
        return
    ja, ta = _cast(_IRREP_ARGS[fn], mode)
    _check_same(getattr(tmace, fn)(*ta), getattr(jmace, fn)(*ja), fn)


# -- the segment sum ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("trailing", [(), (5,), (3, 3)])
@pytest.mark.parametrize("ids_sorted", [False, True])
def test_segment_sum_is_the_references_scatter_add(dtype, trailing,
                                                   ids_sorted):
    """The sums bit for bit (segments 0 and 37 of 40 receive no row: exact
    zeros) and the backward, a gather of the cotangent."""
    rng = np.random.default_rng(3)
    ids = rng.choice([i for i in range(40) if i not in (0, 37)], 600)
    if ids_sorted:
        ids = np.sort(ids, kind="stable")
    data = rng.normal(size=(600,) + trailing).astype(np.float32)
    jd = jnp.asarray(data, getattr(jnp, dtype))
    want = jax.ops.segment_sum(jd, jnp.asarray(ids), num_segments=40)
    td = torch.from_numpy(np.asarray(jd.astype(jnp.float32))).to(
        getattr(torch, dtype)).requires_grad_(True)
    got = layers.segment_sum(td, torch.from_numpy(ids), 40,
                             ids_sorted=ids_sorted)
    assert got.dtype == td.dtype and got.shape == (40,) + trailing
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert not got[0].any() and not got[37].any()
    cot = rng.normal(size=(40,) + trailing).astype(np.float32)
    gt = torch.autograd.grad(got, td, torch.from_numpy(cot).to(td.dtype))[0]
    np.testing.assert_array_equal(gt.float().numpy(),
                                  torch.from_numpy(cot).to(td.dtype)
                                  .float().numpy()[ids])


# -- parameters --------------------------------------------------------------------


def test_init_params_layout_matches_the_reference():
    jcfg, tcfg, params, _ = _pair()
    model = tmace.init_params(tcfg, generator=torch.Generator()
                              .manual_seed(0))
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in flat_state(_np(params)).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in model.state_dict().items()}
    assert got == want
    assert [n for n, _ in model.named_parameters()][:3] == [
        "embed", "layers.0.rad_w1", "layers.0.rad_w2"]
    # the correlation weights at scale 1, the rest at fan-in scale
    for name, p in model.state_dict().items():
        assert float(p.abs().max()) <= 2.0 + 1e-6, name
    assert tcfg.param_count() == jcfg.param_count()


# -- forward, loss, gradients ---------------------------------------------------------


@pytest.mark.parametrize("node_level", [False, True])
@pytest.mark.parametrize("edge_chunks", [1, 4])
@pytest.mark.parametrize("remat", [False, True])
def test_forward_loss_and_gradients_match_the_reference(node_level,
                                                        edge_chunks, remat):
    """f32, padded edges and masked nodes included; the chunked path sums
    each chunk's A-basis into f32 in chunk order, the reference's scan."""
    jcfg, tcfg, params, model = _pair(edge_chunks=edge_chunks, remat=remat)
    arrays, static = _graph(11, node_level)
    jb, tb = _jb(arrays, static), _tb(arrays, static)
    pred_j, ((loss_j, _), grads_j) = jax.jit(lambda p: (
        jmace.forward(jcfg, p, jb),
        jax.value_and_grad(lambda q: jmace.loss_fn(jcfg, q, jb),
                           has_aux=True)(p)))(params)
    pred_t = tmace.forward(tcfg, model, tb)
    assert pred_t.dtype == torch.float32
    assert pred_t.shape == ((64,) if node_level else (N_GRAPHS,))
    np.testing.assert_allclose(pred_t.detach().numpy(), np.asarray(pred_j),
                               **FWD)
    loss_t, aux = tmace.loss_fn(tcfg, model, tb)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), **FWD)
    assert aux["loss"] is loss_t
    grads_t = _port_grads(model, loss_t)
    want = flat_state(_np(grads_j))
    assert set(grads_t) == set(want)
    for name, g in grads_t.items():
        np.testing.assert_allclose(g.numpy(), want[name], **GRAD,
                                   err_msg=name)
    # the last layer's l = 1, 2 linears do not reach the energies
    assert not grads_t["layers.1.msg1"].any()
    assert not want["layers.1.msg1"].any()


def test_node_descriptors_match_the_reference():
    jcfg, tcfg, params, model = _pair()
    arrays, static = _graph(12, False)
    want = np.asarray(jmace.node_descriptors(jcfg, params,
                                             _jb(arrays, static)))
    got = tmace.node_descriptors(tcfg, model, _tb(arrays, static))
    assert got.dtype == torch.float32 and got.shape == (64, tcfg.channels)
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD)
    assert not got[[5, 17, 40]].any()  # masked nodes


# -- bf16 -------------------------------------------------------------------------------


def _xla_cpu_silu(x):
    """``jax.nn.silu`` as XLA's CPU backend computes a bf16 ``logistic``:
    1 / (1 + exp(-x)), each step rounded to bf16, then the product."""
    if x.dtype != torch.bfloat16:
        return x * torch.sigmoid(x)
    b = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    xf = x.float()
    sig = b(1.0 / b(b(torch.exp(b(-xf))) + 1.0))
    return (xf * sig).to(torch.bfloat16)


@pytest.mark.parametrize("node_level", [False, True])
def test_bf16_forward_is_the_references_bits(monkeypatch, node_level):
    """With the silu swapped for XLA's CPU expansion, the bf16 energies
    are the reference's op-by-op bits (every dtype promotion, every
    rounding and every sum order of the forward), the descriptors within
    f32 noise."""
    monkeypatch.setattr(tmace, "_silu", _xla_cpu_silu)
    jcfg, tcfg, params, model = _pair("bfloat16")
    assert model.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        model.embed.detach().view(torch.int16).numpy().view(np.uint16),
        np.asarray(params["embed"]).view(np.uint16))
    arrays, static = _graph(13, node_level)
    jb, tb = _jb(arrays, static), _tb(arrays, static)
    with torch.no_grad():
        got = tmace.forward(tcfg, model, tb).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmace.forward(jcfg, params,
                                                                jb)))
    if not node_level:
        with torch.no_grad():
            d = tmace.node_descriptors(tcfg, model, tb).numpy()
        np.testing.assert_allclose(
            d, np.asarray(jmace.node_descriptors(jcfg, params, jb)), **FWD)


@pytest.mark.parametrize("node_level", [False, True])
@pytest.mark.parametrize("edge_chunks", [1, 4])
def test_bf16_within_bounds_of_f64(node_level, edge_chunks):
    """The port's bf16 energies, loss and gradients within
    ``testing.bf16_gnn_mismatch``'s bounds of the port's f64 evaluation of
    the same (bf16) parameters, and a bf16 leaf's gradient in bf16; the
    reference's bf16 energies and loss within the same bounds. (Its
    gradients are not held: compiled, its fused bf16 chains put them up to
    0.32 of a leaf's largest |g| from f64 on these graphs, where the
    port's read at most 0.061.)"""
    jcfg, tcfg, params, model = _pair("bfloat16", edge_chunks=edge_chunks)
    arrays, static = _graph(14, node_level)
    jb, tb = _jb(arrays, static), _tb(arrays, static)
    f64_cfg = dataclasses.replace(tcfg, dtype=torch.float64)
    want = testing.gnn_outputs(f64_cfg, convert.mace_from_arrays(
        f64_cfg, jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                              params), device="cpu"), tb)
    got = testing.gnn_outputs(tcfg, model, tb)
    msg = testing.bf16_gnn_mismatch(*got, *want)
    assert msg is None, f"port: {msg}"
    loss, _ = tmace.loss_fn(tcfg, model, tb)
    assert all(g.dtype == torch.bfloat16
               for g in _port_grads(model, loss).values())
    energies_j, loss_j = jax.jit(lambda p: (
        jmace.forward(jcfg, p, jb), jmace.loss_fn(jcfg, p, jb)[0]))(params)
    msg = testing.bf16_gnn_mismatch(np.asarray(energies_j), float(loss_j),
                                    {}, want[0], want[1], {})
    assert msg is None, f"reference: {msg}"


# -- invariances and masking -------------------------------------------------------------


def _energies(cfg, model, arrays, static):
    with torch.no_grad():
        return tmace.forward(cfg, model, _tb(arrays, static)).numpy()


@pytest.mark.parametrize("node_level", [False, True])
def test_energies_are_invariant_under_rotation_translation_and_edge_order(
        node_level):
    _, tcfg, _, model = _pair()
    arrays, static = _graph(15, node_level)
    base = _energies(tcfg, model, arrays, static)
    rng = np.random.default_rng(15)
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    rot = q * np.sign(np.diag(r))  # a random orthogonal matrix
    moved = dict(arrays, positions=(arrays["positions"].astype(np.float64)
                                    @ rot.T + rng.normal(size=3) * 3.0)
                 .astype(np.float32))
    np.testing.assert_allclose(_energies(tcfg, model, moved, static), base,
                               rtol=1e-5, atol=1e-6)
    perm = rng.permutation(arrays["senders"].shape[0])
    shuffled = dict(arrays, **{k: arrays[k][perm] for k in
                               ("senders", "receivers", "edge_mask")})
    np.testing.assert_allclose(_energies(tcfg, model, shuffled, static),
                               base, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("node_level", [False, True])
def test_masked_edges_and_nodes_contribute_nothing(node_level):
    """Eight more padding edges (sender = receiver = 0, edge_mask 0) and
    five more masked nodes with live edges to and from them leave every
    real node's energy (and every graph's) as it was, and give the masked
    nodes exactly 0."""
    _, tcfg, _, model = _pair()
    arrays, static = _graph(16, node_level)
    base = _energies(tcfg, model, arrays, static)
    rng = np.random.default_rng(16)
    more = {k: v.copy() for k, v in arrays.items()}
    n_new = 5
    new = np.arange(64, 64 + n_new, dtype=np.int32)
    live_s = np.concatenate([new, rng.integers(0, 64, n_new)]).astype(np.int32)
    live_r = np.concatenate([rng.integers(0, 64, n_new), new]).astype(np.int32)
    more["senders"] = np.concatenate([arrays["senders"], live_s,
                                      np.zeros(8, np.int32)])
    more["receivers"] = np.concatenate([arrays["receivers"], live_r,
                                        np.zeros(8, np.int32)])
    more["edge_mask"] = np.concatenate([arrays["edge_mask"],
                                        np.ones(2 * n_new, np.float32),
                                        np.zeros(8, np.float32)])
    node_extra = {"positions": rng.uniform(0, 8, (n_new, 3)),
                  "node_feat": rng.normal(size=(n_new, 8)),
                  "node_mask": np.zeros(n_new),
                  "node_graph": np.full(n_new, N_GRAPHS - 1),
                  "target_nodes": np.zeros(n_new),
                  "loss_node_mask": np.zeros(n_new)}
    for k, v in node_extra.items():
        if k in more:
            more[k] = np.concatenate([arrays[k], v.astype(arrays[k].dtype)])
    got = _energies(tcfg, model, more, static)
    if node_level:
        np.testing.assert_allclose(got[:64], base, rtol=1e-6, atol=1e-7)
        assert not got[64:].any()
    else:
        np.testing.assert_allclose(got, base, rtol=1e-6, atol=1e-7)
