"""The port's recsys models (``repro_torch.models.recsys``), registry and
click-batch generators against the JAX package, on the CPU.

Both packages take one set of weights (``convert.recsys_params_from_arrays``
from the reference's ``init_params``) and the same batches (the reference's
generators, as numpy), on the reduced configs. Tolerances: forward logits
and ``loss_fn`` rtol 1e-5 / atol 1e-6 (the same f32 contractions in another
summation order), every gradient leaf rtol 1e-4 / atol 1e-6 (backward sums
longer chains), the embedding gathers and ``retrieval_topk``'s ids exact.
The port's own generators draw from ``torch.Generator``s, so they are held
to the reference's distributions (ranges, skew, label rate) and, where the
mapping is deterministic (the two-tower item hash), to its exact values.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint.checkpoint import flat_state  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models import recsys as trec  # noqa: E402

ARCHS = ["dlrm-rm2", "autoint", "wide-deep", "xdeepfm"]
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _port_cfg(jcfg) -> trec.RecsysConfig:
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)
              if f.name not in ("dtype", "table_dtype")}
    return trec.RecsysConfig(**fields)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    jspec, tspec = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    assert (tspec.family, tspec.source) == (jspec.family, jspec.source)
    for make in ("make_config", "make_reduced"):
        jcfg, tcfg = getattr(jspec, make)(), getattr(tspec, make)()
        assert _port_cfg(jcfg) == tcfg
        assert (tcfg.padded_rows, tcfg.offsets) == (jcfg.padded_rows,
                                                    jcfg.offsets)
        assert tcfg.dtype == torch.float32 == tcfg.table_dtype
    assert [(c.shape, c.kind, c.dims, c.skip) for c in tspec.cells] == \
        [(c.shape, c.kind, c.dims, c.skip) for c in jspec.cells]
    cfg = jspec.make_config()
    for jcell, tcell in zip(jspec.cells, tspec.cells):
        want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                            jconfigs.input_specs(jspec, cfg, jcell))
        got = tconfigs.input_specs(tspec, tspec.make_config(), tcell)
        got = {k: ({kk: (vv.shape, str(vv.dtype).replace("torch.", ""))
                    for kk, vv in v.items()} if isinstance(v, dict)
                   else (v.shape, str(v.dtype).replace("torch.", "")))
               for k, v in got.items()}
        assert got == want


def test_registry_names_the_unported_families():
    """The recsys and LM families are ported; the GNN family's one
    architecture raises naming its ROADMAP item."""
    lm = {a for a in jconfigs.list_archs()
          if jconfigs.get_arch(a).family == "lm"}
    assert set(ARCHS) < set(tconfigs.list_archs())
    assert tconfigs.list_archs() == sorted(set(ARCHS) | lm)
    assert set(tconfigs.list_archs()) < set(jconfigs.list_archs())
    for aid in set(jconfigs.list_archs()) - set(tconfigs.list_archs()):
        assert jconfigs.get_arch(aid).family == "gnn"
        with pytest.raises(ValueError, match="ROADMAP A, item 2"):
            tconfigs.get_arch(aid)
    with pytest.raises(ValueError, match="unknown arch"):
        tconfigs.get_arch("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_gradients_match_the_reference(arch):
    jcfg = jconfigs.get_arch(arch).make_reduced()
    tcfg = tconfigs.get_arch(arch).make_reduced()
    params = jrec.init_params(jcfg, jax.random.PRNGKey(3))
    batch = _np(jsyn.recsys_batch(5, 0, 48, jcfg.vocab_sizes, jcfg.n_dense))
    jb = jax.tree.map(jnp.asarray, batch)
    logits_j = jax.jit(lambda p, b: jrec.forward(jcfg, p, b))(params, jb)
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: jrec.loss_fn(jcfg, p, b), has_aux=True))(params, jb)

    model = convert.recsys_params_from_arrays(tcfg, _np(params),
                                              device="cpu")
    assert set(model.state_dict()) == set(flat_state(_np(params)))
    tb = _torch_batch(batch)
    np.testing.assert_allclose(
        trec.forward(tcfg, model, tb).detach().numpy(), logits_j, **FWD)
    loss_t, aux = trec.loss_fn(tcfg, model, tb)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), **FWD)
    assert aux["loss"] is loss_t
    names = [n for n, _ in model.named_parameters()]
    grads_t = torch.autograd.grad(loss_t, list(model.parameters()))
    want = flat_state(_np(grads_j))
    assert set(names) == set(want)
    for name, g in zip(names, grads_t):
        np.testing.assert_allclose(g.numpy(), want[name], **GRAD,
                                   err_msg=name)
        assert np.abs(want[name]).max() > 0, name  # every leaf is reached


@pytest.mark.parametrize("kind", ["one_hot", "multi_hot", "weighted"])
def test_embedding_bag_matches_the_reference(kind):
    rng = np.random.default_rng(0)
    offsets = (0, 7, 30, 31)
    table = rng.standard_normal((40, 6)).astype(np.float32)
    shape = (9, 4) if kind == "one_hot" else (9, 4, 3)
    idx = rng.integers(0, 7, shape).astype(np.int32)
    idx[:, 2] = 0  # the one-row field
    w = (rng.standard_normal(shape).astype(np.float32)
         if kind == "weighted" else None)
    want = jrec.embedding_bag(jnp.asarray(table), jnp.asarray(idx), offsets,
                              weights=None if w is None else jnp.asarray(w))
    got = trec.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                             offsets,
                             weights=None if w is None else
                             torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (9, 4, 6)
    if kind == "one_hot":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_gather_backward_sums_duplicates_in_the_order_they_occur():
    """The gather's backward is a sequential f32 sum of each row's
    gradients in the order its ids occur (as ``np.add.at``), so it has
    the same bits on any device and in any run."""
    rng = np.random.default_rng(6)
    table = torch.zeros((50, 8), requires_grad=True)
    ids = rng.integers(0, 12, (300, 3))  # rows 12..49 untouched
    ids[:, 1] = 7  # a row hit 300 times
    go = rng.standard_normal((300, 3, 8)).astype(np.float32)
    (got,) = torch.autograd.grad(
        trec.gather_rows(table, torch.from_numpy(ids)), table,
        torch.from_numpy(go))
    want = np.zeros((50, 8), np.float32)
    np.add.at(want, ids.reshape(-1), go.reshape(-1, 8))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[12:].any()


def test_two_tower_matches_the_reference():
    jcfg = jrec.RecsysConfig(name="two_tower", model="dlrm", n_sparse=8,
                             embed_dim=16, vocab_sizes=(96,) * 8)
    tcfg = _port_cfg(jcfg)
    n_items = 300
    params = jrec.init_two_tower_params(jcfg, jax.random.PRNGKey(1),
                                        n_items)
    batch = _np(jsyn.two_tower_batch(2, 0, 64, jcfg.vocab_sizes, n_items))
    jb = jax.tree.map(jnp.asarray, batch)
    (loss_j, aux_j), grads_j = jax.value_and_grad(
        lambda p: jrec.two_tower_loss(jcfg, p, jb), has_aux=True)(params)

    model = convert.recsys_params_from_arrays(tcfg, _np(params),
                                              device="cpu")
    assert isinstance(model, trec.TwoTowerModel)
    tb = _torch_batch(batch)
    loss_t, aux_t = trec.two_tower_loss(tcfg, model, tb)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), **FWD)
    assert aux_t["in_batch_acc"].item() == float(aux_j["in_batch_acc"])
    names = [n for n, _ in model.named_parameters()]
    for name, g in zip(names, torch.autograd.grad(loss_t,
                                                  list(model.parameters()))):
        np.testing.assert_allclose(g.numpy(), np.asarray(grads_j[name]),
                                   **GRAD, err_msg=name)
    with torch.no_grad():
        users_t, items_t = trec.two_tower_towers(tcfg, model, tb)
        np.testing.assert_allclose(
            trec.user_repr(tcfg, model, tb).numpy(),
            jrec.user_repr(jcfg, params, jb), **FWD)
        sub = torch.tensor([5, 0, 299, 5])
        np.testing.assert_array_equal(
            trec.item_repr(model, sub).numpy(),
            jrec.item_repr(params, jnp.asarray(sub.numpy())))
    users_j, items_j = jrec.two_tower_towers(jcfg, params, jb)
    np.testing.assert_allclose(users_t.numpy(), users_j, **FWD)
    np.testing.assert_array_equal(items_t.detach().numpy(), items_j)
    # the towers are raw: the item rows keep their norms
    assert not np.allclose(np.linalg.norm(np.asarray(items_j), axis=1), 1.0)


@pytest.mark.parametrize("ties", [False, True])
def test_retrieval_topk_matches_lax_top_k(ties):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((6, 8)).astype(np.float32)
    cand = rng.standard_normal((50, 8)).astype(np.float32)
    if ties:  # exact copies score exactly alike: the lower index first
        cand = np.tile(cand[:10], (5, 1))
        q = np.round(q)
        cand = np.round(cand * 2) / 2
    s_j, i_j = jrec.retrieval_topk(jnp.asarray(q), jnp.asarray(cand), k=12)
    s_t, i_t = trec.retrieval_topk(torch.from_numpy(q),
                                   torch.from_numpy(cand), k=12)
    np.testing.assert_array_equal(i_t.numpy(), i_j)
    np.testing.assert_allclose(s_t.numpy(), s_j, **FWD)
    np.testing.assert_allclose(
        trec.retrieval_scores(torch.from_numpy(q), torch.from_numpy(cand))
        .numpy(), jrec.retrieval_scores(jnp.asarray(q), jnp.asarray(cand)),
        **FWD)
    if ties:
        assert len(np.unique(s_j[0])) < 12


B = 8_192
CRITEO = tuple(trec.CRITEO_26)


def _port_batch(seed=0, step=0, n_dense=13):
    return tsyn.recsys_batch(B, CRITEO, n_dense,
                             generator=tsyn.batch_generator(seed, step))


def test_recsys_batch_ranges_skew_and_labels():
    got = _port_batch()
    ref = _np(jsyn.recsys_batch(0, 0, B, CRITEO, 13))
    assert got["sparse"].dtype == torch.int32
    assert got["sparse"].shape == ref["sparse"].shape == (B, 26)
    assert got["labels"].dtype == torch.float32 and got["labels"].shape == (B,)
    assert got["dense"].dtype == torch.float32
    assert got["dense"].shape == (B, 13)
    sparse = got["sparse"].numpy()
    maxes = np.asarray(CRITEO)
    assert (sparse >= 0).all() and (sparse < maxes[None, :]).all()
    # the top 1% of a field's rows draws ~21.5% (0.01 ** (1/3)) of its
    # lookups, as in the reference, far more than 1%
    big = maxes >= 10_000
    hot = (sparse[:, big] < maxes[big] // 100).mean()
    hot_ref = (ref["sparse"][:, big] < maxes[big] // 100).mean()
    assert hot > 0.15 and abs(hot - hot_ref) < 0.02, (hot, hot_ref)
    rate = float(got["labels"].mean())
    assert set(np.unique(got["labels"].numpy())) == {0.0, 1.0}
    assert abs(rate - 0.25) <= 0.02, rate
    dense = got["dense"].numpy()
    assert abs(dense.mean()) < 0.02 and abs(dense.std() - 1.0) < 0.02
    # a pure function of (seed, step); another step is another batch
    again = _port_batch()
    assert all(torch.equal(got[k], again[k]) for k in got)
    assert not torch.equal(got["sparse"], _port_batch(step=1)["sparse"])


def test_item_hash_equals_the_reference_exactly():
    n_items = 1_000_000
    ref = _np(jsyn.two_tower_batch(0, 0, B, CRITEO, n_items))
    sparse = ref["sparse"]
    # the field-2 term passes 2**31: the hash wraps as int32 arithmetic
    assert (sparse[:, 2].astype(np.int64) * 255 >= 2**31).any()
    got = tsyn.item_hash(torch.from_numpy(np.array(sparse)), n_items)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref["items"])
    small = _np(jsyn.two_tower_batch(1, 3, 500, (7, 5), 11))
    np.testing.assert_array_equal(
        tsyn.item_hash(torch.from_numpy(np.array(small["sparse"])), 11).numpy(),
        small["items"])
    port = tsyn.two_tower_batch(B, CRITEO, n_items,
                                generator=tsyn.batch_generator(0, 0))
    assert set(port) == {"sparse", "items"}
    assert torch.equal(port["items"], tsyn.item_hash(port["sparse"], n_items))
    assert int(port["items"].min()) >= 0
    assert int(port["items"].max()) < n_items
