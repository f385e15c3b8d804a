"""The reduced JSD leg of the LM family against the JAX package, on the
CPU: next-token rows of the port's LM (``launch.train_lm``) served through
the flat and IVF Zen servers at ``metric="jsd"``, as
``benchmarks/retrieval_e2e.py::jsd_lm_leg`` serves the reference's at its
smoke size.

Tolerances: the rows rtol 1e-5 / atol 1e-7 (softmax of f32 logits); the
served distances rtol 1e-4 / atol 1e-4 with ids equal outside near-ties
(``repro_torch.testing.topk_mismatch``): the port fits its own transform
from the reference's reference ids, a Cholesky factor and triangular
solve in another library. Corpus rows queried back: distances atol 2e-3
(a self distance is the square root of f32 noise in K = D^2; the
reference's own bound).
"""
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train_lm as ttrain_lm  # noqa: E402
from repro_torch.testing import topk_mismatch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _ref_ids(corpus, refs):
    """The corpus rows the reference drew as its references."""
    d = np.abs(corpus[None, :, :] - refs[:, None, :]).sum(-1)
    ids = d.argmin(1)
    assert (d.min(1) < 1e-5).all()
    return [int(i) for i in ids]


def test_reduced_jsd_leg_matches_the_reference(example):
    """``benchmarks/retrieval_e2e.py::jsd_lm_leg`` at its smoke size: next-
    token rows at temperature 6 of 256 + 32 Markov contexts, the flat and
    IVF servers at k = 16, re-rank 16, n = 10, nprobe max(8, C // 2).
    The port's flat index fits from the reference's reference ids; its IVF
    index holds the reference's quantizer and tiles."""
    jcfg = jconfigs.get_arch("qwen1.5-0.5b").make_reduced()
    tcfg = tconfigs.get_arch("qwen1.5-0.5b").make_reduced()
    params = jax.jit(lambda k: jtfm.init_params(jcfg, k))(
        jax.random.PRNGKey(0))
    model = convert.transformer_from_arrays(tcfg, _np(params), device="cpu")
    toks = np.asarray(jsyn.lm_markov_batch(1, 0, 288, 32, 512)["tokens"])
    P = ttrain_lm.next_token_distributions(tcfg, model, _t(toks),
                                           temperature=6.0).numpy()
    P_ref = np.asarray(example.next_token_distributions(
        jcfg, params, jnp.asarray(toks), temperature=6.0))
    np.testing.assert_allclose(P, P_ref, rtol=1e-5, atol=1e-7)
    corpus, queries = P[:256], P[256:]
    for kind in ("flat", "ivf"):
        jidx = jserve.build_index(jnp.asarray(corpus), 16, metric="jsd",
                                  index=kind, key=jax.random.PRNGKey(3))
        ids = _ref_ids(corpus, np.asarray(jidx.transform.refs))
        tidx = tserve.build_index(_t(corpus), 16, metric="jsd",
                                  pivot_ids=ids, device="cpu")
        kw = {}
        if kind == "ivf":
            iv = jidx.ivf
            tidx = convert.ivf_index_from_arrays(
                tidx.transform, centroids=np.asarray(iv.centroids),
                tile_coords=np.asarray(iv.tile_coords),
                tile_ids=np.asarray(iv.tile_ids),
                tiles_per_cluster=iv.tiles_per_cluster,
                tile_rows=iv.tile_rows, n_valid=iv.n_valid, corpus=corpus,
                device="cpu")
            kw = {"nprobe": max(8, iv.n_clusters // 2)}
        want = jserve.ZenServer(jidx, rerank_factor=16, **kw).query(
            jnp.asarray(queries), 10)
        server = tserve.ZenServer(tidx, rerank_factor=16, **kw)
        got = server.query(_t(queries), 10)
        msg = topk_mismatch(got[0], got[1], want[0], want[1], rtol=1e-4,
                            atol=1e-4)
        assert msg is None, f"{kind}: {msg}"
        # corpus rows queried: the reference's answers, and on the flat
        # server each row first at JSD < 2e-3 (the reference's check;
        # these rows of an untrained model are near-one-hot, so the
        # estimator's first stage needs the leg's n = 10, and the IVF
        # probe misses some rows' own clusters in both packages)
        d, i = server.query(_t(corpus[:24]), 10)
        wd, wi = jserve.ZenServer(jidx, rerank_factor=16, **kw).query(
            jnp.asarray(corpus[:24]), 10)
        # a self distance is the square root of f32 noise in K = D^2 (the
        # reference's 2e-3 bound), so these distances take that atol
        msg = topk_mismatch(d, i, wd, wi, rtol=1e-4, atol=2e-3)
        assert msg is None, f"{kind} self queries: {msg}"
        if kind == "flat":
            np.testing.assert_array_equal(i[:, 0].numpy(), np.arange(24))
            assert float(d[:, 0].abs().max()) < 2e-3
