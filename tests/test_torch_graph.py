"""The port's graph data (``repro_torch.data.graph`` and
``data.synthetic.geometric_graph_batch``) against the JAX package's, on
the CPU: both draw with numpy from the same seed, so every array must be
the reference's, bit for bit (dtype included)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.data import graph as jgraph  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.data import graph as tgraph  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402

SEEDS = [0, 1, 7, 123]


def _same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("seed", SEEDS)
def test_random_graph_and_csr_match_the_reference(seed):
    want = jgraph.random_graph(500, 6, seed=seed)
    got = tgraph.random_graph(500, 6, seed=seed)
    assert got.num_nodes == want.num_nodes == 500
    _same(got.indptr, want.indptr, "indptr")
    _same(got.indices, want.indices, "indices")
    for v in (0, 17, 499):
        _same(got.neighbors(v), want.neighbors(v), f"neighbors({v})")
    s = np.random.default_rng(seed).integers(0, 40, 300)
    r = np.random.default_rng(seed + 1).integers(0, 40, 300)
    a = jgraph.CSRGraph.from_edges(s, r, 40)
    b = tgraph.CSRGraph.from_edges(s, r, 40)
    _same(b.indptr, a.indptr, "from_edges indptr")
    _same(b.indices, a.indices, "from_edges indices")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fanout", [(5,), (10, 5), (3, 3, 2)])
def test_neighbourhood_sampling_matches_the_reference(seed, fanout):
    g_j = jgraph.random_graph(2_000, 8, seed=seed)
    g_t = tgraph.random_graph(2_000, 8, seed=seed)
    roots = np.random.default_rng(seed).choice(2_000, 32, replace=False)
    want = jgraph.sample_neighborhood(g_j, roots, fanout,
                                      np.random.default_rng(seed + 5))
    got = tgraph.sample_neighborhood(g_t, roots, fanout,
                                     np.random.default_rng(seed + 5))
    for name, a, b in zip(("nodes", "senders", "receivers"), got, want):
        _same(a, b, name)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("max_nodes,max_edges", [(600, 900), (64, 80)])
def test_padded_batches_match_the_reference(seed, max_nodes, max_edges):
    """``sample_padded_batch`` (and so ``pad_subgraph``): the same keys and
    arrays; the small case cuts nodes and edges at the static sizes."""
    kw = dict(max_nodes=max_nodes, max_edges=max_edges, seed=seed)
    want = jgraph.sample_padded_batch(jgraph.random_graph(3_000, 5, seed),
                                      64, (8, 4), **kw)
    got = tgraph.sample_padded_batch(tgraph.random_graph(3_000, 5, seed),
                                     64, (8, 4), **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        _same(got[k], want[k], k)
    # an isolated root set: no edges survive the padding
    empty = tgraph.pad_subgraph(np.arange(4), np.zeros(0, np.int64),
                                np.zeros(0, np.int64), np.arange(2),
                                max_nodes=8, max_edges=4)
    assert not empty["edge_mask"].any() and empty["root_mask"].sum() == 2


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("node_level", [False, True])
@pytest.mark.parametrize("shape", [(64, 192, 8, 4), (3_840, 8_192, 16, 128),
                                   (100, 30, 3, 1)])
def test_geometric_graph_batch_is_the_references(seed, node_level, shape):
    """The port's tensors carry the reference's arrays bit for bit, on the
    device asked for."""
    n_nodes, n_edges, d_feat, n_graphs = shape
    want = jsyn.geometric_graph_batch(seed, n_nodes, n_edges, d_feat,
                                      n_graphs=n_graphs,
                                      node_level=node_level)
    got = tsyn.geometric_graph_batch(seed, n_nodes, n_edges, d_feat,
                                     n_graphs=n_graphs,
                                     node_level=node_level, device="cpu")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].device.type == "cpu"
        _same(got[k].numpy(), np.asarray(v), k)
