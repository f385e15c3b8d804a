"""Graph data utilities: CSR neighbour sampling (GraphSAGE-style fanout) and
static-shape padding (the port's copy of ``repro.data.graph``: numpy only,
the same arrays from the same seed).

The ``minibatch_lg`` shape requires a REAL neighbour sampler: given a batch of
root nodes, sample ``fanout[0]`` 1-hop neighbours per root and ``fanout[1]``
2-hop neighbours per 1-hop node from a CSR adjacency, deduplicate into a
subgraph with relabelled node ids, and pad to static (n_nodes, n_edges).
Sampling is host-side numpy (data pipeline), as in every production GNN
stack; the device step sees only dense padded arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray   # (N+1,)
    indices: np.ndarray  # (nnz,)
    num_nodes: int

    @staticmethod
    def from_edges(senders: np.ndarray, receivers: np.ndarray, num_nodes: int
                   ) -> "CSRGraph":
        order = np.argsort(senders, kind="stable")
        s, r = senders[order], receivers[order]
        counts = np.bincount(s, minlength=num_nodes)
        indptr = np.zeros(num_nodes + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSRGraph(indptr=indptr, indices=r.astype(np.int64),
                        num_nodes=num_nodes)

    def neighbors(self, node: int) -> np.ndarray:
        return self.indices[self.indptr[node]: self.indptr[node + 1]]


def random_graph(num_nodes: int, avg_degree: int, seed: int = 0) -> CSRGraph:
    rng = np.random.default_rng(seed)
    nnz = num_nodes * avg_degree
    senders = rng.integers(0, num_nodes, nnz)
    receivers = rng.integers(0, num_nodes, nnz)
    return CSRGraph.from_edges(senders, receivers, num_nodes)


def sample_neighborhood(
    graph: CSRGraph,
    roots: np.ndarray,
    fanout: Sequence[int],
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Layer-wise fanout sampling.

    Returns (nodes, senders, receivers): global node ids of the subgraph and
    its edge list in *global* ids (relabelling happens in ``pad_subgraph``).
    Edges point sampled-neighbour -> frontier node (message direction).
    """
    nodes = [np.unique(roots)]
    senders, receivers = [], []
    frontier = nodes[0]
    for k in fanout:
        new_src = []
        for v in frontier:
            nbrs = graph.neighbors(v)
            if nbrs.size == 0:
                continue
            take = rng.choice(nbrs, size=min(k, nbrs.size), replace=False)
            new_src.append(np.stack([take, np.full(take.size, v)], axis=0))
        if not new_src:
            break
        e = np.concatenate(new_src, axis=1)
        senders.append(e[0])
        receivers.append(e[1])
        frontier = np.unique(e[0])
        nodes.append(frontier)
    all_nodes = np.unique(np.concatenate(nodes))
    if senders:
        s = np.concatenate(senders)
        r = np.concatenate(receivers)
    else:
        s = np.zeros(0, np.int64)
        r = np.zeros(0, np.int64)
    return all_nodes, s, r


def pad_subgraph(
    nodes: np.ndarray,
    senders: np.ndarray,
    receivers: np.ndarray,
    roots: np.ndarray,
    *,
    max_nodes: int,
    max_edges: int,
) -> dict:
    """Relabel to local ids and pad to static shapes."""
    nodes = nodes[:max_nodes]
    lut = {int(g): i for i, g in enumerate(nodes)}
    keep = np.array(
        [int(s) in lut and int(r) in lut for s, r in zip(senders, receivers)],
        bool,
    ) if senders.size else np.zeros(0, bool)
    s = np.array([lut[int(x)] for x in senders[keep]], np.int32)[:max_edges]
    r = np.array([lut[int(x)] for x in receivers[keep]], np.int32)[:max_edges]
    n, e = nodes.shape[0], s.shape[0]
    out = {
        "local_nodes": nodes.astype(np.int64),
        "senders": np.pad(s, (0, max_edges - e)).astype(np.int32),
        "receivers": np.pad(r, (0, max_edges - e)).astype(np.int32),
        "edge_mask": np.pad(np.ones(e, np.float32), (0, max_edges - e)),
        "node_mask": np.pad(np.ones(n, np.float32), (0, max_nodes - n)),
        "root_mask": np.zeros(max_nodes, np.float32),
    }
    for g in roots:
        if int(g) in lut:
            out["root_mask"][lut[int(g)]] = 1.0
    return out


def sample_padded_batch(
    graph: CSRGraph,
    batch_nodes: int,
    fanout: Sequence[int],
    *,
    max_nodes: int,
    max_edges: int,
    seed: int = 0,
) -> dict:
    rng = np.random.default_rng(seed)
    roots = rng.choice(graph.num_nodes, size=batch_nodes, replace=False)
    nodes, s, r = sample_neighborhood(graph, roots, fanout, rng)
    return pad_subgraph(nodes, s, r, roots, max_nodes=max_nodes,
                        max_edges=max_edges)
