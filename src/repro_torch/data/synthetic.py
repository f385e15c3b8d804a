"""Synthetic data generators (PyTorch counterpart of ``repro.data.synthetic``):
the paper's spaces, the LM token streams, the recsys click batches and the
geometric graphs of the GNN family.

Draws come from a ``torch.Generator``: the distributions are the JAX
package's, the bits are not (``jax.random`` streams cannot be replayed).
The graphs are the exception: the reference draws them with numpy's
``default_rng(seed)``, and so does ``geometric_graph_batch``, so its arrays
are the reference's, bit for bit.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def manifold_space(n: int, dim: int, intrinsic: int, noise: float = 0.01,
                   *, generator: torch.Generator) -> Tensor:
    """Data on an ``intrinsic``-dimensional nonlinear manifold embedded in
    R^dim — the GloVe/CNN-feature stand-in (paper §5.4).

    Drawn on the generator's device, so a CUDA generator builds a large
    corpus on the card without a host round trip.
    """
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    z = normal(n, intrinsic)
    w1 = normal(intrinsic, 2 * intrinsic) / math.sqrt(intrinsic)
    w2 = normal(2 * intrinsic, dim) / math.sqrt(2 * intrinsic)
    x = torch.tanh(z @ w1) @ w2
    return x + noise * normal(n, dim)


def uniform_space(n: int, dim: int, *, generator: torch.Generator) -> Tensor:
    """Uniform [0, 1) vectors, on the generator's device (paper §5.3)."""
    return torch.rand((n, dim), generator=generator, device=generator.device)


def gaussian_space(n: int, dim: int, *, generator: torch.Generator) -> Tensor:
    """Standard normal vectors, on the generator's device (paper §5.3)."""
    return torch.randn((n, dim), generator=generator,
                       device=generator.device)


def relu_feature_space(n: int, dim: int, intrinsic: int, *,
                       generator: torch.Generator) -> Tensor:
    """Non-negative CNN-activation-like data (the cosine experiments)."""
    return torch.relu(manifold_space(n, dim, intrinsic, generator=generator))


def probability_space(n: int, dim: int, intrinsic: Optional[int] = None, *,
                      generator: torch.Generator) -> Tensor:
    """l1-normalised positive vectors, the Jensen-Shannon domain (paper
    §5.6): uniform draws, or softplus of a manifold when ``intrinsic`` is
    given; on the generator's device."""
    if intrinsic is None:
        x = uniform_space(n, dim, generator=generator)
    else:
        x = torch.nn.functional.softplus(
            manifold_space(n, dim, intrinsic, generator=generator))
    return x / torch.clamp_min(torch.sum(x, dim=1, keepdim=True), 1e-12)


# -- model-family batches ---------------------------------------------------------


def batch_generator(seed: int, step: int, device=None) -> torch.Generator:
    """The generator of batch ``step`` of stream ``seed``: a fresh generator
    seeded from the pair, so a batch is a pure function of (seed, step) and
    a restarted trainer gets the same batches (on the same device type)."""
    if not (0 <= seed < 2**31 and 0 <= step < 2**32):
        raise ValueError(f"seed {seed} / step {step} out of range")
    gen = torch.Generator(device=device if device is not None else "cpu")
    return gen.manual_seed((seed << 32) | step)


def lm_batch(batch: int, seq: int, vocab: int, *,
             generator: torch.Generator) -> dict:
    """I.i.d. uniform tokens (batch, seq) int32 in [0, vocab), drawn on the
    generator's device."""
    return {"tokens": torch.randint(0, vocab, (batch, seq),
                                    generator=generator,
                                    device=generator.device,
                                    dtype=torch.int32)}


#: transition-logit entries of one block of rows that ``lm_markov_batch``
#: evaluates at once (1 GiB of f32): a fixed number, so the draws of a
#: batch do not depend on the device's memory
MARKOV_BLOCK_ELEMS = 1 << 28


def markov_factors(seed: int, vocab: int, *, device=None
                   ) -> Tuple[Tensor, Tensor]:
    """The low-rank factors (A (vocab, rank), B (rank, vocab)) of stream
    ``seed``'s transition logits ``A @ B / (sqrt(rank) * concentration)``,
    rank = max(4, min(16, vocab // 32)); drawn on ``device`` from a
    generator of ``seed`` alone (outside ``batch_generator``'s seeds), so
    every step of the stream shares them."""
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed {seed} out of range")
    rank = max(4, min(16, vocab // 32))
    gen = torch.Generator(device=device if device is not None else "cpu")
    gen.manual_seed((1 << 63) | seed)
    A = torch.randn((vocab, rank), generator=gen, device=gen.device)
    B = torch.randn((rank, vocab), generator=gen, device=gen.device)
    return A, B


def markov_logits(A: Tensor, B: Tensor, tokens: Tensor,
                  concentration: float = 1.0) -> Tensor:
    """The transition-logit rows of ``tokens``: rows of the dense
    ``A @ B / (sqrt(rank) * concentration)``, evaluated for those rows
    alone (the dense matrix is 92 GB at a 151,936-token vocabulary)."""
    return (A[tokens.long()] @ B) / (math.sqrt(A.shape[1]) * concentration)


def lm_markov_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
                    concentration: float = 1.0, *, device=None) -> dict:
    """First-order Markov token streams (structured LM data).

    ``lm_batch`` draws i.i.d. uniform tokens: a trained LM collapses every
    next-token distribution toward the same unigram. Here tokens follow a
    fixed (per ``seed``) peaked, low-rank transition matrix
    (``markov_factors``), so the learned next-token distributions depend
    on the context: a probability-simplex corpus with real neighbourhood
    geometry for the paper's §5.6 JSD experiments. The first token is
    uniform; each next one is a categorical draw from its row
    (Gumbel-max, the first index on a tie), the rows evaluated lazily in
    blocks of ``MARKOV_BLOCK_ELEMS`` entries. Deterministic in (seed,
    step) on one device type.
    """
    A, B = markov_factors(seed, vocab, device=device)
    gen = batch_generator(seed, step, device)
    dev = gen.device
    tok = torch.randint(0, vocab, (batch,), generator=gen, device=dev)
    rows = max(1, MARKOV_BLOCK_ELEMS // vocab)
    out = [tok]
    for _ in range(seq - 1):
        nxt = torch.empty_like(tok)
        for lo in range(0, batch, rows):
            logits = markov_logits(A, B, tok[lo:lo + rows], concentration)
            u = torch.rand(logits.shape, generator=gen, device=dev)
            gumbel = -torch.log(-torch.log(
                torch.clamp_min(u, torch.finfo(u.dtype).tiny)))
            nxt[lo:lo + rows] = torch.argmax(logits + gumbel, dim=-1)
        tok = nxt
        out.append(tok)
    return {"tokens": torch.stack(out, dim=1).to(torch.int32)}


def recsys_batch(batch: int, vocab_sizes, n_dense: int = 0, *,
                 generator: torch.Generator) -> dict:
    """Criteo-shaped click log: Zipf-skewed (``u**3``) sparse ids per field,
    Bernoulli(0.25) labels and, with ``n_dense``, normal dense features;
    drawn on the generator's device."""
    dev = generator.device
    maxes = torch.as_tensor(tuple(vocab_sizes), dtype=torch.int32,
                            device=dev)
    u = torch.rand((batch, len(vocab_sizes)), generator=generator,
                   device=dev)
    # zipf-ish skew: hot rows are hit much more often (realistic table
    # traffic); the product is f32 and truncates, as the reference's
    sparse = torch.minimum((u**3 * maxes[None, :].float()).to(torch.int32),
                           maxes[None, :] - 1)
    labels = (torch.rand((batch,), generator=generator, device=dev)
              < 0.25).float()
    out = {"sparse": sparse, "labels": labels}
    if n_dense:
        out["dense"] = torch.randn((batch, n_dense), generator=generator,
                                   device=dev)
    return out


def item_hash(sparse: Tensor, n_items: int) -> Tensor:
    """The positive item of each user row: a hash of its three leading
    fields with the multipliers 131 + 62 j, in int32 arithmetic that wraps
    as the reference's does, then a floor modulo ``n_items``."""
    n_hash = min(3, sparse.shape[1])
    mult = 131 + 62 * torch.arange(n_hash, dtype=torch.int64,
                                   device=sparse.device)
    total = (sparse[:, :n_hash].long() * mult[None, :]).sum(1)
    wrapped = (total + 2**31) % 2**32 - 2**31      # int32 overflow
    return torch.remainder(wrapped, n_items).to(torch.int32)


def two_tower_batch(batch: int, vocab_sizes, n_items: int, *,
                    generator: torch.Generator) -> dict:
    """Criteo-shaped sparse user features and a co-clicked positive item id
    (``item_hash`` of the user's leading fields): a consistent user pattern
    -> item mapping to learn, under ``recsys_batch``'s skew."""
    sparse = recsys_batch(batch, vocab_sizes, generator=generator)["sparse"]
    return {"sparse": sparse, "items": item_hash(sparse, n_items)}


def geometric_graph_batch(seed: int, n_nodes: int, n_edges: int, d_feat: int,
                          n_graphs: int = 1, node_level: bool = False,
                          box: float = 8.0, *, device) -> dict:
    """Random geometric graph(s) with synthetic 3D positions, as tensors on
    ``device``: the reference's numpy draws from ``default_rng(seed)``, in
    its order (positions uniform in a ``box`` cube, senders uniform,
    receivers a sender plus an offset in [1, max(n_nodes // 64, 2)) modulo
    ``n_nodes``, sorted graph ids, normal features, then the targets:
    per-node with ``loss_node_mask`` when ``node_level``, else per graph).
    Like the reference's, the batch holds neither ``n_graphs`` nor
    ``node_level``; the caller adds them."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, box, size=(n_nodes, 3)).astype(np.float32)
    send = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    # bias edges toward spatial neighbours: jitter around sender positions
    recv = (send + rng.integers(1, max(n_nodes // 64, 2), n_edges)) % n_nodes
    recv = recv.astype(np.int32)
    node_graph = np.sort(rng.integers(0, n_graphs, n_nodes)).astype(np.int32)
    feat = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)

    def t(a):
        return torch.from_numpy(a).to(device)

    batch = {
        "positions": t(pos),
        "node_feat": t(feat),
        "senders": t(send),
        "receivers": t(recv),
        "edge_mask": torch.ones((n_edges,), device=device),
        "node_mask": torch.ones((n_nodes,), device=device),
        "node_graph": t(node_graph),
    }
    if node_level:
        batch["target_nodes"] = t(rng.normal(size=(n_nodes,))
                                  .astype(np.float32))
        batch["loss_node_mask"] = torch.ones((n_nodes,), device=device)
    else:
        batch["target_energy"] = t(rng.normal(size=(n_graphs,))
                                   .astype(np.float32))
    return batch
