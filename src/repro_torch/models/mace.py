"""MACE: higher-order equivariant message passing (arXiv:2206.07697) with
Cartesian irreps (l = 0, 1, 2) (PyTorch counterpart of
``repro.models.mace``).

Features are kept in Cartesian irrep form:
  h0: (N, C)        scalars            (l = 0)
  h1: (N, C, 3)     vectors            (l = 1)
  h2: (N, C, 3, 3)  traceless symmetric rank-2 tensors (l = 2)

Every Clebsch-Gordan coupling is dense tensor algebra (dot, cross, outer,
contraction, symmetric-traceless projection). The structure is the
reference's: a Bessel radial basis with a polynomial cutoff and a radial
MLP giving per-edge, per-path channel weights; the A-basis, a density over
neighbours of Y(r_hat) (x) h_j paths summed edge -> node; the B-basis,
symmetric contractions of A up to correlation order 3; per-layer channel
mixes, self-connections and invariant readouts; per-graph energies.

The reference's rounding points are kept:

* **dtypes promote as the reference's**: ``sym_traceless`` multiplies by an
  f32 identity, so ``outer11`` and ``mat22`` of bf16 inputs return f32
  while ``mat21`` and ``cross11`` stay bf16. Under bf16 the l = 2 edge
  paths, ``a2``, ``A2`` (with ``edge_chunks == 1``) and the B-basis terms
  built on them are f32, and a channel mix of an f32 path promotes its
  bf16 weights. torch promotes two tensors as JAX does; where torch
  refuses mixed operands (``@``) the port casts both to the promoted
  dtype first.
* a contraction (``mat21``, ``mat22``'s product, the channel mixes, the
  linears) is a dot: exact products accumulated in f32, rounded once to
  the promoted dtype; an elementwise product rounds, then a ``sum``
  accumulates in f32 and rounds once (``dot11``, ``ddot22``, the trace);
* sums over paths add left to right, as Python's ``sum``;
* the edge -> node reduction is ``layers.segment_sum``: each node adds its
  edges one after another in edge order, in the message's dtype (the
  reference's scatter-add), with the edges of each chunk stably sorted by
  receiver once a forward (a chunk keeps its edge set, a node its edge
  order); with ``edge_chunks > 1`` the chunks accumulate into f32 in
  chunk order and are cast once. Sender gathers go through
  ``layers.gather_rows``. Neither uses float atomics, so a step is the
  same bits every time on the card;
* remat is ``torch.utils.checkpoint`` around each layer and, with
  ``edge_chunks > 1``, each chunk.

The reference's sharding hooks (``edge_axes``, ``channel_axes``) are GSPMD
constraints. The port's sharded path (``init_sharded``,
``sharded_loss_fn``, the end of this module) lays the leaves out on a
(data, model) mesh by the reference's partition rules, splits the edges
over ``data`` and the channels over ``model``, and computes the same
function.
"""
from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt_lib

from repro_torch.distributed.partition import (
    ShardedTensor,
    all_sum,
    axis_groups,
    place,
    sum_scatter,
    sum_to,
)
from repro_torch.distributed.sharding import gnn_param_specs

from . import layers as L

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    channels: int = 128          # d_hidden
    l_max: int = 2               # fixed: this implementation carries l <= 2
    correlation: int = 3         # correlation order (nu)
    n_rbf: int = 8
    d_feat: int = 1              # raw node-feature dim (embedded to channels)
    r_cut: float = 5.0
    radial_hidden: int = 64
    readout_hidden: int = 16
    dtype: Any = torch.float32
    remat: bool = False
    # process edges in this many chunks, accumulating the A-basis in f32:
    # transient edge tensors shrink by the chunk count
    edge_chunks: int = 1

    def param_count(self) -> int:
        """The reference's rough estimate (``MACEConfig.param_count``)."""
        C = self.channels
        per_layer = (
            self.n_rbf * self.radial_hidden
            + self.radial_hidden * C * N_A_PATHS
            + C * C * (3 + N_MSG0 + N_MSG1 + N_MSG2)
            + C * self.readout_hidden + self.readout_hidden
        )
        return self.d_feat * C + self.n_layers * per_layer


# path counts (see product_paths): A-density paths 3+5+4; message inputs are
# [A_l, B2-paths_l, B3_l] = (1+3+1, 1+5+1, 1+4+1) per output l.
N_A_PATHS = 12
N_MSG0, N_MSG1, N_MSG2 = 5, 7, 6


# -- irrep algebra (all channel-wise; shapes (..., C[, 3[, 3]])) --------------


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The accumulation dtype of a dot of ``dtype`` operands."""
    return torch.promote_types(dtype, torch.float32)


def sym_traceless(t: Tensor) -> Tensor:
    """Project (..., 3, 3) onto the l=2 (symmetric traceless) component; the
    f32 identity promotes a bf16 ``t`` to f32, as the reference's does."""
    s = 0.5 * (t + t.transpose(-1, -2))
    tr = s.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(3, dtype=torch.float32, device=t.device)
    return s - tr * eye / 3.0


def outer11(a: Tensor, b: Tensor) -> Tensor:
    """(...,3) x (...,3) -> l=2 part of the outer product."""
    return sym_traceless(a[..., :, None] * b[..., None, :])


def dot11(a: Tensor, b: Tensor) -> Tensor:
    return (a * b).sum(-1)


def cross11(a: Tensor, b: Tensor) -> Tensor:
    """``jnp.cross``'s three components, each a difference of two rounded
    products."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def ddot22(a: Tensor, b: Tensor) -> Tensor:
    """double contraction (l2 (x) l2 -> l0)."""
    return (a * b).sum((-2, -1))


def mat21(t: Tensor, v: Tensor) -> Tensor:
    """(...,3,3) . (...,3) -> (...,3)   (l2 (x) l1 -> l1), a dot."""
    dt = torch.promote_types(t.dtype, v.dtype)
    t, v = t.to(_acc(dt)), v.to(_acc(dt))
    out = (t[..., :, 0] * v[..., None, 0] + t[..., :, 1] * v[..., None, 1]
           + t[..., :, 2] * v[..., None, 2])
    return out.to(dt)


def mat22(a: Tensor, b: Tensor) -> Tensor:
    """l=2 part of the matrix product (l2 (x) l2 -> l2), the product a
    dot."""
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(_acc(dt)), b.to(_acc(dt))
    prod = (a[..., :, 0, None] * b[..., None, 0, :]
            + a[..., :, 1, None] * b[..., None, 1, :]
            + a[..., :, 2, None] * b[..., None, 2, :])
    return sym_traceless(prod.to(dt))


def product_paths(u: Tuple[Tensor, Tensor, Tensor],
                  v: Tuple[Tensor, Tensor, Tensor],
                  ls: Tuple[int, ...] = (0, 1, 2)) -> Dict[int, list]:
    """All CG-allowed channel-wise products of two irrep triples (l <= 2),
    by output l (those of ``ls``)."""
    u0, u1, u2 = u
    v0, v1, v2 = v
    out = {}
    if 0 in ls:
        out[0] = [u0 * v0, dot11(u1, v1), ddot22(u2, v2)]
    if 1 in ls:
        out[1] = [
            u0[..., None] * v1,
            v0[..., None] * u1,
            cross11(u1, v1),
            mat21(u2, v1),
            mat21(v2, u1),
        ]
    if 2 in ls:
        out[2] = [
            u0[..., None, None] * v2,
            v0[..., None, None] * u2,
            outer11(u1, v1),
            mat22(u2, v2),
        ]
    return out


def _sum(terms) -> Tensor:
    """Left to right, each add promoting as the reference's ``sum``."""
    terms = list(terms)
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


# -- radial basis --------------------------------------------------------------


def bessel_basis(d: Tensor, n_rbf: int, r_cut: float) -> Tensor:
    """sin(n pi d / rc) / d with smooth polynomial cutoff (E: (E, n_rbf)),
    f32; the envelope's powers as ``lax.integer_pow`` forms them."""
    d = torch.clamp_min(d, 1e-9)
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=d.device)
    arg = n[None, :] * math.pi * d[:, None] / r_cut
    c = torch.sqrt(torch.tensor(2.0 / r_cut, dtype=torch.float32,
                                device=d.device))
    rbf = c * torch.sin(arg) / d[:, None]
    # polynomial cutoff envelope (p = 5)
    x = torch.clamp(d / r_cut, 0.0, 1.0)
    x2 = x * x
    x4 = x2 * x2
    env = 1.0 - 10.0 * (x * x2) + 15.0 * x4 - 6.0 * (x * x4)
    return rbf * env[:, None]


# -- params --------------------------------------------------------------------


def _layer_shapes(cfg: MACEConfig) -> Dict[str, Tuple[tuple, Any]]:
    """Each layer leaf's shape and init scale (None: fan-in), in the
    reference's order of draws."""
    C, H = cfg.channels, cfg.radial_hidden
    return {
        # radial MLP: n_rbf -> hidden -> (n_paths, C) per-edge TP weights
        "rad_w1": ((cfg.n_rbf, H), None),
        "rad_w2": ((H, N_A_PATHS, C), None),
        # channel-mixing linears per output l, stored (P, C_in, C_out)
        "msg0": ((N_MSG0, C, C), None),
        "msg1": ((N_MSG1, C, C), None),
        "msg2": ((N_MSG2, C, C), None),
        # self-connection linears per l
        "self0": ((C, C), None),
        "self1": ((C, C), None),
        "self2": ((C, C), None),
        # per-channel weights for the nu=2 / nu=3 symmetric contractions
        "w_corr2": ((C,), 1.0),
        "w_corr3": ((C,), 1.0),
        # invariant readout
        "ro_w1": ((C, cfg.readout_hidden), None),
        "ro_w2": ((cfg.readout_hidden, 1), None),
    }


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(tuple(shape), dtype=dtype, device=device))


class MACELayer(nn.Module):
    """One interaction layer's leaves, by the reference's names."""

    def __init__(self, cfg: MACEConfig, device=None):
        super().__init__()
        for name, (shape, _) in _layer_shapes(cfg).items():
            setattr(self, name, _param(shape, cfg.dtype, device))


class MACE(nn.Module):
    """The parameters of one MACE model; uninitialised until ``init_params``
    draws them or a caller loads them. ``state_dict`` keys mirror the
    reference's pytree paths (``embed``, ``layers.0.rad_w1``, ...)."""

    def __init__(self, cfg: MACEConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = _param((cfg.d_feat, cfg.channels), cfg.dtype, device)
        self.layers = nn.ModuleList(MACELayer(cfg, device)
                                    for _ in range(cfg.n_layers))


def _draws(cfg: MACEConfig, generator: torch.Generator):
    """(name, value) of every leaf, drawn in the reference's order on the
    generator's device: truncated-normal fan-in (``layers.dense_init``),
    the correlation weights at scale 1."""
    yield "embed", L.dense_init((cfg.d_feat, cfg.channels), None, cfg.dtype,
                                generator=generator)
    for i in range(cfg.n_layers):
        for name, (shape, scale) in _layer_shapes(cfg).items():
            yield f"layers.{i}.{name}", L.dense_init(
                shape, scale, cfg.dtype, generator=generator)


@torch.no_grad()
def init_params(cfg: MACEConfig, *, generator: torch.Generator) -> MACE:
    """A model with random weights on the generator's device."""
    model = MACE(cfg, device=generator.device)
    params = dict(model.named_parameters())
    for name, value in _draws(cfg, generator):
        params[name].copy_(value)
    return model


# -- forward -------------------------------------------------------------------


def _mm(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` in the promoted dtype (the reference's default-precision
    product: f32 accumulation, one rounding)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _silu(x: Tensor) -> Tensor:
    """``jax.nn.silu``: x * sigmoid(x), two roundings in low precision."""
    return x * torch.sigmoid(x)


def _contract(p: Tensor, w: Tensor) -> Tensor:
    """einsum("nc...,cd->nd...", p, w)."""
    return _mm(p.movedim(1, -1), w).movedim(-1, 1)


def _channel_mix(paths: list, w: Tensor) -> Tensor:
    """Mix per-path channel features: sum_p paths[p] @ w[p]
    (w: (P, C_in, C_out)), left to right."""
    return _sum(_contract(p, w[i]) for i, p in enumerate(paths))


class _Edges(NamedTuple):
    """The edges, each chunk's stably sorted by receiver, and their
    geometry."""
    send: Tensor
    recv: Tensor
    emask: Tensor
    y1: Tensor
    y2: Tensor
    rbf: Tensor

    def chunk(self, c: int, n_chunks: int) -> "_Edges":
        size = self.send.shape[0] // n_chunks
        return _Edges(*(t[c * size:(c + 1) * size] for t in self))


def _edges(cfg: MACEConfig, batch: dict, n_chunks: int) -> _Edges:
    send = batch["senders"].long()
    recv = batch["receivers"].long()
    E = send.shape[0]
    assert E % n_chunks == 0, (E, n_chunks)
    size = E // n_chunks
    perm = (torch.argsort(recv.view(n_chunks, size), dim=1, stable=True)
            + torch.arange(n_chunks, device=recv.device)[:, None] * size
            ).reshape(-1)
    send, recv = send[perm], recv[perm]
    pos = batch["positions"].float()
    r = pos[recv] - pos[send]  # (E, 3)
    d = torch.sqrt((r * r).sum(-1))
    rhat = r / torch.clamp_min(d, 1e-9)[:, None]
    return _Edges(
        send=send, recv=recv,
        emask=batch["edge_mask"][perm].to(cfg.dtype),
        y1=rhat.to(cfg.dtype),
        y2=sym_traceless(rhat[:, :, None] * rhat[:, None, :]).to(cfg.dtype),
        rbf=bessel_basis(d, cfg.n_rbf, cfg.r_cut).to(cfg.dtype))


def _gather(h: Tensor, send: Tensor) -> Tensor:
    """h[send] for (N, C[, 3[, 3]]) features, through the deterministic
    row gather."""
    rows = L.gather_rows(h.reshape(h.shape[0], -1), send)
    return rows.view((send.shape[0],) + tuple(h.shape[1:]))


def _edge_pass(cfg: MACEConfig, layer: MACELayer, h0: Tensor, h1: Tensor,
               h2: Tensor, e: _Edges, n_nodes: int):
    """A-basis contribution of a run of edges (a chunk, or all of them)."""
    E, C = e.send.shape[0], h0.shape[1]
    # radial TP weights per edge: (E, n_paths, C)
    hid = _silu(_mm(e.rbf, layer.rad_w1))
    rw = _mm(hid, layer.rad_w2.reshape(hid.shape[1], -1)).view(
        E, N_A_PATHS, C)
    rw = rw * e.emask[:, None, None]
    s0, s1, s2 = _gather(h0, e.send), _gather(h1, e.send), _gather(h2,
                                                                   e.send)
    ones = torch.ones((E, 1), dtype=cfg.dtype, device=e.send.device)
    prods = product_paths((ones, e.y1[:, None, :], e.y2[:, None, :, :]),
                          (s0, s1, s2))
    # weight each path per channel, then sum to receivers
    a0 = _sum(rw[:, i] * p for i, p in enumerate(prods[0]))
    a1 = _sum(rw[:, 3 + i][..., None] * p for i, p in enumerate(prods[1]))
    a2 = _sum(rw[:, 8 + i][..., None, None] * p
              for i, p in enumerate(prods[2]))
    return tuple(L.segment_sum(a, e.recv, n_nodes, ids_sorted=True)
                 for a in (a0, a1, a2))


def _basis(layer, A0: Tensor, A1: Tensor, A2: Tensor,
           ls: Tuple[int, ...] = (0, 1, 2)) -> Dict[int, list]:
    """The symmetric contractions (nu = 2 and 3, the B-basis): per output
    l of ``ls``, the channel mix's inputs [A_l | B2-paths_l | B3_l]."""
    w2, w3 = layer.w_corr2, layer.w_corr3
    B2 = product_paths((A0, A1, A2), (A0 * w2, A1 * w2[:, None],
                                      A2 * w2[:, None, None]))
    B2s = [_sum(B2[l]) for l in range(3)]
    B3 = product_paths(B2s, (A0 * w3, A1 * w3[:, None],
                             A2 * w3[:, None, None]), ls)
    A = (A0, A1, A2)
    return {l: [A[l], *B2[l], _sum(B3[l])] for l in ls}


def _messages(layer: MACELayer, A0: Tensor, A1: Tensor, A2: Tensor):
    """The messages: the channel mix of [A | B2-paths | B3] per output
    l."""
    paths = _basis(layer, A0, A1, A2)
    return tuple(_channel_mix(paths[l], getattr(layer, f"msg{l}"))
                 for l in range(3))


def _one_layer(cfg: MACEConfig, layer: MACELayer, h0: Tensor, h1: Tensor,
               h2: Tensor, edges: _Edges, nmask: Tensor):
    n_nodes, nc = h0.shape[0], cfg.edge_chunks
    if nc <= 1:
        A0, A1, A2 = _edge_pass(cfg, layer, h0, h1, h2, edges, n_nodes)
    else:
        # chunk after chunk into f32 accumulators ("gradient accumulation
        # for edges"), cast once
        acc = (torch.zeros(h0.shape, device=h0.device),
               torch.zeros(h1.shape, device=h0.device),
               torch.zeros(h2.shape, device=h0.device))
        for c in range(nc):
            args = (cfg, layer, h0, h1, h2, edges.chunk(c, nc), n_nodes)
            part = (ckpt_lib.checkpoint(_edge_pass, *args,
                                        use_reentrant=False)
                    if cfg.remat else _edge_pass(*args))
            acc = tuple(a + p for a, p in zip(acc, part))
        A0, A1, A2 = (a.to(cfg.dtype) for a in acc)
    m0, m1, m2 = _messages(layer, A0, A1, A2)
    # update with self-connection (residual), cast back to h's dtype
    dt = h0.dtype
    h0n = (_contract(h0, layer.self0) + m0).to(dt)
    h1n = (_contract(h1, layer.self1) + m1).to(dt)
    h2n = (_contract(h2, layer.self2) + m2).to(dt)
    h0n = h0n * nmask[:, None]
    h1n = h1n * nmask[:, None, None]
    h2n = h2n * nmask[:, None, None, None]
    # invariant readout
    e = _mm(_silu(_mm(h0n, layer.ro_w1)), layer.ro_w2)  # (N, 1)
    return h0n, h1n, h2n, e[:, 0].float()


def _embed(cfg: MACEConfig, model: MACE, batch: dict):
    """(h0, h1, h2, node mask) before the first layer."""
    nmask = batch["node_mask"].to(cfg.dtype)
    h0 = _mm(batch["node_feat"].to(cfg.dtype), model.embed) * nmask[:, None]
    n, C = h0.shape
    h1 = torch.zeros((n, C, 3), dtype=cfg.dtype, device=h0.device)
    h2 = torch.zeros((n, C, 3, 3), dtype=cfg.dtype, device=h0.device)
    return h0, h1, h2, nmask


def forward(cfg: MACEConfig, model: MACE, batch: dict) -> Tensor:
    """Per-graph energies (n_graphs,) f32, or per-node ones (N,) when
    ``batch["node_level"]``.

    batch: positions (N, 3) f32; node_feat (N, d_feat); senders/receivers
    (E,) int; edge_mask (E,) (0 for padding); node_graph (N,) int graph id;
    node_mask (N,); n_graphs an int; node_level a bool (default False).
    """
    edges = _edges(cfg, batch, max(cfg.edge_chunks, 1))
    h0, h1, h2, nmask = _embed(cfg, model, batch)
    energy = torch.zeros((h0.shape[0],), device=h0.device)
    for layer in model.layers:
        args = (cfg, layer, h0, h1, h2, edges, nmask)
        h0, h1, h2, e = (ckpt_lib.checkpoint(_one_layer, *args,
                                             use_reentrant=False)
                         if cfg.remat else _one_layer(*args))
        energy = energy + e * nmask.float()
    if batch.get("node_level", False):
        return energy  # (N,) per-node predictions
    return L.segment_sum(energy, batch["node_graph"], int(batch["n_graphs"]))


def loss_fn(cfg: MACEConfig, model: MACE, batch: dict
            ) -> Tuple[Tensor, dict]:
    """Regression MSE: graph-level against target_energy (n_graphs,)
    masked by graph_mask, or node-level against target_nodes (N,) masked
    by loss_node_mask (else node_mask)."""
    return _mse(forward(cfg, model, batch), batch)


def _mse(pred: Tensor, batch: dict) -> Tuple[Tensor, dict]:
    """``loss_fn``'s loss of the predictions ``pred``, on their device."""
    def on(x):
        return _on(x, pred.device).float()

    if batch.get("node_level", False):
        target = on(batch["target_nodes"])
        mask = on(batch.get("loss_node_mask", batch["node_mask"]))
    else:
        target = on(batch["target_energy"])
        mask = batch.get("graph_mask")
        mask = torch.ones_like(pred) if mask is None else on(mask)
    se = (pred - target) ** 2 * mask
    loss = se.sum() / torch.clamp_min(mask.sum(), 1.0)
    return loss, {"loss": loss}


def _on(x, device) -> Tensor:
    """A batch entry (a tensor, or a ``ShardedTensor``) whole on
    ``device``. Across processes each process holds the whole batch (it
    draws it itself), and another process's position (``meta``) takes a
    placeholder of it."""
    if isinstance(x, ShardedTensor):
        if x.mesh.process_count > 1:
            raise ValueError("a MACE step across processes takes whole "
                             "batches (every process draws its own)")
        return x.gather(device)
    return x.to(device)


def node_descriptors(cfg: MACEConfig, model: MACE, batch: dict) -> Tensor:
    """Invariant per-node descriptors (N, C) f32: the Euclidean metric
    space the nSimplex reduction consumes for similarity search over
    atomic environments."""
    return _final_h0(cfg, model, batch)


def _final_h0(cfg: MACEConfig, model: MACE, batch: dict) -> Tensor:
    """The last layer's scalars, as the reference's ``_final_h0`` forms
    them: all edges at once, and the update is not cast back, so under
    bf16 the features turn f32 after the first layer."""
    edges = _edges(cfg, batch, 1)
    h0, h1, h2, nmask = _embed(cfg, model, batch)
    for layer in model.layers:
        A0, A1, A2 = _edge_pass(cfg, layer, h0, h1, h2, edges, h0.shape[0])
        m0, m1, m2 = _messages(layer, A0, A1, A2)
        h0 = (_contract(h0, layer.self0) + m0) * nmask[:, None]
        h1 = (_contract(h1, layer.self1) + m1) * nmask[:, None, None]
        h2 = (_contract(h2, layer.self2) + m2) * nmask[:, None, None, None]
    return h0.float()


# -- the sharded half: MACE on a (data, model) mesh ------------------------------
#
# The reference's ``edge_axes`` / ``channel_axes`` (the GNN train plan: edges
# over the data axes, channels over ``model``), single-controller
# (``distributed.partition``):
#
# * each leaf lies by ``sharding.gnn_param_specs``: ``embed``'s and
#   ``rad_w2``'s channels, the ``w_corr*`` and the input channels of
#   ``msg*``, ``self*`` and ``ro_w1`` over ``model``; ``rad_w1`` and ``ro_w2``
#   on every position;
# * node-major features (N, C / M[, 3[, 3]]) hold a model shard's channels on
#   every data replica. Every equivariant product is channel-wise, so the
#   edge pass and the B-basis are local to a shard;
# * the edges split over ``data``: chunk c (the global edge range c, as on
#   one device) in D equal runs, run d data replica d's. A replica sums its
#   runs edge -> node with ``layers.segment_sum`` (chunk after chunk into f32
#   with ``edge_chunks > 1``), and the replicas' partials meet in one
#   fixed-order f32 sum (``all_sum``), cast once;
# * a channel mix and its self-connection contract a shard's input channels
#   into all C output channels: an f32 partial of (h @ self + m), summed
#   block by block on each block's owner (``sum_scatter``) and cast once to
#   h's dtype, the reference's ``(h @ self + m).astype(dt)``;
# * the readout's ``ro_w1`` partials meet on data replica 0's first model
#   shard (``sum_to``), which alone finishes the readout and the loss. The
#   last layer's l = 1, 2 updates reach no energy and are not computed
#   (their leaves' gradients are zeros, as on one device);
# * with ``edge_chunks > 1`` the node side runs in as many blocks of nodes
#   (every node's work is its own), and under remat each layer, each edge
#   chunk and each node block is recomputed by ``layers.RematGroup``;
# * no gradient is summed in an order the autograd engine's card threads
#   set: each collective and each group takes and gives one tensor a
#   device (``_joined``); the edge chunks' groups, and the node blocks',
#   form a chain (``_token``), so in backward they run one at a time, the
#   last first, and what they read gets its gradients in that order (the
#   leaves every node block reads also through ``layers.fan_out``).


def check_mesh(cfg: MACEConfig, mesh) -> None:
    """Raise unless ``cfg``'s channels split over the mesh's model axis."""
    M = mesh.shape["model"]
    if cfg.channels % M:
        raise ValueError(f"{cfg.name} does not split over the mesh "
                         f"{dict(mesh.shape)}: channels % M: {cfg.channels} "
                         f"channels on {M} model shards")


class ShardedMACE:
    """A MACE model's leaves (``params``: name -> ``ShardedTensor``) on a
    (data, model) mesh."""

    def __init__(self, cfg: MACEConfig, mesh, params: dict):
        check_mesh(cfg, mesh)
        self.cfg, self.mesh, self.params = cfg, mesh, dict(params)


def param_specs(cfg: MACEConfig) -> dict:
    """The reference's rules' spec of every leaf, by name."""
    return gnn_param_specs(MACE(cfg, device="meta"))


@torch.no_grad()
def init_sharded(cfg: MACEConfig, mesh, *,
                 generator: torch.Generator) -> ShardedMACE:
    """``init_params``' weights, bit for bit (the same draws on the
    generator's device, leaf by leaf), each placed on ``mesh`` by its
    spec."""
    check_mesh(cfg, mesh)
    specs = param_specs(cfg)
    params = {name: place(value, specs[name], mesh)
              for name, value in _draws(cfg, generator)}
    for st in params.values():
        for s in st.shards:
            s.requires_grad_(True)
    return ShardedMACE(cfg, mesh, params)


def _layer_leaves(model: ShardedMACE, i: int, pos: int,
                  names) -> SimpleNamespace:
    """Layer i's leaves ``names`` of mesh position ``pos``."""
    return SimpleNamespace(**{n: model.params[f"layers.{i}.{n}"].shards[pos]
                              for n in names})


def _replica_edges(cfg: MACEConfig, edges: dict, positions: Tensor,
                   D: int, d: int) -> _Edges:
    """Data replica d's edges on ``positions``' device: run d of the D
    equal runs of each edge chunk, each chunk's run stably sorted by
    receiver (``edges``: the whole senders, receivers and edge_mask)."""
    nc = max(cfg.edge_chunks, 1)
    E = edges["senders"].shape[0]
    if E % (nc * D):
        raise ValueError(f"{E} edges do not split into {nc} chunks of {D} "
                         "data shards' equal runs (configs.base.pad_edges "
                         "pads them)")
    run = {k: v.view(nc, D, -1)[:, d].reshape(-1).to(positions.device)
           for k, v in edges.items()}
    return _edges(cfg, dict(run, positions=positions), nc)


def _group(cfg: MACEConfig, fn, inputs: list, remat: bool) -> list:
    """``fn(*inputs)``, recomputed in backward (``layers.RematGroup``)
    when ``remat`` and the config's remat are on."""
    if remat and cfg.remat:
        return list(L.RematGroup.apply(fn, *inputs))
    return list(fn(*inputs))


def _token(device) -> Tensor:
    """The head of a chain of groups: each group takes the token and
    gives it on (``_passed``), so in backward the groups run one at a
    time, the last first. Unchained, groups that are ready together are
    not: a card's autograd thread that waits, inside one group's
    recompute (a reentrant backward), for another card's work runs the
    next ready group within it, so the recomputes pile up and gradients
    sum in an order the threads set."""
    return torch.zeros((), device=device, requires_grad=True)


def _passed(token: Tensor) -> Tensor:
    return token * 1


def _sharded_edge_side(cfg: MACEConfig, lays: list, hs: list, edges: list,
                       n_nodes: int) -> list:
    """Every position's A-basis (A0, A1, A2) over its data replica's edges:
    ``_edge_pass`` of each chunk in chunk order, into f32 accumulators
    when ``edge_chunks > 1`` (the three joined: one tensor a position)."""
    nc = max(cfg.edge_chunks, 1)
    n = len(lays)
    if nc <= 1:
        return [_edge_pass(cfg, lays[p], *hs[p], edges[p], n_nodes)
                for p in range(n)]
    acc = [_joined({l: torch.zeros(h.shape, device=h.device)
                    for l, h in enumerate(hs[p])}) for p in range(n)]
    token = _token(acc[0].device)
    for c in range(nc):
        chunks = [e.chunk(c, nc) for e in edges]

        def run(*t, chunks=chunks):
            return (*[_joined(dict(enumerate(_edge_pass(
                cfg, SimpleNamespace(rad_w1=t[5 * p + 3],
                                     rad_w2=t[5 * p + 4]),
                *t[5 * p:5 * p + 3], chunks[p], n_nodes))))
                for p in range(n)], _passed(t[-1]))

        *parts, token = _group(cfg, run, [x for p in range(n) for x in (
            *hs[p], lays[p].rad_w1, lays[p].rad_w2)] + [token], remat=True)
        acc = [a + b for a, b in zip(acc, parts)]
    f32 = {l: torch.float32 for l in range(3)}
    return [tuple(_parted(a, f32).values()) for a in acc]


_IRREP_SHAPES = {0: (), 1: (3,), 2: (3, 3)}


def _joined(ts: dict, dtype: torch.dtype = torch.float32) -> Tensor:
    """Irreps {l: (N, C[, 3[, 3]])} as one (N, C, 1 [+ 3] [+ 9]) tensor of
    ``dtype``, in l order: a collective's or a group's one output a
    device, so each device takes one gradient for it in backward."""
    return torch.cat([ts[l].to(dtype).reshape(*ts[l].shape[:2], -1)
                      for l in sorted(ts)], -1)


def _parted(t: Tensor, dtypes: dict) -> dict:
    """``_joined``'s inverse: {l: (N, C[, 3[, 3]])}, each cast once to
    ``dtypes[l]``."""
    ls = sorted(dtypes)
    widths = [math.prod(_IRREP_SHAPES[l]) for l in ls]
    return {l: x.reshape(*t.shape[:2], *_IRREP_SHAPES[l]).to(dtypes[l])
            for l, x in zip(ls, t.split(widths, -1))}


def _data_sum(cfg: MACEConfig, A: list, rows: list) -> list:
    """Each position's A summed over the data replicas of its model
    column (one f32 sum of the three, in replica order) and cast once: to
    cfg.dtype after f32 chunk accumulators, else to the messages'
    dtype."""
    dtypes = [{l: cfg.dtype if cfg.edge_chunks > 1 else a.dtype
               for l, a in enumerate(A[p])} for p in range(len(A))]
    if len(rows) == 1:
        return [tuple(a.to(dtypes[p][l]) for l, a in enumerate(A[p]))
                for p in range(len(A))]
    out = [None] * len(A)
    for m in range(len(rows[0])):
        col = [row[m] for row in rows]
        total = all_sum([_joined(dict(enumerate(A[p]))) for p in col])
        for p, t in zip(col, total):
            out[p] = tuple(_parted(t, dtypes[p]).values())
    return out


def _contract_f32(p: Tensor, w: Tensor) -> Tensor:
    """einsum("nc...,cd->nd...", p, w) with an f32 result."""
    return L.matmul_f32(p.movedim(1, -1), w).movedim(-1, 1)


def _sharded_node_side(lays: dict, A: dict, hs: dict, nmasks: dict,
                       rows: list, ls: Tuple[int, ...]):
    """The node side of one block of nodes on the positions of ``rows``:
    the B-basis, each l of ``ls``'s update summed over the model shards
    (``sum_scatter``), and the readout on ``rows[0]``. Returns the
    updated {l: h_l} of each position and the block's per-node energies
    on ``rows[0][0]``'s device."""
    new = {}
    for row in rows:
        parts = []
        for p in row:
            paths = _basis(lays[p], *A[p], ls)
            partial = {}
            for l in ls:
                w = getattr(lays[p], f"msg{l}")
                m = _sum(_contract_f32(x, w[i])
                         for i, x in enumerate(paths[l]))
                partial[l] = _contract_f32(hs[p][l], getattr(
                    lays[p], f"self{l}")) + m
            del paths
            parts.append(_joined(partial))
            del partial
        # one f32 sum of every l's partial, block by block on its owner
        outs = sum_scatter(parts, 1, torch.float32)
        del parts
        for p, o in zip(row, outs):
            out = _parted(o, {l: hs[p][l].dtype for l in ls})
            new[p] = {l: x * nmasks[p].view((-1,) + (1,) * (x.dim() - 1))
                      for l, x in out.items()}
    first = rows[0][0]
    h0 = new[first][0]
    r = sum_to([L.matmul_f32(new[p][0], lays[p].ro_w1) for p in rows[0]],
               h0.device)
    r = r.to(torch.promote_types(h0.dtype, lays[first].ro_w1.dtype))
    e = _mm(_silu(r), lays[first].ro_w2)[:, 0].float()
    return new, e


def _sharded_layer(cfg: MACEConfig, lays: list, hs: list, edges: list,
                   nmasks: list, rows: list, last: bool):
    """One interaction layer on every position: the edge side on all, the
    node side on every data replica (on replica 0 alone in the last
    layer, whose l = 1, 2 updates are not computed). Returns each
    position's updated (h0, h1, h2) joined (``_joined`` in h's dtype;
    None in the last layer) and the layer's per-node energies on the
    first device."""
    N = hs[0][0].shape[0]
    A = _data_sum(cfg, _sharded_edge_side(cfg, lays, hs, edges, N), rows)
    active = rows[:1] if last else rows
    ls = (0,) if last else (0, 1, 2)
    pos = [p for row in active for p in row]
    # node blocks: with edge_chunks > 1, as many as edge chunks, each
    # reading the leaves through a fan-out
    nb = min(max(cfg.edge_chunks, 1), N)
    split = {p: [torch.tensor_split(t, nb) for t in (*A[p], *hs[p],
                                                     nmasks[p])]
             for p in pos}
    names = ["w_corr2", "w_corr3", *(f"msg{l}" for l in ls),
             *(f"self{l}" for l in ls), "ro_w1", "ro_w2"]
    fans = {p: [L.fan_out(getattr(lays[p], k), nb) for k in names]
            for p in pos}
    blocks, energies = {p: [] for p in pos}, []
    token = _token(hs[pos[0]][0].device)
    for b in range(nb):
        def run(*t, b=b):
            it = iter(t)
            A_, h_, lay_ = {}, {}, {}
            for p in pos:
                A_[p] = tuple(next(it) for _ in range(3))
                h_[p] = tuple(next(it) for _ in range(3))
                lay_[p] = SimpleNamespace(**{n: next(it) for n in names})
            new, e = _sharded_node_side(
                lay_, A_, h_, {p: split[p][6][b] for p in pos}, active, ls)
            joined = [] if last else [_joined(new[p], h_[p][0].dtype)
                                      for p in pos]
            return (*joined, e, _passed(t[-1]))

        *out, e_b, token = _group(cfg, run, [x for p in pos for x in (
            *(split[p][i][b] for i in range(6)),
            *(f[b] for f in fans[p]))] + [token], remat=nb > 1)
        energies.append(e_b)
        for p, o in zip(pos, out):
            blocks[p].append(o)
    e = torch.cat(energies) if nb > 1 else energies[0]
    if last:
        return None, e
    return [torch.cat(blocks[p]) if nb > 1 else blocks[p][0]
            for p in range(len(hs))], e


_LEAVES = tuple(_layer_shapes(MACEConfig()))


def _sharded_energies(cfg: MACEConfig, model: ShardedMACE,
                      batch: dict) -> Tensor:
    """Per-node energies (N,) f32, the sum of every layer's readout, on
    the mesh's first device."""
    mesh = model.mesh
    rows = axis_groups(mesh, "model")
    devs = list(mesh.devices.flat)
    n = mesh.size
    edge_in = {k: (batch[k].gather() if isinstance(batch[k], ShardedTensor)
                   else batch[k]) for k in ("senders", "receivers",
                                             "edge_mask")}
    nodes, replica_edges = {}, {}
    edges, nmasks, hs = [None] * n, [None] * n, [None] * n
    for d, row in enumerate(rows):
        for p in row:
            dev = devs[p]
            if dev not in nodes:
                nodes[dev] = {k: _on(batch[k], dev) for k in (
                    "positions", "node_feat", "node_mask")}
            if (d, dev) not in replica_edges:
                replica_edges[d, dev] = _replica_edges(
                    cfg, edge_in, nodes[dev]["positions"], len(rows), d)
            edges[p] = replica_edges[d, dev]
            *hs[p], nmasks[p] = _embed(cfg, SimpleNamespace(
                embed=model.params["embed"].shards[p]), nodes[dev])
    first = rows[0][0]
    energy = torch.zeros((hs[first][0].shape[0],), device=devs[first])
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        names = [k for k in _LEAVES if not (last and k[-1] in "12"
                                            and k[:-1] in ("msg", "self"))]
        lays = [_layer_leaves(model, i, p, names) for p in range(n)]

        def run(*t, last=last, names=names):
            it = iter(t)
            h_, lay_ = [], []
            for _ in range(n):
                h_.append(tuple(next(it) for _ in range(3)))
                lay_.append(SimpleNamespace(**{k: next(it) for k in names}))
            new, e = _sharded_layer(cfg, lay_, h_, edges, nmasks, rows, last)
            return (e,) if last else (*new, e)

        out = _group(cfg, run, [x for p in range(n) for x in (
            *hs[p], *(getattr(lays[p], k) for k in names))], remat=True)
        if not last:
            hs = [tuple(x.contiguous() for x in _parted(
                out[p], {l: h.dtype for l, h in enumerate(hs[p])}).values())
                for p in range(n)]
        energy = energy + out[-1] * nmasks[first].float()
    return energy


def sharded_forward(cfg: MACEConfig, model: ShardedMACE,
                    batch: dict) -> Tensor:
    """``forward``'s energies on the mesh, on its first device. batch:
    ``forward``'s, each array whole or laid out by
    ``sharding.gnn_input_shardings`` (``partition.place``)."""
    energy = _sharded_energies(cfg, model, batch)
    if batch.get("node_level", False):
        return energy
    return L.segment_sum(energy, _on(batch["node_graph"], energy.device),
                         int(batch["n_graphs"]))


def sharded_loss_fn(cfg: MACEConfig, model: ShardedMACE, batch: dict
                    ) -> Tuple[Tensor, dict]:
    """``loss_fn`` on the mesh, on its first device."""
    return _mse(sharded_forward(cfg, model, batch), batch)
