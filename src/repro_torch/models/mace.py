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
constraints with no meaning on one device; the multi-card trainer is
ROADMAP A, item 3.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt_lib

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
                  v: Tuple[Tensor, Tensor, Tensor]) -> Dict[int, list]:
    """All CG-allowed channel-wise products of two irrep triples (l <= 2)."""
    u0, u1, u2 = u
    v0, v1, v2 = v
    to0 = [u0 * v0, dot11(u1, v1), ddot22(u2, v2)]
    to1 = [
        u0[..., None] * v1,
        v0[..., None] * u1,
        cross11(u1, v1),
        mat21(u2, v1),
        mat21(v2, u1),
    ]
    to2 = [
        u0[..., None, None] * v2,
        v0[..., None, None] * u2,
        outer11(u1, v1),
        mat22(u2, v2),
    ]
    return {0: to0, 1: to1, 2: to2}


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


@torch.no_grad()
def init_params(cfg: MACEConfig, *, generator: torch.Generator) -> MACE:
    """A model with random weights on the generator's device: every leaf
    truncated-normal fan-in (``layers.dense_init``), the correlation
    weights at scale 1."""
    model = MACE(cfg, device=generator.device)
    model.embed.copy_(L.dense_init(model.embed.shape, None, cfg.dtype,
                                   generator=generator))
    for layer in model.layers:
        for name, (shape, scale) in _layer_shapes(cfg).items():
            getattr(layer, name).copy_(L.dense_init(
                shape, scale, cfg.dtype, generator=generator))
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


def _messages(layer: MACELayer, A0: Tensor, A1: Tensor, A2: Tensor):
    """The symmetric contractions (nu = 2 and 3, the B-basis) and the
    messages: the channel mix of [A | B2-paths | B3] per output l."""
    w2, w3 = layer.w_corr2, layer.w_corr3
    B2 = product_paths((A0, A1, A2), (A0 * w2, A1 * w2[:, None],
                                      A2 * w2[:, None, None]))
    B2s = [_sum(B2[l]) for l in range(3)]
    B3 = product_paths(B2s, (A0 * w3, A1 * w3[:, None],
                             A2 * w3[:, None, None]))
    B3s = [_sum(B3[l]) for l in range(3)]
    return (_channel_mix([A0, *B2[0], B3s[0]], layer.msg0),
            _channel_mix([A1, *B2[1], B3s[1]], layer.msg1),
            _channel_mix([A2, *B2[2], B3s[2]], layer.msg2))


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
    pred = forward(cfg, model, batch)
    if batch.get("node_level", False):
        target = batch["target_nodes"].float()
        mask = batch.get("loss_node_mask", batch["node_mask"]).float()
    else:
        target = batch["target_energy"].float()
        mask = batch.get("graph_mask")
        mask = torch.ones_like(pred) if mask is None else mask.float()
    se = (pred - target) ** 2 * mask
    loss = se.sum() / torch.clamp_min(mask.sum(), 1.0)
    return loss, {"loss": loss}


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
