"""RecSys / ranking models: AutoInt, Wide&Deep, DLRM (RM2), xDeepFM, and the
two-tower retrieval model (PyTorch counterpart of ``repro.models.recsys``).

Shared substrate:
* **one concatenated embedding table** of every field's vocabulary, with
  static per-field row offsets; a lookup is one gather (``gather_rows``),
  multi-hot bags sum over L. The gather is ``layers.gather_rows``
  (re-exported here), whose backward is a dense (rows, d) gradient, as the
  reference differentiates ``jnp.take``, summing each row's duplicates in
  the order the ids occur: the same bits every time, where
  ``F.embedding``'s CUDA backward differs run to run in the last bits of
  rows a batch hits many times;
* a feature-interaction op per model (self-attention / concat / dot / CIN),
  every contraction in f32 (TF32 is off package-wide);
* a small dense MLP head with the sigmoid-BCE loss;
* a retrieval head (``retrieval_topk``) and the two-tower model whose item
  tower is the corpus handed to ``launch.serve.build_index``.

The models are ``nn.Module``s whose ``state_dict`` keys mirror the JAX
pytree paths (``table``, ``bot.0.w``, ``attn.1.wq``, ...); the forwards,
losses and heads are plain functions of (config, module, batch) as in the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from .layers import dense_init, gather_rows

Tensor = torch.Tensor

# Criteo Kaggle categorical cardinalities (public, arXiv:1906.00091 scale)
CRITEO_26 = [
    1460, 583, 10_131_227, 2_202_608, 305, 24, 12_517, 633, 3, 93_145, 5_683,
    8_351_593, 3_194, 27, 14_992, 5_461_306, 10, 5_652, 2_173, 4, 7_046_547,
    18, 15, 286_181, 105, 142_572,
]


def criteo_vocab(n_fields: int) -> list[int]:
    """n_fields vocab sizes: the 26 Criteo categorical tables, extended with
    128-bucket quantised dense features (the 39-field convention of the
    AutoInt / xDeepFM papers), then hashed cross-features of 10^4."""
    sizes = list(CRITEO_26)
    sizes += [128] * 13  # bucketised dense features -> 39
    while len(sizes) < n_fields:
        sizes.append(10_000)
    return sizes[:n_fields]


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    model: str                      # autoint | wide_deep | dlrm | xdeepfm
    n_sparse: int
    embed_dim: int
    vocab_sizes: Tuple[int, ...]
    n_dense: int = 0
    # dlrm
    bot_mlp: Tuple[int, ...] = ()
    top_mlp: Tuple[int, ...] = ()
    # autoint
    n_attn_layers: int = 0
    n_heads: int = 0
    d_attn: int = 0
    # wide&deep / xdeepfm MLPs
    mlp: Tuple[int, ...] = ()
    cin_layers: Tuple[int, ...] = ()
    dtype: torch.dtype = torch.float32
    table_dtype: torch.dtype = torch.float32
    # retrieval_cand scoring: "dense" dot products over (N_cand, embed_dim)
    # or "zen" over an nSimplex-reduced (N_cand, zen_k) index
    retrieval_mode: str = "dense"
    zen_k: int = 16

    @property
    def total_rows(self) -> int:
        return int(sum(self.vocab_sizes))

    @property
    def padded_rows(self) -> int:
        """Table rows padded to a multiple of 512 (the reference's row
        sharding needs it); offsets never address the padding rows."""
        return (self.total_rows + 511) // 512 * 512

    @property
    def offsets(self) -> Tuple[int, ...]:
        out, acc = [], 0
        for v in self.vocab_sizes:
            out.append(acc)
            acc += v
        return tuple(out)


# -- modules ---------------------------------------------------------------------


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(tuple(shape), dtype=dtype, device=device))


class Dense(nn.Module):
    """One MLP layer, ``x @ w + b``."""

    def __init__(self, d_in: int, d_out: int, dtype, device):
        super().__init__()
        self.w = _param((d_in, d_out), dtype, device)
        self.b = _param((d_out,), dtype, device)


class AttnLayer(nn.Module):
    """One AutoInt self-attention layer (query, key, value, residual)."""

    def __init__(self, d_in: int, d_out: int, dtype, device):
        super().__init__()
        for name in ("wq", "wk", "wv", "wres"):
            setattr(self, name, _param((d_in, d_out), dtype, device))


class CinLayer(nn.Module):
    """One CIN layer of xDeepFM: the (H_prev * F, H) compression."""

    def __init__(self, d_in: int, d_out: int, dtype, device):
        super().__init__()
        self.w = _param((d_in, d_out), dtype, device)


def _mlp(dims: Sequence[int], dtype, device) -> nn.ModuleList:
    return nn.ModuleList(Dense(dims[i], dims[i + 1], dtype, device)
                         for i in range(len(dims) - 1))


def _mlp_apply(layers: nn.ModuleList, x: Tensor, *,
               final_act: bool = False) -> Tensor:
    for i, l in enumerate(layers):
        x = x @ l.w + l.b
        if i + 1 < len(layers) or final_act:
            x = torch.relu(x)
    return x


class RecsysModel(nn.Module):
    """The parameters of one ranking model; uninitialised until
    ``init_params`` draws them or a caller loads them."""

    def __init__(self, cfg: RecsysConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        F_, d, dt = cfg.n_sparse, cfg.embed_dim, cfg.dtype
        self.table = _param((cfg.padded_rows, d), cfg.table_dtype, device)
        if cfg.model == "dlrm":
            self.bot = _mlp((cfg.n_dense,) + cfg.bot_mlp, dt, device)
            n_f = F_ + 1  # embeddings + bottom-MLP output
            n_int = n_f * (n_f - 1) // 2
            self.top = _mlp((n_int + cfg.bot_mlp[-1],) + cfg.top_mlp, dt,
                            device)
        elif cfg.model == "autoint":
            width = cfg.n_heads * cfg.d_attn
            self.attn = nn.ModuleList(
                AttnLayer(d if i == 0 else width, width, dt, device)
                for i in range(cfg.n_attn_layers))
            d_in = width if cfg.n_attn_layers else d
            self.out = _mlp((F_ * d_in, 1), dt, device)
        elif cfg.model == "wide_deep":
            self.wide = _param((cfg.padded_rows, 1), cfg.table_dtype, device)
            self.deep = _mlp((F_ * d,) + cfg.mlp + (1,), dt, device)
        elif cfg.model == "xdeepfm":
            h_prev, cins = F_, []
            for h in cfg.cin_layers:
                cins.append(CinLayer(h_prev * F_, h, dt, device))
                h_prev = h
            self.cin = nn.ModuleList(cins)
            self.cin_out = _mlp((int(sum(cfg.cin_layers)), 1), dt, device)
            self.dnn = _mlp((F_ * d,) + cfg.mlp + (1,), dt, device)
            self.linear = _param((cfg.padded_rows, 1), cfg.table_dtype,
                                 device)
        else:
            raise ValueError(cfg.model)

    def forward(self, batch: dict) -> Tensor:
        return forward(self.cfg, self, batch)


class TwoTowerModel(nn.Module):
    """User tower = the embedding-bag table read by ``user_repr``; item
    tower = a dedicated (n_items, embed_dim) table whose rows are the
    retrieval corpus handed to ``build_index``."""

    def __init__(self, cfg: RecsysConfig, n_items: int, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.table = _param((cfg.padded_rows, cfg.embed_dim), torch.float32,
                            device)
        self.items = _param((n_items, cfg.embed_dim), torch.float32, device)


@torch.no_grad()
def _fill(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter in place: tables normal x scale, MLP, attention
    and CIN weights ``dense_init``, biases zero."""
    d = model.cfg.embed_dim
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name in ("table", "items"):
            p.normal_(generator=generator).mul_(d**-0.5)
        elif name in ("wide", "linear"):
            p.normal_(generator=generator).mul_(0.01)
        elif leaf == "b":
            p.zero_()
        else:
            p.copy_(dense_init(p.shape, generator=generator))


def init_params(cfg: RecsysConfig, *,
                generator: torch.Generator) -> RecsysModel:
    """A ranking model with random weights, on the generator's device."""
    model = RecsysModel(cfg, device=generator.device)
    _fill(model, generator)
    return model


def init_two_tower_params(cfg: RecsysConfig, n_items: int, *,
                          generator: torch.Generator) -> TwoTowerModel:
    """A two-tower model with random towers, on the generator's device."""
    model = TwoTowerModel(cfg, n_items, device=generator.device)
    _fill(model, generator)
    return model


# -- embedding bag -----------------------------------------------------------------


def embedding_bag(
    table: Tensor,
    indices: Tensor,          # (B, F) one-hot-per-field or (B, F, L) multi-hot
    offsets: Tuple[int, ...],
    *,
    weights: Optional[Tensor] = None,
) -> Tensor:
    """Gather per-field embeddings; multi-hot bags sum (optionally weighted)
    over L. Returns (B, F, d) f32."""
    off = torch.as_tensor(offsets, dtype=torch.int64, device=indices.device)
    if indices.dim() == 2:
        emb = gather_rows(table, indices.long() + off[None, :])
    else:
        emb = gather_rows(table, indices.long() + off[None, :, None])
        if weights is not None:
            emb = emb * weights[..., None]
        emb = torch.sum(emb, dim=2)
    return emb.float()


# -- model forwards ----------------------------------------------------------------


def forward(cfg: RecsysConfig, params: RecsysModel, batch: dict) -> Tensor:
    """Logits (B,). batch: sparse (B, F[, L]) int [+ dense (B, n_dense)]."""
    emb = embedding_bag(params.table, batch["sparse"], cfg.offsets)
    B = emb.shape[0]

    if cfg.model == "dlrm":
        bot = _mlp_apply(params.bot, batch["dense"].float(), final_act=True)
        z = torch.cat([bot[:, None, :], emb], dim=1)         # (B, F+1, d)
        inter = torch.bmm(z, z.transpose(1, 2))             # bfd,bgd->bfg
        n = z.shape[1]
        iu = torch.triu_indices(n, n, offset=1, device=z.device)
        flat = inter[:, iu[0], iu[1]]                       # (B, n_int)
        x = torch.cat([bot, flat], dim=-1)
        return _mlp_apply(params.top, x)[:, 0]

    if cfg.model == "autoint":
        x = emb  # (B, F, d)
        H, da = cfg.n_heads, cfg.d_attn
        for l in params.attn:
            q = (x @ l.wq).reshape(B, -1, H, da)
            k = (x @ l.wk).reshape(B, -1, H, da)
            v = (x @ l.wv).reshape(B, -1, H, da)
            scores = torch.einsum("bfhd,bghd->bhfg", q, k)
            probs = torch.softmax(scores, dim=-1)
            o = torch.einsum("bhfg,bghd->bfhd", probs, v)
            o = o.reshape(B, x.shape[1], H * da)
            x = torch.relu(o + x @ l.wres)
        return _mlp_apply(params.out, x.reshape(B, -1))[:, 0]

    if cfg.model == "wide_deep":
        deep = _mlp_apply(params.deep, emb.reshape(B, -1))[:, 0]
        wide = embedding_bag(params.wide, batch["sparse"], cfg.offsets)
        return deep + torch.sum(wide, dim=(1, 2))

    if cfg.model == "xdeepfm":
        x0 = emb  # (B, F, d)
        xk = x0
        pooled = []
        for l in params.cin:
            z = xk[:, :, None, :] * x0[:, None, :, :]       # (B, Hk, F, d)
            z = z.reshape(B, -1, z.shape[-1])               # (B, Hk*F, d)
            xk = torch.einsum("bpd,ph->bhd", z, l.w)
            pooled.append(torch.sum(xk, dim=-1))            # (B, Hk+1)
        cin_logit = _mlp_apply(params.cin_out, torch.cat(pooled, dim=-1))[:, 0]
        dnn_logit = _mlp_apply(params.dnn, emb.reshape(B, -1))[:, 0]
        lin = embedding_bag(params.linear, batch["sparse"], cfg.offsets)
        return cin_logit + dnn_logit + torch.sum(lin, dim=(1, 2))

    raise ValueError(cfg.model)


def loss_fn(cfg: RecsysConfig, params: RecsysModel, batch: dict
            ) -> Tuple[Tensor, dict]:
    """Sigmoid binary cross-entropy vs batch['labels'] (B,) in {0, 1}."""
    logits = forward(cfg, params, batch)
    y = batch["labels"].float()
    loss = torch.mean(torch.clamp_min(logits, 0.0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))
    return loss, {"loss": loss}


# -- retrieval head ------------------------------------------------------------------


def user_repr(cfg: RecsysConfig, params: nn.Module, batch: dict) -> Tensor:
    """Query-side representation (B, embed_dim): the mean of the field
    embeddings."""
    emb = embedding_bag(params.table, batch["sparse"], cfg.offsets)
    return torch.mean(emb, dim=1)


def retrieval_scores(query_repr: Tensor, candidates: Tensor) -> Tensor:
    """Dense dot-product scoring: (B, d) x (N_cand, d) -> (B, N_cand)."""
    return query_repr.float() @ candidates.float().T


def retrieval_topk(query_repr: Tensor, candidates: Tensor, k: int = 100
                   ) -> Tuple[Tensor, Tensor]:
    """The k largest scores per query, largest first, a tie going to the
    lower candidate index (``lax.top_k``'s order: a stable descending
    sort, not ``torch.topk``)."""
    scores = retrieval_scores(query_repr, candidates)
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k].to(torch.int32)


# -- two-tower retrieval training ------------------------------------------------------


def item_repr(params: TwoTowerModel, item_ids: Optional[Tensor] = None
              ) -> Tensor:
    """Item-tower embeddings: all rows, or a gathered (B, d) batch."""
    if item_ids is None:
        return params.items
    return gather_rows(params.items, item_ids)


def _l2(x: Tensor) -> Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1,
                                                        keepdim=True), 1e-6)


def two_tower_loss(cfg: RecsysConfig, params: TwoTowerModel, batch: dict, *,
                   temperature: float = 0.1) -> Tuple[Tensor, dict]:
    """In-batch sampled softmax over L2-normalised towers.

    batch: sparse (B, F) user features + items (B,) positive item ids. Row
    i's positive is logit (i, i); every other item in the batch is a
    negative.
    """
    u = _l2(user_repr(cfg, params, batch))          # (B, d)
    v = _l2(item_repr(params, batch["items"]))      # (B, d)
    logits = (u @ v.T) / temperature
    labels = torch.arange(u.shape[0], device=u.device)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.mean(torch.gather(logp, 1, labels[:, None]))
    acc = torch.mean((torch.argmax(logits, dim=-1) == labels).float())
    return loss, {"loss": loss, "in_batch_acc": acc}


def two_tower_towers(cfg: RecsysConfig, params: TwoTowerModel, batch: dict
                     ) -> Tuple[Tensor, Tensor]:
    """(users (B, d), all items (n_items, d)): the query set and retrieval
    corpus of the trained model, as raw (unnormalised) embeddings — on the
    unit sphere every point is equidistant from the origin and nearly so
    from any reference, which starves the nSimplex estimators."""
    return user_repr(cfg, params, batch), item_repr(params)
