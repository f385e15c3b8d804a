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
from types import SimpleNamespace
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.distributed.partition import (
    ShardedTensor,
    all_gather,
    all_sum,
    axis_groups,
    block,
    place,
    sum_to,
)
from repro_torch.distributed.sharding import (
    P,
    mesh_data_axes,
    recsys_param_specs,
)
from repro_torch.kernels.scoring import merge_topk

from .layers import dense_init, gather_rows, gather_rows_sharded

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


def _draw(name: str, p: Tensor, generator: torch.Generator, d: int) -> None:
    """Draw leaf ``name`` in place: tables normal x scale, MLP, attention
    and CIN weights ``dense_init``, biases zero."""
    leaf = name.rsplit(".", 1)[-1]
    if name in ("table", "items"):
        p.normal_(generator=generator).mul_(d**-0.5)
    elif name in ("wide", "linear"):
        p.normal_(generator=generator).mul_(0.01)
    elif leaf == "b":
        p.zero_()
    else:
        p.copy_(dense_init(p.shape, generator=generator))


@torch.no_grad()
def _fill(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter in place, in ``named_parameters`` order."""
    for name, p in model.named_parameters():
        _draw(name, p, generator, model.cfg.embed_dim)


@torch.no_grad()
def _draws(cfg: RecsysConfig, generator: torch.Generator):
    """``init_params``' leaves, (name, tensor) one at a time: the same
    draws in the same order on the generator's device."""
    for name, p in RecsysModel(cfg, device="meta").named_parameters():
        t = torch.empty(p.shape, dtype=p.dtype, device=generator.device)
        _draw(name, t, generator, cfg.embed_dim)
        yield name, t


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


def _flat_ids(indices: Tensor, offsets: Tuple[int, ...]) -> Tensor:
    """Per-field ids as rows of the concatenated table."""
    off = torch.as_tensor(offsets, dtype=torch.int64, device=indices.device)
    if indices.dim() == 2:
        return indices.long() + off[None, :]
    return indices.long() + off[None, :, None]


def _bag(emb: Tensor, weights: Optional[Tensor]) -> Tensor:
    """Gathered (B, F, d) rows as they are, or (B, F, L, d) multi-hot bags
    summed (optionally weighted) over L; f32."""
    if emb.dim() == 4:
        if weights is not None:
            emb = emb * weights[..., None]
        emb = torch.sum(emb, dim=2)
    return emb.float()


def embedding_bag(
    table: Tensor,
    indices: Tensor,          # (B, F) one-hot-per-field or (B, F, L) multi-hot
    offsets: Tuple[int, ...],
    *,
    weights: Optional[Tensor] = None,
) -> Tensor:
    """Gather per-field embeddings; multi-hot bags sum (optionally weighted)
    over L. Returns (B, F, d) f32."""
    return _bag(gather_rows(table, _flat_ids(indices, offsets)), weights)


# -- model forwards ----------------------------------------------------------------


def _dlrm_logits(p, emb: Tensor, dense: Tensor) -> Tensor:
    """DLRM's bottom MLP, dot interaction and top MLP: logits (B,)."""
    bot = _mlp_apply(p.bot, dense.float(), final_act=True)
    z = torch.cat([bot[:, None, :], emb], dim=1)             # (B, F+1, d)
    inter = torch.bmm(z, z.transpose(1, 2))                 # bfd,bgd->bfg
    n = z.shape[1]
    iu = torch.triu_indices(n, n, offset=1, device=z.device)
    flat = inter[:, iu[0], iu[1]]                           # (B, n_int)
    x = torch.cat([bot, flat], dim=-1)
    return _mlp_apply(p.top, x)[:, 0]


def _autoint_logits(cfg: RecsysConfig, p, emb: Tensor) -> Tensor:
    """AutoInt's self-attention layers and output layer: logits (B,)."""
    x = emb  # (B, F, d)
    B = emb.shape[0]
    H, da = cfg.n_heads, cfg.d_attn
    for l in p.attn:
        q = (x @ l.wq).reshape(B, -1, H, da)
        k = (x @ l.wk).reshape(B, -1, H, da)
        v = (x @ l.wv).reshape(B, -1, H, da)
        scores = torch.einsum("bfhd,bghd->bhfg", q, k)
        probs = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhfg,bghd->bfhd", probs, v)
        o = o.reshape(B, x.shape[1], H * da)
        x = torch.relu(o + x @ l.wres)
    return _mlp_apply(p.out, x.reshape(B, -1))[:, 0]


def _cin_rows(xk: Tensor, x0: Tensor, w: Tensor, lo: int, hi: int
              ) -> Tensor:
    """Rows lo..hi of a CIN layer's z = xk_h * x0_f (row p = h * F + f, z
    (B, Hk * F, d)) contracted with the same rows of ``w``: the layer's
    (B, H, d) f32 output, or its partial over those rows."""
    B, F_, d = x0.shape
    h0, h1 = lo // F_, -(-hi // F_)
    z = (xk[:, h0:h1, None, :] * x0[:, None, :, :]).reshape(B, -1, d)
    return torch.einsum("bpd,ph->bhd", z[:, lo - h0 * F_:hi - h0 * F_],
                        w[lo:hi])


def forward(cfg: RecsysConfig, params: RecsysModel, batch: dict) -> Tensor:
    """Logits (B,). batch: sparse (B, F[, L]) int [+ dense (B, n_dense)]."""
    emb = embedding_bag(params.table, batch["sparse"], cfg.offsets)
    B = emb.shape[0]

    if cfg.model == "dlrm":
        return _dlrm_logits(params, emb, batch["dense"])

    if cfg.model == "autoint":
        return _autoint_logits(cfg, params, emb)

    if cfg.model == "wide_deep":
        deep = _mlp_apply(params.deep, emb.reshape(B, -1))[:, 0]
        wide = embedding_bag(params.wide, batch["sparse"], cfg.offsets)
        return deep + torch.sum(wide, dim=(1, 2))

    if cfg.model == "xdeepfm":
        x0 = emb  # (B, F, d)
        xk = x0
        pooled = []
        for l in params.cin:
            xk = _cin_rows(xk, x0, l.w, 0, l.w.shape[0])    # (B, Hk+1, d)
            pooled.append(torch.sum(xk, dim=-1))            # (B, Hk+1)
        cin_logit = _mlp_apply(params.cin_out, torch.cat(pooled, dim=-1))[:, 0]
        dnn_logit = _mlp_apply(params.dnn, emb.reshape(B, -1))[:, 0]
        lin = embedding_bag(params.linear, batch["sparse"], cfg.offsets)
        return cin_logit + dnn_logit + torch.sum(lin, dim=(1, 2))

    raise ValueError(cfg.model)


def _bce(logits: Tensor, labels: Tensor) -> Tensor:
    """Elementwise sigmoid binary cross-entropy of logits against labels in
    {0, 1}."""
    y = labels.float()
    return (torch.clamp_min(logits, 0.0) - logits * y
            + torch.log1p(torch.exp(-torch.abs(logits))))


def loss_fn(cfg: RecsysConfig, params: RecsysModel, batch: dict
            ) -> Tuple[Tensor, dict]:
    """Sigmoid binary cross-entropy vs batch['labels'] (B,) in {0, 1}."""
    loss = torch.mean(_bce(forward(cfg, params, batch), batch["labels"]))
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


# -- on a (data, model) mesh ------------------------------------------------------
#
# The reference's rules (``distributed.sharding.recsys_param_specs``, its
# ``repro.distributed.sharding:116-125``) lay the leaves out:
#
# * ``table``, ``wide`` and ``linear`` P("model", None): each model shard
#   holds a block of rows. A lookup is ``layers.gather_rows_sharded``: each
#   shard gathers the ids it holds, and the shards' rows meet by a
#   fixed-order sum (one nonzero term a row, so exactly the rows);
# * ``deep.0.w`` and ``dnn.0.w`` P(None, "model"): each model shard
#   multiplies the whole embeddings by its block of columns, and the
#   blocks are gathered along the features (``partition.all_gather``);
# * every other leaf P(), and the batch over ``data``
#   (``recsys_input_shardings``): each data replica takes its rows.
#
# Within a data replica the replicated dense work (the MLPs, DLRM's
# interaction, AutoInt's attention, the CIN's pooling and output layer)
# runs once, on the replica's first model shard, which alone takes its
# logits and loss; the other shards' copies of those leaves get zero
# gradients, so the sum over holders (``partition.reduce_holders_``)
# counts each replica's use once. The per-replica loss sums meet on the
# mesh's first device (``partition.sum_to``) and are divided once by the
# global batch.
#
# The reference's ``emb_shard`` / ``act_shard`` constraints are layout,
# not function:
#
# * xDeepFM's CIN keeps its constraint P(dp, "model", None) on z = (B,
#   Hk * F, d): model shard m forms only its block of rows p = h * F + f
#   of z and contracts it with the same rows of the layer's ``w``; the
#   (B, H, d) f32 partials meet by ``partition.all_sum``, in shard order.
#   Hk * F need not divide by M (39 x 39 = 1,521 at xDeepFM's first
#   layer): the rows split in blocks of ceil(Hk * F / M), the last shorter,
#   which is GSPMD's padding with zero rows of ``w`` (their terms are
#   zero) without forming them. At the train_batch cell's B = 65,536 a
#   layer's z is 20.4 GB f32; on a 2 x 2 mesh a shard forms 5.1 GB of it;
# * AutoInt's field-sharded constraint on its attention output is not
#   kept. At B = 65,536 and published width a layer keeps about seven
#   (B, 39, 64) f32 tensors (0.65 GB each) and its (B, 2, 39, 39) scores
#   and probabilities (0.80 GB each), ~6 GB a layer and ~18 GB for the
#   three, which one card holds beside its block of the 2.2 GB table
#   (phase 21 trains AutoInt at this batch on one card); splitting the
#   fields would add an all-gather of the keys and values to every
#   layer, since every field attends to every field;
# * ``emb_shard`` P(dp, None, None) is the embeddings' own layout here.
#
# Only the column-split products and the CIN's partial sums change the
# summation order against the single device. So on a 1 x M mesh DLRM's and
# AutoInt's logits and table gradients are the single device's bits, and
# every model's gathered rows are.


def check_mesh(cfg: RecsysConfig, mesh) -> None:
    """Raise unless ``cfg``'s split leaves divide over the mesh's model
    axis."""
    M = mesh.shape["model"]
    bad = []
    if cfg.padded_rows % M:
        bad.append(f"padded_rows % M: {cfg.padded_rows} rows on {M} model "
                   "shards")
    if cfg.model in ("wide_deep", "xdeepfm"):
        width = (tuple(cfg.mlp) + (1,))[0]
        if width % M:
            bad.append(f"the first MLP width % M: {width} columns on {M} "
                       "model shards")
    if bad:
        raise ValueError(f"{cfg.name} does not split over the mesh "
                         f"{dict(mesh.shape)}: " + "; ".join(bad))


class ShardedRecsys:
    """A ranking model's leaves (``params``: name -> ``ShardedTensor``) on
    a (data, model) mesh."""

    def __init__(self, cfg: RecsysConfig, mesh, params: dict):
        check_mesh(cfg, mesh)
        self.cfg, self.mesh, self.params = cfg, mesh, dict(params)


def param_specs(cfg: RecsysConfig) -> dict:
    """The reference's rules' spec of every leaf, by name."""
    return recsys_param_specs(RecsysModel(cfg, device="meta"))


@torch.no_grad()
def init_sharded(cfg: RecsysConfig, mesh, *,
                 generator: torch.Generator) -> ShardedRecsys:
    """``init_params``' weights, bit for bit (the same draws on the
    generator's device, leaf by leaf), each placed on ``mesh`` by its spec
    and dropped before the next is drawn."""
    check_mesh(cfg, mesh)
    specs = param_specs(cfg)
    params = {}
    for name, value in _draws(cfg, generator):
        params[name] = place(value, specs[name], mesh)
        del value
    for st in params.values():
        for s in st.shards:
            s.requires_grad_(True)
    return ShardedRecsys(cfg, mesh, params)


def _local(model: ShardedRecsys, pos: int) -> SimpleNamespace:
    """Mesh position ``pos``'s shards in ``RecsysModel``'s shape
    (``p.bot[0].w``, ``p.table``, ...)."""
    tree: dict = {}
    for name, st in model.params.items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = st.shards[pos]

    def build(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return [build(node[str(i)]) for i in range(len(node))]
        return SimpleNamespace(**{k: build(v) for k, v in node.items()})

    return build(tree)


def _laid_out(model: ShardedRecsys, x, spec: P) -> list:
    """Each mesh position's block of ``x`` laid out by ``spec``, on its
    device (``x``: a whole tensor, or a ``ShardedTensor`` of any
    layout)."""
    if isinstance(x, ShardedTensor):
        if x.spec == spec and x.mesh.devices.shape == model.mesh.devices.shape \
                and list(x.mesh.devices.flat) == list(model.mesh.devices.flat):
            return x.shards
        x = x.gather()
    return place(x, spec, model.mesh).shards


def embedding_bag_sharded(tables: list, indices: list,
                          offsets: Tuple[int, ...], *, weights=None,
                          to=None):
    """``embedding_bag`` of a table whose rows are split over model shards
    in order (``tables[m]`` on shard m's device, ``indices[m]`` the same
    (B, F[, L]) ids there): the rows gathered whole
    (``layers.gather_rows_sharded``), then ``embedding_bag``'s bag sum on
    each copy. Returns a list of (B, F, d) f32, one a shard (``weights``
    then a list alike, or None), or with ``to`` one on that device
    (``weights`` one tensor there, or None)."""
    flat = [_flat_ids(i, offsets) for i in indices]
    rows = gather_rows_sharded(tables, flat, to=to)
    if to is not None:
        return _bag(rows, weights)
    return [_bag(r, None if weights is None else w)
            for r, w in zip(rows, weights or [None] * len(rows))]


def _split_first_mlp(model: ShardedRecsys, row: list, prefix: str,
                     xs: list) -> Tensor:
    """``_mlp_apply(prefix, x)[:, 0]`` with the first layer's columns split
    over the model shards of ``row`` (``xs[m]``: x on shard m's device):
    each shard's block of columns, gathered along the features onto the
    first shard, which adds the bias and runs the rest."""
    w = model.params[f"{prefix}.0.w"]
    h = all_gather([x @ w.shards[q] for x, q in zip(xs, row)], -1)[0]
    layers = getattr(_local(model, row[0]), prefix)
    h = h + layers[0].b
    if len(layers) > 1:
        h = torch.relu(h)
    return _mlp_apply(layers[1:], h)[:, 0]


def _sharded_cin(cfg: RecsysConfig, model: ShardedRecsys, row: list,
                 x0s: list) -> Tensor:
    """xDeepFM's CIN logit (B,) on ``row``'s first shard, each layer's rows
    of z split over the shards (``x0s[m]``: the embeddings on shard m)."""
    M = len(row)
    xks, pooled = x0s, []
    for i in range(len(cfg.cin_layers)):
        w = model.params[f"cin.{i}.w"]
        P_ = w.shape[0]
        blk = -(-P_ // M)  # P_ padded to a multiple of M, over M
        xks = all_sum([
            _cin_rows(xks[m], x0s[m], w.shards[q], min(m * blk, P_),
                      min((m + 1) * blk, P_)) for m, q in enumerate(row)])
        pooled.append(torch.sum(xks[0], dim=-1))
    p = _local(model, row[0])
    return _mlp_apply(p.cin_out, torch.cat(pooled, dim=-1))[:, 0]


def _replica_logits(cfg: RecsysConfig, model: ShardedRecsys, row: list,
                    sparse: list, dense: Optional[Tensor]) -> Tensor:
    """One data replica's logits (B_d,) on its first shard's device.
    ``row``: the replica's positions, in model order; ``sparse[m]``: its
    ids on ``row[m]``'s device; ``dense``: its dense features on the
    first."""
    dev = model.mesh.devices.flat[row[0]]

    def tables(name):
        return [model.params[name].shards[q] for q in row]

    if cfg.model in ("dlrm", "autoint"):
        emb = embedding_bag_sharded(tables("table"), sparse, cfg.offsets,
                                    to=dev)
        p = _local(model, row[0])
        if cfg.model == "dlrm":
            return _dlrm_logits(p, emb, dense)
        return _autoint_logits(cfg, p, emb)
    if cfg.model not in ("wide_deep", "xdeepfm"):
        raise ValueError(cfg.model)
    embs = embedding_bag_sharded(tables("table"), sparse, cfg.offsets)
    B = embs[0].shape[0]
    if cfg.model == "wide_deep":
        deep = _split_first_mlp(model, row, "deep",
                                [e.reshape(B, -1) for e in embs])
        wide = embedding_bag_sharded(tables("wide"), sparse, cfg.offsets,
                                     to=dev)
        return deep + torch.sum(wide, dim=(1, 2))
    cin_logit = _sharded_cin(cfg, model, row, embs)
    dnn_logit = _split_first_mlp(model, row, "dnn",
                                 [e.reshape(B, -1) for e in embs])
    lin = embedding_bag_sharded(tables("linear"), sparse, cfg.offsets,
                                to=dev)
    return cin_logit + dnn_logit + torch.sum(lin, dim=(1, 2))


def _logits(cfg: RecsysConfig, model: ShardedRecsys, batch: dict) -> list:
    """Every data replica's logits on its first shard's device, in replica
    order, with that device's labels (or None)."""
    rows = axis_groups(model.mesh, "model")
    dp = mesh_data_axes(model.mesh)
    data = P(dp, None)
    sparse = _laid_out(model, batch["sparse"], data)
    dense = (_laid_out(model, batch["dense"], data)
             if batch.get("dense") is not None else None)
    labels = (_laid_out(model, batch["labels"], P(dp))
              if batch.get("labels") is not None else None)
    out = []
    for row in rows:
        lg = _replica_logits(cfg, model, row, [sparse[q] for q in row],
                             None if dense is None else dense[row[0]])
        out.append((lg, None if labels is None else labels[row[0]]))
    return out


def sharded_forward(cfg: RecsysConfig, model: ShardedRecsys,
                    batch: dict) -> Tensor:
    """``forward``'s logits (B,) on the mesh, gathered onto its first
    device. batch: ``forward``'s, each array whole or laid out by
    ``sharding.recsys_input_shardings`` (``partition.place``)."""
    logits = [lg for lg, _ in _logits(cfg, model, batch)]
    return all_gather(logits, 0)[0]


def sharded_loss_fn(cfg: RecsysConfig, model: ShardedRecsys, batch: dict
                    ) -> Tuple[Tensor, dict]:
    """``loss_fn`` on the mesh: each data replica's summed cross-entropy,
    the sums added in replica order on the mesh's first device and divided
    once by the global batch."""
    out = _logits(cfg, model, batch)
    sums = [torch.sum(_bce(lg, y)) for lg, y in out]
    B = sum(lg.shape[0] for lg, _ in out)
    loss = sum_to(sums, model.mesh.first_device) / B
    return loss, {"loss": loss}


def sharded_user_repr(cfg: RecsysConfig, model: ShardedRecsys,
                      batch: dict) -> Tensor:
    """``user_repr`` (B, embed_dim) on the mesh's first device. The batch
    (whole, or laid out by any spec) is read once, by the first data
    replica's model shards, as the retrieval cell replicates it."""
    row = axis_groups(model.mesh, "model")[0]
    sparse = _laid_out(model, batch["sparse"], P())
    emb = embedding_bag_sharded(
        [model.params["table"].shards[q] for q in row],
        [sparse[q] for q in row], cfg.offsets, to=model.mesh.first_device)
    return torch.mean(emb, dim=1)


def sharded_topk(q: Tensor, rows: ShardedTensor, k: int, score, *,
                 largest: bool) -> Tuple[Tensor, Tensor]:
    """The ``k`` best rows of a row-sharded (N, ...) table for each query
    of ``q`` by ``score(q, block) -> (B, rows)``: largest or smallest
    first, a tie going to the lower row (``lax.top_k``'s order). Each
    distinct block takes its own k best by a stable sort, on its device;
    they are gathered onto ``q``'s device in row order and merged by
    ``kernels.scoring.merge_topk``. Returns (scores (B, k), row ids (B, k)
    int32) on ``q``'s device."""
    mesh = rows.mesh
    qs = place(q, P(), mesh).shards
    starts = sorted((block(rows.shape, rows.spec, mesh, g[0])[0].start, g[0])
                    for g in rows.holders())
    keys, ids = [], []
    for start, pos in starts:
        s = score(qs[pos], rows.shards[pos])
        key, idx = torch.sort(-s if largest else s, dim=1, stable=True)
        keys.append(key[:, :k])
        ids.append(idx[:, :k] + start)
    # the blocks' lists side by side on the first block's device: one
    # stable sort of [block 0 | block 1 | ...] keeps the lower row first
    w = keys[0].shape[1]
    keys, ids = all_gather(keys, 1)[0], all_gather(ids, 1)[0]
    best, best_i = merge_topk(keys[:, :w], ids[:, :w], keys[:, w:],
                              ids[:, w:], k)
    best, best_i = best.to(q.device), best_i.to(q.device)
    return (-best if largest else best), best_i.to(torch.int32)
