"""Step builders: a step function, its abstract arguments and their
partition specs per (architecture x shape cell) (PyTorch counterpart of
``repro.launch.steps``).

``build_plan(arch_id, shape, ...)`` returns a :class:`StepPlan`: the
fields of the reference's ``LoweringPlan``, with ``args`` as meta-device
tensors (shapes and dtypes, no storage) and ``fn`` a step that runs on a
(data, model) mesh: its arguments are laid out by ``in_specs``
(``distributed.partition.place``). Where the reference lowers the plan for
a mesh through GSPMD, the port runs it single-controller
(``distributed.partition``).

The LM train plan is ported: ``n_microbatches`` gradient accumulation, the
reference's arithmetic (f32 sums of the microbatches' gradients, then
``(gsum / nm).astype(p.dtype)`` and ``loss = lsum / nm``), then AdamW from
``make_optimizer``. So is the GNN train plan: MACE bound to the cell's
feature width (``configs.mace.for_shape``), ``edge_chunks = 16`` for a
graph of more than 8,000,000 edges (unless the config already chunks),
then the loss, its gradients and AdamW, with edges over ``data`` and
channels over ``model`` (``mace.sharded_loss_fn``). So are the recsys
plans (``recsys.sharded_loss_fn``, ``sharded_forward``,
``sharded_user_repr``): train (the loss, its gradients and AdamW, the batch
over ``data``), serve (the logits, laid out over ``data``) and retrieval,
the batch replicated: a top-100 by dot product over the candidates, or
with ``retrieval_mode="zen"`` the paper's estimator, the query's reference
distances projected (``core.simplex.apex_project``) and scored against
the reduced index (``core.zen.estimate_pdist``), smallest first. Each
block of candidates takes its own top 100 on its device and the blocks
merge in row order (``recsys.sharded_topk``): a tie goes to the lower
row, as in ``lax.top_k``. The candidates (dense, or the reduced index's
coords) lie over the data axes, as the reference's plan lays them (10^6
rows divide by 16 and 32 but not by the 256- or 512-way mesh), the
transform replicated. So are
the LM's prefill and decode plans (``transformer.sharded_prefill``,
``sharded_decode_step``): the prompt over ``data``, its logits laid out
P(dp, "model") and its KV cache P(None, dp, "model", None, None), the
batch over ``data`` and the sequence over ``model``; a decode step against
that cache (the 500k decode's one row replicated, its cache's sequence
over ("data", "model")), whose new keys and values the step writes in
place, as the train plans update their state in place. ``place_inputs``
lays a prefill's tokens or a decode's cache and token out by the plan's
specs. Every plan is built for the (data, model) mesh and, with
``multi_pod``, for the reference's (pod, data, model) mesh, whose
``pod`` axis extends the data axes (``sharding.data_axes``): the batch,
the edges, the candidates and the cache's batch lie over ("pod",
"data"), the 500k decode's sequence over all three axes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch import configs as C
from repro_torch.core.metrics import euclidean_pdist
from repro_torch.core.simplex import BaseSimplex, apex_project
from repro_torch.core.zen import estimate_pdist
from repro_torch.distributed import partition
from repro_torch.distributed import sharding as shard_lib
from repro_torch.distributed.partition import ShardedTensor
from repro_torch.launch import train as train_lib
from repro_torch.models import mace, recsys, transformer
from repro_torch.optim import AdamW, AdamWState


@dataclasses.dataclass
class StepPlan:
    arch_id: str
    shape: str
    kind: str
    fn: Callable
    args: Tuple[Any, ...]           # pytrees of meta-device tensors
    in_specs: Tuple[Any, ...]       # matching pytrees of sharding.P
    out_specs: Any                  # pytree of sharding.P or None
    cfg: Any = None
    skip: Optional[str] = None


def make_optimizer() -> AdamW:
    return AdamW(learning_rate=3e-4, weight_decay=0.01, clip_norm=1.0)


def _meta(spec) -> torch.Tensor:
    return torch.empty(spec.shape, dtype=spec.dtype, device="meta")


def _lm_train_plan(spec, cfg, cell, multi_pod: bool) -> StepPlan:
    params_shape = dict(transformer.Transformer(cfg, device="meta")
                        .named_parameters())
    pspecs = shard_lib.lm_param_specs(params_shape)
    opt_shape = _opt_shape(params_shape)
    ospecs = shard_lib.opt_state_specs(pspecs)
    ins = C.input_specs(spec, cfg, cell)
    batch_shape = {k: _meta(v) for k, v in ins["batch"].items()}
    in_shard = shard_lib.lm_input_shardings(cell.kind, cell.shape,
                                            multi_pod, cfg)
    opt = make_optimizer()
    nm = cfg.n_microbatches

    def train_step(params: dict, opt_state: AdamWState, batch: dict):
        """One step on the mesh the leaves of ``params`` (name ->
        ``ShardedTensor``) live on; ``opt_state``'s moments and step laid
        out alike. Updates the shards in place and returns (params,
        opt_state, aux)."""
        trainer = train_lib.ShardedTrainer(
            transformer.ShardedTransformer(cfg, _mesh_of(params), params),
            opt=opt, opt_state=opt_state)
        tokens = batch["tokens"]
        if nm == 1:
            loss, aux, grads = trainer.reduced_grads({"tokens": tokens})
        else:
            # gradient accumulation: activation memory / nm
            if isinstance(tokens, ShardedTensor):
                tokens = tokens.gather()
            B = tokens.shape[0]
            gsum = lsum = None
            for i in range(nm):
                mb = tokens[i * (B // nm):(i + 1) * (B // nm)]
                loss, _, grads = trainer.reduced_grads({"tokens": mb})
                if gsum is None:
                    gsum = {n: g.map(lambda s: s.float(), torch.float32)
                            for n, g in grads.items()}
                    lsum = torch.zeros((), dtype=torch.float32,
                                       device=loss.device) + loss.detach()
                    continue
                for n, g in grads.items():
                    for acc, s in zip(gsum[n].shards, g.shards):
                        acc.add_(s.float())
                lsum = lsum + loss.detach()
                del grads
            grads = {n: g.map(lambda s, d=params[n].dtype: (s / nm).to(d),
                              params[n].dtype)
                     for n, g in gsum.items()}
            del gsum
            loss = lsum / nm
            aux = {"loss": loss}
        trainer.apply(grads)
        return params, trainer.opt_state, {k: v.detach()
                                           for k, v in aux.items()}

    return StepPlan(
        spec.arch_id, cell.shape, cell.kind, train_step,
        args=(params_shape, opt_shape, batch_shape),
        in_specs=(pspecs, ospecs, in_shard["batch"]),
        out_specs=(pspecs, ospecs, shard_lib.P()),
        cfg=cfg, skip=cell.skip)


def _lm_serve_plan(spec, cfg, cell, multi_pod: bool) -> StepPlan:
    dp = shard_lib.data_axes(multi_pod)
    params_shape = dict(transformer.Transformer(cfg, device="meta")
                        .named_parameters())
    pspecs = shard_lib.lm_param_specs(params_shape)
    ins = C.input_specs(spec, cfg, cell)
    in_shard = shard_lib.lm_input_shardings(cell.kind, cell.shape,
                                            multi_pod, cfg)

    def cache_specs(leaf_spec) -> dict:
        return {f"pos{p}": {"k": leaf_spec, "v": leaf_spec}
                for p in range(cfg.pattern_len)}

    def model_of(params):
        return transformer.ShardedTransformer(cfg, _mesh_of(params), params)

    if cell.kind == "prefill":
        def prefill_step(params: dict, tokens):
            """(the last position's logits (B, Vp) laid out P(dp,
            "model"), the KV cache laid out P(None, dp, "model", None,
            None)) of the prompt ``tokens`` (B, S): whole, or laid out
            P(dp, None)."""
            return transformer.sharded_prefill(cfg, model_of(params), tokens)

        return StepPlan(
            spec.arch_id, cell.shape, cell.kind, prefill_step,
            args=(params_shape, _meta(ins["tokens"])),
            in_specs=(pspecs, in_shard["tokens"]),
            out_specs=(shard_lib.P(dp, "model"), cache_specs(
                shard_lib.P(None, dp, "model", None, None))),
            cfg=cfg, skip=cell.skip)

    cache_spec = cache_specs(in_shard["cache"])
    logits_spec = (shard_lib.P(None, "model") if cell.shape == "long_500k"
                   else shard_lib.P(dp, "model"))

    def decode_step(params: dict, cache: dict, token, cache_len):
        """(logits (B, Vp) laid out by the plan's first out spec, the
        cache) of one token against ``cache`` (laid out by ``in_specs``),
        whose new keys and values are written in place, as the trainer's
        plans update their state in place. ``token`` (B, 1): whole or
        laid out by its in spec; ``cache_len`` an int or a scalar
        tensor."""
        return transformer.sharded_decode_step(cfg, model_of(params), cache,
                                               token, cache_len)

    return StepPlan(
        spec.arch_id, cell.shape, cell.kind, decode_step,
        args=(params_shape, _meta_tree(ins["cache"]), _meta(ins["token"]),
              _meta(ins["cache_len"])),
        in_specs=(pspecs, cache_spec, in_shard["token"],
                  in_shard["cache_len"]),
        out_specs=(logits_spec, cache_spec),
        cfg=cfg, skip=cell.skip)


def _meta_tree(tree: dict) -> dict:
    return {k: _meta_tree(v) if isinstance(v, dict) else _meta(v)
            for k, v in tree.items()}


def _opt_shape(params_shape: dict) -> AdamWState:
    f32 = torch.float32
    return AdamWState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        mu={n: torch.empty(p.shape, dtype=f32, device="meta")
            for n, p in params_shape.items()},
        nu={n: torch.empty(p.shape, dtype=f32, device="meta")
            for n, p in params_shape.items()})


#: the reference plan's threshold for chunking a full-batch graph's edges,
#: and the chunk count it sets
GIANT_EDGES, GIANT_EDGE_CHUNKS = 8_000_000, 16


def _gnn_train_plan(spec, cfg, cell, multi_pod: bool) -> StepPlan:
    from repro_torch.configs import mace as mace_cfg

    cfg = mace_cfg.for_shape(cfg, cell.dims["d_feat"])
    if (cell.dims["n_edges"] > GIANT_EDGES and cfg.edge_chunks == 1
            and not multi_pod):
        # full-batch giant graphs: edge-chunked A-basis accumulation
        cfg = dataclasses.replace(cfg, edge_chunks=GIANT_EDGE_CHUNKS)
    params_shape = dict(mace.MACE(cfg, device="meta").named_parameters())
    pspecs = shard_lib.gnn_param_specs(params_shape)
    ins = C.input_specs(spec, cfg, cell)
    static = ins["static"]
    batch_shape = {k: _meta(v) for k, v in ins["batch"].items()}
    in_shard_all = shard_lib.gnn_input_shardings(multi_pod)["batch"]
    opt = make_optimizer()

    def train_step(params: dict, opt_state: AdamWState, batch: dict):
        """One step on the mesh the leaves of ``params`` live on (as the
        LM plan's): updates the shards in place and returns (params,
        opt_state, aux)."""
        trainer = train_lib.ShardedTrainer(
            mace.ShardedMACE(cfg, _mesh_of(params), params),
            opt=opt, opt_state=opt_state)
        loss, aux, grads = trainer.reduced_grads(dict(batch, **static))
        trainer.apply(grads)
        return params, trainer.opt_state, {k: v.detach()
                                           for k, v in aux.items()}

    return StepPlan(
        spec.arch_id, cell.shape, cell.kind, train_step,
        args=(params_shape, _opt_shape(params_shape), batch_shape),
        in_specs=(pspecs, shard_lib.opt_state_specs(pspecs),
                  {k: in_shard_all[k] for k in batch_shape}),
        out_specs=(pspecs, shard_lib.opt_state_specs(pspecs),
                   shard_lib.P()),
        cfg=cfg, skip=cell.skip)


def _recsys_plan(spec, cfg, cell, multi_pod: bool) -> StepPlan:
    dp = shard_lib.data_axes(multi_pod)
    params_shape = dict(recsys.RecsysModel(cfg, device="meta")
                        .named_parameters())
    pspecs = shard_lib.recsys_param_specs(params_shape)
    ins = C.input_specs(spec, cfg, cell)
    batch_shape = {k: _meta(v) for k, v in ins["batch"].items()}
    in_shard_all = shard_lib.recsys_input_shardings(cell.kind, multi_pod)
    in_shard = {k: in_shard_all["batch"][k] for k in batch_shape}

    def model_of(params):
        return recsys.ShardedRecsys(cfg, _mesh_of(params), params)

    if cell.kind == "train":
        opt = make_optimizer()

        def train_step(params: dict, opt_state: AdamWState, batch: dict):
            """One step on the mesh the leaves of ``params`` live on (as
            the LM plan's): updates the shards in place and returns
            (params, opt_state, aux)."""
            trainer = train_lib.ShardedTrainer(model_of(params), opt=opt,
                                               opt_state=opt_state)
            loss, aux, grads = trainer.reduced_grads(batch)
            trainer.apply(grads)
            return params, trainer.opt_state, {k: v.detach()
                                               for k, v in aux.items()}

        return StepPlan(
            spec.arch_id, cell.shape, cell.kind, train_step,
            args=(params_shape, _opt_shape(params_shape), batch_shape),
            in_specs=(pspecs, shard_lib.opt_state_specs(pspecs), in_shard),
            out_specs=(pspecs, shard_lib.opt_state_specs(pspecs),
                       shard_lib.P()),
            cfg=cfg, skip=cell.skip)

    if cell.kind == "serve":
        @torch.no_grad()
        def serve_step(params: dict, batch: dict) -> ShardedTensor:
            """The logits (B,), laid out over ``data``."""
            model = model_of(params)
            return partition.place(
                recsys.sharded_forward(cfg, model, batch), shard_lib.P(dp),
                model.mesh)

        return StepPlan(
            spec.arch_id, cell.shape, cell.kind, serve_step,
            args=(params_shape, batch_shape), in_specs=(pspecs, in_shard),
            out_specs=shard_lib.P(dp), cfg=cfg, skip=cell.skip)

    if cell.kind != "retrieval":
        raise ValueError(cell.kind)
    out_specs = {"scores": shard_lib.P(), "ids": shard_lib.P()}
    if cfg.retrieval_mode == "zen":
        cand_specs = {"coords": shard_lib.P(dp, None), "refs": shard_lib.P(),
                      "chol": shard_lib.P(), "diag_g": shard_lib.P(),
                      "d0": shard_lib.P()}

        @torch.no_grad()
        def zen_step(params: dict, batch: dict, index: dict) -> dict:
            """The 100 candidates of smallest Zen estimate a query, from
            the reduced index (``index``: coords laid out over ``data``,
            the transform whole or replicated)."""
            model = model_of(params)
            mesh = model.mesh
            whole = {k: _whole(index[k], mesh) for k in
                     ("refs", "chol", "diag_g", "d0")}
            q = recsys.sharded_user_repr(cfg, model, batch)
            base = BaseSimplex(chol=whole["chol"], diag_g=whole["diag_g"],
                               d0=whole["d0"])
            qp = apex_project(base, euclidean_pdist(q, whole["refs"]))
            coords = _rows_of(index["coords"], cand_specs["coords"], mesh)
            d, ids = recsys.sharded_topk(
                qp, coords, 100,
                lambda x, block: estimate_pdist(x, block, "zen"),
                largest=False)
            return {"scores": d, "ids": ids}

        return StepPlan(
            spec.arch_id, cell.shape, cell.kind, zen_step,
            args=(params_shape, batch_shape,
                  {k: _meta(v) for k, v in ins["candidates"].items()}),
            in_specs=(pspecs, in_shard, cand_specs), out_specs=out_specs,
            cfg=cfg, skip=cell.skip)

    # candidates over the data axes (10^6 rows divide by 16 and 32 but not
    # by the full 256- or 512-way mesh product)
    cand_spec = shard_lib.P(dp, None)

    @torch.no_grad()
    def retrieval_step(params: dict, batch: dict, candidates) -> dict:
        """The 100 candidates of largest dot product a query
        (``candidates``: whole, or laid out by the plan's spec)."""
        model = model_of(params)
        q = recsys.sharded_user_repr(cfg, model, batch)
        scores, ids = recsys.sharded_topk(
            q, _rows_of(candidates, cand_spec, model.mesh), 100,
            recsys.retrieval_scores, largest=True)
        return {"scores": scores, "ids": ids}

    return StepPlan(
        spec.arch_id, cell.shape, cell.kind, retrieval_step,
        args=(params_shape, batch_shape, _meta(ins["candidates"])),
        in_specs=(pspecs, in_shard, cand_spec), out_specs=out_specs,
        cfg=cfg, skip=cell.skip)


def _whole(x, mesh) -> torch.Tensor:
    """``x`` whole on the mesh's first device (``x``: a tensor there, or a
    ``ShardedTensor``)."""
    if isinstance(x, ShardedTensor):
        return x.gather()
    return partition.held(x, mesh, 0)


def _rows_of(x, spec, mesh) -> ShardedTensor:
    """``x`` laid out by ``spec``: a ``ShardedTensor`` as it is, a whole
    tensor placed."""
    if isinstance(x, ShardedTensor):
        return x
    return partition.place(x, spec, mesh)


def _mesh_of(params: dict):
    return next(iter(params.values())).mesh


def place_args(plan: StepPlan, mesh, params: dict,
               opt_state: Optional[AdamWState] = None):
    """``params`` (name -> whole tensor) laid out on ``mesh`` by the plan's
    specs, as ``fn`` takes them; for a train plan also an optimizer state
    (zeros by default), and the returned pair (params, opt_state)."""
    pspecs = plan.in_specs[0]
    train = plan.kind == "train"
    placed = {}
    for n, p in params.items():
        placed[n] = partition.place(p.detach(), pspecs[n], mesh)
        for s in placed[n].shards:
            s.requires_grad_(train)
    if not train:
        return placed
    ospecs = plan.in_specs[1]
    f32 = torch.float32
    if opt_state is None:
        zeros = {n: torch.zeros(p.shape, dtype=f32, device=p.device)
                 for n, p in params.items()}
        opt_state = AdamWState(
            step=torch.zeros((), dtype=torch.int32,
                             device=next(iter(params.values())).device),
            mu=zeros, nu=zeros)
    ost = AdamWState(
        step=partition.place(opt_state.step, ospecs.step, mesh),
        mu={n: partition.place(t, ospecs.mu[n], mesh)
            for n, t in opt_state.mu.items()},
        nu={n: partition.place(t, ospecs.nu[n], mesh)
            for n, t in opt_state.nu.items()})
    return placed, ost


def place_inputs(plan: StepPlan, mesh, *inputs) -> tuple:
    """The plan's arguments after the parameters (a prefill's tokens; a
    decode's cache, token and cache length), each laid out on ``mesh`` by
    its ``in_specs`` entry: a tensor placed, a nested dict leaf by leaf,
    a Python number as it is."""
    def lay(x, spec):
        if isinstance(x, dict):
            return {k: lay(v, spec[k]) for k, v in x.items()}
        if isinstance(x, torch.Tensor):
            return partition.place(x, spec, mesh)
        return x

    return tuple(lay(x, s) for x, s in zip(inputs, plan.in_specs[1:]))


def build_plan(
    arch_id: str,
    shape: str,
    *,
    reduced: bool = False,
    multi_pod: bool = False,
    overrides: Optional[dict] = None,
    dims: Optional[dict] = None,
) -> StepPlan:
    """overrides: config-field replacements, e.g. ``{"n_microbatches":
    4}``, ``{"edge_chunks": 32}`` or ``{"retrieval_mode": "zen"}``; dims:
    the cell's sizes replaced, e.g. ``{"global_batch": 8}`` (a cut of
    scale; the shapes' other dimensions stay). Every cell of every family,
    on the (data, model) mesh or, with ``multi_pod``, the (pod, data,
    model) mesh."""
    spec = C.get_arch(arch_id)
    cell = spec.cell(shape)
    if dims:
        cell = dataclasses.replace(cell, dims=dict(cell.dims, **dims))
    cfg = spec.make_reduced() if reduced else spec.make_config()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if spec.family == "gnn":
        return _gnn_train_plan(spec, cfg, cell, multi_pod)
    if spec.family == "recsys":
        return _recsys_plan(spec, cfg, cell, multi_pod)
    if cell.kind == "train":
        return _lm_train_plan(spec, cfg, cell, multi_pod)
    return _lm_serve_plan(spec, cfg, cell, multi_pod)
