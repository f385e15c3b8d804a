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
channels over ``model`` (``mace.sharded_loss_fn``). The prefill, decode,
serve and retrieval kinds, the recsys plans and the multi-pod mesh are
ROADMAP A, item 3b.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch import configs as C
from repro_torch.distributed import partition
from repro_torch.distributed import sharding as shard_lib
from repro_torch.distributed.partition import ShardedTensor
from repro_torch.launch import train as train_lib
from repro_torch.models import mace, transformer
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


def _mesh_of(params: dict):
    return next(iter(params.values())).mesh


def place_args(plan: StepPlan, mesh, params: dict,
               opt_state: Optional[AdamWState] = None):
    """``params`` (name -> whole tensor) and an optimizer state (zeros by
    default) laid out on ``mesh`` by the plan's specs, as ``fn`` takes
    them."""
    pspecs, ospecs, _ = plan.in_specs
    placed = {}
    for n, p in params.items():
        placed[n] = partition.place(p.detach(), pspecs[n], mesh)
        for s in placed[n].shards:
            s.requires_grad_(True)
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


def build_plan(
    arch_id: str,
    shape: str,
    *,
    reduced: bool = False,
    multi_pod: bool = False,
    overrides: Optional[dict] = None,
) -> StepPlan:
    """overrides: config-field replacements, e.g. ``{"n_microbatches":
    4}`` or ``{"edge_chunks": 32}``. The LM and GNN families' train cells
    only (ROADMAP A, item 3b for the rest)."""
    spec = C.get_arch(arch_id)
    cell = spec.cell(shape)
    cfg = spec.make_reduced() if reduced else spec.make_config()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if spec.family not in ("lm", "gnn") or cell.kind != "train":
        raise NotImplementedError(
            f"the {spec.family} family's {cell.kind} plan ({arch_id}, "
            f"{shape}) is ROADMAP A, item 3b; the LM and GNN train plans "
            "are ported")
    if multi_pod:
        raise NotImplementedError(
            "the multi-pod mesh comes with the dry-run (ROADMAP A, item 3b)")
    if spec.family == "gnn":
        return _gnn_train_plan(spec, cfg, cell, multi_pod)
    return _lm_train_plan(spec, cfg, cell, multi_pod)
