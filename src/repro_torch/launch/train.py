"""Training entry point of the port: the LM family (``qwen1.5-0.5b``,
``gemma2-2b``, ``granite-8b``, ``granite-moe-3b-a800m``,
``qwen2-moe-a2.7b``), the GNN family (``mace``) and the recsys family
(``dlrm-rm2``, ``autoint``, ``wide-deep``, ``xdeepfm``) with
checkpoint/restart, straggler monitoring, preemption-aware saves and
optional gradient compression (PyTorch counterpart of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --reduced --device cpu --steps 12 --seq 64 --ckpt-dir /tmp/ck
    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-rm2 \\
        --reduced --device cpu --steps 12 --ckpt-dir /tmp/ck
    PYTHONPATH=src python -m repro_torch.launch.train --arch mace \\
        --reduced --device cpu --steps 12 --ckpt-dir /tmp/ck
    # the same command with --resume continues from the newest checkpoint

Runs on the card unless told ``--device cpu``; without a card it raises.
Batches are a pure function of (seed, step), drawn on the training device
and prefetched by a background thread, so a resumed run on the same
device takes the same steps, bit for bit: every operation of the step is
deterministic on one CUDA stream (the embedding gather's backward sorts
its ids, the reductions and GEMMs have fixed orders). An LM batch is
``--batch`` x ``--seq`` tokens of ``lm_batch``; a GNN batch is the
reference trainer's: ``geometric_graph_batch(seed + step)`` of ``--batch``
graphs, 16 nodes and 48 edges each (numpy draws, so the reference's
batches bit for bit).

Every family trains on a (data, model) mesh with ``--data-shards D
--model-shards M`` (D x M > 1): ``make_host_mesh(D, M)`` spans D x M cards
where there are that many, else puts D x M logical shards on the card (or
the CPU with ``--device cpu``). The weights are ``init_params``' from the
same seed, bit for bit, laid out by the reference's partition rules
(``distributed.sharding``); the global batch is the single device's, its
token rows (an LM's), edges (MACE's) or click rows (a ranking model's,
laid out over ``data`` as drawn) split over ``data``; the step is the
unsharded ``Trainer.step``'s function (``ShardedTrainer``). Checkpoints
carry every leaf's spec in the reference's manifest format, and
``--resume`` restores onto the current mesh whatever mesh saved.

``--multihost`` (the reference's ``jax.distributed.initialize()``) makes
the run one process a host, started by ``python -m
torch.distributed.run``: each process owns its host's cards
(``distributed.process``), and together they hold the ``--data-shards D
--model-shards M`` mesh, process r positions r L .. (r + 1) L - 1. Each
process draws the weights and the global batch itself (the same seed, on
its first device) and lays out only its own blocks; copies between
processes are point-to-point transfers and every sum is the one-process
mesh's, so losses, state and checkpoints are the one-process run's bits.
The step time fed to the straggler monitor is the slowest process's, and
a preemption flagged on any process stops them all at the same step.

    python -m torch.distributed.run --nproc-per-node 2 \\
        -m repro_torch.launch.train --multihost --device cpu \\
        --arch granite-8b --reduced --data-shards 1 --model-shards 4 \\
        --steps 3

Beyond the reference's options: ``--device``, ``--fixed-batch`` (every
step takes step 0's batch) and, for the LM family, ``--layers`` (the
published widths at a cut depth).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
        --reduced --device cpu --data-shards 2 --model-shards 2 --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch mace \\
        --reduced --device cpu --data-shards 2 --model-shards 2 --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch xdeepfm \\
        --reduced --device cpu --data-shards 2 --model-shards 2 --steps 4
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import signal
import threading
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import resolve_device
from repro_torch import configs as C
from repro_torch.checkpoint.checkpoint import (
    CheckpointManager,
    flat_state,
    leaf_paths,
    nest_state,
)
from repro_torch.data import synthetic as syn
from repro_torch.data.pipeline import PrefetchPipeline
from repro_torch.distributed import partition, process
from repro_torch.distributed import sharding as shard_lib
from repro_torch.distributed.fault import PreemptionGuard, StepMonitor
from repro_torch.distributed.partition import ShardedTensor
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import mace, recsys, transformer
from repro_torch.optim import AdamW, AdamWState, apply_updates
from repro_torch.optim import compression as comp_lib
from repro_torch.optim.adamw import clip_by_global_norm_sharded

Tensor = torch.Tensor

#: the reference trainer's learning rate
LEARNING_RATE = 3e-4


class Trainer:
    """A model, its AdamW state (and error-feedback buffers) and the step.

    ``loss_fn(model, batch) -> (loss, aux)``. The parameters, moments and
    gradients are keyed by the model's parameter names (``table``,
    ``bot.0.w``, ...); ``state_tree`` gives them as the reference's
    ``(params, AdamWState)`` pytree, which ``CheckpointManager`` writes in
    the reference's format.
    """

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, *,
                 opt: Optional[AdamW] = None, compress_grads: bool = False):
        self.model = model
        self.loss_fn = loss_fn
        self.params = dict(model.named_parameters())
        self.opt = opt if opt is not None else AdamW(
            learning_rate=LEARNING_RATE)
        self.opt_state = self.opt.init(self.params)
        self.comp_state = (comp_lib.init_state(self.params)
                           if compress_grads else None)

    def step(self, batch: dict) -> Tuple[Tensor, dict]:
        """One training step on ``batch``; returns (loss, aux), detached,
        computed before the update."""
        loss, aux = self.loss_fn(self.model, batch)
        # a leaf the loss does not reach (MACE's last layer's l = 1, 2
        # linears) gets zeros, as the reference's grad gives it
        grads = dict(zip(self.params, torch.autograd.grad(
            loss, list(self.params.values()), materialize_grads=True)))
        if self.comp_state is not None:
            grads, self.comp_state = comp_lib.error_feedback_update(
                grads, self.comp_state)
        updates, self.opt_state = self.opt.update(grads, self.opt_state,
                                                  self.params)
        apply_updates(self.params, updates)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    def state_tree(self):
        """``(params, AdamWState(step, mu, nu))`` as nested pytrees (views
        of the live tensors, no copies)."""
        st = self.opt_state
        return (nest_state(self.params),
                AdamWState(step=st.step, mu=nest_state(st.mu),
                           nu=nest_state(st.nu)))

    @torch.no_grad()
    def load_state_tree(self, tree) -> None:
        """Copy a ``state_tree``-shaped tree into the live tensors."""
        params, st = tree
        for dst, src in ((self.params, params), (self.opt_state.mu, st.mu),
                         (self.opt_state.nu, st.nu)):
            flat = flat_state(src)
            if set(flat) != set(dst):
                raise ValueError(f"state holds {sorted(flat)}, the model "
                                 f"{sorted(dst)}")
            for name, t in flat.items():
                dst[name].copy_(t)
        self.opt_state = self.opt_state._replace(
            step=st.step.to(self.opt_state.step))


def state_specs(pspecs: dict):
    """The spec tree of a ``state_tree``: ``(params' specs,
    AdamWState(P(), specs, specs))``, as the reference trainer saves."""
    ost = shard_lib.opt_state_specs(pspecs)
    return (nest_state(pspecs),
            AdamWState(step=ost.step, mu=nest_state(ost.mu),
                       nu=nest_state(ost.nu)))


@torch.no_grad()
def _assign(dst: ShardedTensor, src) -> None:
    """Copy ``src`` (a tensor, or a ``ShardedTensor`` on any mesh and
    spec) into ``dst``'s shards."""
    local = dst.mesh.local_positions
    if isinstance(src, ShardedTensor) and src.spec == dst.spec and \
            src.mesh.devices.shape == dst.mesh.devices.shape:
        for pos in local:
            dst.shards[pos].copy_(src.shards[pos])
        return
    full = src.gather() if isinstance(src, ShardedTensor) else src
    for pos in local:
        dst.shards[pos].copy_(
            full[partition.block(dst.shape, dst.spec, dst.mesh, pos)])


def sharded_loss(model) -> Callable:
    """The sharded loss of a model on a mesh, ``loss_fn(model, batch) ->
    (loss, aux)``: ``transformer.sharded_loss_fn``,
    ``mace.sharded_loss_fn`` or ``recsys.sharded_loss_fn`` by its kind."""
    if isinstance(model, mace.ShardedMACE):
        return functools.partial(mace.sharded_loss_fn, model.cfg)
    if isinstance(model, recsys.ShardedRecsys):
        return functools.partial(recsys.sharded_loss_fn, model.cfg)
    return functools.partial(transformer.sharded_loss_fn, model.cfg)


def sharded_grads(model, batch: dict, loss_fn: Optional[Callable] = None,
                  *, reduce: bool = True):
    """(loss, aux, gradients) of ``loss_fn(model, batch)`` (the model's
    ``sharded_loss`` by default): name -> ``ShardedTensor`` of every
    holder's own gradient, each shard summed over its holders
    (``reduce``) or not."""
    loss_fn = sharded_loss(model) if loss_fn is None else loss_fn
    loss, aux = loss_fn(model, batch)
    names = list(model.params)
    leaves = [s for n in names for s in model.params[n].shards]
    flat = iter(torch.autograd.grad(loss, leaves, materialize_grads=True))
    grads = {}
    for n in names:
        p = model.params[n]
        grads[n] = ShardedTensor(p.mesh, p.spec, p.shape, p.dtype,
                                 [next(flat) for _ in p.shards])
        if reduce:
            partition.reduce_holders_(grads[n])
    return loss, aux, grads


class ShardedTrainer:
    """``Trainer`` for a model laid out on a (data, model) mesh (a
    ``transformer.ShardedTransformer``, a ``mace.ShardedMACE`` or a
    ``recsys.ShardedRecsys``): the same function as the unsharded
    ``Trainer.step``.

    ``loss_fn(model, batch) -> (loss, aux)`` is the model's sharded loss
    (``sharded_loss`` by default). A step differentiates it with respect
    to every shard of every holder; each shard's gradient is then the
    fixed-order sum over its holders (``partition.reduce_holders_``), the
    same bits on each. With ``compress_grads`` each data replica instead
    quantises its own gradient (D times its share of the global loss's
    gradient: its local mean's when the replicas hold equal token counts)
    with its own error buffers, and the reconstructions are averaged over
    ``data`` in replica order. The global-norm clip counts every distinct
    shard once (``clip_by_global_norm_sharded``); AdamW then updates each
    position's shards, its moments and its copy of the step with the
    unsharded arithmetic. Parameters, moments, error buffers and the step
    are name -> ``ShardedTensor`` (the step one replicated scalar).
    """

    def __init__(self, model, loss_fn: Optional[Callable] = None, *,
                 opt: Optional[AdamW] = None, compress_grads: bool = False,
                 opt_state: Optional[AdamWState] = None):
        self.model, self.cfg, self.mesh = model, model.cfg, model.mesh
        self.loss_fn = sharded_loss(model) if loss_fn is None else loss_fn
        self.params = model.params
        self.opt = opt if opt is not None else AdamW(
            learning_rate=LEARNING_RATE)
        self._local_opt = dataclasses.replace(self.opt, clip_norm=None)
        f32 = torch.float32

        def zeros(st):
            return st.map(lambda s: torch.zeros_like(s, dtype=f32), f32)

        self.opt_state = opt_state if opt_state is not None else AdamWState(
            step=partition.zeros((), shard_lib.P(), self.mesh, torch.int32),
            mu={n: zeros(p) for n, p in self.params.items()},
            nu={n: zeros(p) for n, p in self.params.items()})
        # replica d's error buffers are block d of a (D, *shape) leaf laid
        # out P(dp, *spec), dp the mesh's data axes: saved and restored
        # like any other leaf
        D = shard_lib.data_replicas(self.mesh)
        dp = shard_lib.mesh_data_axes(self.mesh)
        self.comp_state = ({n: partition.zeros(
            (D,) + p.shape, shard_lib.P(dp, *p.spec), self.mesh, f32)
            for n, p in self.params.items()} if compress_grads else None)

    def grads(self, batch: dict):
        """(loss, aux, gradients): each holder's own gradient of the
        global loss, not yet summed over holders."""
        return sharded_grads(self.model, batch, self.loss_fn, reduce=False)

    def reduced_grads(self, batch: dict):
        """(loss, aux, gradients summed over their holders)."""
        return sharded_grads(self.model, batch, self.loss_fn)

    def step(self, batch: dict) -> Tuple[Tensor, dict]:
        """One training step on ``batch`` (the loss's: whole tensors, or
        laid out by the input specs); returns (loss, aux), detached,
        computed before the update."""
        if self.comp_state is None:
            loss, aux, grads = self.reduced_grads(batch)
        else:
            loss, aux, grads = self.grads(batch)
            self._compress(grads)
        self.apply(grads)
        # across processes the loss lives on the first position's: every
        # process reads a copy of the same bits
        return (partition.everywhere(loss.detach(), self.mesh),
                {k: partition.everywhere(v.detach(), self.mesh)
                 for k, v in aux.items()})

    @torch.no_grad()
    def _compress(self, grads: dict) -> None:
        """In place: the data replicas' error-feedback mean
        (``compression.error_feedback_mean`` with shards)."""
        mesh = self.mesh
        D = shard_lib.data_replicas(mesh)
        rows = partition.axis_groups(mesh, "model")
        for n, g in grads.items():
            err = self.comp_state[n]
            recs = {}
            for row in rows:
                groups = {}
                for pos in row:
                    groups.setdefault(partition.shard_key(g.spec, mesh, pos),
                                      []).append(pos)
                keys = list(groups)
                mine = [partition.sum_to([g.shards[p] for p in groups[k]],
                                         g.device(groups[k][0]))
                        for k in keys]
                corrected = [m.float() * D + err.shards[groups[k][0]][0]
                             for m, k in zip(mine, keys)]
                rec, resid = comp_lib.compress_decompress_shards(corrected)
                for k, r, e in zip(keys, rec, resid):
                    recs.setdefault(k, []).append(r)
                    for p in groups[k]:
                        partition.copy_into(err.shards[p][0], e, mesh, p)
            means = {k: comp_lib.replica_mean(r).to(g.dtype)
                     for k, r in recs.items()}
            with record_function("mesh.replica_mean"):
                for pos in range(mesh.size):
                    partition.copy_into(g.shards[pos], means[
                        partition.shard_key(g.spec, mesh, pos)], mesh, pos)

    @torch.no_grad()
    def apply(self, grads: dict) -> None:
        """Clip (over the distinct shards) and AdamW-update every
        position's shards with ``grads`` (summed over holders); the
        gradient buffers become the updates."""
        if self.opt.clip_norm is not None:
            clip_by_global_norm_sharded(grads, self.opt.clip_norm)
        st = self.opt_state
        for pos in self.mesh.local_positions:
            local = AdamWState(
                step=st.step.shards[pos],
                mu={n: m.shards[pos] for n, m in st.mu.items()},
                nu={n: v.shards[pos] for n, v in st.nu.items()})
            params = {n: p.shards[pos] for n, p in self.params.items()}
            upd, new = self._local_opt.update(
                {n: g.shards[pos] for n, g in grads.items()}, local, params)
            apply_updates(params, upd)
            st.step.shards[pos] = new.step

    def specs(self) -> dict:
        return {n: p.spec for n, p in self.params.items()}

    def state_tree(self):
        """``(params, AdamWState(step, mu, nu))`` as nested pytrees of
        ``ShardedTensor``, and with ``compress_grads`` a third element
        ``{"error": ...}``: the data replicas' error buffers."""
        st = self.opt_state
        tree = (nest_state(self.params),
                AdamWState(step=st.step, mu=nest_state(st.mu),
                           nu=nest_state(st.nu)))
        if self.comp_state is not None:
            tree += ({"error": nest_state(self.comp_state)},)
        return tree

    def state_specs(self):
        """The spec tree of ``state_tree``."""
        tree = state_specs(self.specs())
        if self.comp_state is not None:
            tree += ({"error": nest_state(
                {n: e.spec for n, e in self.comp_state.items()})},)
        return tree

    def load_state_tree(self, tree) -> None:
        """Copy a ``state_tree``-shaped tree (tensors, or
        ``ShardedTensor`` on any mesh and spec) into the live shards; a
        tree without the error buffers leaves them as they are."""
        params, st = tree[:2]
        if len(tree) > 2:
            for name, t in flat_state(tree[2]["error"]).items():
                _assign(self.comp_state[name], t)
        for dst, src in ((self.params, params), (self.opt_state.mu, st.mu),
                         (self.opt_state.nu, st.nu)):
            flat = flat_state(src)
            if set(flat) != set(dst):
                raise ValueError(f"state holds {sorted(flat)}, the model "
                                 f"{sorted(dst)}")
            for name, t in flat.items():
                _assign(dst[name], t)
        _assign(self.opt_state.step, st.step)


def sharded_lm_trainer(cfg: transformer.TransformerConfig, *, mesh,
                       seed: int, compress_grads: bool = False
                       ) -> ShardedTrainer:
    """``lm_trainer``'s weights (drawn from ``seed`` on the mesh's first
    device, this process's across processes, leaf by leaf) laid out on
    ``mesh``."""
    gen = torch.Generator(device=mesh.local_device).manual_seed(seed)
    return ShardedTrainer(transformer.init_sharded(cfg, mesh, generator=gen),
                          compress_grads=compress_grads)


def sharded_mace_trainer(cfg: mace.MACEConfig, *, mesh, seed: int,
                         compress_grads: bool = False) -> ShardedTrainer:
    """``mace_trainer``'s weights (drawn from ``seed`` on the mesh's first
    device, this process's across processes, leaf by leaf) laid out on
    ``mesh``."""
    gen = torch.Generator(device=mesh.local_device).manual_seed(seed)
    return ShardedTrainer(mace.init_sharded(cfg, mesh, generator=gen),
                          compress_grads=compress_grads)


def sharded_recsys_trainer(cfg: recsys.RecsysConfig, *, mesh, seed: int,
                           compress_grads: bool = False) -> ShardedTrainer:
    """``recsys_trainer``'s weights (drawn from ``seed`` on the mesh's
    first device, this process's across processes, leaf by leaf) laid out
    on ``mesh``."""
    gen = torch.Generator(device=mesh.local_device).manual_seed(seed)
    return ShardedTrainer(recsys.init_sharded(cfg, mesh, generator=gen),
                          compress_grads=compress_grads)


def recsys_trainer(cfg: recsys.RecsysConfig, *, seed: int, device,
                   compress_grads: bool = False) -> Trainer:
    """A ranking model drawn from ``seed`` on ``device``, with AdamW at the
    reference trainer's learning rate."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = recsys.init_params(cfg, generator=gen)
    return Trainer(model, functools.partial(recsys.loss_fn, cfg),
                   compress_grads=compress_grads)


def lm_trainer(cfg: transformer.TransformerConfig, *, seed: int, device,
               compress_grads: bool = False) -> Trainer:
    """An LM drawn from ``seed`` on ``device``, with AdamW at the
    reference trainer's learning rate."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = transformer.init_params(cfg, generator=gen)
    return Trainer(model, functools.partial(transformer.loss_fn, cfg),
                   compress_grads=compress_grads)


def mace_trainer(cfg: mace.MACEConfig, *, seed: int, device,
                 compress_grads: bool = False) -> Trainer:
    """A MACE model drawn from ``seed`` on ``device``, with AdamW at the
    reference trainer's learning rate."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = mace.init_params(cfg, generator=gen)
    return Trainer(model, functools.partial(mace.loss_fn, cfg),
                   compress_grads=compress_grads)


def batch_fn(cfg: recsys.RecsysConfig, *, seed: int, batch: int,
             device) -> Callable[[int], dict]:
    """step -> the click batch of that step, drawn on ``device``."""
    def make(step: int) -> dict:
        return syn.recsys_batch(
            batch, cfg.vocab_sizes, cfg.n_dense,
            generator=syn.batch_generator(seed, step, device))
    return make


def lm_batch_fn(cfg: transformer.TransformerConfig, *, seed: int,
                batch: int, seq: int, device) -> Callable[[int], dict]:
    """step -> the (batch, seq) token batch of that step (``lm_batch``),
    drawn on ``device``."""
    def make(step: int) -> dict:
        return syn.lm_batch(batch, seq, cfg.vocab_size,
                            generator=syn.batch_generator(seed, step, device))
    return make


def gnn_batch_fn(cfg: mace.MACEConfig, *, seed: int, batch: int,
                 device) -> Callable[[int], dict]:
    """step -> the reference trainer's graph batch of that step:
    ``geometric_graph_batch(seed + step)`` of ``batch`` graphs (16 nodes
    and 48 edges each, ``cfg.d_feat`` features), with ``n_graphs``, as
    tensors on ``device``."""
    def make(step: int) -> dict:
        return dict(syn.geometric_graph_batch(
            seed + step, n_nodes=16 * batch, n_edges=48 * batch,
            d_feat=cfg.d_feat, n_graphs=batch, device=device),
            n_graphs=batch)
    return make


def family_trainer(family: str, cfg, *, seed: int, device,
                   compress_grads: bool = False) -> Trainer:
    """``lm_trainer``, ``mace_trainer`` or ``recsys_trainer`` by the
    architecture's family."""
    make = {"lm": lm_trainer, "gnn": mace_trainer,
            "recsys": recsys_trainer}[family]
    return make(cfg, seed=seed, device=device, compress_grads=compress_grads)


def family_batch_fn(family: str, cfg, *, seed: int, batch: int, seq: int,
                    device) -> Callable[[int], dict]:
    """``lm_batch_fn``, ``gnn_batch_fn`` or ``batch_fn`` by the
    architecture's family."""
    if family == "lm":
        return lm_batch_fn(cfg, seed=seed, batch=batch, seq=seq,
                           device=device)
    if family == "gnn":
        return gnn_batch_fn(cfg, seed=seed, batch=batch, device=device)
    return batch_fn(cfg, seed=seed, batch=batch, device=device)


def _laid_out_batch(step: int, *, make, mesh, specs: dict) -> dict:
    """``make(step)``'s arrays laid out on ``mesh`` by ``specs``."""
    return {k: partition.place(v, specs[k], mesh)
            for k, v in make(step).items()}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=64,
                   help="the LM family's sequence length (the GNN and "
                        "recsys families have none)")
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=10)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data-shards", type=int, default=1)
    p.add_argument("--model-shards", type=int, default=1)
    p.add_argument("--compress-grads", action="store_true")
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--fixed-batch", action="store_true",
                   help="every step takes step 0's batch (a smoke run's "
                        "check that the model fits data it has seen)")
    p.add_argument("--layers", type=int, default=None,
                   help="the LM family's depth, cut from the published "
                        "config's (every width kept)")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def train(args: argparse.Namespace, log=print) -> dict:
    """The CLI's loop. Returns ``losses`` and ``step_s`` of the steps run
    (on a mesh, each step's time waits for every card), ``start_step``,
    ``peak_bytes`` (the largest peak allocation of a card during the run,
    None on the CPU) and ``peak_bytes_by_device``, ``batch_shapes`` of the
    first batch (a tensor's shape and dtype; any other entry, such as a
    graph batch's ``n_graphs``, as it is), the ``trainer`` and the
    ``mesh`` (None on one device)."""
    world = None
    if args.multihost:
        # first, as the reference calls jax.distributed.initialize()
        world = process.initialize(args.device, log=log)
        log = functools.partial(_process_log, log, world.index)
    dev = resolve_device(args.device)
    spec = C.get_arch(args.arch)
    cfg = spec.make_reduced() if args.reduced else spec.make_config()
    if args.layers is not None:
        if spec.family != "lm":
            raise ValueError("--layers cuts an LM's depth")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    mesh = None
    if args.data_shards * args.model_shards > 1 or world is not None:
        mesh = make_host_mesh(args.data_shards, args.model_shards,
                              device=args.device)
    if world is not None:  # batches are drawn on this process's first device
        dev = mesh.local_device
    cards = ([] if mesh is None and dev.type != "cuda" else
             [dev] if mesh is None else
             [d for d in dict.fromkeys(mesh.devices.flat)
              if d.type == "cuda"])
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    if mesh is None:
        trainer = family_trainer(spec.family, cfg, seed=args.seed,
                                 device=dev,
                                 compress_grads=args.compress_grads)
        specs = state_specs(shard_lib.param_specs(spec.family,
                                                  trainer.params))
    else:
        make = {"lm": sharded_lm_trainer, "gnn": sharded_mace_trainer,
                "recsys": sharded_recsys_trainer}[spec.family]
        trainer = make(cfg, mesh=mesh, seed=args.seed,
                       compress_grads=args.compress_grads)
        specs = trainer.state_specs()
        log(f"mesh {dict(mesh.shape)} on "
            f"{[str(d) for d in mesh.devices.flat]}")
    make_batch = family_batch_fn(spec.family, cfg, seed=args.seed,
                                 batch=args.batch, seq=args.seq, device=dev)
    if args.fixed_batch:
        make_batch = functools.partial(lambda step, make: make(0),
                                       make=make_batch)
    if mesh is not None and spec.family == "recsys":
        # sparse, dense and labels over data (recsys_input_shardings)
        make_batch = functools.partial(
            _laid_out_batch, make=make_batch, mesh=mesh,
            specs=shard_lib.recsys_input_shardings("train", False)["batch"])

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        like = trainer.state_tree()
        stored = ckpt.shapes()
        if any(stored.get(n) != tuple(x.shape) for n, x in leaf_paths(like)
               if n.startswith("2__")):
            # saved without compression, or by another number of data
            # replicas: the error buffers start from zero
            like = like[:2]
            log("error-feedback buffers start from zero (the checkpoint "
                "holds none for this mesh's data replicas)")
        start_step, tree = ckpt.restore(
            like=like, mesh=mesh, strict=mesh is None or len(like) > 2)
        trainer.load_state_tree(tree)
        del tree
        log(f"resumed from step {start_step}")

    monitor = StepMonitor()
    main_thread = threading.current_thread() is threading.main_thread()
    prev_handler = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard(install_signal=True)
    pipeline = PrefetchPipeline(make_batch, start_step=start_step)
    losses, step_s, batch_shapes = [], [], None
    try:
        for _ in range(args.steps - start_step):
            step, batch = next(pipeline)
            if batch_shapes is None:
                batch_shapes = {
                    k: (tuple(v.shape), v.dtype)
                    if isinstance(v, (torch.Tensor, ShardedTensor)) else v
                    for k, v in batch.items()}
            t0 = time.perf_counter()
            loss, _ = trainer.step(batch)
            loss = float(loss)  # waits for the step
            if mesh is not None:  # and for every card's update
                partition.synchronize(mesh)
            dt = time.perf_counter() - t0
            losses.append(loss)
            step_s.append(dt)
            # every process takes the same decisions: the slowest step time
            # and any process's preemption flag
            dt, preempt = _agreed(dt, guard.should_save())
            ev = monitor.record(step, dt)
            if ev:
                log(f"straggler flagged at step {step}: "
                    f"{ev.ratio:.1f}x EMA ({ev.step_time:.2f}s)")
            if monitor.should_escalate and ckpt:
                log("straggler patience exhausted -> checkpoint + escalate")
                ckpt.wait()
                ckpt.save(step + 1, trainer.state_tree(), specs)
            if not np.isfinite(loss):
                raise FloatingPointError(f"loss diverged at step {step}")
            if step % 5 == 0 or step == args.steps - 1:
                log(f"step {step}: loss={loss:.4f} ({dt * 1e3:.0f} ms)")
            if ckpt and ((step + 1) % args.ckpt_every == 0 or preempt):
                ckpt.save_async(step + 1, trainer.state_tree(), specs)
                if preempt:
                    ckpt.wait()
                    log(f"preemption save at step {step + 1}")
                    break
    finally:
        pipeline.close()
        if ckpt:
            ckpt.wait()
        if main_thread:
            signal.signal(signal.SIGTERM, prev_handler)
    peaks = {str(d): torch.cuda.max_memory_allocated(d) for d in cards}
    peak = max(peaks.values()) if peaks else None
    if peak is not None:
        log(f"peak device memory {peak / 1e9:.2f} GB" + (
            f" (by card: { {k: round(v / 1e9, 2) for k, v in peaks.items()} })"
            if len(peaks) > 1 else ""))
    log("done")
    return {"losses": losses, "step_s": step_s, "start_step": start_step,
            "peak_bytes": peak, "peak_bytes_by_device": peaks,
            "batch_shapes": batch_shapes, "trainer": trainer, "mesh": mesh,
            "backend": None if world is None else world.backend}


def _process_log(log, index: int, msg: str) -> None:
    log(f"[process {index}] {msg}")


def _agreed(step_s: float, preempt: bool) -> Tuple[float, bool]:
    """(the slowest process's step time, whether any process is being
    preempted): one host-side all-gather across processes."""
    got = process.all_gather_object((step_s, bool(preempt)))
    return max(t for t, _ in got), any(p for _, p in got)


def main(argv=None) -> dict:
    args = parse_args(argv)
    try:
        return train(args)
    finally:
        if args.multihost:
            process.shutdown()


if __name__ == "__main__":
    main()
