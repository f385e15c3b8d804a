"""Training entry point of the port: the LM family (``qwen1.5-0.5b``,
``gemma2-2b``, ``granite-8b``, ``granite-moe-3b-a800m``,
``qwen2-moe-a2.7b``) and the recsys family (``dlrm-rm2``, ``autoint``,
``wide-deep``, ``xdeepfm``) with checkpoint/restart, straggler monitoring,
preemption-aware saves and optional gradient compression (PyTorch
counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --reduced --device cpu --steps 12 --seq 64 --ckpt-dir /tmp/ck
    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-rm2 \\
        --reduced --device cpu --steps 12 --ckpt-dir /tmp/ck
    # the same command with --resume continues from the newest checkpoint

Runs on the card unless told ``--device cpu``; without a card it raises.
Batches are a pure function of (seed, step), drawn on the training device
and prefetched by a background thread, so a resumed run on the same
device takes the same steps, bit for bit: every operation of the step is
deterministic on one CUDA stream (the embedding gather's backward sorts
its ids, the reductions and GEMMs have fixed orders). An LM batch is
``--batch`` x ``--seq`` tokens of ``lm_batch``.

The GNN family (ROADMAP A, item 2), ``--data-shards`` / ``--model-shards``
> 1 and ``--multihost`` (the reference's GSPMD sharding: ROADMAP A, item
3) raise.
"""
from __future__ import annotations

import argparse
import functools
import signal
import threading
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import configs as C
from repro_torch.checkpoint.checkpoint import (
    CheckpointManager,
    flat_state,
    nest_state,
)
from repro_torch.data import synthetic as syn
from repro_torch.data.pipeline import PrefetchPipeline
from repro_torch.distributed.fault import PreemptionGuard, StepMonitor
from repro_torch.models import recsys, transformer
from repro_torch.optim import AdamW, AdamWState, apply_updates
from repro_torch.optim import compression as comp_lib

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
        grads = dict(zip(self.params, torch.autograd.grad(
            loss, list(self.params.values()))))
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


def family_trainer(family: str, cfg, *, seed: int, device,
                   compress_grads: bool = False) -> Trainer:
    """``lm_trainer`` or ``recsys_trainer`` by the architecture's family."""
    make = lm_trainer if family == "lm" else recsys_trainer
    return make(cfg, seed=seed, device=device, compress_grads=compress_grads)


def family_batch_fn(family: str, cfg, *, seed: int, batch: int, seq: int,
                    device) -> Callable[[int], dict]:
    """``lm_batch_fn`` or ``batch_fn`` by the architecture's family."""
    if family == "lm":
        return lm_batch_fn(cfg, seed=seed, batch=batch, seq=seq,
                           device=device)
    return batch_fn(cfg, seed=seed, batch=batch, device=device)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=64,
                   help="the LM family's sequence length (the recsys "
                        "family has none)")
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=10)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data-shards", type=int, default=1)
    p.add_argument("--model-shards", type=int, default=1)
    p.add_argument("--compress-grads", action="store_true")
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def train(args: argparse.Namespace, log=print) -> dict:
    """The CLI's loop. Returns ``losses`` and ``step_s`` of the steps run,
    ``start_step``, ``peak_bytes`` (the card's peak allocation during the
    run, None on the CPU), ``batch_shapes`` of the first batch and the
    ``trainer``."""
    dev = resolve_device(args.device)
    if args.multihost or args.data_shards * args.model_shards > 1:
        raise NotImplementedError(
            "--multihost and --data-shards / --model-shards > 1 need the "
            "reference's GSPMD partitioning (distributed/sharding.py), "
            "which the port does not have yet (ROADMAP A, item 3)")
    spec = C.get_arch(args.arch)
    cfg = spec.make_reduced() if args.reduced else spec.make_config()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    trainer = family_trainer(spec.family, cfg, seed=args.seed, device=dev,
                             compress_grads=args.compress_grads)
    make_batch = family_batch_fn(spec.family, cfg, seed=args.seed,
                                 batch=args.batch, seq=args.seq, device=dev)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        start_step, tree = ckpt.restore(like=trainer.state_tree())
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
                batch_shapes = {k: (tuple(v.shape), v.dtype)
                                for k, v in batch.items()}
            t0 = time.perf_counter()
            loss, _ = trainer.step(batch)
            loss = float(loss)  # waits for the step
            dt = time.perf_counter() - t0
            losses.append(loss)
            step_s.append(dt)
            ev = monitor.record(step, dt)
            if ev:
                log(f"straggler flagged at step {step}: "
                    f"{ev.ratio:.1f}x EMA ({ev.step_time:.2f}s)")
            if monitor.should_escalate and ckpt:
                log("straggler patience exhausted -> checkpoint + escalate")
                ckpt.wait()
                ckpt.save(step + 1, trainer.state_tree())
            if not np.isfinite(loss):
                raise FloatingPointError(f"loss diverged at step {step}")
            if step % 5 == 0 or step == args.steps - 1:
                log(f"step {step}: loss={loss:.4f} ({dt * 1e3:.0f} ms)")
            if ckpt and (
                (step + 1) % args.ckpt_every == 0 or guard.should_save()
            ):
                ckpt.save_async(step + 1, trainer.state_tree())
                if guard.should_save():
                    ckpt.wait()
                    log(f"preemption save at step {step + 1}")
                    break
    finally:
        pipeline.close()
        if ckpt:
            ckpt.wait()
        if main_thread:
            signal.signal(signal.SIGTERM, prev_handler)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    if peak is not None:
        log(f"peak device memory {peak / 1e9:.2f} GB")
    log("done")
    return {"losses": losses, "step_s": step_s, "start_step": start_step,
            "peak_bytes": peak, "batch_shapes": batch_shapes,
            "trainer": trainer}


def main(argv=None) -> dict:
    return train(parse_args(argv))


if __name__ == "__main__":
    main()
