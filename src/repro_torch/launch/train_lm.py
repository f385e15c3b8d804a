"""Train an LM with the production substrate (checkpoint/restart, straggler
monitoring, the deterministic prefetch pipeline), then reduce its token
embeddings with nSimplex Zen (PyTorch counterpart of
``examples/train_lm.py``).

Importable pieces: ``train_lm`` runs the loop and returns (cfg, model,
losses); ``next_token_distributions`` turns a trained model and token
contexts into softmax rows on the probability simplex, the
coordinate-free JSD corpus of the paper's §5.6 experiments.

    PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu \\
        --resume                                   # the restart path
"""
from __future__ import annotations

import argparse
import functools
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import quality, select_references, zen_pdist
from repro_torch.core.metrics import euclidean_pdist
from repro_torch.data import synthetic as syn
from repro_torch.data.pipeline import PrefetchPipeline
from repro_torch.distributed.fault import StepMonitor
from repro_torch.launch.train import Trainer
from repro_torch.models import transformer as tfm
from repro_torch.optim import AdamW

Tensor = torch.Tensor

#: the reference example's learning rate
LEARNING_RATE = 1e-3


def train_lm(steps: int = 40, *, resume: bool = False,
             ckpt_dir: Optional[str] = None, batch: int = 8, seq: int = 64,
             data_seed: int = 0, data: str = "uniform", log=None,
             cfg: Optional[tfm.TransformerConfig] = None, seed: int = 0,
             device=None):
    """Train ``cfg`` (the reduced qwen1.5-0.5b config by default) from
    weights drawn from ``seed``; returns (cfg, model, losses).

    ``ckpt_dir=None`` disables checkpointing; with a directory a
    checkpoint is written every 20 steps (the newest 2 kept) and
    ``resume`` continues from the newest. ``data="markov"`` trains on
    ``lm_markov_batch``'s structured streams, so the learned next-token
    distributions depend on the context (the JSD corpus); ``"uniform"``
    on ``lm_batch``.
    """
    dev = resolve_device(device)
    cfg = cfg if cfg is not None else C.get_arch(
        "qwen1.5-0.5b").make_reduced()
    model = tfm.init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(seed))
    trainer = Trainer(model, functools.partial(tfm.loss_fn, cfg),
                      opt=AdamW(learning_rate=LEARNING_RATE))
    ckpt = CheckpointManager(ckpt_dir, keep=2) if ckpt_dir else None

    start = 0
    if resume and ckpt is not None and ckpt.latest_step() is not None:
        start, tree = ckpt.restore(like=trainer.state_tree())
        trainer.load_state_tree(tree)
        del tree
        if log:
            log(f"resumed at step {start}")

    if data == "markov":
        def make(s):
            return syn.lm_markov_batch(data_seed, s, batch, seq,
                                       cfg.vocab_size, device=dev)
    elif data == "uniform":
        def make(s):
            return syn.lm_batch(batch, seq, cfg.vocab_size,
                                generator=syn.batch_generator(data_seed, s,
                                                              dev))
    else:
        raise ValueError(f"data must be 'uniform' or 'markov', got {data!r}")

    monitor = StepMonitor()
    pipe = PrefetchPipeline(make, start_step=start)
    losses = []
    try:
        for _ in range(steps - start):
            step, batch_ = next(pipe)
            t0 = time.perf_counter()
            loss = float(trainer.step(batch_)[0])
            monitor.record(step, time.perf_counter() - t0)
            losses.append(loss)
            if log and step % 10 == 0:
                log(f"step {step}: loss={loss:.3f}")
            if ckpt is not None and (step + 1) % 20 == 0:
                ckpt.save_async(step + 1, trainer.state_tree())
    finally:
        pipe.close()
        if ckpt is not None:
            ckpt.wait()
    return cfg, model, losses


@torch.no_grad()
def next_token_distributions(cfg: tfm.TransformerConfig,
                             model: tfm.Transformer, tokens: Tensor, *,
                             temperature: float = 1.0) -> Tensor:
    """Softmax next-token rows: (N, S) contexts -> (N, padded vocab) f32.

    Each row is the model's next-token distribution after its context: a
    point on the probability simplex (rows sum to 1), an object of the
    coordinate-free Jensen-Shannon space. The softmax runs over the
    padded vocabulary, whose masked columns come out exactly 0.
    ``temperature > 1`` smooths the rows away from the one-hot corners
    where pairwise JSD saturates at its maximum. Only the last position's
    logits are formed (``transformer.last_token_logits``; the reference
    slices them from the whole sequence's).
    """
    tokens = torch.as_tensor(tokens, device=model.embed.device)
    last = tfm.last_token_logits(cfg, model, tokens) / float(temperature)
    return torch.softmax(last, dim=-1)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    p.add_argument("--device", default=None, help="cuda (the default) or "
                   "cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg, model, losses = train_lm(args.steps, resume=args.resume,
                                  ckpt_dir=args.ckpt_dir, log=print,
                                  device=args.device)
    if losses:
        assert losses[-1] < losses[0], "loss must decrease"
        print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
              f"{len(losses)} steps")

    # nSimplex Zen over the learned embedding space
    emb = model.embed.detach()[:2000].float()
    tr = select_references(emb, 16,
                           generator=torch.Generator().manual_seed(7))
    red = tr.transform(emb)
    d_true = euclidean_pdist(emb[:300], emb[:300]).cpu().numpy()
    d_zen = zen_pdist(red[:300], red[:300]).cpu().numpy()
    mask = np.triu(np.ones((300, 300), bool), 1)
    stress = quality.kruskal_stress(d_true[mask], d_zen[mask])
    rho = quality.spearman_rho(d_true[mask], d_zen[mask])
    print(f"embedding space {emb.shape[1]}d -> 16d: kruskal={stress:.4f} "
          f"rho={rho:.4f}")
    return {"losses": losses, "kruskal": stress, "rho": rho}


if __name__ == "__main__":
    main()
