"""Learning-rate schedules as step -> lr callables (PyTorch counterpart of
``repro.optim.schedules``): a step tensor in, a 0-d f32 tensor out, on the
step's device (no host sync inside a training step)."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(step.float() / total_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)

    return fn


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    def fn(step):
        s = step.float()
        warm = lr * s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total_steps - warmup, 1), 0.0, 1.0)
        cos = lr * (final_frac + (1 - final_frac) * 0.5
                    * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup, warm, cos)

    return fn
