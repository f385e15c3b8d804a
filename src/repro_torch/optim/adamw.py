"""AdamW with decoupled weight decay, f32 moments, global-norm clipping
(PyTorch counterpart of ``repro.optim.adamw``).

The reference's arithmetic, not ``torch.optim.AdamW``'s: b2 = 0.95, the
global-norm clip inside ``update``, the weight decay added to the step
direction ``u`` before it is scaled by ``-lr``, and every moment decayed
and every row decayed on every step (a dense update, as the reference's
dense table gradient gives; no lazy or sparse variant).

Parameters, gradients and moments are dicts of tensors keyed by parameter
name. ``update`` works in place, so a full-width embedding table (8.6 GB
in f32) needs no full-size temporary: the moments are updated where they
are, the gradient buffers become the updates, and the elementwise
formula runs over slices of at most ``CHUNK`` elements, in the
reference's order of operations, one rounding per operation.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed import partition

Tensor = torch.Tensor

#: elements of one slice of the elementwise update (64 MiB of f32)
CHUNK = 1 << 24


class AdamWState(NamedTuple):
    step: Tensor              # scalar int32, on the parameters' device
    mu: Dict[str, Tensor]     # first moments (f32)
    nu: Dict[str, Tensor]     # second moments (f32)


def _slices(n: int):
    for lo in range(0, n, CHUNK):
        yield slice(lo, min(lo + CHUNK, n))


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Callable[[Tensor], Tensor] | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: Optional[float] = 1.0

    def init(self, params: Dict[str, Tensor]) -> AdamWState:
        dev = next(iter(params.values())).device
        zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for k, p in params.items()}
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          mu=zeros,
                          nu={k: torch.zeros_like(z) for k, z in zeros.items()})

    def _lr(self, step: Tensor) -> Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return torch.tensor(self.learning_rate, dtype=torch.float32,
                            device=step.device)

    @torch.no_grad()
    def update(self, grads: Dict[str, Tensor], state: AdamWState,
               params: Dict[str, Tensor]
               ) -> Tuple[Dict[str, Tensor], AdamWState]:
        """One step: returns (updates, new state). In place: ``grads`` are
        clipped and then overwritten by the updates (the returned dict
        holds the same buffers), and ``state``'s moments become the new
        state's. ``params`` are read, not written (``apply_updates``). A
        non-contiguous gradient is first replaced in ``grads`` by a
        contiguous copy."""
        step = state.step + 1
        if self.clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, self.clip_norm)
        b1, b2 = self.b1, self.b2
        stepf = step.float()
        bc1 = 1 - torch.pow(b1, stepf)
        bc2 = 1 - torch.pow(b2, stepf)
        neg_lr = -self._lr(step)
        for name, g in grads.items():
            if not g.is_contiguous():  # e.g. a tied embedding's transpose
                g = grads[name] = g.contiguous()
            m, v, p = state.mu[name], state.nu[name], params[name]
            gv, mv, vv, pv = (t.view(-1) for t in (g, m, v, p))
            for s in _slices(gv.numel()):
                gs = gv[s]
                gf = gs.float()  # gs itself when g is f32
                # mu = b1 * m + (1 - b1) * g
                mv[s].mul_(b1).add_(gf * (1 - b1))
                # nu = b2 * v + (1 - b2) * g^2
                vv[s].mul_(b2).add_(torch.square(gf).mul_(1 - b2))
                # u = (mu / bc1) / (sqrt(nu / bc2) + eps) + wd * p
                u = torch.div(mv[s], bc1, out=gs if gf is gs else None)
                u.div_(torch.div(vv[s], bc2).sqrt_().add_(self.eps))
                u.add_(pv[s].float() * self.weight_decay)
                # update = -lr * u, in the parameter's dtype
                u.mul_(neg_lr)
                if u is not gs:
                    gs.copy_(u)
        return grads, AdamWState(step=step, mu=state.mu, nu=state.nu)


@torch.no_grad()
def apply_updates(params: Dict[str, Tensor], updates: Dict[str, Tensor]
                  ) -> Dict[str, Tensor]:
    """p + u for every parameter, in place; returns ``params``."""
    for name, p in params.items():
        p.add_(updates[name])
    return params


def _clip_scale(gn: Tensor, max_norm: float) -> Tensor:
    return torch.clamp_max(
        torch.full_like(gn, max_norm) / torch.clamp_min(gn, 1e-9), 1.0)


def _scale_(g: Tensor, scale: Tensor) -> None:
    if g.dtype == torch.float32:
        g.mul_(scale)
    else:
        g.copy_(g.float().mul_(scale))


@torch.no_grad()
def clip_by_global_norm(grads: Dict[str, Tensor], max_norm: float
                        ) -> Tuple[Dict[str, Tensor], Tensor]:
    """Scale every gradient, in place, by min(1, max_norm / global norm);
    returns (grads, the global norm). Each leaf's norm is one reduction
    (no squared copy), the global norm the norm of those. A leaf of
    another dtype than f32 (bf16) is scaled in f32 and rounded once, as
    the reference's ``(g.astype(f32) * scale).astype(g.dtype)``, never by
    a scale rounded to its dtype first."""
    norms = [torch.linalg.vector_norm(g.float()) for g in grads.values()]
    gn = torch.linalg.vector_norm(torch.stack(norms))
    scale = _clip_scale(gn, max_norm)
    for g in grads.values():
        _scale_(g, scale)
    return grads, gn


@torch.no_grad()
def clip_by_global_norm_sharded(grads: dict, max_norm: float) -> Tensor:
    """``clip_by_global_norm`` over leaves laid out on a mesh
    (``distributed.partition.ShardedTensor``, every holder of a shard
    holding the same bits): the global norm is the norm of each distinct
    shard's norm, so a leaf sharded over the model axis counts each of its
    shards once and a replicated leaf counts once, not once a holder. It
    is taken once, on the mesh's first device, and every shard of every
    holder is scaled by the same scale (across processes, every shard of
    this process's positions, the scale copied to each process). Returns
    the global norm (on the mesh's first device)."""
    first = next(iter(grads.values()))
    mesh, at0 = first.mesh, first.shards[0]   # at mesh position 0
    norms = [partition.send(torch.linalg.vector_norm(s.float()), at0)
             for g in grads.values() for s in g.distinct()]
    gn = torch.linalg.vector_norm(torch.stack(norms))
    scale = partition.everywhere(_clip_scale(gn, max_norm), mesh)
    per_device = {}
    for g in grads.values():
        for pos in mesh.local_positions:
            s = g.shards[pos]
            if s.device not in per_device:
                per_device[s.device] = scale.to(s.device)
            _scale_(s, per_device[s.device])
    return gn
