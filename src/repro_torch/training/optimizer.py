"""AdamW and its schedule over the port's nested-dict param trees
(``repro.training.optimizer``).

The update is ``repro``'s: f32 moments whatever the param dtype, f32
math, the result cast back to the param dtype, the gradient clipped by its
global norm first (and, as in ``repro``, rounded back to the gradient's
dtype). ``torch.optim.AdamW`` keeps bf16 moments for bf16 params and so
computes another update. The update runs in place under ``no_grad``, the
counterpart of ``repro``'s donated train state: no second copy of the
params or moments is made, and each leaf's f32 temporaries are taken
``_CHUNK`` elements at a time.

Leaves are visited in sorted key order, as ``jax.tree`` flattens a dict,
so the global norm adds them in ``repro``'s order. Scalars of the
schedule (the learning rate, the bias corrections) are f32, computed on
the host from the step count, so nothing waits on the device.

On a mesh the params are DTensors and the moments follow them
(``adamw_init`` makes them with the params' placements, the
``sharding.opt_state_specs`` rule). The global norm is then the norm of
the whole tree, computed on the DTensors, and the elementwise update runs
on each rank's local shards of the param, its gradient (redistributed to
the param's placements) and both moments, which share one layout.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.tree import leaves, tree_map

Params = Dict[str, Any]
_CHUNK = 1 << 24


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32, on the host
    mu: Params
    nu: Params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio * lr``; f32 on
    the host."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, decay)


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares; a
    0-d f32 tensor on the leaves' device. Of DTensor leaves it is the norm
    of the whole tree, the same plain tensor on every rank."""
    sq = [torch.linalg.vector_norm(x, dtype=torch.float32) ** 2
          for _, x in leaves(tree)]
    sq = [x.full_tensor() if isinstance(x, DTensor) else x for x in sq]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    """(the tree scaled to global norm at most ``max_norm``, each leaf
    scaled in f32 and cast back to its dtype; the norm before clipping)."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def adamw_init(params: Params) -> AdamWState:
    def zeros(p):
        # a DTensor param's moments take its placements
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)
    return AdamWState(step=torch.zeros((), dtype=torch.int32),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def _chunks(*ts: torch.Tensor) -> Iterator[List[torch.Tensor]]:
    """Matching ``_CHUNK``-element slices of flat views of the tensors."""
    flat = [t.view(-1) for t in ts]
    for i in range(0, flat[0].numel(), _CHUNK):
        yield [f[i:i + _CHUNK] for f in flat]


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Params, state: AdamWState,
                 params: Params) -> Tuple[Params, AdamWState, dict]:
    """One AdamW step: params and moments are updated in place and
    returned. Metrics: ``lr`` (f32 on the host) and ``grad_norm`` (the
    norm before clipping, on the device)."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = int(state.step) + 1
    lr = lr_schedule(cfg, step)
    step32 = _f32(step)
    bc1 = float(1 - _f32(cfg.b1) ** step32)
    bc2 = float(1 - _f32(cfg.b2) ** step32)
    b1, b2, lr_ = cfg.b1, cfg.b2, float(lr)
    mu, nu = dict(leaves(state.mu)), dict(leaves(state.nu))
    grads_ = dict(leaves(grads))
    for key, p in leaves(params):
        g, m_, v_ = grads_[key], mu[key], nu[key]
        if isinstance(p, DTensor):
            g = g.redistribute(p.device_mesh, p.placements)
            p, g, m_, v_ = (t.to_local() for t in (p, g, m_, v_))
        if not p.is_contiguous():
            raise ValueError(f"adamw_update: param {key!r} is not "
                             "contiguous; the update writes it in place")
        g = g.contiguous()
        for g_, m, v, p_ in _chunks(g, m_, v_, p):
            # clipped in f32 and rounded to g's dtype, as repro does; every
            # op below computes in f32 and a bf16 param is rounded once
            g32 = (g_ * scale).float()
            m.mul_(b1).add_(g32, alpha=1 - b1)
            v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
            delta = torch.div(m, bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
            delta.add_(p_, alpha=cfg.weight_decay)
            p_.sub_(delta, alpha=lr_)
    new = AdamWState(step=torch.tensor(step, dtype=torch.int32),
                     mu=state.mu, nu=state.nu)
    return params, new, {"lr": lr, "grad_norm": gnorm}
