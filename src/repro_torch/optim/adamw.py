"""AdamW, functional, as the reference writes it (``repro/optim/adamw.py``).

Decoupled weight decay (Loshchilov & Hutter), bias-corrected moments,
global-norm gradient clipping, and a cosine schedule with linear warm-up.
The moments are float32 whatever the parameters' dtype (float64 for
float64 leaves); each leaf is updated in float32 (or float64) and cast back
to its dtype.  ``torch.optim.AdamW`` is
not used: for bfloat16 parameters it keeps bfloat16 moments, and the
reference does not.

Unlike the reference, :func:`update` updates the parameters, the moments
and the gradients (clipped) in place and returns the same tensors: at
paper-moe-8e's 1.92 B parameters a copy of parameters and moments would
cost 19 GB of device memory.  The schedule and the bias corrections are
host float32 scalars (the step count is a host integer), so a step reads
nothing back from the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..tree import leaves, map_tree

_F32 = np.float32


def _up(dtype: torch.dtype) -> torch.dtype:
    """At least float32: a float64 leaf keeps float64 moments and norms."""
    return torch.promote_types(dtype, torch.float32)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    m: Any
    v: Any
    step: int


def init(params) -> OptState:
    zeros = map_tree(lambda p: torch.zeros_like(p, dtype=_up(p.dtype)), params)
    return OptState(m=zeros, v=map_tree(torch.zeros_like, zeros), step=0)


def schedule(cfg: AdamWConfig, step: int) -> float:
    """The learning rate at ``step``, in float32 as the reference computes it."""
    s = _F32(step)
    warm = min(s / _F32(max(cfg.warmup_steps, 1)), _F32(1.0))
    t = _F32((step - cfg.warmup_steps) / _F32(max(cfg.total_steps - cfg.warmup_steps, 1)))
    t = min(max(t, _F32(0.0)), _F32(1.0))
    cos = _F32(0.5) * (_F32(1.0) + np.cos(_F32(math.pi) * t, dtype=_F32))
    frac = _F32(cfg.min_lr_frac) + (_F32(1.0) - _F32(cfg.min_lr_frac)) * cos
    return float(_F32(cfg.lr) * warm * frac)


def global_norm(tree, split: Optional[Sequence[tuple]] = None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, as a float32 device scalar
    (float64 where a leaf is float64).

    ``split``: per leaf (in leaf order), the process groups over which this
    process holds one block of it (the axes that split it,
    ``train/step.py::norm_groups``); its squared norm is summed over each of
    them (one ``all_reduce`` a group, over the leaves it splits) before the
    sum over leaves, which keeps its order.  A leaf that no group splits is
    whole, or a copy, in every process, and is counted once.

    Each leaf's norm is the norm of its rows' norms, in float32: one pass
    that reads the leaf once on either device.  The CPU's float32 norm of a
    whole leaf of millions of elements drifts far from the reference's
    float32 sum, its rows' norms do not; and a float64 accumulator would
    make the card copy each bf16 leaf to float64 before it reduces.
    """
    norms = [torch.linalg.vector_norm(
        torch.linalg.vector_norm(x, 2, dim=-1, dtype=_up(x.dtype)), 2) for x in leaves(tree)]
    out = torch.float64 if any(n.dtype == torch.float64 for n in norms) else torch.float32
    sq = torch.stack([n.double() for n in norms]) ** 2
    if split is not None and any(split):
        sq = list(sq.unbind())
        for group in dict.fromkeys(g for gs in split for g in gs):
            idx = [i for i, gs in enumerate(split) if group in gs]
            part = torch.stack([sq[i] for i in idx])
            dist.all_reduce(part, group=group)
            for j, i in enumerate(idx):
                sq[i] = part[j]
        sq = torch.stack(sq)
    return torch.sqrt(torch.sum(sq)).to(out)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, split: Optional[Sequence[tuple]] = None):
    """Scales the leaves in place by min(1, max_norm / norm); -> (grads, norm).
    ``split`` as in :func:`global_norm`."""
    norm = global_norm(grads, split)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm


@torch.no_grad()
def update(cfg: AdamWConfig, params, grads, state: OptState, *,
           split: Optional[Sequence[tuple]] = None) -> Tuple[Any, OptState, dict]:
    """One AdamW step over every leaf, in place; -> (params, state, metrics).

    Over a mesh ``params``, ``grads`` and the moments are this process's
    blocks (``init`` of the blocks gives moments of their shape), and the
    update is elementwise on them; ``split`` as in :func:`global_norm`."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, split)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = float(_F32(1.0) - _F32(b1) ** _F32(step))
    bc2 = float(_F32(1.0) - _F32(b2) ** _F32(step))
    # g and p enter the float32 ops as they are: each op promotes them to
    # float32, and p.sub_ rounds the float32 result to p's dtype once, as the
    # reference's astype does, without float32 copies of either
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m), leaves(state.v)):
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        delta.add_(p, alpha=cfg.weight_decay)
        p.sub_(delta, alpha=lr)
    return params, OptState(state.m, state.v, step), {"grad_norm": gnorm, "lr": lr}
