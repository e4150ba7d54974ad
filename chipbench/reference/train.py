"""The reference's first training steps: the plain model's loss and
gradients (``model.loss``) and AdamW as its published rule states it.

AdamW (Loshchilov and Hutter): the gradient clipped to a global norm of
``clip_norm``, float32 moments with bias correction, decoupled weight
decay, and a linear warm-up into a cosine schedule.  The parameters are
stored in the configuration's parameter dtype: each update is computed in
float32 from the stored value and rounded back to it once.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from . import model

F32 = np.float32


def lr_at(opt: dict, step: int) -> float:
    """The learning rate of step ``step`` (1-based), in float32."""
    s = F32(step)
    warm = min(s / F32(max(opt["warmup_steps"], 1)), F32(1.0))
    t = F32((step - opt["warmup_steps"]) / F32(max(opt["total_steps"] - opt["warmup_steps"], 1)))
    t = min(max(t, F32(0.0)), F32(1.0))
    cos = F32(0.5) * (F32(1.0) + np.cos(F32(math.pi) * t, dtype=F32))
    frac = F32(opt["min_lr_frac"]) + (F32(1.0) - F32(opt["min_lr_frac"])) * cos
    return float(F32(opt["lr"]) * warm * frac)


def _leaves(tree, prefix="") -> Dict[str, torch.Tensor]:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out.update(_leaves(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def _tree(flat: Dict[str, torch.Tensor]):
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


#: leaves that hold one matrix an expert, along their second axis
EXPERT_LEAVES = ("blocks.wg", "blocks.wu", "blocks.wd")


def leaf_norms(flat: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's norm; an expert leaf's by expert (``<leaf>/e<j>``): each
    expert is a parameter of its own, on its own rank."""
    out = {}
    for k, v in flat.items():
        if k in EXPERT_LEAVES:
            per = torch.linalg.vector_norm(v.float().transpose(0, 1).reshape(v.shape[1], -1), dim=1)
            out.update({f"{k}/e{j}": x for j, x in enumerate(per.tolist())})
        else:
            out[k] = float(torch.linalg.vector_norm(v.float()))
    return out


def first_steps(stored, batches: List[Dict[str, torch.Tensor]], cfg: dict, opt: dict,
                prec: str = "f32") -> dict:
    """``len(batches)`` AdamW steps from the parameters ``stored`` (a tree of
    leaves in their stored dtype, which this updates in place).

    -> ``losses`` (each step's), ``raw`` (by :func:`leaf_norms`, the norm
    of the first step's gradient as the optimizer takes it, before its
    clipping) and ``update`` (by :func:`leaf_norms`, the norm of the stored
    parameters' change over all the steps)."""
    flat = _leaves(stored)
    start = {k: v.clone() for k, v in flat.items()}
    m = {k: torch.zeros_like(v, dtype=torch.float32) for k, v in flat.items()}
    v2 = {k: torch.zeros_like(v, dtype=torch.float32) for k, v in flat.items()}
    b1, b2 = opt["beta1"], opt["beta2"]
    losses, raw = [], {}
    for step, batch in enumerate(batches, start=1):
        live = {k: t.to(torch.float32, copy=True).requires_grad_(True) for k, t in flat.items()}
        lo = model.loss(_tree(live), batch["tokens"], batch["labels"], cfg, prec)
        grads = dict(zip(live, torch.autograd.grad(lo, list(live.values()))))
        losses.append(float(lo.detach()))
        del live, lo
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.linalg.vector_norm(g, dtype=torch.float64) ** 2
                                  for g in grads.values())).float()
            scale = torch.clamp(opt["clip_norm"] / torch.clamp(norm, min=1e-9), max=1.0)
            if step == 1:
                raw = leaf_norms(grads)
            for g in grads.values():
                g.mul_(scale)
            lr = lr_at(opt, step)
            bc1 = float(F32(1.0) - F32(b1) ** F32(step))
            bc2 = float(F32(1.0) - F32(b2) ** F32(step))
            for k, p in flat.items():
                g = grads[k]
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                delta = (m[k] / bc1).div_((v2[k] / bc2).sqrt_().add_(opt["eps"]))
                delta.add_(p, alpha=opt["weight_decay"])
                p.sub_(delta, alpha=lr)
        del grads
    update = {}
    for k, p in flat.items():
        update.update(leaf_norms({k: p.float() - start[k].float()}))
    return {"losses": losses, "raw": raw, "update": update}
