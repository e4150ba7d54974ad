"""Train step factory: loss and gradients by autograd, then AdamW.

Counterpart of ``repro/train/step.py``.  The step takes the parameter tree
as the model holds it (tensors that need no gradient), differentiates the
loss with respect to detached aliases of its leaves, and hands the
gradients to :func:`~repro_torch.optim.adamw.update`, which updates the
parameters in place.  Its metrics are the reference's: ``loss``,
``grad_norm`` and ``lr``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from ..models.registry import Model
from ..optim import adamw
from ..tree import leaves, map_tree, unflatten


class _Phases:
    """Seconds of each phase, each ended by a device synchronise (when asked)."""

    def __init__(self, times: Optional[Dict[str, float]], device):
        self.times = times
        self.cuda = torch.device(device).type == "cuda"
        self.last = time.perf_counter()

    def mark(self, name: str) -> None:
        if self.times is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.times[name] = self.times.get(name, 0.0) + now - self.last
        self.last = now


def loss_and_grads(model: Model, params, batch, *, window=None,
                   stats: Optional[dict] = None, phases: Optional[_Phases] = None):
    """-> (loss, gradient tree shaped like ``params``), by autograd through
    detached aliases of the leaves (``params`` itself needs no gradient)."""
    live = map_tree(lambda p: p.detach().requires_grad_(True), params)
    loss = model.loss(live, batch, window=window, stats=stats)
    if phases is not None:
        phases.mark("forward")
    flat = leaves(live)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    if phases is not None:
        phases.mark("backward")
    return loss.detach(), unflatten(params, grads)


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig, *, window=None):
    """-> ``step(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``step`` also takes ``stats`` (the model's capacity-drop accumulator)
    and ``times``: a dict that, when given, gains the seconds of the
    ``forward``, ``backward`` and ``optimizer`` phases, each ended by a
    ``torch.cuda.synchronize`` on the card (off by default: no sync).
    """

    def train_step(params, opt_state, batch, *, stats: Optional[dict] = None,
                   times: Optional[Dict[str, float]] = None):
        phases = _Phases(times, model.ctx.device)
        loss, grads = loss_and_grads(model, params, batch, window=window, stats=stats,
                                     phases=phases)
        params, opt_state, metrics = adamw.update(opt_cfg, params, grads, opt_state)
        phases.mark("optimizer")
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


def make_eval_step(model: Model, *, window=None):
    @torch.no_grad()
    def eval_step(params, batch):
        return model.loss(params, batch, window=window)
    return eval_step
