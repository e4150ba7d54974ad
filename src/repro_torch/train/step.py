"""Train step factory: loss and gradients by autograd, then AdamW.

Counterpart of ``repro/train/step.py``.  The step takes the parameter tree
as the model holds it (tensors that need no gradient), differentiates the
loss with respect to detached aliases of its leaves, and hands the
gradients to :func:`~repro_torch.optim.adamw.update`, which updates the
parameters in place.  Its metrics are the reference's: ``loss``,
``grad_norm`` and ``lr``.

Across processes (``model.ctx.mesh``) the step takes the global batch, as
the reference's jitted step does, and each process runs its rows of it
(:func:`shard_batch`): over data x model where that divides the batch,
else over the data axes that divide it and replicated over the rest (the
model axis included), as the reference's ``batch_spec`` places it.  The
run is data-parallel over the row blocks, plus expert parallelism for the
experts.  Each process scales its loss by ``1 / world``; the gradients of
replicated leaves are summed over the world, those of the expert leaves
(this process's block) over the data axes, one ``all_reduce`` a bucket of
one dtype and at most ``BUCKET_BYTES``; AdamW's global norm sums the
expert blocks' squared norms over the model group.  The reported loss is
summed over the world, the capacity drops too, counting each token once.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..models.registry import Model
from ..optim import adamw
from ..sharding.specs import expert_leaf_mask
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


def shard_batch(batch: Dict[str, torch.Tensor], ctx):
    """The global batch -> (this process's rows of it, their
    :class:`~repro_torch.sharding.context.RowBlock`).

    Placed by ``ctx.row_block``: ``count`` distinct blocks, each held by
    ``replicas`` processes.  Each process's loss share stays ``1 / world``
    (``RowBlock.share``), which keeps the sums of the module docstring
    right: the ``replicas`` copies of block b give ``replicas / world x
    mean_b = mean_b / count``, so the world's sum of the losses, and of a
    replicated leaf's gradients, is the global batch's mean over the
    ``count`` equal blocks.  An expert block takes its gradient from the
    tokens of its data block only, routed once in the model group (the
    MoE layer splits replicated rows over it, ``models/moe.py``): summed
    over the data axes it is the global mean's too.  Where data x model
    divides the batch, ``replicas`` is 1 and the placement is data x model.
    """
    first = next(iter(batch.values()))
    rows = ctx.row_block(first.shape[0])
    out = {}
    for k, v in batch.items():
        if v.shape[0] != first.shape[0]:
            raise ValueError(f"the batch's {k} holds {v.shape[0]} rows, not "
                             f"{first.shape[0]}")
        b = v.shape[0] // rows.count
        out[k] = v[rows.index * b:(rows.index + 1) * b]
    return out, rows


def routed_copies(rows, ctx) -> int:
    """How many processes route each token of ``rows`` through the experts:
    the model group routes its replicated rows once (``models/moe.py``), so
    only the replicas over the data axes repeat them."""
    return 1 if rows.split_over_model else rows.replicas // ctx.model_procs


#: the most bytes of gradients one all_reduce's flat buffer gathers
BUCKET_BYTES = 256 << 20


def _buckets(tensors):
    """``tensors`` in order, packed by dtype into buckets of at most
    ``BUCKET_BYTES`` (a larger tensor in a bucket of its own)."""
    done, open_ = [], {}
    for t in tensors:
        size = t.numel() * t.element_size()
        ts, used = open_.get(t.dtype, ([], 0))
        if ts and used + size > BUCKET_BYTES:
            done.append(ts)
            ts, used = [], 0
        open_[t.dtype] = (ts + [t], used + size)
    return done + [ts for ts, _ in open_.values()]


def _all_reduce_flat(tensors, groups) -> None:
    """Sum ``tensors`` in place over each of ``groups``, one all_reduce a
    bucket: a bucket of one tensor is reduced where it lies, one of several
    through a flat buffer (at most ``BUCKET_BYTES`` beyond the gradients)."""
    for ts in _buckets(tensors):
        one = len(ts) == 1 and ts[0].is_contiguous()
        flat = ts[0] if one else torch.cat([t.reshape(-1) for t in ts])
        for g in groups:
            dist.all_reduce(flat, group=g)
        if one:
            continue
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def loss_and_grads(model: Model, params, batch, *, window=None,
                   stats: Optional[dict] = None, phases: Optional[_Phases] = None):
    """-> (loss, gradient tree shaped like ``params``), by autograd through
    detached aliases of the leaves (``params`` itself needs no gradient).

    With a mesh: over this process's rows of the global ``batch``, the
    gradients summed as the module docstring says; the loss is the global
    batch's."""
    ctx = model.ctx
    rows, own = None, stats
    if ctx.mesh is not None:
        if ctx.mesh.size() != dist.get_world_size():
            raise ValueError(f"the mesh spans {ctx.mesh.size()} of "
                             f"{dist.get_world_size()} processes")
        batch, rows = shard_batch(batch, ctx)
        own = None if stats is None else {}
    live = map_tree(lambda p: p.detach().requires_grad_(True), params)
    loss = model.loss(live, batch, window=window, stats=own, rows=rows)
    if ctx.mesh is not None:
        loss = loss * rows.share
    if phases is not None:
        phases.mark("forward")
    flat = leaves(live)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    loss = loss.detach()
    if ctx.mesh is not None:
        sharded = expert_leaf_mask(params)
        _all_reduce_flat([g for g, s in zip(grads, sharded) if not s], (None,))
        _all_reduce_flat([g for g, s in zip(grads, sharded) if s], ctx.data_groups)
        dist.all_reduce(loss)
        if stats is not None:
            dropped = torch.as_tensor(own.get("dropped", 0), device=loss.device)
            dist.all_reduce(dropped)
            stats["dropped"] = stats.get("dropped", 0) + dropped // routed_copies(rows, ctx)
    if phases is not None:
        phases.mark("backward")
    return loss, unflatten(params, grads)


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig, *, window=None):
    """-> ``step(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``step`` also takes ``stats`` (the model's capacity-drop accumulator)
    and ``times``: a dict that, when given, gains the seconds of the
    ``forward``, ``backward`` and ``optimizer`` phases, each ended by a
    ``torch.cuda.synchronize`` on the card (off by default: no sync).
    With a mesh it takes the global batch (see the module docstring).
    """
    sharded = None

    def train_step(params, opt_state, batch, *, stats: Optional[dict] = None,
                   times: Optional[Dict[str, float]] = None):
        phases = _Phases(times, model.ctx.device)
        loss, grads = loss_and_grads(model, params, batch, window=window, stats=stats,
                                     phases=phases)
        nonlocal sharded
        if model.ctx.mesh is None:
            params, opt_state, metrics = adamw.update(opt_cfg, params, grads, opt_state)
        else:
            if sharded is None:
                sharded = expert_leaf_mask(params)
            params, opt_state, metrics = adamw.update(
                opt_cfg, params, grads, opt_state, sharded=sharded,
                group=model.ctx.model_group)
        phases.mark("optimizer")
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


def make_eval_step(model: Model, *, window=None):
    @torch.no_grad()
    def eval_step(params, batch):
        return model.loss(params, batch, window=window)
    return eval_step
