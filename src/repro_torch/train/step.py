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
model axis included), as the reference's ``batch_spec`` places it.  Each
parameter leaf, and AdamW's two moments, is this process's block under
``sharding/specs.py::build_param_specs``; the model reads it whole
(``sharding/gather.py``), and the gather's backward reduce-scatters the
whole leaf's gradient back to the block, summed over the axes that split
the leaf.

Where the model group holds the rows replicated, it shares each block's
dense products (``sharding/tp.py``): attention by whole heads (unevenly
where they do not divide), zamba2's Mamba layers by SSM heads, the MLP on
d_ff and the loss's logits by vocab, each on the leaves' "model" blocks or
on the process's share cut from a whole leaf, summed over the group.

The gradients.  Each process scales its loss by ``1 / world``
(``RowBlock.share``), and every collective on the loss's path has as its
backward the adjoint with respect to the sum of all the processes' losses:
the gather's reduce-scatter (``sharding/gather.py::GatherLeaf``, for the
leaves and for the MoE layer's row gather), and the sum over the model
group (``sharding/tp.py::SumOverGroup``: the tensor-parallel products',
the loss's and the MoE masked branch's), whose backward is a sum too.
Block b of the rows, held by ``replicas`` processes, enters that sum
``replicas / world x mean_b = mean_b / count`` times: the world's sum is
the global batch's mean over its ``count`` equal blocks, whether the model
group splits the rows or holds them replicated.  So a block's gradient is
the global loss's once it is summed over the axes the leaf is *not* split
on, one ``all_reduce`` a bucket of one dtype and at most ``BUCKET_BYTES``
for each such set of axes (a leaf split on none is summed over the world
at once).  Where the rows are replicated over "model":

  * a leaf that keeps its "model" block for a tensor-parallel product
    (``wq``/``wo`` of heads that divide, the MLP's, ``lm_head``) has a
    gradient of its block alone, already whole: the sum over the group at
    the product's output gave each process the cotangent of every
    process's loss.  "model" splits it, so it is not summed over "model"
    (before tensor-parallel compute the gather's reduce-scatter summed its
    whole gradient there);
  * a leaf that "model" does not split (the norms, the router, a bias
    after a sum) holds in each process that process's share: the entry of
    a tensor-parallel product passes each process's own heads' or
    columns' cotangent, and the MoE layer routes a different share of the
    group's tokens in each process.  It is summed over "model" as before;
    so is, by the gather's reduce-scatter, a leaf "model" splits but the
    product reads whole (``wk``/``wv`` whose KV heads do not divide, the
    attention of heads that do not, Mamba's ``in_proj``, ``embed``): each
    process's gradient of it is nonzero only on the share it computed on.

The sets of axes and the buckets are the same with or without
tensor-parallel compute.  AdamW's global norm sums each leaf's squared
norm over the axes that split it, the same axes.  The reported loss is
summed over the world, the capacity drops too, counting each token once.

On the CPU the tensor-parallel cases run in gloo worlds:
``python -m pytest -q tests/test_torch_dist_p4.py tests/test_torch_dist_p8.py -k
"placed or tp_train"`` (the step on (data 2, model 2) and (data 2, model 4)
against one process)
and ``tests/test_torch_tp.py`` (the blocks' algebra on one process).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..models.registry import Model
from ..optim import adamw
from ..sharding.gather import leaf_specs, norm_axes, reduce_axes
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
    (``RowBlock.share``): the module docstring derives why the world's sum
    of the losses and of the gradients is then the global batch's mean,
    whether the model group splits the rows or holds them replicated.
    Where data x model divides the batch, ``replicas`` is 1 and the
    placement is data x model.
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


def _reduce_sets(model: Model, grads):
    """(gradient blocks, the process groups to sum them over): the leaves
    grouped by the mesh axes of more than one process that do not split
    them, in leaf order; all of the mesh's axes: the world, at once."""
    place, mesh = model.placement, model.ctx.mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    specs = leaf_specs(place) or [()] * len(grads)
    sets: Dict[tuple, list] = {}
    for g, spec in zip(grads, specs):
        sets.setdefault(reduce_axes(spec, sizes), []).append(g)
    every = tuple(a for a, s in sizes.items() if s > 1)
    return [(ts, (None,) if axes == every else tuple(mesh.get_group(a) for a in axes))
            for axes, ts in sets.items() if axes]


def norm_groups(model: Model) -> Optional[list]:
    """Per leaf in leaf order, the process groups over which AdamW's global
    norm sums its block's squared norm (the axes that split it); ``None``
    without a placement."""
    specs = leaf_specs(model.placement)
    if specs is None:
        return None
    mesh = model.ctx.mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return [tuple(mesh.get_group(a) for a in norm_axes(s, sizes)) for s in specs]


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
        for ts, groups in _reduce_sets(model, grads):
            _all_reduce_flat(ts, groups)
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
    split = norm_groups(model)

    def train_step(params, opt_state, batch, *, stats: Optional[dict] = None,
                   times: Optional[Dict[str, float]] = None):
        phases = _Phases(times, model.ctx.device)
        loss, grads = loss_and_grads(model, params, batch, window=window, stats=stats,
                                     phases=phases)
        if split is None:
            params, opt_state, metrics = adamw.update(opt_cfg, params, grads, opt_state)
        else:
            params, opt_state, metrics = adamw.update(opt_cfg, params, grads, opt_state,
                                                      split=split)
        phases.mark("optimizer")
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


def make_eval_step(model: Model, *, window=None):
    @torch.no_grad()
    def eval_step(params, batch):
        return model.loss(params, batch, window=window)
    return eval_step
