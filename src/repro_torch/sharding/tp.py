"""Tensor-parallel compute: a model group shares a block's dense products.

Where the train step's rows are replicated over the model group
(``RowBlock.split_over_model`` false: data x model does not divide the
batch), the reference's partitioned step computes each product on the
group's "model" block of its weight, as XLA's partitioner places it from
``sharding/specs.py``'s rules: attention by whole query heads, the dense
MLP and SwiGLU on d_ff (column-parallel in, row-parallel out), zamba2's
Mamba layers by SSM heads, xLSTM's mLSTM layers by value columns and its
sLSTM layers by channels, the loss's logits by vocab.  The port does the
same:

  * ``sharding/gather.py::placement`` keeps those leaves' "model" blocks
    (gathered over their other axes only) and hands each block a
    :class:`TensorParallel`, this process's place in the model group;
  * ``models/layers.py`` computes on the blocks: ``attention_forward`` on
    the process's query heads (:meth:`TensorParallel.heads`) and the KV
    heads they read, ``swiglu`` and ``mlp`` on the d_ff block,
    ``models/ssm.py`` on the process's SSM heads, ``models/xlstm.py`` on
    the process's value columns (:func:`value_columns`) or channels; a
    row-parallel output is
    a partial sum, summed over the group by :meth:`TensorParallel.sum`
    (:class:`SumOverGroup`), and a bias after it is added once, after the
    sum;
  * ``models/registry.py::Model.loss`` takes the logits' vocab block and
    computes the NLL from the blocks (:func:`vocab_parallel_nll`).

Heads that do not divide the group.  The reference's counts suggest that
XLA pads H heads to a multiple of m (40 over 16 to 48, 3 a device); the
port splits whole heads unevenly (:func:`head_range`: rank 0 holds
``ceil(H / m)``, the padded share, some ranks none where ``H < m``).
Their leaves' "model" blocks are then not whole heads, so they stay
gathered whole over "model" and each process uses a slice of the whole
leaf: the columns of its heads in ``wq``/``bq`` (whisper's ``wk``/``wv``
too), the rows of ``wo``, and the columns of the KV heads its heads read
in ``wk``/``wv``/``bk``/``bv`` (``layers.local_heads``, ``_local_qkv``);
Mamba's ``in_proj`` likewise, always (its "model" block of contiguous
columns cuts across its five groups: ``ssm.py::_local``), and
``A_log``/``D``/``dt_bias`` (replicated).  The gather's backward (a
reduce-scatter) then sums the processes' disjoint shares into the whole
leaf's gradient, and a replicated leaf's shares are summed by the step's
all_reduce over "model".  A process of no head adds zeros to the sum and
launches no attention kernel.  Mamba's ``gate_norm`` is an RMSNorm over
the whole ``d_inner``: its sum of squares is summed over the group too.
Where the SSM heads do not divide the group, a Mamba layer runs whole.

xLSTM.  An mLSTM layer splits by the "model" block of ``wv``: process r
computes the value columns ``[r d/m, (r+1) d/m)``, whole heads where m
divides the heads, else ``d/m`` columns of one head where the heads
divide m (4 heads of 192 over 16: 48 columns a process).  Each value
column's recurrence reads q and k of its head over all dk key columns
and no other value column, and ``n`` and the denominator ``n^T q`` are
the head's own, so the scan needs no collective (``mlstm_scan`` at a
value width dv < dk); q and k of a shared head are computed by each
process that holds its columns, from ``wq``/``wk`` read whole.
``gate_norm``'s sum of squares and ``wo``'s output are summed over the
group.  An sLSTM layer splits by channels: its gates and prefix scans
are per channel, ``h`` is gathered over the group before ``up``
(:meth:`TensorParallel.gather_last`, whose backward reduce-scatters, as
the row gather's), each half of ``up`` (read whole) gives the process's
columns of the GEGLU, and ``down``'s output is summed.  A layer runs
whole where m does not divide d, or the value block is neither whole
heads nor a divisor of one.

The adjoints.  Each process scales its loss by ``1 / world`` and every
collective's backward is its adjoint with respect to the sum ``J`` of the
world's losses (``train/step.py``).  Inside a tensor-parallel region:

  * the exit, ``y = sum_r y_r`` over the group, reaches every process's
    loss: ``dJ/dy_r`` is the sum over the group of the cotangents each
    process's copy of ``y`` received.  So the sum's backward is a sum too
    (:class:`SumOverGroup`, the MoE masked branch's Function);
  * the entry needs no collective: process r's copy of the replicated
    input ``x`` feeds only its own block ``y_r``, whose cotangent the exit
    has already made whole.  The identity is the adjoint, and ``x``'s
    gradient in process r is its share: the heads or columns that r
    computes, and its own copy's path through the residual.  The shares
    sum over the group to the gradient of the one replicated ``x``.

So a leaf that keeps its "model" block has a gradient that is its block's
whole: it is summed over the axes that do not split it, "model" not among
them, as before.  A leaf read whole over "model" (a norm, the router,
``wk``/``wv`` whose KV heads do not divide, attention whose heads do not
divide, ``in_proj``) collects the processes' shares: the step's all_reduce over
"model" or the gather's reduce-scatter sums them, as before.  Nothing in
the step's reduction changes; only what the shares hold.

:data:`COUNTS` counts the sums over a group (``"sum"``: the blocks' and the
loss's and ``gate_norm``'s, forward only; a remat recompute counts again), the maxes (``"max"``:
the loss's, a sequence-split decode's) and the gathers of activations
(``"gather"``: the decode's q, k, v over a sequence-split cache, the
sLSTM's ``h``).

Serving (``models/registry.py``: a prefill's ``forward`` and ``decode_step``
on a mesh) places its rows over the data axes only, so the model group
always holds them replicated and takes the same TP use; the logits' vocab
blocks are gathered whole.  The decode's attention follows its cache's
placement (``sharding/specs.py::KVLayout``; ``models/layers.py::attention_decode``).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

#: forward launches over the model group: "sum", "max", "gather"
COUNTS: collections.Counter = collections.Counter()


class SumOverGroup(torch.autograd.Function):
    """``x`` of each process of ``group`` -> their sum, in every process
    (``all_reduce``, the reference's ``psum``).  The backward sums the
    cotangent over the group as well: each process's loss reads the sum, so
    a process's share reaches all the group's losses.  Over one process's
    share of the world's loss (``train/step.py``: ``1 / world`` each, summed
    over the world) that is the gradient of the global loss; the identity
    would leave it short by the group's size, as a slice would the row
    gather's (``sharding/gather.py::GatherLeaf``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This process's place in the model group that shares a block's
    products: the group, its ``size`` m and this process's ``rank`` r."""

    group: object
    size: int
    rank: int

    def sum(self, y: torch.Tensor) -> torch.Tensor:
        """A row-parallel product's partial sums -> their sum over the group."""
        COUNTS["sum"] += 1
        return SumOverGroup.apply(y, self.group)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` of each process of the group -> ``[m, *t.shape]``, in group-rank
        order; no gradient (the serving decode's gather of the new token's q,
        k and v)."""
        COUNTS["gather"] += 1
        out = t.new_empty((self.size * t.shape[0], *t.shape[1:]))
        dist.all_gather_into_tensor(out, t.contiguous(), group=self.group)
        return out.unflatten(0, (self.size, t.shape[0]))

    def gather_last(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` of each process of the group joined along its last dim, in
        group-rank order (the sLSTM's ``h`` of the process's channels ->
        every channel); differentiable: ``sharding/gather.py::GatherLeaf``,
        whose backward reduce-scatters the cotangent back to the block."""
        from .gather import gather_leaf       # gather.py imports this module

        COUNTS["gather"] += 1
        return gather_leaf(t, ((t.dim() - 1, self.group, self.size),))

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s elementwise max over the group, in place; no gradient."""
        COUNTS["max"] += 1
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def heads(self, n_heads: int) -> Tuple[int, int]:
        """(first, count) of this process's query heads: :func:`head_range`."""
        return head_range(n_heads, self.size, self.rank)

    def kv_heads(self, n_heads: int, n_kv: int) -> Tuple[int, int, Optional[List[int]]]:
        """(first, count, index) of the KV heads that this process's query
        heads (:meth:`heads`) read (query head h reads KV head
        ``h // (H / Hkv)``); ``index``: for each local query head, its KV
        head among them, where the local heads do not share them evenly
        (then each gets its own copy), else ``None``.  A process of no
        query head reads none: ``(0, 0, None)``."""
        h0, hq = self.heads(n_heads)
        if hq == 0:
            return 0, 0, None
        g = n_heads // n_kv
        reads = [(h0 + j) // g for j in range(hq)]
        first, count = reads[0], reads[-1] - reads[0] + 1
        even = hq % count == 0 and all(h - first == j // (hq // count)
                                       for j, h in enumerate(reads))
        return first, count, None if even else [h - first for h in reads]


def head_range(n_heads: int, m: int, r: int) -> Tuple[int, int]:
    """(first, count) of the query heads of process ``r`` of ``m``: heads
    ``ceil(r H / m) ... ceil((r+1) H / m) - 1``, contiguous, the counts
    differing by at most one and rank 0 holding the most (``ceil(H / m)``,
    the share a pad of H up to a multiple of m gives each process).  Where
    ``m`` divides H these are the "model" blocks of ``wq``; where ``H < m``
    some processes hold none."""
    first, last = -(-r * n_heads // m), -(-(r + 1) * n_heads // m)
    return first, last - first


def value_columns(n_heads: int, head_dim: int, m: int, r: int
                  ) -> Optional[Tuple[int, int, int, int]]:
    """(first head, heads, first value column within a head, value columns a
    head) of process ``r`` of ``m`` under the mLSTM's split by the "model"
    block of ``wv``: the process takes the value columns ``[r d/m, (r+1)
    d/m)`` of ``d = n_heads * head_dim``, whole heads where ``d/m`` is a
    multiple of the head width (``m`` divides the heads), else ``d/m``
    columns of one head where ``d/m`` divides the head width (the heads
    divide ``m``).  ``None`` where neither holds, or ``m`` does not divide
    ``d``: the layer then runs whole."""
    d = n_heads * head_dim
    if d % m:
        return None
    c = d // m
    if c % head_dim == 0:
        hq = c // head_dim
        return r * hq, hq, 0, head_dim
    if head_dim % c == 0:
        return r * c // head_dim, 1, r * c % head_dim, c
    return None


#: float32 bytes a row chunk of the loss's forward and backward holds
#: (``models/layers.py::nll`` too): a bound on their float32 working set
ROW_CHUNK_BYTES = 1 << 24


def chunk_rows(width: int, nbytes: int = 0) -> int:
    """Rows of ``width`` float32s that make one chunk of at most ``nbytes``
    (:data:`ROW_CHUNK_BYTES` by default; at least one row)."""
    return max(1, (nbytes or ROW_CHUNK_BYTES) // (4 * max(width, 1)))


def row_chunks(rows: int, width: int) -> List[Tuple[int, int]]:
    """[r0, r1) ranges of ``rows`` rows of :func:`chunk_rows` each."""
    step = chunk_rows(width)
    return [(r, min(rows, r + step)) for r in range(0, rows, step)]


def block_max(z: torch.Tensor) -> torch.Tensor:
    """The largest logit of each position over a vocab block, in at least
    float32, no gradient."""
    return z.detach().amax(-1).to(torch.promote_types(z.dtype, torch.float32))


def _parts(z, labels, v0: int, mx):
    """(:func:`block_parts`, the target's index in the block by row, whether
    it lies there), over row chunks of ``z``."""
    f = torch.promote_types(z.dtype, torch.float32)
    v = z.shape[-1]
    zr, mr = z.reshape(-1, v), mx.reshape(-1)
    local = labels.reshape(-1) - v0
    mine = (local >= 0) & (local < v)
    idx = local.clamp(0, v - 1)
    se = torch.cat([torch.exp(zr[a:b].to(f) - mr[a:b, None]).sum(-1)
                    for a, b in row_chunks(zr.shape[0], v)])
    t = torch.gather(zr, -1, idx[:, None])[:, 0].to(f)
    parts = torch.stack([se, torch.where(mine, t, torch.zeros_like(t))])
    return parts.view(2, *z.shape[:-1]), idx, mine


class _BlockParts(torch.autograd.Function):
    """:func:`block_parts`, keeping ``z`` in its own dtype for the backward:
    no float32 copy of the logits, nor their exps, lives past a row chunk.
    The backward: ``dz = g_se * exp(z - mx)``, plus ``g_t`` at the target
    where it lies in the block."""

    @staticmethod
    def forward(ctx, z, labels, v0, mx):
        parts, idx, mine = _parts(z, labels, v0, mx)
        ctx.save_for_backward(z, mx, idx, mine)
        return parts

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        z, mx, idx, mine = ctx.saved_tensors
        f = torch.promote_types(z.dtype, torch.float32)
        v = z.shape[-1]
        zr, mr = z.reshape(-1, v), mx.reshape(-1)
        g = g.reshape(2, -1)
        gt = torch.where(mine, g[1], torch.zeros_like(g[1]))
        dz = torch.empty_like(zr)
        for a, b in row_chunks(zr.shape[0], v):
            d = torch.exp(zr[a:b].to(f) - mr[a:b, None]) * g[0, a:b, None]
            dz[a:b] = d.scatter_add_(-1, idx[a:b, None], gt[a:b, None])
        return dz.view(z.shape), None, None, None


def block_parts(z: torch.Tensor, labels: torch.Tensor, v0: int,
                mx: torch.Tensor) -> torch.Tensor:
    """[2, ...]: a vocab block's ``sum(exp(z - mx))`` and the target's logit
    (0 where the target lies in another block), in at least float32; ``z``
    holds vocab ``v0 ... v0 + z.shape[-1] - 1``, ``mx`` is the max over
    every block (:class:`_BlockParts` under autograd)."""
    if torch.is_grad_enabled() and z.requires_grad:
        return _BlockParts.apply(z, labels, v0, mx)
    return _parts(z, labels, v0, mx)[0]


def nll_from_parts(parts: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """The NLL of each position from the parts summed over the blocks."""
    return torch.log(parts[0]) + mx - parts[1]


def vocab_parallel_nll(z: torch.Tensor, labels: torch.Tensor, v0: int,
                       tp: TensorParallel) -> torch.Tensor:
    """Each position's NLL from this process's vocab block ``z`` (in its own
    dtype; the arithmetic in at least float32):
    the max over the group (``all_reduce(MAX)``, no gradient), then the
    blocks' sums of exps and the target's logit summed over the group in
    one :meth:`TensorParallel.sum`."""
    mx = tp.max(block_max(z))
    return nll_from_parts(tp.sum(block_parts(z, labels, v0, mx)), mx)
