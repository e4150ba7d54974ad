"""Gather on use: a parameter leaf held as its block, read whole.

The train step holds every parameter leaf, and AdamW's two moments, as
this process's block under ``specs.build_param_specs`` (FSDP over "data" on
the input dim, "model" on the output columns or input rows, the experts'
expert dim over "model" and their inner dim over "data"), as the reference
places them (``repro/launch/dryrun.py:105-127``).  The models compute on
whole leaves, so each family reads a leaf through :class:`Placement`:

  * :meth:`Placement.whole` gathers a leaf, or a tree of them, over the axes
    its spec splits it on (:class:`GatherLeaf`: ``all_gather_into_tensor``
    forward, ``reduce_scatter_tensor`` backward), block after block in
    ``specs.local_shard``'s order, the first axis of a dim major;
  * an expert leaf keeps its "model" block (each process computes on the
    experts of its EP ranks) and is gathered over its inner "data" dim only;
  * ``models/layers.py::layer`` gathers one layer's leaves when a block
    reads them (inside the block's ``checkpoint`` under remat, so that the
    backward gathers them again rather than keeping every layer whole), and
    each family gathers its top-level leaves where its forward reads them.

A tied or shared leaf (whisper's ``embed`` read twice, zamba2's shared
attention block read at each call) is gathered at each use; autograd sums
the uses' block gradients, which the step then reduces once.

The gather's backward returns the block's gradient summed over the split
axes: the adjoint of ``all_gather`` with respect to the sum of every
process's loss (``train/step.py``).  On a world of one, or for a leaf that
no axis of more than one process splits, a leaf is read as it is and
nothing is launched.  :data:`COUNTS` counts the collectives the Function
launches; :data:`LEAF_GATHERS` the gathers of each leaf by axis.

Where the model group holds the same rows (the train step's
``RowBlock.split_over_model`` false), :func:`placement` with the ``rows``
gives the "TP use" (``sharding/tp.py``): the leaves of the blocks' tensor-parallel
products keep their "model" block and are gathered over their other axes
only: ``wq``/``bq``/``wo`` of an attention whose query heads the model
group divides, and ``wk``/``wv``/``bk``/``bv`` where its KV heads divide
too (else they are read whole, and each process projects the KV heads
its query heads read); ``wg``/``wu``/``wd``/``w1``/``b1``/``w2`` of a dense
MLP (d_ff divides where the spec splits it); a Mamba layer's ``conv_w``,
``conv_b``, ``gate_norm`` and ``out_proj`` where its SSM heads divide;
an mLSTM layer's ``wv``, ``wg``, ``gate_norm`` and ``wo`` (its value
columns) where the model group's blocks of d are whole heads or columns
of one head, and its ``wq``, ``wk``, ``wi``, ``wf`` where they are whole
heads; an sLSTM layer's ``wz``, ``wi``, ``wf``, ``wo_gate`` and ``down``
(its channels); ``lm_head`` on vocab (a tied embedding is read whole and
its vocab rows taken).  Attention whose heads do not divide, Mamba's
``in_proj``, the mLSTM's ``wq``/``wk`` where its heads do not divide and
the sLSTM's ``up`` (whose block would hold one half's columns) are read
whole and each process cuts its share out of the whole leaf
(``sharding/tp.py``): :meth:`Placement.tp_at` hands every attention its
:class:`TensorParallel` all the same.  A block under TP use is the block
the process holds: nothing is placed anew.
"""

from __future__ import annotations

import collections
import functools
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .specs import (KVLayout, Spec, at_path, block_shape, build_param_specs, entry_axes,
                    is_expert_leaf, kv_layout, leaf_paths, local_shard, map_with_path,
                    mesh_coord, mesh_sizes, split_axes)
from .tp import TensorParallel, value_columns

#: launches of the gather's collectives: "all_gather" and "reduce_scatter"
COUNTS: collections.Counter = collections.Counter()

#: (leaf path "a/b/c", axis) -> gathers of that leaf over that axis on use
LEAF_GATHERS: collections.Counter = collections.Counter()

#: the subtrees whose products are tensor-parallel under TP use
_ATTENTION = ("attn", "self_attn", "cross_attn")
_Q_LEAVES = ("wq", "bq", "wo")
_KV_LEAVES = ("wk", "wv", "bk", "bv")
_MLP_LEAVES = ("wg", "wu", "wd", "w1", "b1", "w2")
#: a Mamba layer's leaves whose "model" block is its SSM heads' channels
_MAMBA_LEAVES = ("conv_w", "conv_b", "gate_norm", "out_proj")
#: an mLSTM layer's leaves whose "model" block is its value columns, and
#: those whose block is whole heads where the model group divides them
_MLSTM_COLUMNS = ("wv", "wg", "gate_norm", "wo")
_MLSTM_HEADS = ("wq", "wk", "wi", "wf")
#: an sLSTM layer's leaves whose "model" block is its channels
_SLSTM_LEAVES = ("wz", "wi", "wf", "wo_gate", "down")

#: one step of a gather: (dim, process group, its size)
Step = Tuple[int, object, int]

def gather_plan(spec: Spec, sizes: Mapping[str, int]) -> Tuple[Tuple[int, str], ...]:
    """(dim, axis) of each gather ``spec`` needs, in order: dims in order, the
    axes of one dim minor first, so that each gather joins the blocks of the
    next axis up (``local_shard`` splits a dim first axis major).  Axes of one
    process are left out."""
    out = []
    for dim, entry in enumerate(spec):
        out += [(dim, a) for a in reversed(entry_axes(entry)) if sizes.get(a, 1) > 1]
    return tuple(out)


def _gather_dim(t: torch.Tensor, dim: int, group, m: int) -> torch.Tensor:
    """The group's blocks of ``t`` joined along ``dim``, in group-rank order."""
    out = t.new_empty((m * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    COUNTS["all_gather"] += 1
    return out.unflatten(0, (m, t.shape[0])).movedim(0, dim).flatten(dim, dim + 1)


def _scatter_dim(g: torch.Tensor, dim: int, group, m: int) -> torch.Tensor:
    """``g``'s block of this process along ``dim``, summed over the group."""
    stacked = g.unflatten(dim, (m, g.shape[dim] // m)).movedim(dim, 0).contiguous()
    out = g.new_empty(stacked.shape[1:])
    dist.reduce_scatter_tensor(out, stacked.flatten(0, 1), group=group)
    COUNTS["reduce_scatter"] += 1
    return out


class GatherLeaf(torch.autograd.Function):
    """A block -> the whole leaf over ``steps`` (:data:`Step`); the backward
    reduce-scatters the whole leaf's gradient back to the block, the steps
    in reverse."""

    @staticmethod
    def forward(ctx, t, steps):
        ctx.steps = steps
        for dim, group, m in steps:
            t = _gather_dim(t, dim, group, m)
        return t

    @staticmethod
    def backward(ctx, g):
        for dim, group, m in reversed(ctx.steps):
            g = _scatter_dim(g, dim, group, m)
        return g, None


def gather_leaf(t: torch.Tensor, steps: Sequence[Step]) -> torch.Tensor:
    """``t`` whole over ``steps`` (:class:`GatherLeaf`); ``t`` itself, and
    nothing launched, without a step."""
    return GatherLeaf.apply(t, tuple(steps)) if steps else t


def use_spec(path: Sequence, shape: Sequence[int], spec: Spec) -> Spec:
    """The axes over which a leaf is gathered before use: its spec, less the
    expert dim's "model" (EP computes on the process's own experts)."""
    return _without_model(spec) if is_expert_leaf(path, shape) else spec


def _without_model(spec: Spec) -> Spec:
    return tuple(None if a == "model" else a for a in spec)


def _keeps_model_block(path: Sequence, shapes, spec: Spec, m: int, head_dim: int) -> bool:
    """Whether the leaf at ``path`` keeps its "model" block under TP use
    (module docstring): a leaf of a tensor-parallel product that "model"
    splits as a dim of its own; attention by whole heads (``H % m``, and
    ``Hkv % m`` for the KV leaves, H and Hkv from ``wq``'s and ``wk``'s
    columns); a Mamba layer's channel leaves by whole SSM heads (H from
    ``A_log``); an xLSTM layer (a list entry of ``blocks``) by value
    columns (an mLSTM layer, which has ``wq``; H from ``wi``'s columns,
    ``tp.value_columns``) or by channels (an sLSTM layer, which has
    ``wz``); ``lm_head`` by vocab."""
    if "model" not in spec:
        return False
    name, parent = str(path[-1]), (path[-2] if len(path) > 1 else None)
    if isinstance(parent, int) and path[0] == "blocks":
        sub = at_path(shapes, path[:-1])
        if "wz" in sub:
            return name in _SLSTM_LEAVES
        heads = sub["wi"][-1]
        if value_columns(heads, sub["wq"][-1] // heads, m, 0) is None:
            return False
        return name in _MLSTM_COLUMNS or (heads % m == 0 and name in _MLSTM_HEADS)
    if parent in _ATTENTION and name in _Q_LEAVES + _KV_LEAVES:
        sub = at_path(shapes, path[:-1])
        heads, kv = sub["wq"][-1] // head_dim, sub["wk"][-1] // head_dim
        return heads % m == 0 and (name in _Q_LEAVES or kv % m == 0)
    if parent == "mamba":
        return name in _MAMBA_LEAVES and at_path(shapes, path[:-1])["A_log"][-1] % m == 0
    if parent == "mlp":
        return name in _MLP_LEAVES
    return tuple(path) == ("lm_head",)


@functools.lru_cache(maxsize=32)
def _trees(shapes_of, cfg, sizes: Tuple[Tuple[str, int], ...]):
    """(shapes, full specs, use specs) of ``shapes_of(cfg)`` over ``sizes``."""
    shapes = shapes_of(cfg)
    full = build_param_specs(shapes, dict(sizes))
    use = map_with_path(
        lambda path, s: use_spec(path, s, at_path(full, path)), shapes)
    return shapes, full, use


@functools.lru_cache(maxsize=32)
def _tp_use(shapes_of, cfg, sizes: Tuple[Tuple[str, int], ...]):
    """The use specs under TP use (module docstring) of ``_trees``' tree."""
    shapes, full, use = _trees(shapes_of, cfg, sizes)
    m = dict(sizes)["model"]

    def one(path, _):
        u = at_path(use, path)
        keep = _keeps_model_block(path, shapes, at_path(full, path), m, cfg.head_dim)
        return _without_model(u) if keep else u

    return map_with_path(one, shapes)


class Placement:
    """Where a parameter tree's leaves lie over a mesh: each leaf's spec
    (``specs``), the spec it is gathered by before use (``use``) and its
    whole shape (``shapes``), for a subtree of the parameters (:meth:`at`).
    ``specs is None``: nothing is split (no mesh, or a world of one), and
    every leaf is read as it is.  Under TP use (:func:`placement` with
    ``rows``), ``tp`` is this process's :class:`~repro_torch.sharding.tp.TensorParallel`
    and ``vocab`` the vocab rows of its logits' block (``None`` where they
    stay whole)."""

    def __init__(self, shapes=None, specs=None, use=None, mesh=None, groups=None,
                 tp: Optional[TensorParallel] = None, vocab: Optional[slice] = None,
                 prefix: Tuple = ()):
        self.shapes, self.specs, self.use, self.mesh = shapes, specs, use, mesh
        self.sizes = mesh_sizes(mesh)
        self._groups: Dict[str, object] = {} if groups is None else groups
        self.tp, self.vocab, self.prefix = tp, vocab, prefix

    @property
    def placed(self) -> bool:
        return self.specs is not None

    def at(self, *keys) -> "Placement":
        """The placement of the subtree at ``keys``."""
        if not self.placed:
            return self
        return Placement(*(at_path(t, keys) for t in (self.shapes, self.specs, self.use)),
                         mesh=self.mesh, groups=self._groups, tp=self.tp,
                         vocab=self.vocab, prefix=self.prefix + keys)

    def tp_at(self, *keys) -> Optional[TensorParallel]:
        """:attr:`tp` where a leaf of the subtree at ``keys`` keeps its "model"
        block (its products are tensor-parallel) and for every attention
        subtree (its heads split unevenly where they do not divide: the
        layer slices them out of the whole leaves), else ``None``."""
        if self.tp is None:
            return None
        if (self.prefix + keys)[-1:] and (self.prefix + keys)[-1] in _ATTENTION:
            return self.tp
        specs, use = at_path(self.specs, keys), at_path(self.use, keys)
        for path, _ in leaf_paths(at_path(self.shapes, keys)):
            if "model" in at_path(specs, path) and "model" not in at_path(use, path):
                return self.tp
        return None

    def kv_layout(self, n_kv: int, width: int) -> Optional[KVLayout]:
        """Under TP use, how a KV cache of ``n_kv`` heads and ``width`` slots
        lies over the model group (``specs.KVLayout``, its ``group`` :attr:`tp`);
        ``None`` where each process holds it whole."""
        if self.tp is None:
            return None
        kv = kv_layout(n_kv, width, self.tp.size, self.tp.rank, self.tp)
        return None if kv.kind == "whole" else kv

    def whole_vocab(self, z: torch.Tensor) -> torch.Tensor:
        """Logits of this process's vocab block (:attr:`vocab`) -> the whole
        vocab, gathered over the model group (:class:`GatherLeaf`); ``z``
        itself where the logits stay whole."""
        if self.vocab is None:
            return z
        return gather_leaf(z, ((z.dim() - 1, self.tp.group, self.tp.size),))

    def vocab_rows(self, w: torch.Tensor) -> torch.Tensor:
        """A tied embedding ``w`` [V, D], read whole -> the rows of this
        process's logits block (all of them where the logits stay whole)."""
        return w if self.vocab is None else w[self.vocab]

    def group(self, axis: str):
        if axis not in self._groups:
            self._groups[axis] = self.mesh.get_group(axis)
        return self._groups[axis]

    def steps(self, spec: Spec) -> Tuple[Step, ...]:
        return tuple((d, self.group(a), self.sizes[a])
                     for d, a in gather_plan(spec, self.sizes))

    def whole(self, tree, lead: int = 0):
        """``tree`` (a leaf or a subtree of this placement's, blocks as held)
        with every leaf whole for use; ``lead``: the leading dims the caller
        has indexed away (``layers.layer``'s layer index)."""
        if not self.placed:
            return tree
        return self._whole(tree, lead, ())

    def _whole(self, t, lead, path):
        if isinstance(t, dict):
            return {k: self._whole(v, lead, path + (k,)) for k, v in t.items()}
        if isinstance(t, list):
            return [self._whole(v, lead, path + (i,)) for i, v in enumerate(t)]
        spec = at_path(self.specs, path)[lead:]
        want = block_shape(tuple(at_path(self.shapes, path))[lead:], spec, self.sizes)
        if tuple(t.shape) != want:
            raise ValueError(f"parameter {'/'.join(map(str, path)) or 'leaf'}: held "
                             f"{tuple(t.shape)}, its block under {spec} is {want}")
        use = at_path(self.use, path)[lead:]
        name = "/".join(map(str, self.prefix + path))
        for _, axis in gather_plan(use, self.sizes):
            LEAF_GATHERS[(name, axis)] += 1
        return gather_leaf(t, self.steps(use))

    def spec(self, path) -> Optional[Spec]:
        """The spec of the parameter leaf at ``path``; ``None`` where the
        parameters have no leaf (or nothing is placed)."""
        if not self.placed:
            return None
        try:
            shape = at_path(self.shapes, path)
        except (KeyError, IndexError, TypeError):
            return None
        return at_path(self.specs, path) if _is_shape(shape) else None

    def whole_leaf(self, t: torch.Tensor, path) -> torch.Tensor:
        """The block ``t`` of the leaf at ``path`` (a parameter, its gradient
        or a moment) -> the whole leaf, expert dims too, without autograd."""
        with torch.no_grad():
            return gather_leaf(t, self.steps(self.spec(path)))

    def block(self, t: torch.Tensor, path) -> torch.Tensor:
        """The whole leaf ``t`` at ``path`` -> this process's block of it (a
        contiguous copy where it is split, ``t`` itself where it is not)."""
        spec = self.spec(path)
        if not gather_plan(spec, self.sizes):
            return t
        return local_shard(t, spec, self.sizes, mesh_coord(self.mesh)).contiguous()


def _is_shape(node) -> bool:
    return isinstance(node, tuple) and all(isinstance(d, int) for d in node)


#: no mesh: every leaf read as it is
UNPLACED = Placement()


def tp_rows(rows, sizes: Mapping[str, int]) -> bool:
    """Whether ``rows`` (the train step's or serving's ``RowBlock``, or
    ``None``) lie replicated over a model axis of more than one process: TP
    use."""
    return rows is not None and not rows.split_over_model and sizes.get("model", 1) > 1


def placement(shapes_of, cfg, ctx, rows=None) -> Placement:
    """The placement of ``shapes_of(cfg)``'s parameters (a family's
    ``param_shapes``) over ``ctx.mesh``; :data:`UNPLACED` without a mesh or on
    a world of one.  With ``rows`` replicated over the model group
    (:func:`tp_rows`), TP use (module docstring): the train step's loss
    (``Model.loss``) or serving's (``Model.forward``/``decode_step``), its
    logits by vocab where the vocab divides."""
    sizes = mesh_sizes(ctx.mesh)
    if all(s == 1 for s in sizes.values()):
        return UNPLACED
    key = tuple(sizes.items())
    shapes, full, use = _trees(shapes_of, cfg, key)
    if not tp_rows(rows, sizes):
        return Placement(shapes, full, use, mesh=ctx.mesh)
    group, m = ctx.mesh.get_group("model"), sizes["model"]
    tp = TensorParallel(group, m, dist.get_rank(group))
    v = shapes["embed"][0] // m
    split = ("model" in full["lm_head"] if "lm_head" in shapes   # tied: embed's rows
             else shapes["embed"][0] % m == 0)
    return Placement(shapes, full, _tp_use(shapes_of, cfg, key), mesh=ctx.mesh, tp=tp,
                     vocab=slice(tp.rank * v, (tp.rank + 1) * v) if split else None)


def reduce_axes(spec: Spec, sizes: Mapping[str, int]) -> Tuple[str, ...]:
    """The mesh axes of more than one process that do not split a leaf of
    ``spec``: the axes over which its copies' gradients are summed."""
    split = set(split_axes(spec))
    return tuple(a for a, s in sizes.items() if s > 1 and a not in split)


def norm_axes(spec: Spec, sizes: Mapping[str, int]) -> Tuple[str, ...]:
    """The mesh axes of more than one process that split a leaf of ``spec``:
    the axes over which its blocks' squared norms are summed."""
    return tuple(a for a in split_axes(spec) if sizes.get(a, 1) > 1)


def leaf_specs(place: Placement) -> Optional[list]:
    """Each leaf's spec in leaf order (``tree.leaves``), or ``None`` unplaced."""
    if not place.placed:
        return None
    return [at_path(place.specs, path) for path, _ in leaf_paths(place.shapes)]
