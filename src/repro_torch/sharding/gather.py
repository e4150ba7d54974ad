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
launches.
"""

from __future__ import annotations

import collections
import functools
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .specs import (Spec, at_path, block_shape, build_param_specs, entry_axes,
                    is_expert_leaf, leaf_paths, local_shard, map_with_path, mesh_coord,
                    mesh_sizes, split_axes)

#: launches of the gather's collectives: "all_gather" and "reduce_scatter"
COUNTS: collections.Counter = collections.Counter()

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
    if not is_expert_leaf(path, shape):
        return spec
    return tuple(None if a == "model" else a for a in spec)


@functools.lru_cache(maxsize=32)
def _trees(shapes_of, cfg, sizes: Tuple[Tuple[str, int], ...]):
    """(shapes, full specs, use specs) of ``shapes_of(cfg)`` over ``sizes``."""
    shapes = shapes_of(cfg)
    full = build_param_specs(shapes, dict(sizes))
    use = map_with_path(
        lambda path, s: use_spec(path, s, at_path(full, path)), shapes)
    return shapes, full, use


class Placement:
    """Where a parameter tree's leaves lie over a mesh: each leaf's spec
    (``specs``), the spec it is gathered by before use (``use``) and its
    whole shape (``shapes``), for a subtree of the parameters (:meth:`at`).
    ``specs is None``: nothing is split (no mesh, or a world of one), and
    every leaf is read as it is."""

    def __init__(self, shapes=None, specs=None, use=None, mesh=None, groups=None):
        self.shapes, self.specs, self.use, self.mesh = shapes, specs, use, mesh
        self.sizes = mesh_sizes(mesh)
        self._groups: Dict[str, object] = {} if groups is None else groups

    @property
    def placed(self) -> bool:
        return self.specs is not None

    def at(self, *keys) -> "Placement":
        """The placement of the subtree at ``keys``."""
        if not self.placed:
            return self
        return Placement(*(at_path(t, keys) for t in (self.shapes, self.specs, self.use)),
                         mesh=self.mesh, groups=self._groups)

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
        return gather_leaf(t, self.steps(at_path(self.use, path)[lead:]))

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


def placement(shapes_of, cfg, ctx) -> Placement:
    """The placement of ``shapes_of(cfg)``'s parameters (a family's
    ``param_shapes``) over ``ctx.mesh``; :data:`UNPLACED` without a mesh or on
    a world of one."""
    sizes = mesh_sizes(ctx.mesh)
    if all(s == 1 for s in sizes.values()):
        return UNPLACED
    return Placement(*_trees(shapes_of, cfg, tuple(sizes.items())), mesh=ctx.mesh)


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
