"""Partition-spec rules: FSDP over "data", tensor/expert parallel over "model".

Counterpart of ``repro/sharding/specs.py``.  Rules are keyed by parameter
leaf name (path suffix) with rank templates; stacked-layer leading axes get
``None`` prefixes automatically.  Any dim whose size its assigned axis does
not divide falls back to replication (so reduced configs and ragged dims
never fault).

A spec is a tuple with one entry a dim, each entry an axis name, ``None``
or a tuple of names, as a ``PartitionSpec``'s entries are (a tuple of one
name is that name).  Specs are built from a mesh's axis names and sizes
alone (:func:`mesh_sizes`), so they need no process group: they work on the
port's ``param_shapes`` trees as the reference's work on ``eval_shape``.

The "pod" axis never appears in param specs: pods are pure data-parallel
replicas, so parameters are replicated across pods.

The port places every leaf by these specs (:func:`shard_params`): each
process holds its block, and the models read a leaf whole through
``sharding/gather.py`` (gathered on use, its gradient reduce-scattered
back to the block).  :func:`unshard` is :func:`local_shard`'s inverse.
A serving cache is placed by :func:`shard_cache` (:func:`serve_cache_specs`),
one layer's KV cache over the model group described by :class:`KVLayout`.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .tp import value_columns

# leaf-name -> spec template (rightmost dims; missing leading dims -> None)
_RULES = {
    # embeddings / heads
    "embed": ("*", "model"),
    "lm_head": ("*", "model"),
    "dec_pos": ("*", "model"),
    # attention (col-parallel in, row-parallel out)
    "wq": ("data", "model"),
    "wk": ("data", "model"),
    "wv": ("data", "model"),
    "wo": ("model", "data"),
    "bq": ("model",),
    "bk": ("model",),
    "bv": ("model",),
    # dense mlp
    "wg": ("data", "model"),
    "wu": ("data", "model"),
    "wd": ("model", "data"),
    "w1": ("data", "model"),
    "b1": ("model",),
    "w2": ("model", "data"),
    "b2": ("*",),
    "up": ("data", "model"),
    "down": ("model", "data"),
    # router (small, replicated)
    "router": ("*", "*"),
    # mamba
    "in_proj": ("data", "model"),
    "out_proj": ("model", "data"),
    "conv_w": ("*", "model"),
    "conv_b": ("model",),
    "A_log": ("*",),
    "D": ("*",),
    "dt_bias": ("*",),
    "gate_norm": ("model",),
    # xlstm gates
    "wi": ("data", "model"),
    "wf": ("data", "model"),
    "wz": ("data", "model"),
    "wo_gate": ("data", "model"),
    "wg_x": ("data", "model"),
    "bi": ("*",),
    "bf": ("*",),
}

# MoE expert tensors: leading expert dim -> model axis (expert parallelism).
_MOE_EXPERT_LEAVES = {"wg", "wu", "wd"}

Spec = Tuple[object, ...]


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's order.

    ``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh``, a mapping of
    axis names to sizes, or ``None`` (one device: every axis of size 1).
    """
    if mesh is None:
        return {}
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return {str(a): int(s) for a, s in zip(mesh.mesh_dim_names, mesh.shape)}


def _axis_size(sizes: Mapping[str, int], axis) -> int:
    if isinstance(axis, tuple):
        return math.prod(sizes.get(a, 1) for a in axis)
    return sizes.get(axis, 1)


def _entry(axes) -> object:
    """A spec entry from a sequence of axis names (``PartitionSpec``'s form)."""
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _is_leaf(node) -> bool:
    return isinstance(node, torch.Tensor) or hasattr(node, "shape") or (
        isinstance(node, tuple) and all(isinstance(d, int) for d in node))


def is_expert_leaf(path: Sequence, shape: Sequence[int]) -> bool:
    """An MoE expert tensor: ``wg``/``wu``/``wd`` under ``blocks`` with a
    layer and an expert dim before the template's."""
    names = [str(n) for n in path]
    template = _RULES.get(names[-1]) if names else None
    return (template is not None and names[-1] in _MOE_EXPERT_LEAVES
            and "blocks" in names and len(shape) - len(template) >= 2)


def leaf_paths(tree, path=()) -> list:
    """(path, leaf) of every leaf, in the reference's leaf order (``tree.leaves``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaf_paths(tree[k], path + (k,))]
    if isinstance(tree, list) or (isinstance(tree, tuple) and not _is_leaf(tree)):
        return [x for i, t in enumerate(tree) for x in leaf_paths(t, path + (i,))]
    return [(path, tree)]


def spec_for_path(path: Sequence, leaf, sizes: Mapping[str, int]) -> Spec:
    """The spec of the leaf at ``path`` (its keys and list indices)."""
    shape = _shape(leaf)
    rank = len(shape)
    template = _RULES.get(str(path[-1])) if path else None
    if template is None:
        return ()                        # norms, scalars, unknown leaves -> replicate
    if is_expert_leaf(path, shape):
        # [L, E, ...]: expert dim gets the model axis, inner dims get fsdp
        inner = ["data" if i == 0 else None for i in range(len(template))]
        spec = [None] * (rank - len(template) - 1) + ["model"] + inner
    else:
        spec = [None] * (rank - len(template)) + [
            None if a == "*" else a for a in template]
    # drop axes that don't divide the dim exactly
    return tuple(None if axis is None or dim % _axis_size(sizes, axis) else axis
                 for dim, axis in zip(shape, spec))


def at_path(tree, path):
    """The node of ``tree`` at ``path`` (its keys and list indices)."""
    for k in path:
        tree = tree[k]
    return tree


def map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], path + (k,)) for k in tree}
    if isinstance(tree, list) or (isinstance(tree, tuple) and not _is_leaf(tree)):
        return type(tree)(map_with_path(fn, t, path + (i,)) for i, t in enumerate(tree))
    return fn(path, tree)


def build_param_specs(params, mesh) -> dict:
    """Tree of specs matching ``params`` (tensors or ``param_shapes`` tuples)."""
    sizes = mesh_sizes(mesh)
    return map_with_path(lambda path, leaf: spec_for_path(path, leaf, sizes), params)


def entry_axes(entry) -> Tuple[str, ...]:
    """A spec entry's axis names, in order."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def split_axes(spec: Spec) -> Tuple[str, ...]:
    """The axes a leaf of ``spec`` is split on, in the spec's order; it is
    replicated over every other axis of the mesh."""
    return tuple(a for entry in spec for a in entry_axes(entry))


def block_slices(shape: Sequence[int], spec: Spec, sizes: Mapping[str, int],
                 coord: Mapping[str, int]) -> Tuple[slice, ...]:
    """Where the block at ``coord`` lies in a ``shape`` leaf under ``spec``: a
    slice a dim.  A dim placed over several axes is split into their product
    of blocks, the first axis major, as a ``NamedSharding`` splits it."""
    out = []
    for dim, (n, entry) in enumerate(zip(shape, spec)):
        axes = entry_axes(entry)
        idx = 0
        for a in axes:
            idx = idx * sizes.get(a, 1) + coord.get(a, 0)
        parts = _axis_size(sizes, axes)
        if n % parts:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split into {parts}")
        step = n // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out) + (slice(None),) * (len(shape) - len(spec))


def block_shape(shape: Sequence[int], spec: Spec, sizes: Mapping[str, int]) -> Tuple[int, ...]:
    """The shape of one block of a ``shape`` leaf under ``spec``."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        out[dim] //= _axis_size(sizes, entry_axes(entry))
    return tuple(out)


def local_shard(t: torch.Tensor, spec: Spec, sizes: Mapping[str, int],
                coord: Mapping[str, int]) -> torch.Tensor:
    """One process's block of ``t`` under ``spec`` (a view); ``coord`` is the
    process's index along each mesh axis (:func:`block_slices`)."""
    return t[block_slices(t.shape, spec, sizes, coord)]


def unshard(block_at, spec: Spec, sizes: Mapping[str, int]):
    """The whole leaf from its blocks, :func:`local_shard`'s inverse:
    ``block_at(coord)`` gives the block at a coordinate of the axes ``spec``
    splits on (a tensor or a numpy array; every block of one shape)."""
    axes = split_axes(spec)
    out = None
    for idx in itertools.product(*(range(sizes.get(a, 1)) for a in axes)):
        coord = dict(zip(axes, idx))
        blk = block_at(coord)
        if out is None:
            shape = [n * _axis_size(sizes, entry_axes(e)) for n, e in zip(blk.shape, spec)]
            shape += list(blk.shape[len(spec):])
            out = (blk.new_empty(shape) if isinstance(blk, torch.Tensor)
                   else np.empty(shape, dtype=blk.dtype))
        out[block_slices(out.shape, spec, sizes, coord)] = blk
    return out


def shard_params(params, ctx):
    """Full parameters -> the blocks this process holds under ``ctx.mesh``
    (:func:`build_param_specs`; contiguous copies where an axis of more than
    one process splits a leaf, the leaf itself where none does); ``params``
    itself without a mesh."""
    if ctx.mesh is None:
        return params
    sizes, coord = mesh_sizes(ctx.mesh), mesh_coord(ctx.mesh)
    specs = build_param_specs(params, sizes)

    def one(path, leaf):
        spec = at_path(specs, path)
        if all(sizes.get(a, 1) == 1 for a in split_axes(spec)):
            return leaf
        return local_shard(leaf, spec, sizes, coord).contiguous()

    return map_with_path(one, params)


# --------------------------------------------------------------------------- #
# batch / cache specs
# --------------------------------------------------------------------------- #


def batch_axes(data_axes: Sequence[str]) -> Tuple[str, ...]:
    """Axes that shard the batch dim (pod + data)."""
    return tuple(data_axes)


def batch_spec(mesh, data_axes: Sequence[str], global_batch: int) -> Spec:
    sizes = mesh_sizes(mesh)
    axes = []
    remaining = global_batch
    for a in batch_axes(data_axes):
        sz = _axis_size(sizes, a)
        if remaining % sz == 0 and sz > 1:
            axes.append(a)
            remaining //= sz
    if not axes:
        return (None,)
    return (_entry(axes),)


def input_specs_sharding(model_inputs: Mapping, mesh, data_axes: Sequence[str],
                         global_batch: int) -> Dict[str, Spec]:
    """Specs for a dict of input stand-ins (``Model.input_specs``)."""
    sizes = mesh_sizes(mesh)
    bspec = batch_spec(mesh, data_axes, global_batch)

    def one(name, s):
        ndim = len(s.shape)
        if ndim == 0:
            return ()
        parts = [bspec[0]] + [None] * (ndim - 1)
        # modality stubs: shard embedding dim over model
        if name in ("frames", "patches") and ndim == 3:
            parts[-1] = "model" if _axis_size(sizes, "model") <= s.shape[-1] else None
        return tuple(parts)

    return {k: one(k, v) for k, v in model_inputs.items()}


def cache_spec_rules(mesh):
    """KV / state caches: heads (or inner channels) over model, batch over data."""
    sizes = mesh_sizes(mesh)

    def spec(path, leaf):
        shape = _shape(leaf)
        leaf_name = str(path[-1]) if path else ""
        if leaf_name in ("k", "v") and len(shape) >= 4:
            # [L, B, Hkv, S, dh] or [B, Hkv, S, dh]
            parts = [None] * len(shape)
            if shape[-4] % _axis_size(sizes, "data") == 0:
                parts[-4] = "data"
            m = _axis_size(sizes, "model")
            if shape[-3] % m == 0:
                parts[-3] = "model"          # shard KV heads (GQA permitting)
            elif shape[-2] % m == 0:
                parts[-2] = "model"          # else sequence-shard the cache
            return tuple(parts)
        if leaf_name in ("C", "n", "ssm", "conv") and len(shape) >= 2:
            parts = [None] * len(shape)
            # batch dim position: [L?, B, ...] — the first dim >= data size
            ds = _axis_size(sizes, "data")
            for i, d in enumerate(shape):
                if ds > 1 and d % ds == 0 and d >= ds:
                    parts[i] = "data"
                    break
            # shard the channel dim over model if divisible
            ms = _axis_size(sizes, "model")
            if parts[-1] is None and shape[-1] % ms == 0 and shape[-1] >= ms:
                parts[-1] = "model"
            return tuple(parts)
        return ()
    return spec


def build_cache_specs(cache, mesh) -> dict:
    return map_with_path(cache_spec_rules(mesh), cache)


def serve_cache_specs(cache, mesh, data_axes: Sequence[str] = ("data",)) -> dict:
    """Serving's placement of a cache: each process holds the cache of the
    rows it decodes, placed as :func:`input_specs_sharding` places the
    tokens (:func:`batch_spec`: the data axes that divide them, "pod" among
    them; never "model"), and its share of the model group's work:

      * a KV leaf (``k``, ``v``) by :func:`build_cache_specs`' rule (its KV
        heads, else its slots over "model"); ``slot_pos`` replicated (spec
        ``()``);
      * a Mamba layer's states (a ``conv`` [L, B, K-1, d_inner] beside an
        ``ssm`` [L, B, H, N, P]) by SSM heads where H divides by "model":
        ``ssm`` on H and ``conv`` on its channels, which are the heads' x
        channels (``models/ssm.py``).  The reference's
        ``cache_spec_rules`` splits ``ssm`` on P instead, the same bytes a
        process; a split on P would have every process project every
        head's B, C and dt (``2 N H + H`` of ``in_proj``'s columns) where a
        split by heads projects its own;
      * the encoder states ``enc_out`` [B, F, d] by rows only, whole over
        "model" (the reference's cache holds them replicated);
      * an xLSTM layer's states as its compute splits them
        (``models/xlstm.py``): an sLSTM layer's ``c``, ``n``, ``m``, ``h``
        [B, d] by channels; an mLSTM layer's ``C`` [B, H, dk, dv], ``n``
        [B, H, dk] and ``m`` [B, H] by heads where "model" divides them.
        Where the heads divide "model" instead, a process holds value
        columns of one head (``C`` [B, 1, dk, dv/(m/H)], ``n``, ``m`` of
        that head), a block no spec of dims expresses: the spec gives its
        rows, and :func:`shard_cache` cuts the head and its columns
        (:func:`mlstm_columns`).  The reference's ``cache_spec_rules``
        splits ``C`` and ``n`` on their last dim (``C``'s value columns: 12
        of every head on 16) and replicates ``m`` and the sLSTM's ``c``,
        ``m``, ``h``; the bytes of ``C`` a process are the same."""
    specs = build_cache_specs(cache, mesh)
    sizes = mesh_sizes(mesh)
    m = _axis_size(sizes, "model")

    def rows_at(shape, dim):
        parts = [None] * len(shape)
        parts[dim] = batch_spec(mesh, data_axes, shape[dim])[0]
        return parts

    def one(path, leaf):
        spec, name, shape = at_path(specs, path), str(path[-1]), _shape(leaf)
        parent = at_path(cache, path[:-1])
        if name in ("k", "v") and len(spec) >= 4:
            rows = len(spec) - 4
            return (*spec[:rows], batch_spec(mesh, data_axes, shape[rows])[0],
                    *spec[rows + 1:])
        if name in ("ssm", "conv") and isinstance(parent, Mapping) and {"ssm", "conv"} <= set(
                parent):
            heads = _shape(parent["ssm"])[-3]
            parts = rows_at(shape, len(shape) - (4 if name == "ssm" else 3))
            if m > 1 and heads % m == 0:
                parts[-3 if name == "ssm" else -1] = "model"
            return tuple(parts)
        if name == "enc_out":
            return tuple(rows_at(shape, 0))
        if _is_xlstm_state(parent):
            parts = rows_at(shape, 0)
            if m > 1 and "h" in parent and shape[-1] % m == 0:
                parts[-1] = "model"                       # sLSTM: channels
            elif m > 1 and "C" in parent and _shape(parent["C"])[1] % m == 0:
                parts[1] = "model"                        # mLSTM: whole heads
            return tuple(parts)
        return spec

    return map_with_path(one, cache)


def _is_xlstm_state(node) -> bool:
    """An xLSTM layer's serving state: an mLSTM's (C, n, m) or an sLSTM's (c,
    n, m, h)."""
    return isinstance(node, Mapping) and set(node) in ({"C", "n", "m"}, {"c", "n", "m", "h"})


def mlstm_columns(state: Mapping, m: int, r: int) -> Optional[Tuple[slice, slice]]:
    """(head slice, value column slice) of process ``r`` of a model group of
    ``m`` in an mLSTM state ``{"C": [B, H, dk, dv], ...}`` where the heads
    divide ``m`` and each process holds columns of one head
    (``tp.value_columns``); ``None`` where the heads are whole (or m is 1)."""
    H, dk = _shape(state["C"])[1:3]
    if m == 1 or H % m == 0:
        return None
    cols = value_columns(H, dk, m, r)
    if cols is None:
        return None
    h0, _, p0, pc = cols
    return slice(h0, h0 + 1), slice(p0, p0 + pc)


def shard_cache(cache, mesh, data_axes: Sequence[str] = ("data",), coord=None):
    """A whole cache -> the blocks this process holds under
    :func:`serve_cache_specs` (contiguous copies where an axis splits a leaf),
    :func:`shard_params`' counterpart; ``cache`` itself without a mesh.
    ``coord``: this process's index along each axis (default: the mesh's
    coordinate, which needs its process group)."""
    if mesh is None:
        return cache
    sizes = mesh_sizes(mesh)
    coord = mesh_coord(mesh) if coord is None else coord
    specs = serve_cache_specs(cache, sizes, data_axes)

    def one(path, leaf):
        spec = at_path(specs, path)
        parent = at_path(cache, path[:-1])
        cut = (mlstm_columns(parent, sizes.get("model", 1), coord.get("model", 0))
               if _is_xlstm_state(parent) and "C" in parent else None)
        if cut is not None:
            heads, cols = cut
            leaf = leaf[:, heads]
            leaf = leaf[..., cols] if path[-1] == "C" else leaf
        elif all(sizes.get(a, 1) == 1 for a in split_axes(spec)):
            return leaf
        return local_shard(leaf, spec, sizes, coord).contiguous()

    return map_with_path(one, cache)


@dataclasses.dataclass(frozen=True)
class KVLayout:
    """How one layer's KV cache ``[B, Hkv, W, dh]`` lies over a model group of
    ``size`` processes, by :func:`cache_spec_rules`' rule, and where process
    ``rank`` sits in it:

      * ``"heads"`` (``Hkv % m == 0``): each process holds ``Hkv / m`` KV
        heads, every slot;
      * ``"seq"`` (else ``W % m == 0``): each process holds every KV head at
        the slots ``[r W/m, (r+1) W/m)``; the slot of position ``pos`` is
        written by its owner, ``(pos % W) // (W/m)``;
      * ``"whole"`` (neither, or a group of one): each process holds it all.

    ``slot_pos`` [W] is replicated under every kind.  ``group``: the model
    group's ``sharding/tp.py::TensorParallel``, over which a ``"seq"``
    cache's attention combines its blocks (``None`` where nothing splits)."""

    kind: str
    size: int
    rank: int
    width: int
    group: Optional[object] = None

    @property
    def slots(self) -> int:
        """The slots this process holds."""
        return self.width // self.size if self.kind == "seq" else self.width

    def heads(self, n_kv: int) -> int:
        """The KV heads this process holds."""
        return n_kv // self.size if self.kind == "heads" else n_kv

    def owner(self, pos: int) -> int:
        """The process that holds the slot of position ``pos`` (``"seq"``)."""
        return (pos % self.width) // self.slots


def kv_layout(n_kv: int, width: int, m: int, rank: int = 0, group=None) -> KVLayout:
    """The :class:`KVLayout` of a cache of ``n_kv`` heads and ``width`` slots
    over a model group of ``m`` processes (the rule of
    :func:`cache_spec_rules`)."""
    kind = ("whole" if m == 1 else "heads" if n_kv % m == 0
            else "seq" if width % m == 0 else "whole")
    return KVLayout(kind, m, rank, width, group if kind != "whole" else None)


def mesh_coord(mesh) -> Dict[str, int]:
    """This process's index along each axis of a ``DeviceMesh``."""
    if mesh is None:
        return {}
    return dict(zip(mesh_sizes(mesh), mesh.get_coordinate()))
