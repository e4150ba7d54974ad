"""The port's sharding specs against ``repro.sharding.specs``.

Specs are built from a mesh's axis names and sizes alone, so both packages
run on meshes far larger than this host: the reference on a stand-in mesh
object (its specs read only ``axis_names`` and ``devices.shape``), the port
on a mapping of axis sizes.  Every leaf of every architecture's parameter
tree (the reference's by ``jax.eval_shape``, the port's ``param_shapes``),
the batch spec, the input specs of every shape and the decode caches'
specs must be equal entry for entry, on each of four meshes.
"""

import types

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import INPUT_SHAPES as J_INPUT_SHAPES
from repro.configs.base import get_config as j_get_config
from repro.models.registry import build_model as j_build_model
from repro.sharding import specs as jspecs
from repro.sharding.context import ParallelContext as JContext
from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.models.registry import build_model, family
from repro_torch.sharding import specs
from repro_torch.sharding.context import ParallelContext

pytestmark = pytest.mark.torch_port

MESHES = {
    "pod2-data16-model16": ({"pod": 2, "data": 16, "model": 16}, ("pod", "data")),
    "data16-model16": ({"data": 16, "model": 16}, ("data",)),
    "data2-model4": ({"data": 2, "model": 4}, ("data",)),
    "data1-model8": ({"data": 1, "model": 8}, ("data",)),
}


def _jctx(sizes, data_axes):
    mesh = types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.empty(tuple(sizes.values())))
    return JContext(mesh=mesh, data_axes=data_axes)


def _key(k):
    return getattr(k, "key", getattr(k, "idx", None))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _jtree(arch, ctx):
    return jax.eval_shape(j_build_model(j_get_config(arch), ctx).init,
                          jax.random.PRNGKey(0))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch, mesh):
    sizes, data_axes = MESHES[mesh]
    jctx = _jctx(sizes, data_axes)
    jtree = _jtree(arch, jctx)
    jspec = jspecs.build_param_specs(jtree, jctx)
    shapes = family(get_config(arch)).param_shapes(get_config(arch))
    port = specs.build_param_specs(shapes, sizes)
    flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    jflat = jax.tree.leaves(jspec, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    assert len(flat) == len(jflat)
    for (path, leaf), want in zip(flat, jflat):
        keys = tuple(_key(k) for k in path)
        assert tuple(_at(shapes, keys)) == tuple(leaf.shape), keys
        assert _at(port, keys) == tuple(want), (keys, _at(port, keys), want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_divisible(arch):
    """The port's counterpart of ``test_substrates::test_param_specs_divisible``."""
    sizes = MESHES["pod2-data16-model16"][0]
    shapes = family(get_config(arch)).param_shapes(get_config(arch))
    port = specs.build_param_specs(shapes, sizes)

    def check(shape, spec):
        assert len(spec) in (0, len(shape)), (shape, spec)
        for dim, axis in zip(shape, spec):
            if axis is not None:
                axes = axis if isinstance(axis, tuple) else (axis,)
                assert dim % int(np.prod([sizes[a] for a in axes])) == 0, (shape, spec)

    def walk(s, p):
        if isinstance(s, dict):
            for k in s:
                walk(s[k], p[k])
        elif isinstance(s, list):
            for a, b in zip(s, p):
                walk(a, b)
        else:
            check(tuple(s), p)

    walk(shapes, port)


def test_moe_experts_sharded_over_model():
    """The port's counterpart of ``test_substrates::test_moe_experts_sharded_over_model``."""
    cfg = get_config("qwen3-moe-235b-a22b")
    port = specs.build_param_specs(family(cfg).param_shapes(cfg),
                                   MESHES["pod2-data16-model16"][0])
    assert port["blocks"]["wg"][1] == "model"          # [L, E, D, F]
    # the port holds these specs: each process its block, an expert leaf
    # split over both axes and gathered for use over "data" only
    from repro_torch.sharding.gather import gather_plan, norm_axes, reduce_axes, use_spec

    sizes = {"data": 2, "model": 4}
    shapes = family(cfg).param_shapes(cfg)
    held = specs.build_param_specs(shapes, sizes)
    wg = held["blocks"]["wg"]
    assert wg == (None, "model", "data", None)
    assert specs.split_axes(wg) == ("model", "data") and reduce_axes(wg, sizes) == ()
    assert norm_axes(wg, sizes) == ("model", "data")
    assert use_spec(("blocks", "wg"), shapes["blocks"]["wg"], wg) == (None, None, "data", None)
    assert held["blocks"]["router"] == (None, None, None)
    assert reduce_axes(held["blocks"]["router"], sizes) == ("data", "model")
    assert held["embed"] == (None, "model")
    assert reduce_axes(held["embed"], sizes) == ("data",)
    assert gather_plan(held["embed"], sizes) == ((1, "model"),)
    assert gather_plan(held["embed"], {"data": 2, "model": 1}) == ()


@pytest.mark.parametrize("mesh", MESHES)
def test_batch_and_input_specs_equal_the_reference(mesh, monkeypatch):
    sizes, data_axes = MESHES[mesh]
    jctx = _jctx(sizes, data_axes)
    # the reference wraps each spec in a NamedSharding of its mesh: keep the spec
    monkeypatch.setattr(jspecs, "NamedSharding", lambda m, s: s)
    for gb in (1, 2, 3, 4, 8, 32, 128, 256, 512):
        assert specs.batch_spec(sizes, data_axes, gb) == tuple(jspecs.batch_spec(jctx, gb))
    assert specs.batch_axes(data_axes) == jspecs.batch_axes(jctx)
    for arch in ARCH_IDS:
        model = build_model(get_config(arch), ParallelContext(device="cpu"))
        jmodel = j_build_model(j_get_config(arch), jctx)
        for name, shape in INPUT_SHAPES.items():
            if not model.supports(shape):
                continue
            want = jspecs.input_specs_sharding(jmodel.input_specs(J_INPUT_SHAPES[name]),
                                               jctx, J_INPUT_SHAPES[name])
            got = specs.input_specs_sharding(model.input_specs(shape), sizes, data_axes,
                                             shape.global_batch)
            assert got == {k: tuple(v) for k, v in want.items()}, (arch, name)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_reference(arch, mesh):
    sizes, data_axes = MESHES[mesh]
    jctx = _jctx(sizes, data_axes)
    cfg = get_config(arch)
    model = build_model(cfg, ParallelContext(device="meta"))
    jmodel = j_build_model(j_get_config(arch), jctx)
    for name in ("decode_32k", "long_500k"):
        shape, jshape = INPUT_SHAPES[name], J_INPUT_SHAPES[name]
        if not model.supports(shape):
            continue
        B = 8
        jcache = jax.eval_shape(lambda: jmodel.init_cache(B, jshape))
        want = jspecs.build_cache_specs(jcache, jctx)
        cache = model.init_cache(B, shape)
        got = specs.build_cache_specs(cache, sizes)
        flat = jax.tree_util.tree_flatten_with_path(jcache)[0]
        jflat = jax.tree.leaves(want, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
        assert len(flat) == len(jflat)
        for (path, leaf), w in zip(flat, jflat):
            keys = tuple(_key(k) for k in path)
            assert tuple(_at(cache, keys).shape) == tuple(leaf.shape), keys
            assert _at(got, keys) == tuple(w), (arch, name, keys)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-1b-a400m"])
def test_shard_params_holds_the_blocks_of_the_full_specs(arch, mesh):
    """Every process's blocks (a mesh's coordinate, no process group): each
    leaf ``local_shard`` of the whole by ``build_param_specs``, its bytes the
    block's; the processes' blocks put back together (``unshard``) are the
    whole leaf, bit for bit, and AdamW's moments take the blocks' shape."""
    import itertools

    from repro_torch.optim import adamw
    from repro_torch.tree import leaves

    sizes, _ = MESHES[mesh]
    cfg = get_config(arch).reduced()
    model = build_model(cfg, ParallelContext(device="cpu"))
    whole = model.mod.init(0, cfg, model.ctx)
    specs_ = specs.build_param_specs(whole, sizes)
    coords = [dict(zip(sizes, c)) for c in itertools.product(*map(range, sizes.values()))]
    held = {}
    for c in coords[:: max(1, len(coords) // 8)] if len(coords) > 8 else coords:
        held[tuple(c.values())] = specs.shard_params(
            whole, ParallelContext(mesh=_FakeMesh(sizes, c), device="cpu"))
    for (path, t), spec in zip(specs.leaf_paths(whole), _leaf_specs(specs_, whole)):
        blocks = {k: _at(h, path) for k, h in held.items()}
        for k, b in blocks.items():
            coord = dict(zip(sizes, k))
            assert torch.equal(b, specs.local_shard(t, spec, sizes, coord)), path
            assert b.shape == specs.block_shape(t.shape, spec, sizes)
        if len(blocks) == len(coords):
            back = specs.unshard(lambda c: blocks[tuple(c.get(a, 0) for a in sizes)],
                                 spec, sizes)
            assert torch.equal(back, t), path
    one = next(iter(held.values()))
    state = adamw.init(one)
    want = sum(int(np.prod(specs.block_shape(t.shape, s, sizes))) * (t.element_size() + 8)
               for (_, t), s in zip(specs.leaf_paths(whole), _leaf_specs(specs_, whole)))
    assert sum(t.numel() * t.element_size() for t in leaves([one, state.m, state.v])) == want


def _leaf_specs(spec_tree, like):
    return [specs.at_path(spec_tree, path) for path, _ in specs.leaf_paths(like)]


class _FakeMesh:
    """A mesh's names, shape and one process's coordinate, without a group."""

    def __init__(self, sizes, coord):
        self.mesh_dim_names, self.shape = tuple(sizes), tuple(sizes.values())
        self._coord = [coord[a] for a in sizes]

    def get_coordinate(self):
        return self._coord


def test_local_shard_splits_like_a_named_sharding():
    t = torch.arange(2 * 8 * 3 * 4).reshape(2, 8, 3, 4)
    sizes = {"pod": 2, "data": 2, "model": 4}
    spec = (None, "model", ("pod", "data"), None)
    with pytest.raises(ValueError):
        specs.local_shard(t, spec, sizes, {"pod": 0, "data": 0, "model": 0})
    spec = (None, "model", None, ("pod", "data"))
    blocks = {}
    for p in range(2):
        for d in range(2):
            for m in range(4):
                blk = specs.local_shard(t, spec, sizes, {"pod": p, "data": d, "model": m})
                assert tuple(blk.shape) == (2, 2, 3, 1)
                blocks[(p, d, m)] = blk
    # model coordinate m holds rows [2m, 2m + 2); (pod, data) = (p, d) column 2p + d
    for (p, d, m), blk in blocks.items():
        assert torch.equal(blk, t[:, 2 * m:2 * m + 2, :, 2 * p + d:2 * p + d + 1])
