"""The port's executor on a gloo world of 4 processes, (data 2, model 2),
on the CPU (the cases and checks: ``torch_dist_common.py``).

* the dataplane (n = 8, G = 4), the baseline and the MoE layer against
  the stacked executor; the masked branch at P = 4;
* ``sharding/gather.py::GatherLeaf``: a leaf split over one axis, two axes
  of one dim, two dims and none comes back whole bit for bit, and its
  block's gradient is the block of the cotangents summed over the
  processes that split it (nothing launched for none);
* the train step with a batch of 2 sequences (the rows over data,
  replicated over model) for reduced paper-moe-8e (EP 4, the MoE's full
  split over the model group) and smollm-135m, from the JAX package's
  weights, against the single-process step: the loss within 1e-6, the
  gradients within 1e-5, the drops equal; and the loss within 5e-2 of the
  JAX package's single-device step; one sequence at a capacity that drops;
* every parameter and AdamW moment placed by the full specs
  (``PLACED_ARCHS``, 31 tokens a sequence: the MoE's masked branch), the
  model group running each block's products tensor-parallel, and the
  tensor-parallel cases (``TP_CASES``), against one process and the JAX
  package, their launches exactly; xLSTM's mLSTM by 2 whole heads a
  process, the one-head case by 64 value columns (``mlstm_scan`` at
  dv < dk), its sLSTM by channels;
* serving (``SERVE_CASES``) against one process within 1e-5 and the JAX
  package within 1e-4;
* a checkpoint written by the world is the world's blocks put together,
  bit for bit, and one written by a single process restores in the world
  as each process's block of it, bit for bit.
"""

import numpy as np
import pytest

from repro_torch.launch import dist_checks, selftest
from repro_torch.optim import adamw
from repro_torch.tree import leaves
from torch_dist_common import (PLACED_ARCHS, ROWS_ARCHS, ROWS_OVERFLOW, SERVE_CASES,
                               TP_CASES, _ckpt_dir, _close, check_baseline, check_exchange,
                               check_layer, check_masked, check_placed, check_placed_tp,
                               check_serving, check_tp_train, exchange_params, jax_rows_ref,
                               params_for, single_ckpt, single_rows, world)  # noqa: F401

pytestmark = pytest.mark.torch_port

P = 4


@pytest.mark.parametrize("world,n,dt,mode", exchange_params((P,)), indirect=["world"])
def test_exchange_bit_exact_against_stacked_and_oracle(world, n, dt, mode):
    check_exchange(world, n, dt, mode)


@pytest.mark.parametrize("world,n", params_for("baseline", (P,)), indirect=["world"])
def test_baseline_all_to_all_equals_the_oracle(world, n):
    check_baseline(world, n)


@pytest.mark.parametrize("world,n", params_for("layer", (P,)), indirect=["world"])
def test_moe_layer_forward_and_gradients_equal_stacked(world, n):
    check_layer(world, n)


@pytest.mark.parametrize("world", [P], indirect=True, ids=["P4"])
def test_masked_branch_forward_equals_stacked_and_its_gradients_equal_stacked(world):
    check_masked(world)


@pytest.mark.parametrize("world", [P], indirect=True, ids=["P4"])
@pytest.mark.parametrize("case", ["one axis", "two axes", "two dims", "no dim"])
def test_gather_leaf_round_trip_and_gradient(world, case):
    """(data 2, model 2): the whole leaf, bit for bit, in every process; the
    block's gradient the block of the cotangents summed over the processes
    that hold the leaf's other blocks (the processes of its split axes)."""
    from repro_torch.sharding.specs import local_shard, split_axes

    got = world["gather"]
    t, cases, cots = dist_checks.gather_inputs(len(got))
    spec = cases[case]
    axes = split_axes(spec)
    sizes = {"data": 2, "model": 2}
    for rank, g in enumerate(got):
        assert np.array_equal(g[case]["whole"], t.numpy())
        me = g["coord"]
        peers = [r for r, h in enumerate(got)
                 if all(h["coord"][a] == me[a] for a in sizes if a not in axes)]
        want = local_shard(sum(cots[r] for r in peers), spec, sizes, me)
        _close(g[case]["grad"], want.numpy(), 1e-6)
        steps = len(axes)
        assert g[case]["launches"] == {"all_gather": steps, "reduce_scatter": steps}


@pytest.mark.parametrize("world", [P], indirect=True, ids=["P4"])
def test_replicated_rows_count_each_dropped_token_once(world):
    """1 sequence on (data 2, model 2), held by all 4 processes, at a capacity
    that drops: the model group splits its 32 tokens as the stacked EP 4
    step does (8 a rank) and the two data replicas repeat them, so the
    world's sum of drops over the two copies is the single step's."""
    loss, dropped, grads, params = single_rows("paper-moe-8e", 1, ROWS_OVERFLOW)
    got = world["rows-overflow"]
    assert dropped > 0
    for g in got:
        assert g["rows"] == dict(index=0, count=1, replicas=4, split_over_model=False)
        assert g["dropped"] == dropped
        assert abs(g["loss"] - loss) <= 1e-6 * abs(loss)
    for a, b in zip(selftest.assemble_grads(got, params), grads):
        _close(a, b)


@pytest.mark.parametrize("world,arch", [pytest.param(P, a, id=f"P4-{a}")
                                        for a in ROWS_ARCHS], indirect=["world"])
def test_train_step_with_rows_replicated_over_model_equals_single(world, arch):
    """2 sequences on (data 2, model 2): each data block's row replicated over
    the model group; the MoE splits its tokens over the group and gathers
    them back (the backward a reduce-scatter sum).  The loss is also held
    against the JAX package's single-device step on the same weights."""
    loss, dropped, grads, params = single_rows(arch)
    _, jloss = jax_rows_ref(arch)
    got = world[f"rows-{arch}"]
    for g in got:
        assert g["rows"] == dict(index=g["coord"]["data"], count=2, replicas=2,
                                 split_over_model=False)
        assert abs(g["loss"] - loss) <= 1e-6 * abs(loss)
        assert np.isfinite(g["loss"]) and abs(g["loss"] - jloss) < 5e-2
        assert g["dropped"] == dropped == 0
    full = selftest.assemble_grads(got, params)
    assert len(full) == len(grads)
    for a, b in zip(full, grads):
        _close(a, b)


@pytest.mark.parametrize("world,arch", [pytest.param(P, a, id=f"P4-{a}")
                                        for a in PLACED_ARCHS], indirect=["world"])
def test_placed_train_step_equals_one_process(world, arch):
    check_placed(world, arch)


@pytest.mark.parametrize("world,arch", [pytest.param(P, a, id=f"P4-{a}")
                                        for a in PLACED_ARCHS], indirect=["world"])
def test_placed_train_step_runs_the_blocks_tensor_parallel(world, arch):
    check_placed_tp(world, arch)


@pytest.mark.parametrize("world,case", [pytest.param(P, c, id=f"P4-{c}")
                                        for c in TP_CASES], indirect=["world"])
def test_tp_train_step_equals_one_process(world, case):
    check_tp_train(world, case)


@pytest.mark.parametrize("world,case", [pytest.param(P, c, id=f"P4-{c}")
                                        for c in SERVE_CASES], indirect=["world"])
def test_serving_across_processes_equals_one_process(world, case):
    check_serving(world, case)


@pytest.mark.parametrize("world", [P], indirect=True, ids=["P4"])
def test_checkpoint_round_trip_across_world_shapes(world):
    """(data 2, model 2) -> one process: the files hold the world's blocks put
    together, bit for bit; one process -> (data 2, model 2): each process
    restores its block of the single tree, bit for bit.  The save holds one
    gathered leaf whole at a time, and the restore uploads only blocks."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.sharding.specs import at_path, build_param_specs, leaf_paths, local_shard

    got = world["ckpt"]
    _, tree = single_ckpt()
    params = tree["params"]
    n = len(leaves(params))
    whole, _ = ckpt.restore(_ckpt_dir("world"), 1,
                            namedtuple_types={"OptState": adamw.OptState}, device="cpu")
    want = leaves(whole)                  # m, v, step, params: the "opt" key sorts first
    parts = {"m": (0, n), "v": (n, 2 * n), "params": (2 * n + 1, 3 * n + 1)}
    for lo, hi in parts.values():
        res = [dict(coord=g["coord"], blocks=g["written"][lo:hi]) for g in got]
        for a, b in zip(selftest.assemble_grads(res, params, "blocks"), want[lo:hi]):
            assert np.array_equal(a, b.numpy())
    assert want[2 * n] == 1 and all(g["written"][2 * n] == 1 for g in got)
    sizes = {"data": 2, "model": 2}
    specs = build_param_specs(params, sizes)
    single = leaves(tree)
    for g in got:
        for lo, hi in parts.values():
            for i, (path, _) in zip(range(lo, hi), leaf_paths(params)):
                spec = at_path(specs, path)
                blk = local_shard(single[i], spec, sizes, g["coord"])
                assert np.array_equal(g["restored"][i], blk.numpy())
                assert g["uploaded"][i] == tuple(blk.shape)
        assert g["restored"][2 * n] == 1
        assert len(g["uploaded"]) == len(single) and g["held_whole"] == 1
