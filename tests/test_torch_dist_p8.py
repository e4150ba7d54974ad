"""The port's executor on a gloo world of 8 processes, (data 2, model 4),
on the CPU (the cases and checks: ``torch_dist_common.py``).

* the dataplane (n = 8, G = 4), the baseline and the MoE layer against
  the stacked executor;
* the reference's EP train step from the JAX package's weights
  (``params_from_jax``): the loss within 1e-6 relative and every gradient
  leaf within 1e-5 of its largest value against the stacked EP 4 path,
  the loss within 5e-2 of the JAX package's single-device step;
* every parameter and AdamW moment placed by the full specs
  (``PLACED_ARCHS``, 32 tokens a sequence: the MoE's split of the model
  group's rows), the model group running each block's products
  tensor-parallel, and the tensor-parallel cases (``TP_CASES``), against
  one process and the JAX package, their launches exactly; xLSTM's mLSTM
  by one whole head a process, the one-head case by 32 value columns
  (``mlstm_scan`` at dv < dk), its sLSTM by channels;
* serving (``SERVE_CASES``) against one process within 1e-5 and the JAX
  package within 1e-4.
"""

import numpy as np
import pytest

from torch_dist_common import (PLACED_ARCHS, SERVE_CASES, TP_CASES, check_baseline,
                               check_exchange, check_layer, check_placed, check_placed_tp,
                               check_serving, check_tp_train, exchange_params, hold_train,
                               jax_train_ref, params_for, world)  # noqa: F401

pytestmark = pytest.mark.torch_port

P = 8


@pytest.mark.parametrize("world,n,dt,mode", exchange_params((P,)), indirect=["world"])
def test_exchange_bit_exact_against_stacked_and_oracle(world, n, dt, mode):
    check_exchange(world, n, dt, mode)


@pytest.mark.parametrize("world,n", params_for("baseline", (P,)), indirect=["world"])
def test_baseline_all_to_all_equals_the_oracle(world, n):
    check_baseline(world, n)


@pytest.mark.parametrize("world,n", params_for("layer", (P,)), indirect=["world"])
def test_moe_layer_forward_and_gradients_equal_stacked(world, n):
    check_layer(world, n)


@pytest.mark.parametrize("world", [P], indirect=True, ids=["P8"])
def test_train_step_across_8_processes_equals_stacked_ep4(world):
    hold_train(world["train"], 4)


@pytest.mark.parametrize("world", [P], indirect=True, ids=["P8"])
def test_train_step_across_8_processes_near_jax_single_device(world):
    got = world["train"]
    _, jloss = jax_train_ref()
    for g in got:
        assert np.isfinite(g["loss"]) and abs(g["loss"] - jloss) < 5e-2


@pytest.mark.parametrize("world,arch", [pytest.param(P, a, id=f"P8-{a}")
                                        for a in PLACED_ARCHS], indirect=["world"])
def test_placed_train_step_equals_one_process(world, arch):
    check_placed(world, arch)


@pytest.mark.parametrize("world,arch", [pytest.param(P, a, id=f"P8-{a}")
                                        for a in PLACED_ARCHS], indirect=["world"])
def test_placed_train_step_runs_the_blocks_tensor_parallel(world, arch):
    check_placed_tp(world, arch)


@pytest.mark.parametrize("world,case", [pytest.param(P, c, id=f"P8-{c}")
                                        for c in TP_CASES], indirect=["world"])
def test_tp_train_step_equals_one_process(world, case):
    check_tp_train(world, case)


@pytest.mark.parametrize("world,case", [pytest.param(P, c, id=f"P8-{c}")
                                        for c in SERVE_CASES], indirect=["world"])
def test_serving_across_processes_equals_one_process(world, case):
    check_serving(world, case)
