"""The port's executor on gloo worlds of 1 and 2 processes (on the CPU)
against the stacked one (the cases and checks: ``torch_dist_common.py``).

* the dataplane at P = 1 and 2 for n = 8, G = 4 and at P = 2 for n = 4,
  G = 2, in the three modes, f32 and bf16: ``y`` and ``recv`` bit-exact
  against the stacked executor and ``ref_all_to_allv``, and the plan's
  digest the same on every process and the stacked executor's;
  ``baseline_all_to_all`` against the oracle;
* the MoE layer forward and its gradients against the stacked path's;
* the masked branch (tokens replicated over the model group) at P = 2;
* the train step on (data 2, model 1) across 2 processes without EP
  (ep_size 1) against the stacked one.
"""

import pytest

from torch_dist_common import (check_baseline, check_exchange, check_layer, check_masked,
                               exchange_params, hold_train, params_for, world)  # noqa: F401

pytestmark = pytest.mark.torch_port

WORLDS = (1, 2)


@pytest.mark.parametrize("world,n,dt,mode", exchange_params(WORLDS), indirect=["world"])
def test_exchange_bit_exact_against_stacked_and_oracle(world, n, dt, mode):
    check_exchange(world, n, dt, mode)


@pytest.mark.parametrize("world,n", params_for("baseline", WORLDS), indirect=["world"])
def test_baseline_all_to_all_equals_the_oracle(world, n):
    check_baseline(world, n)


@pytest.mark.parametrize("world,n", params_for("layer", WORLDS), indirect=["world"])
def test_moe_layer_forward_and_gradients_equal_stacked(world, n):
    check_layer(world, n)


@pytest.mark.parametrize("world", [2], indirect=True, ids=["P2"])
def test_masked_branch_forward_equals_stacked_and_its_gradients_equal_stacked(world):
    check_masked(world)


@pytest.mark.parametrize("world", [2], indirect=True, ids=["P2"])
def test_ep1_train_step_on_data_2_model_1_equals_stacked(world):
    """No EP with a mesh: the batch over data, the load-balance loss still
    the global batch's (each process's aux is not its shard's)."""
    hold_train(world["train-ep1"], 1)
