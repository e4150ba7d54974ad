"""Port's stacked-rank dataplane against the JAX package's numpy oracle.

``repro.core.dataplane.ref_all_to_allv`` is the oracle the reference's own
selftest holds its shard_map dataplane to; the port's executor must match
it bit for bit, with equal receive counts, in all three modes.
"""

import numpy as np
import pytest
import torch

from repro.core.dataplane import ref_all_to_allv
from repro_torch.core.dataplane import NimbleAllToAll
from repro_torch.core.dataplane import ref_all_to_allv as port_ref
from repro_torch.core.planner import PlannerConfig

pytestmark = pytest.mark.torch_port


def _inputs(n, C, E, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, n, C, E)).astype(np.float32)
    counts = rng.integers(0, C + 1, size=(n, n)).astype(np.int32)
    for s in range(n):
        for d in range(n):
            x[s, d, counts[s, d]:] = 0.0
    return x, counts


# chunk_bytes 4 MiB makes every message large enough to split over relays
@pytest.mark.parametrize("chunk_bytes", [128.0, float(4 << 20)])
@pytest.mark.parametrize("mode", ["direct", "stripe", "nimble"])
@pytest.mark.parametrize("n,C,E", [(8, 16, 32), (16, 8, 8)])
def test_stacked_executor_bit_exact(n, C, E, mode, chunk_bytes):
    x, counts = _inputs(n, C, E, seed=n)
    comm = NimbleAllToAll(n, 4, max_chunks=C, chunk_bytes=chunk_bytes, mode=mode)
    y, recv = comm(torch.as_tensor(x), torch.as_tensor(counts))
    yref, rref = ref_all_to_allv(x, counts)
    np.testing.assert_array_equal(y.numpy(), yref)
    np.testing.assert_array_equal(recv.numpy(), rref)
    if mode != "direct" and chunk_bytes > 1e6:
        # the multi-path modes really took alternate paths here
        plan = comm.plan_from_counts(torch.as_tensor(counts))
        assert int(plan[..., 1:].sum()) > 0


def test_port_oracle_equals_reference_oracle():
    x, counts = _inputs(8, 4, 3, seed=5)
    for a, b in zip(port_ref(x, counts), ref_all_to_allv(x, counts)):
        np.testing.assert_array_equal(a, b)


def test_bfloat16_payload_moves_unchanged():
    x, counts = _inputs(8, 16, 32, seed=9)
    xb = torch.as_tensor(x).to(torch.bfloat16)
    comm = NimbleAllToAll(8, 4, max_chunks=16, chunk_bytes=1.0,
                          planner_cfg=PlannerConfig(split_threshold=0.0))
    y, _ = comm(xb, torch.as_tensor(counts))
    yref, _ = ref_all_to_allv(xb.float().numpy(), counts)
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(y.float().numpy(), yref)
