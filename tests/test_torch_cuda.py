"""The port's CUDA kernels against their plain versions, on the card.

Imports no JAX (the machine with the card has none): the plain versions
here are themselves held against the JAX package by the CPU tests in
``test_torch_kernels.py``.  Every test needs a CUDA device and skips
without one; run them on the card with

    python -m pytest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import planner
from repro_torch.core.dataplane import NimbleAllToAll, build_rel_of_pair, ref_all_to_allv
from repro_torch.core.incidence import incidence_for
from repro_torch.core.schedule import build_schedule
from repro_torch.core.topology import Topology
from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention.ops import flash_attention, mha_ref
from repro_torch.kernels.grouped_ffn.ops import (
    _arrange,
    grouped_ffn,
    grouped_ffn_blocked,
    grouped_ffn_blocked_ref,
)
from repro_torch.kernels.token_scatter.ops import token_gather, token_gather_ref

pytestmark = pytest.mark.torch_port


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n,m,d", [(64, 100, 32), (300, 1000, 4096), (17, 9, 3)])
def test_token_gather_matches_plain(cuda, dtype, idx_dtype, n, m, d):
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(n, d)), dtype=dtype, device=cuda)
    idx = torch.as_tensor(rng.integers(-1, n, size=(m,)), dtype=idx_dtype,
                          device=cuda)
    before = launch_counts()["token_gather"]
    out = token_gather(x, idx)
    torch.cuda.synchronize()
    # a copy: bit-exact
    assert torch.equal(out, token_gather_ref(x, idx))
    assert launch_counts()["token_gather"] == before + 1


def _ffn_inputs(rng, m, d, f, e, dtype, device):
    def t(shape, scale):
        return torch.as_tensor(rng.normal(size=shape) * scale, dtype=dtype,
                               device=device)
    return (t((m, d), 0.5), t((e, d, f), 0.05), t((e, d, f), 0.05),
            t((e, f, d), 0.05))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_grouped_ffn_blocked_matches_plain(cuda, dtype, tol):
    # f32 sums in another order: 1e-4 relative; bf16 output rounding: 2e-2
    rng = np.random.default_rng(1)
    m, d, f, e, bt = 256, 128, 192, 3, 64
    x, wg, wu, wd = _ffn_inputs(rng, m, d, f, e, dtype, cuda)
    be = torch.as_tensor([2, 0, 0, 1], dtype=torch.int32, device=cuda)
    y = grouped_ffn_blocked(x, be, wg, wu, wd, block_tokens=bt)
    torch.cuda.synchronize()
    ref = grouped_ffn_blocked_ref(x, be, wg, wu, wd, block_tokens=bt)
    scale = ref.float().abs().max()
    assert (y.float() - ref.float()).abs().max() <= tol * scale


def test_grouped_ffn_end_to_end_matches_cpu(cuda):
    # the sort/pad on the card equals the CPU's; f32 sums differ in order
    rng = np.random.default_rng(2)
    n, d, f, e = 300, 128, 128, 4
    x, wg, wu, wd = _ffn_inputs(rng, n, d, f, e, torch.float32, "cpu")
    eid = torch.as_tensor(rng.integers(-1, e, size=n))
    y_cpu = grouped_ffn(x, eid, wg, wu, wd, block_tokens=64)
    y = grouped_ffn(*(t.to(cuda) for t in (x, eid, wg, wu, wd)), block_tokens=64)
    o_cpu, p_cpu, b_cpu, m_cpu = _arrange(eid, e, 64)
    o, p, b, m = _arrange(eid.to(cuda), e, 64)
    assert m == m_cpu and torch.equal(o.cpu(), o_cpu)
    assert torch.equal(p.cpu(), p_cpu) and torch.equal(b.cpu(), b_cpu)
    np.testing.assert_allclose(y.cpu().numpy(), y_cpu.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("case", ["causal", "window", "offset", "full"])
def test_flash_attention_matches_plain(cuda, dtype, tol, dh, case):
    # online vs two-pass softmax: f32 2e-5 absolute (outputs are O(1));
    # bf16 inputs and output rounding: 1e-2
    rng = np.random.default_rng(3)
    b, h, hkv = 2, 4, 2
    sq, sk, kw = 200, 200, dict(causal=True, window=None, q_offset=0)
    if case == "window":
        kw["window"] = 50
    elif case == "offset":
        sq, sk, kw["q_offset"] = 130, 300, 170
    elif case == "full":
        kw["causal"] = False
    q = torch.as_tensor(rng.normal(size=(b, h, sq, dh)), dtype=dtype, device=cuda)
    k = torch.as_tensor(rng.normal(size=(b, hkv, sk, dh)), dtype=dtype, device=cuda)
    v = torch.as_tensor(rng.normal(size=(b, hkv, sk, dh)), dtype=dtype, device=cuda)
    o = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = mha_ref(q, k, v, **kw)
    assert (o.float() - ref.float()).abs().max() <= tol


@pytest.mark.parametrize("chunk_bytes", [128.0, float(4 << 20)])
@pytest.mark.parametrize("mode", ["direct", "stripe", "nimble"])
def test_dataplane_on_card_bit_exact(cuda, mode, chunk_bytes):
    rng = np.random.default_rng(0)
    n, C, E = 8, 16, 32
    x = rng.normal(size=(n, n, C, E)).astype(np.float32)
    counts = rng.integers(0, C + 1, size=(n, n)).astype(np.int32)
    for s in range(n):
        for d in range(n):
            x[s, d, counts[s, d]:] = 0.0
    comm = NimbleAllToAll(n, 4, max_chunks=C, chunk_bytes=chunk_bytes, mode=mode)
    y, r = comm(torch.as_tensor(x, device=cuda), torch.as_tensor(counts, device=cuda))
    yref, rref = ref_all_to_allv(x, counts)
    assert np.array_equal(y.cpu().numpy(), yref)
    assert np.array_equal(r.cpu().numpy(), rref)
    plan_card = comm.plan_from_counts(torch.as_tensor(counts, device=cuda))
    plan_cpu = comm.plan_from_counts(torch.as_tensor(counts))
    assert torch.equal(plan_card.cpu(), plan_cpu)


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("seed", range(4))
def test_planner_on_card_deterministic_and_equal_to_cpu(cuda, n, seed):
    # skewed demand, in chunks large enough to split over relay paths
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 5, size=(n, n))
    d[:, rng.choice(n, size=2, replace=False)] = rng.integers(8, 17, size=(n, 2))
    np.fill_diagonal(d, 0)
    dc = torch.as_tensor(d, dtype=torch.int32)
    topo = Topology(n, 4)
    tables, S = incidence_for(topo), build_schedule(topo, 16, 0.5).S
    rel = build_rel_of_pair(n, 4)
    cfg = planner.PlannerConfig(chunk_bytes=float(4 << 20))
    D = dc.to(cuda).float() * cfg.chunk_bytes
    f1, l1 = planner.plan_flows(D, tables, cfg)
    f2, l2 = planner.plan_flows(D, tables, cfg)
    assert torch.equal(f1, f2) and torch.equal(l1, l2)      # run to run
    on_card = planner.plan_chunks(dc.to(cuda), tables, cfg, S, rel)
    assert int(on_card[..., 1:].sum()) > 0                  # relays in use
    assert torch.equal(on_card.cpu(), planner.plan_chunks(dc, tables, cfg, S, rel))
