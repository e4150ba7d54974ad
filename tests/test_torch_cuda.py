"""The port's CUDA kernels against their plain versions, on the card.

Imports no JAX (the machine with the card has none): the plain versions
here are themselves held against the JAX package by the CPU tests in
``test_torch_kernels.py``.  Every test needs a CUDA device and skips
without one; run them on the card with

    python -m pytest -q tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import planner
from repro_torch.core.dataplane import NimbleAllToAll, build_rel_of_pair, ref_all_to_allv
from repro_torch.core.incidence import incidence_for
from repro_torch.core.schedule import build_schedule
from repro_torch.core.topology import Topology
from repro_torch.kernels import _build, launch_counts
from repro_torch.kernels.flash_attention.ops import flash_attention, mha_ref
from repro_torch.kernels.grouped_ffn.ops import (
    _arrange,
    _block_rows,
    grouped_ffn,
    grouped_ffn_blocked,
    grouped_ffn_blocked_ref,
)
from repro_torch.kernels.mlstm_scan.ops import mlstm_scan, mlstm_scan_chunked_ref
from repro_torch.kernels.relay_copy.ops import parity_slot_map, relay_copy, relay_copy_ref
from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
from repro_torch.kernels.grouped_ffn.ops import grouped_ffn_bwd
from repro_torch.kernels.token_scatter.ops import (
    build_inverse_index,
    geometry,
    inverse_index,
    token_gather,
    token_gather_ref,
    token_scatter_add,
    token_scatter_add_ref,
)
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw
from repro_torch import runtime as rt
from repro_torch.sharding.context import ParallelContext
from repro_torch.train.step import loss_and_grads, make_train_step
from repro_torch.tree import leaves, map_tree

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


def _gather_case(rng, n, m, d, dtype, idx_dtype, device):
    # indices past both ends: negative ones give zero rows, ones past the
    # last row read the last row
    x = torch.as_tensor(rng.normal(size=(n, d)), dtype=dtype, device=device)
    idx = torch.as_tensor(rng.integers(-3, n + 5, size=(m,)), dtype=idx_dtype, device=device)
    return x, idx


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n,m,d,dtype", [
    (1024, 1, 65536, torch.bfloat16),       # 128 KiB dispatch chunks, a decode-sized call
    (1024, 8, 65536, torch.bfloat16),
    (1024, 64, 65536, torch.bfloat16),
    (1024, 1024, 65536, torch.bfloat16),    # the prefill's relay round
    (256, 64, 65536 + 24, torch.bfloat16),  # not a multiple of the segment
    (2048, 4096, 16, torch.float32),        # the expert-id sideband's 64-byte rows
    (3731, 8704, 4096, torch.bfloat16),     # the FFN's sort/pad of 8 KiB rows
])
def test_token_gather_path_shapes_bit_exact(cuda, n, m, d, dtype, idx_dtype):
    x, idx = _gather_case(np.random.default_rng(m + d), n, m, d, dtype, idx_dtype, cuda)
    before = launch_counts()["token_gather"]
    out = token_gather(x, idx)
    torch.cuda.synchronize()
    assert torch.equal(out, token_gather_ref(x, idx))
    assert launch_counts()["token_gather"] == before + 1


@pytest.mark.parametrize("dtype,word", [(torch.float32, 4), (torch.bfloat16, 2)])
def test_token_gather_offset_views_take_narrow_routes(cuda, dtype, word):
    # a contiguous view one element into its storage: 16-byte rows, but a
    # base address aligned to 4 (f32) or 2 (bf16) bytes only
    rng = np.random.default_rng(word)
    n, m, d = 300, 500, 4104
    flat = torch.as_tensor(rng.normal(size=(n * d + 1,)), dtype=dtype, device=cuda)
    x = flat[1:].view(n, d)
    idx = torch.as_tensor(rng.integers(-2, n + 2, size=(m,)), device=cuda)
    out = token_gather(x, idx)
    torch.cuda.synchronize()
    assert geometry(d * x.element_size(), m, x.data_ptr() | out.data_ptr()).word == word
    assert torch.equal(out, token_gather_ref(x, idx))


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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 1e-2)])
def test_flash_attention_at_smollm_heads(cuda, dtype, tol):
    # smollm-135m's attention: 9 query heads over 3 kv heads of 64, causal;
    # the forward on its route (the tolerances of
    # test_flash_attention_matches_plain) and the gradients against the CPU's
    # (those of test_flash_backward_on_card_equals_cpu)
    rng = np.random.default_rng(9)
    q, k, v, g = (torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)
                  for shape in ((2, 9, 320, 64), (2, 3, 320, 64), (2, 3, 320, 64),
                                (2, 9, 320, 64)))
    count = "flash_attention" if dtype == torch.bfloat16 else "flash_attention_f32"
    before = launch_counts()[count]
    qc, kc, vc = (t.to(cuda, dtype) for t in (q, k, v))
    o = flash_attention(qc, kc, vc)
    torch.cuda.synchronize()
    assert launch_counts()[count] == before + 1
    assert (o.float() - mha_ref(qc, kc, vc).float()).abs().max() <= tol
    want = flash_attention_bwd(q, k, v, g)
    live = [t.requires_grad_(True) for t in (qc, kc, vc)]
    got = torch.autograd.grad(flash_attention(*live), live, g.to(cuda, dtype))
    gtol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, want):
        assert (a.cpu().float() - b).abs().max() <= gtol * b.abs().max()


# ---- the bf16 tensor-core routes (wgmma fed by TMA) ------------------------

def _ffn_tc_close(y, ref):
    # H rounds to bf16 between the passes (2^-9 relative, in sums of F terms
    # of both signs, so about 2^-9 of a typical |y|) and y rounds to bf16:
    # within 2e-2 x max|ref|, as the bf16 route always was
    scale = ref.float().abs().max()
    assert (y.float() - ref.float()).abs().max() <= 2e-2 * scale


def test_grouped_ffn_tc_one_tile(cuda):
    rng = np.random.default_rng(4)
    x, wg, wu, wd = _ffn_inputs(rng, 64, 128, 128, 1, torch.bfloat16, cuda)
    be = torch.zeros(1, dtype=torch.int32, device=cuda)
    before = launch_counts()
    y = grouped_ffn_blocked(x, be, wg, wu, wd, block_tokens=64)
    torch.cuda.synchronize()
    _ffn_tc_close(y, grouped_ffn_blocked_ref(x, be, wg, wu, wd, block_tokens=64))
    after = launch_counts()
    assert after["grouped_ffn_blocked"] == before["grouped_ffn_blocked"] + 1
    assert after["grouped_ffn_blocked_f32"] == before["grouped_ffn_blocked_f32"]


@pytest.mark.parametrize("bt", [64, 128])
def test_grouped_ffn_tc_ragged_f(cuda, bt):
    # F 192: the second 128-column tile of pass 1 is half past F (TMA fills
    # zeros, the store stops at F); bt 128: a block is a pair of tiles
    rng = np.random.default_rng(bt)
    m, d, f, e = 4 * bt, 256, 192, 3
    x, wg, wu, wd = _ffn_inputs(rng, m, d, f, e, torch.bfloat16, cuda)
    be = torch.as_tensor([2, 0, 0, 1], dtype=torch.int32, device=cuda)
    y = grouped_ffn_blocked(x, be, wg, wu, wd, block_tokens=bt)
    torch.cuda.synchronize()
    _ffn_tc_close(y, grouped_ffn_blocked_ref(x, be, wg, wu, wd, block_tokens=bt))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bt", [64, 128])
def test_grouped_ffn_block_rows_skips_padding(cuda, dtype, bt):
    # a full, a partial, an empty and an almost full block; x is nonzero in
    # the padding too, so the skipped rows must be written as exact zeros
    rng = np.random.default_rng(5 + bt)
    m, d, f, e = 4 * bt, 128, 192, 3
    x, wg, wu, wd = _ffn_inputs(rng, m, d, f, e, dtype, cuda)
    be = torch.as_tensor([2, 0, 1, 2], dtype=torch.int32, device=cuda)
    rows = torch.as_tensor([bt, 5, 0, bt - 1], dtype=torch.int32, device=cuda)
    y = grouped_ffn_blocked(x, be, wg, wu, wd, block_tokens=bt, block_rows=rows)
    torch.cuda.synchronize()
    ref = grouped_ffn_blocked_ref(x, be, wg, wu, wd, block_tokens=bt, block_rows=rows)
    live = torch.arange(m, device=cuda) % bt < rows.long().repeat_interleave(bt)
    assert bool((y[~live] == 0).all())
    if dtype == torch.bfloat16:
        _ffn_tc_close(y, ref)
    else:   # f32 sums in another order
        assert (y - ref).abs().max() <= 1e-4 * ref.abs().max()


def test_grouped_ffn_block_rows_on_card_equals_cpu(cuda):
    # _block_rows from device ops equals the CPU's, and the sort/pad path
    # through it equals the CPU's plain version
    rng = np.random.default_rng(6)
    eid = torch.as_tensor(rng.integers(-1, 4, size=300))
    assert torch.equal(_block_rows(eid.to(cuda), 4, 64).cpu(), _block_rows(eid, 4, 64))
    x, wg, wu, wd = _ffn_inputs(rng, 300, 128, 128, 4, torch.bfloat16, "cpu")
    y_cpu = grouped_ffn(x, eid, wg, wu, wd, block_tokens=64)
    y = grouped_ffn(*(t.to(cuda) for t in (x, eid, wg, wu, wd)), block_tokens=64)
    _ffn_tc_close(y.cpu(), y_cpu)


def _flash_inputs(rng, b, h, hkv, sq, sk, dh, dtype, device):
    def t(shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=dtype, device=device)
    return t((b, h, sq, dh)), t((b, hkv, sk, dh)), t((b, hkv, sk, dh))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [64, 128])
def test_flash_tc_one_tile(cuda, dh, causal):
    # one 64-row query tile and one kv tile.  bf16 inputs and output: 1e-2
    # absolute (outputs are O(1)); P enters P V as its bf16 rounding plus the
    # rounding's bf16 residual, about 16 bits, so P adds no bf16-sized error
    rng = np.random.default_rng(dh)
    q, k, v = _flash_inputs(rng, 1, 1, 1, 64, 64, dh, torch.bfloat16, cuda)
    before = launch_counts()
    o = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (o.float() - mha_ref(q, k, v, causal=causal).float()).abs().max() <= 1e-2
    after = launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["flash_attention_f32"] == before["flash_attention_f32"]


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("case", ["causal", "window", "offset", "full"])
def test_flash_tc_ragged_edges(cuda, dh, case):
    # Sq 200 and Sk 300: partial query and kv tiles, zero-filled by TMA and
    # masked (keys past Sk) or not stored (rows past Sq); GQA 4 / 2.  The
    # tolerance and its reason as in test_flash_tc_one_tile
    rng = np.random.default_rng(7)
    kw = dict(causal=case != "full", window=50 if case == "window" else None,
              q_offset=100 if case == "offset" else 0)
    q, k, v = _flash_inputs(rng, 2, 4, 2, 200, 300, dh, torch.bfloat16, cuda)
    o = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (o.float() - mha_ref(q, k, v, **kw).float()).abs().max() <= 1e-2


def test_main_path_bf16_runs_tensor_core_routes(cuda):
    # paper-moe-8e (reduced, 8 experts, EP 8 in groups of 4) in bf16: its
    # prefill reaches the FFN and flash through their tensor-core routes only
    cfg = dataclasses.replace(get_config("paper-moe-8e").reduced(), n_experts=8)
    ctx = ParallelContext(ep_size=8, group_size=4, moe_mode="nimble",
                          param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                          device="cuda")
    model = build_model(cfg, ctx)
    params = model.init(0)
    tokens = torch.as_tensor(np.random.default_rng(8).integers(0, cfg.vocab, (2, 128)),
                             device=cuda)
    before = launch_counts()
    logits, _ = model.forward(params, {"tokens": tokens})
    torch.cuda.synchronize()
    after = launch_counts()
    assert bool(torch.isfinite(logits).all())
    for name in ("grouped_ffn_blocked", "flash_attention"):
        assert after[name] > before[name]
        assert after[f"{name}_f32"] == before[f"{name}_f32"]


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


@pytest.mark.parametrize("n", [8, 32])
def test_planner_load_sum_on_card_equals_cpu_on_jittered_demand(cuda, n):
    # real-valued demand: the loads' last bits depend on the order of the
    # sum, and at n=32 a resource has hundreds of charging entries
    trace = np.concatenate([rt.drifting_skew_trace(n, 3, dwell=1),
                            rt.skew_burst_trace(n, 3, burst_window=1)])
    tables = incidence_for(Topology(n, 4))
    d = torch.as_tensor(trace.astype(np.float32))
    prev = torch.rand((len(trace), tables.n_resources), generator=torch.Generator().manual_seed(n)) * 5e8
    for kw in ({}, {"prev_loads": prev, "ext_loads": prev.flip(0)}):
        f_cpu, l_cpu = planner.plan_flows_batch(d, tables, **kw)
        f_gpu, l_gpu = planner.plan_flows_batch(
            d.to(cuda), tables, **{k: v.to(cuda) for k, v in kw.items()})
        assert torch.equal(f_gpu.cpu(), f_cpu) and torch.equal(l_gpu.cpu(), l_cpu)


@pytest.mark.parametrize("scenario", ["drift", "drift-n32", "link-down"])
def test_runtime_on_card_equals_cpu(cuda, scenario):
    n = 32 if scenario == "drift-n32" else 8
    topo = Topology(n, 4)
    if scenario == "link-down":
        trace = rt.balanced_trace(n, 24)
        events = rt.EventLog([rt.link_down(8, 0, 4)])
    else:
        trace, events = rt.drifting_skew_trace(n, 48, dwell=12), None
    runs = {dev: rt.OrchestrationRuntime(topo, events=events, device=dev).run_trace(trace)
            for dev in ("cuda", "cpu")}
    assert runs["cuda"].to_json_obj() == runs["cpu"].to_json_obj()
    if n == 8:
        assert rt.run_oracle(topo, trace, device="cuda").to_json_obj() == \
            rt.run_oracle(topo, trace, device="cpu").to_json_obj()


def test_runtime_raises_without_a_card(monkeypatch):
    # runs on any host: the CUDA device is hidden, and nothing falls back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = Topology(8, 4)
    trace = rt.balanced_trace(8, 2)
    for call in (lambda: rt.OrchestrationRuntime(topo),
                 lambda: rt.run_static(topo, trace),
                 lambda: rt.run_oracle(topo, trace),
                 lambda: rt.solve_plans_batch(topo, trace)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert rt.OrchestrationRuntime(topo, device="cpu").run_trace(trace).stats.windows == 2


@pytest.mark.parametrize("arm", ["legacy", "calibrated"])
def test_arbitrated_sessions_on_card_equal_cpu(cuda, arm):
    """Two arbitrated runtime tenants on one fabric (the mutual-drift arm,
    24 windows): every priced replan solved on the card gives the CPU's
    figures and reports."""
    from repro_torch.launch import fairness

    runs = {}
    for dev in ("cuda", "cpu"):
        reports = {}
        rec = fairness.mutual_drift_arm(arm, windows=24, device=dev, reports=reports)
        for r in reports.values():
            r.pop("topology")
        runs[dev] = (rec, reports)
    assert runs["cuda"] == runs["cpu"]
    assert runs["cuda"][1][f"mutual_drift {arm} a"]["runtime_stats"]["solves"] > 1


@pytest.mark.parametrize("mode", ["nimble", "stripe"])
def test_plan_batch_on_card_equals_cpu(cuda, mode):
    from repro_torch.api import Session, SessionSpec, TopologySpec

    rng = np.random.default_rng(3)
    demand = rng.integers(0, 16, size=(4, 8, 8)).astype(np.int32)
    for b in range(4):
        np.fill_diagonal(demand[b], 0)
    plans, tels = {}, {}
    for dev in ("cuda", "cpu"):
        spec = SessionSpec(topology=TopologySpec(8, 4), adaptivity="adaptive", device=dev)
        with Session(spec) as sess:
            comm = sess.all_to_all(max_chunks=16, chunk_bytes=1024.0, mode=mode)
            out = comm.plan_batch(torch.as_tensor(demand, device=dev))
            assert out.device.type == dev
            plans[dev], tels[dev] = out.cpu(), sess.runtime.telemetry.to_json_obj()
    assert torch.equal(plans["cuda"], plans["cpu"])
    assert tels["cuda"] == tels["cpu"]


def test_session_raises_without_a_card(monkeypatch):
    # runs on any host: the CUDA device is hidden, and nothing falls back
    from repro_torch.api import Session, SessionSpec, TopologySpec

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for adaptivity in ("static", "adaptive", "arbitrated"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Session(SessionSpec(topology=TopologySpec(8, 4), adaptivity=adaptivity))
    spec = SessionSpec(topology=TopologySpec(8, 4), adaptivity="arbitrated", device="cpu")
    with Session(spec) as sess:
        assert sess.step(rt.balanced_trace(8, 1)[0]).window == 0


@pytest.mark.parametrize("section", ["flap", "tenant_crash"])
def test_drill_on_card_equals_cpu(cuda, section):
    """A fault drill with every solve on the card: the section's figures (its
    schedule digest included) and every DrillResult or window report equal
    the CPU's."""
    from repro_torch.launch import drills

    runs = {}
    for dev in ("cuda", "cpu"):
        reports = {}
        runs[dev] = (drills.SECTIONS[section](device=dev, reports=reports), reports)
    assert runs["cuda"] == runs["cpu"]


def test_scenario_on_card_equals_cpu(cuda):
    """``elephant_victim`` through both control-plane arms on the card: the
    ServeReports and the SLO verdict equal the CPU's."""
    from repro_torch.serve import evaluate_scenario, get_scenario

    res = {dev: evaluate_scenario(get_scenario("elephant_victim"), device=dev)
           for dev in ("cuda", "cpu")}
    for arm in ("adaptive", "static"):
        assert res["cuda"][arm].to_json_obj() == res["cpu"][arm].to_json_obj()
    assert res["cuda"]["slo"] == res["cpu"]["slo"] and res["cuda"]["slo"]["pass"]


def test_recorded_run_on_card_equals_cpu(cuda):
    """``flap_under_load``'s adaptive arm flight-recorded on the card: the
    trace event for event, the provenance log and the metrics snapshot equal
    the CPU's, and the recorded report equals an unrecorded one."""
    from repro_torch.obs import FlightRecorder, validate_trace
    from repro_torch.serve import get_scenario, run_scenario

    spec = get_scenario("flap_under_load")
    recs, reps = {}, {}
    for dev in ("cuda", "cpu"):
        recs[dev] = FlightRecorder("card-vs-cpu")
        reps[dev] = run_scenario(spec, "adaptive", recorder=recs[dev], device=dev)
    assert reps["cuda"].to_json_obj() == reps["cpu"].to_json_obj()
    assert recs["cuda"].export_trace() == recs["cpu"].export_trace()
    assert recs["cuda"].provenance.to_json_obj() == recs["cpu"].provenance.to_json_obj()
    assert recs["cuda"].metrics_snapshot() == recs["cpu"].metrics_snapshot()
    info = validate_trace(recs["cuda"].export_trace())
    assert {"serve", "runtime", "fabric", "planner"} <= set(info["cats"])
    plain = run_scenario(spec, "adaptive", device="cuda").to_json_obj()
    recorded = reps["cuda"].to_json_obj()
    recorded.pop("metrics")
    assert recorded == plain


def test_control_plane_raises_without_a_card(monkeypatch):
    # runs on any host: the CUDA device is hidden, and nothing falls back
    from repro_torch.launch import drills, serve
    from repro_torch.serve import ControlPlane, evaluate_scenario, get_scenario

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = get_scenario("minimal")
    for call in (lambda: ControlPlane(spec),
                 lambda: ControlPlane(spec, mode="static"),
                 lambda: evaluate_scenario(spec),
                 lambda: drills.perturb(),
                 lambda: serve.main(["--scenario", "minimal"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert ControlPlane(spec, device="cpu").run().windows == spec.windows


def _mlstm_inputs(rng, b, h, s, dh, device):
    # the reference's kernel-test inputs (tests/test_mlstm_scan_kernel.py)
    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)
    q, k, v = (t(rng.normal(size=(b, h, s, dh)) * 0.3) for _ in range(3))
    ig = t(rng.normal(size=(b, h, s)) * 0.5)
    fg = rng.normal(size=(b, h, s)) + 2.0
    lf = t(np.log(1.0 / (1.0 + np.exp(-fg))))
    return q, k, v, ig, lf


def _close(got, want, rtol=2e-4, atol=2e-5):
    # f32 sums over dh and the chunk in another order: the reference's own
    # kernel tolerance
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("b,h,s,dh,chunk", [
    (2, 2, 64, 16, 16),
    (1, 3, 96, 32, 64),      # S padded to 128 (L = 64)
    (2, 4, 256, 64, 64),
    (1, 2, 200, 48, 64),     # a partial 32-column value slice, S padded
    (1, 4, 8, 192, 64),      # an 8-token prompt: L = 8
    (1, 4, 320, 192, 64),    # xlstm-125m's head dim
    (1, 1, 130, 64, 64),     # B * H = 1
    (2, 2, 160, 100, 64),    # a head dim that fills no 64-row tile
    (1, 1, 72, 100, 16),
    (1, 2, 100, 50, 64),     # dh % 4 != 0: the 4-byte route
    (1, 1, 1100, 12, 1),     # 1100 chunks: the chain runs in windows of 1024
    (1, 4, 2048, 192, 64),   # xlstm-125m's prefill length
])
def test_mlstm_scan_matches_plain(cuda, b, h, s, dh, chunk):
    rng = np.random.default_rng(s + dh)
    q, k, v, ig, lf = _mlstm_inputs(rng, b, h, s, dh, cuda)
    before = launch_counts()["mlstm_scan"]
    got, st = mlstm_scan(q, k, v, ig, lf, chunk=chunk)
    torch.cuda.synchronize()
    assert launch_counts()["mlstm_scan"] == before + 1
    want, st_ref = mlstm_scan_chunked_ref(q, k, v, ig, lf, chunk=chunk)
    assert got.shape == (b, h, s, dh)
    _close(got, want)
    for key in ("C", "n", "m"):
        _close(st[key], st_ref[key])


def test_mlstm_scan_carries_state(cuda):
    # two calls chained through the carried state equal one call
    rng = np.random.default_rng(7)
    q, k, v, ig, lf = _mlstm_inputs(rng, 2, 4, 192, 192, cuda)
    whole, st_whole = mlstm_scan(q, k, v, ig, lf, chunk=64)
    a, st_a = mlstm_scan(*(x[:, :, :100] for x in (q, k, v, ig, lf)), chunk=64)
    b, st_b = mlstm_scan(*(x[:, :, 100:] for x in (q, k, v, ig, lf)), chunk=64,
                         state=st_a)
    torch.cuda.synchronize()
    _close(torch.cat([a, b], dim=2), whole)
    ref_b, st_ref = mlstm_scan_chunked_ref(*(x[:, :, 100:] for x in (q, k, v, ig, lf)),
                                           chunk=64, state=st_a)
    _close(b, ref_b)
    for key in ("C", "n", "m"):
        _close(st_b[key], st_whole[key])
        _close(st_b[key], st_ref[key])


def test_mlstm_scan_carries_state_at_a_ragged_head_dim(cuda):
    rng = np.random.default_rng(11)
    q, k, v, ig, lf = _mlstm_inputs(rng, 1, 2, 300, 100, cuda)
    _, st_a = mlstm_scan(*(x[:, :, :130] for x in (q, k, v, ig, lf)), chunk=64)
    b, st_b = mlstm_scan(*(x[:, :, 130:] for x in (q, k, v, ig, lf)), chunk=64, state=st_a)
    torch.cuda.synchronize()
    ref_b, st_ref = mlstm_scan_chunked_ref(*(x[:, :, 130:] for x in (q, k, v, ig, lf)),
                                           chunk=64, state=st_a)
    _close(b, ref_b)
    for key in ("C", "n", "m"):
        _close(st_b[key], st_ref[key])


_RELAY_ROUTES = ("relay_copy", "relay_copy_w4", "relay_copy_w2")


def _relay_launches():
    counts = launch_counts()
    return sum(counts[r] for r in _RELAY_ROUTES)


def _relay_input(rng, n, d, dtype, device):
    if dtype == torch.int32:
        return torch.as_tensor(rng.integers(-100, 100, size=(n, d)), dtype=dtype,
                               device=device)
    return torch.as_tensor(rng.normal(size=(n, d)), dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("n,d,bc", [(1024, 64, 256), (512, 128, 64), (256, 32, 256),
                                    (8192, 4096, 256), (45, 7, 15)])
def test_relay_copy_bit_exact_under_every_slot_map(cuda, dtype, n, d, bc):
    rng = np.random.default_rng(n + d)
    x = _relay_input(rng, n, d, dtype, cuda)
    n_chunks = n // bc
    maps = [None, parity_slot_map(n_chunks, cuda), 1 - parity_slot_map(n_chunks, cuda),
            torch.zeros(n_chunks, dtype=torch.int32, device=cuda)]
    for slot_map in maps:
        before = _relay_launches()
        out = relay_copy(x, slot_map, block_chunk=bc)
        torch.cuda.synchronize()
        assert _relay_launches() == before + 1
        assert out.dtype == x.dtype and out.data_ptr() != x.data_ptr()
        assert torch.equal(out, x)
        assert torch.equal(out, relay_copy_ref(x, slot_map, block_chunk=bc))


@pytest.mark.parametrize("dtype,n,d,bc,offset,route", [
    (torch.bfloat16, 8192, 4096, 256, 0, "relay_copy"),      # phase 13's shape: bulk
    (torch.float32, 512, 128, 64, 0, "relay_copy"),
    (torch.int32, 96, 4, 3, 0, "relay_copy"),                # 48-byte chunks, 16-byte tiles
    (torch.float32, 45, 7, 15, 0, "relay_copy_w4"),          # 420-byte chunks
    (torch.int32, 45, 7, 15, 0, "relay_copy_w4"),
    (torch.bfloat16, 45, 7, 15, 0, "relay_copy_w2"),         # 210-byte chunks
    (torch.float32, 512, 128, 64, 1, "relay_copy_w4"),       # a view 4 bytes off
    (torch.bfloat16, 512, 128, 64, 1, "relay_copy_w2"),      # a view 2 bytes off
])
def test_relay_copy_takes_each_route_bit_exact(cuda, dtype, n, d, bc, offset, route):
    # the route follows the chunk size's and both pointers' alignment; every
    # route is bit-exact under the parity, swapped and all-zeros maps
    rng = np.random.default_rng(n + d + offset)
    flat = _relay_input(rng, 1, n * d + offset, dtype, cuda)[0]
    x = flat[offset:].view(n, d)
    n_chunks = n // bc
    for slot_map in (parity_slot_map(n_chunks, cuda), 1 - parity_slot_map(n_chunks, cuda),
                     torch.zeros(n_chunks, dtype=torch.int32, device=cuda)):
        before = launch_counts()
        out = relay_copy(x, slot_map, block_chunk=bc)
        torch.cuda.synchronize()
        after = launch_counts()
        assert {r: after[r] - before[r] for r in _RELAY_ROUTES} == {
            r: int(r == route) for r in _RELAY_ROUTES}
        assert torch.equal(out.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                           x.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


def test_relay_copy_new_slot_map_reuses_the_loaded_kernel(cuda):
    # a new schedule is an argument: same library, no build, no host read of
    # the map (any synchronizing call raises in sync-debug "error" mode)
    rng = np.random.default_rng(3)
    x = _relay_input(rng, 2048, 256, torch.bfloat16, cuda)
    relay_copy(x, block_chunk=256)
    lib = _build.library("relay_copy")
    built = sorted(_build.BUILD_DIR.glob("librelay_copy-*.so"))
    outs = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for slot_map in (1 - parity_slot_map(8, cuda),
                         torch.zeros(8, dtype=torch.int32, device=cuda),
                         torch.ones(8, dtype=torch.int32, device=cuda)):
            outs.append(relay_copy(x, slot_map, block_chunk=256))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _build.library("relay_copy") is lib
    assert sorted(_build.BUILD_DIR.glob("librelay_copy-*.so")) == built
    assert all(torch.equal(o, x) for o in outs)


def test_relay_copy_refuses_bad_maps(cuda):
    x = torch.zeros((512, 16), device=cuda)
    with pytest.raises(ValueError):
        relay_copy(x, torch.zeros(3, dtype=torch.int32, device=cuda), block_chunk=256)
    with pytest.raises(ValueError):
        relay_copy(x, torch.zeros(2, dtype=torch.int64, device=cuda), block_chunk=256)
    with pytest.raises(ValueError):
        relay_copy(x, torch.zeros(2, dtype=torch.int32), block_chunk=256)


@pytest.mark.parametrize("kernel", ["relay_copy"])
def test_kernel_without_backward_raises_under_grad(cuda, kernel):
    # the CUDA route has no backward: an input that needs a gradient raises
    # (a silent zero gradient otherwise); without grad mode, or without such
    # an input, it runs.  (mlstm_scan has its backward:
    # test_mlstm_scan_gradients_on_card_equal_cpu)
    rng = np.random.default_rng(11)
    args = [_relay_input(rng, 512, 64, torch.float32, cuda)]

    def run(a):
        return relay_copy(a[0], block_chunk=256)
    for i in range(len(args)):
        live = [a.clone().requires_grad_(j == i) for j, a in enumerate(args)]
        with pytest.raises(RuntimeError, match="backward"):
            run(live)
        with torch.no_grad():
            assert torch.equal(run(live), run(args))
    assert torch.isfinite(run(args)).all()


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("b,h,s,dh,chunk", [
    (1, 2, 64, 16, 16),
    (2, 2, 100, 48, 32),     # S padded, a partial value slice
    (1, 4, 300, 192, 64),    # xlstm-125m's head dim and chunk, S padded
])
def test_mlstm_scan_gradients_on_card_equal_cpu(cuda, with_state, b, h, s, dh, chunk):
    # under a gradient the card runs the kernel's forward (one launch) and
    # MLSTMScanFunction's backward from the kernel's chunk states; the CPU
    # differentiates its plain version by autograd.  f32 sums in other
    # orders: 1e-4 of each gradient's largest value
    rng = np.random.default_rng(s + dh + with_state)
    ins = _mlstm_inputs(rng, b, h, s, dh, "cpu")
    st = None
    if with_state:
        st = {"C": torch.as_tensor(rng.normal(size=(b, h, dh, dh)) * 0.2, dtype=torch.float32),
              "n": torch.as_tensor(rng.normal(size=(b, h, dh)) * 0.2, dtype=torch.float32),
              "m": torch.as_tensor(rng.normal(size=(b, h)), dtype=torch.float32)}
    cots = [torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)
            for shape in ((b, h, s, dh), (b, h, dh, dh), (b, h, dh), (b, h))]
    grads = []
    for dev in ("cpu", cuda):
        live = [a.to(dev).requires_grad_(True) for a in ins]
        lst = None if st is None else {k: a.to(dev).requires_grad_(True) for k, a in st.items()}
        before = launch_counts()["mlstm_scan"]
        hh, fin = mlstm_scan(*live, chunk=chunk, state=lst)
        outs = (hh, fin["C"], fin["n"], fin["m"])
        wrt = live + ([] if lst is None else list(lst.values()))
        grads.append([g.cpu() for g in torch.autograd.grad(outs, wrt, [c.to(dev) for c in cots])])
        if dev != "cpu":
            assert launch_counts()["mlstm_scan"] == before + 1
    for a, want in zip(grads[1], grads[0]):
        assert (a - want).abs().max() <= 1e-4 * want.abs().max()


# --------------------------------------------------------------------------- #
# token_scatter_add (token_gather's backward) and the training path
# --------------------------------------------------------------------------- #


def _scatter_case(rng, n, d, dtype, idx_dtype, device, offset=0):
    """g and idx where output row r has r % 4 sources (0-3), plus indices
    below 0 (dropped) and past n - 1 (clipped onto row n - 1)."""
    rows = np.repeat(np.arange(n), np.arange(n) % 4)
    idx = np.concatenate([rows, [-1, -5, n + 3]])
    idx = rng.permutation(idx)
    m = idx.size
    flat = torch.as_tensor(rng.normal(size=(m * d + offset,)), dtype=dtype, device=device)
    g = flat[offset:].view(m, d)
    return g, torch.as_tensor(idx, dtype=idx_dtype, device=device)


def _check_scatter(g, idx, n, out):
    # rows of at most two sources round once: bit-exact against the CPU's
    # plain version; three sources sum in another order: one f32 rounding,
    # so within 2^-8 of the row's magnitude after bf16 rounding (1e-6 in f32)
    want = token_scatter_add_ref(g.cpu(), idx.cpu(), n)
    got = out.cpu()
    key = torch.where(idx.cpu() < 0, n, idx.cpu().clamp_max(n - 1))
    mult = torch.bincount(key, minlength=n + 1)[:n]
    low = mult <= 2
    assert torch.equal(got[low], want[low])
    tol = 2.0 ** -8 if g.dtype == torch.bfloat16 else 1e-6
    err = (got.float() - want.float()).abs().max(1).values
    assert bool((err <= tol * (want.float().abs().max(1).values + 1e-30)).all())


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,offset", [
    (40, 3, 0),          # 12- or 6-byte rows: 4- and 2-byte words
    (64, 64, 0),
    (300, 4096, 0),      # the dispatch's 8 KiB bf16 rows
    (64, 65536, 0),      # a 128 KiB payload row: several segments a row
    (50, 65536 + 24, 0),  # not a multiple of the segment
    (100, 4104, 1),      # an offset view: the 4-byte (f32) or 2-byte (bf16) route
])
def test_token_scatter_add_matches_plain(cuda, dtype, idx_dtype, n, d, offset):
    rng = np.random.default_rng(n + d + offset)
    g, idx = _scatter_case(rng, n, d, dtype, idx_dtype, cuda, offset)
    before = launch_counts()["token_scatter_add"]
    out = token_scatter_add(g, idx, n)
    torch.cuda.synchronize()
    assert out.dtype == dtype and tuple(out.shape) == (n, d)
    assert launch_counts()["token_scatter_add"] == before + 1
    _check_scatter(g, idx, n, out)


def _index_case(rng, kind, m, n):
    if kind == "random":
        return rng.integers(-3, n + 3, size=(m,))
    if kind == "permutation":
        return rng.permutation(max(m, n))[:m] % n
    if kind == "negative":
        return np.full((m,), -1)
    # top-2: tokens sent twice each, the rest of the m slots dropped (-1)
    tokens = rng.permutation(n)[:min(n, m // 2)]
    return rng.permutation(np.concatenate([tokens, tokens, np.full(m - 2 * tokens.size, -1)]))


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("kind", ["random", "permutation", "negative", "top2"])
@pytest.mark.parametrize("m,n", [
    (1000, 50),          # one block: n + 1 <= INDEX_KEYS row ids
    (1024, 1024),        # a relay round's backward: three blocks
    (8192, 2048),        # the dispatch pack's backward: five blocks
    (4096, 8192),        # the combine's backward: seventeen blocks
    (3000, 511),         # exactly one block's row ids
    (3, 1),
])
def test_inverse_index_launch_equals_plain(cuda, kind, m, n, idx_dtype):
    idx = torch.as_tensor(_index_case(np.random.default_rng(m + n), kind, m, n),
                          dtype=idx_dtype, device=cuda)
    before = launch_counts()["token_scatter_index"]
    order, offsets = build_inverse_index(idx, n)
    torch.cuda.synchronize()
    assert launch_counts()["token_scatter_index"] == before + 1
    want_order, want_offsets = inverse_index(idx, n)
    assert order.dtype == want_order.dtype and offsets.dtype == want_offsets.dtype
    assert torch.equal(order, want_order) and torch.equal(offsets, want_offsets)


@pytest.mark.parametrize("dtype,bits", [(torch.bfloat16, torch.int16),
                                        (torch.float32, torch.int32)])
@pytest.mark.parametrize("d", [4096, 65536, 7])
def test_token_scatter_add_copies_single_source_rows_bit_for_bit(cuda, dtype, bits, d):
    # a permutation with drops: every output row has one source or none; a
    # row with one is its source's bits (-0.0 and NaN payloads included),
    # a row with none is zeros
    rng = np.random.default_rng(d)
    n = 300
    idx = torch.as_tensor(rng.permutation(n + 40)[:n] - 40, device=cuda)
    raw = rng.integers(-2**15 if bits == torch.int16 else -2**31,
                       2**15 if bits == torch.int16 else 2**31, size=(n, d))
    g = torch.as_tensor(raw, dtype=bits, device=cuda).view(dtype)
    out = token_scatter_add(g, idx, n)
    torch.cuda.synchronize()
    src = torch.full((n,), -1, dtype=torch.int64, device=cuda)
    keep = idx >= 0
    src[idx[keep]] = torch.arange(n, device=cuda)[keep]
    has = src >= 0
    assert torch.equal(out[has].view(bits), g[src[has]].view(bits))
    assert not out[~has].view(bits).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_token_scatter_add_is_deterministic(cuda, dtype):
    # no atomics: a second run gives the same bits, also at 3 sources a row
    g, idx = _scatter_case(np.random.default_rng(5), 1000, 4096, dtype, torch.int64, cuda)
    first = token_scatter_add(g, idx, 1000)
    for _ in range(3):
        assert torch.equal(token_scatter_add(g, idx, 1000), first)


def test_token_scatter_add_edge_cases(cuda):
    g = torch.ones((4, 8), device=cuda)
    out = token_scatter_add(g, torch.full((4,), -1, device=cuda), 3)
    assert torch.equal(out, torch.zeros((3, 8), device=cuda))
    empty = token_scatter_add(g[:0], torch.zeros(0, dtype=torch.int64, device=cuda), 5)
    assert torch.equal(empty, torch.zeros((5, 8), device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_token_gather_backward_on_card_equals_cpu(cuda, dtype):
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.normal(size=(50, 256)), dtype=dtype)
    idx = torch.as_tensor(rng.integers(-2, 52, size=(120,)))
    g = torch.as_tensor(rng.normal(size=(120, 256)), dtype=dtype)
    grads = []
    for dev in ("cpu", cuda):
        xx = x.to(dev).requires_grad_(True)
        grads.append(torch.autograd.grad(token_gather(xx, idx.to(dev)), xx, g.to(dev))[0])
    _check_scatter(g, idx, 50, grads[1])
    tol = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-6
    assert (grads[1].cpu().float() - grads[0].float()).abs().max() <= tol * grads[0].float(
        ).abs().max()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_grouped_ffn_backward_on_card_equals_cpu(cuda, dtype, tol):
    # through the autograd Function on the card (kernel forward, torch
    # backward) against the CPU's plain backward in f32.  f32: products in
    # another order; bf16: the inputs, the gradients and gx's operands da
    # and db round to bf16
    rng = np.random.default_rng(4)
    m, d, f, e = 700, 256, 512, 4
    x, wg, wu, wd = (torch.as_tensor(rng.normal(size=s) * sc, dtype=torch.float32) for s, sc in
                     (((m, d), 0.5), ((e, d, f), 0.05), ((e, d, f), 0.05), ((e, f, d), 0.05)))
    eid = torch.as_tensor(rng.integers(-1, e, size=(m,)))
    g = torch.as_tensor(rng.normal(size=(m, d)), dtype=torch.float32)
    want = grouped_ffn_bwd(g, x, eid, wg, wu, wd)
    live = [t.to(cuda, dtype).requires_grad_(True) for t in (x, wg, wu, wd)]
    y = grouped_ffn(live[0], eid.to(cuda), *live[1:], block_tokens=64)
    got = torch.autograd.grad(y, live, g.to(cuda, dtype))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert (a.cpu().float() - b).abs().max() <= tol * b.abs().max()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", ["causal", "window", "offset"])
def test_flash_backward_on_card_equals_cpu(cuda, dtype, tol, case):
    # f32: the softmax backward dS = P (dP - sum(P dP)) cancels, so the
    # card's and the CPU's sums in other orders differ by up to about 2e-5
    # of the largest gradient; bf16: q, k, v and the gradients round
    kw = {"causal": dict(causal=True, window=None, q_offset=0),
          "window": dict(causal=True, window=60, q_offset=0),
          "offset": dict(causal=True, window=None, q_offset=40)}[case]
    rng = np.random.default_rng(6)
    q, k, v, g = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32) for s in
                  ((2, 4, 200, 64), (2, 2, 240 if case == "offset" else 200, 64),
                   (2, 2, 240 if case == "offset" else 200, 64), (2, 4, 200, 64)))
    want = flash_attention_bwd(q, k, v, g, **kw)
    live = [t.to(cuda, dtype).requires_grad_(True) for t in (q, k, v)]
    o = flash_attention(*live, **kw)
    got = torch.autograd.grad(o, live, g.to(cuda, dtype))
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert (a.cpu().float() - b).abs().max() <= tol * b.abs().max()


def test_reduced_train_step_on_card_equals_cpu(cuda, monkeypatch):
    # paper-moe-8e reduced (8 experts, EP 8 in groups of 4, nimble), f32: one
    # step's loss, grad_norm and every gradient leaf on the card (its
    # kernels, the FFN and flash on their f32 routes) against the CPU's plain
    # versions; f32 sums in other orders: 1e-4 of each leaf's largest value
    cfg = dataclasses.replace(get_config("paper-moe-8e").reduced(), n_experts=8,
                              moe_capacity_factor=8.0)
    seen = {}
    orig = adamw.update

    def record(cfg_, params, grads, state):
        seen.setdefault("grads", []).append([t.detach().cpu().clone() for t in leaves(grads)])
        return orig(cfg_, params, grads, state)

    monkeypatch.setattr(adamw, "update", record)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=2,
                                   seed=1)).batch(0)
    metrics = []
    before = launch_counts()
    weights = build_model(cfg, ParallelContext(ep_size=8, group_size=4, device="cpu")).init(0)
    for dev in ("cpu", "cuda"):
        ctx = ParallelContext(ep_size=8, group_size=4, device=dev)
        model = build_model(cfg, ctx)
        params = map_tree(lambda t: t.to(dev, copy=True), weights)
        step = make_train_step(model, adamw.AdamWConfig(lr=1e-3, warmup_steps=2))
        stats = {}
        _, _, m = step(params, adamw.init(params), to_device(batch, dev), stats=stats)
        assert int(stats["dropped"]) == 0
        metrics.append({k: float(v) for k, v in m.items()})
    after = launch_counts()
    for name in ("token_gather", "token_scatter_add", "grouped_ffn_blocked_f32",
                 "flash_attention_f32"):
        assert after[name] > before[name], name
    cpu, card = metrics
    for key in ("loss", "grad_norm", "lr"):
        assert abs(card[key] - cpu[key]) <= 1e-4 * abs(cpu[key]), key
    for a, b in zip(seen["grads"][1], seen["grads"][0]):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


# --------------------------------------------------------------------------- #
# the dense and xLSTM training paths, checkpoints, the selftest
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2.5-14b", "xlstm-125m"])
def test_reduced_dense_and_xlstm_train_step_on_card_equals_cpu(cuda, arch):
    # one f32 step's loss and every gradient leaf on the card (flash's f32
    # route, or mlstm_scan and its Function's backward) against the CPU's
    # plain versions; f32 sums in other orders: loss 1e-5, leaves 1e-4 of
    # each one's largest value.  S 160 passes the flash dispatch's 128
    cfg = get_config(arch).reduced()
    if cfg.arch_type == "ssm":
        cfg = dataclasses.replace(cfg, n_layers=2, mlstm_chunk=16)
    name = "mlstm_scan" if cfg.arch_type == "ssm" else "flash_attention_f32"
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=160, global_batch=2,
                                   seed=2)).batch(0)
    weights = build_model(cfg, ParallelContext(device="cpu")).init(0)
    if cfg.qkv_bias:
        for key in ("bq", "bk", "bv"):
            weights["blocks"]["attn"][key].normal_(generator=torch.Generator().manual_seed(1))
    out = []
    before = launch_counts()[name]
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, ParallelContext(device=dev))
        params = map_tree(lambda t: t.to(dev, copy=True), weights)
        loss, grads = loss_and_grads(model, params, to_device(batch, dev))
        out.append((float(loss), [g.cpu() for g in leaves(grads)]))
    assert launch_counts()[name] > before
    (l_cpu, g_cpu), (l_card, g_card) = out
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    for a, b in zip(g_card, g_cpu):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    # bf16 parameters, f32 moments and the int step: restored on the card,
    # every leaf equal bit for bit
    from repro_torch.checkpoint import ckpt

    cfg = get_config("smollm-135m").reduced()
    ctx = ParallelContext(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                          device="cuda")
    params = build_model(cfg, ctx).init(0)
    state = adamw.init(params)
    state = adamw.OptState(map_tree(lambda t: t + 0.5, state.m), state.v, 3)
    tree = {"params": params, "opt": state}
    ckpt.save(str(tmp_path), 4, tree)
    got, step = ckpt.restore(str(tmp_path), namedtuple_types={"OptState": adamw.OptState})
    assert step == 4 and got["opt"].step == 3
    for a, b in zip(leaves(tree), leaves(got)):
        if isinstance(a, int):
            assert a == b
            continue
        assert b.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a, b)


def test_selftest_on_card(cuda):
    from repro_torch.launch import selftest

    assert selftest.main([]) == 0


# --------------------------------------------------------------------------- #
# the remaining families' shapes: flash non-causal with Sq != Sk and GQA
# 16:1, the grouped FFN at E 128 / F 1536 and E 32 / F 512, the cummax tie
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("case", ["whisper_encoder", "whisper_cross", "qwen3_gqa16",
                                  "internvl2_gqa2"])
def test_flash_attention_at_the_new_families_shapes(cuda, dtype, tol, case):
    # whisper: non-causal over 1500 frames (a ragged last tile), and its
    # cross-attention, 448 queries over the 1500 frames; qwen3: 64 query
    # heads over 4 (here 16 over 1); internvl2: 16 over 8 at head dim 128
    rng = np.random.default_rng(21)
    b, h, hkv, sq, sk, dh, causal = {
        "whisper_encoder": (1, 2, 2, 1500, 1500, 64, False),
        "whisper_cross": (2, 2, 2, 448, 1500, 64, False),
        "qwen3_gqa16": (1, 16, 1, 512, 512, 128, True),
        "internvl2_gqa2": (1, 4, 2, 768, 768, 128, True)}[case]
    q = torch.as_tensor(rng.normal(size=(b, h, sq, dh)), dtype=dtype, device=cuda)
    k = torch.as_tensor(rng.normal(size=(b, hkv, sk, dh)), dtype=dtype, device=cuda)
    v = torch.as_tensor(rng.normal(size=(b, hkv, sk, dh)), dtype=dtype, device=cuda)
    count = "flash_attention" if dtype == torch.bfloat16 else "flash_attention_f32"
    before = launch_counts()[count]
    o = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert launch_counts()[count] == before + 1
    assert (o.float() - mha_ref(q, k, v, causal=causal).float()).abs().max() <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("e,f,d,n", [(128, 1536, 512, 4096), (32, 512, 1024, 2048)])
def test_grouped_ffn_at_the_moe_families_widths(cuda, dtype, tol, e, f, d, n):
    # qwen3's 128 experts of F 1536 and granite's 32 of F 512, top-8 rows in
    # any order with some padding (-1): the sort/pad and the kernel on the
    # card against the plain version on the CPU in f32
    rng = np.random.default_rng(e + f)
    x, wg, wu, wd = _ffn_inputs(rng, n, d, f, e, torch.float32, "cpu")
    eid = torch.as_tensor(rng.integers(-1, e, size=n))
    want = grouped_ffn(x, eid, wg, wu, wd, block_tokens=64)
    count = "grouped_ffn_blocked" if dtype == torch.bfloat16 else "grouped_ffn_blocked_f32"
    before = launch_counts()[count]
    got = grouped_ffn(x.to(cuda, dtype), eid.to(cuda),
                      *(w.to(cuda, dtype) for w in (wg, wu, wd)), block_tokens=64)
    torch.cuda.synchronize()
    assert launch_counts()[count] == before + 1
    assert (got.cpu().float() - want).abs().max() <= tol * want.abs().max()
    assert not got[eid.to(cuda) < 0].any()


def test_chunk_cummax_tie_gradient_on_card_equals_cpu(cuda):
    # the tie rule (JAX's: halves down the associative scan's tree) on both
    # devices, one launch of mlstm_cummax_bwd each backward on the card, and
    # through the chunked mLSTM's VJP with tied input gates
    from repro_torch.kernels.mlstm_scan.ops import _cummax, mlstm_scan_function

    g = torch.tensor([[[1, 3, 2, 3, 0.5, 3]]])
    ct = torch.arange(1.0, 7.0)[None, None]
    grads = []
    for dev in ("cpu", "cuda"):
        x = g.to(dev).requires_grad_(True)
        (gx,) = torch.autograd.grad(_cummax(x), x, ct.to(dev))
        grads.append(gx.cpu())
    assert grads[0].tolist() == [[[1, 11, 0, 6, 0, 3]]]
    assert torch.equal(grads[0], grads[1])
    rng = np.random.default_rng(9)
    for n in (1, 2, 3, 7, 16, 33, 64):
        gn = torch.as_tensor(rng.integers(0, 4, size=(4, 16, n)), dtype=torch.float32)
        cn = torch.as_tensor(rng.normal(size=(4, 16, n)), dtype=torch.float32)
        per = []
        for dev in ("cpu", "cuda"):
            x = gn.to(dev).requires_grad_(True)
            before = launch_counts()["mlstm_cummax_bwd"]
            (gx,) = torch.autograd.grad(_cummax(x), x, cn.to(dev))
            assert launch_counts()["mlstm_cummax_bwd"] == before + (dev == "cuda")
            per.append(gx.cpu())
        assert torch.equal(per[0], per[1]), n
    b, h, s, dh = 2, 2, 48, 16
    ins = [torch.as_tensor(rng.normal(size=(b, h, s, dh)) * 0.3, dtype=torch.float32)
           for _ in range(3)]
    ins += [torch.as_tensor(rng.integers(-1, 2, size=(b, h, s)), dtype=torch.float32),
            torch.zeros((b, h, s))]
    cots = [torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)
            for shape in ((b, h, s, dh), (b, h, dh, dh), (b, h, dh), (b, h))]
    out = []
    for dev in ("cpu", "cuda"):
        live = [t.to(dev).requires_grad_(True) for t in ins]
        hh, fin = mlstm_scan_function(*live, chunk=16)
        got = torch.autograd.grad((hh, fin["C"], fin["n"], fin["m"]), live,
                                  [c.to(dev) for c in cots])
        out.append([a.cpu() for a in got])
    for a, w in zip(out[1], out[0]):
        assert (a - w).abs().max() <= 1e-4 * w.abs().max()


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-small", "internvl2-2b",
                                  "qwen3-moe-235b-a22b"])
def test_reduced_new_families_train_step_on_card_equals_cpu(cuda, arch):
    # one f32 step's loss and every gradient leaf on the card (flash's and the
    # FFN's f32 routes) against the CPU's plain versions, as the dense test
    # above: loss 1e-5, leaves 1e-4 of each one's largest value; whisper with
    # 150 frames and qwen3 with its head-dim override, GQA, E 16 and top-8
    from repro_torch.data.pipeline import add_modality_stubs

    cfg = get_config(arch).reduced()
    if cfg.arch_type == "audio":
        cfg = dataclasses.replace(cfg, n_audio_frames=150)
    if cfg.arch_type == "moe":
        cfg = dataclasses.replace(cfg, head_dim_override=128, n_kv_heads=1, n_experts=16,
                                  top_k=8)
    batch = add_modality_stubs(SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=160,
                                                      global_batch=2, seed=2)).batch(0), cfg)
    weights = build_model(cfg, ParallelContext(device="cpu")).init(0)
    out = []
    before = launch_counts()["flash_attention_f32"]
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, ParallelContext(device=dev))
        params = map_tree(lambda t: t.to(dev, copy=True), weights)
        loss, grads = loss_and_grads(model, params, to_device(batch, dev))
        out.append((float(loss), [g.cpu() for g in leaves(grads)]))
    assert launch_counts()["flash_attention_f32"] > before
    (l_cpu, g_cpu), (l_card, g_card) = out
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    for a, b in zip(g_card, g_cpu):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


def test_zamba2_decode_on_card_reproduces_its_forward(cuda):
    # the reference's rule (tests/test_models.py): decode steps against the
    # teacher-forced forward within atol = rtol = 1e-3; S 130 sends the
    # forward's attention through flash
    from repro_torch.configs.base import InputShape

    cfg = dataclasses.replace(get_config("zamba2-1.2b").reduced(), attn_every=2, n_layers=4)
    model = build_model(cfg, ParallelContext(device="cuda"))
    params = model.init(1)
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (2, 130)),
                           device=cuda)
    with torch.no_grad():
        full, _ = model.forward(params, {"tokens": toks})
        cache = model.init_cache(2, InputShape("d", 130, 2, "decode"))
        dec = torch.stack([model.decode_step(params, cache, toks[:, i], i)[0]
                           for i in range(130)], 1)
    torch.testing.assert_close(dec, full, atol=1e-3, rtol=1e-3)
