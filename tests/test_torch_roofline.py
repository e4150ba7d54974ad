"""The port's op counter and roofline (``roofline/``) against the reference's.

On the CPU, over fake tensors where a model is counted:

  * the counterparts of ``tests/test_hlo_cost_slices.py``'s four tests on
    :class:`CostCounter` (slice-accurate writes and reads, products counted
    once a run, a ``send``'s bytes as ``collective-permute``);
  * FLOP parity with the reference's ``analyze_hlo_text`` of its jitted
    ``value_and_grad(loss)`` and ``forward(last_only=True)``, on the same
    reduced configs and input shapes: smollm-135m equal at S 512 and 4096,
    xlstm-125m within 0.5%, zamba2-1.2b within 0.1%, granite-moe-1b-a400m
    with 8 experts (EP 1) within 1%;
  * ``count_params``, ``active_param_fraction`` and ``model_flops`` equal to
    the reference's for all 11 architectures (the port counts fake leaves,
    the reference ``jax.eval_shape(model.init, ...)``);
  * the kernels' reported costs at ``PERF.md`` §6's shapes, the helpers
    ``chip_smoke.py`` bounds each kernel with: each gives the bound that
    table lists; and a train step's least work (6 N D, a fused AdamW);
  * the fake-tensor repairs keep their bits: ``_arrange``, ``_block_rows``,
    ``grouped_ffn_dense`` and ``token_scatter_add_ref`` against their old
    forms (``torch.bincount``; a boolean-mask index), with invalid rows and
    empty experts, and each runs under ``FakeTensorMode``; the planner's
    device tables are not cached under a fake mode;
  * ``serve/engine.py::make_serve_step`` equals ``Model.decode_step``;
  * the reference's own dry run of smollm-135m x train_4k (a subprocess)
    beside the port's record.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.base import ARCH_IDS as J_ARCH_IDS
from repro.configs.base import InputShape as JInputShape
from repro.configs.base import get_config as j_get_config
from repro.models.registry import build_model as j_build_model
from repro.roofline import analysis as j_analysis
from repro.roofline.hlo_cost import analyze_hlo_text
from repro.sharding.context import SINGLE as J_SINGLE
from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES, InputShape, get_config
from repro_torch.core import planner
from repro_torch.core.schedule import build_planner_tables
from repro_torch.core.topology import Topology
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.grouped_ffn import ops as ffn_ops
from repro_torch.kernels.mlstm_scan import ops as ms_ops
from repro_torch.kernels.relay_copy import ops as rc_ops
from repro_torch.kernels.token_scatter import ops as ts_ops
from repro_torch.models.registry import build_model
from repro_torch.roofline import analysis
from repro_torch.roofline.hlo_cost import CostCounter
from repro_torch.serve.engine import make_serve_step
from repro_torch.sharding.context import ParallelContext
from repro_torch.train.step import loss_and_grads

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
CPU = ParallelContext(device="cpu")


# -- the counterparts of tests/test_hlo_cost_slices.py ----------------------------------


def test_stacked_writes_charge_the_slice():
    """S steps each writing a [N] slice of a stacked [S, N] buffer: O(S N)
    bytes, not O(S^2 N)."""
    S, N = 512, 256
    with CostCounter() as c:
        x = torch.ones(N)
        buf = torch.empty(S, N)
        for i in range(S):
            x = x * 1.000001
            buf[i] = x
    total = S * N * 4
    assert total < c.result()["bytes"] < 32 * total


def test_row_reads_charge_the_rows():
    """A loop that takes one row of a [1024, 128] table a step reads the rows,
    not the table each step."""
    table = torch.ones(1024, 128)
    with CostCounter() as c:
        acc = torch.zeros(())
        for i in range(256):
            row = torch.index_select(table, 0, torch.tensor([i]))
            acc = acc + row.sum()
    assert c.result()["bytes"] < 24 * table.numel() * 4


def test_looped_products_count_once_a_run():
    L, D = 8, 64
    w = torch.ones(L, D, D)
    with CostCounter() as c:
        y = torch.ones(4, D)
        for i in range(L):
            y = y @ w[i]
    r = c.result()
    assert r["flops"] == L * 2 * 4 * D * D
    assert r["flops_by_dtype"] == {"f32": L * 2 * 4 * D * D}


def test_send_counts_as_collective_permute():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        with CostCounter() as c:
            dist.send(torch.ones(128, 64), 1)
            dist.recv(torch.empty(128, 64), 1)
    finally:
        dist.destroy_process_group()
    r = c.result()
    assert r["collectives"]["collective-permute"] == 128 * 64 * 4
    assert r["collective_bytes"] == 128 * 64 * 4


def test_live_at_the_peak_names_its_sites():
    """A few ops under FakeTensorMode: the peak's largest storage is
    ``up32``'s float32 copy, the set is taken at the first free after the
    peak (the small product is freed then), a later lower high-water mark
    does not replace it, and the breakdown's fourth section names the
    sites, its rows summing to ``temp_peak``."""
    from repro_torch.models import layers
    from repro_torch.roofline.breakdown import live_rows, live_section

    with FakeTensorMode():
        x = torch.empty((1024, 256), dtype=torch.bfloat16)        # an argument
        with CostCounter(attribute=True) as c:
            big = layers.up32(x)                                  # 1 MiB
            small = big[:64] * 2                                  # 64 KiB, at "?"
            del small
            later = big[:32] * 2                                  # 32 KiB: no new peak
            del later
            del big
    assert c.temp_peak == 1024 * 256 * 4 + 64 * 256 * 4
    rows = live_rows(c)
    assert rows[0][0] == 1024 * 256 * 4 and rows[0][1] == 1
    assert rows[0][2].startswith("models.layers.up32:")
    assert sum(r[0] for r in rows) == c.temp_peak
    lines = live_section(c, top=1)
    assert "models.layers.up32:" in lines[1] and "(1 more sites)" in lines[2]
    assert not CostCounter().peak_sites


# -- FLOP parity with the reference's HLO count ---------------------------------------------

_GRANITE8 = ("granite-moe-1b-a400m", lambda c: dataclasses.replace(c, n_experts=8))
# (arch, S, relative tolerance): the port counts the same products as the
# reference's dots, but for its chunk loops: the reference's scans run every
# chunk's products alike, the port's unrolled loops skip a few at the ends
# (xlstm's mLSTM chunks: 93 of the reference's 96 [64, 64] tile products at
# 8 chunks, and 5 more matrix-vector ones, 0.2%; zamba2's SSD chunks: one
# [2^19]-multiply-add product and two small ones fewer, 0.01%).  Training
# takes the port's attention backward by design: ``attention_bwd``
# recomputes S and takes 5 products on each (query block, key chunk) pair
# that the mask leaves, where the reference's jax.grad through the plain
# attention takes 4 on all Sq x Sk pairs; the reference's count is held
# with that difference (:func:`_attention_bwd_delta`) added, exactly
PARITY = [("smollm-135m", 512, 0.0), ("smollm-135m", 4096, 0.0), ("xlstm-125m", 512, 5e-3),
          ("zamba2-1.2b", 512, 1e-3), (_GRANITE8, 512, 1e-2)]


def _cfg(get, arch):
    name, change = arch if isinstance(arch, tuple) else (arch, None)
    cfg = get(name).reduced()
    return change(cfg) if change else cfg


def _ref_flops(arch, S: int, kind: str, B: int = 2) -> float:
    model = j_build_model(_cfg(j_get_config, arch), J_SINGLE)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    specs = model.input_specs(JInputShape("parity", S, B, "train"))
    if kind == "train":
        fn = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b)))
    else:
        fn = jax.jit(lambda p, b: model.forward(p, b, last_only=True)[0])
    return analyze_hlo_text(fn.lower(params, specs).compile().as_text())["flops"]


def _port_flops(arch, S: int, kind: str, B: int = 2) -> float:
    model = build_model(_cfg(get_config, arch), CPU)
    with FakeTensorMode():
        params = model.init(0)
        specs = model.input_specs(InputShape("parity", S, B, "train"))
        batch = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in specs.items()}
        with CostCounter() as c:
            if kind == "train":
                loss_and_grads(model, params, batch)
            else:
                with torch.no_grad():
                    model.forward(params, batch, last_only=True)
    return c.result()["flops"]


def _attention_bwd_delta(calls) -> float:
    """FLOPs that ``attention_bwd`` counts beyond autograd's 4 products over
    every Sq x Sk pair, for the calls ``(q shape, Sk, keywords)``: 5 products
    on each pair of a (query block, key chunk) that the mask does not hide
    entirely, the mask evaluated pair by pair here."""
    total = 0.0
    for (b, h, sq, dh), sk, kw in calls:
        qpos = np.arange(sq)[:, None] + kw["q_offset"]
        kpos = np.arange(sk)[None, :]
        mask = np.ones((sq, sk), bool)
        if kw["causal"]:
            mask &= kpos <= qpos
        if kw["window"] is not None:
            mask &= kpos > qpos - kw["window"]
        chunk, block = kw["chunk"], kw.get("block", fa_ops._BLOCK)
        pairs = sum(mask[q0:q0 + block, k0:k0 + chunk].size
                    for k0 in range(0, sk, chunk) for q0 in range(0, sq, block)
                    if mask[q0:q0 + block, k0:k0 + chunk].any())
        total += 2.0 * b * h * dh * (5 * pairs - 4 * sq * sk)
    return total


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch,S,tol", PARITY,
                         ids=[f"{a if isinstance(a, str) else a[0] + '-e8'}-{s}"
                              for a, s, _ in PARITY])
def test_flops_match_the_reference_hlo_count(arch, S, tol, kind, monkeypatch):
    calls, bwd = [], fa_ops.attention_bwd

    def spy(q, k, *args, **kw):
        calls.append((tuple(q.shape), k.shape[2], kw))
        return bwd(q, k, *args, **kw)

    monkeypatch.setattr(fa_ops, "attention_bwd", spy)
    ref, port = _ref_flops(arch, S, kind), _port_flops(arch, S, kind)
    assert bool(calls) == (kind == "train" and "xlstm" not in str(arch))
    ref += _attention_bwd_delta(calls)
    assert abs(port - ref) <= tol * ref, (port, ref, port / ref)


# -- parameters and model FLOPs ----------------------------------------------------------------


def test_arch_ids_are_the_reference_s():
    assert ARCH_IDS == J_ARCH_IDS


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_and_model_flops_equal_the_reference(arch):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    jmodel = j_build_model(jcfg, J_SINGLE)
    want = j_analysis.count_params(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))
    with FakeTensorMode():
        got = analysis.count_params(build_model(cfg, CPU).init(0))
    assert got == want
    assert analysis.active_param_fraction(cfg) == j_analysis.active_param_fraction(jcfg)
    for shape in INPUT_SHAPES.values():
        tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
        kind = shape.kind if shape.kind == "train" else "prefill"
        assert analysis.model_flops(cfg, got, tokens, kind) == \
            j_analysis.model_flops(jcfg, want, tokens, kind)
    if arch == "smollm-135m":
        assert got == 162826560


def test_roofline_terms_price_each_dtype_at_its_peak():
    cost = {"flops": 989e12 + 67e12, "bytes": 3.35e12, "flops_by_dtype":
            {"bf16": 989e12, "f32": 67e12},
            "collectives": {"all-reduce": 50e9, "all-gather": 0}}
    roof = analysis.analyze(cost, 4, 1e15)
    assert roof.compute_s == pytest.approx(2.0)
    assert roof.memory_s == pytest.approx(1.0)
    assert roof.collective_s == pytest.approx(1.0)
    assert roof.dominant == "compute" and roof.bound_s == pytest.approx(2.0)
    ref = j_analysis.Roofline(1.0, 1.0, 1.0, {}, 4, 1.0).as_dict()
    assert set(ref) <= set(roof.as_dict())
    assert roof.as_dict()["useful_flops_ratio"] == pytest.approx(1e15 / (4 * (989e12 + 67e12)))


# -- the kernels' reported costs ------------------------------------------------------------------


# (kernel, its cost at PERF.md §6's shape, dtype, the table's bound in ms and its digits)
KERNEL_COSTS = [
    # token_gather, the moe prefill's first relay round: x [1024, 65536] bf16,
    # a permutation of 1024 int64 indices
    ("token_gather", lambda: (0.0, ts_ops.gather_bytes(1024, 1024, 65536 * 2, 8)), "bf16",
     0.0801, 4),
    # token_scatter_add, a relay round's backward: g [1024, 65536] bf16 -> 1024 rows
    ("token_scatter_add",
     lambda: (0.0, ts_ops.scatter_add_bytes(1024, 1024, 65536 * 2, 1024, 8)), "bf16", 0.0801, 4),
    # grouped_ffn_blocked: 3730 token rows, D 4096, F 16384, E 8 all used
    ("grouped_ffn_blocked", lambda: ffn_ops.ffn_cost(3730, 8, 4096, 16384, 2), "bf16",
     1.5186, 4),
    # flash_attention, causal: the moe prefill's q [4, 32, 512, 128] over 8 kv
    # heads, and smollm's [4, 9, 2048, 64] over 3
    ("flash_attention moe", lambda: fa_ops.flash_cost((4, 32, 512, 128), 4 * 8 * 512 * 128,
                                                      True, None, 0, 512, 2), "bf16", 0.0125, 4),
    ("flash_attention smollm", lambda: fa_ops.flash_cost((4, 9, 2048, 64), 4 * 3 * 2048 * 64,
                                                         True, None, 0, 2048, 2), "bf16",
     0.0196, 4),
    # mlstm_scan [4, 4, 2048, 192] f32, chunk 64
    ("mlstm_scan", lambda: ms_ops.mlstm_cost(4, 4, 2048, 192, 64), "f32", 0.0843, 4),
    # mlstm_cummax_bwd, g [4, 128, 64] f32
    ("mlstm_cummax_bwd", lambda: ms_ops.cummax_bwd_cost(4 * 128 * 64), "f32", 0.00012, 5),
    # relay_copy [8192, 4096] bf16 in 32 chunks of 256 rows
    ("relay_copy", lambda: (0.0, rc_ops.relay_bytes(8192 * 4096, 2, 32)), "bf16", 0.0401, 4),
]


def test_kernel_costs_are_chip_smoke_bounds_at_perf_shapes():
    """Each launch site reports its cost by the helper chip_smoke.py bounds
    that kernel with (``analysis.kernel_bound``); at the shapes of PERF.md's
    kernel table each gives the bound that table lists."""
    for name, cost, dtype, want, digits in KERNEL_COSTS:
        bound_s, _ = analysis.kernel_bound(*cost(), dtype)
        assert round(bound_s * 1e3, digits) == want, name


def test_attention_pairs_count_the_mask():
    for sq, sk, causal, window, off in ((7, 7, True, None, 0), (5, 12, True, 4, 7),
                                        (6, 9, False, None, 0), (4, 4, True, 2, 0)):
        assert fa_ops.attention_pairs(sq, sk, causal, window, off) == \
            int(fa_ops._mask(sq, sk, causal, window, off, "cpu").sum())


def test_kernel_bound_takes_the_larger_term():
    assert analysis.kernel_bound(989e12, 3.35e12, "bf16") == (1.0, "operations")
    assert analysis.kernel_bound(67e12, 6.7e12, "f32") == (2.0, "bytes")


def test_least_train_step_is_6ND_and_a_fused_adamw():
    """6 N D at the bf16 peak; bf16 parameters with f32 moments move 22 bytes
    a parameter in a fused AdamW (p, g, m, v read; p, m, v written)."""
    from repro_torch.optim import adamw

    params = {"w": torch.zeros(1000, 10, dtype=torch.bfloat16), "b": [torch.zeros(5)]}
    state = adamw.init(params)
    compute_s, memory_s = analysis.least_train_step(6.0 * 10005 * 64, params, state)
    assert compute_s == 6.0 * 10005 * 64 / 989e12
    assert memory_s == (22 * 10000 + 3 * 4 * 5 + 2 * 2 * 4 * 5) / 3.35e12


# -- the fake-tensor repairs keep their bits -----------------------------------------------------


def _old_bincount(keys, n):
    return torch.bincount(keys, minlength=n)


def _old_scatter_add_ref(g, idx, n):
    valid = idx >= 0
    safe = idx.clamp(0, n - 1).long()[valid]
    out = torch.zeros((n, g.shape[1]), dtype=torch.float32, device=g.device)
    return out.index_add_(0, safe, g[valid].float()).to(g.dtype)


def _expert_ids(rng, n, E):
    """Ids over only some experts (empty ones too), with invalid rows."""
    eid = rng.choice([0, 2, 3, E - 1], size=n).astype(np.int64)
    eid[rng.random(n) < 0.2] = -1
    return torch.as_tensor(eid)


@pytest.mark.parametrize("seed", [0, 1])
def test_grouping_repairs_keep_their_bits(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    E, n, D, F = 6, 300, 16, 32
    eid = _expert_ids(rng, n, E)
    x = torch.as_tensor(rng.normal(size=(n, D)).astype(np.float32))
    w = [torch.as_tensor(rng.normal(size=s).astype(np.float32))
         for s in ((E, D, F), (E, D, F), (E, F, D))]
    new = (ffn_ops._arrange(eid, E, 64), ffn_ops._block_rows(eid, E, 64),
           ffn_ops.grouped_ffn_dense(x, eid, *w))
    monkeypatch.setattr(ffn_ops, "_bincount", _old_bincount)
    old = (ffn_ops._arrange(eid, E, 64), ffn_ops._block_rows(eid, E, 64),
           ffn_ops.grouped_ffn_dense(x, eid, *w))
    for a, b in zip(new[0], old[0]):
        assert (a == b) if isinstance(a, int) else torch.equal(a, b)
    assert torch.equal(new[1], old[1])
    assert torch.equal(new[2], old[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_add_ref_keeps_its_bits(dtype):
    rng = np.random.default_rng(3)
    m, n, D = 500, 120, 24
    idx = torch.as_tensor(rng.integers(-1, n + 5, m))         # invalid and clipped rows
    g = torch.as_tensor(rng.normal(size=(m, D)).astype(np.float32)).to(dtype)
    got = ts_ops.token_scatter_add_ref(g, idx, n)
    assert got.shape == (n, D) and got.dtype == dtype
    assert torch.equal(got, _old_scatter_add_ref(g, idx, n))


def test_repaired_functions_run_under_fake_tensors():
    with FakeTensorMode():
        eid = torch.zeros(300, dtype=torch.int64)
        x = torch.zeros(300, 16)
        w = [torch.zeros(s) for s in ((6, 16, 32), (6, 16, 32), (6, 32, 16))]
        order, pos, blk, m_pad = ffn_ops._arrange(eid, 6, 64)
        assert pos.shape == (300,) and blk.shape == (m_pad // 64,)
        assert ffn_ops._block_rows(eid, 6, 64).shape == (m_pad // 64,)
        assert ffn_ops.grouped_ffn_dense(x, eid, *w).shape == (300, 16)
        assert ffn_ops.grouped_ffn_scan(x, eid, *w, block_tokens=64).shape == (300, 16)
        g = torch.zeros(500, 24)
        assert ts_ops.token_scatter_add_ref(g, torch.zeros(500, dtype=torch.int64),
                                            120).shape == (120, 24)


def test_planner_tables_are_not_cached_under_a_fake_mode():
    tables = build_planner_tables(Topology(8, group_size=4))
    before = dict(planner._DEVICE_CACHE)
    for _ in range(2):                                   # two modes, one after the other
        with FakeTensorMode():
            dt = planner.device_tables(tables, "cpu")
            assert dt.caps.shape[0] == tables.n_resources
            assert (dt.caps + 1).shape == dt.caps.shape
    assert dict(planner._DEVICE_CACHE) == before
    real = planner.device_tables(tables, "cpu")
    assert planner.device_tables(tables, "cpu") is real            # cached outside one


# -- the serving step ------------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["smollm-135m", "paper-moe-8e"])
def test_make_serve_step_equals_decode_step(arch):
    cfg = get_config(arch).reduced()
    if arch == "paper-moe-8e":
        cfg = dataclasses.replace(cfg, n_experts=8)
    ctx = ParallelContext(ep_size=8 if arch == "paper-moe-8e" else 1, device="cpu")
    model = build_model(cfg, ctx)
    params = model.init(0)
    shape = InputShape("serve", 16, 2, "decode")
    token = torch.tensor([3, 5])
    a, b = model.init_cache(2, shape), model.init_cache(2, shape)
    serve = make_serve_step(model)
    for pos in range(3):
        la, a = serve(params, a, token, pos)
        lb, b = model.decode_step(params, b, token, pos)
        assert torch.equal(la, lb)
        token = torch.argmax(la, -1)
    for k in a:
        assert torch.equal(a[k], b[k])


# -- beside the reference's own dry run -----------------------------------------------------------


def test_reference_dryrun_record_beside_the_port_s(tmp_path):
    """The reference's dry run of smollm-135m x train_4k (16 x 16, a subprocess)
    and the port's, both at 2 of its 30 layers, agree on what must agree:
    status, ``n_params`` and ``model_flops_total``.  Per-device FLOPs differ by design and are only
    printed: the port runs each process's block of tokens over data x model
    with every dense leaf replicated, while XLA keeps the batch over "data"
    and splits or replicates the 9-head layers over "model" as its
    partitioner chooses."""
    from repro_torch.launch.dryrun import run_one

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", "repro.launch.dryrun", "--arch", "smollm-135m",
                        "--shape", "train_4k", "--set", "n_layers=2", "--out", str(tmp_path)],
                       env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    ref = json.loads((tmp_path / "smollm-135m_train_4k_16x16_nimble.json").read_text())
    assert ref["overrides"] == {"n_layers": 2}
    port = run_one("smollm-135m", "train_4k", multi_pod=False, cfg_overrides={"n_layers": 2})
    print(f"per-device FLOPs: reference {ref['roofline']['flops_per_device']:.4e}, "
          f"port {port['roofline']['flops_per_device']:.4e}")
    assert port["status"] == ref["status"] == "ok"
    assert port["n_params"] == ref["n_params"]
    assert port["roofline"]["model_flops_total"] == ref["roofline"]["model_flops_total"]
