#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths once on one card, and check them.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA device.  It builds the
port's six CUDA kernels from ``src/repro_torch/csrc``, all at once, then:

  1. prints the device, its power limit and the kernels' build time;
  2. holds each kernel of the paper-moe-8e path against its plain PyTorch
     version on the inputs the path gives it (bfloat16, the tensor-core
     routes of the FFN and flash; and float32, their CUDA-core routes), and
     times the kernel, the plain version and one PyTorch library call as a
     yardstick (the FFN's: a per-expert matmul loop over the token rows;
     flash's: ``scaled_dot_product_attention``, with ``is_causal`` for a
     plain causal call); it counts the FFN's tiles computed and skipped;
     ``token_gather`` is timed on the prefill's relay round, the sideband's
     relay round and the FFN's sort of 8 KiB rows, and (after phase 5) on a
     decode step's relay round captured there, each beside its bound and
     ``index_select``;
  3. checks the stacked dataplane bit for bit against the numpy oracle in
     all three modes, and that the card's chunk plan equals the CPU's;
  4. prefills paper-moe-8e at full width (bf16, 8 EP ranks in 2 groups of 4,
     NIMBLE dispatch) for 4 requests of 512 tokens through
     ``Model.forward(last_only=True)``, and holds the logits against the
     single-device path on the same weights;
  5. answers 4 requests through ``ServeEngine.generate`` (prompt 8, 8 new
     tokens, greedy), recording a decode step's first ``token_gather`` calls;
  6. checks that phases 4 and 5 launched every kernel of that path (the FFN
     and flash through their bf16 tensor-core routes);
  7. trains paper-moe-8e at full width (bf16, EP 8 in groups of 4, NIMBLE,
     capacity factor 2.0) on 4 x 512 tokens from ``SyntheticLM``: one
     warm-up step, then 3 timed AdamW steps through ``make_train_step``;
     prints step time, tokens/s, each step's loss and ``grad_norm``, the
     forward's, backward's and optimizer's shares, the grouped FFN's and
     attention's plain-torch backward times and the peak of
     ``torch.cuda.max_memory_allocated``, and checks that losses and norms
     are finite;
  8. holds one step's loss and gradients at capacity factor 8 (nothing
     dropped, checked) on EP 8 against EP 1 on the same weights (bf16), and
     a reduced config's one-step gradients on the card against the CPU's
     plain versions (float32);
  9. holds ``token_scatter_add`` (``token_gather``'s backward, the port's
     own kernel) against its plain version on the backward calls phase 7's
     warm-up step made: bit-exact where no row has more than two sources, the
     same bits on a second run, its inverse-index launch equal to the plain
     stable sort and search; times it beside its bound and ``index_add_``,
     split on the device into the inverse-index launch and the row sums
     (beside the plain sort and search), and a relay round's beside
     ``token_gather`` on the same rows;
 10. holds ``mlstm_scan`` against its plain version on the inputs of
     xlstm-125m's first mLSTM layer at a 4 x 2048 prefill (float32), and
     times both; checks that an input that needs a gradient raises (the
     kernel has no backward);
 11. prefills xlstm-125m at full width (bf16) for 4 requests of 2048 tokens,
     holds the chunked (kernel) forward against the per-step mLSTM forward
     at 4 x 256 tokens (float32 and bf16), and a reduced xlstm config on the
     card against the CPU's plain versions (float32);
 12. answers 4 requests through ``ServeEngine.generate`` on xlstm-125m
     (prompt 128, 16 new tokens, greedy), and holds the engine's step-by-step
     prefill logits against the kernel-path ``forward(last_only=True)``;
 13. holds ``relay_copy`` bit for bit against its plain version on
     [8192, 4096] bf16, f32 and int32 inputs under the parity, swapped and
     all-zeros slot maps, times it against ``Tensor.copy_`` by events and on
     the device, checks that an input that needs a gradient raises, and
     calls it through its own entry point on each route (nothing in the
     serving paths, or in the JAX package, calls it): the TMA bulk route at
     [8192, 4096], the 4- and 2-byte word routes on 420- and 210-byte chunks;
 14. checks that each path launched every kernel of its own: phase 7's
     timed steps ``token_gather``, ``token_scatter_add`` (and its
     inverse-index launch), the FFN and flash (bf16 routes), phases 11 and
     12 ``mlstm_scan``, phase 13's entry-point calls each route of
     ``relay_copy``.
 15. replays the runtime's scenarios with every replan solved on the card
     and again on the CPU, and checks that the reports are equal: the paper's
     testbed (2 nodes x 4) under a drifting hotspot (48 windows), balanced
     traffic (30) and a link down at window 8 (24), and an 8-node EP group's
     drift (n=32, 48 windows); prints each scenario's static, adaptive and
     oracle totals, speedups, replans, solves, cache hits and the link-down
     recovery window, and the card's solve times (each replan, B=1 and the
     oracle's B=48 batch at n=8 and n=32) beside the CPU's and the host
     ``solve_mwu`` sweep's;
 16. drives NIMBLE's endpoint API and shared-fabric arbiter on the card:
     (a) the five fairness sections of ``launch/fairness.py`` (host
     co-planning, the weight sweep, an arbitrated runtime, four tenants,
     the three mutual-drift arms) with every runtime replan solved on the
     card and again on the CPU: every figure and every ``Session.report()``
     (its topology description aside) must be equal; prints the figures,
     the card's priced solves (count, median ms) and ``solve_plans_batch``
     with and without ``ext_loads`` at B=1, n=8; (b) prefills paper-moe-8e
     at phase 4's width and weights through an arbitrated ``Session``-wired
     ``ParallelContext``: the logits must equal phase 4's bit for bit, the
     path's kernels must launch, and the prefill's dispatch demand planned
     by ``sess.moe_dispatcher(cfg).plan_batched`` on the card must equal
     the CPU's and the path's own plan, with one telemetry and estimator
     record per batch entry; (c) the ``skewed_alltoallv`` example on the
     card, bit-exact in all three modes at hotspots 0.3, 0.7 and 0.9; (d)
     the API selfcheck's checks 1-5 on the card.

It prints one line per phase, the card's name and power limit as
``nvidia-smi`` reports them, a JSON line of per-kernel numbers, and as its
last line ``{"ok": true, "device": {...}}``.  It exits non-zero, without
that line, when there is no CUDA device, when run outside a checkout, or
when any check fails.  Weights are random, made from ``--seed``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_S = 3.35e12                     # H100 SXM HBM3
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}  # dense tensor-core bf16; f32 CUDA cores

KERNEL_META = {
    "token_gather": ("src/repro_torch/csrc/token_gather.cu",
                     "src/repro/kernels/token_scatter/scatter.py:31"),
    "grouped_ffn_blocked": ("src/repro_torch/csrc/grouped_ffn.cu",
                            "src/repro/kernels/grouped_ffn/ffn.py:45"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/flash.py:72"),
    "mlstm_scan": ("src/repro_torch/csrc/mlstm_scan.cu",
                   "src/repro/kernels/mlstm_scan/scan.py:112"),
    "relay_copy": ("src/repro_torch/csrc/relay_copy.cu",
                   "src/repro/kernels/relay_copy/relay.py:52"),
    "token_scatter_add": ("src/repro_torch/csrc/token_scatter_add.cu",
                          "none: no Pallas kernel; the port's own kernel for the XLA "
                          "scatter-add VJP at src/repro/kernels/token_scatter/ops.py:30"),
}
MOE_KERNELS = ("token_gather", "grouped_ffn_blocked", "flash_attention")


class Checks:
    """Collects failed checks; the run fails at the end if any did."""

    def __init__(self):
        self.failed = []

    def __call__(self, ok: bool, what: str) -> bool:
        if not ok:
            self.failed.append(what)
            print(f"  FAILED: {what}", flush=True)
        return ok


def _to(tree, device, dtype=None):
    """A parameter tree on ``device`` (floating leaves cast to ``dtype``)."""
    if isinstance(tree, dict):
        return {k: _to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device, dtype) for v in tree]
    return tree.to(device=device, dtype=dtype or tree.dtype)


class Recorder:
    """Records the arguments of a module-level function while installed."""

    def __init__(self, module, name, keep: int = 8):
        self.module, self.name, self.keep = module, name, keep
        self.calls = []
        self.orig = getattr(module, name)

    def __enter__(self):
        def rec(*args, **kw):
            if len(self.calls) < self.keep:
                self.calls.append(tuple(a.clone() if hasattr(a, "clone") else a
                                        for a in args) + (dict(kw),))
            return self.orig(*args, **kw)
        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _raises_under_grad(torch, run, args) -> bool:
    """True when ``run`` raises RuntimeError for each input made to need a
    gradient, and runs under ``torch.no_grad`` on the same inputs."""
    for i in range(len(args)):
        live = [a.clone().requires_grad_(j == i) for j, a in enumerate(args)]
        try:
            run(live)
            return False
        except RuntimeError:
            pass
        with torch.no_grad():
            run(live)
    return True


def _max_err(out, ref) -> float:
    return (out.float() - ref.float()).abs().max().item()


def gather_report(torch, x, idx, token_gather, token_gather_ref) -> dict:
    """``token_gather`` on one captured call: times, bound and error.

    The bound counts the bytes this call's data needs: the rows it reads
    (index >= 0), the rows it writes and the indices, at 3.35 TB/s.
    ``index_select`` is the yardstick, on the indices clipped at 0 (it
    takes no -1 and writes no zero rows).  Times by CUDA events over 20
    calls include the host's launch cost; the device times do not
    (``kernel_times.device_ms``: the calls queue behind a sleeping kernel).
    """
    from repro_torch.launch.kernel_times import device_ms, time_ms

    safe = idx.clamp_min(0)
    valid = int((idx >= 0).sum())
    row = x.shape[1] * x.element_size()
    moved = (valid + idx.numel()) * row + idx.numel() * idx.element_size()
    return dict(
        ms=time_ms(lambda: token_gather(x, idx), 20),
        plain_ms=time_ms(lambda: token_gather_ref(x, idx), 20),
        library_ms=time_ms(lambda: torch.index_select(x, 0, safe), 20),
        device_ms=device_ms(lambda: token_gather(x, idx), 20),
        library_device_ms=device_ms(lambda: torch.index_select(x, 0, safe), 20),
        bound_ms=moved / PEAK_BYTES_S * 1e3, bound_by="bytes",
        max_abs_err=_max_err(token_gather(x, idx), token_gather_ref(x, idx)),
        shape=f"x {tuple(x.shape)} {str(x.dtype)[6:]}, idx [{idx.numel()}] "
              f"({valid} read)")


def print_gather(label, r) -> None:
    print(f"[2 kernel] token_gather {label}: {r['shape']}: kernel {r['ms']:.4f} ms "
          f"({r['device_ms']:.4f} on the device, {r['device_ms'] / r['bound_ms']:.2f}x its "
          f"bound), plain {r['plain_ms']:.4f} ms, index_select {r['library_ms']:.4f} ms "
          f"({r['library_device_ms']:.4f} on the device), bound {r['bound_ms']:.4f} ms "
          f"(bytes)", flush=True)


def xlstm_phases(torch, np, check, compare, seed: int, dev):
    """Phases 10-12 on xlstm-125m -> (mlstm_scan's report, its launches)."""
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.mlstm_scan.ops import mlstm_scan, mlstm_scan_chunked_ref
    from repro_torch.launch.kernel_times import time_ms
    from repro_torch.models import xlstm as xlstm_mod
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding.context import ParallelContext

    cfg = get_config("xlstm-125m")
    bf16 = torch.bfloat16
    ctx = ParallelContext(param_dtype=bf16, compute_dtype=bf16, device="cuda")
    model = build_model(cfg, ctx)
    params = model.init(seed)
    ctx32 = ParallelContext(device="cuda")
    model32 = build_model(cfg, ctx32)
    params32 = _to(params, dev, torch.float32)
    rng = np.random.default_rng(seed + 1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 2048)), device=dev)
    batch = {"tokens": tokens}

    # ---- 10. mlstm_scan against its plain version ----------------------------
    # capture pass (also a warm-up): layer 0's q, k, v, ig, lf at the prefill
    with Recorder(xlstm_mod, "mlstm_scan", keep=1) as rec:
        model.forward(params, batch, last_only=True)
    torch.cuda.synchronize()
    q, k, v, ig, lf = (a.contiguous() for a in rec.calls[0][:5])
    chunk = rec.calls[0][5]["chunk"]
    h, st = mlstm_scan(q, k, v, ig, lf, chunk=chunk)
    h_ref, st_ref = mlstm_scan_chunked_ref(q, k, v, ig, lf, chunk=chunk)
    why = "f32 sums over dh and the chunk's steps in another order"
    err = compare("mlstm_scan", "h f32", h, h_ref, 1e-4, why)
    for key in ("C", "n", "m"):
        compare("mlstm_scan", f"final {key} f32", st[key], st_ref[key], 1e-4, why)
    B, H, S, dh = q.shape
    L = min(chunk, S)
    n_chunks = -(-S // L)
    # least work: q k^T and S v over the causal half of each L x L chunk, q C
    # and the k^T v state update at L x dh x dh; bytes: q, k, v, ig, lf in,
    # h and the final (C, n, m) out, once each
    flops = 2.0 * B * H * n_chunks * (2 * (L * (L + 1) // 2) * dh + 2 * L * dh * dh)
    nbytes = 4 * (4 * B * H * S * dh + 2 * B * H * S + B * H * (dh * dh + dh + 1))
    t_ops, t_bytes = flops / PEAK_FLOPS["f32"], nbytes / PEAK_BYTES_S
    ms_report = dict(
        ms=time_ms(lambda: mlstm_scan(q, k, v, ig, lf, chunk=chunk), 10),
        plain_ms=time_ms(lambda: mlstm_scan_chunked_ref(q, k, v, ig, lf,
                                                                 chunk=chunk), 3),
        library_ms=None, max_abs_err=err,
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
    )
    grad_raises = _raises_under_grad(
        torch, lambda a: mlstm_scan(*a, chunk=chunk)[0],
        [t[:, :, :2 * L].contiguous() for t in (q, k, v, ig, lf)])
    check(grad_raises, "mlstm_scan: an input that needs a gradient did not raise on the card")
    print(f"[10 kernel] mlstm_scan: q/k/v {tuple(q.shape)} f32, chunk {L}: kernel "
          f"{ms_report['ms']:.4f} ms, plain {ms_report['plain_ms']:.4f} ms, library none, "
          f"bound {ms_report['bound_ms']:.4f} ms ({ms_report['bound_by']}: "
          f"{flops / 1e9:.3f} GFLOP at 67 TFLOP/s, {nbytes / 1e6:.1f} MB at 3.35 TB/s); "
          f"an input that needs a gradient {'raises' if grad_raises else 'DOES NOT RAISE'} "
          f"(no backward; under torch.no_grad the same call runs)", flush=True)

    # ---- 11. prefill ---------------------------------------------------------
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = model.forward(params, batch, last_only=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts_prefill = launch_counts()
    check(tuple(logits.shape) == (4, 1, cfg.vocab), f"xlstm prefill logits {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "xlstm prefill logits not finite")
    # the chunked (kernel) forward against the per-step mLSTM forward
    step_cfg = dataclasses.replace(cfg, mlstm_chunk=0)
    short = {"tokens": tokens[:, :256]}
    cross = {}
    for label, m, p, mstep, tol in (
            ("f32", model32, params32, build_model(step_cfg, ctx32), 1e-3),
            ("bf16", model, params, build_model(step_cfg, ctx), 5e-2)):
        lc, _ = m.forward(p, short)
        ls, _ = mstep.forward(p, short)
        cross[label] = compare("xlstm chunked vs per-step", f"{label} logits 4x256", lc, ls,
                               tol, "f32: sums in other orders through 12 layers"
                               if label == "f32" else "bf16 activations round differently")
    # a reduced config on the card against the CPU's plain versions
    small = get_config("xlstm-125m").reduced(n_layers=4)
    cpu = ParallelContext(device="cpu")
    m_cpu = build_model(small, cpu)
    p_cpu = m_cpu.init(seed)
    toks_s = torch.as_tensor(rng.integers(0, small.vocab, (2, 160)))
    ls_cpu, _ = m_cpu.forward(p_cpu, {"tokens": toks_s})
    ls_gpu, _ = build_model(small, ctx32).forward(_to(p_cpu, dev), {"tokens": toks_s.to(dev)})
    small_err = _max_err(ls_gpu.cpu(), ls_cpu)
    check(small_err <= 1e-3, f"reduced xlstm card vs CPU: {small_err:.3g}")
    n_tok = tokens.numel()
    print(f"[11 prefill] {cfg.name} bf16, 4 x 2048 tokens: {prefill_s * 1e3:.1f} ms, "
          f"{n_tok / prefill_s:.0f} tokens/s, logits {tuple(logits.shape)} finite; "
          f"chunked vs per-step mLSTM at 4 x 256: max|diff| f32 {cross['f32']:.4g}, "
          f"bf16 {cross['bf16']:.4g}; reduced xlstm (dh 64) f32 card vs CPU plain "
          f"{small_err:.3g} (limit 1e-3: f32 sums in other orders)", flush=True)

    # ---- 12. generation ------------------------------------------------------
    P, n_new = 128, 16
    prompts = rng.integers(0, cfg.vocab, (4, P))
    engine = ServeEngine(model, params, max_len=P + n_new)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = engine.generate(prompts, n_new=n_new)
    gen_s = time.perf_counter() - t0
    counts_gen = launch_counts()
    check(ids.shape == (4, n_new) and ((ids >= 0) & (ids < cfg.vocab)).all(),
          f"xlstm generated ids {ids.shape}")
    # the engine's step-by-step prefill ends where the kernel-path forward does
    pt = torch.as_tensor(prompts, device=dev)
    shape = InputShape("serve", P + n_new, 4, "decode")
    agree = {}
    for label, m, p, eng, tol in (
            ("bf16", model, params, engine, 5e-2),
            ("f32", model32, params32, ServeEngine(model32, params32, P + n_new), 1e-3)):
        with torch.no_grad():
            l_step, _ = eng.prefill(m.init_cache(4, shape), pt)
            l_fwd = m.forward(p, {"tokens": pt}, last_only=True)[0][:, 0]
        compare("xlstm engine prefill vs forward", f"{label} last logits", l_step, l_fwd,
                tol, "per-step vs chunked mLSTM" + ("" if label == "f32"
                                                    else ", bf16 activations"))
        agree[label] = torch.equal(l_step.float().argmax(-1), l_fwd.float().argmax(-1))
    check(agree["f32"], "xlstm f32: argmax of the step prefill != the forward's")
    print(f"[12 generate] {cfg.name} bf16, 4 requests, prompt {P}, {n_new} new tokens, "
          f"greedy: {gen_s:.2f} s, {ids.size / gen_s:.1f} new tokens/s "
          f"({4 * (P + n_new) / gen_s:.1f} incl. the prompt steps); argmax of the last "
          f"prompt logits, step prefill vs forward: f32 {'equal' if agree['f32'] else 'DIFFER'}"
          f", bf16 {'equal' if agree['bf16'] else 'differ'} (reported, not checked); ids "
          f"{ids[:, :8].tolist()}", flush=True)
    return ms_report, counts_prefill["mlstm_scan"] + counts_gen["mlstm_scan"]


class EventTimer:
    """Device time of every call of a module-level function while installed
    (CUDA events around each call; read after a synchronize)."""

    def __init__(self, torch, module, name):
        self.torch, self.module, self.name = torch, module, name
        self.orig = getattr(module, name)
        self.events = []

    def __enter__(self):
        def timed(*args, **kw):
            start, end = (self.torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = self.orig(*args, **kw)
            end.record()
            self.events.append((start, end))
            return out
        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)

    def total_ms(self) -> float:
        self.torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def train_phases(torch, np, check, seed: int, dev, smi: str):
    """Phases 7-9 on paper-moe-8e training -> (token_scatter_add's report, the
    training path's launches)."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.grouped_ffn import ops as ffn_ops
    from repro_torch.kernels.token_scatter import ops as ts_ops
    from repro_torch.launch.kernel_times import device_ms, time_ms
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw
    from repro_torch.sharding.context import ParallelContext
    from repro_torch.train.step import loss_and_grads, make_train_step
    from repro_torch.tree import leaves, map_tree

    # ---- 7. train at full width ----------------------------------------------
    cfg = get_config("paper-moe-8e")
    bf16 = torch.bfloat16
    ctx8 = ParallelContext(ep_size=8, group_size=4, moe_mode="nimble", param_dtype=bf16,
                           compute_dtype=bf16, device="cuda")
    model = build_model(cfg, ctx8)
    params = model.init(seed)
    n_params = sum(p.numel() for p in leaves(params))
    state = adamw.init(params)
    # the training launcher's defaults: lr 3e-4 after 20 steps of warm-up
    step = make_train_step(model, adamw.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=100))
    B, S = 4, 512
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=seed))
    t0 = time.perf_counter()
    batches = [to_device(data.batch(i), dev) for i in range(5)]
    data_ms = (time.perf_counter() - t0) * 1e3 / 5
    # warm-up step, recording the backward's token_scatter_add calls
    with Recorder(ts_ops, "token_scatter_add", keep=16) as rec_sa:
        params, state, m0 = step(params, state, batches[0])
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    with EventTimer(torch, ffn_ops, "grouped_ffn_bwd") as t_ffn, \
            EventTimer(torch, fa_ops, "flash_attention_bwd") as t_fa:
        for i in (1, 2, 3):
            times, stats = {}, {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batches[i], stats=stats, times=times)
            wall = time.perf_counter() - t0                    # the step ends in a sync
            rows.append(dict(wall=wall, loss=float(m["loss"]),
                             gnorm=float(m["grad_norm"]), dropped=int(stats["dropped"]),
                             **times))
    counts_train = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ffn_bwd_ms, fa_bwd_ms = t_ffn.total_ms() / 3, t_fa.total_ms() / 3
    losses = [float(m0["loss"])] + [r["loss"] for r in rows]
    norms = [float(m0["grad_norm"])] + [r["gnorm"] for r in rows]
    check(bool(np.isfinite(losses).all() and np.isfinite(norms).all()),
          f"train losses {losses} or grad norms {norms} not finite")
    step_ms = float(np.mean([r["wall"] for r in rows])) * 1e3
    walls = ", ".join(f"{r['wall'] * 1e3:.1f}" for r in rows)
    share = {k: float(np.mean([r[k] / r["wall"] for r in rows]))
             for k in ("forward", "backward", "optimizer")}
    print(f"[7 train] {cfg.name} bf16, {n_params / 1e9:.3f} B params, ep=8 groups of 4 "
          f"nimble, capacity factor {cfg.moe_capacity_factor}, batch {B} x {S} from "
          f"SyntheticLM ({data_ms:.1f} ms a batch on the host), AdamW: step "
          f"{walls} ms (mean {step_ms:.1f} ms, "
          f"{B * S / step_ms * 1e3:.0f} tokens/s; warm-up step excluded); forward "
          f"{share['forward']:.3f}, backward {share['backward']:.3f}, optimizer "
          f"{share['optimizer']:.3f} of the step; grouped FFN backward (plain torch) "
          f"{ffn_bwd_ms:.2f} ms, attention backward (plain torch, f32) {fa_bwd_ms:.2f} ms a "
          f"step; peak memory {peak_gb:.2f} GB; on {smi}", flush=True)
    print(f"[7 train] loss by step {[round(x, 4) for x in losses]}, grad_norm "
          f"{[round(x, 4) for x in norms]}, dropped {[r['dropped'] for r in rows]} of "
          f"{B * S * cfg.top_k} assignments; launches in the 3 timed steps {counts_train}",
          flush=True)
    del state, m0, m
    torch.cuda.empty_cache()

    # ---- 8. parity on the card -------------------------------------------------
    # capacity factor 8 holds every assignment; EP 8 against EP 1 on the same
    # (trained) weights, one step's loss and gradients.  Both route each
    # expert's rows in the same order (the dataplane moves rows and adds
    # nothing; token_scatter_add sums a row's sources in increasing i), so
    # the same products see the same operands: they must agree bit for bit
    nodrop = build_model(dataclasses.replace(cfg, moe_capacity_factor=8.0), ctx8)
    one = build_model(cfg, dataclasses.replace(ctx8, ep_size=1))
    st = {}
    l8, g8 = loss_and_grads(nodrop, params, batches[4], stats=st)
    l1, g1 = loss_and_grads(one, params, batches[4])
    check(int(st["dropped"]) == 0, "capacity factor 8 dropped assignments in training")
    loss_err = abs(float(l8) - float(l1))
    check(loss_err == 0.0, f"EP8 vs EP1 train loss {float(l8)} vs {float(l1)}")
    worst = 0.0
    for a, b in zip(leaves(g8), leaves(g1)):
        rel = ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()
        worst = max(worst, rel)
    check(worst == 0.0, f"EP8 vs EP1 gradients: worst leaf {worst:.3g} of its max")
    del g8, g1, nodrop, one, params, model
    torch.cuda.empty_cache()
    # a reduced config's one-step gradients: the card's kernels (f32 routes)
    # against the CPU's plain versions
    small = dataclasses.replace(cfg.reduced(), n_experts=8)
    ctx_s = ParallelContext(ep_size=8, group_size=4, device="cpu")
    m_cpu = build_model(small, ctx_s)
    p_cpu = m_cpu.init(seed)
    sb = SyntheticLM(DataConfig(vocab=small.vocab, seq_len=128, global_batch=2,
                                seed=seed)).batch(0)
    lc, gc = loss_and_grads(m_cpu, p_cpu, to_device(sb, "cpu"))
    lg, gg = loss_and_grads(build_model(small, dataclasses.replace(ctx_s, device="cuda")),
                            map_tree(lambda t: t.to(dev), p_cpu), to_device(sb, dev))
    small_worst = max(((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                      for a, b in zip(leaves(gg), leaves(gc)))
    small_loss = abs(float(lg) - float(lc))
    check(small_worst <= 1e-4 and small_loss <= 1e-5 * abs(float(lc)),
          f"reduced train step card vs CPU: loss {small_loss:.3g}, grads {small_worst:.3g}")
    print(f"[8 train parity] capacity factor 8 (dropped {int(st['dropped'])}): EP8 vs EP1 loss "
          f"{float(l8):.5f} vs {float(l1):.5f} (|diff| {loss_err:.3g}), gradients worst leaf "
          f"max|diff| / max|leaf| {worst:.3g} (limit 0 for both: each expert's rows arrive in "
          f"the same order on EP 8 as on EP 1, so every sum sees the same operands); "
          f"reduced config f32 one step, card vs CPU plain: loss |diff| {small_loss:.3g} "
          f"(limit 1e-5 x |loss|), gradients worst leaf {small_worst:.3g} (limit 1e-4: f32 "
          f"sums in other orders)", flush=True)

    # ---- 9. token_scatter_add against its plain version -------------------------
    # rows of at most two sources round once, so they equal the plain version
    # (the CPU's, summed in order) bit for bit; more sources sum in another
    # order: within one bf16 rounding of the largest value
    parts = []
    for i, (g, idx, n, _) in enumerate(rec_sa.calls):
        out = ts_ops.token_scatter_add(g, idx, n)
        again = ts_ops.token_scatter_add(g, idx, n)
        ref = ts_ops.token_scatter_add_ref(g.cpu(), idx.cpu(), n)
        # the inverse-index launch against the plain stable sort and search
        inv, inv_ref = ts_ops.build_inverse_index(idx, n), ts_ops.inverse_index(idx, n)
        check(all(torch.equal(a, b) for a, b in zip(inv, inv_ref)),
              f"token_scatter_add call {i}: the inverse index differs from the plain one")
        key = torch.where(idx < 0, n, idx.clamp_max(n - 1))
        mult = int(torch.bincount(key, minlength=n + 1)[:n].max())
        err = _max_err(out.cpu(), ref)
        ok = err == 0.0 if mult <= 2 else err <= 2.0 ** -8 * ref.float().abs().max().item()
        same = torch.equal(out, again)
        check(ok, f"token_scatter_add call {i} g {tuple(g.shape)}: max|err| {err:.3g} "
              f"with at most {mult} sources a row")
        check(same, f"token_scatter_add call {i}: a second run gave other bits")
        parts.append(f"{i}: {tuple(g.shape)} -> {n} rows, <= {mult} sources, max|err| "
                     f"{err:g}, {'same bits' if same else 'DIFFER'}, index of "
                     f"{-(-(n + 1) // ts_ops.INDEX_KEYS)} block(s) "
                     f"{'= plain' if torch.equal(inv[0], inv_ref[0]) else '!= plain'}")
    # the index launch of one block (n + 1 <= INDEX_KEYS row ids) on the
    # pack's indices, clipped onto 300 rows
    g, idx = rec_sa.calls[-1][:2]
    one = all(torch.equal(a, b) for a, b in zip(ts_ops.build_inverse_index(idx, 300),
                                                 ts_ops.inverse_index(idx, 300)))
    check(one, "the inverse index of one block differs from the plain one")
    print(f"[9 kernel] token_scatter_add on the {len(rec_sa.calls)} backward calls of phase 7's "
          f"warm-up step (the inverse index by its own launch, against the plain stable sort "
          f"and search): " + "; ".join(parts) + f"; the index of one block ({idx.numel()} "
          f"indices clipped onto 300 rows) {'= plain' if one else '!= plain'}", flush=True)

    def scatter_report(g, idx, n):
        valid = idx >= 0
        safe, src = idx.clamp(0, n - 1)[valid], g[valid]
        acc = torch.zeros((n, g.shape[1]), dtype=g.dtype, device=dev)
        moved = (int(valid.sum()) + n) * g.shape[1] * g.element_size() \
            + idx.numel() * idx.element_size()
        return dict(
            ms=time_ms(lambda: ts_ops.token_scatter_add(g, idx, n), 20),
            device_ms=device_ms(lambda: ts_ops.token_scatter_add(g, idx, n), 20),
            index_device_ms=device_ms(lambda: ts_ops.build_inverse_index(idx, n), 20),
            plain_index_device_ms=device_ms(lambda: ts_ops.inverse_index(idx, n), 20),
            plain_ms=time_ms(lambda: ts_ops.token_scatter_add_ref(g, idx, n), 10),
            library_ms=time_ms(lambda: acc.index_add_(0, safe, src), 20),
            library_device_ms=device_ms(lambda: acc.index_add_(0, safe, src), 20),
            bound_ms=moved / PEAK_BYTES_S * 1e3, bound_by="bytes",
            max_abs_err=_max_err(ts_ops.token_scatter_add(g, idx, n),
                                 ts_ops.token_scatter_add_ref(g, idx, n)),
            shape=f"g {tuple(g.shape)} {str(g.dtype)[6:]} -> {n} rows "
                  f"({int(valid.sum())} read)")

    # the dispatch pack's backward (token rows, read up to top_k times) and
    # one relay round's (a permutation of 128 KiB chunk rows)
    pack = next(c for c in rec_sa.calls if c[0].shape[1] == cfg.d_model
                and c[1].numel() > c[2])
    relay = next(c for c in rec_sa.calls if c[0].shape[1] == cfg.d_model * 16
                 and c[1].numel() == c[2] and bool((c[1] >= 0).all()))
    report = scatter_report(*pack[:3])
    report["relay round backward"] = scatter_report(*relay[:3])
    # the same bytes forward: token_gather over the round's g and permutation
    report["relay round backward"]["gather_device_ms"] = device_ms(
        lambda: ts_ops.token_gather(*relay[:2]), 20)
    for label, r in (("dispatch pack backward", report),
                     ("relay round backward", report["relay round backward"])):
        print(f"[9 kernel] token_scatter_add {label}: {r['shape']}: kernel {r['ms']:.4f} ms "
              f"({r['device_ms']:.4f} on the device, {r['device_ms'] / r['bound_ms']:.2f}x its "
              f"bound; of it the inverse-index launch {r['index_device_ms']:.4f} and the row "
              f"sums {r['device_ms'] - r['index_device_ms']:.4f}; the plain sort and search "
              f"{r['plain_index_device_ms']:.4f}), "
              + (f"token_gather on the same g and idx {r['gather_device_ms']:.4f} on the "
                 f"device (kernel {r['device_ms'] / r['gather_device_ms']:.3f}x), "
                 if "gather_device_ms" in r else "")
              + f"plain {r['plain_ms']:.4f} ms, "
              f"index_add_ {r['library_ms']:.4f} ms ({r['library_device_ms']:.4f} on the "
              f"device), bound {r['bound_ms']:.4f} ms (bytes)", flush=True)
    del rec_sa
    torch.cuda.empty_cache()
    return report, counts_train


def relay_phase(torch, check, seed: int, dev):
    """Phase 13 -> (relay_copy's report, its launches through its entry point,
    by route)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.relay_copy.ops import (
        parity_slot_map,
        relay_copy,
        relay_copy_ref,
    )
    from repro_torch.launch.kernel_times import device_ms, time_ms

    gen = torch.Generator(device=dev).manual_seed(seed)
    n, d, bc = 8192, 4096, 256
    n_chunks = n // bc
    maps = {"parity": parity_slot_map(n_chunks, dev),
            "swapped": 1 - parity_slot_map(n_chunks, dev),
            "zeros": torch.zeros(n_chunks, dtype=torch.int32, device=dev)}
    inputs = {
        "bf16": torch.randn((n, d), generator=gen, device=dev).to(torch.bfloat16),
        "f32": torch.randn((n, d), generator=gen, device=dev),
        "int32": torch.randint(-2**31, 2**31 - 1, (n, d), generator=gen, device=dev,
                               dtype=torch.int32),
    }
    parts = []
    for dt, x in inputs.items():
        for mname, smap in maps.items():
            out = relay_copy(x, smap, block_chunk=bc)
            exact = torch.equal(out, x) and torch.equal(out, relay_copy_ref(x, smap,
                                                                             block_chunk=bc))
            check(exact, f"relay_copy {dt} {mname} map: not bit-exact")
            parts.append(f"{dt}/{mname} {'exact' if exact else 'WRONG'}")
    x = inputs["bf16"]
    smap = maps["parity"]
    out = torch.empty_like(x)
    nbytes = 2 * x.numel() * x.element_size() + smap.numel() * 4
    report = dict(
        ms=time_ms(lambda: relay_copy(x, smap, block_chunk=bc), 20),
        device_ms=device_ms(lambda: relay_copy(x, smap, block_chunk=bc), 20),
        plain_ms=time_ms(lambda: relay_copy_ref(x, smap, block_chunk=bc), 20),
        library_ms=time_ms(lambda: out.copy_(x), 20),
        library_device_ms=device_ms(lambda: out.copy_(x), 20),
        max_abs_err=_max_err(relay_copy(x, smap, block_chunk=bc), x),
        bound_ms=nbytes / PEAK_BYTES_S * 1e3, bound_by="bytes",
    )
    del inputs
    grad_raises = _raises_under_grad(torch, lambda a: relay_copy(a[0], block_chunk=bc),
                                     [x[:2 * bc].float()])
    check(grad_raises, "relay_copy: an input that needs a gradient did not raise on the card")
    # its own entry point, as a caller would use it (default map and chunk),
    # on each route: the bulk route, then 420- and 210-byte chunks (4- and
    # 2-byte words)
    small = {"f32": torch.randn((45, 7), generator=gen, device=dev)}
    small["bf16"] = small["f32"].to(torch.bfloat16)
    reset_launch_counts()
    y = relay_copy(x)
    ys = {k: relay_copy(v, block_chunk=15) for k, v in small.items()}
    torch.cuda.synchronize()
    counts = launch_counts()
    launches = {k: counts[k] for k in ("relay_copy", "relay_copy_w4", "relay_copy_w2")}
    check(torch.equal(y, x) and all(torch.equal(ys[k], small[k]) for k in small),
          "relay_copy entry point: not bit-exact")
    print(f"[13 relay] relay_copy [{n}, {d}], chunks of {bc} rows: {', '.join(parts)}; "
          f"bf16 parity: kernel {report['ms']:.4f} ms ({report['device_ms']:.4f} on the "
          f"device, {report['bound_ms'] / report['device_ms']:.3f} of its bound), plain "
          f"(clone) {report['plain_ms']:.4f} ms, copy_ {report['library_ms']:.4f} ms "
          f"({report['library_device_ms']:.4f} on the device), bound "
          f"{report['bound_ms']:.4f} ms (bytes); entry point relay_copy(x) on [8192, 4096] "
          f"bf16 and [45, 7] f32 and bf16 in chunks of 15 rows: launches by route "
          f"{launches}, exact; an input that needs a gradient "
          f"{'raises' if grad_raises else 'DOES NOT RAISE'} (no backward)", flush=True)
    return report, launches


def runtime_phase(torch, np, check, smi: str):
    """Phase 15: the execution-time planning runtime, card against CPU.

    Replays the paper's testbed scenarios (2 nodes x 4, ``RuntimeConfig()``'s
    32 MWU iterations) and an 8-node EP group's drift through
    ``OrchestrationRuntime.run_trace``, ``run_static`` and ``run_oracle`` with
    every solve on the card, and again on the CPU: the reports must be
    equal.  Times each solve the card runs (the ``plan_flows_batch`` call,
    synchronized before and after), and pairs the host ``solve_mwu`` sweep
    with the card's ``plan_flows_batch`` at n=32."""
    import statistics

    from repro_torch import runtime as rt
    from repro_torch.core.mcf import apply_plan_fractions, congestion_lower_bound, solve_mwu
    from repro_torch.core.schedule import build_planner_tables
    from repro_torch.core.topology import Topology
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import controller

    G = 4
    scenarios = {
        "drift n=8": (8, rt.drifting_skew_trace(8, 48, dwell=12), None),
        "balanced n=8": (8, rt.balanced_trace(8, 30), None),
        "link-down n=8": (8, rt.balanced_trace(8, 24), (8, 0, G)),
        "drift n=32": (32, rt.drifting_skew_trace(32, 48, dwell=12), None),
    }
    pcfg = rt.RuntimeConfig().planner
    plan = controller.plan_flows_batch
    solve_ms = []                                   # each card solve's ms

    def timed(d, tables, cfg, **kw):
        if d.device.type != "cuda":
            return plan(d, tables, cfg, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plan(d, tables, cfg, **kw)
        torch.cuda.synchronize()
        solve_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def warm_ratio(runtime):
        """The never-replaced warm plan's congestion ratio (Z over the cut
        bound Z*) on its own uniform demand: the policy's baseline."""
        n = runtime.topo.n_devices
        dem = rt.demand_dict(np.full((n, n), 64.0 * runtime.cfg.chunk_bytes))
        z = apply_plan_fractions(runtime.active_plan, dem, topo=runtime.topo)
        return z.max_normalized_load() / congestion_lower_bound(runtime.topo, dem)

    for n in (8, 32):                               # device tables and warm launches
        rt.solve_plans_batch(Topology(n, G), scenarios[f"drift n={n}"][1][:1],
                             planner_cfg=pcfg, device="cuda")
    reset_launch_counts()
    controller.plan_flows_batch = timed
    results = {}
    try:
        for label, (n, trace, ev) in scenarios.items():
            topo = Topology(n, G)
            log = (lambda: rt.EventLog([rt.link_down(*ev)])) if ev else (lambda: None)
            runs = {}
            for dv in ("cuda", "cpu"):
                first = len(solve_ms)
                runtime = rt.OrchestrationRuntime(topo, events=log(), device=dv)
                adaptive = runtime.run_trace(trace)
                if dv == "cuda":
                    card_solves = solve_ms[first:]
                    warm = warm_ratio(runtime) if not adaptive.stats.replans else None
                runs[dv] = dict(
                    adaptive=adaptive,
                    static=rt.run_static(topo, trace, events=log(), device=dv),
                    oracle=rt.run_oracle(topo, trace, device=dv),
                )
            for arm in ("adaptive", "static", "oracle"):
                check(runs["cuda"][arm].to_json_obj() == runs["cpu"][arm].to_json_obj(),
                      f"runtime {label} {arm}: card reports != CPU reports")
            results[label] = (runs["cuda"], card_solves, warm)
    finally:
        controller.plan_flows_batch = plan
    torch.cuda.synchronize()
    launched = {k: v for k, v in launch_counts().items() if v}

    def recovery(res, fail_at):
        pre = np.median([r.completion_s for r in res.reports[:fail_at]])
        return next((r.window - fail_at for r in res.reports[fail_at:]
                     if r.completion_s <= 2.0 * pre), None)

    for label, (runs, solves, warm) in results.items():
        a, s, o = runs["adaptive"], runs["static"], runs["oracle"]
        ratios = [r.congestion_ratio for r in a.reports]
        extra = (f"; congestion ratio over the windows {min(ratios):.4f}-{max(ratios):.4f}"
                 + ("" if warm is None else f", the warm plan's baseline {warm:.4f} "
                    f"(a replan fires above "
                    f"{warm * rt.PolicyConfig().degrade_factor:.4f})"))
        if label.startswith("link-down"):
            rec = recovery(a, 8)
            check(a.reports[8].replan_reason == "topology" and rec is not None,
                  f"runtime {label}: no topology replan or no recovery")
            extra += (f"; link 0->4 down at w8: replan reason "
                     f"{a.reports[8].replan_reason!r}, recovered in {rec} window(s), "
                     f"oracle on the healthy fabric")
        if label == "drift n=8":
            check(s.total_completion_s / a.total_completion_s >= 1.3
                  and a.replan_fraction <= 0.25,
                  f"runtime {label}: adaptive below 1.3x static or over 25% replans")
        if label == "balanced n=8":
            check(a.total_completion_s / s.total_completion_s <= 1.02
                  and all(w < 2 for w in a.replan_windows),
                  f"runtime {label}: adaptive over 1.02x static or replans after w1")
        print(f"[15 runtime] {label}, {len(a.reports)} windows: simulated completion "
              f"static {s.total_completion_s * 1e3:.4f} ms, adaptive "
              f"{a.total_completion_s * 1e3:.4f} ms, oracle {o.total_completion_s * 1e3:.4f}"
              f" ms; adaptive {s.total_completion_s / a.total_completion_s:.4f}x static "
              f"(adaptive/static {a.total_completion_s / s.total_completion_s:.4f}), oracle "
              f"{s.total_completion_s / o.total_completion_s:.4f}x; replans "
              f"{a.stats.replans} at windows {a.replan_windows}, solves {a.stats.solves}, "
              f"cache hits {a.stats.cache_hits}, swaps {a.stats.swaps}{extra}; card solves "
              f"of the adaptive run {len(solves)}, median {statistics.median(solves):.3f} "
              f"ms; "
              f"card reports = CPU reports", flush=True)

    # solve latency on the card, each call synchronized, beside the host solvers
    def med_ms(fn, reps, sync):
        out = []
        for _ in range(reps):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            if sync:
                torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    parts = []
    for n in (8, 32):
        topo = Topology(n, G)
        tables = build_planner_tables(topo)
        trace = scenarios[f"drift n={n}"][1]
        one = torch.as_tensor(trace[:1].astype(np.float32))
        d1, d48 = one.cuda(), torch.as_tensor(trace.astype(np.float32)).cuda()
        t = dict(
            card_b1=med_ms(lambda: plan(d1, tables, pcfg), 20, True),
            card_solve_plans=med_ms(lambda: rt.solve_plans_batch(
                topo, trace[:1], planner_cfg=pcfg, device="cuda"), 10, True),
            card_b48=med_ms(lambda: plan(d48, tables, pcfg), 5, True),
            cpu_b1=med_ms(lambda: plan(one, tables, pcfg), 5, False),
            host_sweep=med_ms(lambda: solve_mwu(topo, rt.demand_dict(trace[0])), 5,
                              False),
        )
        parts.append(
            f"n={n}: card plan_flows_batch B=1 {t['card_b1']:.3f} ms, B=48 (the "
            f"oracle's batch) {t['card_b48']:.3f} ms, solve_plans_batch B=1 with the "
            f"copy back and plan_from_flows {t['card_solve_plans']:.3f} ms; CPU "
            f"plan_flows_batch B=1 {t['cpu_b1']:.3f} ms; host solve_mwu sweep "
            f"{t['host_sweep']:.3f} ms")
    print(f"[15 runtime] solve times (medians; card calls synchronized before and "
          f"after; {pcfg.n_iters} MWU iterations; drift window 0) on {smi}: "
          + "; ".join(parts) + f"; port kernels launched by phase 15: "
          f"{launched or 'none (the planner loop is plain torch)'}", flush=True)


def _quiet(fn, *args):
    """``fn(*args)`` with its standard output captured -> (result, text)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def session_phase(torch, np, check, smi: str, seed: int, dev, phase4_logits,
                  phase4_ms: float):
    """Phase 16: the endpoint API and the shared-fabric arbiter on the card."""
    import statistics

    from repro_torch import runtime as rt
    from repro_torch.api import Session, SessionSpec, TopologySpec, selfcheck
    from repro_torch.configs.base import get_config
    from repro_torch.core.dataplane import NimbleAllToAll
    from repro_torch.core.mcf import solve_direct
    from repro_torch.core.moe_comm import MoECommConfig
    from repro_torch.core.topology import Topology
    from repro_torch.examples import skewed_alltoallv
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import fairness
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.context import ParallelContext

    t_phase = time.perf_counter()
    print(f"[16 session] {smi}", flush=True)

    # ---- 16a. the fairness sections, card against CPU -------------------------
    reports = {"cuda": {}, "cpu": {}}
    with fairness.timed_solves() as solves:
        t0 = time.perf_counter()
        card = fairness.metrics(device="cuda", reports=reports["cuda"])
        card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = fairness.metrics(device="cpu", reports=reports["cpu"])
    cpu_s = time.perf_counter() - t0
    for side in reports.values():
        for r in side.values():
            r.pop("topology")
    for name in fairness.SECTIONS:
        same = card[name] == cpu[name]
        check(same, f"fairness {name}: card figures != CPU figures")
        print(f"[16a fairness] {name}: {fairness.describe(name, card[name])}; card "
              f"{'=' if same else '!='} CPU", flush=True)
    check(reports["cuda"] == reports["cpu"],
          "fairness: a card Session.report() != the CPU's")
    # the reference code's figures (its bench, rerun with JAX on a CPU)
    expect = {("host_coplan", "win"): 1.4554899, ("host_coplan", "jain_index"): 0.9983191,
              ("runtime_adaptive", "win"): 1.2131033, ("four_tenant", "win"): 1.0071764,
              ("four_tenant", "jain_index"): 0.8889080, ("mutual_drift", "win"): 1.0181673,
              ("mutual_drift", "win_legacy"): 0.7995681}
    for (sec, key), val in expect.items():
        check(round(card[sec][key], 7) == val,
              f"fairness {sec} {key} {card[sec][key]:.7f} != the reference's {val}")
    cal = card["mutual_drift"]["arms"]["calibrated"]
    check(card["runtime_adaptive"]["replans"] == 2 and card["four_tenant"]["solves"] == 6
          and cal["reprices"] == 3 and cal["price_hints"] == 11,
          "fairness: replans, solves, reprices or hints differ from the reference's")
    gated = {k: v["runtime_stats"]["gated"] for k, v in reports["cuda"].items()
             if "runtime_stats" in v}
    rt_solves = {k: v["runtime_stats"]["solves"] for k, v in reports["cuda"].items()
                 if "runtime_stats" in v}
    priced = [ms for p, ms in solves if p]

    def med_ms(fn, reps):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    topo = Topology(8, 4)
    pcfg = rt.RuntimeConfig().planner
    one = rt.drifting_skew_trace(8, 1, dwell=1)
    ext = solve_direct(topo, {(0, 4): 128.0 * 2**20, (4, 0): 128.0 * 2**20}
                       ).resource_bytes[None]
    solve = lambda dv, e: rt.solve_plans_batch(topo, one, planner_cfg=pcfg, ext_loads=e,
                                               device=dv)[0]
    same_priced = np.array_equal(solve("cuda", ext).resource_bytes,
                                 solve("cpu", ext).resource_bytes)
    check(same_priced, "priced solve_plans_batch: card plan != CPU plan")
    t_plain, t_priced = med_ms(lambda: solve("cuda", None), 15), med_ms(
        lambda: solve("cuda", ext), 15)
    print(f"[16a fairness] five sections on the card {card_s:.2f} s, on the CPU "
          f"{cpu_s:.2f} s; runtime solves on the card (each synchronized): "
          f"{fairness.solve_summary(solves)}; priced replans' median "
          f"{statistics.median(priced) if priced else float('nan'):.3f} ms; solves by "
          f"session {rt_solves}; gated windows {gated}; solve_plans_batch B=1 n=8 "
          f"({pcfg.n_iters} MWU iterations, the copy back and plan_from_flows included) "
          f"unpriced {t_plain:.3f} ms, priced (ext_loads) {t_priced:.3f} ms, priced card "
          f"plan {'=' if same_priced else '!='} CPU; every figure and report card = CPU; "
          f"on {smi}", flush=True)

    # ---- 16b. paper-moe-8e prefill through a Session ---------------------------
    cfg = get_config("paper-moe-8e")
    bf16 = torch.bfloat16
    ctx8 = ParallelContext(ep_size=8, group_size=4, moe_mode="nimble", param_dtype=bf16,
                           compute_dtype=bf16, device="cuda")
    model = build_model(cfg, ctx8)
    params = model.init(seed)
    prompts = torch.as_tensor(np.random.default_rng(seed).integers(0, cfg.vocab, (4, 512)),
                              device=dev)
    batch = {"tokens": prompts}
    spec = SessionSpec(topology=TopologySpec(8, 4), adaptivity="arbitrated",
                       tenant="moe-serve", device="cuda")
    sess = Session(spec)
    wired = build_model(cfg, dataclasses.replace(ctx8, session=sess))
    # warm-up, recording each layer's dispatch demand (the stacked send counts)
    with Recorder(NimbleAllToAll, "plan_from_counts", keep=cfg.n_layers) as rec:
        wired.forward(params, batch, last_only=True)
    torch.cuda.synchronize()

    def timed_prefill(m):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = m.forward(params, batch, last_only=True)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    reset_launch_counts()
    logits_w, wired_ms = timed_prefill(wired)
    counts = launch_counts()
    logits_u, unwired_ms = timed_prefill(model)
    logits_w2, wired_ms2 = timed_prefill(wired)
    exact = (torch.equal(logits_w, phase4_logits) and torch.equal(logits_w, logits_u)
             and torch.equal(logits_w2, logits_w))
    check(exact, "Session-wired prefill logits != phase 4's unwired logits (bit for bit)")
    for kname in MOE_KERNELS:
        check(counts[kname] > 0, f"{kname} never launched on the Session-wired prefill")
    check(len(sess.runtime.telemetry) == 0,
          "the Session-wired forward fed the runtime (it plans as the unwired one)")
    # the dispatch demand through the session's dispatcher, on the card
    comm_cfg = MoECommConfig(
        n_devices=8, n_experts=cfg.n_experts, d_model=cfg.d_model,
        chunk_tokens=ctx8.moe_chunk_tokens, capacity_factor=cfg.moe_capacity_factor,
        group_size=4, alt_frac=ctx8.moe_alt_frac, mode="nimble", payload_dtype=bf16)
    n_endpoints = len(sess._endpoints)
    disp = sess.moe_dispatcher(comm_cfg)
    check(len(sess._endpoints) == n_endpoints,
          "plan_batched: the session built a new dispatcher (not the model's)")
    demand = torch.stack([c[1] for c in rec.calls])                   # [B, n, n]
    n_assign = prompts.numel() // 8 * cfg.top_k
    est_calls = []
    est = sess.runtime.estimator
    est_update = est.update
    est.update = lambda D: (est_calls.append(1), est_update(D))[1]
    plan_card = disp.plan_batched(demand, n_assign)
    est.update = est_update
    B = demand.shape[0]
    with Session(dataclasses.replace(spec, device="cpu")) as cpu_sess:
        plan_cpu = cpu_sess.moe_dispatcher(comm_cfg).plan_batched(demand.cpu(), n_assign)
        same_cpu = torch.equal(plan_card.cpu(), plan_cpu) and (
            sess.runtime.telemetry.to_json_obj() == cpu_sess.runtime.telemetry.to_json_obj())
    own = torch.stack([c[0].plan_from_counts(demand[b]) for b, c in enumerate(rec.calls)])
    same_path = torch.equal(plan_card, own)
    records = (len(sess.runtime.telemetry), len(est_calls))
    check(plan_card.device.type == "cuda" and same_cpu,
          "plan_batched on the card != on the CPU (plan or telemetry)")
    check(same_path, "plan_batched != the plan the path's dispatch used")
    check(records == (B, B), f"plan_batched fed {records} telemetry/estimator records, "
          f"not {B} each")
    report = sess.report()
    sess.close()
    print(f"[16b session prefill] {cfg.name} bf16 ep=8 groups of 4 nimble, 4 x 512 tokens, "
          f"through an arbitrated Session (tenant 'moe-serve', device cuda): logits "
          f"{'= phase 4 bit for bit' if exact else '!= phase 4'}; prefill {wired_ms:.1f} / "
          f"{wired_ms2:.1f} ms wired vs {unwired_ms:.1f} ms unwired in this call (phase 4 "
          f"{phase4_ms:.1f} ms); launches {counts}; plan_batched of the prefill's "
          f"{B} dispatch demand(s) (n_assign {n_assign}, {int(demand.sum())} chunks) on the "
          f"card {'= CPU' if same_cpu else '!= CPU'}, {'=' if same_path else '!='} the "
          f"path's own plan, {int(plan_card[..., 1:].sum())} alt chunks; telemetry/"
          f"estimator records {records}; report {report['schema']} with "
          f"{len(report['metrics']['metrics'])} metrics", flush=True)
    del model, wired, params, logits_w, logits_u, logits_w2, rec
    torch.cuda.empty_cache()

    # ---- 16c. the endpoint example on the card ---------------------------------
    results, _ = _quiet(skewed_alltoallv.main, ["--device", "cuda"])
    exact = all(ok for r in results.values() for ok, _ in r.values())
    check(exact and len(results) == 3, "skewed_alltoallv on the card: not bit-exact")
    print("[16c example] skewed_alltoallv on the card through Session.all_to_all: "
          + "; ".join(f"hotspot {h}: " + ", ".join(
              f"{m} {'exact' if ok else 'WRONG'} ({t * 1e3:.3f} ms projected)"
              for m, (ok, t) in r.items()) for h, r in results.items()), flush=True)

    # ---- 16d. the API selfcheck on the card -------------------------------------
    rc, out = _quiet(selfcheck.main, ["--device", "cuda"])
    check(rc == 0, f"api selfcheck on the card: {out.strip().splitlines()[-1]}")
    print("[16d selfcheck] " + " | ".join(
        line.replace("[selfcheck] ", "") for line in out.strip().splitlines()), flush=True)
    print(f"[16 session] ({time.perf_counter() - t_phase:.0f} s for phase 16)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs.base import get_config
    from repro_torch.core import dataplane as dp_mod
    from repro_torch.core.dataplane import NimbleAllToAll, ref_all_to_allv
    from repro_torch.kernels import _build, launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.grouped_ffn import ops as ffn_ops
    from repro_torch.kernels.token_scatter.ops import token_gather, token_gather_ref
    from repro_torch.launch.kernel_times import time_ms
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding.context import ParallelContext

    check = Checks()
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 1. device and build ------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    built = _build.build()
    build_s = time.perf_counter() - t0
    name = torch.cuda.get_device_name(0)
    print(f"[1 device] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32} | kernels built in {build_s:.1f}s "
          f"({', '.join(f'{k} {v:.1f}s' for k, v in built.items())})", flush=True)
    print(smi, flush=True)

    cfg = get_config("paper-moe-8e")
    bf16 = torch.bfloat16
    ctx8 = ParallelContext(ep_size=8, group_size=4, moe_mode="nimble",
                           param_dtype=bf16, compute_dtype=bf16, device="cuda")
    model8 = build_model(cfg, ctx8)
    params = model8.init(args.seed)
    rng = np.random.default_rng(args.seed)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 512)), device=dev)
    batch = {"tokens": prompts}

    # capture pass: the main path's own inputs to each kernel (also a warm-up)
    with Recorder(dp_mod, "token_gather", keep=10) as rec_tg, \
            Recorder(ffn_ops, "token_gather", keep=2) as rec_sort, \
            Recorder(ffn_ops, "grouped_ffn_blocked", keep=1) as rec_ffn, \
            Recorder(fa_ops, "flash_attention", keep=1) as rec_fa:
        model8.forward(params, batch, last_only=True)
    torch.cuda.synchronize()

    # ---- 2. kernels against their plain versions -----------------------------
    report = {}

    def compare(kname, dt, out, ref, tol, why):
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        ok = check(np.isfinite(err) and err <= tol * max(scale, 1e-30),
                   f"{kname} {dt}: max|err| {err:.3g} > {tol:g} x max|ref| {scale:.3g}")
        print(f"  {kname} {dt}: max|err| {err:.4g} (limit {tol:g} x max|ref| "
              f"{scale:.4g}: {why}) {'ok' if ok else 'FAIL'}", flush=True)
        return err

    # token_gather: the dispatch's slot fill (zero rows), relay rounds (a
    # permutation) and reassembly, on the bf16 payload (calls 0-4) and on the
    # f32 expert-id sideband (calls 5-9); the FFN's sort/pad and unsort
    calls = rec_tg.calls
    for i, (x, idx, _) in enumerate(calls):
        out = token_gather(x, idx)
        compare("token_gather", f"{str(x.dtype)[6:]} call {i} {tuple(x.shape)}",
                out, token_gather_ref(x, idx), 0.0, "a copy is exact")
    for i, (x, idx, _) in enumerate(rec_sort.calls):
        compare("token_gather", f"FFN {('sort', 'unsort')[i]} {tuple(x.shape)}",
                token_gather(x, idx), token_gather_ref(x, idx), 0.0, "a copy is exact")
    tg = gather_report(torch, *calls[1][:2], token_gather, token_gather_ref)
    report["token_gather"] = tg                           # the first relay round
    gathers = {"sideband relay round": calls[6][:2], "FFN sort of 8 KiB rows":
               rec_sort.calls[0][:2]}
    for label, (x, idx) in gathers.items():
        tg[label] = gather_report(torch, x, idx, token_gather, token_gather_ref)

    # grouped_ffn_blocked: the prefill's sorted, padded expert rows, with the
    # per-block token counts the path passes (tiles of padding are skipped)
    x_pad, blk, wg, wu, wd, kw = rec_ffn.calls[0]
    bt, rows = kw["block_tokens"], kw["block_rows"]
    valid_rows = int(rows.sum())
    used = sorted(set(blk[rows > 0].tolist()))
    D, Fd = x_pad.shape[1], wg.shape[2]
    n_tiles = x_pad.shape[0] // 64
    tile_rows = rows.long().repeat_interleave(bt // 64) - (
        torch.arange(n_tiles, device=dev) % (bt // 64)) * 64
    live_tiles = int((tile_rows > 0).sum())
    n_pairs = int((ffn_ops._tile_pairs(blk, rows, bt, x_pad.shape[0]) >= 0).sum())

    def ffn_bound(dt_name, itemsize):
        flops = 6.0 * valid_rows * D * Fd
        nbytes = (2 * valid_rows * D + 3 * len(used) * D * Fd) * itemsize
        t_ops, t_bytes = flops / PEAK_FLOPS[dt_name], nbytes / PEAK_BYTES_S
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")

    def segments(live_only):
        """contiguous per-expert row ranges: every row, or token rows only"""
        segs = []
        for b, e in enumerate(blk.tolist()):
            lo, hi = b * bt, b * bt + (int(rows[b]) if live_only else bt)
            if hi == lo:
                continue
            if segs and segs[-1][0] == e and segs[-1][2] == lo:
                segs[-1][2] = hi
            else:
                segs.append([e, lo, hi])
        return segs

    def ffn_library(xx, g, u, d_, segs):
        out = torch.zeros_like(xx)
        for e, lo, hi in segs:
            xe = xx[lo:hi]
            out[lo:hi] = (F.silu(xe @ g[e]) * (xe @ u[e])) @ d_[e]
        return out

    def run_ffn(xx, g, u, d_):
        return ffn_ops.grouped_ffn_blocked(xx, blk, g, u, d_, block_tokens=bt, block_rows=rows)

    def plain_ffn(xx, g, u, d_):
        return ffn_ops.grouped_ffn_blocked_ref(xx, blk, g, u, d_, block_tokens=bt,
                                               block_rows=rows)

    y = run_ffn(x_pad, wg, wu, wd)
    ref = plain_ffn(x_pad, wg, wu, wd)
    err_bf16 = compare("grouped_ffn_blocked", "bf16", y, ref, 1e-2,
                       "H rounds to bf16 between the passes (2^-9 relative, summed over "
                       "16384 terms of both signs), f32 sums, y rounds to bf16")
    check(bool((y[(torch.arange(y.shape[0], device=dev) % bt)
                  >= rows.long().repeat_interleave(bt)] == 0).all()),
          "grouped_ffn_blocked: a padding row is not exactly 0")
    seg_tok, seg_all = segments(True), segments(False)
    gf = dict(
        ms=time_ms(lambda: run_ffn(x_pad, wg, wu, wd), 5),
        plain_ms=time_ms(lambda: plain_ffn(x_pad, wg, wu, wd), 3),
        library_ms=time_ms(lambda: ffn_library(x_pad, wg, wu, wd, seg_tok), 5),
        every_row_loop_ms=time_ms(lambda: ffn_library(x_pad, wg, wu, wd, seg_all), 3),
        max_abs_err=err_bf16,
        shape=f"x [{x_pad.shape[0]}, {D}] bf16 ({valid_rows} token rows), "
              f"E {wg.shape[0]}, F {Fd}, block_tokens {bt}",
    )
    gf["bound_ms"], gf["bound_by"] = ffn_bound("bf16", 2)
    w32 = [w.float() for w in (wg, wu, wd)]
    x32 = x_pad.float()
    y32 = run_ffn(x32, *w32)
    gf["f32_max_abs_err"] = compare(
        "grouped_ffn_blocked", "f32", y32, plain_ffn(x32, *w32), 1e-4,
        "f32 sums of 4096 and 16384 terms in another order")
    gf["f32_ms"] = time_ms(lambda: run_ffn(x32, *w32), 2)
    gf["f32_bound_ms"] = ffn_bound("f32", 4)[0]
    del w32, x32, y32
    report["grouped_ffn_blocked"] = gf
    print(f"[2 kernel] grouped_ffn_blocked tiles: {n_tiles} of 64 rows, {live_tiles} hold "
          f"a token and are computed in {n_pairs} pairs, {n_tiles - live_tiles} skipped; "
          f"matmul loop over token rows {gf['library_ms']:.4f} ms (the library column), "
          f"over every row {gf['every_row_loop_ms']:.4f} ms", flush=True)

    # flash_attention: layer 0's prefill q, k, v
    q, k, v, kw = rec_fa.calls[0]
    o = fa_ops.flash_attention(q, k, v, **kw)
    err_fa = compare("flash_attention", "bf16", o, fa_ops.mha_ref(q, k, v, **kw), 1e-2,
                     "bf16 inputs and output; online vs two-pass softmax; P enters P V as "
                     "bf16 plus its bf16 residual, about 16 bits")
    q32, k32, v32 = q.float(), k.float(), v.float()
    fa_f32_err = compare("flash_attention", "f32", fa_ops.flash_attention(q32, k32, v32, **kw),
                         fa_ops.mha_ref(q32, k32, v32, **kw), 1e-5,
                         "f32 online vs two-pass softmax sums")
    B, H, Sq, Dh = q.shape
    mask = fa_ops._mask(Sq, k.shape[2], kw["causal"], kw["window"], kw["q_offset"], dev)
    pairs = int(mask.sum()) * B * H
    t_ops = 4.0 * Dh * pairs / PEAK_FLOPS["bf16"]
    t_bytes = 2 * (q.numel() * 2 + k.numel() + v.numel()) / PEAK_BYTES_S
    # the fastest single PyTorch call for it: is_causal where the call is plain
    # causal (no window, no offset, Sq == Sk), else an explicit mask
    plain_causal = (kw["causal"] and kw["window"] is None and kw["q_offset"] == 0
                    and Sq == k.shape[2])
    sdpa_kw = dict(is_causal=True) if plain_causal else dict(attn_mask=mask)
    sdpa_kw["enable_gqa"] = True
    kk, vv = k, v
    try:
        F.scaled_dot_product_attention(q, kk, vv, **sdpa_kw)
    except TypeError:                      # a torch without enable_gqa
        sdpa_kw.pop("enable_gqa")
        kk = k.repeat_interleave(H // k.shape[1], 1)
        vv = v.repeat_interleave(H // k.shape[1], 1)
    report["flash_attention"] = dict(
        ms=time_ms(lambda: fa_ops.flash_attention(q, k, v, **kw), 20),
        plain_ms=time_ms(lambda: fa_ops.mha_ref(q, k, v, **kw), 10),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, kk, vv, **sdpa_kw), 20),
        max_abs_err=err_fa, f32_max_abs_err=fa_f32_err,
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        shape=f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 {kw}; library: SDPA "
              + ("is_causal" if plain_causal else "with a boolean mask"),
    )
    for label in gathers:
        print_gather(label, tg[label])
    print_gather("prefill relay round", tg)
    for kname, r in report.items():
        if kname == "token_gather":
            continue
        print(f"[2 kernel] {kname}: {r['shape']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    print(f"[2 kernel] grouped_ffn_blocked f32: kernel {gf['f32_ms']:.3f} ms, bound "
          f"{gf['f32_bound_ms']:.3f} ms at 67 TFLOP/s", flush=True)

    # ---- 3. dataplane on the card --------------------------------------------
    n, C, E = 8, 16, 32
    drng = np.random.default_rng(0)
    xd = drng.normal(size=(n, n, C, E)).astype(np.float32)
    counts = drng.integers(0, C + 1, size=(n, n)).astype(np.int32)
    for s in range(n):
        for d in range(n):
            xd[s, d, counts[s, d]:] = 0.0
    yref, rref = ref_all_to_allv(xd, counts)
    parts = []
    for mode in ("direct", "stripe", "nimble"):
        for cb in (float(E * 4), float(4 << 20)):
            comm = NimbleAllToAll(n, 4, max_chunks=C, chunk_bytes=cb, mode=mode)
            yy, rr = comm(torch.as_tensor(xd, device=dev),
                          torch.as_tensor(counts, device=dev))
            exact = np.array_equal(yy.cpu().numpy(), yref) and np.array_equal(
                rr.cpu().numpy(), rref)
            check(exact, f"dataplane {mode} chunk_bytes {cb:g} not bit-exact")
            plan_card = comm.plan_from_counts(torch.as_tensor(counts, device=dev))
            plan_cpu = comm.plan_from_counts(torch.as_tensor(counts))
            same = torch.equal(plan_card.cpu(), plan_cpu)
            check(same, f"dataplane {mode} chunk_bytes {cb:g}: card plan != CPU plan")
            parts.append(f"{mode}/{cb:g}B: {'exact' if exact else 'WRONG'}, plan "
                         f"{'= CPU' if same else '!= CPU'}, "
                         f"{int(plan_card[..., 1:].sum())} alt chunks")
    print(f"[3 dataplane] n={n} C={C} E={E}: " + "; ".join(parts), flush=True)

    # ---- 4. prefill ----------------------------------------------------------
    reset_launch_counts()
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits8, _ = model8.forward(params, batch, last_only=True, stats=stats)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts_prefill = launch_counts()
    phase4_logits = logits8                  # held for phase 16's Session-wired prefill
    check(tuple(logits8.shape) == (4, 1, cfg.vocab), f"prefill logits {logits8.shape}")
    check(bool(torch.isfinite(logits8).all()), "prefill logits not finite")
    # parity with the single-device path needs a dispatch that drops nothing:
    # capacity factor 8 holds every assignment (the config's 2.0 may drop)
    model1 = build_model(cfg, dataclasses.replace(ctx8, ep_size=1))
    logits1, _ = model1.forward(params, batch, last_only=True)
    nodrop = build_model(dataclasses.replace(cfg, moe_capacity_factor=8.0), ctx8)
    nd_stats = {}
    logits8nd, _ = nodrop.forward(params, batch, last_only=True, stats=nd_stats)
    check(int(nd_stats["dropped"]) == 0, "capacity factor 8 dropped tokens")
    diff = (logits8nd.float() - logits1.float()).abs().max().item()
    lscale = logits1.float().abs().max().item()
    check(diff <= 1e-2 * lscale, f"EP=8 vs EP=1 logits differ by {diff:.3g}")
    n_tok = prompts.numel()
    # small input, whole path: the card's kernels against the CPU's plain versions
    small = dataclasses.replace(cfg.reduced(), n_experts=8)
    ctx_s = ParallelContext(ep_size=8, group_size=4, device="cpu")
    ms_cpu = build_model(small, ctx_s)
    p_cpu = ms_cpu.init(args.seed)
    p_gpu = _to(p_cpu, dev)
    ms_gpu = build_model(small, dataclasses.replace(ctx_s, device="cuda"))
    toks_s = torch.as_tensor(rng.integers(0, small.vocab, (2, 128)))
    ls_cpu, _ = ms_cpu.forward(p_cpu, {"tokens": toks_s})
    ls_gpu, _ = ms_gpu.forward(p_gpu, {"tokens": toks_s.to(dev)})
    small_err = (ls_gpu.cpu() - ls_cpu).abs().max().item()
    check(small_err <= 1e-3, f"reduced model card vs CPU: {small_err:.3g}")
    print(f"[4 prefill] {cfg.name} bf16 ep=8 groups of 4 nimble, 4 x 512 tokens: "
          f"{prefill_s * 1e3:.1f} ms, {n_tok / prefill_s:.0f} tokens/s, dropped "
          f"{int(stats['dropped'])} of {2 * n_tok} assignments, logits "
          f"{tuple(logits8.shape)} finite; with capacity factor 8: max|EP8 - EP1| "
          f"{diff:.4g} (limit 1e-2 x {lscale:.3g}: bf16 logits, same kernel rows "
          f"on both paths); reduced model f32 card vs CPU plain "
          f"{small_err:.3g} (limit 1e-3: f32 sums in other orders)", flush=True)

    # ---- 5. generation -------------------------------------------------------
    reset_launch_counts()
    engine = ServeEngine(model8, params, max_len=16)
    gprompts = rng.integers(0, cfg.vocab, (4, 8))
    gstats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = engine.generate(gprompts, n_new=8, stats=gstats)
    gen_s = time.perf_counter() - t0
    counts_gen = launch_counts()
    ids1 = ServeEngine(model1, params, max_len=16).generate(gprompts, n_new=8)
    check(ids.shape == (4, 8) and ((ids >= 0) & (ids < cfg.vocab)).all(),
          f"generated ids {ids.shape}")
    check(np.array_equal(ids, ids1), "EP=8 and EP=1 greedy ids differ")
    # a decode step's first relay round (its dispatch's second gather),
    # recorded in an untimed call after the timed one and its counts
    with Recorder(dp_mod, "token_gather", keep=2) as rec_dec:
        engine.generate(gprompts, n_new=1)
    x, idx = rec_dec.calls[1][:2]
    compare("token_gather", f"decode relay round {tuple(x.shape)}", token_gather(x, idx),
            token_gather_ref(x, idx), 0.0, "a copy is exact")
    tg["decode relay round"] = gather_report(torch, x, idx, token_gather, token_gather_ref)
    print_gather("decode relay round (captured in phase 5)", tg["decode relay round"])
    print(f"[5 generate] 4 requests, prompt 8, 8 new tokens, greedy: {gen_s:.2f} s, "
          f"{ids.size / gen_s:.1f} new tokens/s ({4 * 16 / gen_s:.1f} incl. the "
          f"prompt steps), dropped {int(gstats['dropped'])}, EP1 ids "
          f"{'equal' if np.array_equal(ids, ids1) else 'DIFFER'}; ids "
          f"{ids.tolist()}", flush=True)

    # ---- 6. kernels on the paper-moe-8e path ---------------------------------
    launches = {k: counts_prefill[k] + counts_gen[k] for k in MOE_KERNELS}
    for kname, c in launches.items():
        check(c > 0, f"{kname} never launched on the paper-moe-8e path")
    print(f"[6 kernels] launches prefill {counts_prefill}, generate {counts_gen} "
          f"({time.perf_counter() - t_start:.0f} s so far)", flush=True)
    del model8, model1, nodrop, engine, params, logits8, logits1, logits8nd, rec_tg, rec_sort
    del rec_ffn, rec_fa, rec_dec, calls, x_pad, blk, wg, wu, wd, q, k, v, kk, vv, x, idx
    torch.cuda.empty_cache()

    # ---- 7-9. paper-moe-8e training ---------------------------------------------
    report["token_scatter_add"], counts_train = train_phases(torch, np, check, args.seed,
                                                             dev, smi)
    train_kernels = ("token_gather", "token_scatter_add", "token_scatter_index",
                     "grouped_ffn_blocked", "flash_attention")
    for kname in MOE_KERNELS:
        launches[kname] += counts_train[kname]
    launches["token_scatter_add"] = counts_train["token_scatter_add"]
    print(f"[9 kernel] ({time.perf_counter() - t_start:.0f} s so far)", flush=True)

    # ---- 10-12. xlstm-125m -----------------------------------------------------
    report["mlstm_scan"], launches["mlstm_scan"] = xlstm_phases(
        torch, np, check, compare, args.seed, dev)
    print(f"[12 generate] ({time.perf_counter() - t_start:.0f} s so far)", flush=True)

    # ---- 13. relay_copy -------------------------------------------------------
    report["relay_copy"], relay_routes = relay_phase(torch, check, args.seed, dev)
    launches["relay_copy"] = relay_routes["relay_copy"]

    # ---- 14. kernels on their paths ---------------------------------------------
    for kname in train_kernels:
        check(counts_train[kname] > 0, f"{kname} never launched on the training path")
    check(launches["mlstm_scan"] > 0, "mlstm_scan never launched on the xlstm-125m path")
    for route, c in relay_routes.items():
        check(c > 0, f"{route} never launched by relay_copy's entry point")
    print(f"[14 kernels] launches: paper-moe-8e serving (phases 4-5) "
          f"{ {k: counts_prefill[k] + counts_gen[k] for k in MOE_KERNELS} }; paper-moe-8e "
          f"training (phase 7's 3 timed steps) { {k: counts_train[k] for k in train_kernels} }; "
          f"xlstm-125m path (phases 11-12) mlstm_scan {launches['mlstm_scan']}; relay_copy's "
          f"own entry point (phase 13; no path calls it) by route {relay_routes} "
          f"({time.perf_counter() - t_start:.0f} s in all)", flush=True)

    # ---- 15. execution-time planning runtime -------------------------------------
    runtime_phase(torch, np, check, smi)
    print(f"[15 runtime] ({time.perf_counter() - t_start:.0f} s in all)", flush=True)

    # ---- 16. endpoint API and shared-fabric arbiter -------------------------------
    session_phase(torch, np, check, smi, args.seed, dev, phase4_logits, prefill_s * 1e3)
    print(f"[16 session] ({time.perf_counter() - t_start:.0f} s in all)", flush=True)

    kernels = []
    for kname, (src, replaces) in KERNEL_META.items():
        r = report[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    if check.failed:
        print(f"chip_smoke: {len(check.failed)} check(s) failed: {check.failed}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
