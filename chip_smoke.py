#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one card, and check them.

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
     times both; under a gradient, checks that the kernel runs the forward
     and the gradients equal the CPU's plain version's within 1e-4;
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
     the API selfcheck's checks on the card.
 17. drives NIMBLE's fault harness, serve control plane and flight recorder
     on the card, each sub-phase against a CPU run of the same port code:
     (a) the four fault drills of ``launch/drills.py`` (flap, blackout,
     tenant crash, perturb): every figure and every ``DrillResult`` card =
     CPU, each schedule's digest equal to ``BENCH_faults.json``'s, the figures
     equal to the reference code's; (b) all six built-in serve scenarios,
     both arms, through ``evaluate_scenario``: every ``ServeReport`` and SLO
     verdict card = CPU, the two fault digests equal to ``BENCH_serve.json``'s,
     and the churn section; (c) ``flap_under_load`` and the obs section
     flight-recorded: a valid trace with spans from the serve, runtime, fabric
     and planner layers under one correlation id, the trace, provenance log
     and metrics snapshot card = CPU event for event, a complete provenance
     record for every swap, recorded reports equal to unrecorded ones (70
     trace events, 8 plans, 7 swaps); (d) the API selfcheck's checks 1-8 on
     the card.  Prints each sub-phase's card solves (count, median ms) and
     incidence-table uploads to the card, and the phase's wall time.
 18. trains xlstm-125m at full width (bf16, 4 x 2048 tokens from
     ``SyntheticLM``, AdamW, a warm-up step and 3 timed steps): step time,
     tokens/s, the forward's, backward's and optimizer's shares, the peak
     memory, ``mlstm_scan``'s launches under grad (6 mLSTM layers x 4 steps,
     checked) and its backward's time a step beside its bound, and the
     step's backward with and without the sLSTM prefix Functions; holds
     ``mlstm_cummax_bwd`` (the chunk body's cummax VJP, two launches a layer
     a step, checked) on the warm-up step's first call against its plain
     version, exactly, and times it; gates finite losses and norms, and a
     reduced xlstm's f32 loss (1e-5) and gradients (1e-4) on the card,
     through the kernels, against the CPU's;
 19. the dense family: trains smollm-135m at full width (bf16, 4 x 2048, as
     phase 18; flash at head dim 64, 30 layers x 4 steps, checked), holds
     the flash forward at smollm's shape (9 heads over 3) against
     ``mha_ref`` and times it beside SDPA and its bound; serves llama3-8b at
     full width (bf16, 8.03 B parameters): a 4 x 512 prefill with
     ``last_only`` (flash at head dim 128, one launch a layer, checked) and
     ``ServeEngine.generate`` of 4 requests, 8 + 8 tokens, the engine's step
     prefill against the forward; gates reduced smollm-135m and qwen2.5-14b
     (its QKV biases nonzero) in f32, logits and gradients card vs CPU;
 20. saves phase 18's parameters and optimizer state with ``ckpt``, restores
     them on the card and takes one more step from each: params, moments,
     step and loss must be equal bit for bit; holds the index's keys, meta
     and structure and the ``.npz`` keys against the reference's
     ``_flatten`` and ``_structure`` (ported here, numpy only); runs
     ``launch/selftest.main(["--device", "cuda"])``;
 21. serves qwen3-moe-235b-a22b cut to 1 layer (bf16, 3.73 B parameters,
     EP 8, prefill 4 x 512 and 4 requests of 8 + 8 tokens) and trains
     granite-moe-1b-a400m (bf16, 4 x 512, a warm-up and 3 timed steps);
     holds the FFN at E 128 / F 1536 and E 32 / F 512, flash at GQA 16:1,
     and the first ``token_gather`` call of every shape on both paths and
     the first ``token_scatter_add`` call of every shape in granite's
     backward against their plain versions; launches checked; gates a
     reduced qwen3 (E 16, top-8, head dim 128) card vs CPU;
 22. serves and trains zamba2-1.2b (bf16, 4 x 2048, remat as
     ``launch/train.py::needs_remat`` says), flash at [4, 32, 2048, 64]
     against its plain version, the SSD scan's time a layer; gates a
     reduced zamba2 card vs CPU and decode against forward on the card;
 23. serves whisper-small (1500 stub frames, 4 x 448 tokens) and
     internvl2-2b (256 patches + 512 tokens), flash non-causal, Sq != Sk
     and GQA 2:1 against its plain version, launches checked; gates the
     reduced configs card vs CPU and runs ``serve_multiarch --adaptive``;
 24. the reference's non-TPU paths in plain torch: (a) ``chunked_attention``
     on the card against the CPU (keys padded to whole chunks, a window,
     GQA 4:1, a ``q_offset``; f32 within 1e-5, bf16 1e-2), and
     ``attention()`` below 128 queries over 4500 keys taking it; (b) the
     flash kernel's backward, ``chunked_attention``'s VJP, at [4, 9, 2048,
     64] and [4, 9, 4096, 64] over 3 heads (one and two chunks) and at
     [4, 32, 512, 128] over 8 (one chunk of 512) against the CPU's and
     ``mha_ref``'s VJP (f32, 1e-4), and both formulations' ms a call; (c)
     smollm-135m trains 2 steps at 4 x 4096 (bf16): step ms, tokens/s, the
     attention backward's ms a step, peak memory, finite losses and norms,
     and its first flash call against ``mha_ref``; (d) ``grouped_ffn_scan``
     and ``grouped_ffn_dense`` on the card against the CPU: the same rows
     dropped, values within 1e-5; (e) ``examples/quickstart`` on the card
     prints the CPU's figures, and its granite logits equal the CPU's on
     the same weights within 1e-4.
     CPU runs held against the card's MoE path pin ``NIMBLE_FFN_IMPL=scan``
     (``scan_ffn``): above 2 E x 64 rows the CPU's FFN otherwise takes the
     capacity-dropping dense branch.
 25. the executor across processes (``torch.distributed``), in an NCCL world
     of ``torch.cuda.device_count()`` processes (this one when that is 1):
     (a) the dataplane at phase 3's shapes (both chunk sizes) and at
     paper-moe-8e's dispatch shapes (8 ranks in groups of 4, 8 chunks of 16
     tokens x 4096 bf16), in the three modes, through a model group: output,
     counts and plan bit for bit against the stacked executor and the numpy
     oracle, the messages sent a hop and ``token_gather``'s launches against
     the stacked path's; (b) paper-moe-8e at full width (bf16, EP 8 in groups
     of 4) through a ``ParallelContext`` with a ``(data, model)`` mesh: the
     prefill logits must equal phase 4's and the warm-up and 3 timed train
     steps' losses and gradient norms phase 7's, bit for bit (at one process
     every collective is an identity), and the step ms beside phase 7's;
     the path's kernels must launch; (c) ``selftest --procs <device_count>``
     (spawned processes, NCCL).  With one card no hop crosses a process:
     ``tests/test_torch_dist.py`` holds the exchange between processes on the
     CPU (gloo).
 26. the roofline and the dry run: (a) ``launch/dryrun.py`` on this
     machine's host (fake tensors in a fake world of 256 processes) for
     smollm-135m x train_4k, granite-moe-1b-a400m x train_4k and llama3-8b x
     decode_32k on 16 x 16: each record's line, ``status`` ok, and
     ``n_params`` and ``model_flops_total`` equal to ``DRYRUN_PINNED`` (the
     values the CPU tests hold against the reference's), and smollm-135m x
     train_4k on 2 x 16 x 16 (512 processes, 256 sequences: the rows over
     pod x data, replicated over model), ``status`` ok; (b) the counter
     (``roofline/hlo_cost.py``) around one real step on the card of phase
     7's paper-moe-8e (4 x 512, EP 8 stacked) and phase 19's smollm-135m
     (4 x 2048): FLOPs by dtype, bytes, the roofline's compute and memory
     terms at the card's rates, the step's op-by-op bound (the larger; it
     counts this code's own ops, so it moves with the code) and the least
     that does not move with the code (6 N D at the bf16 peak, a fused
     AdamW's traffic at HBM rate), each as a share of the mean of 3 steps
     timed here outside the counter; the counter's
     live-bytes peak within 10% of ``torch.cuda.max_memory_allocated()`` less
     the bytes held before the step; (c) no launch left unreported
     (``uncounted`` 0) and each kernel's reported launches equal to its
     ``LAUNCHES`` delta over (b).
 27. the port's static checker and the card's own sync report: (a)
     ``repro_torch.analysis`` over this checkout's ``src/repro_torch``: no
     live finding with the shipped baseline, both locks fresh; prints the
     findings baselined by rule and the ``host-sync`` inventory's sites by
     class; (b) ``launch/sync_audit.py``: one paper-moe-8e train step at
     phase 7's width (4 x 512, EP 8, bf16) after a warm-up step, then one
     decode step of ``make_serve_step``, under
     ``torch.cuda.set_sync_debug_mode("warn")`` with the GPU trace's sync
     callbacks: each sync's innermost frame under ``src/repro_torch/``, as
     its trace callback and its warning each see it, must be a
     ``host-sync`` site of the inventory, (file, function), and the sync
     warnings must match the traced syncs site for site; prints the syncs a
     step and the distinct sites.

It prints one line per phase, the card's name and power limit as
``nvidia-smi`` reports them, a JSON line of per-kernel numbers, and as its
last line ``{"ok": true, "device": {...}}``.  It exits non-zero, without
that line, when there is no CUDA device, when run outside a checkout, or
when any check fails.  Weights are random, made from ``--seed``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

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
    "mlstm_cummax_bwd": ("src/repro_torch/csrc/mlstm_scan.cu",
                         "none: no Pallas kernel; the port's own kernel for the VJP of "
                         "lax.cummax (taken through lax.associative_scan) at "
                         "src/repro/models/xlstm.py:145"),
}
MOE_KERNELS = ("token_gather", "grouped_ffn_blocked", "flash_attention")
#: phase 26a's combos on 16 x 16 and the record values the CPU tests hold
#: against the reference's dry run (``tests/test_torch_dryrun.py``)
DRYRUN_PINNED = {
    ("smollm-135m", "train_4k"): dict(n_params=162826560,
                                      model_flops_total=1024416137871360.0),
    ("granite-moe-1b-a400m", "train_4k"): dict(n_params=1384963072,
                                               model_flops_total=3013565950722048.0),
    ("llama3-8b", "decode_32k"): dict(n_params=8030261248,
                                      model_flops_total=2055746879488.0),
}


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


@contextlib.contextmanager
def scan_ffn():
    """``NIMBLE_FFN_IMPL=scan`` while installed.  Above 2 E x 64 rows the CPU's
    grouped FFN takes, by default, the reference's ``grouped_ffn_dense``,
    which drops rows by capacity where the card's kernel drops none; a CPU
    run held against the card pins the drop-free scan, as the reference's
    tests do."""
    import os

    old = os.environ.get("NIMBLE_FFN_IMPL")
    os.environ["NIMBLE_FFN_IMPL"] = "scan"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("NIMBLE_FFN_IMPL")
        else:
            os.environ["NIMBLE_FFN_IMPL"] = old


class Recorder:
    """Records the arguments (cloned) of a module-level function while
    installed: its first ``keep`` calls in ``calls``, or, given ``key`` (a
    function of the arguments), the first call of each key in ``first`` and
    the calls of each key in ``counts``."""

    def __init__(self, module, name, keep: int = 8, key=None):
        self.module, self.name, self.keep, self.key = module, name, keep, key
        self.calls, self.first, self.counts = [], {}, {}
        self.orig = getattr(module, name)

    def __enter__(self):
        def kept(args, kw):
            return tuple(a.clone() if hasattr(a, "clone") else a for a in args) + (dict(kw),)

        def rec(*args, **kw):
            if self.key is not None:
                k = self.key(*args, **kw)
                self.counts[k] = self.counts.get(k, 0) + 1
                if k not in self.first:
                    self.first[k] = kept(args, kw)
            elif len(self.calls) < self.keep:
                self.calls.append(kept(args, kw))
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
    from repro_torch.kernels.token_scatter.ops import gather_bytes
    from repro_torch.launch.kernel_times import device_ms, time_ms
    from repro_torch.roofline.analysis import kernel_bound

    safe = idx.clamp_min(0)
    valid = int((idx >= 0).sum())
    row = x.shape[1] * x.element_size()
    bound_s, bound_by = kernel_bound(
        0.0, gather_bytes(valid, idx.numel(), row, idx.element_size()), "bf16")
    return dict(
        ms=time_ms(lambda: token_gather(x, idx), 20),
        plain_ms=time_ms(lambda: token_gather_ref(x, idx), 20),
        library_ms=time_ms(lambda: torch.index_select(x, 0, safe), 20),
        device_ms=device_ms(lambda: token_gather(x, idx), 20),
        library_device_ms=device_ms(lambda: torch.index_select(x, 0, safe), 20),
        bound_ms=bound_s * 1e3, bound_by=bound_by,
        max_abs_err=_max_err(token_gather(x, idx), token_gather_ref(x, idx)),
        shape=f"x {tuple(x.shape)} {str(x.dtype)[6:]}, idx [{idx.numel()}] "
              f"({valid} read)")


def print_gather(label, r) -> None:
    print(f"[2 kernel] token_gather {label}: {r['shape']}: kernel {r['ms']:.4f} ms "
          f"({r['device_ms']:.4f} on the device, {r['device_ms'] / r['bound_ms']:.2f}x its "
          f"bound), plain {r['plain_ms']:.4f} ms, index_select {r['library_ms']:.4f} ms "
          f"({r['library_device_ms']:.4f} on the device), bound {r['bound_ms']:.4f} ms "
          f"(bytes)", flush=True)


def check_scatter(torch, check, ts_ops, g, idx, n, label: str) -> str:
    """token_scatter_add on one captured call against its plain version, its
    inverse-index launch against the plain stable sort and search, and a
    second run's bits -> a summary.  Rows of at most two sources round once,
    so they equal the plain version (the CPU's, summed in order) bit for bit;
    more sources sum in another order: within one bf16 rounding of the
    largest value."""
    out = ts_ops.token_scatter_add(g, idx, n)
    again = ts_ops.token_scatter_add(g, idx, n)
    ref = ts_ops.token_scatter_add_ref(g.cpu(), idx.cpu(), n)
    inv, inv_ref = ts_ops.build_inverse_index(idx, n), ts_ops.inverse_index(idx, n)
    check(all(torch.equal(a, b) for a, b in zip(inv, inv_ref)),
          f"token_scatter_add {label}: the inverse index differs from the plain one")
    key = torch.where(idx < 0, n, idx.clamp_max(n - 1))
    mult = int(torch.bincount(key, minlength=n + 1)[:n].max())
    err = _max_err(out.cpu(), ref)
    ok = err == 0.0 if mult <= 2 else err <= 2.0 ** -8 * ref.float().abs().max().item()
    same = torch.equal(out, again)
    check(ok, f"token_scatter_add {label} g {tuple(g.shape)}: max|err| {err:.3g} "
          f"with at most {mult} sources a row")
    check(same, f"token_scatter_add {label}: a second run gave other bits")
    return (f"{tuple(g.shape)} -> {n} rows, <= {mult} sources, max|err| {err:g}, "
            f"{'same bits' if same else 'DIFFER'}, index of "
            f"{-(-(n + 1) // ts_ops.INDEX_KEYS)} block(s) "
            f"{'= plain' if torch.equal(inv[0], inv_ref[0]) else '!= plain'}")


def scatter_report(torch, ts_ops, g, idx, n) -> dict:
    """token_scatter_add on one captured call: times, bound and error.  The
    bound counts the rows read (index >= 0) and written and the indices at
    3.35 TB/s; ``index_add_`` over the valid rows is the yardstick."""
    from repro_torch.launch.kernel_times import device_ms, time_ms
    from repro_torch.roofline.analysis import kernel_bound

    valid = idx >= 0
    safe, src = idx.clamp(0, n - 1)[valid], g[valid]
    acc = torch.zeros((n, g.shape[1]), dtype=g.dtype, device=g.device)
    bound_s, bound_by = kernel_bound(0.0, ts_ops.scatter_add_bytes(
        int(valid.sum()), n, g.shape[1] * g.element_size(), idx.numel(),
        idx.element_size()), "bf16")
    return dict(
        ms=time_ms(lambda: ts_ops.token_scatter_add(g, idx, n), 20),
        device_ms=device_ms(lambda: ts_ops.token_scatter_add(g, idx, n), 20),
        index_device_ms=device_ms(lambda: ts_ops.build_inverse_index(idx, n), 20),
        plain_index_device_ms=device_ms(lambda: ts_ops.inverse_index(idx, n), 20),
        plain_ms=time_ms(lambda: ts_ops.token_scatter_add_ref(g, idx, n), 10),
        library_ms=time_ms(lambda: acc.index_add_(0, safe, src), 20),
        library_device_ms=device_ms(lambda: acc.index_add_(0, safe, src), 20),
        bound_ms=bound_s * 1e3, bound_by=bound_by,
        max_abs_err=_max_err(ts_ops.token_scatter_add(g, idx, n),
                             ts_ops.token_scatter_add_ref(g, idx, n)),
        shape=f"g {tuple(g.shape)} {str(g.dtype)[6:]} -> {n} rows "
              f"({int(valid.sum())} read)")


def xlstm_phases(torch, np, check, compare, seed: int, dev):
    """Phases 10-12 on xlstm-125m -> (mlstm_scan's report, its launches)."""
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.mlstm_scan import ops as ms_ops
    from repro_torch.kernels.mlstm_scan.ops import mlstm_scan, mlstm_scan_chunked_ref
    from repro_torch.launch.kernel_times import time_ms
    from repro_torch.models import xlstm as xlstm_mod
    from repro_torch.models.registry import build_model
    from repro_torch.roofline.analysis import kernel_bound
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
    flops, nbytes = ms_ops.mlstm_cost(B, H, S, dh, chunk)
    bound_s, bound_by = kernel_bound(flops, nbytes, "f32")
    ms_report = dict(
        ms=time_ms(lambda: mlstm_scan(q, k, v, ig, lf, chunk=chunk), 10),
        plain_ms=time_ms(lambda: mlstm_scan_chunked_ref(q, k, v, ig, lf,
                                                                 chunk=chunk), 3),
        library_ms=None, max_abs_err=err, bound_ms=bound_s * 1e3, bound_by=bound_by,
    )
    # under a gradient: the kernel's forward and MLSTMScanFunction's backward
    # against autograd through the plain version on the CPU, on the first
    # 2 chunks of these inputs (f32 sums in other orders: 1e-4)
    sub = [t[:, :, :2 * L].contiguous() for t in (q, k, v, ig, lf)]
    g_out = torch.randn(sub[0].shape, generator=torch.Generator().manual_seed(seed))
    grads, launched = [], 0
    for where in (dev, torch.device("cpu")):
        live = [t.to(where).requires_grad_(True) for t in sub]
        before = launch_counts()["mlstm_scan"]
        hh, _ = mlstm_scan(*live, chunk=chunk)
        grads.append([g.cpu() for g in torch.autograd.grad(hh, live, g_out.to(where))])
        launched += launch_counts()["mlstm_scan"] - before
    grad_err = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(*grads))
    check(launched == 1 and grad_err <= 1e-4,
          f"mlstm_scan under grad: {launched} launches, gradients {grad_err:.3g} from the CPU's")
    print(f"[10 kernel] mlstm_scan: q/k/v {tuple(q.shape)} f32, chunk {L}: kernel "
          f"{ms_report['ms']:.4f} ms, plain {ms_report['plain_ms']:.4f} ms, library none, "
          f"bound {ms_report['bound_ms']:.4f} ms ({ms_report['bound_by']}: "
          f"{flops / 1e9:.3f} GFLOP at 67 TFLOP/s, {nbytes / 1e6:.1f} MB at 3.35 TB/s); "
          f"under a gradient (the first {2 * L} steps) the kernel launched {launched} time(s) "
          f"and the gradients are within {grad_err:.3g} of the CPU's (limit 1e-4)", flush=True)

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
    base_gb = torch.cuda.memory_allocated() / 1e9
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
          f"step; peak memory {peak_gb:.2f} GB ({base_gb:.2f} held before the steps); on "
          f"{smi}", flush=True)
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
    with scan_ffn():
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
          f"reduced config f32 one step, card vs CPU plain (the CPU's FFN pinned to the "
          f"reference's scan, NIMBLE_FFN_IMPL=scan): loss |diff| {small_loss:.3g} "
          f"(limit 1e-5 x |loss|), gradients worst leaf {small_worst:.3g} (limit 1e-4: f32 "
          f"sums in other orders)", flush=True)

    # ---- 9. token_scatter_add against its plain version -------------------------
    parts = [f"{i}: " + check_scatter(torch, check, ts_ops, g, idx, n, f"call {i}")
             for i, (g, idx, n, _) in enumerate(rec_sa.calls)]
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

    # the dispatch pack's backward (token rows, read up to top_k times) and
    # one relay round's (a permutation of 128 KiB chunk rows)
    pack = next(c for c in rec_sa.calls if c[0].shape[1] == cfg.d_model
                and c[1].numel() > c[2])
    relay = next(c for c in rec_sa.calls if c[0].shape[1] == cfg.d_model * 16
                 and c[1].numel() == c[2] and bool((c[1] >= 0).all()))
    report = scatter_report(torch, ts_ops, *pack[:3])
    report["relay round backward"] = scatter_report(torch, ts_ops, *relay[:3])
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
    return report, counts_train, dict(losses=losses, norms=norms, step_ms=step_ms,
                                      share=share, peak_gb=peak_gb, base_gb=base_gb)


def relay_phase(torch, check, seed: int, dev):
    """Phase 13 -> (relay_copy's report, its launches through its entry point,
    by route)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.relay_copy.ops import (
        parity_slot_map,
        relay_bytes,
        relay_copy,
        relay_copy_ref,
    )
    from repro_torch.launch.kernel_times import device_ms, time_ms
    from repro_torch.roofline.analysis import kernel_bound

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
    bound_s, bound_by = kernel_bound(0.0, relay_bytes(x.numel(), x.element_size(),
                                                      smap.numel()), "bf16")
    report = dict(
        ms=time_ms(lambda: relay_copy(x, smap, block_chunk=bc), 20),
        device_ms=device_ms(lambda: relay_copy(x, smap, block_chunk=bc), 20),
        plain_ms=time_ms(lambda: relay_copy_ref(x, smap, block_chunk=bc), 20),
        library_ms=time_ms(lambda: out.copy_(x), 20),
        library_device_ms=device_ms(lambda: out.copy_(x), 20),
        max_abs_err=_max_err(relay_copy(x, smap, block_chunk=bc), x),
        bound_ms=bound_s * 1e3, bound_by=bound_by,
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


#: the fault schedules' digests as ``BENCH_faults.json`` and ``BENCH_serve.json``
#: hold them (the reference's seeds; the floats of those files predate its code)
FAULT_DIGESTS = {
    "flap": "dc8ddaa2bee31628deed4bced91120a7013fd2a133bf135e8017efd398caf86a",
    "blackout": "61caea2cf98311dd38330f413ae19c6af9e22edba9b49e7db15963e34a3423eb",
    "tenant_crash": "7eec5ea3646b3689ac5bd0272a977255b10ca1f28e38e3af42a0b5e746e4b48d",
    "perturb": "221c6c3d2365eb9f0d39f4e2e23f3fb8ab2493b502458fb8e8c4d4b192e2e93d",
    "elephant_victim": "3cda2f17a57e2727a90f0466d36a97eba23591165820e183897ecda986fd7c95",
    "flap_under_load": "a7329c1364ba6572ee49552aa6e420a292700fa9f9c981ae1aa128b0d611f4ad",
}
#: the reference code's figures (its benches, rerun with JAX on a CPU)
DRILL_FIGURES = {
    ("flap", "topology_replans_backoff"): 4, ("flap", "topology_replans_storm"): 8,
    ("flap", "suppressed_windows"): 4, ("flap", "recovered_window"): 15,
    ("flap", "availability"): 0.8571428571428571,
    ("flap", "prefault_completion_s"): 0.003810177137937085,
    ("blackout", "adaptive_static_ratio"): 0.7089201621067166,
    ("blackout", "adaptive_completion_s"): 0.2953325649876276,
    ("blackout", "missing_windows"): 8,
    ("tenant_crash", "survivor_solo_ratio"): 1.0, ("tenant_crash", "evictions"): 1,
    ("tenant_crash", "survivors"): ["A"],
    ("perturb", "straggler_ratio"): 3.524722348348898,
    ("perturb", "total_completion_s"): 0.14198466913342306,
    ("perturb", "telemetry_rejected"): 0,
    ("steady", "win"): 1.0087846045090592,
    ("elephant_victim", "win"): 1.3643284145043393,
    ("elephant_victim", "jain"): 0.9777513524608447,
    ("flap_under_load", "win"): 2.750643360569997,
    ("churn", "tail_ratio"): 0.9991283258421211,
    ("churn", "total_ratio"): 0.9556493285421601,
}


@contextlib.contextmanager
def table_uploads(torch):
    """Time each upload of a topology's incidence tables to the card while
    active (a ``device_tables`` cache miss, synchronized); yields the list of
    ms.  CPU tables and cache hits pass through."""
    from repro_torch.core import planner
    from repro_torch.runtime import controller

    tables, out = controller.device_tables, []

    def upload(tbl, device):
        dev = torch.device(device)
        if dev.type != "cuda" or (id(tbl), str(dev)) in planner._DEVICE_CACHE:
            return tables(tbl, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = tables(tbl, device)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
        return res

    controller.device_tables = upload
    try:
        yield out
    finally:
        controller.device_tables = tables


def card_work(solves, uploads, mark=(0, 0)) -> str:
    """The card solves (``fairness.timed_solves``'s list) and table uploads
    since ``mark`` = (solves, uploads) counted before."""
    import statistics

    s = [ms for _, ms in solves[mark[0]:]]
    u = uploads[mark[1]:]
    med = f", median {statistics.median(s):.3f} ms" if s else ""
    up = f", median {statistics.median(u):.3f} ms" if u else ""
    return (f"card solves {len(s)}{med} ({sum(s):.0f} ms in all); table uploads "
            f"{len(u)}{up} ({sum(u):.1f} ms in all)")


def faults_serve_phase(torch, np, check, smi: str):
    """Phase 17: the fault drills, the serve control plane and the flight
    recorder on the card, each against a CPU run of the same port code."""
    from repro_torch.api import selfcheck
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import drills, fairness
    from repro_torch.obs import FlightRecorder, validate_trace
    from repro_torch.serve import evaluate_scenario, get_scenario, run_scenario
    from repro_torch.serve import scenario_names

    t_phase = time.perf_counter()
    print(f"[17 faults+serve] {smi}", flush=True)
    reset_launch_counts()
    with fairness.timed_solves() as solves, table_uploads(torch) as uploads:
        mark = lambda: (len(solves), len(uploads))
        # ---- 17a. the fault drills -------------------------------------------
        m, t0 = mark(), time.perf_counter()
        rep = {"cuda": {}, "cpu": {}}
        got = drills.metrics(device="cuda", reports=rep["cuda"],
                             sections=drills.FAULT_SECTIONS)
        card_s = time.perf_counter() - t0
        cpu = drills.metrics(device="cpu", reports=rep["cpu"],
                             sections=drills.FAULT_SECTIONS)
        for name in drills.FAULT_SECTIONS:
            same = got[name] == cpu[name]
            check(same, f"drill {name}: card figures != CPU figures")
            check(got[name]["digest"] == FAULT_DIGESTS[name],
                  f"drill {name}: digest {got[name]['digest']} != BENCH_faults.json's")
            print(f"[17a drills] {name}: {drills.describe(name, got[name])}; card "
                  f"{'=' if same else '!='} CPU", flush=True)
        check(rep["cuda"] == rep["cpu"], "drills: a card DrillResult != the CPU's")
        print(f"[17a drills] four drills on the card {card_s:.2f} s; "
              f"{len(rep['cuda'])} DrillResults and report streams card "
              f"{'=' if rep['cuda'] == rep['cpu'] else '!='} CPU; {card_work(solves, uploads, m)}",
              flush=True)

        # ---- 17b. the six serve scenarios, both arms, and churn -------------
        m, t0 = mark(), time.perf_counter()
        res = {dv: {n: evaluate_scenario(get_scenario(n), device=dv)
                    for n in scenario_names()} for dv in ("cuda", "cpu")}
        churn = {dv: drills.churn(device=dv) for dv in ("cuda", "cpu")}
        serve_s = time.perf_counter() - t0
        for n in scenario_names():
            a, b = res["cuda"][n], res["cpu"][n]
            same = all(a[k].to_json_obj() == b[k].to_json_obj()
                       for k in ("adaptive", "static")) and a["slo"] == b["slo"]
            check(same, f"scenario {n}: card reports or SLO != CPU's")
            check(a["slo"]["pass"], f"scenario {n}: SLO failed on the card")
            if n in FAULT_DIGESTS:
                check(a["adaptive"].fault_digest == FAULT_DIGESTS[n],
                      f"scenario {n}: fault digest != BENCH_serve.json's")
            win = a["slo"]["gates"]["combined_drain"]["value"]
            print(f"[17b serve] {n}: SLO {'PASS' if a['slo']['pass'] else 'FAIL'}, win "
                  f"{win!r}, Jain {a['adaptive'].jain_index!r}, availability "
                  f"{a['adaptive'].availability!r}, tenants {len(a['adaptive'].tenants)}, "
                  f"adaptive {a['adaptive'].total_completion_s!r} s; both arms card "
                  f"{'=' if same else '!='} CPU", flush=True)
        same = churn["cuda"] == churn["cpu"]
        check(same, "serve churn section: card != CPU")
        print(f"[17b serve] churn: {drills.describe('churn', churn['cuda'])}; card "
              f"{'=' if same else '!='} CPU; six scenarios and churn on both devices "
              f"{serve_s:.2f} s; {card_work(solves, uploads, m)}", flush=True)
        figs = dict(got, churn=churn["cuda"])
        for n, r in res["cuda"].items():
            figs[n] = {"win": r["slo"]["gates"]["combined_drain"]["value"],
                       "jain": r["adaptive"].jain_index}
        for (sec, key), val in DRILL_FIGURES.items():
            check(figs[sec][key] == val,
                  f"{sec} {key} {figs[sec][key]!r} != the reference code's {val!r}")

        # ---- 17c. the flight recorder ---------------------------------------
        m, t0 = mark(), time.perf_counter()
        spec = get_scenario("flap_under_load")
        recs = {dv: FlightRecorder("flap-17c") for dv in ("cuda", "cpu")}
        reps = {dv: run_scenario(spec, "adaptive", recorder=recs[dv], device=dv)
                for dv in ("cuda", "cpu")}
        plain = run_scenario(spec, "adaptive", device="cuda").to_json_obj()
        info = validate_trace(recs["cuda"].export_trace())
        layers = {"serve", "runtime", "fabric", "planner"} <= set(info["cats"])
        same = (recs["cuda"].export_trace() == recs["cpu"].export_trace()
                and recs["cuda"].provenance.to_json_obj()
                == recs["cpu"].provenance.to_json_obj()
                and recs["cuda"].metrics_snapshot() == recs["cpu"].metrics_snapshot()
                and reps["cuda"].to_json_obj() == reps["cpu"].to_json_obj())
        recorded = reps["cuda"].to_json_obj()
        recorded.pop("metrics")
        swapped = recs["cuda"].provenance.swapped()
        complete = bool(swapped) and all(
            p.swapped_window is not None and p.trigger and p.signature
            and p.ready_window is not None for p in swapped)
        check(layers and info["correlation_id"] == "flap-17c",
              f"recorded flap_under_load: layers {info['cats']}, corr "
              f"{info['correlation_id']}")
        check(same, "recorded flap_under_load: trace, provenance, metrics or report "
              "card != CPU")
        check(complete, "recorded flap_under_load: a swap without a complete provenance")
        check(recorded == plain, "recorded flap_under_load report != unrecorded report")
        obs = {dv: drills.obs(device=dv, recorder=FlightRecorder("obs-17c"))
               for dv in ("cuda", "cpu")}
        wall = {dv: {k: obs[dv].pop(k) for k in drills.OBS_WALL_KEYS} for dv in obs}
        check(obs["cuda"] == obs["cpu"], "obs section: card figures != CPU figures")
        check(obs["cuda"]["identical"] and obs["cuda"]["trace_events"] == 70
              and obs["cuda"]["plans_issued"] == 8 and obs["cuda"]["plans_swapped"] == 7,
              f"obs section on the card: {obs['cuda']}")
        print(f"[17c recorder] flap_under_load on the card: {info['events']} trace "
              f"events, {info['spans']} spans, layers {info['cats']}, corr "
              f"{info['correlation_id']}; {len(recs['cuda'].provenance)} plans, "
              f"{len(swapped)} swapped, provenance {'complete' if complete else 'INCOMPLETE'}; "
              f"trace, provenance, metrics and report card {'=' if same else '!='} CPU; "
              f"recorded report {'=' if recorded == plain else '!='} unrecorded", flush=True)
        print(f"[17c recorder] obs section on the card: "
              f"{drills.describe('obs', {**obs['cuda'], **wall['cuda']})}; card "
              f"{'=' if obs['cuda'] == obs['cpu'] else '!='} CPU (on the CPU: recorder "
              f"overhead {wall['cpu']['overhead_ratio']:.4f}x); "
              f"{time.perf_counter() - t0:.2f} s; {card_work(solves, uploads, m)}", flush=True)

        # ---- 17d. the API selfcheck, eight checks ---------------------------
        m = mark()
        rc, out = _quiet(selfcheck.main, ["--device", "cuda"])
        lines = out.strip().splitlines()
        check(rc == 0 and lines[-1].startswith("[selfcheck] 8/8 checks passed"),
              f"api selfcheck on the card: {lines[-1]}")
        print("[17d selfcheck] " + " | ".join(
            line.replace("[selfcheck] ", "") for line in lines) + f"; {card_work(solves, uploads, m)}",
            flush=True)
    torch.cuda.synchronize()
    launched = {k: v for k, v in launch_counts().items() if v}
    print(f"[17 faults+serve] all of phase 17: {card_work(solves, uploads)}; port kernels "
          f"launched {launched or 'none (the planner loop is plain torch)'}; "
          f"{time.perf_counter() - t_phase:.0f} s for phase 17 on {smi}", flush=True)


def _step_rows(step, params, state, batches, n_timed: int = 3):
    """``n_timed`` steps after the caller's warm-up -> (params, state, rows):
    each step's wall (ended by a sync), loss, norm and phase seconds."""
    import torch

    rows = []
    for i in range(1, n_timed + 1):
        times = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batches[i], times=times)
        wall = time.perf_counter() - t0                    # the step ends in a sync
        rows.append(dict(wall=wall, loss=float(m["loss"]), gnorm=float(m["grad_norm"]),
                         **times))
    return params, state, rows


def _train_line(tag, cfg, n_params, B, S, rows, m0, peak_gb, extra, smi, np, check):
    """Print a full-width training phase's figures and gate its losses and norms."""
    losses = [float(m0["loss"])] + [r["loss"] for r in rows]
    norms = [float(m0["grad_norm"])] + [r["gnorm"] for r in rows]
    check(bool(np.isfinite(losses).all() and np.isfinite(norms).all()),
          f"{cfg.name} train losses {losses} or grad norms {norms} not finite")
    step_ms = float(np.mean([r["wall"] for r in rows])) * 1e3
    share = {k: float(np.mean([r[k] / r["wall"] for r in rows]))
             for k in ("forward", "backward", "optimizer")}
    walls = ", ".join(f"{r['wall'] * 1e3:.1f}" for r in rows)
    print(f"[{tag}] {cfg.name} bf16, {n_params / 1e6:.2f} M params, batch {B} x {S} from "
          f"SyntheticLM (seed 0), AdamW: step {walls} ms (mean {step_ms:.1f} ms, "
          f"{B * S / step_ms * 1e3:.0f} tokens/s; warm-up step excluded); forward "
          f"{share['forward']:.3f}, backward {share['backward']:.3f}, optimizer "
          f"{share['optimizer']:.3f} of the step; {extra}peak memory {peak_gb:.2f} GB; "
          f"on {smi}", flush=True)
    print(f"[{tag}] loss by step {[round(x, 4) for x in losses]}, grad_norm "
          f"{[round(x, 4) for x in norms]}", flush=True)
    return step_ms


def _grads_card_vs_cpu(torch, cfg, seed: int, seq: int, bias: bool = False):
    """A reduced config's f32 loss and gradients on the card against the CPU's
    plain versions -> (loss |diff| / |loss|, worst leaf max|diff| / max|leaf|,
    logits max|diff| / max|logits|).  The audio and vlm families get their stub
    inputs (``add_modality_stubs``); the CPU's FFN takes the scan (``scan_ffn``)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, add_modality_stubs, to_device
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.context import ParallelContext
    from repro_torch.train.step import loss_and_grads
    from repro_torch.tree import leaves, map_tree

    weights = build_model(cfg, ParallelContext(device="cpu")).init(seed)
    if bias:                              # qwen2.5's QKV biases, nonzero
        gen = torch.Generator().manual_seed(seed + 1)
        for key in ("bq", "bk", "bv"):
            weights["blocks"]["attn"][key].normal_(generator=gen)
    batch = add_modality_stubs(SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                                       global_batch=2, seed=seed)).batch(0),
                               cfg, rng_seed=seed)
    out = []
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, ParallelContext(device=dev))
        params = map_tree(lambda t: t.to(dev, copy=True), weights)
        b = to_device(batch, dev)
        with scan_ffn():
            with torch.no_grad():
                logits, _ = model.forward(params, b)
            loss, grads = loss_and_grads(model, params, b)
        out.append((float(loss), [g.cpu() for g in leaves(grads)], logits.float().cpu()))
    (lc, gc, oc), (lg, gg, og) = out
    worst = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                for a, b in zip(gg, gc))
    return (abs(lg - lc) / abs(lc), worst,
            ((og - oc).abs().max() / oc.abs().max()).item())


def xlstm_train_phase(torch, np, check, compare, seed: int, dev, smi: str):
    """Phase 18 -> (mlstm_scan backward's report, launches under grad, the
    chunk body's cummax VJP's report and launches, the state phase 20 steps
    on from)."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.kernel_times import device_ms, time_ms
    from repro_torch.kernels.mlstm_scan import ops as ms_ops
    from repro_torch.models import xlstm as xlstm_mod
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw
    from repro_torch.roofline.analysis import kernel_bound
    from repro_torch.sharding.context import ParallelContext
    from repro_torch.train.step import _Phases, loss_and_grads, make_train_step
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    cfg = get_config("xlstm-125m")
    bf16 = torch.bfloat16
    model = build_model(cfg, ParallelContext(param_dtype=bf16, compute_dtype=bf16,
                                             device="cuda"))
    params = model.init(seed)
    n_params = sum(p.numel() for p in leaves(params))
    state = adamw.init(params)
    step = make_train_step(model, adamw.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=100))
    B, S = 4, 2048
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=seed))
    batches = [to_device(data.batch(i), dev) for i in range(5)]
    # the main path: a warm-up step and 3 timed steps, every count set to 0
    # just before it and read just after
    reset_launch_counts()
    with Recorder(ms_ops, "cummax_bwd", keep=1) as rec_cm:
        params, state, m0 = step(params, state, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with EventTimer(torch, ms_ops, "mlstm_scan_bwd") as t_bwd:
        params, state, rows = _step_rows(step, params, state, batches)
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_mlstm = sum(not xlstm_mod.is_slstm_layer(cfg, i) for i in range(cfg.n_layers))
    check(counts["mlstm_scan"] == 4 * n_mlstm,
          f"mlstm_scan launched {counts['mlstm_scan']} times under grad in 4 steps, "
          f"want {4 * n_mlstm}")
    # the chunk body's cummax VJP: once in each of mlstm_scan_bwd's two passes
    check(counts["mlstm_cummax_bwd"] == 2 * 4 * n_mlstm,
          f"mlstm_cummax_bwd launched {counts['mlstm_cummax_bwd']} times in 4 steps, "
          f"want {2 * 4 * n_mlstm}")
    g, dy, _ = rec_cm.calls[0]
    err = compare("mlstm_cummax_bwd", f"warm-up step's first call g {tuple(g.shape)}",
                  ms_ops.cummax_bwd(g, dy), ms_ops.cummax_bwd_ref(g, dy), 0.0,
                  "sums of at most two products by 1, 1/2 or 0, each rounded once")
    same = torch.equal(ms_ops.cummax_bwd(g, dy), ms_ops.cummax_bwd(g, dy))
    check(same, "mlstm_cummax_bwd: a second run gave other bits")
    cm_bound_s, cm_bound_by = kernel_bound(*ms_ops.cummax_bwd_cost(g.numel()), "f32")
    cm = dict(ms=time_ms(lambda: ms_ops.cummax_bwd(g, dy), 20),
              device_ms=device_ms(lambda: ms_ops.cummax_bwd(g, dy), 20),
              plain_ms=time_ms(lambda: ms_ops.cummax_bwd_ref(g, dy), 5), library_ms=None,
              max_abs_err=err, bound_ms=cm_bound_s * 1e3, bound_by=cm_bound_by,
              shape=f"g {tuple(g.shape)} f32")
    print(f"[18 kernel] mlstm_cummax_bwd {cm['shape']}: kernel {cm['ms']:.4f} ms "
          f"({cm['device_ms']:.4f} on the device), plain "
          f"(autograd through the scan's recursion) {cm['plain_ms']:.4f} ms, bound "
          f"{cm['bound_ms']:.5f} ms ({cm['bound_by']}); no library call computes this VJP; "
          f"{counts['mlstm_cummax_bwd']} launches in the 4 steps, a second run "
          f"{'same bits' if same else 'DIFFERS'}", flush=True)
    del rec_cm, g, dy
    bwd_ms = t_bwd.total_ms() / 3

    # the backward a step with the prefix Functions (the reference's adjoints)
    # and without them (autograd through the doubling scans), in turns
    def backward_ms():
        ph = _Phases({}, dev)
        loss_and_grads(model, params, batches[4], phases=ph)
        return ph.times["backward"] * 1e3

    arms = {"with": [], "without": []}
    for arm in ("with", "without", "without", "with"):
        if arm == "without":
            saved = xlstm_mod.linear_prefix, xlstm_mod.maxplus_prefix
            xlstm_mod.linear_prefix, xlstm_mod.maxplus_prefix = (xlstm_mod._linear_scan,
                                                                 xlstm_mod._maxplus_scan)
        try:
            arms[arm].append(backward_ms())
        finally:
            if arm == "without":
                xlstm_mod.linear_prefix, xlstm_mod.maxplus_prefix = saved
    # the least work of mlstm_scan's VJP at a layer's shapes: its products are
    # the forward's, each transposed twice (2x the forward's operations); bytes:
    # q, k, v, ig, lf, the cotangent of h and the chunk states read once, the
    # five gradients written once
    H, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    L = min(cfg.mlstm_chunk, S)
    nc = -(-S // L)
    flops = 2 * ms_ops.mlstm_cost(B, H, S, dh, cfg.mlstm_chunk)[0]
    nbytes = 4 * (2 * (3 * B * H * S * dh + 2 * B * H * S) + B * H * S * dh
                  + B * H * nc * (dh * dh + dh + 1))
    bwd_bound_s, bwd_bound_by = kernel_bound(flops, nbytes, "f32")
    bwd = dict(ms_per_step=bwd_ms, calls_per_step=n_mlstm,
               bound_ms_per_step=n_mlstm * bwd_bound_s * 1e3, bound_by=bwd_bound_by,
               backward_with_prefix_functions_ms=float(np.mean(arms["with"])),
               backward_without_prefix_functions_ms=float(np.mean(arms["without"])))
    step_ms = _train_line(
        "18 xlstm train", cfg, n_params, B, S, rows, m0, peak_gb,
        f"mlstm_scan under grad: {counts['mlstm_scan']} launches in the 4 steps "
        f"({n_mlstm} layers x 4), its backward (MLSTMScanFunction, plain torch, f32) "
        f"{bwd_ms:.2f} ms a step ({n_mlstm} calls; bound {bwd['bound_ms_per_step']:.3f} ms, "
        f"{bwd['bound_by']}); the step's backward with the prefix Functions "
        f"{bwd['backward_with_prefix_functions_ms']:.1f} ms, without them "
        f"{bwd['backward_without_prefix_functions_ms']:.1f} ms; ", smi, np, check)
    bwd["step_ms"] = step_ms

    # gate: a reduced xlstm (an mLSTM and an sLSTM layer, chunk 16) in f32,
    # the card's kernel + Function against the CPU's plain versions
    small = dataclasses.replace(get_config("xlstm-125m").reduced(n_layers=2), mlstm_chunk=16)
    before = launch_counts()["mlstm_scan"]
    loss_rel, worst, logit_rel = _grads_card_vs_cpu(torch, small, seed, 160)
    launched = launch_counts()["mlstm_scan"] - before
    check(launched > 0, "the reduced xlstm step on the card launched no mlstm_scan")
    check(loss_rel <= 1e-5 and worst <= 1e-4,
          f"reduced xlstm train step card vs CPU: loss {loss_rel:.3g}, grads {worst:.3g}")
    print(f"[18 xlstm train] reduced xlstm (2 layers, d 256, chunk 16, S 160) f32 one "
          f"step, card vs CPU plain: loss |diff| {loss_rel:.3g} of |loss| (limit 1e-5), "
          f"gradients worst leaf {worst:.3g} of its max (limit 1e-4: f32 sums in other "
          f"orders), logits {logit_rel:.3g}; mlstm_scan launched {launched} times on the "
          f"card ({time.perf_counter() - t_phase:.0f} s for phase 18 on {smi})", flush=True)
    return bwd, counts["mlstm_scan"], cm, counts["mlstm_cummax_bwd"], \
        (step, params, state, batches[4])


def dense_phase(torch, np, check, compare, seed: int, dev, smi: str):
    """Phase 19 -> (flash's report at smollm's head dim 64, its launches at
    head dims 64 and 128)."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding.context import ParallelContext
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    ctx = ParallelContext(param_dtype=bf16, compute_dtype=bf16, device="cuda")
    # ---- 19a. smollm-135m trains at full width -----------------------------------
    cfg = get_config("smollm-135m")
    model = build_model(cfg, ctx)
    params = model.init(seed)
    n_params = sum(p.numel() for p in leaves(params))
    state = adamw.init(params)
    step = make_train_step(model, adamw.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=100))
    B, S = 4, 2048
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=seed))
    batches = [to_device(data.batch(i), dev) for i in range(4)]
    reset_launch_counts()
    params, state, m0 = step(params, state, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with EventTimer(torch, fa_ops, "flash_attention_bwd") as t_fa:
        params, state, rows = _step_rows(step, params, state, batches)
    counts_train = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(counts_train["flash_attention"] == 4 * cfg.n_layers,
          f"smollm training launched flash {counts_train['flash_attention']} times, "
          f"want {4 * cfg.n_layers} (head dim {cfg.head_dim})")
    _train_line("19 dense", cfg, n_params, B, S, rows, m0, peak_gb,
                f"flash_attention (bf16, head dim {cfg.head_dim}, {cfg.n_heads} heads over "
                f"{cfg.n_kv_heads}) {counts_train['flash_attention']} launches in the 4 steps, "
                f"its backward (plain torch, f32) {t_fa.total_ms() / 3:.1f} ms a step; ",
                smi, np, check)
    # the flash forward at smollm's shape: layer 0's q, k, v of a prefill
    with torch.no_grad(), Recorder(fa_ops, "flash_attention", keep=1) as rec:
        model.forward(params, {"tokens": batches[1]["tokens"]}, last_only=True)
    q, k, v, kw = rec.calls[0]
    del params, state, model, m0, rec
    torch.cuda.empty_cache()
    fa64 = flash_report(torch, fa_ops, compare, q, k, v, kw,
                        f"at smollm's head dim 64 (phase 19)")
    del q, k, v
    torch.cuda.empty_cache()

    # ---- 19b. llama3-8b serves at full width ---------------------------------------
    cfg = get_config("llama3-8b")
    model = build_model(cfg, ctx)
    params = model.init(seed)
    n_params = sum(p.numel() for p in leaves(params))
    rng = np.random.default_rng(seed + 3)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 512)), device=dev)
    with torch.no_grad():
        model.forward(params, {"tokens": prompts}, last_only=True)          # warm-up
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = model.forward(params, {"tokens": prompts}, last_only=True)
        torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts_prefill = launch_counts()
    check(tuple(logits.shape) == (4, 1, cfg.vocab) and bool(torch.isfinite(logits).all()),
          f"llama3-8b prefill logits {tuple(logits.shape)} not finite or misshapen")
    check(counts_prefill["flash_attention"] == cfg.n_layers,
          f"llama3-8b prefill launched flash {counts_prefill['flash_attention']} times, "
          f"want {cfg.n_layers} (head dim {cfg.head_dim})")
    engine = ServeEngine(model, params, max_len=16)
    gprompts = rng.integers(0, cfg.vocab, (4, 8))
    engine.generate(gprompts, n_new=8)                                     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = engine.generate(gprompts, n_new=8)
    gen_s = time.perf_counter() - t0
    check(ids.shape == (4, 8) and ((ids >= 0) & (ids < cfg.vocab)).all(),
          f"llama3-8b generated ids {ids.shape}")
    # the engine's step-by-step prefill ends where the forward does
    from repro_torch.configs.base import InputShape

    pt = torch.as_tensor(gprompts, device=dev)
    with torch.no_grad():
        l_step, _ = engine.prefill(model.init_cache(4, InputShape("serve", 16, 4, "decode")),
                                   pt)
        l_fwd = model.forward(params, {"tokens": pt}, last_only=True)[0][:, 0]
    step_err = compare("llama3-8b engine prefill vs forward", "bf16 last logits", l_step,
                       l_fwd, 5e-2, "bf16 activations through 32 layers, decode attention "
                       "vs the forward's")
    print(f"[19 serve] {cfg.name} bf16, {n_params / 1e9:.3f} B params "
          f"({n_params * 2 / 1e9:.2f} GB): prefill 4 x 512 (last_only) {prefill_s * 1e3:.1f} "
          f"ms, {prompts.numel() / prefill_s:.0f} tokens/s, flash_attention launches (head "
          f"dim {cfg.head_dim}) {counts_prefill['flash_attention']}; generate 4 requests, "
          f"prompt 8, 8 new tokens, greedy: {gen_s:.2f} s, {ids.size / gen_s:.1f} new "
          f"tokens/s (warm-up run excluded); step prefill vs forward max|diff| "
          f"{step_err:.4g}; ids {ids[:, :4].tolist()}; on {smi}", flush=True)
    del params, model, engine, logits, l_step, l_fwd
    torch.cuda.empty_cache()

    # ---- 19c. gate: reduced configs, card against CPU (f32) -----------------------
    parts = []
    before = launch_counts()["flash_attention_f32"]
    for arch, bias in (("smollm-135m", False), ("qwen2.5-14b", True)):
        small = get_config(arch).reduced()
        loss_rel, worst, logit_rel = _grads_card_vs_cpu(torch, small, seed, 160, bias=bias)
        check(loss_rel <= 1e-5 and worst <= 1e-4 and logit_rel <= 1e-4,
              f"reduced {arch} card vs CPU: logits {logit_rel:.3g}, loss {loss_rel:.3g}, "
              f"grads {worst:.3g}")
        parts.append(f"{arch}{' (QKV bias)' if bias else ''}: logits {logit_rel:.3g}, loss "
                     f"{loss_rel:.3g}, gradients worst leaf {worst:.3g}")
    launched = launch_counts()["flash_attention_f32"] - before
    check(launched > 0, "the reduced dense configs launched no f32 flash on the card")
    print(f"[19 dense parity] reduced (2 layers, d 256, 4 heads of 64, S 160) f32, card vs "
          f"CPU plain, each relative to the CPU's largest value: " + "; ".join(parts)
          + f" (limits 1e-4, loss 1e-5: f32 sums in other orders); flash f32 launched "
          f"{launched} times ({time.perf_counter() - t_phase:.0f} s for phase 19 on {smi})",
          flush=True)
    return fa64, counts_train["flash_attention"], counts_prefill["flash_attention"]


def _ref_flatten(tree, prefix=""):
    """The reference's ``checkpoint/ckpt.py::_flatten`` (numpy only)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _ref_flatten(tree[k], f"{prefix}{k}/")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _ref_flatten(v, f"{prefix}{i}/")
        return out
    return [(prefix.rstrip("/"), tree)]


def _ref_structure(tree):
    """The reference's ``checkpoint/ckpt.py::_structure``."""
    if isinstance(tree, dict):
        return {"__kind__": "dict", "items": {k: _ref_structure(v) for k, v in tree.items()}}
    if hasattr(tree, "_fields"):
        return {"__kind__": "namedtuple", "name": type(tree).__name__,
                "items": [_ref_structure(v) for v in tree]}
    if isinstance(tree, tuple):
        return {"__kind__": "tuple", "items": [_ref_structure(v) for v in tree]}
    if isinstance(tree, list):
        return {"__kind__": "list", "items": [_ref_structure(v) for v in tree]}
    return {"__kind__": "leaf"}


def ckpt_selftest_phase(torch, np, check, xlstm_state, smi: str):
    """Phase 20: a checkpoint round trip on the card, the index against the
    reference's, and the selftest on the card."""
    import tempfile

    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import selftest
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    step, params, state, batch = xlstm_state
    tree = {"params": params, "opt": state}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        d = ckpt.save(tmp, state.step, tree)
        save_s = time.perf_counter() - t0
        size_mb = sum(f.stat().st_size for f in Path(d).iterdir()) / 1e6
        t0 = time.perf_counter()
        got, at = ckpt.restore(tmp, namedtuple_types={"OptState": adamw.OptState})
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        # the index and the .npz keys as the reference's _flatten / _structure
        # give them for this tree (bfloat16 leaves: numpy's dtype name via
        # ml_dtypes, which the reference's np.asarray carries)
        index = json.loads(Path(d, "index.json").read_bytes())
        flat = _ref_flatten(tree)
        keys = [k for k, _ in flat]

        def dtype_name(x):
            return "int32" if isinstance(x, int) else str(x.dtype).replace("torch.", "")
        meta = {k: {"shape": list(getattr(x, "shape", ())), "dtype": dtype_name(x), "shard": 0}
                for k, x in flat}
        with np.load(Path(d, "shard_0.npz")) as z:
            npz_keys = sorted(z.files)
        same_index = (index["keys"] == keys and index["meta"] == meta
                      and index["structure"] == _ref_structure(tree)
                      and npz_keys == sorted(keys) and index["step"] == state.step)
    check(same_index, "the checkpoint's index or .npz keys differ from the reference's")
    on_card = all(x.device.type == "cuda" for x in leaves(got) if hasattr(x, "device"))
    check(at == state.step and got["opt"].step == state.step and on_card,
          f"restored step {at} / {got['opt'].step}, on the card {on_card}")
    # one more step from each: the round trip must change nothing
    p_a, s_a, m_a = step(params, state, batch)
    p_b, s_b, m_b = step(got["params"], got["opt"], batch)
    pairs = list(zip(leaves({"p": p_a, "m": s_a.m, "v": s_a.v}),
                     leaves({"p": p_b, "m": s_b.m, "v": s_b.v})))
    exact = (all(torch.equal(a, b) for a, b in pairs) and s_a.step == s_b.step
             and float(m_a["loss"]) == float(m_b["loss"])
             and float(m_a["grad_norm"]) == float(m_b["grad_norm"]))
    check(exact, "a step after the checkpoint round trip differs from the step without it")
    print(f"[20 ckpt] xlstm-125m after phase 18's steps (step {state.step}): saved "
          f"{len(keys)} leaves, {size_mb:.1f} MB in {save_s:.2f} s, restored on the card in "
          f"{restore_s:.2f} s; index keys, meta, structure and .npz keys "
          f"{'= the reference' if same_index else '!= the reference'}'s _flatten/_structure; "
          f"one more step from the restored state: params ({len(pairs)} leaves with the "
          f"moments), optimizer state and loss {float(m_b['loss']):.5f} "
          f"{'equal bit for bit' if exact else 'DIFFER'}; on {smi}", flush=True)
    rc = selftest.main(["--device", "cuda"])
    check(rc == 0, f"the selftest on the card returned {rc}")
    print(f"[20 selftest] selftest.main(['--device', 'cuda']) -> {rc} "
          f"({time.perf_counter() - t_phase:.0f} s for phase 20 on {smi})", flush=True)


def _flash_key(q, k, v, **kw):
    return (tuple(q.shape), tuple(k.shape), kw["causal"])


def _ffn_key(x, blk, wg, wu, wd, **kw):
    return (tuple(x.shape), tuple(wg.shape))


def _gather_key(x, idx, **kw):
    return (tuple(x.shape), str(x.dtype)[6:], idx.numel())


def _scatter_key(g, idx, n, **kw):
    return (tuple(g.shape), str(g.dtype)[6:], idx.numel(), n)


def gather_recorders(stack):
    """Recorders (``_gather_key``) of token_gather in each module of the MoE
    path that calls it, entered on ``stack``."""
    from repro_torch.core import dataplane, moe_comm
    from repro_torch.kernels.grouped_ffn import ops as ffn_ops

    return [stack.enter_context(Recorder(mod, "token_gather", key=_gather_key))
            for mod in (moe_comm, dataplane, ffn_ops)]


def check_gathers(torch, compare, recs, label: str) -> dict:
    """token_gather on the first call of each shape the recorders saw,
    against its plain version (exact) -> {key: (x, idx)}."""
    from repro_torch.kernels.token_scatter import ops as ts_ops

    calls = {}
    for r in recs:
        for k, c in r.first.items():
            calls.setdefault(k, c[:2])
    for k, (x, idx) in calls.items():
        compare("token_gather", f"{label} x {k[0]} {k[1]} idx [{k[2]}]",
                ts_ops.token_gather(x, idx), ts_ops.token_gather_ref(x, idx), 0.0,
                "a copy is exact")
    return calls


def flash_report(torch, fa_ops, compare, q, k, v, kw, label: str) -> dict:
    """flash_attention on one call's inputs against ``mha_ref`` (bf16, 1e-2 x
    max|ref|), timed beside it, one SDPA call and the bound.  The bound
    counts the score pairs this call's mask keeps (4 dh flops each) at the
    bf16 peak, and q, k, v read and o written once at 3.35 TB/s; SDPA runs
    ``is_causal`` where the call is plain causal, else with the boolean mask,
    and takes the kv heads as they are (``enable_gqa``) where it can."""
    import torch.nn.functional as F

    from repro_torch.launch.kernel_times import time_ms
    from repro_torch.roofline.analysis import kernel_bound

    B, H, Sq, Dh = q.shape
    Sk = k.shape[2]
    o = fa_ops.flash_attention(q, k, v, **kw)
    err = compare("flash_attention", label, o, fa_ops.mha_ref(q, k, v, **kw), 1e-2,
                  "bf16 inputs and output; online vs two-pass softmax")
    mask = fa_ops._mask(Sq, Sk, kw["causal"], kw["window"], kw["q_offset"], q.device)
    bound_s, bound_by = kernel_bound(*fa_ops.flash_cost(
        q.shape, k.numel(), kw["causal"], kw["window"], kw["q_offset"], Sk,
        q.element_size()), "bf16")
    plain_causal = (kw["causal"] and kw["window"] is None and kw["q_offset"] == 0
                    and Sq == Sk)
    sdpa_kw = dict(is_causal=True) if plain_causal else (
        dict(attn_mask=mask) if kw["causal"] or kw["window"] is not None else {})
    kk, vv = k, v
    try:
        F.scaled_dot_product_attention(q, kk, vv, enable_gqa=True, **sdpa_kw)
        sdpa_kw["enable_gqa"] = True
    except TypeError:                      # a torch without enable_gqa
        kk, vv = (t.repeat_interleave(H // k.shape[1], 1) for t in (k, v))
    r = dict(ms=time_ms(lambda: fa_ops.flash_attention(q, k, v, **kw), 20),
             plain_ms=time_ms(lambda: fa_ops.mha_ref(q, k, v, **kw), 3),
             library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                 q, kk, vv, **sdpa_kw), 20),
             max_abs_err=err, bound_ms=bound_s * 1e3, bound_by=bound_by,
             shape=f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 "
                   f"{'causal' if kw['causal'] else 'non-causal'}")
    print(f"  flash_attention {label}: {r['shape']}: kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
          f"ms ({r['bound_by']})", flush=True)
    return r


def ffn_report(torch, ffn_ops, compare, call, label: str) -> dict:
    """grouped_ffn_blocked on one call's sorted, padded rows against its plain
    version (bf16, 1e-2 x max|ref|), timed beside it, the per-expert matmul
    loop over the token rows (the library yardstick) and the bound: 6 D F
    flops a token row at the bf16 peak, and the token rows read and written
    and each used expert's three matrices read once at 3.35 TB/s."""
    import torch.nn.functional as F

    from repro_torch.launch.kernel_times import time_ms
    from repro_torch.roofline.analysis import kernel_bound

    x, blk, wg, wu, wd, kw = call
    bt, rows = kw["block_tokens"], kw["block_rows"]
    valid = int(rows.sum())
    used = sorted(set(blk[rows > 0].tolist()))
    D, Fd = x.shape[1], wg.shape[2]
    segs = []
    for b, e in enumerate(blk.tolist()):
        lo, hi = b * bt, b * bt + int(rows[b])
        if hi == lo:
            continue
        if segs and segs[-1][0] == e and segs[-1][2] == lo:
            segs[-1][2] = hi
        else:
            segs.append([e, lo, hi])

    def library():
        out = torch.zeros_like(x)
        for e, lo, hi in segs:
            xe = x[lo:hi]
            out[lo:hi] = (F.silu(xe @ wg[e]) * (xe @ wu[e])) @ wd[e]
        return out

    def run():
        return ffn_ops.grouped_ffn_blocked(x, blk, wg, wu, wd, block_tokens=bt, block_rows=rows)

    def plain():
        return ffn_ops.grouped_ffn_blocked_ref(x, blk, wg, wu, wd, block_tokens=bt,
                                               block_rows=rows)

    err = compare("grouped_ffn_blocked", label, run(), plain(), 1e-2,
                  "H rounds to bf16 between the passes, f32 sums, y rounds to bf16")
    bound_s, bound_by = kernel_bound(*ffn_ops.ffn_cost(valid, len(used), D, Fd, 2), "bf16")
    r = dict(ms=time_ms(run, 5), plain_ms=time_ms(plain, 2), library_ms=time_ms(library, 5),
             max_abs_err=err, bound_ms=bound_s * 1e3, bound_by=bound_by,
             shape=f"x [{x.shape[0]}, {D}] bf16 ({valid} token rows), E {wg.shape[0]} "
                   f"({len(used)} used), F {Fd}, block_tokens {bt}")
    print(f"  grouped_ffn_blocked {label}: {r['shape']}: kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, matmul loop {r['library_ms']:.4f} ms, bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    return r


def _serve_figures(torch, np, model, params, batch, vocab, rng, extra_prefill=None):
    """A full-width model's prefill (``last_only``, after a warm-up) and
    ``ServeEngine.generate`` of 4 requests, 8 + 8 tokens, greedy (after a
    warm-up) -> (prefill seconds, logits, launches of the prefill, generate
    seconds, ids, launches of the timed generation)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.engine import ServeEngine

    with torch.no_grad():
        model.forward(params, batch, last_only=True)                       # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        logits, _ = model.forward(params, batch, last_only=True, **(extra_prefill or {}))
        torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts_prefill = launch_counts()
    engine = ServeEngine(model, params, max_len=16)
    prompts = rng.integers(0, vocab, (4, 8))
    engine.generate(prompts, n_new=8)                                      # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    ids = engine.generate(prompts, n_new=8)
    gen_s = time.perf_counter() - t0
    return prefill_s, logits, counts_prefill, gen_s, ids, launch_counts()


def moe_family_phase(torch, np, check, compare, seed: int, dev, smi: str):
    """Phase 21 -> (the FFN's reports at E 128 and E 32, flash's at qwen3's
    GQA 16:1, token_gather's and token_scatter_add's at the largest call of
    each path, launches of the four kernels on the phase's paths)."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.grouped_ffn import ops as ffn_ops
    from repro_torch.kernels.token_scatter import ops as ts_ops
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw
    from repro_torch.sharding.context import ParallelContext
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    ctx8 = ParallelContext(ep_size=8, group_size=4, moe_mode="nimble", param_dtype=bf16,
                           compute_dtype=bf16, device="cuda")
    rng = np.random.default_rng(seed + 21)
    ffn, fa, tg, sa = {}, {}, {}, {}
    launches = {"grouped_ffn_blocked": 0, "flash_attention": 0, "token_gather": 0,
                "token_scatter_add": 0}
    # ---- 21a. qwen3-moe-235b-a22b, one layer at full width, serves ------------
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b"), n_layers=1)
    model = build_model(cfg, ctx8)
    params = model.init(seed)
    n_params = sum(p.numel() for p in leaves(params))
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (4, 512)), device=dev)}
    with contextlib.ExitStack() as stack, torch.no_grad():
        log_ffn = stack.enter_context(Recorder(ffn_ops, "grouped_ffn_blocked", key=_ffn_key))
        log_fa = stack.enter_context(Recorder(fa_ops, "flash_attention", key=_flash_key))
        log_tg = gather_recorders(stack)
        model.forward(params, batch, last_only=True)                       # capture
    stats = {}
    prefill_s, logits, c_pre, gen_s, ids, c_gen = _serve_figures(
        torch, np, model, params, batch, cfg.vocab, rng, dict(stats=stats))
    check(tuple(logits.shape) == (4, 1, cfg.vocab) and bool(torch.isfinite(logits).all()),
          f"qwen3 prefill logits {tuple(logits.shape)} not finite or misshapen")
    check(ids.shape == (4, 8) and ((ids >= 0) & (ids < cfg.vocab)).all(),
          f"qwen3 generated ids {ids.shape}")
    check(c_pre["grouped_ffn_blocked"] == cfg.n_layers and c_pre["flash_attention"] ==
          cfg.n_layers and c_pre["token_gather"] > 0 and c_pre["token_scatter_add"] == 0,
          f"qwen3 prefill launches {c_pre}: want the FFN and flash once a layer")
    check(c_gen["grouped_ffn_blocked"] == 16 * cfg.n_layers and c_gen["flash_attention"] == 0,
          f"qwen3 generate launches {c_gen}: want the FFN once a layer a decode step "
          f"(8 prompt + 8 new), no flash (Sq 1 takes the plain attention)")
    for name in launches:
        launches[name] += c_pre[name] + c_gen[name]
    print(f"[21 qwen3] {cfg.name} with 1 of its 94 layers, bf16, {n_params / 1e9:.3f} B "
          f"params ({n_params * 2 / 1e9:.2f} GB), ep=8 groups of 4 nimble, E {cfg.n_experts} "
          f"top-{cfg.top_k}, 64 heads of 128 over 4: prefill 4 x 512 (last_only) "
          f"{prefill_s * 1e3:.1f} ms, {4 * 512 / prefill_s:.0f} tokens/s, dropped "
          f"{int(stats['dropped'])} of {4 * 512 * cfg.top_k} assignments; generate 4 "
          f"requests, prompt 8, 8 new tokens, greedy: {gen_s:.2f} s, {ids.size / gen_s:.1f} "
          f"new tokens/s (warm-up runs excluded); launches prefill {c_pre}, generate "
          f"{c_gen}; on {smi}", flush=True)
    ffn["qwen3 E128 top-8 F1536"] = ffn_report(torch, ffn_ops, compare,
                                               next(iter(log_ffn.first.values())),
                                               "qwen3 E 128 (16 a rank) F 1536 D 4096")
    q, k, v, kw = next(iter(log_fa.first.values()))
    fa["qwen3 GQA 16:1"] = flash_report(torch, fa_ops, compare, q, k, v, kw,
                                        "qwen3 prefill, 64 heads over 4")
    gathers = check_gathers(torch, compare, log_tg, "qwen3 prefill")
    x, idx = max(gathers.values(), key=lambda c: c[0].numel() * c[0].element_size())
    tg["qwen3 prefill largest"] = gather_report(torch, x, idx, ts_ops.token_gather,
                                                ts_ops.token_gather_ref)
    print_gather("qwen3 prefill largest", tg["qwen3 prefill largest"])
    del model, params, logits, log_ffn, log_fa, log_tg, gathers, q, k, v, x, idx
    torch.cuda.empty_cache()

    # ---- 21b. granite-moe-1b-a400m trains at full width ----------------------------
    cfg = get_config("granite-moe-1b-a400m")
    model = build_model(cfg, ctx8)
    params = model.init(seed)
    n_params = sum(p.numel() for p in leaves(params))
    state = adamw.init(params)
    step = make_train_step(model, adamw.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=100))
    B, S = 4, 512
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=seed))
    batches = [to_device(data.batch(i), dev) for i in range(4)]
    reset_launch_counts()
    with contextlib.ExitStack() as stack:
        log_ffn = stack.enter_context(Recorder(ffn_ops, "grouped_ffn_blocked", key=_ffn_key))
        log_tg = gather_recorders(stack)
        log_sa = stack.enter_context(Recorder(ts_ops, "token_scatter_add", key=_scatter_key))
        params, state, m0 = step(params, state, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, dropped = [], []
    with EventTimer(torch, fa_ops, "flash_attention_bwd") as t_fa:
        for i in (1, 2, 3):
            times, st = {}, {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batches[i], stats=st, times=times)
            rows.append(dict(wall=time.perf_counter() - t0, loss=float(m["loss"]),
                             gnorm=float(m["grad_norm"]), **times))
            dropped.append(int(st["dropped"]))
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(counts["grouped_ffn_blocked"] == 4 * cfg.n_layers and counts["flash_attention"] ==
          4 * cfg.n_layers and counts["token_gather"] > 0 and counts["token_scatter_add"] > 0,
          f"granite training launches {counts}: want the FFN and flash once a layer a "
          f"step ({4 * cfg.n_layers}), token_gather and token_scatter_add")
    for name in launches:
        launches[name] += counts[name]
    _train_line("21 granite train", cfg, n_params, B, S, rows, m0, peak_gb,
                f"ep=8 groups of 4 nimble, E {cfg.n_experts} top-{cfg.top_k}, F {cfg.d_ff}; "
                f"dropped {dropped} of {cfg.n_layers} x {B * S * cfg.top_k} assignments a step "
                f"(capacity factor {cfg.moe_capacity_factor}); launches in the "
                f"4 steps: grouped_ffn_blocked {counts['grouped_ffn_blocked']}, flash "
                f"{counts['flash_attention']}, token_gather {counts['token_gather']}, "
                f"token_scatter_add {counts['token_scatter_add']}; the attention backward "
                f"(plain torch, f32) {t_fa.total_ms() / 3:.2f} ms a step; ",
                smi, np, check)
    ffn["granite E32 top-8 F512"] = ffn_report(torch, ffn_ops, compare,
                                               next(iter(log_ffn.first.values())),
                                               "granite E 32 (4 a rank) F 512 D 1024")
    gathers = check_gathers(torch, compare, log_tg, "granite train")
    x, idx = max(gathers.values(), key=lambda c: c[0].numel() * c[0].element_size())
    tg["granite train largest"] = gather_report(torch, x, idx, ts_ops.token_gather,
                                                ts_ops.token_gather_ref)
    print_gather("granite train largest", tg["granite train largest"])
    parts = [check_scatter(torch, check, ts_ops, g, idx, n, f"granite {k}")
             for k, (g, idx, n, _) in log_sa.first.items()]
    g, idx, n, _ = max(log_sa.first.values(), key=lambda c: c[0].numel())
    sa["granite train largest"] = scatter_report(torch, ts_ops, g, idx, n)
    check(len(parts) > 0, "granite's backward made no token_scatter_add call")
    print(f"[21 kernel] token_scatter_add on the first call of each of the "
          f"{len(parts)} shapes of granite's warm-up backward: " + "; ".join(parts)
          + f"; the largest, {sa['granite train largest']['shape']}: kernel "
          f"{sa['granite train largest']['ms']:.4f} ms, plain "
          f"{sa['granite train largest']['plain_ms']:.4f} ms, index_add_ "
          f"{sa['granite train largest']['library_ms']:.4f} ms, bound "
          f"{sa['granite train largest']['bound_ms']:.4f} ms (bytes)", flush=True)
    del model, params, state, m0, m, log_ffn, log_tg, log_sa, gathers, x, idx, g
    torch.cuda.empty_cache()

    # ---- 21c. gate: a reduced qwen3 (its override, GQA, E 16, top-8), card vs CPU ----
    small = dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(),
                                head_dim_override=128, n_kv_heads=1, n_experts=16, top_k=8)
    before = launch_counts()
    loss_rel, worst, logit_rel = _grads_card_vs_cpu(torch, small, seed, 160)
    after = launch_counts()
    ran = {k: after[k] - before[k] for k in ("grouped_ffn_blocked_f32", "flash_attention_f32")}
    check(logit_rel <= 1e-4 and loss_rel <= 1e-5 and worst <= 1e-4 and min(ran.values()) > 0,
          f"reduced qwen3 card vs CPU: logits {logit_rel:.3g}, loss {loss_rel:.3g}, grads "
          f"{worst:.3g}, f32 launches {ran}")
    print(f"[21 moe parity] reduced qwen3 (2 layers, d 256, 4 heads of 128 over 1, E 16, "
          f"top-8, S 160) f32, card vs CPU plain (the CPU's FFN pinned to the reference's "
          f"drop-free scan, NIMBLE_FFN_IMPL=scan): logits {logit_rel:.3g} (limit 1e-4), loss "
          f"{loss_rel:.3g} (limit 1e-5), gradients worst leaf {worst:.3g} (limit 1e-4; f32 "
          f"sums in other orders); f32 launches {ran} ({time.perf_counter() - t_phase:.0f} s "
          f"for phase 21 on {smi})", flush=True)
    return ffn, fa, tg, sa, launches


def zamba2_phase(torch, np, check, compare, seed: int, dev, smi: str):
    """Phase 22 -> (flash's report at zamba2's shape, its launches)."""
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.kernel_times import time_ms
    from repro_torch.launch.train import needs_remat
    from repro_torch.models import hybrid, ssm
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw
    from repro_torch.sharding.context import ParallelContext
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    # remat as the launcher takes it (each mamba block recomputed in the
    # backward; no effect on the prefill and decode, which take no gradient)
    cfg = get_config("zamba2-1.2b")
    ctx = ParallelContext(param_dtype=bf16, compute_dtype=bf16, device="cuda",
                          remat=needs_remat(cfg.name))
    n_attn = hybrid.n_attn_calls(cfg)
    model = build_model(cfg, ctx)
    params = model.init(seed)
    n_params = sum(p.numel() for p in leaves(params))
    rng = np.random.default_rng(seed + 22)
    B, S = 4, 2048
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)), device=dev)}
    with Recorder(fa_ops, "flash_attention", key=_flash_key) as log_fa, \
            Recorder(ssm, "_ssd_chunked", keep=1) as rec_ssd, torch.no_grad():
        model.forward(params, batch, last_only=True)                       # capture
    prefill_s, logits, c_pre, gen_s, ids, c_gen = _serve_figures(
        torch, np, model, params, batch, cfg.vocab, rng)
    check(tuple(logits.shape) == (B, 1, cfg.vocab) and bool(torch.isfinite(logits).all()),
          f"zamba2 prefill logits {tuple(logits.shape)} not finite or misshapen")
    check(ids.shape == (4, 8) and ((ids >= 0) & (ids < cfg.vocab)).all(),
          f"zamba2 generated ids {ids.shape}")
    check(c_pre["flash_attention"] == n_attn and c_gen["flash_attention"] == 0,
          f"zamba2 flash launches: prefill {c_pre['flash_attention']} (want {n_attn}), "
          f"generate {c_gen['flash_attention']} (want 0)")
    print(f"[22 zamba2 serve] {cfg.name} bf16, {n_params / 1e9:.3f} B params, 32 mamba2 "
          f"layers + {n_attn} calls of the shared attention (32 heads of 64): prefill "
          f"{B} x {S} (last_only) {prefill_s * 1e3:.1f} ms, {B * S / prefill_s:.0f} tokens/s, "
          f"flash launches {c_pre['flash_attention']}; generate 4 requests, prompt 8, 8 new "
          f"tokens, greedy: {gen_s:.2f} s, {ids.size / gen_s:.1f} new tokens/s (warm-up runs "
          f"excluded); on {smi}", flush=True)
    q, k, v, kw = next(iter(log_fa.first.values()))
    report = flash_report(torch, fa_ops, compare, q, k, v, kw, "zamba2 shared attention")
    del logits, log_fa, q, k, v
    torch.cuda.empty_cache()

    # ---- 22b. train at full width -----------------------------------------------------
    state = adamw.init(params)
    step = make_train_step(model, adamw.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=100))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=seed))
    batches = [to_device(data.batch(i), dev) for i in range(4)]
    reset_launch_counts()
    params, state, m0 = step(params, state, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with EventTimer(torch, fa_ops, "flash_attention_bwd") as t_fa:
        params, state, rows = _step_rows(step, params, state, batches)
    counts = launch_counts()
    fa_bwd_ms = t_fa.total_ms() / 3
    # the SSD scan's share: one layer's _ssd_chunked (plain torch, f32) on the
    # prefill's inputs of layer 0, forward alone and forward + backward; the
    # step runs it 32 times each way (remat recomputes the forward once more)
    xs, dts, Bs, Cs, A, D = rec_ssd.calls[0][:6]
    g_ssd = torch.randn_like(xs)

    def ssd_fwd_bwd():
        live = [t.detach().requires_grad_(True) for t in (xs, dts, Bs, Cs)]
        torch.autograd.grad(ssm._ssd_chunked(*live, A, D), live, g_ssd)

    ssd_fwd = time_ms(lambda: ssm._ssd_chunked(xs, dts, Bs, Cs, A, D), 3)
    ssd_fb = time_ms(ssd_fwd_bwd, 3)
    n_mamba = hybrid.n_mamba_layers(cfg)
    ssd_step = n_mamba * (ssd_fwd + ssd_fb)
    del rec_ssd, xs, dts, Bs, Cs, g_ssd
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(counts["flash_attention"] == 4 * n_attn,
          f"zamba2 training launched flash {counts['flash_attention']} times, want "
          f"{4 * n_attn}")
    _train_line("22 zamba2 train", cfg, n_params, B, S, rows, m0, peak_gb,
                f"remat (each mamba block recomputed in the backward); flash_attention "
                f"{counts['flash_attention']} launches in the 4 steps ({n_attn} a step), the "
                f"attention's plain f32 backward {fa_bwd_ms:.1f} ms a step; _ssd_chunked "
                f"(plain torch, f32) a layer: forward {ssd_fwd:.2f} ms, forward + backward "
                f"{ssd_fb:.2f} ms, so about {ssd_step:.0f} ms of the step ({n_mamba} layers, "
                f"the forward twice); ", smi, np, check)
    launches = c_pre["flash_attention"] + counts["flash_attention"]
    del model, params, state, m0
    torch.cuda.empty_cache()

    # ---- 22c. gates: a reduced zamba2, card vs CPU, and decode vs forward ---------
    small = get_config("zamba2-1.2b").reduced()
    before = launch_counts()["flash_attention_f32"]
    loss_rel, worst, logit_rel = _grads_card_vs_cpu(torch, small, seed, 160)
    ran = launch_counts()["flash_attention_f32"] - before
    check(logit_rel <= 1e-4 and loss_rel <= 1e-5 and worst <= 1e-4 and ran > 0,
          f"reduced zamba2 card vs CPU: logits {logit_rel:.3g}, loss {loss_rel:.3g}, grads "
          f"{worst:.3g}, f32 flash launches {ran}")
    small4 = dataclasses.replace(small, attn_every=2, n_layers=4)
    m4 = build_model(small4, ParallelContext(device="cuda"))
    p4 = m4.init(seed)
    toks = torch.as_tensor(rng.integers(0, small4.vocab, (2, 130)), device=dev)
    with torch.no_grad():
        full, _ = m4.forward(p4, {"tokens": toks})
        cache = m4.init_cache(2, InputShape("decode", 130, 2, "decode"))
        outs = []
        for i in range(toks.shape[1]):
            lg, cache = m4.decode_step(p4, cache, toks[:, i], i)
            outs.append(lg)
        dec = torch.stack(outs, 1)
    excess = ((dec - full).abs() - 1e-3 * (1 + full.abs())).max().item()
    check(excess <= 0, f"reduced zamba2 decode vs forward on the card: excess {excess:.3g} "
          f"over atol = rtol = 1e-3")
    print(f"[22 zamba2 parity] reduced zamba2 (2 layers, d 256, 4 heads of 64, S 160) f32, "
          f"card vs CPU plain: logits {logit_rel:.3g} (limit 1e-4), loss {loss_rel:.3g} "
          f"(limit 1e-5), gradients worst leaf {worst:.3g} (limit 1e-4), f32 flash launches "
          f"{ran}; 4 layers (attention every 2), 130 decode steps on the card against its "
          f"forward: max|diff| {(dec - full).abs().max().item():.3g} (atol = rtol = 1e-3, the "
          f"reference's) ({time.perf_counter() - t_phase:.0f} s for phase 22 on {smi})",
          flush=True)
    return report, launches


def audio_vlm_phase(torch, np, check, compare, seed: int, dev, smi: str):
    """Phase 23 -> (flash's reports at whisper's and internvl2's shapes, its
    launches)."""
    import contextlib
    import io

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import add_modality_stubs, to_device
    from repro_torch.examples import serve_multiarch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.context import ParallelContext
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    ctx = ParallelContext(param_dtype=bf16, compute_dtype=bf16, device="cuda")
    rng = np.random.default_rng(seed + 23)
    reports, launches = {}, 0
    for arch, S, want in (
            ("whisper-small", 448, {((4, 12, 1500, 64), (4, 12, 1500, 64), False): 12,
                                    ((4, 12, 448, 64), (4, 12, 448, 64), True): 12,
                                    ((4, 12, 448, 64), (4, 12, 1500, 64), False): 12}),
            ("internvl2-2b", 512, {((4, 16, 768, 128), (4, 8, 768, 128), True): 24})):
        cfg = get_config(arch)
        model = build_model(cfg, ctx)
        params = model.init(seed)
        n_params = sum(p.numel() for p in leaves(params))
        toks = rng.integers(0, cfg.vocab, (4, S)).astype(np.int32)
        batch = to_device(add_modality_stubs({"tokens": toks, "labels": toks}, cfg,
                                             rng_seed=seed), dev)
        batch.pop("labels")
        with Recorder(fa_ops, "flash_attention", key=_flash_key) as log_fa, torch.no_grad():
            model.forward(params, batch, last_only=True)                   # capture
        prefill_s, logits, c_pre, gen_s, ids, c_gen = _serve_figures(
            torch, np, model, params, batch, cfg.vocab, rng)
        check(log_fa.counts == want and c_pre["flash_attention"] == sum(want.values()),
              f"{arch} prefill flash calls {log_fa.counts}, launches "
              f"{c_pre['flash_attention']}: want {want}")
        check(tuple(logits.shape) == (4, 1, cfg.vocab) and bool(torch.isfinite(logits).all()),
              f"{arch} prefill logits {tuple(logits.shape)} not finite or misshapen")
        check(ids.shape == (4, 8) and ((ids >= 0) & (ids < cfg.vocab)).all(),
              f"{arch} generated ids {ids.shape}")
        launches += c_pre["flash_attention"] + c_gen["flash_attention"]
        inputs = ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items())
        print(f"[23 {arch}] bf16, {n_params / 1e9:.3f} B params: prefill ({inputs}; "
              f"last_only) {prefill_s * 1e3:.1f} ms, flash launches by (q, k/v, causal) "
              f"{ {str(k): c for k, c in log_fa.counts.items()} }; generate 4 requests, "
              f"prompt 8, 8 new tokens, greedy: {gen_s:.2f} s, {ids.size / gen_s:.1f} new "
              f"tokens/s (warm-up runs excluded)"
              + ("; the engine decodes against zero encoder states, as the reference's does"
                 if cfg.arch_type == "audio" else "") + f"; on {smi}", flush=True)
        for key, call in log_fa.first.items():
            q, k, v, kw = call
            label = f"{arch} q {key[0]} k/v {key[1]} {'causal' if key[2] else 'non-causal'}"
            reports[label] = dict(flash_report(torch, fa_ops, compare, q, k, v, kw, label),
                                  launches=log_fa.counts[key])
        del model, params, logits, log_fa, batch
        torch.cuda.empty_cache()

    # ---- 23c. gates: reduced whisper (150 frames) and internvl2, card vs CPU -------
    parts = []
    for arch, kw in (("whisper-small", dict(n_audio_frames=150)), ("internvl2-2b", {})):
        small = dataclasses.replace(get_config(arch).reduced(), **kw)
        loss_rel, worst, logit_rel = _grads_card_vs_cpu(torch, small, seed, 160)
        check(loss_rel <= 1e-4 and worst <= 1e-4 and logit_rel <= 1e-4,
              f"reduced {arch} card vs CPU: logits {logit_rel:.3g}, loss {loss_rel:.3g}, "
              f"grads {worst:.3g}")
        parts.append(f"{arch}: logits {logit_rel:.3g}, loss {loss_rel:.3g}, gradients worst "
                     f"leaf {worst:.3g}")
    # the example, on the card, with the runtime and arbiter demos
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        served = serve_multiarch.main(["--adaptive"])
    lines = out.getvalue().strip().splitlines()
    check(lines[-1].startswith("[serve] all families served") and len(served) == 4,
          f"serve_multiarch on the card ended with {lines[-1:]}")
    print(f"[23 parity] reduced configs (2 layers, d 256, S 160; whisper with 150 frames) "
          f"f32, card vs CPU plain: " + "; ".join(parts) + " (limits 1e-4); serve_multiarch "
          f"--adaptive on the card: " + " | ".join(lines[-3:]) +
          f" ({time.perf_counter() - t_phase:.0f} s for phase 23 on {smi})", flush=True)
    return reports, launches


def _attn_vjp(torch, fn, q, k, v, g, kw):
    """(dq, dk, dv) of ``fn`` in float32 at (q, k, v) for the cotangent g."""
    with torch.enable_grad():
        live = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
        return torch.autograd.grad(fn(*live, **kw), live, g.float())


def nontpu_phase(torch, np, check, compare, seed: int, dev, smi: str):
    """Phase 24 -> (flash launches of smollm's 4 x 4096 steps, flash's report
    at their shape, the quickstart's launches, the backward's figures).

    The reference's non-TPU paths in plain torch: ``chunked_attention`` and,
    through its VJP, the flash kernel's backward; ``grouped_ffn_scan`` and
    ``grouped_ffn_dense``; the quickstart."""
    import io

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.examples import quickstart
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.grouped_ffn import ops as ffn_ops
    from repro_torch.launch.kernel_times import time_ms
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.registry import build_model
    from repro_torch.roofline.analysis import PEAK_FLOPS
    from repro_torch.optim import adamw
    from repro_torch.sharding.context import ParallelContext
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import leaves, map_tree

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 24)

    def rel(a, b) -> float:
        b = b.float().cpu()
        return ((a.float().cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()

    # ---- 24a. chunked_attention on the card against the CPU ------------------------
    cases = {          # (b, h, hkv, sq, sk, causal, window, q_offset, chunk), head dim 64
        "Sk 1000 over chunks of 256 (pad)": (2, 8, 8, 96, 1000, True, None, 904, 256),
        "window 300": (2, 8, 4, 96, 1000, True, 300, 904, 256),
        "GQA 4:1": (2, 8, 2, 96, 1024, True, None, 928, 256),
        "q_offset 200, not causal": (2, 8, 8, 96, 700, False, None, 200, 256),
    }
    parts, worst = [], {"f32": 0.0, "bf16": 0.0}
    for label, (b, h, hkv, sq, sk, causal, window, q_offset, chunk) in cases.items():
        q, k, v = (torch.as_tensor(rng.normal(size=sh), dtype=torch.float32)
                   for sh in ((b, h, sq, 64), (b, hkv, sk, 64), (b, hkv, sk, 64)))
        kw = dict(causal=causal, window=window, q_offset=q_offset, chunk=chunk)
        for dt, tol in (("f32", 1e-5), ("bf16", 1e-2)):
            dtype = torch.float32 if dt == "f32" else torch.bfloat16
            qq, kk, vv = (t.to(dtype) for t in (q, k, v))
            err = rel(fa_ops.chunked_attention(qq.to(dev), kk.to(dev), vv.to(dev), **kw),
                      fa_ops.chunked_attention(qq, kk, vv, **kw))
            worst[dt] = max(worst[dt], err)
            check(err <= tol, f"chunked_attention {label} {dt}: card vs CPU {err:.3g} > {tol:g}")
    # attention() below 128 queries over more than 4096 keys: chunked_attention
    q, k, v = (torch.as_tensor(rng.normal(size=sh), dtype=torch.float32)
               for sh in ((2, 8, 64, 64), (2, 2, 4500, 64), (2, 2, 4500, 64)))
    kw = dict(causal=True, window=None, q_offset=4500 - 64)
    reset_launch_counts()
    with Recorder(fa_ops, "chunked_attention", keep=1) as rec_ca:
        out = fa_ops.attention(q.to(dev), k.to(dev), v.to(dev), **kw)
    torch.cuda.synchronize()
    took = len(rec_ca.calls) == 1 and not any(launch_counts().values())
    check(took, "attention() at Sq 64 over Sk 4500 on the card did not take chunked_attention")
    err_att = rel(out, fa_ops.chunked_attention(q, k, v, **kw))
    check(err_att <= 1e-5, f"attention() Sq 64 over Sk 4500: card vs CPU {err_att:.3g}")
    print(f"[24a chunked] chunked_attention card vs CPU (plain torch both), head dim 64, "
          f"{'; '.join(cases)}: worst f32 {worst['f32']:.3g} (limit 1e-5), bf16 "
          f"{worst['bf16']:.3g} (limit 1e-2; each relative to the CPU's largest value); "
          f"attention() at q [2, 8, 64, 64] over k/v [2, 2, 4500, 64] took "
          f"{'chunked_attention, no kernel launched' if took else 'ANOTHER ROUTE'}, card vs "
          f"CPU {err_att:.3g}", flush=True)

    # ---- 24b. the flash backward: chunked_attention's VJP --------------------------
    bwd = {}
    # smollm's heads at one chunk and at two; paper-moe-8e's 512 keys, one chunk of 512
    for h, hkv, sk, dh in ((9, 3, 2048, 64), (9, 3, 4096, 64), (32, 8, 512, 128)):
        q = torch.as_tensor(rng.normal(size=(4, h, sk, dh)), dtype=torch.float32)
        k, v = (torch.as_tensor(rng.normal(size=(4, hkv, sk, dh)), dtype=torch.float32)
                for _ in range(2))
        g = torch.as_tensor(rng.normal(size=q.shape), dtype=torch.float32)
        kw = dict(causal=True, window=None, q_offset=0)
        card = [t.to(dev) for t in (q, k, v, g)]
        live = [t.clone().requires_grad_(True) for t in card[:3]]
        got = torch.autograd.grad(fa_ops.flash_attention(*live, **kw), live, card[3])
        want = fa_ops.flash_attention_bwd(q, k, v, g, **kw)                     # the CPU
        plain = _attn_vjp(torch, fa_ops.mha_ref, *card, kw)                      # mha_ref's VJP
        e_cpu = max(rel(a, b) for a, b in zip(got, want))
        e_mha = max(rel(a, b) for a, b in zip(got, plain))
        shape = f"[4, {h}, {sk}, {dh}] over {hkv} heads"
        check(e_cpu <= 1e-4 and e_mha <= 1e-4,
              f"flash backward at {shape}: card vs CPU {e_cpu:.3g}, vs mha_ref's VJP "
              f"{e_mha:.3g} (limit 1e-4)")
        del got, want, plain, live
        qb, kb, vb, gb = (t.to(torch.bfloat16) for t in card)
        ms_chunked = time_ms(lambda: fa_ops.flash_attention_bwd(qb, kb, vb, gb, **kw), 3)
        ms_mha = time_ms(lambda: _attn_vjp(torch, fa_ops.mha_ref, qb, kb, vb, gb, kw), 3)
        flops = 5 * 2 * 4 * h * sk * sk * dh          # S recomputed, dV, dP, dQ, dK
        bwd[shape] = dict(chunks=-(-sk // fa_ops._CHUNK), chunked_ms=ms_chunked,
                          mha_ref_ms=ms_mha, err_cpu=e_cpu, err_mha_ref=e_mha,
                          bound_f32_ms=flops / PEAK_FLOPS["f32"] * 1e3,
                          bound_bf16_ms=flops / PEAK_FLOPS["bf16"] * 1e3)
        del q, k, v, g, card, qb, kb, vb, gb
        torch.cuda.empty_cache()
    print("[24b flash bwd] " + "; ".join(
        f"{shape} ({r['chunks']} chunk{'s' * (r['chunks'] > 1)}), causal, "
        f"f32: card vs CPU {r['err_cpu']:.3g}, vs mha_ref's VJP {r['err_mha_ref']:.3g} "
        f"(limit 1e-4); bf16 inputs, a call: chunked_attention's VJP {r['chunked_ms']:.2f} ms, "
        f"mha_ref's VJP {r['mha_ref_ms']:.2f} ms (bound, 5 products, all keys: "
        f"{r['bound_bf16_ms']:.3f} ms bf16, {r['bound_f32_ms']:.3f} ms f32)"
        for shape, r in bwd.items()) + f"; on {smi}", flush=True)

    # ---- 24c. smollm-135m trains 2 steps at 4 x 4096 ------------------------------
    bf16 = torch.bfloat16
    ctx = ParallelContext(param_dtype=bf16, compute_dtype=bf16, device="cuda")
    cfg = get_config("smollm-135m")
    model = build_model(cfg, ctx)
    params = model.init(seed)
    n_params = sum(p.numel() for p in leaves(params))
    state = adamw.init(params)
    step = make_train_step(model, adamw.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=100))
    B, S = 4, 4096
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=seed))
    batches = [to_device(data.batch(i), dev) for i in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    walls, bwd_ms, ms = [], [], []
    rec_fa = Recorder(fa_ops, "flash_attention", keep=1)   # layer 0's call of step 0
    for i in range(2):
        with EventTimer(torch, fa_ops, "flash_attention_bwd") as t_fa, \
                (rec_fa if i == 0 else contextlib.nullcontext()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batches[i])
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        bwd_ms.append(t_fa.total_ms())
        ms.append(m)
    fa_train = launch_counts()["flash_attention"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(m["loss"]) for m in ms]
    norms = [float(m["grad_norm"]) for m in ms]
    check(bool(np.isfinite(losses).all() and np.isfinite(norms).all()),
          f"smollm-135m at 4 x 4096: losses {losses} or norms {norms} not finite")
    check(fa_train == 2 * cfg.n_layers,
          f"smollm-135m at 4 x 4096 launched flash {fa_train} times, want {2 * cfg.n_layers}")
    print(f"[24c smollm 4k] {cfg.name} bf16, {n_params / 1e6:.2f} M params, batch {B} x {S} "
          f"(the reference's train_4k length; its batch 256 cut to 4 for one card), AdamW, "
          f"2 steps: {walls[0]:.1f} ms (first, allocations included) and {walls[1]:.1f} ms, "
          f"{B * S / walls[1] * 1e3:.0f} tokens/s at the second; the attention backward "
          f"(chunked_attention's VJP, 2 chunks, f32) {bwd_ms[0]:.1f} and {bwd_ms[1]:.1f} ms a "
          f"step over {cfg.n_layers} layers; flash launches {fa_train}; peak memory "
          f"{peak_gb:.2f} GB; losses {[round(x, 4) for x in losses]}, grad_norm "
          f"{[round(x, 4) for x in norms]}; on {smi}", flush=True)
    del params, state, model, step, batches, ms, m
    torch.cuda.empty_cache()
    q, k, v, kw = rec_fa.calls[0]
    with torch.no_grad():
        fa_4k = flash_report(torch, fa_ops, compare, q.detach(), k.detach(), v.detach(), kw,
                             "at smollm's 4 x 4096 (phase 24c)")
    del rec_fa, q, k, v
    torch.cuda.empty_cache()

    # ---- 24d. grouped_ffn_scan and grouped_ffn_dense on the card against the CPU ----
    n, e, d, f = 4096, 8, 256, 512
    x = torch.as_tensor(rng.normal(size=(n, d)), dtype=torch.float32)
    wg, wu, wd = (torch.as_tensor(rng.normal(size=sh) * 0.05, dtype=torch.float32)
                  for sh in ((e, d, f), (e, d, f), (e, f, d)))
    p = np.array([0.3] + [0.7 / (e - 1)] * (e - 1))
    eid = torch.as_tensor(np.where(rng.random(n) < 0.05, -1, rng.choice(e, size=n, p=p)))
    parts = []
    for name, fn, kw in (("scan", ffn_ops.grouped_ffn_scan, dict(block_tokens=64)),
                         ("dense", ffn_ops.grouped_ffn_dense, dict(block_tokens=64)),
                         ("dense cap 1.0", ffn_ops.grouped_ffn_dense,
                          dict(block_tokens=64, cap_factor=1.0))):
        want = fn(x, eid, wg, wu, wd, **kw)
        got = fn(*(t.to(dev) for t in (x, eid, wg, wu, wd)), **kw)
        zero_w, zero_g = (want == 0).all(1), (got.cpu() == 0).all(1)
        err = rel(got, want)
        same = bool(torch.equal(zero_w, zero_g))
        check(same and err <= 1e-5, f"grouped_ffn_{name.split()[0]} ({name}) card vs CPU: "
              f"dropped rows {'equal' if same else 'DIFFER'}, values {err:.3g} (limit 1e-5)")
        parts.append(f"{name}: {int(zero_w.sum()) - int((eid < 0).sum())} rows dropped on "
                     f"both, values {err:.3g}")
    print(f"[24d ffn paths] x [{n}, {d}], E {e} (expert 0 takes 0.3 of the rows), F {f}, "
          f"blocks of 64, f32, card vs CPU (plain torch both): " + "; ".join(parts)
          + " (limit 1e-5 of the CPU's largest value)", flush=True)

    # ---- 24e. the port's quickstart on the card --------------------------------------
    def run(device):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            logits = quickstart.main(["--device", device])
        # the recorder's correlation id counts recorders in the process
        return [ln.split("corr=")[0] + ln.split(";", 1)[1] if "corr=" in ln else ln
                for ln in buf.getvalue().splitlines()], logits

    reset_launch_counts()
    with Recorder(moe_mod, "forward", keep=1) as rec_qs:
        card, card_logits = run("cuda")
    qs_launches = {k: c for k, c in launch_counts().items() if c}
    cpu, _ = run("cpu")
    check(card == cpu, "quickstart on the card printed other figures than on the CPU")
    check(qs_launches.get("grouped_ffn_blocked_f32", 0) > 0 and
          qs_launches.get("token_gather", 0) > 0,
          f"the quickstart's granite forward launched {qs_launches}")
    # each device draws its own weights from the seed: the CPU takes the card's
    params, tokens, cfg = rec_qs.calls[0][:3]
    want, _ = build_model(cfg, ParallelContext(device="cpu")).forward(
        map_tree(lambda t: t.cpu(), params), {"tokens": tokens.cpu()})
    logit_err = rel(card_logits, want)
    check(card_logits.shape == want.shape and logit_err <= 1e-4,
          f"the quickstart's granite logits card vs CPU: {logit_err:.3g} (limit 1e-4)")
    print(f"[24e quickstart] python -m repro_torch.examples.quickstart on the card: "
          f"{len(card)} lines, {'equal to the CPU run' if card == cpu else 'NOT the CPU run'}"
          f" (the correlation id aside); its granite forward (reduced, f32) launched "
          f"{qs_launches}, logits {tuple(card_logits.shape)} card vs CPU plain {logit_err:.3g} "
          f"on its weights (limit 1e-4 of the CPU's largest: f32 sums in other orders); the "
          f"sweep's last row: {[ln for ln in card if ln.startswith('   0.900')]}", flush=True)
    print(f"[24 non-TPU paths] ({time.perf_counter() - t_phase:.0f} s for phase 24 on {smi})",
          flush=True)
    return fa_train, fa_4k, qs_launches, bwd


def dist_phase(torch, np, check, seed: int, dev, smi: str, phase4_logits, phase7):
    """Phase 25: the executor across processes, in an NCCL world of
    ``device_count()`` processes; -> the MoE path's launches in 25b."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.dataplane import NimbleAllToAll, ref_all_to_allv
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import dist_checks, selftest
    from repro_torch.launch.dist import local_world
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw
    from repro_torch.sharding.context import ParallelContext
    from repro_torch.train.step import make_train_step

    t_phase = time.perf_counter()
    procs = torch.cuda.device_count()
    cfg = get_config("paper-moe-8e")
    if procs != 1:
        # each process needs its own card; this script drives one
        print(f"[25 dist] {procs} cards: 25a-b run in this process's world of one, "
              f"25c across all {procs}", flush=True)
    out = {}
    with local_world("nccl"):
        mesh = make_test_mesh(1, 1)
        group = mesh.get_group("model")

        # ---- 25a. the dataplane through a model group ----------------------------
        shapes = [("phase 3", dict(n=8, G=4, C=16, E=32, dtype="f32", chunk_bytes=32 * 4)),
                  ("phase 3, 4 MiB chunks", dict(n=8, G=4, C=16, E=32, dtype="f32",
                                                  chunk_bytes=4 << 20)),
                  ("paper-moe-8e dispatch", dict(n=8, G=4, C=8, E=16 * cfg.d_model,
                                                 dtype="bf16",
                                                 chunk_bytes=16 * cfg.d_model * 2))]
        for label, kw in shapes:
            x_all, counts = dist_checks.exchange_inputs(kw["n"], kw["C"], kw["E"], 0,
                                                        kw["dtype"])
            yref, rref = ref_all_to_allv(x_all, counts)
            reset_launch_counts()
            got = dist_checks.exchange(group, "cuda", seed=0, **kw)
            torch.cuda.synchronize()
            tg_dist = launch_counts()["token_gather"]
            parts, tg_stacked = [], 0
            for mode in dist_checks.MODES:
                comm = NimbleAllToAll(kw["n"], kw["G"], max_chunks=kw["C"], mode=mode,
                                      chunk_bytes=float(kw["chunk_bytes"]))
                xt = torch.as_tensor(x_all, device=dev).to(dist_checks.DTYPES[kw["dtype"]])
                ct = torch.as_tensor(counts, device=dev)
                reset_launch_counts()
                y, r = comm(xt, ct)
                torch.cuda.synchronize()
                tg_st = launch_counts()["token_gather"]
                tg_stacked += tg_st
                plan = dist_checks.plan_digest(comm.plan_from_counts(ct))
                g = got[mode]
                exact = (np.array_equal(g["y"], y.float().cpu().numpy())
                         and np.array_equal(g["recv"], r.cpu().numpy())
                         and np.array_equal(g["y"], yref) and np.array_equal(g["recv"], rref)
                         and g["plan"] == plan)
                check(exact, f"25a {label} {mode}: the executor through a group != the "
                             f"stacked executor or the oracle")
                msgs = [m for rnd in g["messages_per_hop"] for m in rnd]
                check(max(msgs, default=0) == 0, f"25a {label} {mode}: messages at one process")
                parts.append(f"{mode}: {'exact' if exact else 'WRONG'}, messages a hop "
                             f"{g['messages_per_hop']}, token_gather launches stacked "
                             f"{tg_st}")
                del y, r, xt
            print(f"[25a dist dataplane] {label} [{kw['n']}, {kw['n']}, {kw['C']}, {kw['E']}] "
                  f"{kw['dtype']}, 1 process of 8 ranks: {'; '.join(parts)}; token_gather "
                  f"launches through the group, all three modes {tg_dist}", flush=True)
            check(tg_dist == tg_stacked, f"25a {label}: token_gather launches through the "
                                         f"group {tg_dist} != the stacked {tg_stacked}")
            del x_all, yref, got
        torch.cuda.empty_cache()

        # ---- 25b. paper-moe-8e at full width through a mesh -------------------------
        bf16 = torch.bfloat16
        ctx = ParallelContext(mesh=mesh, ep_size=8, group_size=4, moe_mode="nimble",
                              param_dtype=bf16, compute_dtype=bf16, device="cuda")
        model = build_model(cfg, ctx)
        params = model.init(seed)
        prompts = torch.as_tensor(np.random.default_rng(seed).integers(0, cfg.vocab, (4, 512)),
                                  device=dev)
        reset_launch_counts()
        with torch.no_grad():
            logits, _ = model.forward(params, {"tokens": prompts}, last_only=True)
        torch.cuda.synchronize()
        same_logits = torch.equal(logits, phase4_logits)
        check(same_logits, "25b prefill logits through the mesh != phase 4's (bit for bit)")
        state = adamw.init(params)
        make_step = make_train_step(model, adamw.AdamWConfig(lr=3e-4, warmup_steps=20,
                                                             total_steps=100))
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=512, global_batch=4, seed=seed))
        batches = [to_device(data.batch(i), dev) for i in range(4)]
        params, state, m0 = make_step(params, state, batches[0])
        losses, norms, walls = [float(m0["loss"])], [float(m0["grad_norm"])], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_gb = torch.cuda.memory_allocated() / 1e9
        split = {k: 0.0 for k in ("forward", "backward", "optimizer")}
        for i in (1, 2, 3):
            stats, times = {}, {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = make_step(params, state, batches[i], stats=stats, times=times)
            wall = time.perf_counter() - t0                    # the step ends in a sync
            walls.append(wall * 1e3)
            for k in split:
                split[k] += times[k] / wall / 3
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        counts = launch_counts()
        for kname in MOE_KERNELS:
            check(counts[kname] > 0, f"25b: {kname} never launched through the mesh")
            out[kname] = counts[kname]
        same_train = losses == phase7["losses"] and norms == phase7["norms"]
        check(same_train, f"25b losses {losses} / norms {norms} through the mesh != phase "
                          f"7's {phase7['losses']} / {phase7['norms']}")
        step_ms = float(np.mean(walls))
        print(f"[25b dist model] {cfg.name} bf16 full width, mesh (data 1, model 1) of "
              f"NCCL processes, ep 8 in groups of 4: prefill logits "
              f"{'= phase 4 bit for bit' if same_logits else '!= phase 4'}; losses "
              f"{[round(x, 4) for x in losses]} and grad norms "
              f"{[round(x, 4) for x in norms]} {'= phase 7 bit for bit' if same_train else '!= phase 7'}; "
              f"step {', '.join(f'{w:.1f}' for w in walls)} ms (mean {step_ms:.1f}) against "
              f"phase 7's {phase7['step_ms']:.1f} ms in this call; forward, backward "
              f"(the gradients' all_reduce in it), optimizer "
              f"{split['forward']:.3f}, {split['backward']:.3f}, {split['optimizer']:.3f} of "
              f"the step (phase 7: " + ", ".join(f"{phase7['share'][k]:.3f}" for k in split)
              + f"); peak memory {peak_gb:.2f} GB, {base_gb:.2f} held before the steps "
              f"(phase 7: {phase7['peak_gb']:.2f}, {phase7['base_gb']:.2f}); launches in "
              f"prefill + 4 steps {counts}; on {smi}", flush=True)
        del model, params, state, logits, batches, m, m0
        torch.cuda.empty_cache()

    # ---- 25c. the selftest across processes ----------------------------------------------
    rc = selftest.main(["--procs", str(procs)])
    check(rc == 0, f"selftest --procs {procs} returned {rc}")
    print(f"[25c dist selftest] selftest --procs {procs} (spawned, NCCL) -> {rc}; with "
          f"{procs} card{'s' if procs > 1 else ''} "
          + ("no hop crossed a process: tests/test_torch_dist.py holds the exchange between "
             "processes on the CPU (gloo, P = 2, 4, 8)" if procs == 1 else
             f"the hops crossed {procs} processes")
          + f" ({time.perf_counter() - t_phase:.0f} s for phase 25 on {smi})", flush=True)
    return out


def roofline_phase(torch, np, check, seed: int, dev, smi: str, phase7_ms: float):
    """Phase 26: the dry run on the host, the counter around real steps on the
    card, and the kernels' reports against their launch counts."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw
    from repro_torch.roofline.analysis import (
        HBM_BW,
        PEAK_FLOPS,
        analyze,
        count_params,
        least_train_step,
        model_flops,
    )
    from repro_torch.roofline.hlo_cost import CostCounter
    from repro_torch.sharding.context import ParallelContext
    from repro_torch.train.step import make_train_step

    t_phase = time.perf_counter()
    # ---- 26a. the dry run, fake tensors on this machine's host ------------------
    for (arch, shape), want in DRYRUN_PINNED.items():
        rec = dryrun.run_one(arch, shape, multi_pod=False)
        print(f"[26a dryrun] {dryrun.format_line(rec)} n_params {rec.get('n_params')} "
              f"model_flops_total {rec.get('roofline', {}).get('model_flops_total')} "
              f"bytes_per_device {rec.get('bytes_per_device')}", flush=True)
        ok = rec["status"] == "ok"
        check(ok, f"dryrun {arch} x {shape}: {rec['status']} {rec.get('error', '')}")
        if ok:
            got = dict(n_params=rec["n_params"],
                       model_flops_total=rec["roofline"]["model_flops_total"])
            check(got == want, f"dryrun {arch} x {shape}: {got}, the CPU tests pin {want}")
    # train_4k on 2 x 16 x 16: 256 sequences over pod x data, replicated over model
    rec = dryrun.run_one("smollm-135m", "train_4k", multi_pod=True)
    print(f"[26a dryrun] 2x16x16 {dryrun.format_line(rec)} bytes_per_device "
          f"{rec.get('bytes_per_device')}", flush=True)
    check(rec["status"] == "ok", f"dryrun smollm-135m x train_4k on 2x16x16: "
                                 f"{rec['status']} {rec.get('error', '')}")

    # ---- 26b-c. the counter around one real step on the card ----------------------
    bf16 = torch.bfloat16
    cases = [("paper-moe-8e", ParallelContext(ep_size=8, group_size=4, moe_mode="nimble",
                                              param_dtype=bf16, compute_dtype=bf16,
                                              device="cuda"), 4, 512, "phase 7"),
             ("smollm-135m", ParallelContext(param_dtype=bf16, compute_dtype=bf16,
                                             device="cuda"), 4, 2048, "phase 19")]
    for arch, ctx, B, S, where in cases:
        cfg = get_config(arch)
        model = build_model(cfg, ctx)
        params = model.init(seed)
        state = adamw.init(params)
        step = make_train_step(model, adamw.AdamWConfig(lr=3e-4, warmup_steps=20,
                                                        total_steps=100))
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=seed))
        batches = [to_device(data.batch(i), dev) for i in range(5)]
        params, state, _ = step(params, state, batches[0])           # warm-up
        params, state, rows = _step_rows(step, params, state, batches)
        step_ms = float(np.mean([r["wall"] for r in rows])) * 1e3
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        launches0 = dict(_build.LAUNCHES)
        with CostCounter() as counter:
            params, state, _ = step(params, state, batches[4])
            torch.cuda.synchronize()
        alloc_peak = torch.cuda.max_memory_allocated() - held
        cost = counter.result()
        roof = analyze(cost, 1, 0.0)
        bound_ms = roof.bound_s * 1e3
        # the least a step needs however the port computes it (6 N D at the
        # bf16 peak; a fused AdamW's traffic), beside the op-by-op bound
        least_c, least_m = least_train_step(
            model_flops(cfg, count_params(params), B * S, "train"), params, state)
        least_ms = max(least_c, least_m) * 1e3
        temp_err = abs(counter.temp_peak - alloc_peak) / max(alloc_peak, 1)
        check(temp_err <= 0.10, f"26b {arch}: the counter's live peak {counter.temp_peak} B "
                                f"against the allocator's {alloc_peak} B ({temp_err:.3f} off)")
        print(f"[26b roofline] {arch} train step {B} x {S} bf16 on the card: FLOPs "
              f"{ {k: f'{v:.4e}' for k, v in cost['flops_by_dtype'].items()} }, bytes "
              f"{cost['bytes']:.4e}, compute {roof.compute_s * 1e3:.3f} ms (bf16 at "
              f"{PEAK_FLOPS['bf16'] / 1e12:.0f}, f32 at {PEAK_FLOPS['f32'] / 1e12:.0f} "
              f"TFLOP/s), memory {roof.memory_s * 1e3:.3f} ms (at {HBM_BW / 1e12:.2f} TB/s); "
              f"op-by-op bound {bound_ms:.3f} ms ({roof.dominant}); least (6 N D at the bf16 "
              f"peak {least_c * 1e3:.3f} ms, a fused AdamW's traffic {least_m * 1e3:.3f} ms) "
              f"{least_ms:.3f} ms; the step {step_ms:.1f} ms (mean of 3 timed outside the "
              f"counter, {', '.join(f'{r['wall'] * 1e3:.1f}' for r in rows)}"
              + (f"; {where}'s {phase7_ms:.1f}" if arch == "paper-moe-8e" else "")
              + f"): op-by-op bound / step {bound_ms / step_ms:.3f}, least / step "
              f"{least_ms / step_ms:.3f}; live peak {counter.temp_peak / 1e9:.3f} GB "
              f"counted, {alloc_peak / 1e9:.3f} GB by the allocator beyond the {held / 1e9:.3f} "
              f"GB held ({temp_err:.4f} off, limit 0.10); kernels {cost['kernels']}; on {smi}",
              flush=True)
        # ---- 26c. every launch reported --------------------------------------------
        delta = {k: _build.LAUNCHES[k] - launches0[k] for k in _build.LAUNCHES
                 if _build.LAUNCHES[k] != launches0[k]}
        reported = {k: v["launches"] for k, v in cost["kernels"].items()}
        check(cost["uncounted"] == 0, f"26c {arch}: {cost['uncounted']} launches unreported")
        check(reported == delta, f"26c {arch}: reported launches {reported}, LAUNCHES "
                                 f"delta {delta}")
        print(f"[26c launches] {arch}: uncounted {cost['uncounted']}, reported {reported}, "
              f"LAUNCHES delta {delta}", flush=True)
        del model, params, state, batches, counter
        torch.cuda.empty_cache()
    print(f"[26 roofline] ({time.perf_counter() - t_phase:.0f} s for phase 26 on {smi})",
          flush=True)


def analysis_phase(torch, check, seed: int, smi: str):
    """Phase 27: the static checker over this checkout, then the card's own
    report of a train step's and a decode step's syncs against its
    ``host-sync`` inventory."""
    from repro_torch.analysis import (
        AnalysisEngine,
        RULES,
        build_retrace_inventory,
        default_lock_path,
        default_retrace_lock_path,
        load_baseline,
        lock_is_fresh,
        retrace_lock_is_fresh,
    )
    from repro_torch.analysis.engine import build_contexts
    from repro_torch.analysis.rules import HostSyncRule
    from repro_torch.launch import sync_audit

    t_phase = time.perf_counter()
    # ---- 27a. the checker -------------------------------------------------------
    pkg = str(ROOT / "src" / "repro_torch")
    contexts = build_contexts([pkg], rel_to=str(ROOT / "src"))
    engine = AnalysisEngine(RULES, load_baseline())
    report = engine.run(contexts, root=pkg)
    rule = next(r for r in engine.rules if isinstance(r, HostSyncRule))
    fresh = (lock_is_fresh(default_lock_path(), contexts),
             retrace_lock_is_fresh(default_retrace_lock_path(), engine.program, rule.analysis))
    inv = build_retrace_inventory(engine.program, rule.analysis)
    baselined = {}
    for f in report.baselined:
        baselined[f.rule] = baselined.get(f.rule, 0) + 1
    check(report.clean, f"27a: {len(report.findings)} live finding(s): "
                        + "; ".join(str(f) for f in report.findings[:3]))
    check(all(fresh), f"27a: locks fresh (schemas, retrace) {fresh}")
    print(f"[27a analysis] {report.files} files, {len(report.findings)} live finding(s) "
          f"{report.counts}, baselined by rule {baselined}, {len(report.suppressed)} "
          f"suppressed; locks fresh (schemas, retrace) {fresh}; host-sync inventory "
          f"{len(inv['sites'])} sites by class {inv['counts']}", flush=True)

    # ---- 27b. the card's own sync report against the inventory ------------------
    logs = sync_audit.audit(seed)
    listed = {(s["path"], s["function"].rsplit(".", 1)[-1]) for s in inv["sites"]}
    missing = sync_audit.unlisted(logs, listed)
    check(not missing, f"27b: syncs outside the host-sync inventory: {missing}")
    for name, log in logs.items():
        check(all(p != "<outside repro_torch>" for p, _, _ in log.sites + log.warned),
              f"27b {name}: a sync with no frame under src/repro_torch/ "
              f"({log.sites}, {log.warned})")
        check(log.warnings == len(log.sites) and not sync_audit.unmatched(log),
              f"27b {name}: {log.warnings} sync warnings against {len(log.sites)} traced "
              f"syncs; unmatched {sync_audit.unmatched(log)}")
        print(f"[27b sync audit] {sync_audit.describe(name, log)}", flush=True)
    print(f"[27b sync audit] unlisted sites {missing}; "
          f"({time.perf_counter() - t_phase:.0f} s for phase 27 on {smi})", flush=True)


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
    from repro_torch.roofline.analysis import kernel_bound
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
        bound_s, by = kernel_bound(*ffn_ops.ffn_cost(valid_rows, len(used), D, Fd, itemsize),
                                   dt_name)
        return bound_s * 1e3, by

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
    fa_bound_s, fa_bound_by = kernel_bound(*fa_ops.flash_cost(
        q.shape, k.numel(), kw["causal"], kw["window"], kw["q_offset"], k.shape[2],
        q.element_size()), "bf16")
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
        bound_ms=fa_bound_s * 1e3, bound_by=fa_bound_by,
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
    with scan_ffn():
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
          f"{small_err:.3g} (limit 1e-3: f32 sums in other orders; the CPU's FFN pinned "
          f"to the reference's drop-free scan, NIMBLE_FFN_IMPL=scan)", flush=True)

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
    report["token_scatter_add"], counts_train, phase7 = train_phases(
        torch, np, check, args.seed, dev, smi)
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

    # ---- 17. fault drills, serve control plane, flight recorder ------------------
    faults_serve_phase(torch, np, check, smi)
    print(f"[17 faults+serve] ({time.perf_counter() - t_start:.0f} s in all)", flush=True)

    # ---- 18. xlstm-125m training ------------------------------------------------------
    extra = {}
    mlstm_bwd, grad_launches, report["mlstm_cummax_bwd"], launches["mlstm_cummax_bwd"], \
        xlstm_state = xlstm_train_phase(torch, np, check, compare, args.seed, dev, smi)
    launches["mlstm_scan"] += grad_launches
    extra["mlstm_cummax_bwd"] = {k: report["mlstm_cummax_bwd"][k] for k in ("device_ms", "shape")}
    extra["mlstm_scan"] = {"launches_under_grad": grad_launches,
                           "backward_ms_per_step": mlstm_bwd["ms_per_step"],
                           "backward_bound_ms_per_step": mlstm_bwd["bound_ms_per_step"]}
    print(f"[18 xlstm train] ({time.perf_counter() - t_start:.0f} s in all)", flush=True)

    # ---- 19. the dense family: smollm-135m training, llama3-8b serving ----------------
    fa64, fa_dh64, fa_dh128 = dense_phase(torch, np, check, compare, args.seed, dev, smi)
    launches["flash_attention"] += fa_dh64 + fa_dh128
    extra["flash_attention"] = {
        "launches_head_dim_64": fa_dh64, "launches_head_dim_128_llama3": fa_dh128,
        "head_dim_64": {k: fa64[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                             "bound_by", "max_abs_err")}}
    print(f"[19 dense] ({time.perf_counter() - t_start:.0f} s in all)", flush=True)

    # ---- 20. checkpoints and the selftest -------------------------------------------
    ckpt_selftest_phase(torch, np, check, xlstm_state, smi)
    del xlstm_state
    print(f"[20 selftest] ({time.perf_counter() - t_start:.0f} s in all)", flush=True)

    # ---- 21-23. the remaining families: qwen3-moe and granite, zamba2, whisper and
    # internvl2 ---------------------------------------------------------------------------
    ffn_shapes, fa_shapes, tg_shapes, sa_shapes, moe_launches = moe_family_phase(
        torch, np, check, compare, args.seed, dev, smi)
    for kname, c in moe_launches.items():
        launches[kname] += c
    print(f"[21 moe] ({time.perf_counter() - t_start:.0f} s in all)", flush=True)
    fa_shapes["zamba2 causal 32 heads of 64"], z_launches = zamba2_phase(
        torch, np, check, compare, args.seed, dev, smi)
    print(f"[22 zamba2] ({time.perf_counter() - t_start:.0f} s in all)", flush=True)
    av_shapes, av_launches = audio_vlm_phase(torch, np, check, compare, args.seed, dev, smi)
    fa_shapes.update(av_shapes)
    launches["flash_attention"] += z_launches + av_launches
    extra["grouped_ffn_blocked"] = {"shapes": ffn_shapes}
    extra["token_gather"] = {"shapes": tg_shapes}
    extra["token_scatter_add"] = {"shapes": sa_shapes}
    extra["flash_attention"]["shapes"] = fa_shapes
    print(f"[23 audio+vlm] ({time.perf_counter() - t_start:.0f} s in all)", flush=True)

    # ---- 24. the reference's non-TPU paths: chunked attention (the flash backward),
    # the grouped FFN's scan and dense branches, the quickstart ----------------------
    fa_4k, fa_shapes["smollm 4 x 4096 causal 9 heads over 3"], qs_launches, fa_bwd = \
        nontpu_phase(torch, np, check, compare, args.seed, dev, smi)
    launches["flash_attention"] += fa_4k
    launches["token_gather"] += qs_launches.get("token_gather", 0)
    extra["flash_attention"]["launches_smollm_4x4096"] = fa_4k
    extra["flash_attention"]["backward_chunked_vjp"] = fa_bwd
    extra["grouped_ffn_blocked"]["launches_quickstart_f32"] = qs_launches.get(
        "grouped_ffn_blocked_f32", 0)
    print(f"[24 non-TPU paths] ({time.perf_counter() - t_start:.0f} s in all)", flush=True)

    # ---- 25. the executor across processes -------------------------------------------
    dist_launches = dist_phase(torch, np, check, args.seed, dev, smi, phase4_logits, phase7)
    for kname, c in dist_launches.items():
        launches[kname] += c
        extra.setdefault(kname, {})["launches_dist_executor"] = c
    print(f"[25 dist] ({time.perf_counter() - t_start:.0f} s in all)", flush=True)

    # ---- 26. the roofline and the dry run ------------------------------------------
    roofline_phase(torch, np, check, args.seed, dev, smi, phase7["step_ms"])
    print(f"[26 roofline] ({time.perf_counter() - t_start:.0f} s in all)", flush=True)

    # ---- 27. the static checker and the card's own sync report --------------------
    analysis_phase(torch, check, args.seed, smi)
    print(f"[27 analysis] ({time.perf_counter() - t_start:.0f} s in all)", flush=True)

    kernels = []
    for kname, (src, replaces) in KERNEL_META.items():
        r = report[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **extra.get(kname, {}),
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
