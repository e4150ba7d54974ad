#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one card, and check it.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA device.  It builds the
port's CUDA kernels from ``src/repro_torch/csrc``, then:

  1. prints the device, its power limit and the kernels' build time;
  2. holds each kernel against its plain PyTorch version on the inputs the
     main path gives it (bfloat16, and float32), and times the kernel, the
     plain version and one PyTorch library call as a yardstick;
  3. checks the stacked dataplane bit for bit against the numpy oracle in
     all three modes, and that the card's chunk plan equals the CPU's;
  4. prefills paper-moe-8e at full width (bf16, 8 EP ranks in 2 groups of 4,
     NIMBLE dispatch) for 4 requests of 512 tokens through
     ``Model.forward(last_only=True)``, and holds the logits against the
     single-device path on the same weights;
  5. answers 4 requests through ``ServeEngine.generate`` (prompt 8, 8 new
     tokens, greedy);
  6. checks that phases 4 and 5 launched every kernel.

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


def _time_ms(torch, fn, reps: int) -> float:
    fn()                                              # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


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
    # f32 expert-id sideband (calls 5-9)
    calls = rec_tg.calls
    for i, (x, idx, _) in enumerate(calls):
        out = token_gather(x, idx)
        compare("token_gather", f"{str(x.dtype)[6:]} call {i} {tuple(x.shape)}",
                out, token_gather_ref(x, idx), 0.0, "a copy is exact")
    x, idx, _ = calls[1]                                  # the first relay round
    tg = dict(
        ms=_time_ms(torch, lambda: token_gather(x, idx), 20),
        plain_ms=_time_ms(torch, lambda: token_gather_ref(x, idx), 20),
        library_ms=_time_ms(torch, lambda: torch.index_select(x, 0, idx), 20),
    )
    moved = 2 * idx.numel() * x.shape[1] * x.element_size() + idx.numel() * 8
    tg.update(bound_ms=moved / PEAK_BYTES_S * 1e3, bound_by="bytes",
              max_abs_err=(token_gather(x, idx).float()
                           - token_gather_ref(x, idx).float()).abs().max().item(),
              shape=f"x {tuple(x.shape)} bf16, idx [{idx.numel()}]")
    report["token_gather"] = tg

    # grouped_ffn_blocked: the prefill's sorted, padded expert rows
    x_pad, blk, wg, wu, wd, kw = rec_ffn.calls[0]
    bt = kw["block_tokens"]
    valid_rows = int((x_pad != 0).any(1).sum())
    used = sorted(set(blk.tolist()))
    D, Fd = x_pad.shape[1], wg.shape[2]

    def ffn_bound(dt_name, itemsize):
        flops = 6.0 * valid_rows * D * Fd
        nbytes = (2 * valid_rows * D + 3 * len(used) * D * Fd) * itemsize
        t_ops, t_bytes = flops / PEAK_FLOPS[dt_name], nbytes / PEAK_BYTES_S
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")

    segs = []                                 # contiguous per-expert row ranges
    blk_l = blk.tolist()
    for b, e in enumerate(blk_l):
        if segs and segs[-1][0] == e and segs[-1][2] == b * bt:
            segs[-1][2] = (b + 1) * bt
        else:
            segs.append([e, b * bt, (b + 1) * bt])

    def ffn_library(xx, g, u, d_):
        out = torch.empty_like(xx)
        for e, lo, hi in segs:
            xe = xx[lo:hi]
            out[lo:hi] = (F.silu(xe @ g[e]) * (xe @ u[e])) @ d_[e]
        return out

    def run_ffn(xx, g, u, d_):
        return ffn_ops.grouped_ffn_blocked(xx, blk, g, u, d_, block_tokens=bt)

    def plain_ffn(xx, g, u, d_):
        return ffn_ops.grouped_ffn_blocked_ref(xx, blk, g, u, d_, block_tokens=bt)

    y = run_ffn(x_pad, wg, wu, wd)
    ref = plain_ffn(x_pad, wg, wu, wd)
    err_bf16 = compare("grouped_ffn_blocked", "bf16", y, ref, 1e-2,
                       "both sum in f32 then round to bf16; 1 bf16 ulp is 2^-8 relative")
    gf = dict(
        ms=_time_ms(torch, lambda: run_ffn(x_pad, wg, wu, wd), 3),
        plain_ms=_time_ms(torch, lambda: plain_ffn(x_pad, wg, wu, wd), 3),
        library_ms=_time_ms(torch, lambda: ffn_library(x_pad, wg, wu, wd), 3),
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
    gf["f32_ms"] = _time_ms(torch, lambda: run_ffn(x32, *w32), 2)
    gf["f32_bound_ms"] = ffn_bound("f32", 4)[0]
    del w32, x32, y32
    report["grouped_ffn_blocked"] = gf

    # flash_attention: layer 0's prefill q, k, v
    q, k, v, kw = rec_fa.calls[0]
    o = fa_ops.flash_attention(q, k, v, **kw)
    err_fa = compare("flash_attention", "bf16", o, fa_ops.mha_ref(q, k, v, **kw), 1e-2,
                     "bf16 inputs and output; online vs two-pass softmax")
    q32, k32, v32 = q.float(), k.float(), v.float()
    fa_f32_err = compare("flash_attention", "f32", fa_ops.flash_attention(q32, k32, v32, **kw),
                         fa_ops.mha_ref(q32, k32, v32, **kw), 1e-5,
                         "f32 online vs two-pass softmax sums")
    B, H, Sq, Dh = q.shape
    mask = fa_ops._mask(Sq, k.shape[2], kw["causal"], kw["window"], kw["q_offset"], dev)
    pairs = int(mask.sum()) * B * H
    t_ops = 4.0 * Dh * pairs / PEAK_FLOPS["bf16"]
    t_bytes = 2 * (q.numel() * 2 + k.numel() + v.numel()) / PEAK_BYTES_S
    sdpa_kw = dict(attn_mask=mask, enable_gqa=True)
    kk, vv = k, v
    try:
        F.scaled_dot_product_attention(q, kk, vv, **sdpa_kw)
    except TypeError:                      # a torch without enable_gqa
        sdpa_kw.pop("enable_gqa")
        kk = k.repeat_interleave(H // k.shape[1], 1)
        vv = v.repeat_interleave(H // k.shape[1], 1)
    report["flash_attention"] = dict(
        ms=_time_ms(torch, lambda: fa_ops.flash_attention(q, k, v, **kw), 10),
        plain_ms=_time_ms(torch, lambda: fa_ops.mha_ref(q, k, v, **kw), 10),
        library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, kk, vv, **sdpa_kw), 10),
        max_abs_err=err_fa, f32_max_abs_err=fa_f32_err,
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        shape=f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 {kw}",
    )
    for kname, r in report.items():
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
    print(f"[5 generate] 4 requests, prompt 8, 8 new tokens, greedy: {gen_s:.2f} s, "
          f"{ids.size / gen_s:.1f} new tokens/s ({4 * 16 / gen_s:.1f} incl. the "
          f"prompt steps), dropped {int(gstats['dropped'])}, EP1 ids "
          f"{'equal' if np.array_equal(ids, ids1) else 'DIFFER'}; ids "
          f"{ids.tolist()}", flush=True)

    # ---- 6. kernels on the main path -----------------------------------------
    launches = {k: counts_prefill[k] + counts_gen[k] for k in counts_prefill}
    for kname, c in launches.items():
        check(c > 0, f"{kname} never launched on the main path")
    print(f"[6 kernels] launches prefill {counts_prefill}, generate {counts_gen} "
          f"({time.perf_counter() - t_start:.0f} s so far)", flush=True)

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
