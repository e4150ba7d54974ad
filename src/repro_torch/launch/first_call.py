"""A redesigned kernel's first call on the card: build, one tile, then the main shapes.

    python -m repro_torch.launch.first_call [--time]

builds the grouped FFN and flash kernels and prints nvcc's register,
shared-memory and spill report for each of their kernels.  Then it holds
the bf16 tensor-core routes against their plain versions, smallest first,
and stops at the first stage that fails (exit 1):

  1. one tile each: the FFN at M 64, D 128, F 128, E 1 (also with Wd = I,
     which shows pass 1 alone, and with X = I, which shows pass 2's
     weights), flash at one 64-row tile for Dh 64 and 128, causal or not;
  2. ragged shapes: the FFN at F 192 for block_tokens 64 and 128, with and
     without ``block_rows`` (padding rows exactly 0); flash with Sq 200 or
     130 and Sk 200 or 300 under the causal, window, offset and full masks.

Where a check fails it prints the error's map in 8 x 8 blocks, which shows
a misplaced operand (a wrong descriptor stride or swizzle) at a glance.
With ``--time`` it then times both kernels at the main path's shapes on
synthetic inputs (3731 tokens routed uniformly over 8 experts of
paper-moe-8e's widths; q [4, 32, 512, 128], k/v [4, 8, 512, 128], causal)
beside their PyTorch yardsticks, and the FFN's two passes under
``torch.profiler``.  Inputs are made from ``--seed``.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F_

from ..kernels import _build
from ..kernels.flash_attention import ops as fa
from ..kernels.grouped_ffn import ops as ffn


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class _Checks:
    def __init__(self):
        self.ok = True

    def __call__(self, name, out, ref, tol) -> None:
        out, ref = out.float().reshape(-1, out.shape[-1]), ref.float().reshape(-1, ref.shape[-1])
        err = (out - ref).abs()
        scale = ref.abs().max().item()
        good = bool(torch.isfinite(err).all()) and err.max().item() <= tol * max(scale, 1e-30)
        self.ok &= good
        print(f"{name}: max|err| {err.max().item():.4g} (limit {tol:g} x {scale:.4g}) "
              f"{'ok' if good else 'FAIL'}", flush=True)
        if not good:
            r, c = err.shape[0] // 8 * 8, err.shape[1] // 8 * 8
            blocks = err[:r, :c].reshape(r // 8, 8, c // 8, 8).amax((1, 3))
            torch.set_printoptions(precision=2, linewidth=200, sci_mode=True)
            print(f"  error by 8 x 8 block (first 16 x 16):\n{blocks[:16, :16].cpu()}",
                  flush=True)


def _report_build() -> None:
    took = _build.build(["grouped_ffn", "flash_attention"])
    print(f"built in {max(took.values()):.1f}s", flush=True)
    for name in ("grouped_ffn", "flash_attention"):
        lines = (_build.BUILD_DIR / f"{name}.log").read_text().splitlines()
        for line in lines:
            if "Compiling entry" in line:
                print(f"{name}: {line.split(chr(39))[1][:60]}", flush=True)
            elif "registers" in line or "spill" in line:
                print(f"  {line.strip()}", flush=True)


def _ffn_stages(check, rng, dev) -> None:
    bf = torch.bfloat16

    def t(shape, scale):
        return torch.as_tensor(rng.normal(size=shape) * scale, dtype=bf, device=dev)

    x, wg, wu, wd = t((64, 128), 0.5), t((1, 128, 128), 0.05), t((1, 128, 128), 0.05), \
        t((1, 128, 128), 0.05)
    be = torch.zeros(1, dtype=torch.int32, device=dev)
    for label, xx, dd in (("", x, wd), (", Wd = I (pass 1)", x, torch.eye(128, dtype=bf,
                                                                          device=dev)[None]),
                          (", X = I (pass 2's weights)", torch.eye(64, 128, dtype=bf,
                                                                   device=dev), wd)):
        y = ffn.grouped_ffn_blocked(xx, be, wg, wu, dd, block_tokens=64)
        torch.cuda.synchronize()
        check(f"ffn one tile{label}", y,
              ffn.grouped_ffn_blocked_ref(xx, be, wg, wu, dd, block_tokens=64), 2e-2)
    if not check.ok:
        return
    for bt in (64, 128):
        m, d, f, e = 4 * bt, 256, 192, 3
        x, wg, wu, wd = t((m, d), 0.5), t((e, d, f), 0.05), t((e, d, f), 0.05), \
            t((e, f, d), 0.05)
        be = torch.as_tensor([2, 0, 1, 2], dtype=torch.int32, device=dev)
        rows = torch.as_tensor([bt, 5, 0, bt - 1], dtype=torch.int32, device=dev)
        for kw in ({}, {"block_rows": rows}):
            y = ffn.grouped_ffn_blocked(x, be, wg, wu, wd, block_tokens=bt, **kw)
            torch.cuda.synchronize()
            check(f"ffn F {f} block_tokens {bt}{' block_rows' if kw else ''}", y,
                  ffn.grouped_ffn_blocked_ref(x, be, wg, wu, wd, block_tokens=bt, **kw), 2e-2)
        live = torch.arange(m, device=dev) % bt < rows.long().repeat_interleave(bt)
        zero = bool((y[~live] == 0).all())
        check.ok &= zero
        print(f"  padding rows exactly 0: {zero}", flush=True)


def _flash_stages(check, rng, dev) -> None:
    def t(shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.bfloat16, device=dev)

    for dh in (64, 128):
        for causal in (False, True):
            q, k, v = t((1, 1, 64, dh)), t((1, 1, 64, dh)), t((1, 1, 64, dh))
            o = fa.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            check(f"flash one tile Dh {dh} causal {causal}", o,
                  fa.mha_ref(q, k, v, causal=causal), 1e-2)
    if not check.ok:
        return
    for dh in (64, 128):
        for kw, sq, sk in ((dict(causal=True), 200, 200),
                           (dict(causal=True, window=50), 200, 200),
                           (dict(causal=True, q_offset=170), 130, 300),
                           (dict(causal=False), 200, 300)):
            q, k, v = t((2, 4, sq, dh)), t((2, 2, sk, dh)), t((2, 2, sk, dh))
            o = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            check(f"flash Dh {dh} {kw} Sq {sq} Sk {sk}", o, fa.mha_ref(q, k, v, **kw), 1e-2)


def _time_main_shapes(dev, seed: int) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(4, 32, 512, 128, generator=gen, device=dev).to(bf)
    k, v = (torch.randn(4, 8, 512, 128, generator=gen, device=dev).to(bf) for _ in range(2))
    sdpa = _time_ms(lambda: F_.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                            enable_gqa=True), 20)
    kernel = _time_ms(lambda: fa.flash_attention(q, k, v), 20)
    print(f"flash q [4, 32, 512, 128] causal: kernel {kernel:.4f} ms, SDPA is_causal "
          f"{sdpa:.4f} ms", flush=True)

    n, e, d, f = 3731, 8, 4096, 16384
    eid = torch.randint(0, e, (n,), generator=gen, device=dev)
    x = torch.randn(n, d, generator=gen, device=dev).to(bf) * 0.5
    wg, wu = (torch.randn(e, d, f, generator=gen, device=dev).to(bf) * 0.02 for _ in range(2))
    wd = torch.randn(e, f, d, generator=gen, device=dev).to(bf) * 0.02
    order, pos, blk, m_pad = ffn._arrange(eid, e, 64)
    rows = ffn._block_rows(eid, e, 64)
    blk = blk.to(torch.int32)
    xp = torch.zeros(m_pad, d, dtype=bf, device=dev)
    xp[pos] = x[order]

    def run():
        return ffn.grouped_ffn_blocked(xp, blk, wg, wu, wd, block_tokens=64, block_rows=rows)

    segs = []                                   # token rows, per expert
    for b, (ex, r) in enumerate(zip(blk.tolist(), rows.tolist())):
        if r and segs and segs[-1][0] == ex and segs[-1][2] == b * 64:
            segs[-1][2] = b * 64 + r
        elif r:
            segs.append([ex, b * 64, b * 64 + r])

    def loop():
        out = torch.zeros_like(xp)
        for ex, lo, hi in segs:
            xe = xp[lo:hi]
            out[lo:hi] = (F_.silu(xe @ wg[ex]) * (xe @ wu[ex])) @ wd[ex]
        return out

    ms, ml = _time_ms(run, 5), _time_ms(loop, 5)
    print(f"grouped_ffn_blocked [{m_pad}, {d}] ({n} token rows, E {e}, F {f}): kernel "
          f"{ms:.3f} ms, matmul loop over token rows {ml:.3f} ms", flush=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        for frag, label in (("ffn_tc<true>", "pass 1"), ("ffn_tc<false>", "pass 2")):
            if ev.device_type == DeviceType.CUDA and frag in ev.key:
                print(f"  {label}: {ev.self_device_time_total / 1e3:.3f} ms", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--time", action="store_true", help="also time the main path's shapes")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("first_call: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _report_build()
    check = _Checks()
    rng = np.random.default_rng(args.seed)
    for stage in (_ffn_stages, _flash_stages):
        stage(check, rng, dev)
        if not check.ok:
            return 1
    if args.time:
        _time_main_shapes(dev, args.seed)
    print(f"first_call: every check passed ({time.perf_counter() - t0:.0f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
