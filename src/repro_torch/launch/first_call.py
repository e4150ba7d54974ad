"""A redesigned kernel's first call on the card: build, one tile, then the main shapes.

    python -m repro_torch.launch.first_call [--time] [--kernels NAME ...]

builds the redesigned kernels (the grouped FFN, flash, ``token_gather``,
``token_scatter_add``, ``mlstm_scan`` and ``relay_copy``) and prints
nvcc's register, shared-memory and spill report for each of their kernels.  Then it holds each against its plain version,
smallest first, and stops at the first stage that fails (exit 1):

  1. one tile each: the FFN at M 64, D 128, F 128, E 1 (also with Wd = I,
     which shows pass 1 alone, and with X = I, which shows pass 2's
     weights), flash at one 64-row tile for Dh 64 and 128, causal or not;
     ``token_gather`` and ``token_scatter_add`` on 8 rows of 128 bytes
     (first the inverse-index launch alone, bit for bit against the plain
     sort and search); ``mlstm_scan`` on one chunk of 64 steps at dh 64;
     ``relay_copy`` on one tile of 2 KiB;
  2. ragged shapes: the FFN at F 192 for block_tokens 64 and 128, with and
     without ``block_rows`` (padding rows exactly 0); flash with Sq 200 or
     130 and Sk 200 or 300 under the causal, window, offset and full masks;
     ``token_gather`` on rows that are no multiple of a segment, 64-byte
     rows, 8 KiB rows and offset views (the 4- and 2-byte routes);
     ``mlstm_scan`` with S no multiple of the chunk, dh 100, 50 and 192, a
     chunk of 8, a carried state, and value widths below the key width
     (48 and 96 of 192, 7 of 33); ``token_scatter_add`` (token_gather's
     backward) on 6- and 12-byte rows, rows of several segments, the
     dispatch pack's backward (8192 rows of 8 KiB onto 2048) and offset
     views, after the inverse index on five and seventeen blocks; ``relay_copy``
     at [8192, 4096] in bf16, f32 and int32 (the bulk route), on 420- and
     210-byte chunks and offset views (the 4- and 2-byte routes), each
     under the parity, swapped and all-zeros maps.

Where a check fails it prints the error's map in 8 x 8 blocks, which shows
a misplaced operand (a wrong descriptor stride or swizzle) at a glance.
With ``--time`` it then times the kernels at the main path's shapes on
synthetic inputs beside their PyTorch yardsticks: the FFN on 3731 tokens
routed uniformly over 8 experts of paper-moe-8e's widths (its two passes
under ``torch.profiler``); flash on q [4, 32, 512, 128], k/v [4, 8, 512,
128], causal; ``token_gather`` on a relay round of 1024 and of 64 rows of
128 KiB, the FFN's sort of 3731 tokens into 8704 rows of 8 KiB and 1024
sideband rows of 64 bytes, against ``index_select``, on the device alone;
``mlstm_scan`` on q/k/v [4, 4, 2048, 192] f32,
chunk 64, with its three launches under ``torch.profiler``.  Inputs are
made from ``--seed``; ``--kernels`` picks the kernels to check and time.
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
from ..kernels.mlstm_scan import ops as ms
from ..kernels.relay_copy import ops as rl
from ..kernels.token_scatter import ops as tg
from .kernel_times import device_ms, gather_inputs, mlstm_flops, mlstm_inputs, time_ms

KERNELS = ("grouped_ffn", "flash_attention", "token_gather", "token_scatter_add",
           "mlstm_scan", "relay_copy")
PEAK_F32 = 67e12                           # f32 on CUDA cores


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


def _report_build(names) -> None:
    took = _build.build(names)
    print(f"built in {max(took.values()):.1f}s", flush=True)
    for name in names:
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


def _gather_stages(check, rng, dev) -> None:
    def case(n, m, d, dtype):
        x = torch.as_tensor(rng.normal(size=(n, d)), dtype=dtype, device=dev)
        idx = torch.as_tensor(rng.integers(-3, n + 5, size=(m,)), device=dev)
        out = tg.token_gather(x, idx)
        torch.cuda.synchronize()
        check(f"token_gather [{n}, {d}] {str(dtype)[6:]} -> {m} rows", out,
              tg.token_gather_ref(x, idx), 0.0)

    case(8, 8, 64, torch.bfloat16)
    if not check.ok:
        return
    case(256, 64, 65536 + 24, torch.bfloat16)          # no multiple of a segment
    case(2048, 4096, 16, torch.float32)                # 64-byte sideband rows
    case(3731, 8704, 4096, torch.bfloat16)             # the FFN's 8 KiB rows
    for dtype in (torch.float32, torch.bfloat16):      # the 4- and 2-byte routes
        flat = torch.as_tensor(rng.normal(size=(300 * 4104 + 1,)), dtype=dtype, device=dev)
        x = flat[1:].view(300, 4104)
        idx = torch.as_tensor(rng.integers(-2, 302, size=(500,)), device=dev)
        out = tg.token_gather(x, idx)
        torch.cuda.synchronize()
        word = tg.geometry(4104 * x.element_size(), 500, x.data_ptr() | out.data_ptr()).word
        check(f"token_gather offset view {str(dtype)[6:]} ({word}-byte words)", out,
              tg.token_gather_ref(x, idx), 0.0)


def _index_stage(check, rng, dev, n, m) -> None:
    idx = torch.as_tensor(rng.integers(-3, n + 3, size=(m,)), device=dev)
    order, offsets = tg.build_inverse_index(idx, n)
    torch.cuda.synchronize()
    want = tg.inverse_index(idx, n)
    check(f"inverse index {m} indices -> {n} rows ({-(-(n + 1) // tg.INDEX_KEYS)} blocks)",
          torch.cat((order, offsets))[:, None], torch.cat(want)[:, None], 0.0)


def _scatter_stages(check, rng, dev) -> None:
    _index_stage(check, rng, dev, 8, 8)
    if not check.ok:
        return
    _index_stage(check, rng, dev, 2048, 8192)             # five blocks
    _index_stage(check, rng, dev, 8192, 4096)             # seventeen blocks
    if not check.ok:
        return

    def case(n, m, d, dtype, offset=0):
        flat = torch.as_tensor(rng.normal(size=(m * d + offset,)), dtype=dtype, device=dev)
        g = flat[offset:].view(m, d)
        idx = torch.as_tensor(rng.integers(-3, n + 3, size=(m,)), device=dev)
        out = tg.token_scatter_add(g, idx, n)
        torch.cuda.synchronize()
        tol = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-6   # >2 sources: sum order
        check(f"token_scatter_add {m} rows of [{d}] {str(dtype)[6:]} -> {n} (offset {offset})",
              out, tg.token_scatter_add_ref(g.cpu(), idx.cpu(), n).to(dev), tol)

    case(8, 8, 64, torch.bfloat16)
    if not check.ok:
        return
    case(40, 90, 3, torch.float32)                     # 12-byte rows: 4-byte words
    case(40, 90, 3, torch.bfloat16)                    # 6-byte rows: 2-byte words
    case(64, 100, 65536 + 24, torch.bfloat16)          # several segments, a ragged one
    case(2048, 8192, 4096, torch.bfloat16)             # the dispatch pack's backward
    for dtype in (torch.float32, torch.bfloat16):      # offset views
        case(300, 500, 4104, dtype, offset=1)


def _mlstm_stages(check, rng, dev) -> None:
    def case(b, h, s, dh, chunk, split=None, dv=None):
        a = mlstm_inputs(dev, int(rng.integers(1 << 30)), b, h, s, dh)
        if dv is not None:                              # a model group's value columns
            a = (a[0], a[1], a[2][..., :dv].contiguous(), a[3], a[4])
        st = None
        if split:
            _, st = ms.mlstm_scan(*(x[:, :, :split] for x in a), chunk=chunk)
            a = [x[:, :, split:] for x in a]
        got, st_got = ms.mlstm_scan(*a, chunk=chunk, state=st)
        torch.cuda.synchronize()
        want, st_want = ms.mlstm_scan_chunked_ref(*a, chunk=chunk, state=st)
        label = f"mlstm_scan [{b}, {h}, {a[0].shape[2]}, {dh}] chunk {chunk}" + (
            f" dv {dv}" if dv is not None else "") + (" from a state" if split else "")
        check(f"{label} h", got, want, 1e-4)
        for key in ("C", "n"):
            check(f"{label} final {key}", st_got[key], st_want[key], 1e-4)
        check(f"{label} final m", st_got["m"][..., None], st_want["m"][..., None], 1e-4)

    case(1, 1, 64, 64, 64)
    if not check.ok:
        return
    case(2, 2, 200, 100, 64)                            # S padded, dh in no 64-row tile
    case(1, 2, 100, 50, 64)                             # dh % 4 != 0: 4-byte copies
    case(1, 4, 320, 192, 64)
    case(2, 1, 8, 192, 64)                              # a chunk of 8
    case(1, 2, 300, 100, 64, split=130)
    case(4, 1, 2048, 192, 64, dv=48)                    # value columns: model 16
    case(4, 1, 2048, 192, 64, dv=96, split=700)         # model 8, from a state
    case(1, 3, 72, 33, 16, dv=7)                        # both 4-byte routes, odd dk


def _relay_stages(check, rng, dev) -> None:
    def case(n, d, bc, dtype, offset=0):
        flat = torch.as_tensor(rng.integers(-1000, 1000, size=(n * d + offset,)), dtype=dtype,
                               device=dev)
        x = flat[offset:].view(n, d)
        k = n // bc
        for name, smap in (("parity", rl.parity_slot_map(k, dev)),
                           ("swapped", 1 - rl.parity_slot_map(k, dev)),
                           ("zeros", torch.zeros(k, dtype=torch.int32, device=dev))):
            out = rl.relay_copy(x, smap, block_chunk=bc)
            torch.cuda.synchronize()
            word = rl.geometry(k, bc * d * x.element_size(), (x.data_ptr() | out.data_ptr())
                               & 15, rl._sm_count(out.device.index)).word
            check(f"relay_copy [{n}, {d}] {str(dtype)[6:]} chunks of {bc}, {name} map "
                  f"({word}-byte route)", out, x, 0.0)

    case(16, 64, 16, torch.bfloat16)                   # one tile of 2 KiB
    if not check.ok:
        return
    case(512, 128, 64, torch.float32)
    for dtype in (torch.bfloat16, torch.float32, torch.int32):
        case(8192, 4096, 256, dtype)                   # phase 13's shapes
    case(45, 7, 15, torch.float32)                     # 420-byte chunks: 4-byte words
    case(45, 7, 15, torch.bfloat16)                    # 210-byte chunks: 2-byte words
    case(512, 128, 64, torch.float32, offset=1)        # offset views
    case(512, 128, 64, torch.bfloat16, offset=1)


def _time_gather(dev, seed: int) -> None:
    for label, x, idx, bound in gather_inputs(dev, seed):
        safe = idx.clamp_min(0)                 # index_select takes no -1
        kernel = device_ms(lambda: tg.token_gather(x, idx), 20)
        lib = device_ms(lambda: torch.index_select(x, 0, safe), 20)
        print(f"token_gather {label}: x {tuple(x.shape)} {str(x.dtype)[6:]}, {idx.numel()} "
              f"rows: kernel {kernel:.4f} ms on the device "
              f"({time_ms(lambda: tg.token_gather(x, idx), 20):.4f} ms by events), "
              f"index_select {lib:.4f} ms on the device, bound {bound:.4f} ms", flush=True)


def _time_mlstm(dev, seed: int) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a = mlstm_inputs(dev, seed)
    b, h, s, dh = a[0].shape
    L = 64
    kernel = time_ms(lambda: ms.mlstm_scan(*a, chunk=L), 10)
    flops = mlstm_flops(b, h, s, dh, L)
    print(f"mlstm_scan [{b}, {h}, {s}, {dh}] f32 chunk {L}: kernel {kernel:.4f} ms, bound "
          f"{flops / PEAK_F32 * 1e3:.4f} ms ({flops / 1e9:.3f} GFLOP at 67 TFLOP/s)",
          flush=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ms.mlstm_scan(*a, chunk=L)
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        for name in ("mlstm_delta", "mlstm_prefix", "mlstm_out"):
            if ev.device_type == DeviceType.CUDA and (name + "(" in ev.key
                                                      or name + "<" in ev.key):
                print(f"  {name}: {ev.self_device_time_total / 1e3:.4f} ms", flush=True)


def _time_main_shapes(dev, seed: int) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(4, 32, 512, 128, generator=gen, device=dev).to(bf)
    k, v = (torch.randn(4, 8, 512, 128, generator=gen, device=dev).to(bf) for _ in range(2))
    sdpa = time_ms(lambda: F_.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                            enable_gqa=True), 20)
    kernel = time_ms(lambda: fa.flash_attention(q, k, v), 20)
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

    ms, ml = time_ms(run, 5), time_ms(loop, 5)
    print(f"grouped_ffn_blocked [{m_pad}, {d}] ({n} token rows, E {e}, F {f}): kernel "
          f"{ms:.3f} ms, matmul loop over token rows {ml:.3f} ms", flush=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        for frag, label in (("ffn_tc<true>", "pass 1"), ("ffn_tc<false>", "pass 2")):
            if ev.device_type == DeviceType.CUDA and frag in ev.key:
                print(f"  {label}: {ev.self_device_time_total / 1e3:.3f} ms", flush=True)

    # the FFN's plain-torch backward at the same shapes: 8 products of
    # 2 n d f operations each (4 recompute and weight, 4 input gradients)
    g = torch.randn(n, d, generator=gen, device=dev).to(bf)

    def bwd():
        return ffn.grouped_ffn_bwd(g, x, eid, wg, wu, wd)

    bwd_ms = time_ms(bwd, 3)
    print(f"grouped_ffn_bwd [{n}, {d}] bf16 (E {e}, F {f}): {bwd_ms:.3f} ms by events, bound "
          f"{16.0 * n * d * f / 989e12 * 1e3:.3f} ms (operations at 989 TFLOP/s)", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bwd()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((ev.self_device_time_total, ev.count, ev.key) for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0),
                  reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    print(f"  profiled: wall {wall * 1e3:.2f} ms, device busy {busy:.2f} ms", flush=True)
    for t, count, key in rows[:10]:
        print(f"  {t / 1e3:8.3f} ms {count:4d} calls  {key[:90]}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--time", action="store_true", help="also time the main path's shapes")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", nargs="+", choices=KERNELS, default=list(KERNELS),
                    help="the kernels to check (and time)")
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
    _report_build(args.kernels)
    check = _Checks()
    rng = np.random.default_rng(args.seed)
    stages = {"grouped_ffn": _ffn_stages, "flash_attention": _flash_stages,
              "token_gather": _gather_stages, "token_scatter_add": _scatter_stages,
              "mlstm_scan": _mlstm_stages, "relay_copy": _relay_stages}
    for name in args.kernels:
        stages[name](check, rng, dev)
        if not check.ok:
            return 1
    if args.time:
        if "grouped_ffn" in args.kernels or "flash_attention" in args.kernels:
            _time_main_shapes(dev, args.seed)
        if "token_gather" in args.kernels:
            _time_gather(dev, args.seed)
        if "mlstm_scan" in args.kernels:
            _time_mlstm(dev, args.seed)
    print(f"first_call: every check passed ({time.perf_counter() - t0:.0f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
