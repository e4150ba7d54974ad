"""Time ``token_gather``, ``mlstm_scan`` and ``relay_copy`` at the paths' shapes.

    PYTHONPATH=src python -P src/repro_torch/launch/kernel_times.py [--seed N]

It uses only the three kernels' public calls, ``token_gather(x, idx)``,
``mlstm_scan(q, k, v, ig, lf, chunk=...)`` and ``relay_copy(x, slot_map,
block_chunk=...)``, so it runs on the ``repro_torch`` package of any
checkout put on ``PYTHONPATH`` (``-P`` keeps this file's directory off the
import path): two trees can then be compared on one card in one call.
Inputs are synthetic, from ``--seed``:

  * ``token_gather`` on a prefill relay round (1024 of 1024 rows of
    128 KiB, bf16, a permutation), a decode step's relay round (200 rows of
    128 KiB), the grouped FFN's sort of 3731 tokens into 8704 rows of 8 KiB
    (the rest zero rows) and 1024 sideband rows of 64 bytes (f32), beside
    ``index_select``; each by CUDA events over 20 calls (host launch cost
    included) and on the device alone (the calls queued behind a sleeping
    kernel), with its bound: the rows read and written and the indices at
    3.35 TB/s;
  * ``mlstm_scan`` on xlstm-125m layer 0's prefill shapes (q/k/v [4, 4,
    2048, 192] f32, chunk 64) against its f32 operations bound at 67
    TFLOP/s;
  * ``relay_copy`` on [8192, 4096] bf16 in chunks of 256 rows under the
    parity map (``chip_smoke.py`` phase 13's shape) beside ``Tensor.copy_``,
    by CUDA events and on the device, with its bound: the bytes read and
    written and the map at 3.35 TB/s.

It prints one line a measurement and, last, a JSON object of them all.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

PEAK_BYTES_S = 3.35e12                     # H100 SXM HBM3
PEAK_F32 = 67e12                           # f32 on CUDA cores

#: (label, source rows, gathered rows, row width, dtype, index kind)
GATHER_SHAPES = (("relay round, prefill", 1024, 1024, 65536, torch.bfloat16, "perm"),
                 ("relay round, decode", 200, 200, 65536, torch.bfloat16, "perm"),
                 ("FFN sort, 8 KiB rows", 3731, 8704, 4096, torch.bfloat16, "pad"),
                 ("sideband, 64-byte rows", 1024, 1024, 16, torch.float32, "perm"))


def time_ms(fn, reps: int) -> float:
    """CUDA events around ``reps`` calls after a warm-up, host launch cost included."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Device time of ``fn`` a call: the launches queue behind a kernel that
    sleeps while the host enqueues them, so they run back to back and the
    host's launch rate does not set the time (CUDA events around them)."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(2e6) * reps)                 # ~1 ms a launch at 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def gather_inputs(dev, seed: int):
    """Yield (label, x, idx, bound ms) for each of ``GATHER_SHAPES``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    for label, n, m, d, dtype, kind in GATHER_SHAPES:
        x = torch.randn(n, d, generator=gen, device=dev).to(dtype)
        if kind == "perm":
            idx = torch.randperm(n, generator=gen, device=dev)[:m]
        else:                                   # tokens into padded blocks, the rest -1
            idx = torch.full((m,), -1, dtype=torch.int64, device=dev)
            idx[torch.randperm(m, generator=gen, device=dev)[:n]] = torch.arange(n, device=dev)
        valid = int((idx >= 0).sum())
        moved = (valid + m) * d * x.element_size() + m * idx.element_size()
        yield label, x, idx, moved / PEAK_BYTES_S * 1e3


def mlstm_flops(b: int, h: int, s: int, dh: int, L: int) -> float:
    """The scan's least work: q k^T and S v over the causal half of each
    L x L chunk, q C_in and the k^T v state update at L x dh x dh."""
    return 2.0 * b * h * (s // L) * (2 * (L * (L + 1) // 2) * dh + 2 * L * dh * dh)


def mlstm_inputs(dev, seed: int, b=4, h=4, s=2048, dh=192):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)
    q, k, v = (t(rng.normal(size=(b, h, s, dh)) * 0.3) for _ in range(3))
    ig = t(rng.normal(size=(b, h, s)) * 0.5)
    lf = t(np.log(1.0 / (1.0 + np.exp(-(rng.normal(size=(b, h, s)) + 2.0)))))
    return q, k, v, ig, lf


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.mlstm_scan.ops import mlstm_scan
    from repro_torch.kernels.relay_copy.ops import parity_slot_map, relay_copy
    from repro_torch.kernels.token_scatter.ops import token_gather

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} | {smi}", flush=True)
    out = {"device": smi, "token_gather": {}}
    for label, x, idx, bound in gather_inputs(dev, args.seed):
        safe = idx.clamp_min(0)                 # index_select takes no -1
        r = dict(ms=time_ms(lambda: token_gather(x, idx), 20),
                 device_ms=device_ms(lambda: token_gather(x, idx), 20),
                 index_select_ms=time_ms(lambda: torch.index_select(x, 0, safe), 20),
                 index_select_device_ms=device_ms(lambda: torch.index_select(x, 0, safe), 20),
                 bound_ms=bound)
        out["token_gather"][label] = r
        print(f"token_gather {label}: x {tuple(x.shape)} {str(x.dtype)[6:]}, {idx.numel()} "
              f"rows: {r['ms']:.4f} ms ({r['device_ms']:.4f} on the device), index_select "
              f"{r['index_select_ms']:.4f} ms ({r['index_select_device_ms']:.4f}), bound "
              f"{bound:.4f} ms", flush=True)
        del x, idx, safe
    q, k, v, ig, lf = mlstm_inputs(dev, args.seed)
    b, h, s, dh = q.shape
    L = 64
    flops = mlstm_flops(b, h, s, dh, L)
    ms = time_ms(lambda: mlstm_scan(q, k, v, ig, lf, chunk=L), 10)
    out["mlstm_scan"] = dict(ms=ms, device_ms=device_ms(
        lambda: mlstm_scan(q, k, v, ig, lf, chunk=L), 10), bound_ms=flops / PEAK_F32 * 1e3)
    print(f"mlstm_scan q/k/v {tuple(q.shape)} f32, chunk {L}: {ms:.4f} ms "
          f"({out['mlstm_scan']['device_ms']:.4f} on the device), bound "
          f"{out['mlstm_scan']['bound_ms']:.4f} ms", flush=True)
    del q, k, v, ig, lf
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.randn((8192, 4096), generator=gen, device=dev).to(torch.bfloat16)
    smap = parity_slot_map(8192 // 256, dev)
    y = torch.empty_like(x)
    r = dict(ms=time_ms(lambda: relay_copy(x, smap, block_chunk=256), 20),
             device_ms=device_ms(lambda: relay_copy(x, smap, block_chunk=256), 20),
             copy_ms=time_ms(lambda: y.copy_(x), 20),
             copy_device_ms=device_ms(lambda: y.copy_(x), 20),
             bound_ms=(2 * x.numel() * 2 + smap.numel() * 4) / PEAK_BYTES_S * 1e3)
    if not torch.equal(relay_copy(x, smap, block_chunk=256), x):
        print("kernel_times: relay_copy is not an exact copy", file=sys.stderr)
        return 1
    out["relay_copy"] = r
    print(f"relay_copy [8192, 4096] bf16, chunks of 256 rows, parity map: {r['ms']:.4f} ms "
          f"({r['device_ms']:.4f} on the device), copy_ {r['copy_ms']:.4f} ms "
          f"({r['copy_device_ms']:.4f}), bound {r['bound_ms']:.4f} ms", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
