"""Where the device time goes in the port's serving path, by kernel.

    python -m repro_torch.launch.profile [--arch ARCH] [--out DIR]

builds ``--arch`` at full width on the card (bf16, random weights from
``--seed``), warms it up, then traces under ``torch.profiler`` one prefill
(``forward(last_only=True)``) and one greedy ``ServeEngine.generate`` of 4
requests.  paper-moe-8e (the default) runs on 8 EP ranks in groups of 4
with NIMBLE dispatch, prefills 4 x 512 tokens and generates 8 tokens after
a prompt of 8; xlstm-125m prefills 4 x 2048 tokens and generates 16 tokens
after a prompt of 128.  For each it prints the wall time, the summed device
time, the device's idle share, and the kernels that took the most device
time.  With ``--out`` the Chrome traces are written to ``DIR``.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..configs.base import get_config
from ..models.registry import build_model
from ..serve.engine import ServeEngine
from ..sharding.context import ParallelContext

#: kernel-name fragments of the port's own CUDA kernels (demangled, as the
#: profiler shows them); the FFN and flash have a bf16 tensor-core route
#: (``tc::``) and a float32 CUDA-core route each
OWN = {"gather_rows": "token_gather",
       "ffn_tc<true>": "grouped_ffn_blocked pass 1 (tensor cores)",
       "ffn_tc<false>": "grouped_ffn_blocked pass 2 (tensor cores)",
       "ffn_gate_up": "grouped_ffn_blocked pass 1 (f32)",
       "ffn_down": "grouped_ffn_blocked pass 2 (f32)",
       "flash_tc<": "flash_attention (tensor cores)", "flash_fwd": "flash_attention (f32)",
       "mlstm_delta": "mlstm_scan 1/3 (chunk state updates)",
       "mlstm_prefix": "mlstm_scan 2/3 (stabilizer chain, prefix over chunks)",
       "mlstm_out": "mlstm_scan 3/3 (chunk outputs)", "relay_stage": "relay_copy"}

#: per architecture: EP ranks, prefill length, prompt length, new tokens
SHAPES = {"paper-moe-8e": (8, 512, 8, 8), "xlstm-125m": (1, 2048, 128, 16)}


def _report(label: str, prof, wall_s: float, n_tok: int, top: int = 12) -> None:
    # Only the device's own events (kernels, copies, sets) carry device time
    # once: a CPU op's self device time is that of the kernels it launched,
    # which have rows of their own.
    rows = []
    for e in prof.key_averages():
        t = e.self_device_time_total
        if e.device_type == DeviceType.CUDA and t > 0:
            rows.append((t, e.count, e.key))
    busy_us = sum(t for t, _, _ in rows)
    own_us = sum(t for t, _, k in rows if any(f in k for f in OWN))
    print(f"[profile] {label}: wall {wall_s * 1e3:.1f} ms ({n_tok / wall_s:.1f} tokens/s), "
          f"device busy "
          f"{busy_us / 1e3:.1f} ms, idle share {1 - busy_us / 1e3 / (wall_s * 1e3):.3f}, "
          f"own kernels {own_us / 1e3:.1f} ms ({own_us / max(busy_us, 1e-9):.3f} of busy)")
    for t, count, key in sorted(rows, reverse=True)[:top]:
        name = next((v for f, v in OWN.items() if f in key), key[:70])
        print(f"[profile]   {t / 1e3:9.3f} ms {count:6d} calls  {t / busy_us:6.3f}  {name}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-moe-8e", choices=sorted(SHAPES))
    ap.add_argument("--out", default=None, help="directory for Chrome traces")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    out = Path(args.out) if args.out else None
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)

    cfg = get_config(args.arch)
    ep, seq, n_prompt, n_new = SHAPES[args.arch]
    ctx = ParallelContext(ep_size=ep, group_size=min(4, ep), moe_mode="nimble",
                          param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    model = build_model(cfg, ctx)
    params = model.init(args.seed)
    rng = np.random.default_rng(args.seed)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (4, seq)),
                                       device="cuda")}
    engine = ServeEngine(model, params, max_len=n_prompt + n_new)
    prompts = rng.integers(0, cfg.vocab, (4, n_prompt))
    with torch.no_grad():
        model.forward(params, batch, last_only=True)               # warm-up
        engine.generate(prompts, n_new=n_new)
        torch.cuda.synchronize()
        for label, n_tok, fn in (
            (f"prefill 4x{seq}", 4 * seq,
             lambda: model.forward(params, batch, last_only=True)),
            (f"generate 4 x ({n_prompt}+{n_new})", 4 * n_new,       # new tokens
             lambda: engine.generate(prompts, n_new=n_new)),
        ):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            _report(label, prof, wall, n_tok)
            if out is not None:
                prof.export_chrome_trace(str(out / f"{label.split()[0]}.json"))
    print(f"[profile] {cfg.name} on {torch.cuda.get_device_name(0)}")


if __name__ == "__main__":
    main()
