"""Where the device time goes in the port's serving and training paths, by kernel.

    python -m repro_torch.launch.profile [--arch ARCH] [--train | --runtime] [--out DIR]

builds ``--arch`` at full width on the card (bf16, random weights from
``--seed``), warms it up, then traces under ``torch.profiler`` one prefill
(``forward(last_only=True)``) and one greedy ``ServeEngine.generate`` of 4
requests.  paper-moe-8e (the default) runs on 8 EP ranks in groups of 4
with NIMBLE dispatch, prefills 4 x 512 tokens and generates 8 tokens after
a prompt of 8; xlstm-125m prefills 4 x 2048 tokens and generates 16 tokens
after a prompt of 128; llama3-8b prefills 4 x 512 and generates 8 after 8;
zamba2-1.2b prefills 4 x 2048 and whisper-small 4 x 448 tokens over the
4 x 1500 stub frames of ``add_modality_stubs``, each generating 8 after 8.
For each it prints the wall time, the summed device
time, the device's idle share, the kernels that took the most device
time, and the device's longest idle gaps with the host ops in flight
across each.  ``--train`` profiles instead one AdamW train step of ``--arch`` at
full width (bf16, tokens from ``SyntheticLM``) after a warm-up step:
paper-moe-8e and granite-moe-1b-a400m on EP 8 in groups of 4 with NIMBLE
dispatch, 4 x 512 tokens; xlstm-125m, smollm-135m and zamba2-1.2b on one
rank, 4 x 2048 tokens (each block's activations recomputed in the
backward where ``launch/train.py::needs_remat`` says so: zamba2-1.2b).  ``--runtime`` profiles the execution-time planning runtime:
one replan's solve (``solve_plans_batch`` of one demand matrix, every MWU
iteration on the card) on the paper's testbed (n=8) and an 8-node EP group
(n=32), and the testbed's whole drifting-skew replay (48 windows).  With ``--out`` the Chrome traces are
written to ``DIR``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..configs.base import get_config
from ..data.pipeline import DataConfig, SyntheticLM, add_modality_stubs, to_device
from .train import needs_remat
from ..models.registry import build_model
from ..optim import adamw
from ..serve.engine import ServeEngine
from ..sharding.context import ParallelContext
from ..train.step import make_train_step

#: kernel-name fragments of the port's own CUDA kernels (demangled, as the
#: profiler shows them); the FFN and flash have a bf16 tensor-core route
#: (``tc::``) and a float32 CUDA-core route each
OWN = {"gather_rows": "token_gather", "scatter_add_rows": "token_scatter_add",
       "inverse_index<": "token_scatter_add's inverse index",
       "ffn_tc<true>": "grouped_ffn_blocked pass 1 (tensor cores)",
       "ffn_tc<false>": "grouped_ffn_blocked pass 2 (tensor cores)",
       "ffn_gate_up": "grouped_ffn_blocked pass 1 (f32)",
       "ffn_down": "grouped_ffn_blocked pass 2 (f32)",
       "flash_tc<": "flash_attention (tensor cores)", "flash_fwd": "flash_attention (f32)",
       "mlstm_delta": "mlstm_scan 1/3 (chunk state updates)",
       "mlstm_prefix": "mlstm_scan 2/3 (stabilizer chain, prefix over chunks)",
       "mlstm_out": "mlstm_scan 3/3 (chunk outputs)", "relay_bulk": "relay_copy",
       "relay_words": "relay_copy (word routes)"}

#: per architecture: EP ranks, prefill length, prompt length, new tokens
SHAPES = {"paper-moe-8e": (8, 512, 8, 8), "xlstm-125m": (1, 2048, 128, 16),
          "llama3-8b": (1, 512, 8, 8), "zamba2-1.2b": (1, 2048, 8, 8),
          "whisper-small": (1, 448, 8, 8)}
#: per architecture: EP ranks, tokens a sequence of a train step (batch 4)
TRAIN_SHAPES = {"paper-moe-8e": (8, 512), "xlstm-125m": (1, 2048), "smollm-135m": (1, 2048),
                "zamba2-1.2b": (1, 2048), "granite-moe-1b-a400m": (8, 512)}


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


def _gaps(prof, top: int = 5, min_ms: float = 0.5) -> None:
    """The device's longest idle gaps, each with the host ops in flight across it."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    dev = sorted((e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                 key=lambda e: e["ts"])
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    gaps, end = [], None
    for e in dev:
        if end is not None and e["ts"] - end > min_ms * 1e3:
            gaps.append((e["ts"] - end, end, e["name"]))
        end = e["ts"] + e["dur"] if end is None else max(end, e["ts"] + e["dur"])
    print(f"[profile]   {len(gaps)} device idle gaps over {min_ms} ms, "
          f"{sum(g[0] for g in gaps) / 1e3:.1f} ms in all", flush=True)
    for dur, start, nxt in sorted(gaps, reverse=True)[:top]:
        over = sorted((o for o in ops if o["ts"] <= start and o["ts"] + o["dur"] >= start + dur),
                      key=lambda o: o["dur"])
        host = " < ".join(dict.fromkeys(o["name"][:48] for o in over[:3])) or "no host op"
        print(f"[profile]     {dur / 1e3:6.3f} ms idle before {nxt[:40]}; host in {host}",
              flush=True)


def _profile(label: str, fn, n_tok: int, out, top: int = 12) -> None:
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(label, prof, wall, n_tok, top)
    _gaps(prof)
    if out is not None:
        prof.export_chrome_trace(str(out / f"{label.split()[0]}.json"))


def _train(arch: str, seed: int, out) -> None:
    """One warm-up step, then one profiled train step of ``arch``."""
    cfg = get_config(arch)
    ep, seq = TRAIN_SHAPES[arch]
    ctx = ParallelContext(ep_size=ep, group_size=min(4, ep), moe_mode="nimble",
                          param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                          remat=needs_remat(arch))
    model = build_model(cfg, ctx)
    params = model.init(seed)
    state = adamw.init(params)
    step = make_train_step(model, adamw.AdamWConfig(warmup_steps=2))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=4, seed=seed))
    batches = [to_device(add_modality_stubs(data.batch(i), cfg, rng_seed=i), "cuda")
               for i in range(2)]
    params, state, _ = step(params, state, batches[0])
    torch.cuda.synchronize()
    _profile(f"train 4x{seq} step", lambda: step(params, state, batches[1]), 4 * seq, out, 24)
    print(f"[profile] {cfg.name} train on {torch.cuda.get_device_name(0)}")


def _runtime(out) -> None:
    """One replan's solve at n=8 and n=32, then a 48-window drift replay."""
    from .. import runtime as rt
    from ..core.topology import Topology

    pcfg = rt.RuntimeConfig().planner
    for n in (8, 32):
        topo = Topology(n, group_size=4)
        demand = rt.drifting_skew_trace(n, 1)
        rt.solve_plans_batch(topo, demand, planner_cfg=pcfg)        # warm-up
        torch.cuda.synchronize()
        _profile(f"replan-n{n} solve (B=1, {pcfg.n_iters} MWU iterations)",
                 lambda: rt.solve_plans_batch(topo, demand, planner_cfg=pcfg), 1, out)
    topo = Topology(8, group_size=4)
    trace = rt.drifting_skew_trace(8, 48, dwell=12)
    rt.OrchestrationRuntime(topo).run_trace(trace[:2])              # warm-up
    _profile("runtime-drift 48 windows (n=8)",
             lambda: rt.OrchestrationRuntime(topo).run_trace(trace), 48, out)
    print(f"[profile] runtime on {torch.cuda.get_device_name(0)} "
          "(tokens/s above read as solves/s and windows/s)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-moe-8e", choices=sorted({*SHAPES, *TRAIN_SHAPES}))
    ap.add_argument("--train", action="store_true",
                    help="profile a train step instead of serving")
    ap.add_argument("--runtime", action="store_true",
                    help="profile the runtime's replan solves instead of serving")
    ap.add_argument("--out", default=None, help="directory for Chrome traces")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    out = Path(args.out) if args.out else None
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
    if args.train:
        _train(args.arch, args.seed, out)
        return
    if args.arch not in SHAPES:
        ap.error(f"{args.arch} is profiled with --train only")
    if args.runtime:
        _runtime(out)
        return

    cfg = get_config(args.arch)
    ep, seq, n_prompt, n_new = SHAPES[args.arch]
    ctx = ParallelContext(ep_size=ep, group_size=min(4, ep), moe_mode="nimble",
                          param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    model = build_model(cfg, ctx)
    params = model.init(args.seed)
    rng = np.random.default_rng(args.seed)
    toks = rng.integers(0, cfg.vocab, (4, seq))
    batch = to_device(add_modality_stubs({"tokens": toks, "labels": toks}, cfg,
                                         rng_seed=args.seed), "cuda")
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
            _profile(label, fn, n_tok, out)
    print(f"[profile] {cfg.name} on {torch.cuda.get_device_name(0)}")


if __name__ == "__main__":
    main()
