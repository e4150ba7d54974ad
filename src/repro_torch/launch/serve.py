"""Serving launcher: batched generation through ``ServeEngine``.

    python -m repro_torch.launch.serve --arch paper-moe-8e --ep 8 \
        --batch 4 --prompt-len 8 --new-tokens 8

runs the model at full width on the card with random weights from
``--seed``, expert-parallel over ``--ep`` stacked ranks in groups of up to
4 with NIMBLE dispatch.  One generation of the same requests runs first as
a warm-up (its time is printed too), so the timed one pays no first-call
costs.  ``--reduced`` shrinks the model to smoke-test widths and
``--device cpu`` runs on the CPU (the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs.base import get_config
from ..kernels import _build
from ..models.registry import build_model
from ..serve.engine import ServeEngine
from ..sharding.context import ParallelContext

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-moe-8e")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ep", type=int, default=8)
    ap.add_argument("--dtype", default="bf16", choices=sorted(_DTYPES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), n_experts=cfg.n_experts)
    dt = _DTYPES[args.dtype]
    ctx = ParallelContext(ep_size=args.ep, group_size=min(4, args.ep), moe_mode="nimble",
                          param_dtype=dt, compute_dtype=dt, device=args.device)
    if args.device.startswith("cuda"):
        _build.build()                    # compile before the clock starts
    model = build_model(cfg, ctx)
    params = model.init(args.seed)
    engine = ServeEngine(model, params, max_len=args.prompt_len + args.new_tokens)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    times = []
    for _ in range(2):                    # warm-up, then the timed run
        t0 = time.perf_counter()
        out = engine.generate(prompts, n_new=args.new_tokens,
                              temperature=args.temperature, seed=args.seed)
        times.append(time.perf_counter() - t0)
    warm_s, dt_s = times
    where = (torch.cuda.get_device_name(0) if args.device.startswith("cuda")
             else args.device)
    print(f"[serve] {cfg.name} ep={args.ep} on {where}: generated {out.shape} "
          f"in {dt_s:.2f}s ({args.batch * args.new_tokens / dt_s:.1f} tok/s; "
          f"warm-up run {warm_s:.2f}s)")
    print("[serve] sample:", out[0][:12].tolist())
    return out


if __name__ == "__main__":
    main()
