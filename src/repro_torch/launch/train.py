"""Training launcher: a few AdamW steps of a MoE model on the card.

    python -m repro_torch.launch.train --arch paper-moe-8e --steps 5 \
        --batch 4 --seq 512
    python -m repro_torch.launch.train --arch paper-moe-8e --reduced \
        --device cpu --dtype f32 --steps 20 --batch 4 --seq 64

Counterpart of ``repro/launch/train.py``: the same flags, the same
``SyntheticLM`` batches and AdamW, the same log lines, ending with
``loss a -> b (improved|NOT improved)``.  It adds the port's serving flags:
the model runs expert-parallel over ``--ep`` stacked ranks (default 8) in
groups of ``--group-size`` (default up to 4) with ``--mode`` dispatch, in
``--dtype`` (bf16 by default) on ``--device`` (the card by default).
``--reduced`` shrinks the model to smoke-test widths and keeps its expert
count, so the EP ranks still split the experts.  Only the moe family
trains: the ssm family's training needs the ``mlstm_scan`` backward, which
is not ported.  Checkpoint flags wait for the port of ``checkpoint/``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs.base import get_config
from ..data.pipeline import DataConfig, SyntheticLM, to_device
from ..kernels import _build
from ..models.registry import build_model
from ..optim import adamw
from ..sharding.context import DTYPES, ParallelContext
from ..train.step import make_train_step
from ..tree import leaves


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-moe-8e")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale reduced config (keeping its experts)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ep", type=int, default=8, help="expert-parallel ranks")
    ap.add_argument("--group-size", type=int, default=None,
                    help="ranks per node on the NIMBLE axis (default min(4, ep))")
    ap.add_argument("--mode", default="nimble", choices=["nimble", "direct", "stripe"])
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--device", default="cuda")
    return ap, ap.parse_args(argv)


def build_cfg(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), n_experts=cfg.n_experts)
    if args.layers or args.d_model:
        heads = cfg.n_heads
        d = args.d_model or cfg.d_model
        d = max(d // heads, 8) * heads
        cfg = dataclasses.replace(cfg, n_layers=args.layers or cfg.n_layers, d_model=d,
                                  d_ff=(d * 3 if cfg.d_ff else 0))
    return cfg


def main(argv=None):
    ap, args = parse_args(argv)
    cfg = build_cfg(args)
    if cfg.arch_type != "moe":
        ap.error(f"{cfg.name}: only the moe family trains in the port (the "
                 f"{cfg.arch_type} family needs backward kernels not ported yet)")
    dt = DTYPES[args.dtype]
    ctx = ParallelContext(ep_size=args.ep, group_size=args.group_size or min(4, args.ep),
                          moe_mode=args.mode, param_dtype=dt, compute_dtype=dt,
                          device=args.device)
    try:
        model = build_model(cfg, ctx)
    except ValueError as e:
        ap.error(str(e))
    on_card = torch.device(args.device).type == "cuda"
    where = torch.cuda.get_device_name(0) if on_card else args.device
    print(f"[train] {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab} arch={cfg.arch_type}")
    print(f"[train] ep={args.ep} groups of {ctx.group_size} {args.mode} {args.dtype} "
          f"on {where}")
    if on_card:
        _build.build()                    # compile before the clock starts
    params = model.init(args.seed)
    n_params = sum(x.numel() for x in leaves(params))
    print(f"[train] params: {n_params / 1e6:.2f}M")

    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                                total_steps=args.steps)
    opt_state = adamw.init(params)
    step_fn = make_train_step(model, opt_cfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed))

    t0 = time.time()
    losses = []
    for step in range(args.steps):
        batch = to_device(data.batch(step), args.device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            dt_s = time.time() - t0
            print(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} ({dt_s:.1f}s)", flush=True)
    first = np.mean(losses[: max(3, len(losses) // 10)])
    last = np.mean(losses[-max(3, len(losses) // 10):])
    print(f"[train] loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return losses


if __name__ == "__main__":
    main()
