"""Training launcher: AdamW steps of any of the reference's models on the card.

    python -m repro_torch.launch.train --arch smollm-135m --steps 5 \
        --batch 4 --seq 2048
    python -m repro_torch.launch.train --arch xlstm-125m --steps 5 \
        --batch 4 --seq 2048 --ckpt-dir ckpts --ckpt-every 5
    python -m repro_torch.launch.train --arch paper-moe-8e --steps 5 \
        --batch 4 --seq 512
    python -m repro_torch.launch.train --arch zamba2-1.2b --steps 5 \
        --batch 4 --seq 2048
    python -m repro_torch.launch.train --arch smollm-135m --reduced \
        --device cpu --dtype f32 --steps 20 --batch 4 --seq 64

Counterpart of ``repro/launch/train.py``: the same flags (``smollm-135m`` by
default), the same ``SyntheticLM`` batches with the audio and vlm
families' stub inputs (``add_modality_stubs``, seeded by the step) and
AdamW, the same log lines,
ending with ``loss a -> b (improved|NOT improved)``, and checkpoints of
``{"params", "opt"}`` every ``--ckpt-every`` steps under ``--ckpt-dir``
(``checkpoint/ckpt.py``, the reference's format).  It adds the port's
flags: a MoE model runs expert-parallel over ``--ep`` stacked ranks (8 by
default; 1 for the families without experts) in groups of
``--group-size`` (default up to 4) with ``--mode`` dispatch; every model
runs in ``--dtype`` (bf16 by default) on ``--device`` (the card by
default; without one the launcher exits non-zero unless ``--device cpu``
is given); each block's activations are recomputed in the backward
(``ParallelContext.remat``) for the archs of ``REMAT_ARCHS``, or as
``--remat`` / ``--no-remat`` say.  ``--reduced`` shrinks the model to smoke-test
widths and keeps its expert count, so the EP ranks still split the experts.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..checkpoint import ckpt
from ..configs.base import get_config
from ..data.pipeline import DataConfig, SyntheticLM, add_modality_stubs, to_device
from ..kernels import _build
from ..models.registry import build_model
from ..optim import adamw
from ..sharding.context import DTYPES, ParallelContext
from ..train.step import make_train_step
from ..tree import leaves


#: the architectures whose train step recomputes each block's activations in
#: the backward unless told otherwise: kept, zamba2's SSD intermediates pass
#: the card's 80 GB at 4 x 2048 tokens
REMAT_ARCHS = frozenset({"zamba2-1.2b"})


def needs_remat(arch: str, override=None) -> bool:
    """Whether ``arch``'s train step recomputes its blocks (``REMAT_ARCHS``),
    unless ``override`` (``--remat`` / ``--no-remat``) says."""
    return arch in REMAT_ARCHS if override is None else bool(override)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
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
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ep", type=int, default=None,
                    help="expert-parallel ranks (default 8 for moe, else 1)")
    ap.add_argument("--group-size", type=int, default=None,
                    help="ranks per node on the NIMBLE axis (default min(4, ep))")
    ap.add_argument("--mode", default="nimble", choices=["nimble", "direct", "stripe"])
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--remat", action=argparse.BooleanOptionalAction, default=None,
                    help="recompute each block's activations in the backward "
                         "(default: REMAT_ARCHS)")
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
                                  d_ff=(d * 3 if cfg.d_ff else 0),
                                  n_enc_layers=min(cfg.n_enc_layers,
                                                   args.layers or cfg.n_enc_layers))
    return cfg


def main(argv=None):
    ap, args = parse_args(argv)
    cfg = build_cfg(args)
    ep = args.ep if args.ep is not None else (8 if cfg.arch_type == "moe" else 1)
    dt = DTYPES[args.dtype]
    ctx = ParallelContext(ep_size=ep, group_size=args.group_size or min(4, ep),
                          moe_mode=args.mode, param_dtype=dt, compute_dtype=dt,
                          remat=needs_remat(args.arch, args.remat),
                          device=args.device)
    try:
        model = build_model(cfg, ctx)
    except ValueError as e:               # e.g. --ep > 1 for a family without experts
        ap.error(str(e))
    on_card = torch.device(args.device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        ap.error("no CUDA device: the port trains on the card; pass --device cpu "
                 "to train on the host")
    where = torch.cuda.get_device_name(0) if on_card else args.device
    print(f"[train] {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab} arch={cfg.arch_type}")
    print(f"[train] ep={ep} groups of {ctx.group_size} {args.mode} {args.dtype} "
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
        batch = to_device(add_modality_stubs(data.batch(step), cfg, rng_seed=step),
                          args.device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            dt_s = time.time() - t0
            print(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} ({dt_s:.1f}s)", flush=True)
        if args.ckpt_every and args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step + 1, {"params": params, "opt": opt_state})
    first = np.mean(losses[: max(3, len(losses) // 10)])
    last = np.mean(losses[-max(3, len(losses) // 10):])
    print(f"[train] loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return losses


if __name__ == "__main__":
    main()
