"""End-to-end example: expert-parallel MoE training with NIMBLE dispatch.

    python -m repro_torch.examples.train_moe_nimble [--big] [--mode direct] \
        [--device cpu] [--procs 8]

Counterpart of ``examples/train_moe_nimble.py``.  Trains a granite-family
MoE LM with its experts over 4 expert-parallel ranks in 2 groups of 2
("nodes"), stacked in one process on the card (or on the CPU with
``--device cpu``), or with ``--procs 8`` across 8 processes on the
reference's ``(data 2, model 4)`` mesh (one rank a process, the batch over
data x model; gloo on the CPU, a card a process under NCCL on the card;
``--procs P`` takes ``(data P / m, model m)``, ``m = gcd(P, 4)``): every
train step's dispatch and combine is a skewed
All-to-Allv through the NIMBLE dataplane (live demand -> MWU plan ->
scheduled relay rounds), forward and backward.  The dispatch stack is
wired through one :class:`repro_torch.api.Session` describing the EP
fabric (``ParallelContext.session``), as the reference's is: no
per-application planner or telemetry plumbing.

Presets (the reference's):
    default : granite-moe-8m,   ~8M params, 200 steps, sequence 128
    --big   : granite-moe-100m, ~100M params, 300 steps, sequence 256

It fails (AssertionError) if the mean loss of the last 10 steps is not
below that of the first 10.
"""

import argparse
import dataclasses
import time

import numpy as np

from ..api import Session, SessionSpec, TopologySpec
from ..configs.base import get_config
from ..data.pipeline import DataConfig, SyntheticLM, to_device
from ..models.registry import build_model
from ..optim import adamw
from ..sharding.context import ParallelContext
from ..train.step import make_train_step
from ..tree import leaves


def train(args, mesh=None, verbose: bool = True):
    """The run of ``args`` (on ``mesh`` when given) -> the losses by step."""
    base = get_config("granite-moe-1b-a400m")
    if args.big:
        cfg = dataclasses.replace(
            base, name="granite-moe-100m", n_layers=10, d_model=512,
            n_heads=8, n_kv_heads=4, d_ff=512, vocab=16384,
            n_experts=8, top_k=2,
        )
        steps = args.steps or 300
        seq = args.seq or 256
    else:
        cfg = dataclasses.replace(
            base, name="granite-moe-8m", n_layers=4, d_model=256,
            n_heads=4, n_kv_heads=2, d_ff=256, vocab=4096,
            n_experts=8, top_k=2,
        )
        steps = args.steps or 200
        seq = args.seq or 128
    say = print if verbose else (lambda *a, **k: None)

    # one declarative session describes the EP fabric (4 ranks = 2 "nodes"
    # x 2) and hands the model ready-wired NIMBLE dispatchers
    session = Session(SessionSpec(
        topology=TopologySpec(n_devices=4, group_size=2), tenant="moe-train",
        device=args.device,
    ))
    ctx = ParallelContext(mesh=mesh, ep_size=4, group_size=2, moe_mode=args.mode,
                          device=args.device, session=session)
    model = build_model(cfg, ctx)
    params = model.init(args.seed)
    n_par = sum(x.numel() for x in leaves(params))
    where = (f"stacked on {args.device}" if mesh is None else
             f"mesh (data {ctx.data_procs}, model {ctx.model_procs}) of processes; "
             f"this one's blocks hold")
    say(f"[moe-train] {cfg.name}: {n_par / 1e6:.1f}M params ({where}), "
        f"{cfg.n_experts}e top-{cfg.top_k}, ep=4 in groups of 2, mode={args.mode}")

    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=steps)
    opt = adamw.init(params)
    step_fn = make_train_step(model, opt_cfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=args.batch, seed=args.seed))

    losses, t0 = [], time.time()
    for s in range(steps):
        params, opt, m = step_fn(params, opt, to_device(data.batch(s), args.device))
        losses.append(float(m["loss"]))
        if s % 20 == 0 or s == steps - 1:
            say(f"[moe-train] step {s:4d} loss {losses[-1]:.4f} "
                f"gnorm {float(m['grad_norm']):.3f} "
                f"({time.time() - t0:.1f}s)", flush=True)
    session.close()
    return losses


def _procs_worker(rank: int, world: int, args):
    from ..launch.mesh import ep_mesh_shape, make_test_mesh

    return train(args, make_test_mesh(world, ep_mesh_shape(world, 4)[1]),
                 verbose=rank == 0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--big", action="store_true", help="~100M params preset")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--mode", default="nimble", choices=["nimble", "direct", "stripe"],
                    help="dispatch/combine routing mode")
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--procs", type=int, default=None,
                    help="train across this many processes (8: the reference's "
                         "(data 2, model 4) mesh)")
    args = ap.parse_args(argv)
    if args.procs is None:
        losses = train(args)
    else:
        from ..launch.dist import spawn

        every = spawn(_procs_worker, args.procs, args,
                      backend="gloo" if args.device == "cpu" else "nccl", timeout_s=3600)
        losses = every[0]
        same = all(r == losses for r in every)
        print(f"[moe-train] {args.procs} processes: the global loss "
              f"{'equal' if same else 'DIFFERS'} on every process")
        assert same, "the processes' losses differ"

    first = np.mean(losses[:10])
    last = np.mean(losses[-10:])
    print(f"[moe-train] loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    assert last < first, "training did not reduce loss"
    return losses


if __name__ == "__main__":
    main()
