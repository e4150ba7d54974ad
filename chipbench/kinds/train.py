"""The training window: the port's AdamW train step, driven for as long as
the run lasts on the mix's pool of batches, timed with one synchronise at
its end.

Set-up builds one training object (the model of ``repro_torch`` with its
step from ``train/step.py::make_train_step`` and AdamW's state), with
weights made from the seed (``harness.seed_of``), and drives it through
the mix's ``check_steps`` first steps, on the pool's first batches, by the window's
own call.  Those steps warm every shape the window uses.  The judged
numbers are read from them: each step's loss, the first gradient's norm
per leaf as the optimizer took it (worked out from its first moment after
one step) and the parameters' change per leaf after the last.  The same
object then runs the window.  Once the window has closed, the program's
state is freed and the plain reference runs the same steps from the same
weights and batches.
"""

from __future__ import annotations

import numpy as np

from chipbench import compare, costs, gen, harness
from chipbench.kinds import common
from chipbench.reference import train as rt


def run(cell, seed: int, seconds: float, trace: bool, device: str, t_start: float):
    import torch
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw
    from repro_torch.sharding.context import ParallelContext
    from repro_torch.train.step import make_train_step

    mix, config = cell.mix, cell.config
    cfg, par = harness.program_config(config)
    model = build_model(cfg, ParallelContext(device=device, **par))
    shapes = model.mod.param_shapes(cfg)
    params = harness.make_weights(shapes, seed, par["param_dtype"], device, config)
    state = adamw.init(params)
    opt = dict(common.OPT_DEFAULTS, **mix["optimizer"])
    step = make_train_step(model, adamw.AdamWConfig(**opt))
    host_pool = gen.pool(seed, cfg.vocab, mix)
    pool = [common.to_device(b, device) for b in host_pool]
    b, s = mix["batch"], mix["seq"]

    # the judged first steps, through the window's own call
    n_check = mix["check_steps"]
    losses, raw, gnorm = [], None, None
    for i in range(n_check):
        params, state, m = step(params, state, pool[i])
        losses.append(m["loss"])
        if i == 0:
            gnorm = m["grad_norm"]
            raw = rt.leaf_norms(harness.flat(state.m))
    upd, now = {}, harness.flat(params)
    for j, (path, shape) in enumerate(harness.flat(shapes).items()):
        p0 = harness.make_leaf(path, shape, j, seed, par["param_dtype"], device, config)
        upd.update(rt.leaf_norms({path: now[path].float() - p0.float()}))
        del p0
    del now
    # the first moment after one step is (1 - beta1) times the clipped gradient
    unclip = (1 - opt["beta1"]) * min(1.0, opt["clip_norm"] / max(float(gnorm), 1e-9))
    prog = {"losses": [float(x) for x in losses],
            "raw": {k: v / unclip for k, v in raw.items()}, "update": upd}
    del raw, upd

    stats = {}
    idx = [n_check]

    def one():
        nonlocal params, state
        params, state, m = step(params, state, pool[idx[0] % len(pool)], stats=stats)
        idx[0] += 1
        return m["loss"]

    win = common.Window(device)
    losses_w = win.loop(one, seconds, trace, t_start)
    steps = len(losses_w)
    out_losses = torch.stack(losses_w).float().cpu().numpy()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    win.read_trace()
    dropped = int(stats.get("dropped", 0))
    assign = steps * b * s * cfg.top_k * cfg.n_layers
    metrics = {"train_tokens_per_s": steps * b * s / win.seconds, "setup_s": win.setup_s}
    obs = None
    if trace:
        times = {}
        for _ in range(2):
            params, state, _ = step(params, state, pool[idx[0] % len(pool)], times=times)
            idx[0] += 1
        syncs = [None]
        if device == "cuda":
            from chipbench import trace as tr
            with tr.count_syncs() as syncs:
                params, state, _ = step(params, state, pool[idx[0] % len(pool)])
                torch.cuda.synchronize()
        obs = common.Observed(
            kind="train", units=steps, window_s=win.seconds, busy_s=win.busy_s,
            ops=win.ops, phases_ms={k: v * 1e3 / 2 for k, v in times.items()},
            syncs_per_unit=syncs[0],
            least={"grouped_ffn": common.ffn_least(cfg, assign - dropped, steps, win.ops)},
            model_flops=costs.train_step_flops(harness.reference_config(config), b, s) * steps,
            model_s=win.seconds)
    common.diagnose(model, params, pool[0], cfg, dropped=dropped, assignments=assign,
                    peak=peak)
    del params, state, step, model, pool
    harness.free_device()

    ref = common.reference_train(config, shapes, seed, host_pool[:n_check], opt, device)
    checks = compare.train_numbers(prog, ref)
    gr = compare.leaf_gaps(prog["raw"], ref["raw"])
    up = compare.leaf_gaps(prog["update"], ref["update"], compare.moving_leaves(ref))
    for leaf in sorted(ref["raw"], key=lambda k: -gr[k])[:12]:
        print(f"[diag] leaf {leaf}: first gradient {prog['raw'][leaf]!r} (reference "
              f"{ref['raw'][leaf]!r}, gap {gr[leaf]:.3e}); change {prog['update'][leaf]!r} "
              f"(reference {ref['update'][leaf]!r}, gap {up.get(leaf, float('nan')):.3e})",
              flush=True)
    print(f"[diag] losses {prog['losses']} (reference {ref['losses']}, gap "
          f"{compare.loss_gap(prog, ref)!r})", flush=True)
    failed = int((~np.isfinite(out_losses)).sum())
    return harness.Outcome(metrics, steps, failed, checks, peak, obs, win.busy_s,
                           win.seconds if trace else None, win.breakdown)
