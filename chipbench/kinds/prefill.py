"""The prefill window: a closed loop of one client.  Each batch of prompts
is prefilled by the port's ``Model.forward(..., last_only=True)``, and the
next goes out as soon as its last positions' logits are on the host, so the
card is offered more than it can take and one batch is in service at a
time.  A batch's latency runs from its submission to its logits on the host.

Set-up builds the model of ``repro_torch`` with weights made from the
seed (``harness.seed_of``), puts the mix's pool of prompt batches on the
card, and prefills two of them.  The window serves the pool in turn.  Every serve keeps what the
judge reads: its greedy tokens (the last positions' argmax), its dropped
assignments, and the last expert layer's output at the batch's judged rows
(every prompt's last position and ``judge_rows_per_rank`` rows of each
rank's tokens, drawn from the seed), taken from the same forward call.
Once the window has closed, ``judge_serves`` serves drawn from the seed
over the whole window are judged by the plain reference, after the
program's state is freed.
"""

from __future__ import annotations

import time

import numpy as np

from chipbench import costs, gen, harness
from chipbench.kinds import common


def judge_rows(seed: int, j: int, b: int, s: int, ep: int, per_rank: int) -> np.ndarray:
    """The flat token rows of pool batch ``j`` whose expert-layer output is
    judged: every prompt's last position and ``per_rank`` rows drawn from
    the seed in each rank's contiguous share of the batch's tokens."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 3, j]))
    n = b * s // ep
    rows = {r * s + s - 1 for r in range(b)}
    for rank in range(ep):
        rows.update((rank * n + rng.choice(n, size=min(per_rank, n), replace=False)).tolist())
    return np.array(sorted(rows), dtype=np.int64)


def capture_rows(model, cap: dict) -> None:
    """Have the model's expert layer keep its output at the rows
    ``cap["rows"]`` (a device index, or None) in ``cap["y"]``: the last
    layer's, or None where the call held fewer rows."""
    apply = model.moe_apply

    def seen(p, x, **kw):
        y, aux, dropped = apply(p, x, **kw)
        if cap["rows"] is not None:
            flat = y.reshape(-1, y.shape[-1])
            cap["y"] = flat.index_select(0, cap["rows"]) if flat.shape[0] > cap["last"] else None
        return y, aux, dropped

    model.__dict__["moe_apply"] = seen


def run(cell, seed: int, seconds: float, trace: bool, device: str, t_start: float):
    import torch
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.context import ParallelContext

    mix, config = cell.mix, cell.config
    cfg, par = harness.program_config(config)
    rcfg = harness.reference_config(config)
    model = build_model(cfg, ParallelContext(device=device, **par))
    shapes = model.mod.param_shapes(cfg)
    params = harness.make_weights(shapes, seed, par["param_dtype"], device, config)
    host_pool = gen.pool(seed, cfg.vocab, mix)
    pool = [common.to_device({"tokens": b["tokens"]}, device) for b in host_pool]
    b, s = mix["batch"], mix["seq"]
    rows = [judge_rows(seed, j, b, s, rcfg["ep"], mix["judge_rows_per_rank"])
            for j in range(len(pool))]
    rows_dev = [torch.as_tensor(r, device=device) for r in rows]
    cap = {"rows": None, "y": None, "last": 0}
    capture_rows(model, cap)

    served = []                      # (pool batch, tokens, rows' output, dropped) a serve
    lat = []

    def serve(j: int):
        cap.update(rows=rows_dev[j], y=None, last=int(rows[j][-1]))
        stats = {}
        t = time.perf_counter()
        with torch.no_grad():
            logits, _ = model.forward(params, pool[j], last_only=True, stats=stats)
        out = logits[:, -1].float().cpu().numpy()
        lat.append(time.perf_counter() - t)
        served.append((j, np.argmax(out, axis=-1), cap["y"], stats.get("dropped", 0),
                       bool(np.isfinite(out).all())))

    for j in range(2):
        serve(j)
    served.clear()
    lat.clear()

    win = common.Window(device)
    win.loop(lambda: serve(len(lat) % len(pool)), seconds, trace, t_start)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    win.read_trace()
    units = len(lat)
    metrics = {"prefill_tokens_per_s": units * b * s / win.seconds, "setup_s": win.setup_s}
    drops = [int(d) for _, _, _, d, _ in served]
    obs = None
    if trace:
        kept = units * b * s * cfg.top_k * cfg.n_layers - sum(drops)
        obs = common.Observed(
            kind="prefill", units=units, window_s=win.seconds, busy_s=win.busy_s,
            ops=win.ops,
            least={"grouped_ffn": common.ffn_least(cfg, kept, units, win.ops),
                   "flash_attention": common.flash_least(rcfg, b, s, win.ops)},
            model_flops=costs.prefill_flops(rcfg, b, s) * units, model_s=win.seconds,
            latency_p95_ms=common.p95_ms(lat))
    print(f"[window] {units} batches served in {win.seconds:.3f} s; latency median "
          f"{1e3 * float(np.median(lat)):.3f} ms, p95 {common.p95_ms(lat):.3f} ms, max "
          f"{1e3 * max(lat):.3f} ms", flush=True)
    common.diagnose(model, params, pool[0], cfg, dropped=sum(drops),
                    assignments=units * b * s * cfg.top_k * cfg.n_layers, peak=peak,
                    last_only=True)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 2]))
    pick = sorted(rng.choice(units, size=min(mix["judge_serves"], units), replace=False))
    judged = [(served[i][0], served[i][1], None if served[i][2] is None else
               served[i][2].float().cpu(), drops[i]) for i in pick]
    failed = sum(1 for *_, ok in served if not ok)
    del params, model, pool, served, rows_dev
    harness.free_device()

    checks = judge(config, shapes, seed, host_pool, rows, judged, device)
    return harness.Outcome(metrics, units, failed, checks, peak, obs, win.busy_s,
                           win.seconds if trace else None, win.breakdown)


def judge(config, shapes, seed: int, host_pool, rows, judged, device: str) -> dict:
    """The widest of each number of :meth:`Judge.score` over the judged
    serves ``[(pool batch, served tokens, rows' output, dropped)]``."""
    import torch

    from chipbench.reference import model as rm

    rm.exact()
    rcfg = harness.reference_config(config)
    dtype = getattr(torch, config["parallel"]["param_dtype"])
    params = _float(harness.make_weights(shapes, seed, dtype, device, config))
    worst = {"gap": 0.0, "moe_gap": 0.0, "drops_out": 0.0}
    with torch.no_grad():
        for j in sorted({j for j, *_ in judged}):
            toks = torch.as_tensor(host_pool[j]["tokens"], dtype=torch.int64, device=device)
            ref = rm.Judge(params, toks, rows[j], rcfg)
            for jj, tok, y, dropped in judged:
                if jj == j:
                    for k, v in ref.score(tok, y, dropped).items():
                        worst[k] = max(worst[k], v)
            del ref
    return worst


def _float(tree):
    return {k: _float(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}
