"""Readings that set the limits of ``correct``: the control and the planted
faults, at a cell's own size, against the plain reference.

    python3 chipbench/control.py --workload <name> --seeds 11 12 13 [--out FILE]

For each seed it makes the cell's weights and inputs as a run does, and
puts in the program's place:

  * ``control``: the reference in float8 e4m3 (``reference/model.py``,
    ``prec="fp8"``), the precision below the configuration's bfloat16;
  * ``half``: the reference over half of each batch's rows, the mean over
    the rest (training) / the first half of each batch served twice
    (serving);
  * ``exchange``: the reference with the exchange between ranks left out:
    each rank's assignments go to its own experts;
  * ``token``: a token altered where it is produced: each judged batch's
    first token id moved to the next id at the feed (training), the first
    prompt's served token moved to the next id (serving);
  * ``capacity`` (serving): the reference at half the configured capacity
    factor, dropping more.

A state left unchanged reads 1 on ``update_gap`` by its measure and is not
run.  Each reading is printed as one JSON line; the benchmark's own runs
never run this.  Needs a CUDA card, or ``--device cpu`` with a small
configuration (the tests).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

FAULTS = ("control", "half", "exchange", "token")


@contextlib.contextmanager
def planted(fault: str, rcfg: dict):
    """The reference with ``fault`` planted in it (none for ``control``)."""
    from chipbench.reference import model as rm

    saved = rm.experts
    if fault == "exchange":
        def experts(p, h, top_idx, gate, keep, prec):
            epd = rcfg["n_experts"] // rcfg["ep"]
            import torch
            rank = torch.arange(h.shape[0], device=h.device)[:, None] // (h.shape[0] // rcfg["ep"])
            return saved(p, h, rank * epd + top_idx % epd, gate, keep, prec)
        rm.experts = experts
    try:
        yield
    finally:
        rm.experts = saved


def train_readings(cell, seed: int, device: str):
    from chipbench import compare, gen, harness
    from chipbench.kinds import common

    rcfg = harness.reference_config(cell.config)
    opt = dict(common.OPT_DEFAULTS, **cell.mix["optimizer"])
    shapes = _shapes(cell)
    batches = gen.pool(seed, rcfg["vocab"], dict(cell.mix, pool=cell.mix["check_steps"]))
    ref = common.reference_train(cell.config, shapes, seed, batches, opt, device)
    out = {}
    for fault in FAULTS:
        with planted(fault, rcfg):
            use = batches
            if fault == "half":
                use = [{k: v[: v.shape[0] // 2] for k, v in b.items()} for b in batches]
            if fault == "token":
                use = [dict(b, tokens=b["tokens"].copy()) for b in batches]
                for b in use:
                    b["tokens"][0, 0] = (b["tokens"][0, 0] + 1) % rcfg["vocab"]
            got = _steps(cell, shapes, seed, use, opt, device,
                         "fp8" if fault == "control" else "f32")
        out[fault] = dict(compare.train_numbers(got, ref), loss_gap=compare.loss_gap(got, ref))
        harness.free_device()
    return out


def _steps(cell, shapes, seed, batches, opt, device, prec):
    import torch

    from chipbench import harness
    from chipbench.kinds import common
    from chipbench.reference import model as rm
    from chipbench.reference import train as rt

    rm.exact()
    dtype = getattr(torch, cell.config["parallel"]["param_dtype"])
    stored = harness.make_weights(shapes, seed, dtype, device, cell.config)
    return rt.first_steps(stored, [common.to_device(b, device) for b in batches],
                          harness.reference_config(cell.config), opt, prec)


def _shapes(cell):
    from chipbench import harness
    from repro_torch.models.registry import build_model

    cfg, _ = harness.program_config(cell.config)
    model = build_model(cfg)
    return model.mod.param_shapes(cfg)


def prefill_readings(cell, seed: int, device: str):
    """Each fault's widest numbers over ``judge_serves`` batches of the pool,
    each served once by the reference in the program's place."""
    import numpy as np
    import torch

    from chipbench import gen, harness
    from chipbench.kinds.prefill import _float, judge_rows
    from chipbench.reference import model as rm

    rm.exact()
    rcfg = harness.reference_config(cell.config)
    dtype = getattr(torch, cell.config["parallel"]["param_dtype"])
    shapes = _shapes(cell)
    tree = _float(harness.make_weights(shapes, seed, dtype, device, cell.config))
    mix = cell.mix
    b, s = mix["batch"], mix["seq"]
    pool = gen.pool(seed, rcfg["vocab"], mix)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 2]))
    pick = rng.choice(len(pool), size=min(mix["judge_serves"], len(pool)), replace=False)
    worst = {f: {} for f in FAULTS + ("capacity",)}
    with torch.no_grad():
        for j in sorted(pick):
            toks = torch.as_tensor(pool[j]["tokens"], dtype=torch.int64, device=device)
            rows = judge_rows(seed, j, b, s, rcfg["ep"], mix["judge_rows_per_rank"])
            r = torch.as_tensor(rows, device=device)
            ref = rm.Judge(tree, toks, rows, rcfg)
            for fault in worst:
                if fault == "half":          # half of the batch served, twice
                    z, _, d = rm.served(tree, toks[: b // 2], r[r < b * s // 2], rcfg)
                    got = (torch.cat([z, z]), None, 2 * d)
                else:
                    with planted(fault, rcfg):
                        got = rm.served(tree, toks, r, dict(rcfg, capacity_factor=rcfg[
                            "capacity_factor"] / 2) if fault == "capacity" else rcfg,
                            "fp8" if fault == "control" else "f32")
                z, y, d = got
                tok = z.argmax(-1).cpu().numpy()
                if fault == "token":
                    tok[0] = (tok[0] + 1) % rcfg["vocab"]
                for k, v in ref.score(tok, y, d).items():
                    worst[fault][k] = max(worst[fault].get(k, 0.0), v)
            del ref
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from chipbench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.resolve(bench, args.workload)
    kind = cell.mix["kind"]
    for seed in args.seeds:
        read = train_readings if kind == "train" else prefill_readings
        line = json.dumps({"workload": cell.name, "seed": seed, **read(cell, seed, args.device)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
