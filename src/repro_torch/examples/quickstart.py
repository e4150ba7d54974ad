"""Quickstart: NIMBLE's control plane in a minute, on the card.

    python -m repro_torch.examples.quickstart [--device cpu]

Counterpart of ``examples/quickstart.py``, parts 1-3.  One
:class:`repro_torch.api.Session` over the paper's testbed fabric (2 nodes x
4 GPUs) plans a skewed exchange with the three routing policies compared on
the calibrated fabric simulator:

  * ``direct``: static least-hop routing (NCCL/PXN-like baseline);
  * ``stripe``: static even multi-rail striping (UCX-like baseline);
  * ``nimble``: the paper's execution-time multiplicative-weights MCF;

and gives the MWU plan's gap to the congestion lower bound.  Then a
:class:`repro_torch.obs.FlightRecorder` traces an adaptive run over a
drifting hotspot, and a reduced granite-moe-1b-a400m runs a forward pass.
Every solve and the forward run on ``--device`` (the card by default).
The reference's part 4 lints a fixture with ``repro.analysis``, which has
no counterpart in this package yet: it prints one line that says so.
"""

import argparse

import torch

from ..api import Session, SessionSpec, TopologySpec
from ..core import fabsim, mcf


def skewed_demand(n: int, total_bytes: float, hotspot: float, hot_dst: int = 0):
    """Paper Fig. 7 traffic model: each rank sends ``hotspot`` of its payload
    to one hot destination, the rest spread evenly."""
    d = {}
    for s in range(n):
        peers = [p for p in range(n) if p != s]
        hd = hot_dst if hot_dst != s else (hot_dst + 1) % n
        for p in peers:
            d[(s, p)] = total_bytes * (1 - hotspot) / (len(peers) - 1) \
                if p != hd else total_bytes * hotspot
    return d


def main(argv=None) -> torch.Tensor:
    """Runs parts 1-3 and prints their figures -> the granite forward's logits."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: the quickstart runs on the card; pass --device cpu "
                 "to run on the host")

    # ---- 1. control plane: plan + simulate a skewed exchange ---------------
    spec = SessionSpec(topology=TopologySpec(n_devices=8, group_size=4), device=args.device)
    with Session(spec) as sess:                    # 2 "nodes" x 4 "GPUs"
        topo = sess.topo
        print(f"topology: {topo.n_devices} devices, {topo.n_groups} groups, "
              f"{len(topo.links)} directed links")

        msg = 64 * 2**20                           # 64 MB per source
        print(f"\n{'hotspot':>8s} {'direct':>10s} {'stripe':>10s} "
              f"{'nimble':>10s} {'speedup':>8s}  bottleneck")
        for hot in [0.125, 0.3, 0.5, 0.7, 0.9]:
            demands = skewed_demand(8, msg, hot)
            plans = {mode: sess.plan(demands, mode=mode)
                     for mode in ("direct", "stripe", "nimble")}
            res = fabsim.compare(plans)
            t = {k: r.completion_time * 1e3 for k, r in res.items()}
            speed = t["direct"] / t["nimble"]
            print(f"{hot:8.3f} {t['direct']:9.2f}ms {t['stripe']:9.2f}ms "
                  f"{t['nimble']:9.2f}ms {speed:7.2f}x  "
                  f"{res['nimble'].bottleneck_kind(plans['nimble'])}")

        # optimality: compare against the capacity-normalized congestion LB
        demands = skewed_demand(8, msg, 0.7)
        plan = sess.plan(demands)
        lb = mcf.congestion_lower_bound(topo, demands)
        z = fabsim.simulate(plan).completion_time
        print(f"\nMWU congestion vs lower bound: {z:.4f}s vs {lb:.4f}s "
              f"(gap {100 * (z / lb - 1):.1f}%)")

    # ---- 2. flight recorder: trace one adaptive run -----------------------
    from ..obs import FlightRecorder, validate_trace
    from ..runtime import drifting_skew_trace

    rec = FlightRecorder()
    adaptive_spec = SessionSpec(topology=TopologySpec(n_devices=8, group_size=4),
                                adaptivity="adaptive", device=args.device)
    with Session(adaptive_spec, recorder=rec) as sess:
        sess.run_trace(drifting_skew_trace(8, 12, dwell=4))
    info = validate_trace(rec.export_trace())
    swapped = rec.provenance.swapped()
    print(f"\nflight recorder: {info['events']} trace events, "
          f"{info['spans']} spans, layers={info['cats']}, "
          f"corr={info['correlation_id']}; "
          f"{len(rec.provenance)} plans issued, {len(swapped)} swapped")

    # ---- 3. model registry: one assigned arch, reduced, forward pass -------
    from ..configs.base import get_config
    from ..models.registry import build_model
    from ..sharding.context import ParallelContext
    from ..tree import leaves

    cfg = get_config("granite-moe-1b-a400m").reduced()
    model = build_model(cfg, ParallelContext(device=args.device))
    params = model.init(0)
    n_par = sum(x.numel() for x in leaves(params))
    toks = torch.zeros((2, 16), dtype=torch.int64, device=args.device)
    with torch.no_grad():
        logits, _ = model.forward(params, {"tokens": toks})
    print(f"\nmodel {cfg.name}: {n_par / 1e6:.2f}M params, "
          f"logits {tuple(logits.shape)}, finite={bool(torch.isfinite(logits).all())}")

    # ---- 4. the static invariant checker ----------------------------------
    print("\nstatic checker: not in this package (the reference's repro.analysis "
          "lints JAX code; run examples/quickstart.py for it)")
    return logits


if __name__ == "__main__":
    main()
