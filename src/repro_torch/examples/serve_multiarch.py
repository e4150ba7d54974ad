"""Batched serving across architecture families.

    python -m repro_torch.examples.serve_multiarch [--adaptive] [--device cpu]

Counterpart of ``examples/serve_multiarch.py``.  Drives the ``ServeEngine``
(prefill + autoregressive decode with per-family caches: KV ring buffers,
Mamba and xLSTM recurrent states) for one reduced model per family, with
batched requests, greedy decoding (checked to be deterministic) and
temperature sampling (draws from a ``torch.Generator``, so they differ from
JAX's), on the card unless ``--device cpu`` is given.

With ``--adaptive`` it also routes a drifting expert-traffic trace through
the execution-time orchestration runtime (telemetry -> estimate -> replan
-> hot swap, every replan solved on ``--device``) and reports the
adaptive-vs-static completion-time ratio, then re-runs the serving tenant
as a fabric-arbitrated session next to a background elephant job and
reports the arbitrated combined-drain win and Jain fairness.  All stacks
are built through :class:`repro_torch.api.Session`: one ``SessionSpec``
field, ``adaptivity``, selects static / adaptive / arbitrated.

Its last line reads ``all families served``.
"""

import argparse
import time

import numpy as np
import torch

from ..configs.base import get_config
from ..models.registry import build_model
from ..serve.engine import ServeEngine
from ..sharding.context import ParallelContext

FAMILIES = [
    ("smollm-135m", "dense"),
    ("granite-moe-1b-a400m", "moe"),
    ("zamba2-1.2b", "hybrid"),
    ("xlstm-125m", "ssm"),
]


def adaptive_demo(device: str):
    """Orchestration-runtime demo: serve a drifting expert-routing trace.

    The receive hotspot (the popular expert's device) migrates, the
    runtime's telemetry and estimator detect the drift, and plans are
    re-solved off the hot path and hot-swapped between rounds.  The adaptive
    and static stacks differ by one ``SessionSpec`` field.
    """
    from ..api import Session, SessionSpec, TopologySpec
    from ..runtime import drifting_skew_trace

    n = 8
    tspec = TopologySpec(n_devices=n, group_size=4)
    trace = drifting_skew_trace(n, windows=36, dwell=9)
    with Session(SessionSpec(topology=tspec, adaptivity="adaptive", tenant="serve",
                             device=device)) as sess:
        adaptive = sess.run_trace(trace)
        rec = sess.report()
    with Session(SessionSpec(topology=tspec, device=device)) as static_sess:
        static = static_sess.run_trace(trace)
    speedup = static.total_completion_s / adaptive.total_completion_s
    print(
        f"[serve] adaptive runtime: {len(trace)} windows, "
        f"{len(adaptive.replan_windows)} replans "
        f"({adaptive.replan_fraction:.0%}), "
        f"{rec['cache']['hits']} cache hits, "
        f"speedup vs static plan {speedup:.2f}x, "
        f"link-util imbalance "
        f"{rec['telemetry']['utilization_imbalance']:.2f}"
    )
    multitenant_demo(tspec, trace, device)
    return speedup


def multitenant_demo(tspec, trace, device: str):
    """Fabric-arbiter demo: the same serving tenant sharing the fabric.

    A second tenant's elephant flows (direct-routed: a job the arbiter cannot
    re-plan) join the session's fabric as a static tenant; the serving
    session runs arbitrated, so its replans price the background in and
    route around it.  Reports the combined-fabric win over oblivious
    replanning and the fairness account.
    """
    from ..api import Session, SessionSpec
    from ..core.mcf import solve_direct
    from ..fabric import jains_index

    MB = float(1 << 20)
    bg_D = {(0, 4): 160 * MB, (4, 0): 160 * MB,
            (1, 5): 160 * MB, (5, 1): 160 * MB}
    bg = solve_direct(tspec.build(), bg_D)
    bg_time = bg.resource_bytes / bg.rm.capacity

    def replay(arbitrated):
        spec = SessionSpec(topology=tspec,
                           adaptivity="arbitrated" if arbitrated else "adaptive",
                           tenant="serve", device=device)
        with Session(spec) as sess:
            if arbitrated:
                sess.join_static_tenant("bg", bg)
            combined = own = 0.0
            for w in range(len(trace)):
                sess.step(trace[w])
                t = sess.runtime.telemetry.latest(1)[0].per_resource_time
                combined += float(np.max(t + bg_time))
                own += float(t.max())
            commits = sess.fabric.stats.commits if arbitrated else 0
        return combined, own, commits

    oblivious, _, _ = replay(False)
    arbitrated, serve_drain, commits = replay(True)
    # Jain over accumulated per-tenant drains (the ledger holds only the
    # serving tenant's last window)
    jain = jains_index([serve_drain, float(bg_time.max()) * len(trace)])
    print(
        f"[serve] multi-tenant arbiter: combined drain "
        f"{oblivious * 1e3:.1f}ms oblivious -> {arbitrated * 1e3:.1f}ms "
        f"arbitrated ({oblivious / arbitrated:.2f}x), "
        f"Jain {jain:.3f}, "
        f"{commits} ledger commits"
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--adaptive", action="store_true",
                    help="also run the orchestration-runtime and arbiter demos")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: the example serves on the card; pass --device cpu "
                 "to serve on the host")
    ctx = ParallelContext(device=args.device)
    rng = np.random.default_rng(0)
    served = {}
    for arch, fam in FAMILIES:
        cfg = get_config(arch).reduced()
        model = build_model(cfg, ctx)
        params = model.init(0)
        engine = ServeEngine(model, params, max_len=48)

        prompts = rng.integers(0, cfg.vocab, (4, 8)).astype(np.int32)
        t0 = time.time()
        greedy = engine.generate(prompts, n_new=16, temperature=0.0)
        sampled = engine.generate(prompts, n_new=16, temperature=0.8, seed=1)
        dt = time.time() - t0
        assert greedy.shape == (4, 16) and sampled.shape == (4, 16)
        again = engine.generate(prompts, n_new=16, temperature=0.0)
        assert np.array_equal(greedy, again), "greedy decode not deterministic"
        served[arch] = greedy
        print(f"[serve] {fam:7s} {cfg.name:28s} "
              f"batch=4 new=16x2 in {dt:5.1f}s  "
              f"greedy[0,:6]={greedy[0, :6].tolist()}")
    if args.adaptive:
        adaptive_demo(args.device)
    print("[serve] all families served batched requests deterministically")
    return served


if __name__ == "__main__":
    main()
