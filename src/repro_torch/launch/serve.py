"""Serving launcher: scenario control plane + batched generation.

Scenario mode — run a registry (or JSON-file) scenario through the
continuous-traffic control plane and print the SLO verdict, every runtime
solve on ``--device`` (the card unless ``cpu`` is named):

    python -m repro_torch.launch.serve --scenario steady
    python -m repro_torch.launch.serve --scenario path/to/spec.json \
        --mode static --json report.json
    python -m repro_torch.launch.serve --list-scenarios

With ``--trace-out PATH`` the run is flight-recorded: a
:class:`repro_torch.obs.FlightRecorder` rides the adaptive arm and the
resulting ``nimble.trace/v1`` record — valid Chrome/Perfetto trace JSON
with one correlation id across serve / runtime / fabric / planner — is
written to PATH (open it at ``ui.perfetto.dev`` or ``chrome://tracing``).
``--metrics-out PATH`` writes the final ``nimble.metrics/v1`` snapshot;
either flag also prints trace and plan-provenance summaries:

    python -m repro_torch.launch.serve --scenario flap_under_load \
        --mode both --device cpu --trace-out t.json

Generation mode — batched generation through ``ServeEngine``:

    python -m repro_torch.launch.serve --arch paper-moe-8e --ep 8 \
        --batch 4 --prompt-len 8 --new-tokens 8
    python -m repro_torch.launch.serve --arch xlstm-125m \
        --batch 4 --prompt-len 128 --new-tokens 16
    python -m repro_torch.launch.serve --arch llama3-8b \
        --batch 4 --prompt-len 8 --new-tokens 8
    python -m repro_torch.launch.serve --arch zamba2-1.2b

runs any of the reference's models at full width on the card with random weights from
``--seed`` (without a card it exits non-zero unless ``--device cpu`` is
given).  A MoE model runs expert-parallel over ``--ep`` stacked ranks
(default 8) in groups of up to 4 with NIMBLE dispatch; the other families
have no experts, so ``--ep`` above 1 is refused for them.  The audio
family decodes against zero encoder states, as the reference's engine
does.  One
generation of the same requests runs first as a warm-up (its time is
printed too), so the timed one pays no first-call costs.  ``--reduced``
shrinks the model to smoke-test widths and ``--device cpu`` runs on the
CPU (the kernels' plain versions).
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
from ..sharding.context import DTYPES, ParallelContext


def _run_scenario(args) -> int:
    from ..jsonio import write_json_file
    from ..obs import FlightRecorder, validate_trace
    from ..serve import evaluate_scenario, load_scenario, run_scenario

    spec = load_scenario(args.scenario)
    recorder = None
    if args.trace_out or args.metrics_out:
        recorder = FlightRecorder()
    t0 = time.time()
    if args.mode == "both":
        res = evaluate_scenario(spec, recorder=recorder, device=args.device)
        report, slo = res["adaptive"], res["slo"]
    else:
        report = run_scenario(spec, args.mode, recorder=recorder,
                              device=args.device)
        slo = None
    dt = time.time() - t0

    tenants = report.tenants
    print(
        f"[serve] scenario {spec.name!r}: {spec.windows} windows, "
        f"{len(tenants)} tenant(s), mode={report.mode}, solves on "
        f"{args.device} ({dt:.1f}s)"
    )
    print(
        f"[serve] cluster: total {report.total_completion_s:.4f}s, "
        f"median {report.median_latency_s() * 1e3:.2f}ms, "
        f"availability {report.availability:.2f}, "
        f"Jain {report.jain_index:.3f}"
    )
    for name, led in sorted(tenants.items()):
        life = f"w{led.joined}-" + (
            f"w{led.left}" if led.left is not None else "end"
        )
        print(
            f"[serve]   {name}: {life} {led.windows}w "
            f"{led.completion_s:.4f}s drain, {led.replans} replans"
            + (" (crashed)" if led.crashed else "")
        )
    if slo is not None:
        for gate, v in slo["gates"].items():
            val = v["value"]
            shown = f"{val:.3f}" if isinstance(val, float) else str(val)
            print(
                f"[serve]   gate {gate}: "
                f"{'PASS' if v['ok'] else 'FAIL'} "
                f"(value {shown}, limit {v['limit']})"
            )
        print(f"[serve] SLO: {'PASS' if slo['pass'] else 'FAIL'}")
    if recorder is not None:
        trace = recorder.export_trace()
        info = validate_trace(trace)
        print(
            f"[serve] trace: {info['events']} events, {info['spans']} spans, "
            f"layers={sorted(info['cats'])}, corr={info['correlation_id']}"
        )
        print(
            f"[serve] provenance: {len(recorder.provenance)} plans issued, "
            f"{len(recorder.provenance.swapped())} swapped"
        )
        if args.trace_out:
            write_json_file(args.trace_out, trace)
            print(f"[serve] trace -> {args.trace_out}")
        if args.metrics_out:
            write_json_file(args.metrics_out, recorder.metrics_snapshot())
            print(f"[serve] metrics -> {args.metrics_out}")
    if args.json:
        obj = report.to_json_obj()
        if slo is not None:
            obj["slo"] = slo
        write_json_file(args.json, obj)
        print(f"[serve] report -> {args.json}")
    return 0 if slo is None or slo["pass"] else 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    # scenario mode
    ap.add_argument("--scenario", default=None,
                    help="registry name or scenario JSON path")
    ap.add_argument("--mode", default="both",
                    choices=("adaptive", "static", "both"),
                    help="control-plane arm; 'both' also gates the SLOs")
    ap.add_argument("--json", default=None,
                    help="write the nimble.serve/v1 report here")
    ap.add_argument("--trace-out", metavar="PATH", default=None,
                    help="flight-record the run and write the "
                         "nimble.trace/v1 Chrome trace JSON here")
    ap.add_argument("--metrics-out", metavar="PATH", default=None,
                    help="write the final nimble.metrics/v1 snapshot here")
    ap.add_argument("--list-scenarios", action="store_true")
    # generation mode
    ap.add_argument("--arch", default="paper-moe-8e")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ep", type=int, default=None,
                    help="expert-parallel ranks (moe only; default 8)")
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.list_scenarios:
        from ..serve import scenario_names

        print("\n".join(scenario_names()))
        return 0
    if args.scenario is not None:
        return _run_scenario(args)
    return _run_generate(args, ap)


def _run_generate(args, ap):
    cfg = get_config(args.arch)
    ep = args.ep if args.ep is not None else (8 if cfg.arch_type == "moe" else 1)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), n_experts=cfg.n_experts)
    dt = DTYPES[args.dtype]
    ctx = ParallelContext(ep_size=ep, group_size=min(4, ep), moe_mode="nimble",
                          param_dtype=dt, compute_dtype=dt, device=args.device)
    try:
        model = build_model(cfg, ctx)
    except ValueError as e:               # e.g. --ep > 1 for a family without experts
        ap.error(str(e))
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            ap.error("no CUDA device: the port serves on the card; pass --device cpu "
                     "to serve on the host")
        _build.build()                    # compile before the clock starts
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
    print(f"[serve] {cfg.name} ep={ep} on {where}: generated {out.shape} "
          f"in {dt_s:.2f}s ({args.batch * args.new_tokens / dt_s:.1f} tok/s; "
          f"warm-up run {warm_s:.2f}s)")
    print("[serve] sample:", out[0][:12].tolist())
    return out


if __name__ == "__main__":
    main()
