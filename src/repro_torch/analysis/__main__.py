"""CLI: ``python -m repro_torch.analysis [paths...]``.

Counterpart of ``repro/analysis/__main__.py``.  Exit codes: 0 clean, 1
findings (or stale lock under ``--check-lock``), 2 usage error.  Default
target is the ``src/repro_torch`` tree this module ships in; paths are
reported relative to ``src/`` so baseline entries stay machine-independent.

``--write-lock`` regenerates *both* committed manifests —
``schemas.lock.json`` (emitted record kinds/keys) and
``retrace.lock.json`` (the ``host-sync`` site inventory, line-free keys) —
plus the digest-keyed function-summary cache; ``--check-lock`` fails
when regenerating either lock is not a no-op.  ``--debt`` prints the
suppression/baseline ledger; ``--retrace-out`` / ``--units-out`` dump
the ``nimble.retrace/v1`` / ``nimble.units/v1`` inventories.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..jsonio import json_dumps, tag, write_json_file
from .callgraph import SummaryCache, build_program
from .engine import (
    AnalysisEngine,
    build_contexts,
    collect_debt,
    default_baseline_path,
    default_lock_path,
    load_baseline,
    write_baseline,
)
from .provenance import (
    analyze_program,
    build_retrace_inventory,
    default_retrace_lock_path,
    retrace_lock_is_fresh,
    write_retrace_lock,
)
from .rules import RULES, HostSyncRule
from .schemas import lock_is_fresh, write_lock
from .units import build_units_inventory

DEBT_KIND = "lint_debt"


def _default_root() -> str:
    # src/repro_torch/analysis/__main__.py -> src/repro_torch
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def default_summary_cache_path() -> str:
    return os.path.join(os.path.dirname(__file__), "summaries.cache.json")


def _emit(path: str, obj: dict) -> None:
    if path == "-":
        sys.stdout.write(json_dumps(obj, indent=True).decode() + "\n")
    else:
        write_json_file(path, obj)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="NIMBLE static invariant checker, over the PyTorch port",
    )
    parser.add_argument(
        "paths", nargs="*", help="files/dirs to lint (default: src/repro_torch)"
    )
    parser.add_argument(
        "--json", metavar="PATH",
        help="write the nimble.lint/v1 report here ('-' for stdout)",
    )
    parser.add_argument(
        "--baseline", metavar="PATH", default=None,
        help=f"baseline file (default: {default_baseline_path()})",
    )
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="ignore the baseline — report grandfathered findings too",
    )
    parser.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite the baseline from this run's findings and exit 0",
    )
    parser.add_argument(
        "--write-lock", action="store_true",
        help="regenerate schemas.lock.json + retrace.lock.json + the "
        "summary cache from the scanned files",
    )
    parser.add_argument(
        "--check-lock", action="store_true",
        help="also fail when regenerating either lock is not a no-op",
    )
    parser.add_argument(
        "--debt", action="store_true",
        help="list every inline suppression and baseline entry, then exit",
    )
    parser.add_argument(
        "--retrace-out", metavar="PATH",
        help="write the nimble.retrace/v1 site inventory ('-' for stdout)",
    )
    parser.add_argument(
        "--units-out", metavar="PATH",
        help="write the nimble.units/v1 inventory ('-' for stdout)",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog"
    )
    parser.add_argument(
        "-q", "--quiet", action="store_true", help="summary line only"
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in RULES:
            print(f"{rule.rule_id:20s} {rule.description}")
        print(f"{'suppression':20s} suppression hygiene (engine built-in)")
        print(f"{'baseline':20s} stale/reasonless baseline entries "
              "(engine built-in)")
        return 0

    root = _default_root()
    paths = args.paths or [root]
    rel_to = os.path.dirname(root)  # .../src — reports say repro_torch/...
    contexts = build_contexts(paths, rel_to=rel_to)

    if args.write_lock:
        cache = SummaryCache(default_summary_cache_path())
        program = build_program(contexts, cache=cache)
        analysis = analyze_program(program)
        lock = write_lock(contexts, default_lock_path())
        retrace = write_retrace_lock(
            program, default_retrace_lock_path(), analysis
        )
        cache.save()
        print(
            f"[analysis] wrote {default_lock_path()} "
            f"({len(lock['kinds'])} kinds)"
        )
        print(
            f"[analysis] wrote {default_retrace_lock_path()} "
            f"({len(retrace['entries'])} sites)"
        )
        print(
            f"[analysis] wrote {default_summary_cache_path()} "
            f"({cache.hits} cached, {cache.misses} summarized)"
        )
        return 0

    baseline = (
        [] if args.no_baseline else load_baseline(args.baseline)
    )

    if args.debt:
        debt = collect_debt(contexts, baseline)
        for s in debt["suppressions"]:
            rules = ",".join(s["rules"])
            print(
                f"{s['path']}:{s['line']}: suppressed [{rules}] "
                f"-- {s['reason'] or '(no reason)'}"
            )
        for e in debt["baseline"]:
            age = f" since {e['since']}" if e.get("since") else ""
            reason = e.get("reason") or "(no reason)"
            print(
                f"{e['path']}: baselined [{e['rule']}]{age} -- {reason}: "
                f"{e['message']}"
            )
        print(
            f"[analysis] debt: {len(debt['suppressions'])} suppression(s), "
            f"{len(debt['baseline'])} baseline entr(ies)"
        )
        if args.json:
            _emit(args.json, tag(DEBT_KIND, debt))
        return 0

    cache = None
    if os.path.exists(default_summary_cache_path()) and not args.paths:
        cache = SummaryCache(default_summary_cache_path())
    engine = AnalysisEngine(RULES, baseline)
    report = engine.run(contexts, root=";".join(paths), cache=cache)

    if args.update_baseline:
        path = args.baseline or default_baseline_path()
        write_baseline(report.findings, path)
        print(
            f"[analysis] baselined {len(report.findings)} finding(s) -> {path}"
        )
        return 0

    if not args.quiet:
        for f in report.findings:
            print(f)

    retrace_rule = next(
        r for r in engine.rules if isinstance(r, HostSyncRule)
    )
    program = engine.program
    if args.retrace_out and program is not None:
        _emit(args.retrace_out, build_retrace_inventory(
            program, retrace_rule.analysis
        ))
    if args.units_out and program is not None:
        _emit(args.units_out, build_units_inventory(program))

    lock_fresh = True
    if args.check_lock:
        lock_fresh = lock_is_fresh(default_lock_path(), contexts)
        if not lock_fresh:
            print(
                "[analysis] schemas.lock.json is stale — regenerate with "
                "--write-lock (and bump versions for changed kinds)"
            )
        if program is not None:
            retrace_fresh = retrace_lock_is_fresh(
                default_retrace_lock_path(), program, retrace_rule.analysis
            )
            if not retrace_fresh:
                print(
                    "[analysis] retrace.lock.json is stale — the "
                    "host-sync inventory changed; regenerate with "
                    "--write-lock"
                )
            lock_fresh = lock_fresh and retrace_fresh
    status = "clean" if report.clean and lock_fresh else "FAIL"
    print(
        f"[analysis] {status}: {report.files} files, "
        f"{len(report.findings)} finding(s), "
        f"{len(report.suppressed)} suppressed, "
        f"{len(report.baselined)} baselined"
    )
    if args.json:
        _emit(args.json, report.to_json_obj())
    return 0 if report.clean and lock_fresh else 1


if __name__ == "__main__":
    sys.exit(main())
