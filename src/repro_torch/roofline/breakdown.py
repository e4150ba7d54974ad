"""Where a dry run's bytes and collectives come from.

Counterpart of ``repro/roofline/breakdown.py``::

    PYTHONPATH=src python -m repro_torch.roofline.breakdown --arch xlstm-125m \\
        --shape train_4k [--set mlstm_chunk=64] [--top 20]

Runs one combo of the dry run (``launch/dryrun.py``) with the counter
attributing each op, and prints the reference's three sections: the top N
byte contributors with their op, the top collectives, and an aggregate by
name prefix; and a fourth: what is live at the step's peak (``temp``), by
the site that allocated it, the rest of the sites in one row, so that the
rows sum to ``temp``.  The counterpart of the reference's ``op_name`` is where the op
was dispatched: the innermost frame under ``src/repro_torch/``, as
``module.function:line``; the aggregate is by ``module.function``.  A row
sums every call of one op at one line (``xN``: the calls), as the
reference's rows multiply an instruction by its loops' trip counts.
"""

from __future__ import annotations

import argparse
import sys
from collections import defaultdict


def byte_rows(counter):
    """[(bytes, calls, op, site)] by bytes, largest first."""
    rows = [(b, n, op, site) for (site, op), (b, _, n) in counter.rows.items()]
    return sorted(rows, key=lambda r: -r[0])


def collective_rows(counter):
    """[(bytes, calls, kind, site)] by bytes, largest first."""
    rows = [(b, n, kind, site) for (site, kind), (b, n) in counter.coll_rows.items()]
    return sorted(rows, key=lambda r: -r[0])


def by_prefix(rows):
    """Bytes by ``module.function`` (the site without its line)."""
    agg = defaultdict(float)
    for b, _, _, site in rows:
        agg[site.rsplit(":", 1)[0]] += b
    return sorted(agg.items(), key=lambda x: -x[1])


def live_rows(counter):
    """[(bytes, storages, site)] live at ``temp_peak``, largest first."""
    return sorted(((b, n, site) for site, (b, n) in counter.peak_sites.items()),
                  key=lambda r: -r[0])


def live_section(counter, top: int) -> list:
    """The fourth section's lines: the ``top`` sites, then the rest in one row."""
    rows = live_rows(counter)
    lines = [f"live at the peak (temp {counter.temp_peak:.3e} bytes, "
             f"{sum(r[1] for r in rows)} storages), by allocating site:"]
    for b, n, site in rows[:top]:
        lines.append(f"  {b:10.3e} ({100 * b / max(counter.temp_peak, 1):5.1f}%) "
                     f"x{n:<6d} {site[:80]}")
    rest = rows[top:]
    if rest:
        b = sum(r[0] for r in rest)
        lines.append(f"  {b:10.3e} ({100 * b / max(counter.temp_peak, 1):5.1f}%) "
                     f"x{sum(r[1] for r in rest):<6d} ({len(rest)} more sites)")
    return lines


def main(argv=None) -> int:
    from ..launch.dryrun import _parse_kv, run_one

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--moe-mode", default="nimble")
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--set-ctx", action="append", default=[])
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)

    rec = run_one(args.arch, args.shape, multi_pod=args.multi_pod,
                  moe_mode=args.moe_mode, cfg_overrides=_parse_kv(args.set),
                  ctx_overrides=_parse_kv(args.set_ctx), attribute=True)
    if rec["status"] != "ok":
        print(f"{args.arch} x {args.shape}: {rec['status']}")
        return 0
    ro = rec["roofline"]
    print(f"{args.arch} x {args.shape}: dom={ro['dominant']} "
          f"comp={ro['compute_s']:.3e}s mem={ro['memory_s']:.3e}s "
          f"coll={ro['collective_s']:.3e}s")
    counter = rec["_counter"]

    rows = byte_rows(counter)
    total = sum(r[0] for r in rows) or 1.0
    print(f"\ntop {args.top} byte contributors (of {total:.3e} bytes):")
    for b, n, op, site in rows[: args.top]:
        print(f"  {b:10.3e} ({100 * b / total:5.1f}%) x{n:<6d} {op:26s} {site[:80]}")

    crows = collective_rows(counter)
    print(f"\ntop collectives ({sum(r[0] for r in crows):.3e} bytes total):")
    for b, n, kind, site in crows[: args.top]:
        print(f"  {b:10.3e} x{n:<6d} {kind:20s} {site[:80]}")

    print("\nby op_name prefix:")
    for k, v in by_prefix(rows)[:15]:
        print(f"  {v:10.3e} ({100 * v / total:5.1f}%)  {k}")

    print()
    print("\n".join(live_section(counter, args.top)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
