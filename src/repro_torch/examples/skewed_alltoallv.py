"""Skewed All-to-Allv on the NIMBLE dataplane, through one ``Session``.

    python -m repro_torch.examples.skewed_alltoallv [--device cpu] [--procs P]

Counterpart of ``examples/skewed_alltoallv.py``.  The reference runs its
``shard_map`` dataplane over 8 forced host devices; here the 8 ranks (2
nodes x 4, the paper's Fig. 7 setup) are stacked in one process on the card
(or on the CPU with ``--device cpu``), or with ``--procs P`` spread over
``P`` processes as the reference spreads them over devices (``n / P``
ranks each): live demand matrix -> MWU planner -> scheduled relay rounds.
The result is checked bit for bit against the numpy oracle ``ref_all_to_allv`` in all three modes (direct, stripe,
nimble) under a hotspot-ratio sweep.  The dataplane endpoints come
ready-wired from one :class:`repro_torch.api.Session`
(``session.all_to_all``).

Wall-clock here is not fabric bandwidth (the stacked ranks move data
through one device's memory), so each mode's projected completion time on
the paper's fabric comes from the planner's own link-time model
(``fabsim.simulate`` of ``session.plan``).  It ends with the line "all
modes bit-exact vs oracle", and fails (AssertionError) before it otherwise.
"""

import argparse

import numpy as np
import torch

from ..api import Session, SessionSpec, TopologySpec
from ..core import fabsim
from ..core.dataplane import ref_all_to_allv

HOTSPOTS = (0.3, 0.7, 0.9)
MODES = ("direct", "stripe", "nimble")


def skewed_counts(n, max_chunks, hotspot, rng):
    """Per (src, dst) chunk counts with a hot destination (Fig. 7)."""
    counts = np.zeros((n, n), dtype=np.int32)
    for s in range(n):
        hd = 0 if s != 0 else 1
        budget = max_chunks
        counts[s, hd] = int(round(budget * hotspot))
        others = [d for d in range(n) if d not in (s, hd)]
        for d in others:
            counts[s, d] = int(budget * (1 - hotspot) / len(others))
    return counts


def sweep(device, group=None):
    """The hotspot sweep on this process's block of the 8 ranks (all of them
    without ``group``) -> ``{hotspot: {mode: (bit_exact, projected_s)}}``."""
    n, C, E = 8, 32, 64               # 8 ranks, <=32 chunks/dst, 64 floats each
    P = 1 if group is None else torch.distributed.get_world_size(group)
    r0 = 0 if group is None else torch.distributed.get_rank(group) * (n // P)
    blk = slice(r0, r0 + n // P)
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    results = {}

    spec = SessionSpec(topology=TopologySpec(n_devices=n, group_size=4),
                       device=device)
    with Session(spec) as sess:
        for hotspot in HOTSPOTS:
            counts = skewed_counts(n, C, hotspot, rng)
            x_all = rng.normal(size=(n, n, C, E)).astype(np.float32)
            for s in range(n):
                for d in range(n):
                    x_all[s, d, counts[s, d]:] = 0.0
            yref, rref = ref_all_to_allv(x_all, counts)
            results[hotspot] = {}
            for mode in MODES:
                comm = sess.all_to_all(max_chunks=C, chunk_bytes=E * 4, mode=mode,
                                       group=group)
                y, r = comm(torch.as_tensor(x_all[blk], device=dev),
                            torch.as_tensor(counts[blk], device=dev))
                ok = (np.array_equal(y.cpu().numpy(), yref[blk])
                      and np.array_equal(r.cpu().numpy(), rref[blk]))
                # projected completion time on the calibrated fabric
                demands = {(s, d): float(counts[s, d]) * E * 4 * 2**14
                           for s in range(n) for d in range(n)
                           if counts[s, d]}
                t = fabsim.simulate(sess.plan(demands, mode=mode)).completion_time
                results[hotspot][mode] = (ok, t)
    return results


def _procs_worker(rank: int, world: int, device: str):
    from ..launch.mesh import make_test_mesh

    return sweep(device, make_test_mesh(world, world).get_group("model"))


def main(argv=None):
    """Run the sweep; returns ``{hotspot: {mode: (bit_exact, projected_s)}}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--procs", type=int, default=None,
                    help="spread the 8 ranks over this many processes (gloo on the "
                         "CPU, a card each under NCCL on the card)")
    args = ap.parse_args(argv)
    if args.procs is None:
        results = sweep(args.device)
    else:
        from ..launch.dist import spawn

        backend = "gloo" if args.device == "cpu" else "nccl"
        every = spawn(_procs_worker, args.procs, args.device, backend=backend)
        # bit-exact on every process; the projection is the same host plan
        results = {h: {m: (all(r[h][m][0] for r in every), every[0][h][m][1])
                       for m in MODES} for h in HOTSPOTS}
        print(f"8 ranks over {args.procs} processes, {8 // args.procs} each")
    for hotspot, by_mode in results.items():
        print(f"\nhotspot={hotspot}")
        for mode, (ok, t) in by_mode.items():
            print(f"  {mode:7s} bit-exact={'OK' if ok else 'FAIL'}   "
                  f"projected completion {t * 1e3:8.3f} ms")
            assert ok, f"dataplane {mode} mismatch"
    print("\nall modes bit-exact vs oracle")
    return results


if __name__ == "__main__":
    main()
