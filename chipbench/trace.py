"""Readings of a traced window: the profiler's device events and the host
syncs of a step.

The device's busy time is the union of its kernels', copies' and sets'
intervals in the profiler's trace; each idle gap between them is named by
the innermost host op in flight across it, as ``repro_torch``'s
``launch/profile.py`` names them (this is the benchmark's own copy of that
arithmetic).  Syncs are counted from ``torch.cuda.set_sync_debug_mode``'s
warnings, one at each call that makes the host wait for the card, the
autograd engine's device thread included (as ``launch/sync_audit.py``
counts them).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import warnings
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC_WARNING = "called a synchronizing CUDA operation"


def read(prof, top: int = 10):
    """-> (device op name -> (seconds, launches), seconds in which a device
    op ran, the ``top`` longest idle gaps between device ops as (host op in
    flight, seconds)), all from the profiler's trace: one export, no
    ``key_averages``, whose parse of every event takes minutes at a
    window's hundreds of thousands of events."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"])
    ops: Dict[str, Tuple[float, int]] = {}
    busy, gaps, start, end = 0.0, [], None, None
    for e in dev:
        t0, dur = float(e["ts"]), float(e["dur"])
        s, c = ops.get(e["name"], (0.0, 0))
        ops[e["name"]] = (s + dur * 1e-6, c + 1)
        if end is None or t0 > end:
            if end is not None:
                busy += end - start
                gaps.append((t0 - end, end))
            start, end = t0, t0 + dur
        else:
            end = max(end, t0 + dur)
    if end is not None:
        busy += end - start
    cpu = [e for e in events if e.get("cat") == "cpu_op"]
    named = []
    for dur, t in sorted(gaps, reverse=True)[:top]:
        over = [o for o in cpu if o["ts"] <= t and o["ts"] + o["dur"] >= t + dur]
        name = min(over, key=lambda o: o["dur"])["name"] if over else "no host op"
        named.append((name, dur * 1e-6))
    return ops, busy * 1e-6, named


@contextlib.contextmanager
def count_syncs():
    """Count the host syncs made inside the block: -> a one-element list."""
    import torch

    n = [0]
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield n
        finally:
            torch.cuda.set_sync_debug_mode(0)
    n[0] = sum(SYNC_WARNING in str(w.message) for w in seen)
