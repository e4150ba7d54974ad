"""The card's own report of a step's host syncs, held against the checker's
``host-sync`` inventory (``repro_torch.analysis``).

``torch.cuda.set_sync_debug_mode("warn")`` warns at every call that makes
the host wait for the card, and the GPU trace (``torch.cuda._gpu_trace``,
which ``torch.cuda._sanitizer`` uses) calls back at the sync itself.  Both
fire on the thread that makes the sync, the autograd engine's device thread
included.  :func:`record_syncs` records both: for each traced sync, and for
each sync warning through a ``warnings.showwarning`` hook, the innermost
frame under ``src/repro_torch/`` (a lambda's or a comprehension's frame
stands for the function around it).  :func:`unmatched` gives the syncs that
only one of the two saw; the audit fails on any.  The debug mode's own
notice that it is a prototype is not a sync and is not counted.

:func:`audit` runs one paper-moe-8e train step at full width (4 x 512,
EP 8 in groups of 4, bf16) after a warm-up step, with ``times=None`` (the
step's own phase timer synchronises on purpose), then one decode step of
``make_serve_step`` after a warm-up one; :func:`unlisted` gives each
recorded (file, function) that the inventory lacks.

Usage (on the card):
    PYTHONPATH=src python -m repro_torch.launch.sync_audit         # exits 1 on an unlisted site
    PYTHONPATH=src python -m repro_torch.launch.sync_audit --raw   # the syncs alone
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import os
import sys
import warnings
from typing import Dict, List, Tuple

import torch

#: src/repro_torch, and the directory that paths are reported against
PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.dirname(PKG_DIR)

Site = Tuple[str, str, int]          # (path under src/, function, line)

#: the text of ``set_sync_debug_mode("warn")``'s warning
SYNC_WARNING = "called a synchronizing CUDA operation"


@dataclasses.dataclass
class SyncLog:
    """The syncs of one recorded span: each traced sync's site, and the site
    where each sync warning surfaced."""

    sites: List[Site] = dataclasses.field(default_factory=list)
    warned: List[Site] = dataclasses.field(default_factory=list)

    @property
    def warnings(self) -> int:
        return len(self.warned)

    def by_site(self) -> Dict[Tuple[str, str], int]:
        """(path, function) -> syncs there."""
        return dict(collections.Counter((p, f) for p, f, _ in self.sites))


def _site() -> Site:
    """The innermost frame of the calling thread under ``src/repro_torch/``
    (not this module); a ``<lambda>``/``<genexpr>`` frame gives way to the
    function around it in the same file."""
    f = sys._getframe(1)
    here = os.path.abspath(__file__)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path.startswith(PKG_DIR + os.sep) and path != here:
            line = f.f_lineno
            while f.f_code.co_name.startswith("<") and f.f_back is not None and (
                    os.path.abspath(f.f_back.f_code.co_filename) == path):
                f = f.f_back
            return os.path.relpath(path, SRC_DIR).replace(os.sep, "/"), f.f_code.co_name, line
        f = f.f_back
    return "<outside repro_torch>", "", 0


# The GPU trace's callbacks are process-wide and cannot be removed once
# registered: one registration a process (_TRACE_ON), and the span being
# recorded, if any, is the module's (_LOG).
_LOG: List[SyncLog] = []
_TRACE_ON: List[bool] = []


def _on_sync(*_args) -> None:
    if _LOG:
        _LOG[-1].sites.append(_site())


def _on_warning(message, category, filename, lineno, file=None, line=None) -> None:
    if _LOG and SYNC_WARNING in str(message):
        _LOG[-1].warned.append(_site())
    else:
        warnings._showwarning_orig(message, category, filename, lineno, file, line)


def _trace() -> None:
    """Register the callbacks and turn the GPU trace on, once a process."""
    if _TRACE_ON:
        return
    from torch.cuda import _gpu_trace

    _gpu_trace.register_callback_for_stream_synchronization(_on_sync)
    _gpu_trace.register_callback_for_device_synchronization(_on_sync)
    _gpu_trace.register_callback_for_event_synchronization(_on_sync)
    torch._C._activate_gpu_trace()
    _TRACE_ON.append(True)


@contextlib.contextmanager
def record_syncs():
    """Record the syncs made inside the block -> a :class:`SyncLog`."""
    _trace()
    log = SyncLog()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = _on_warning
        torch.cuda.set_sync_debug_mode("warn")
        _LOG.append(log)
        try:
            yield log
        finally:
            _LOG.pop()
            torch.cuda.set_sync_debug_mode("default")


def audit(seed: int = 0) -> Dict[str, SyncLog]:
    """{"train": one paper-moe-8e train step's syncs, "decode": one decode
    step's} at full width on the card, each after a warm-up step."""
    from ..configs.base import InputShape, get_config
    from ..data.pipeline import DataConfig, SyntheticLM, to_device
    from ..models.registry import build_model
    from ..optim import adamw
    from ..serve.engine import make_serve_step
    from ..sharding.context import ParallelContext
    from ..train.step import make_train_step

    cfg = get_config("paper-moe-8e")
    bf16 = torch.bfloat16
    ctx = ParallelContext(ep_size=8, group_size=4, moe_mode="nimble", param_dtype=bf16,
                          compute_dtype=bf16, device="cuda")
    model = build_model(cfg, ctx)
    params = model.init(seed)
    state = adamw.init(params)
    step = make_train_step(model, adamw.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=100))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=512, global_batch=4, seed=seed))
    batches = [to_device(data.batch(i), "cuda") for i in range(2)]
    params, state, _ = step(params, state, batches[0])
    torch.cuda.synchronize()
    with record_syncs() as train:
        params, state, _ = step(params, state, batches[1])
    torch.cuda.synchronize()
    del state
    serve_step = make_serve_step(model)
    cache = model.init_cache(4, InputShape("serve", 16, 4, "decode"))
    with torch.no_grad():
        logits, cache = serve_step(params, cache, batches[1]["tokens"][:, 0], 0)
        token = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        with record_syncs() as decode:
            serve_step(params, cache, token, 1)
        torch.cuda.synchronize()
    return {"train": train, "decode": decode}


def inventory_sites() -> set:
    """(path, function name) of every ``host-sync`` site the checker
    inventories over ``src/repro_torch``."""
    from ..analysis import build_program, build_retrace_inventory
    from ..analysis.engine import build_contexts

    program = build_program(build_contexts([PKG_DIR], rel_to=SRC_DIR))
    inv = build_retrace_inventory(program)
    return {(s["path"], s["function"].rsplit(".", 1)[-1]) for s in inv["sites"]
            if s["kind"] == "host-sync"}


def unlisted(logs: Dict[str, SyncLog], listed: set) -> List[Tuple[str, str]]:
    """Each recorded (path, function), traced or warned, that ``listed``
    lacks, in order."""
    seen = {(p, f) for log in logs.values() for p, f, _ in log.sites + log.warned}
    return sorted(seen - listed)


def unmatched(log: SyncLog) -> List[Tuple[str, str]]:
    """The (path, function) of each sync warning that no traced sync there
    accounts for, and of each traced sync that warned nowhere."""
    traced = collections.Counter((p, f) for p, f, _ in log.sites)
    warned = collections.Counter((p, f) for p, f, _ in log.warned)
    return sorted(((warned - traced) + (traced - warned)).elements())


def describe(name: str, log: SyncLog) -> str:
    sites = ", ".join(f"{p}::{f} x{n}" for (p, f), n in sorted(log.by_site().items()))
    return (f"{name}: {len(log.sites)} syncs ({log.warnings} sync warnings), "
            f"{len(log.by_site())} sites: {sites}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--raw", action="store_true",
                    help="list the syncs and their lines; no inventory check")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sync_audit: no CUDA device", file=sys.stderr)
        return 2
    logs = audit(args.seed)
    for name, log in logs.items():
        print(f"[sync_audit] {describe(name, log)}", flush=True)
        if args.raw:
            for site, n in sorted(collections.Counter(log.sites).items()):
                print(f"  {site[0]}:{site[2]} {site[1]} x{n}")
    if args.raw:
        return 0
    missing = unlisted(logs, inventory_sites())
    for p, f in missing:
        print(f"[sync_audit] not a host-sync site of the inventory: {p}::{f}")
    odd = {name: unmatched(log) for name, log in logs.items() if unmatched(log)}
    for name, sites in odd.items():
        print(f"[sync_audit] {name}: traced and warned syncs differ at {sites}")
    return 1 if missing or odd else 0


if __name__ == "__main__":
    sys.exit(main())
