"""Start a world of processes, run one function in each, collect the results.

    results = spawn(fn, nprocs, *args, backend="gloo")   # [fn's result by rank]

The port's own launcher: XLA's SPMD runtime plays this part for the
reference.  ``spawn``:

  * starts ``nprocs`` children with the ``spawn`` start method, never
    ``fork`` (the caller may have JAX, threads or a card's context loaded);
  * initialises each child's default process group through a rendezvous
    file in a fresh temporary directory (``init_method=file://``), so no
    port is fixed and worlds started side by side do not meet;
  * on ``backend="nccl"`` binds child ``r`` to ``cuda:r`` and needs that many
    cards; on ``"gloo"`` (the CPU) each child runs one thread; every
    collective times out after ``COLLECTIVE_TIMEOUT_S`` (60 s);
  * runs ``fn(rank, world, *args)`` in each child and returns the results,
    which must pickle, in rank order;
  * joins against one deadline (``timeout_s``): on a child's exception, a
    nonzero exit or the deadline it kills every child and raises.

``fn`` must be importable by name in the children, so it lives in a module
of the package, not in a test file or ``__main__``.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, List

BACKENDS = ("gloo", "nccl")
#: seconds a collective may wait before it raises
COLLECTIVE_TIMEOUT_S = 60


def _init_group(backend: str, rank: int, world: int, init_file: str) -> None:
    """Join the default process group through ``init_file``: under NCCL bound
    to ``cuda:{rank}``."""
    import torch
    import torch.distributed as dist

    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S), **kw)


def _child(rank: int, world: int, init_file: str, backend: str,
           fn: Callable, args: tuple, results) -> None:
    import torch
    import torch.distributed as dist

    try:
        if backend == "gloo":
            torch.set_num_threads(1)
        _init_group(backend, rank, world, init_file)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:                # report everything, KeyboardInterrupt too
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, nprocs: int, *args, backend: str = "gloo",
          timeout_s: float = 300.0) -> List[Any]:
    """Run ``fn(rank, nprocs, *args)`` in ``nprocs`` fresh processes; see the
    module docstring."""
    import multiprocessing as mp

    import torch

    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if backend == "nccl" and torch.cuda.device_count() < nprocs:
        raise RuntimeError(f"nccl needs a card a process: {nprocs} processes, "
                           f"{torch.cuda.device_count()} cards")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_dist_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_child, daemon=True,
                             args=(r, nprocs, init_file, backend, fn, args, results))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        out, errors = {}, []
        deadline = time.monotonic() + timeout_s
        try:
            while len(out) + len(errors) < nprocs:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{fn.__name__}: {nprocs - len(out)} of {nprocs} "
                                       f"processes had not finished after {timeout_s:.0f} s")
                try:
                    rank, ok, val = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in out]
                    if dead and results.empty():
                        time.sleep(0.5)              # a last message may be in flight
                        if results.empty():
                            raise RuntimeError(
                                f"{fn.__name__}: process {dead[0]} exited with code "
                                f"{procs[dead[0]].exitcode} and no result")
                    continue
                if ok:
                    out[rank] = val
                else:
                    errors.append((rank, val))
                    break                 # the others may now wait on it forever
            if errors:
                rank, tb = errors[0]
                raise RuntimeError(f"{fn.__name__} failed in process {rank} of {nprocs}:\n{tb}")
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
            bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
            if bad:
                raise RuntimeError(f"{fn.__name__}: processes exited with {bad}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(5)
            results.close()
    return [out[r] for r in range(nprocs)]


@contextlib.contextmanager
def local_world(backend: str = "gloo"):
    """A world of one process, this one, for the body of the ``with``: the
    same code path as a spawned world at P = 1 (on the card under NCCL,
    bound to ``cuda:0``)."""
    import torch.distributed as dist

    with tempfile.TemporaryDirectory(prefix="repro_torch_dist_") as tmp:
        _init_group(backend, 0, 1, os.path.join(tmp, "rendezvous"))
        try:
            yield
        finally:
            dist.destroy_process_group()
