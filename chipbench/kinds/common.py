"""What the windows share: the timed loop and its profile, the readings a
traced run hands to the per-layer readers, the post-window diagnostics,
and the reference's training run."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from chipbench import costs, harness

#: AdamW's settings that a mix's ``optimizer`` does not give
OPT_DEFAULTS = dict(lr=3e-4, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
                    clip_norm=1.0, warmup_steps=100, total_steps=10_000, min_lr_frac=0.1)
#: device-op name fragments of the port's kernels (as the profiler names them)
FFN_OPS = ("ffn_tc<",)
FLASH_OPS = ("flash_tc<",)
DISPATCH_OPS = ("gather_rows", "scatter_add_rows", "inverse_index<")


def to_device(batch: Dict[str, np.ndarray], device: str):
    import torch

    return {k: torch.as_tensor(v, dtype=torch.int64, device=device) for k, v in batch.items()}


def _sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


@dataclasses.dataclass
class Observed:
    """A traced run's readings.  ``units``: steps or batches in the traced
    window; ``ops``: device op name -> (seconds, launches); ``least``: per
    kernel, the summed least time of its launches in the window;
    ``model_flops`` done over ``model_s`` seconds."""

    kind: str
    units: int
    window_s: float
    busy_s: float
    ops: Dict[str, tuple]
    least: Dict[str, Optional[float]]
    model_flops: float
    model_s: float
    phases_ms: Dict[str, float] = dataclasses.field(default_factory=dict)
    syncs_per_unit: Optional[float] = None
    latency_p95_ms: Optional[float] = None


def op_seconds(ops: Dict[str, tuple], fragments) -> float:
    return sum(s for k, (s, _) in ops.items() if any(f in k for f in fragments))


def op_launches(ops: Dict[str, tuple], fragments) -> int:
    return sum(c for k, (_, c) in ops.items() if any(f in k for f in fragments))


class Window:
    """The measured window: ``loop(fn, seconds)`` calls ``fn`` until
    ``seconds`` have passed on the host's clock, then synchronises once;
    ``seconds`` is from the window's start to that synchronise's end.
    Traced, the same loop runs under ``torch.profiler``."""

    def __init__(self, device: str):
        self.device = device
        self.seconds = self.setup_s = self.t0 = 0.0
        self.busy_s = None
        self.ops: Dict[str, tuple] = {}
        self.breakdown = None
        self._prof = None

    @contextlib.contextmanager
    def _profiled(self, trace: bool):
        if not trace:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device == "cuda" else [])
        with profile(activities=acts) as self._prof:
            yield

    def read_trace(self) -> None:
        """Read the traced window's profile (after whatever the window left
        to finish, which its reading would otherwise hold up)."""
        from chipbench import trace as tr

        if self._prof is None:
            return
        self.ops, self.busy_s, gaps = tr.read(self._prof)
        self._prof = None
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:10]
        self.breakdown = {"device_ops": [[k[:120], s] for k, (s, _) in top],
                          "idle_gaps": [[k[:120], s] for k, s in gaps]}

    def loop(self, fn: Callable[[], object], seconds: float, trace: bool,
             t_start: float) -> List[object]:
        import torch

        _sync(self.device)
        if self.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        outs = []
        with self._profiled(trace):
            t0 = self.t0 = time.perf_counter()
            self.setup_s = t0 - t_start
            while time.perf_counter() - t0 < seconds:
                outs.append(fn())
            _sync(self.device)
            self.seconds = time.perf_counter() - t0
        return outs


def p95_ms(latencies_s) -> float:
    """The 95th percentile of every latency (nearest rank), in ms."""
    if not len(latencies_s):
        return float("inf")
    return 1e3 * float(np.percentile(latencies_s, 95, method="inverted_cdf"))


def ffn_least(cfg, kept: int, units: int, ops) -> Optional[float]:
    """The grouped FFN's least time over its launches in a traced window:
    each launch over the mean kept rows of a layer's call."""
    launches = op_launches(ops, ("ffn_tc<true>",))
    if not launches or not units:
        return None
    valid = kept / (units * cfg.n_layers)
    fl, by = costs.ffn_launch(valid, cfg.n_experts, cfg.d_model, cfg.d_ff)
    return launches * costs.least_s(fl, by)[0]


def flash_least(rcfg: dict, b: int, s: int, ops) -> Optional[float]:
    launches = op_launches(ops, FLASH_OPS)
    if not launches:
        return None
    fl, by = costs.flash_launch(b, rcfg["n_heads"], rcfg["n_kv_heads"], s, rcfg["head_dim"])
    return launches * costs.least_s(fl, by)[0]


def diagnose(model, params, batch, cfg, *, dropped: int, assignments: int, peak: int,
             last_only: bool = False) -> None:
    """Print, after the window, the routing skew of each layer (the hottest
    expert's assignments over the mean), the window's dropped share, and
    the alternate-path chunks of one forward's plans."""
    import torch
    from repro_torch.core import dataplane
    from repro_torch.models import moe

    loads, alt = [], [0, 0]
    router, plan = moe._router, dataplane.NimbleAllToAll.plan_from_counts

    def seen_router(*a, **k):
        out = router(*a, **k)
        loads.append(torch.bincount(out[0].reshape(-1), minlength=cfg.n_experts))
        return out

    def seen_plan(self, demand):
        out = plan(self, demand)
        alt[0] += int(out[..., 1:].sum())
        alt[1] += int(out.sum())
        return out

    moe._router, dataplane.NimbleAllToAll.plan_from_counts = seen_router, seen_plan
    try:
        with torch.no_grad():
            model.forward(params, batch, last_only=last_only)
    finally:
        moe._router, dataplane.NimbleAllToAll.plan_from_counts = router, plan
    skew = [round(float(x.max()) / float(x.float().mean()), 4) for x in loads]
    print(f"[diag] routing skew by layer (hottest expert over the mean): {skew}", flush=True)
    print(f"[diag] dropped in the window: {dropped} of {assignments} assignments "
          f"({dropped / max(assignments, 1):.6f})", flush=True)
    print(f"[diag] one forward's plans: {alt[0]} of {alt[1]} chunks on alternate paths",
          flush=True)
    print(f"[diag] peak memory in the window: {peak} bytes", flush=True)


def reference_train(config: dict, shapes: dict, seed: int, host_batches, opt: dict,
                    device: str) -> dict:
    """The reference's first steps from the weights of ``seed``."""
    import torch

    from chipbench.reference import model as rm
    from chipbench.reference import train as rt

    rm.exact()
    dtype = getattr(torch, config["parallel"]["param_dtype"])
    stored = harness.make_weights(shapes, seed, dtype, device, config)
    batches = [to_device(b, device) for b in host_batches]
    return rt.first_steps(stored, batches, harness.reference_config(config), opt)

