"""Arithmetic that the per-layer readers (``metrics/<name>.py``) share.

Each takes a traced run's :class:`~chipbench.kinds.common.Observed` and the
kind of window it reads (``train`` or ``prefill``), and gives ``None``
where that run has nothing to read: another kind of window, or no launch
of the kernel.
"""

from __future__ import annotations

from typing import Optional

from chipbench import costs
from chipbench.kinds.common import DISPATCH_OPS, FFN_OPS, FLASH_OPS, op_seconds

KERNEL_OPS = {"grouped_ffn": FFN_OPS, "flash_attention": FLASH_OPS}


def _of(obs, kind: str) -> bool:
    return obs is not None and obs.kind == kind and obs.units > 0


def roofline(obs, kernel: str, kind: str) -> Optional[float]:
    """% of its launches' time that the kernel's least time is."""
    if not _of(obs, kind) or not obs.least.get(kernel):
        return None
    took = op_seconds(obs.ops, KERNEL_OPS[kernel])
    return 100.0 * obs.least[kernel] / took if took > 0 else None


def dispatch_ms(obs, kind: str) -> Optional[float]:
    """Device ms a step (or batch) of the dispatch's row gathers and sums."""
    if not _of(obs, kind):
        return None
    took = op_seconds(obs.ops, DISPATCH_OPS)
    return 1e3 * took / obs.units if took > 0 else None


def idle_share(obs, kind: str) -> Optional[float]:
    if not _of(obs, kind) or obs.busy_s is None or not obs.ops:
        return None
    return 100.0 * (1.0 - obs.busy_s / obs.window_s)


def mfu(obs, kind: str) -> Optional[float]:
    """% of the bf16 peak that the model's FLOPs over their time make."""
    if not _of(obs, kind) or obs.model_s <= 0:
        return None
    return 100.0 * obs.model_flops / obs.model_s / costs.PEAK_BF16


def phase_ms(obs, phase: str) -> Optional[float]:
    if not _of(obs, "train") or phase not in obs.phases_ms:
        return None
    return obs.phases_ms[phase]


def latency_p95(obs, kind: str) -> Optional[float]:
    if not _of(obs, kind) or obs.latency_p95_ms is None:
        return None
    return float(obs.latency_p95_ms)


def syncs(obs, kind: str) -> Optional[float]:
    if not _of(obs, kind) or obs.syncs_per_unit is None:
        return None
    return float(obs.syncs_per_unit)
