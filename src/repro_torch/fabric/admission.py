"""Replan admission gate — token bucket + QoS priority.

Counterpart of ``repro/fabric/admission.py``, copied as it is (the stdlib
only).

A replan is not free for the *fabric*: every tenant solve occupies the
shared planner (one jit dispatch), and every committed-load change moves
the prices its peers plan against, invalidating their demand+price-keyed
plan caches.  A tenant whose estimator is noisy (or whose traffic genuinely
bursts) can therefore thrash everyone.  The gate bounds that blast radius:

  * each tenant holds a **token bucket** (``burst`` tokens, refilled at
    ``refill_per_window`` per elapsed window); a congestion- or
    staleness-triggered replan consumes one token and is **throttled** when
    the bucket is empty;
  * **topology events bypass** the gate — a plan solved for dead geometry
    is worse than any amount of cache churn;
  * the ``gold`` QoS class bypasses the gate (latency-critical tenants);
  * with fewer than two registered tenants there is nobody to protect, so
    the gate admits everything — part of the arbiter's zero-overhead
    single-tenant contract.

The bypass/solo logic lives in :meth:`repro_torch.fabric.FabricArbiter.admit`;
this module is the mechanism.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    burst: int = 3                  # bucket depth: back-to-back replans
    refill_per_window: float = 0.5  # sustained replans per window

    def __post_init__(self):
        if self.burst < 1:
            raise ValueError(f"burst must be >= 1, got {self.burst}")
        if self.refill_per_window < 0:
            raise ValueError("refill_per_window must be non-negative")


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    admitted: bool
    reason: str         # "topology" | "solo" | "qos" | "ok" | "throttled"
    tokens_left: float

    def to_json_obj(self) -> dict:
        return dataclasses.asdict(self)


class TokenBucket:
    """Window-clocked token bucket; refill is lazy on access."""

    def __init__(self, cfg: AdmissionConfig | None = None):
        self.cfg = cfg or AdmissionConfig()
        self._tokens = float(self.cfg.burst)
        self._last_window: Optional[int] = None

    def _refill(self, window: int) -> None:
        if self._last_window is not None and window > self._last_window:
            elapsed = window - self._last_window
            self._tokens = min(
                float(self.cfg.burst),
                self._tokens + elapsed * self.cfg.refill_per_window,
            )
        if self._last_window is None or window > self._last_window:
            self._last_window = window

    def tokens(self, window: int) -> float:
        self._refill(window)
        return self._tokens

    def try_take(self, window: int) -> bool:
        """Consume one token at ``window``; False when the bucket is dry."""
        self._refill(window)
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False
