"""Demand estimation — the *estimate* stage of the runtime loop.

Counterpart of ``repro/runtime/estimator.py``, copied as it is (numpy and the
stdlib only).

Turns the telemetry stream of observed per-pair byte counts into the next
window's predicted demand matrix.  Two estimators compose:

  * **EWMA** — exponentially-weighted average of per-pair observations;
    smooth under jitter, so balanced traffic with noise never looks like
    drift (the paper's "matches baseline under balanced traffic" relies on
    the predictor not chasing noise);
  * **skew-burst attack** — when an entry jumps far above its running
    average (a token-routing hotspot igniting, a tenant arriving), the
    EWMA's slow attack would under-predict for several windows; entries
    whose latest observation exceeds ``burst_ratio x`` the pre-update EWMA
    (plus an absolute floor) snap directly to the observation instead.

Decay stays EWMA-slow in both modes: a hotspot that vanishes is forgotten
gradually, which gives the replan policy hysteresis-friendly inputs.

**Degraded telemetry** (DESIGN.md §9): observation windows can be *lost*
(telemetry blackout — ``LinkTelemetry.observed_demand`` returns ``None``)
or *partial* (dropout — entries arrive as NaN).  The estimator never
poisons its state with either: a missing window (:meth:`DemandEstimator.
observe_missing`) keeps the last-good EWMA/burst state untouched, and a
partial update back-fills NaN entries from the last-good estimate before
folding.  Both decay a ``confidence`` signal (1.0 on a clean window,
halved per fully-missing window by default, proportionally for partial
loss) so consumers can tell "the fabric is calm" from "we are flying
blind on a stale prediction".
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    alpha: float = 0.5               # EWMA weight on the newest observation
    burst_ratio: float = 2.5         # obs > ratio * ewma (+floor) => burst
    burst_floor_bytes: float = float(1 << 22)  # ignore bursts below 4 MB
    # confidence retained per fully-missing observation window (blackout);
    # partial windows decay proportionally to the lost-entry fraction
    confidence_decay: float = 0.5


class DemandEstimator:
    """EWMA + skew-burst next-window demand estimator (per endpoint)."""

    def __init__(self, n_devices: int, cfg: EstimatorConfig | None = None):
        self.n = n_devices
        self.cfg = cfg or EstimatorConfig()
        self._ewma: Optional[np.ndarray] = None
        self._burst: Optional[np.ndarray] = None  # [n, n] bool, latest update
        self._last: Optional[np.ndarray] = None
        self._confidence = 1.0
        self._missing_windows = 0

    @property
    def initialized(self) -> bool:
        return self._ewma is not None

    @property
    def confidence(self) -> float:
        """How fresh the estimate is: 1.0 after a clean observation window,
        decayed toward 0 by missing/partial windows (last-good fallback)."""
        return self._confidence

    @property
    def missing_windows(self) -> int:
        """Total observation windows lost (blackout) since construction."""
        return self._missing_windows

    def observe_missing(self) -> None:
        """One observation window was lost entirely (telemetry blackout).

        The last-good EWMA/burst state is kept as-is — :meth:`predict`
        keeps serving the pre-blackout estimate — and only the confidence
        decays, so the runtime can keep planning on last-good demand
        instead of snapping to zeros or crashing.
        """
        self._missing_windows += 1
        self._confidence *= self.cfg.confidence_decay

    def update(self, observed: Optional[np.ndarray]) -> None:
        """Fold one window's observed per-pair bytes into the estimate.

        ``observed=None`` degrades to :meth:`observe_missing`; NaN entries
        (partial telemetry dropout) are back-filled from the last-good
        estimate (zero before the first clean window) so corrupted
        windows never poison the EWMA, and decay confidence by the lost
        fraction.
        """
        if observed is None:
            self.observe_missing()
            return
        obs = np.asarray(observed, dtype=np.float64).copy()
        if obs.shape != (self.n, self.n):
            raise ValueError(
                f"observed shape {obs.shape} != ({self.n}, {self.n})"
            )
        missing = ~np.isfinite(obs)
        if missing.all():
            self.observe_missing()
            return
        if missing.any():
            fill = self._ewma if self._ewma is not None else 0.0
            obs = np.where(missing, fill, obs)
            frac = float(missing.mean())
            self._confidence *= 1.0 - frac * (1.0 - self.cfg.confidence_decay)
        else:
            self._confidence = 1.0
        obs = np.maximum(obs, 0.0)
        np.fill_diagonal(obs, 0.0)
        cfg = self.cfg
        if self._ewma is None:
            self._ewma = obs.copy()
            self._burst = np.zeros_like(obs, dtype=bool)
        else:
            prev = self._ewma
            self._burst = obs > (
                cfg.burst_ratio * prev + cfg.burst_floor_bytes
            )
            self._ewma = cfg.alpha * obs + (1.0 - cfg.alpha) * prev
        self._last = obs

    def predict(self) -> np.ndarray:
        """Predicted demand matrix for the next window ([n, n] bytes)."""
        if self._ewma is None:
            return np.zeros((self.n, self.n))
        pred = self._ewma.copy()
        if self._burst is not None and self._burst.any():
            # fast attack: bursting entries snap to the latest observation
            pred[self._burst] = self._last[self._burst]
        return pred

    def burst_pairs(self) -> np.ndarray:
        """Bool [n, n] mask of entries in burst mode after the last update."""
        if self._burst is None:
            return np.zeros((self.n, self.n), dtype=bool)
        return self._burst.copy()

    def reset(self) -> None:
        self._ewma = None
        self._burst = None
        self._last = None
        self._confidence = 1.0
