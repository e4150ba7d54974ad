"""Link/resource telemetry — the *monitor* stage of the runtime loop.

Counterpart of ``repro/runtime/telemetry.py``, copied as it is (numpy and the
stdlib only).

NIMBLE is endpoint-driven (§III): every device observes the traffic it
sources and the utilization of the resources its plans charge, with no
central collector.  :class:`LinkTelemetry` is the per-endpoint counter
store: a fixed-capacity **ring buffer** of per-window records, each holding

  * per-resource busy time and utilization over the window (harvested from
    :class:`~repro.core.fabsim.SimResult` in simulation, or from planned
    resource loads when hooked into live ``NimbleAllToAll.plan_batch``
    executions);
  * the observed per-pair byte counts (the realized demand matrix), which
    feed the demand estimator for the next window's prediction.

Aggregation helpers (`mean_util`, `utilization_imbalance`, `aggregate`)
operate over the last *k* windows so the replan policy can look at smoothed
signals instead of single-window noise.  Serialization goes through the
shared ``repro.jsonio`` schema (``nimble.telemetry_window/v1``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..jsonio import tag


@dataclasses.dataclass(frozen=True)
class TelemetryWindow:
    """One window's harvested counters."""

    window: int
    completion_s: float
    payload_bytes: float
    bottleneck_resource: int
    per_resource_time: np.ndarray    # [R] seconds busy
    per_resource_util: np.ndarray    # [R] fraction of window busy
    pair_bytes: Optional[np.ndarray]  # [n, n] observed demand (or None)

    def to_json_obj(self) -> dict:
        return tag(
            "telemetry_window",
            {
                "window": int(self.window),
                "completion_s": float(self.completion_s),
                "payload_bytes": float(self.payload_bytes),
                "bottleneck_resource": int(self.bottleneck_resource),
                "util_max": float(self.per_resource_util.max())
                if len(self.per_resource_util)
                else 0.0,
                "util_mean_busy": _mean_busy(self.per_resource_util),
                "pair_bytes_total": float(self.pair_bytes.sum())
                if self.pair_bytes is not None
                else None,
            },
        )


def _mean_busy(util: np.ndarray) -> float:
    busy = util[util > 0]
    return float(busy.mean()) if busy.size else 0.0


class LinkTelemetry:
    """Fixed-capacity ring buffer of per-window resource counters."""

    def __init__(self, capacity_bps: np.ndarray, window_capacity: int = 256):
        if window_capacity <= 0:
            raise ValueError("window_capacity must be positive")
        self.capacity_bps = np.asarray(capacity_bps, dtype=np.float64)
        self.n_resources = len(self.capacity_bps)
        self.window_capacity = window_capacity
        R, W = self.n_resources, window_capacity
        self._time = np.zeros((W, R))
        self._util = np.zeros((W, R))
        self._completion = np.zeros(W)
        self._payload = np.zeros(W)
        self._bottleneck = np.full(W, -1, dtype=np.int64)
        self._window_id = np.full(W, -1, dtype=np.int64)
        self._pairs: List[Optional[np.ndarray]] = [None] * W
        self._count = 0   # total records ever written
        self.rejected = 0  # malformed load records refused (NaN/negative)

    # -- recording -------------------------------------------------------------
    def record(self, window: int, sim, pair_bytes: Optional[np.ndarray] = None,
               completion_scale: float = 1.0) -> None:
        """Harvest a :class:`~repro.core.fabsim.SimResult` for one window.

        ``completion_scale`` stretches the measured busy/completion times
        (straggler windows, DESIGN.md §9) without touching utilization —
        the fabric did the same work, it just took longer.
        """
        self._write(
            window,
            per_resource_time=(
                np.asarray(sim.per_resource_time, dtype=np.float64)
                * completion_scale
            ),
            per_resource_util=np.asarray(sim.per_resource_util, dtype=np.float64),
            completion_s=float(sim.completion_time) * completion_scale,
            payload=float(sim.total_payload),
            bottleneck=int(sim.bottleneck_resource),
            pair_bytes=pair_bytes,
        )

    def record_loads(
        self,
        window: Optional[int],
        resource_bytes: np.ndarray,
        pair_bytes: Optional[np.ndarray] = None,
    ) -> None:
        """Harvest planned per-resource loads (dataplane ``plan_batch`` hook).

        Loads are effective bytes; busy time is ``bytes / capacity`` and the
        window "completion" is the slowest resource (the plan's objective Z).
        ``window=None`` self-numbers with the record count (useful when
        several producers share one sink and none owns a window clock).

        A shape mismatch is a caller bug and raises; NaN/Inf/negative
        entries are *producer corruption* (a crashed counter, a torn read)
        and are **rejected whole** — the record is dropped and ``rejected``
        incremented, so one poisoned window can never contaminate
        ``mean_util`` / ``utilization_imbalance`` for everything behind it
        in the ring.
        """
        loads = np.asarray(resource_bytes, dtype=np.float64)
        if loads.shape != (self.n_resources,):
            raise ValueError(
                f"loads shape {loads.shape} != ({self.n_resources},) — the "
                "producer's topology disagrees with this telemetry sink's"
            )
        if not np.isfinite(loads).all() or (loads < 0).any():
            self.rejected += 1
            return
        drain = loads / self.capacity_bps
        t = float(drain.max()) if len(drain) else 0.0
        util = drain / t if t > 0 else np.zeros_like(drain)
        self._write(
            window,
            per_resource_time=drain,
            per_resource_util=util,
            completion_s=t,
            payload=float(pair_bytes.sum()) if pair_bytes is not None else 0.0,
            bottleneck=int(np.argmax(drain)) if len(drain) else -1,
            pair_bytes=pair_bytes,
        )

    def _write(self, window, per_resource_time, per_resource_util,
               completion_s, payload, bottleneck, pair_bytes) -> None:
        if window is None:
            window = self._count
        i = self._count % self.window_capacity
        self._time[i] = per_resource_time
        self._util[i] = per_resource_util
        self._completion[i] = completion_s
        self._payload[i] = payload
        self._bottleneck[i] = bottleneck
        self._window_id[i] = window
        self._pairs[i] = (
            np.asarray(pair_bytes, dtype=np.float64)
            if pair_bytes is not None
            else None
        )
        self._count += 1

    # -- access ----------------------------------------------------------------
    def __len__(self) -> int:
        return min(self._count, self.window_capacity)

    def _live_idx(self, last_k: Optional[int] = None) -> np.ndarray:
        """Ring indices of the last ``k`` records, oldest -> newest."""
        n = len(self)
        k = n if last_k is None else min(last_k, n)
        start = self._count - k
        return np.arange(start, self._count) % self.window_capacity

    def latest(self, k: int = 1) -> List[TelemetryWindow]:
        return [
            TelemetryWindow(
                window=int(self._window_id[i]),
                completion_s=float(self._completion[i]),
                payload_bytes=float(self._payload[i]),
                bottleneck_resource=int(self._bottleneck[i]),
                per_resource_time=self._time[i].copy(),
                per_resource_util=self._util[i].copy(),
                pair_bytes=self._pairs[i],
            )
            for i in self._live_idx(k)
        ]

    # -- aggregation -----------------------------------------------------------
    def mean_util(self, last_k: Optional[int] = None) -> np.ndarray:
        """Per-resource mean utilization over the last ``k`` windows."""
        idx = self._live_idx(last_k)
        if not len(idx):
            return np.zeros(self.n_resources)
        return self._util[idx].mean(axis=0)

    def utilization_imbalance(self, last_k: Optional[int] = None) -> float:
        """max/mean utilization over busy resources — the *skew* signal.

        1.0 means perfectly balanced load (the paper's "symmetry"); large
        values mean traffic is funneling onto few links.
        """
        mu = self.mean_util(last_k)
        busy = mu[mu > 0]
        if not busy.size:
            return 1.0
        return float(busy.max() / busy.mean())

    def observed_demand(self, last_k: Optional[int] = None
                        ) -> Optional[np.ndarray]:
        """Summed per-pair bytes over the last ``k`` windows (None if unset)."""
        mats = [self._pairs[i] for i in self._live_idx(last_k)]
        mats = [m for m in mats if m is not None]
        if not mats:
            return None
        return np.sum(mats, axis=0)

    def health(self) -> dict:
        """Compact numeric-only health snapshot for the metrics registry
        (DESIGN.md §11) — no schema envelope, no arrays, so the flight
        recorder's collectors can map it straight onto gauges."""
        last = self.latest(1)
        return {
            "windows": int(self._count),
            "retained": len(self),
            "rejected": int(self.rejected),
            "utilization_imbalance": self.utilization_imbalance(),
            "last_completion_s": (
                float(last[0].completion_s) if last else 0.0
            ),
        }

    def aggregate(self, last_k: Optional[int] = None) -> dict:
        idx = self._live_idx(last_k)
        return tag(
            "telemetry_aggregate",
            {
                "windows": int(len(idx)),
                "completion_s_total": float(self._completion[idx].sum()),
                "payload_bytes_total": float(self._payload[idx].sum()),
                "utilization_imbalance": self.utilization_imbalance(last_k),
                "util_mean_busy": _mean_busy(self.mean_util(last_k)),
                "rejected_records": int(self.rejected),
            },
        )

    def to_json_obj(self, last_k: Optional[int] = None) -> dict:
        return tag(
            "telemetry_log",
            {
                "aggregate": self.aggregate(last_k),
                "windows": [
                    w.to_json_obj() for w in self.latest(last_k or len(self))
                ],
            },
        )
