"""Seed-driven fault injection — scenario specs compiled to schedules.

Counterpart of ``repro/faults/injector.py``.  The schedule is host data and
stays numpy, with the reference's dtypes (bool masks, float64 elephant
matrices), shapes and event order, so its digest is the reference's.

:class:`FaultInjector` validates a :class:`~repro_torch.faults.scenarios.
FaultScenario` against a concrete topology and compiles it into a
:class:`FaultSchedule`: the scheduled :class:`~repro_torch.runtime.events.
LinkEvent` list (flap trains expanded cycle by cycle, rail losses fanned
out to every link through the lost NIC) plus window-indexed telemetry
perturbations (blackout/dropout masks, straggler inflation, elephant
demand).  All randomness — flap jitter, dropout masks, elephant noise —
comes from one ``np.random.default_rng(seed)`` with a fixed draw order,
so the same (scenario, topology) pair always compiles to a bit-identical
schedule; :meth:`FaultSchedule.digest` hashes the canonical byte
serialization and is what the determinism property test pins.

The schedule is consumed by the existing machinery, not a parallel stack:
link events feed :class:`~repro_torch.runtime.events.EventLog` (or
``FabricArbiter.broadcast``), telemetry perturbations enter through
``OrchestrationRuntime.step(observed=..., completion_scale=...)``, and
elephants are added to the executed demand matrix.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.topology import INTRA, Topology
from ..jsonio import tag
from ..runtime.events import EventLog, LinkEvent, link_down, link_restored
from .scenarios import FaultScenario


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """Compiled, deterministic fault timeline for one scenario.

    ``events`` is window-sorted (stable: same-window events keep their
    generation order, so :class:`EventLog`'s schedule-order-wins rule sees
    down-before-restore exactly as the scenario intended).  The telemetry
    maps are window-indexed; windows absent from a map are unperturbed.
    """

    scenario: FaultScenario
    n_devices: int
    events: Tuple[LinkEvent, ...]
    # window -> drop probability; 1.0 = full blackout
    blackout_prob: Dict[int, float]
    # window -> [n, n] bool lost-entry mask (partial-dropout windows only)
    dropout_masks: Dict[int, np.ndarray]
    # window -> completion-time inflation factor (>= 1)
    straggler_scale: Dict[int, float]
    # window -> [n, n] additive background demand (bytes)
    elephant_bytes: Dict[int, np.ndarray]
    # tenant -> window of last heartbeat (crashed from that window on)
    crash_windows: Dict[str, int]

    # -- consumption ------------------------------------------------------------
    def event_log(self) -> EventLog:
        """Fresh :class:`EventLog` holding this schedule's link events."""
        return EventLog(self.events)

    def perturbed_demand(self, window: int, demand: np.ndarray) -> np.ndarray:
        """Executed demand for ``window``: the trace plus elephant bytes."""
        extra = self.elephant_bytes.get(window)
        if extra is None:
            return demand
        return np.asarray(demand, dtype=np.float64) + extra

    def observed_demand(
        self, window: int, demand: np.ndarray
    ) -> Optional[np.ndarray]:
        """What telemetry sees at ``window``: the demand, a NaN-masked copy
        (partial dropout), or ``None`` (full blackout)."""
        prob = self.blackout_prob.get(window)
        if prob is None:
            return demand
        if prob >= 1.0:
            return None
        obs = np.asarray(demand, dtype=np.float64).copy()
        mask = self.dropout_masks.get(window)
        if mask is not None:
            obs[mask] = np.nan
        return obs

    def completion_scale(self, window: int) -> float:
        return self.straggler_scale.get(window, 1.0)

    def crashed(self, tenant: str, window: int) -> bool:
        """True when ``tenant`` has stopped heartbeating by ``window``."""
        crash = self.crash_windows.get(tenant)
        return crash is not None and window >= crash

    @property
    def horizon(self) -> int:
        """Last window the schedule touches (0 for an empty schedule)."""
        last = 0
        for ev in self.events:
            last = max(last, ev.window)
        for m in (self.blackout_prob, self.straggler_scale,
                  self.elephant_bytes):
            if m:
                last = max(last, max(m))
        for w in self.crash_windows.values():
            last = max(last, w)
        return last

    # -- identity ---------------------------------------------------------------
    def digest(self) -> str:
        """SHA-256 over the canonical byte serialization of the schedule.

        Two schedules are bit-identical iff their digests match — the
        determinism contract's observable (same seed + spec -> same
        digest), covering event order, every mask bit, and every float.
        """
        h = hashlib.sha256()
        h.update(str(self.n_devices).encode())
        for ev in self.events:
            h.update(
                f"E{ev.window}:{ev.src}:{ev.dst}:{ev.scale!r};".encode()
            )
        for w in sorted(self.blackout_prob):
            h.update(f"B{w}:{self.blackout_prob[w]!r};".encode())
        for w in sorted(self.dropout_masks):
            h.update(f"M{w};".encode())
            h.update(np.ascontiguousarray(self.dropout_masks[w]).tobytes())
        for w in sorted(self.straggler_scale):
            h.update(f"S{w}:{self.straggler_scale[w]!r};".encode())
        for w in sorted(self.elephant_bytes):
            h.update(f"D{w};".encode())
            h.update(np.ascontiguousarray(self.elephant_bytes[w]).tobytes())
        for t in sorted(self.crash_windows):
            h.update(f"C{t}:{self.crash_windows[t]};".encode())
        return h.hexdigest()

    def to_json_obj(self) -> dict:
        return tag(
            "fault_schedule",
            {
                "scenario": self.scenario.name,
                "seed": int(self.scenario.seed),
                "digest": self.digest(),
                "horizon": int(self.horizon),
                "events": [ev.describe() for ev in self.events],
                "blackout_windows": sorted(self.blackout_prob),
                "straggler_windows": sorted(self.straggler_scale),
                "elephant_windows": sorted(self.elephant_bytes),
                "crashes": {
                    t: int(w) for t, w in sorted(self.crash_windows.items())
                },
            },
        )


class FaultInjector:
    """Compile :class:`FaultScenario` specs against one topology."""

    def __init__(self, topo: Topology):
        self.topo = topo

    # -- validation helpers -----------------------------------------------------
    def _check_device(self, dev: int, what: str) -> None:
        if not 0 <= dev < self.topo.n_devices:
            raise ValueError(
                f"{what}: device {dev} out of range "
                f"[0, {self.topo.n_devices})"
            )

    def _check_link(self, src: int, dst: int, what: str) -> None:
        self._check_device(src, what)
        self._check_device(dst, what)
        if not self.topo.has_link(src, dst):
            raise ValueError(f"{what}: no link {src}->{dst} in the topology")

    def _nic_links(self, device: int) -> Tuple[Tuple[int, int], ...]:
        """Directed inter-group (rail) links through ``device``'s NIC."""
        out = []
        for l in self.topo.links:
            if l.kind != INTRA and device in (l.src, l.dst):
                out.append((l.src, l.dst))
        return tuple(out)

    # -- compilation ------------------------------------------------------------
    def compile(self, scenario: FaultScenario) -> FaultSchedule:
        """Expand ``scenario`` into a deterministic :class:`FaultSchedule`.

        Draw order is fixed — flap jitter in spec order, dropout masks in
        window order per blackout spec, elephant noise in window order per
        elephant spec — so equal (seed, specs, topology) triples always
        produce bit-identical schedules.
        """
        rng = np.random.default_rng(scenario.seed)
        n = self.topo.n_devices
        events: list[LinkEvent] = []

        for spec in scenario.flaps:
            self._check_link(spec.src, spec.dst, "flap spec")
            period = spec.down_windows + spec.up_windows
            prev_restore = spec.start
            for cycle in range(spec.cycles):
                down_w = spec.start + cycle * period
                if spec.jitter > 0.0:
                    off = rng.uniform(-spec.jitter, spec.jitter) * period
                    down_w += int(round(off))
                # never reorder: a cycle starts at or after the previous
                # restore, and never before the spec's start window
                down_w = max(down_w, prev_restore, spec.start)
                restore_w = down_w + spec.down_windows
                events.append(link_down(down_w, spec.src, spec.dst))
                events.append(link_restored(restore_w, spec.src, spec.dst))
                prev_restore = restore_w

        for spec in scenario.rail_losses:
            self._check_device(spec.device, "rail-loss spec")
            links = self._nic_links(spec.device)
            if not links:
                raise ValueError(
                    f"rail-loss spec: device {spec.device} has no "
                    "inter-group links"
                )
            for src, dst in links:
                events.append(link_down(spec.start, src, dst))
            if spec.restore is not None:
                for src, dst in links:
                    events.append(link_restored(spec.restore, src, dst))

        # stable sort: same-window events keep generation order, matching
        # EventLog's schedule-order-wins override rule
        events.sort(key=lambda ev: ev.window)

        blackout_prob: Dict[int, float] = {}
        dropout_masks: Dict[int, np.ndarray] = {}
        for spec in scenario.blackouts:
            for w in range(spec.start, spec.start + spec.duration):
                # overlapping blackouts compose by worst loss
                blackout_prob[w] = max(
                    blackout_prob.get(w, 0.0), spec.drop_prob
                )
                if spec.drop_prob < 1.0:
                    mask = rng.random((n, n)) < spec.drop_prob
                    prev = dropout_masks.get(w)
                    dropout_masks[w] = mask if prev is None else prev | mask
        # full-blackout windows need no mask: everything is lost
        for w, prob in blackout_prob.items():
            if prob >= 1.0:
                dropout_masks.pop(w, None)

        straggler_scale: Dict[int, float] = {}
        for spec in scenario.stragglers:
            if spec.device is not None:
                self._check_device(spec.device, "straggler spec")
            for w in range(spec.start, spec.start + spec.duration):
                straggler_scale[w] = max(
                    straggler_scale.get(w, 1.0), spec.inflation
                )

        elephant_bytes: Dict[int, np.ndarray] = {}
        for spec in scenario.elephants:
            self._check_link(spec.src, spec.dst, "elephant spec")
            for w in range(spec.start, spec.start + spec.duration):
                b = spec.bytes_per_window
                if spec.jitter > 0.0:
                    b *= 1.0 + rng.uniform(-spec.jitter, spec.jitter)
                mat = elephant_bytes.setdefault(w, np.zeros((n, n)))
                mat[spec.src, spec.dst] += b

        crash_windows: Dict[str, int] = {}
        for spec in scenario.crashes:
            if not spec.tenant:
                raise ValueError("tenant-crash spec needs a tenant name")
            prev = crash_windows.get(spec.tenant)
            crash_windows[spec.tenant] = (
                spec.window if prev is None else min(prev, spec.window)
            )

        return FaultSchedule(
            scenario=scenario,
            n_devices=n,
            events=tuple(events),
            blackout_prob=blackout_prob,
            dropout_masks=dropout_masks,
            straggler_scale=straggler_scale,
            elephant_bytes=elephant_bytes,
            crash_windows=crash_windows,
        )
