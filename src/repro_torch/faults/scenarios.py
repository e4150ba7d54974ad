"""Declarative fault-scenario specs (counterpart of ``repro/faults/scenarios.py``).

A scenario is a frozen, purely-declarative description of *what goes wrong
when* — link flap trains, rail/NIC loss, telemetry blackouts, stragglers,
tenant crashes, background elephants — with every stochastic choice
deferred to the injector's seeded RNG.  Specs carry no topology knowledge
beyond device/link indices; :class:`~repro_torch.faults.injector.FaultInjector`
validates them against a concrete :class:`~repro_torch.core.topology.Topology`
at compile time and expands them into scheduled
:class:`~repro_torch.runtime.events.LinkEvent` / telemetry perturbations.

Determinism contract: a scenario plus a seed compiles to a bit-identical
:class:`~repro_torch.faults.injector.FaultSchedule` on every call (pinned by a
hypothesis property test in ``tests/test_torch_faults.py``, which also
holds the digests equal to the reference's), so drills are
replayable and schedule digests are stable across runs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LinkFlapSpec:
    """A flap train on one directed link: down/up cycles from ``start``.

    Each cycle holds the link down for ``down_windows`` then restored for
    ``up_windows``; the train always ends with a restore, so the fabric is
    whole after ``end_window``.  ``jitter`` (fraction of a cycle, drawn
    from the injector's seeded RNG) perturbs each cycle's start — real
    flaps are not metronomes — without ever reordering events.
    """

    src: int
    dst: int
    start: int
    cycles: int = 3
    down_windows: int = 2
    up_windows: int = 2
    jitter: float = 0.0

    def __post_init__(self):
        if self.cycles < 1:
            raise ValueError(f"cycles must be >= 1, got {self.cycles}")
        if self.down_windows < 1 or self.up_windows < 1:
            raise ValueError("down_windows and up_windows must be >= 1")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")

    @property
    def end_window(self) -> int:
        """Window of the final (un-jittered) restore event."""
        period = self.down_windows + self.up_windows
        return self.start + (self.cycles - 1) * period + self.down_windows


@dataclasses.dataclass(frozen=True)
class RailLossSpec:
    """NIC loss: every inter-group link through ``device``'s NIC goes down.

    Models a single NIC (one rail endpoint) failing — all rail links whose
    source *or* destination is ``device`` drop to ``DOWN_CAP`` at
    ``start`` and, unless ``restore`` is None (permanent loss), come back
    together at ``restore``.
    """

    device: int
    start: int
    restore: Optional[int] = None

    def __post_init__(self):
        if self.restore is not None and self.restore <= self.start:
            raise ValueError("restore must come after start")


@dataclasses.dataclass(frozen=True)
class TelemetryBlackoutSpec:
    """Telemetry loss over ``[start, start + duration)`` windows.

    ``drop_prob=1.0`` is a full blackout (the estimator sees nothing);
    ``drop_prob < 1`` is partial dropout — each pair-bytes entry is
    independently lost (NaN) with probability ``drop_prob``, masks drawn
    once per window from the injector's seeded RNG.
    """

    start: int
    duration: int
    drop_prob: float = 1.0

    def __post_init__(self):
        if self.duration < 1:
            raise ValueError(f"duration must be >= 1, got {self.duration}")
        if not 0.0 < self.drop_prob <= 1.0:
            raise ValueError(
                f"drop_prob must be in (0, 1], got {self.drop_prob}"
            )


@dataclasses.dataclass(frozen=True)
class StragglerSpec:
    """Inflated window completion over ``[start, start + duration)``.

    A slow participant stretches the measured wall time of every window in
    the range by ``inflation`` (>= 1) without changing routed bytes — the
    telemetry-plausible signature of a straggling rank.  Overlapping
    straggler specs compose by taking the worst (max) inflation.
    """

    start: int
    duration: int
    inflation: float = 2.0
    device: Optional[int] = None   # informational: which rank straggles

    def __post_init__(self):
        if self.duration < 1:
            raise ValueError(f"duration must be >= 1, got {self.duration}")
        if self.inflation < 1.0:
            raise ValueError(
                f"inflation must be >= 1.0, got {self.inflation}"
            )


@dataclasses.dataclass(frozen=True)
class TenantCrashSpec:
    """Tenant ``tenant`` stops heartbeating (committing) at ``window``.

    The drill harness stops stepping the tenant's runtime from ``window``
    on; the fabric sees its ledger stamp go stale and — with
    ``ArbiterConfig.evict_staleness`` set — decays it to zero and evicts.
    """

    tenant: str
    window: int


@dataclasses.dataclass(frozen=True)
class ElephantFlowSpec:
    """Background elephant: extra ``bytes_per_window`` on one pair.

    Injected additively into the *executed* demand over
    ``[start, start + duration)`` — cross-traffic the planner never asked
    for, per the congestion-characterization methodology (victim flows
    under sustained background elephants).  ``jitter`` multiplies each
    window's bytes by ``1 ± jitter`` noise from the injector's seeded RNG.
    """

    src: int
    dst: int
    start: int
    duration: int
    bytes_per_window: float
    jitter: float = 0.0

    def __post_init__(self):
        if self.duration < 1:
            raise ValueError(f"duration must be >= 1, got {self.duration}")
        if self.bytes_per_window <= 0:
            raise ValueError("bytes_per_window must be > 0")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")


@dataclasses.dataclass(frozen=True)
class FaultScenario:
    """One named, seeded bundle of fault specs — the injector's input.

    Spec tuples, not lists, so scenarios are hashable and safely shared;
    ``seed`` drives every stochastic choice (jitter, dropout masks) in the
    compiled schedule.
    """

    name: str
    seed: int = 0
    flaps: Tuple[LinkFlapSpec, ...] = ()
    rail_losses: Tuple[RailLossSpec, ...] = ()
    blackouts: Tuple[TelemetryBlackoutSpec, ...] = ()
    stragglers: Tuple[StragglerSpec, ...] = ()
    crashes: Tuple[TenantCrashSpec, ...] = ()
    elephants: Tuple[ElephantFlowSpec, ...] = ()

    def __post_init__(self):
        # tolerate lists at construction; normalize to tuples for hashing
        for field in ("flaps", "rail_losses", "blackouts", "stragglers",
                      "crashes", "elephants"):
            val = getattr(self, field)
            if not isinstance(val, tuple):
                object.__setattr__(self, field, tuple(val))
