"""Declarative serving scenarios — tenant mixes, traffic programs, SLOs.

Counterpart of ``repro/serve/scenario.py`` (numpy and the stdlib only): the
same specs, the same built-in library and the same JSON, byte for byte.
The device a run solves on is an argument of the run
(:func:`~repro_torch.serve.controlplane.run_scenario`), not part of the
scenario.

A :class:`ScenarioSpec` is a frozen, JSON-round-trippable description of a
*continuous* serving deployment: which fabric, which tenants (each with a
per-tenant :class:`TrafficProgram` — diurnal swell, phase-shifted drifting
skew, MoE popularity flips), a deterministic tenant-churn schedule
(:class:`ChurnSpec`), an embedded :class:`~repro_torch.faults.FaultScenario`
drill, and an :class:`SloSpec` of gates the run must hold.  Scenarios are
*data*: they ship as config (``ScenarioSpec.to_json`` /
``ScenarioSpec.from_json`` round-trip bit-exactly, unknown keys raise with
the offending key named) and a named built-in library covers the paper's
production-shaped regimes:

  * ``steady``          — two balanced tenants; adaptive must *match*
    static (the no-regression scenario);
  * ``diurnal``         — phase-shifted diurnal skew swell (daytime
    hotspot concentration, nighttime balance) on two tenants;
  * ``churn_storm``     — a long-lived tenant under a storm of short-lived
    scavenger tenants joining and leaving;
  * ``flap_under_load`` — drifting skew while a rail link flaps;
  * ``elephant_victim`` — a victim tenant absorbing background elephant
    flows (the congestion-characterization victim-flow scenario).

Determinism contract: every stochastic choice (traffic jitter, popularity
flips, churn jitter) is drawn from RNGs seeded by ``(spec seed, window)``
or compiled in one fixed draw order, so a scenario replays bit-identically
— the same contract :mod:`repro_torch.faults` pins for fault schedules.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..api.spec import TopologySpec
from ..faults.scenarios import (
    ElephantFlowSpec,
    FaultScenario,
    LinkFlapSpec,
    RailLossSpec,
    StragglerSpec,
    TelemetryBlackoutSpec,
    TenantCrashSpec,
)
from ..jsonio import json_dumps, json_loads, tag

MB = float(1 << 20)

#: schema tag of a serialized scenario
SCENARIO_SCHEMA = "nimble.serve_scenario/v1"

#: traffic-program shapes understood by :meth:`TrafficProgram.demand`
TRAFFIC_KINDS = ("steady", "diurnal", "drift", "flips")


# -- traffic programs -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrafficProgram:
    """One tenant's open-ended traffic as a *function of the window index*.

    Stateless by construction: :meth:`demand` derives window ``w``'s
    ``[n, n]`` byte matrix from ``(seed, w)`` alone — no generator state —
    so a tenant joining at window 40 sees exactly the traffic it would
    have seen had it been up since window 0, and replays are bit-exact.

    Kinds:

      * ``steady``  — balanced all-pairs with multiplicative jitter;
      * ``diurnal`` — skew toward ``hot`` swells and relaxes with period
        ``period``: at the peak ``hot_frac`` of each source's bytes target
        the hotspot and the magnitude is ``swell``x; at the trough traffic
        is balanced at base magnitude (daytime concentration, nighttime
        balance).  ``phase`` shifts the cycle per tenant;
      * ``drift``   — a receive hotspot that migrates between node groups
        every ``dwell`` windows with a ``ramp``-window crossfade (the
        runtime-adaptation worst case); ``phase`` offsets the schedule so
        co-tenants peak on different groups;
      * ``flips``   — MoE popularity flips: ``n_hot`` "popular expert"
        destinations are re-drawn each ``dwell``-window epoch from the
        seeded RNG and flip *abruptly* (no ramp), the data-mixture
        phase-lock regime.
    """

    kind: str
    bytes_per_src: float = 256 * MB
    hot_frac: float = 0.7
    hot: int = 0             # diurnal: the fixed hotspot destination
    period: int = 12         # diurnal: full swell cycle, windows
    swell: float = 2.0       # diurnal: peak magnitude multiplier
    dwell: int = 8           # drift/flips: windows per hotspot epoch
    ramp: int = 2            # drift: crossfade windows at an epoch change
    n_hot: int = 2           # flips: popular destinations per epoch
    phase: int = 0           # window offset (phase-shifted co-tenants)
    jitter: float = 0.02
    seed: int = 0

    def __post_init__(self):
        if self.kind not in TRAFFIC_KINDS:
            raise ValueError(
                f"unknown traffic kind {self.kind!r}; one of {TRAFFIC_KINDS}"
            )
        if self.bytes_per_src <= 0:
            raise ValueError("bytes_per_src must be > 0")
        if not 0.0 < self.hot_frac <= 1.0:
            raise ValueError(f"hot_frac must be in (0, 1], got {self.hot_frac}")
        if self.period < 2 or self.dwell < 1:
            raise ValueError("period must be >= 2 and dwell >= 1")
        if self.swell < 1.0:
            raise ValueError(f"swell must be >= 1.0, got {self.swell}")
        if self.ramp < 0 or self.n_hot < 1:
            raise ValueError("ramp must be >= 0 and n_hot >= 1")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")

    # -- window -> demand --------------------------------------------------------
    def _skewed(self, n: int, hots: Tuple[int, ...], frac: float,
                scale: float) -> np.ndarray:
        """``frac`` of every source's bytes split across ``hots``."""
        bps = self.bytes_per_src * scale
        D = np.zeros((n, n))
        for s in range(n):
            hs = [h for h in hots if h != s]
            cold = [d for d in range(n) if d != s and d not in hs]
            if not hs or frac <= 0.0:
                for d in cold:
                    D[s, d] = bps / len(cold)
                continue
            for h in hs:
                D[s, h] = bps * frac / len(hs)
            for d in cold:
                D[s, d] = bps * (1.0 - frac) / len(cold)
        return D

    def _drift_hot(self, n: int, epoch: int) -> int:
        """Deterministic migrating hotspot: alternates node halves, then
        walks within the half — every migration crosses inter-group rails."""
        half = max(n // 2, 1)
        return (epoch % 2) * half + (epoch // 2) % half

    def demand(self, window: int, n: int) -> np.ndarray:
        """The ``[n, n]`` demand matrix this program emits at ``window``."""
        w = window + self.phase
        if self.kind == "steady":
            D = self._skewed(n, (), 0.0, 1.0)
        elif self.kind == "diurnal":
            s = 0.5 * (1.0 - np.cos(2.0 * np.pi * w / self.period))
            D = self._skewed(
                n, (self.hot % n,), self.hot_frac * s,
                1.0 + (self.swell - 1.0) * s,
            )
        elif self.kind == "drift":
            epoch, off = divmod(w, self.dwell)
            cur = self._skewed(
                n, (self._drift_hot(n, epoch),), self.hot_frac, 1.0
            )
            if epoch > 0 and off < self.ramp:
                mix = (off + 1) / (self.ramp + 1)
                prev = self._skewed(
                    n, (self._drift_hot(n, epoch - 1),), self.hot_frac, 1.0
                )
                cur = mix * cur + (1.0 - mix) * prev
            D = cur
        else:  # flips
            epoch = w // self.dwell
            rng = np.random.default_rng((self.seed, 7919, epoch))
            hots = tuple(
                int(h) for h in rng.choice(n, size=min(self.n_hot, n),
                                           replace=False)
            )
            D = self._skewed(n, hots, self.hot_frac, 1.0)
        if self.jitter > 0.0:
            rng = np.random.default_rng((self.seed, window))
            noise = 1.0 + self.jitter * rng.standard_normal((n, n))
            D = D * np.clip(noise, 0.25, 4.0)
        np.fill_diagonal(D, 0.0)
        return D


# -- tenants and churn ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's identity, entitlement, traffic, and lifetime.

    ``join_window`` / ``leave_window`` are *scenario* windows: the control
    plane spawns the tenant's session at ``join_window`` and retires it
    (clean close: ledger withdrawn, bus unsubscribed) at ``leave_window``;
    ``None`` runs to the end of the scenario.
    """

    name: str
    traffic: TrafficProgram
    qos: str = "standard"
    weight: float = 1.0
    join_window: int = 0
    leave_window: Optional[int] = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if self.join_window < 0:
            raise ValueError(f"join_window must be >= 0, got {self.join_window}")
        if self.leave_window is not None and self.leave_window <= self.join_window:
            raise ValueError(
                f"tenant {self.name!r}: leave_window {self.leave_window} "
                f"must come after join_window {self.join_window}"
            )


@dataclasses.dataclass(frozen=True)
class ChurnSpec:
    """Deterministic schedule of short-lived tenants joining and leaving.

    ``compile_churn`` expands this into concrete :class:`TenantSpec`\\ s in
    one fixed draw order from ``np.random.default_rng(seed)`` — the same
    (spec, horizon) pair always yields the bit-identical schedule (pinned
    by a hypothesis property in ``tests/test_torch_serve.py``, on both
    packages).
    """

    template: TrafficProgram
    n_tenants: int = 4
    lifetime: int = 6        # windows each churned tenant lives
    spacing: int = 3         # windows between consecutive joins
    start: int = 2
    jitter: int = 1          # +- windows on each join/lifetime draw
    qos: str = "scavenger"
    weight: float = 1.0
    name_prefix: str = "churn"
    seed: int = 0

    def __post_init__(self):
        if self.n_tenants < 1:
            raise ValueError(f"n_tenants must be >= 1, got {self.n_tenants}")
        if self.lifetime < 1 or self.spacing < 1:
            raise ValueError("lifetime and spacing must be >= 1")
        if self.start < 0 or self.jitter < 0:
            raise ValueError("start and jitter must be >= 0")


def compile_churn(spec: ChurnSpec, windows: int) -> Tuple[TenantSpec, ...]:
    """Expand a churn spec over a ``windows``-long horizon.

    Fixed draw order — two draws per tenant slot, always taken, even for
    slots that fall past the horizon — so the schedule is deterministic in
    (spec, windows) and a longer horizon only *extends* the prefix.
    """
    rng = np.random.default_rng(spec.seed)
    out: List[TenantSpec] = []
    for i in range(spec.n_tenants):
        j_off = int(rng.integers(-spec.jitter, spec.jitter + 1))
        l_off = int(rng.integers(-spec.jitter, spec.jitter + 1))
        join = max(spec.start + i * spec.spacing + j_off, 0)
        life = max(spec.lifetime + l_off, 1)
        if join >= windows - 1:
            continue  # would never step before teardown
        out.append(
            TenantSpec(
                name=f"{spec.name_prefix}-{i:02d}",
                traffic=spec.template,
                qos=spec.qos,
                weight=spec.weight,
                join_window=join,
                leave_window=join + life,
            )
        )
    return tuple(out)


# -- SLOs -------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SloSpec:
    """The gates a scenario run must hold (DESIGN.md §10.3).

    Latency gates are *relative* by default (robust across fabric scales):
    the cluster p99 window latency must stay within
    ``p99_latency_factor`` x the median, with an optional absolute ceiling
    ``p99_latency_s``.  The drain gates compare against the **unpriced
    static baseline** arm on the same scenario: ``combined_win_floor`` is
    the floor on ``static total completion / adaptive total completion``
    (1.0 = must not lose; 0.99 = parity) and ``min_drain_ratio`` the
    per-tenant floor on the same ratio.  ``jain_floor`` gates weighted
    fairness across tenants, ``max_recovery_windows`` the windows allowed
    between the drill's final link event and cluster latency returning to
    1.5x the healthy median, and ``availability_floor`` the fraction of
    windows served within ``availability_factor`` x the healthy median.
    """

    p99_latency_factor: float = 3.0
    p99_latency_s: Optional[float] = None
    combined_win_floor: float = 1.0
    min_drain_ratio: float = 0.9
    jain_floor: float = 0.8
    max_recovery_windows: Optional[int] = None
    availability_floor: float = 0.9
    availability_factor: float = 5.0

    def __post_init__(self):
        if self.p99_latency_factor < 1.0:
            raise ValueError("p99_latency_factor must be >= 1.0")
        if self.p99_latency_s is not None and self.p99_latency_s <= 0:
            raise ValueError("p99_latency_s must be > 0 or None")
        if self.combined_win_floor <= 0 or self.min_drain_ratio <= 0:
            raise ValueError("drain floors must be > 0")
        if not 0.0 <= self.jain_floor <= 1.0:
            raise ValueError("jain_floor must be in [0, 1]")
        if self.max_recovery_windows is not None and self.max_recovery_windows < 0:
            raise ValueError("max_recovery_windows must be >= 0 or None")
        if not 0.0 <= self.availability_floor <= 1.0:
            raise ValueError("availability_floor must be in [0, 1]")
        if self.availability_factor < 1.0:
            raise ValueError("availability_factor must be >= 1.0")


# -- the scenario -----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One named, seeded, fully-declarative serving scenario."""

    name: str
    topology: TopologySpec
    windows: int
    tenants: Tuple[TenantSpec, ...]
    churn: Optional[ChurnSpec] = None
    faults: Optional[FaultScenario] = None
    slo: SloSpec = SloSpec()
    seed: int = 0

    def __post_init__(self):
        if not isinstance(self.tenants, tuple):
            object.__setattr__(self, "tenants", tuple(self.tenants))
        if self.windows < 1:
            raise ValueError(f"windows must be >= 1, got {self.windows}")
        if not self.tenants:
            raise ValueError("a scenario needs at least one tenant")
        names = [t.name for t in self.roster()]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(
                f"duplicate tenant name {sorted(dupes)[0]!r} in scenario "
                f"{self.name!r}"
            )

    def roster(self) -> Tuple[TenantSpec, ...]:
        """Base tenants plus the compiled churn schedule (fixed order)."""
        extra = (
            compile_churn(self.churn, self.windows) if self.churn else ()
        )
        return self.tenants + extra

    def without_churn(self) -> "ScenarioSpec":
        """The never-churned control: base tenants only, same everything
        else — the reference arm for the survivor-drain gate."""
        return dataclasses.replace(self, churn=None)

    # -- JSON round trip ---------------------------------------------------------
    def to_json_obj(self) -> dict:
        if self.topology.caps is not None or self.topology.link_scale:
            raise ValueError(
                "scenario JSON carries only plain topology geometry "
                "(n_devices / group_size / n_pods); custom caps or "
                "link_scale belong in code-built specs"
            )
        obj = {
            "name": self.name,
            "topology": {
                "n_devices": self.topology.n_devices,
                "group_size": self.topology.group_size,
                "n_pods": self.topology.n_pods,
            },
            "windows": self.windows,
            "tenants": [_tenant_to_obj(t) for t in self.tenants],
            "churn": _churn_to_obj(self.churn) if self.churn else None,
            "faults": _faults_to_obj(self.faults) if self.faults else None,
            "slo": dataclasses.asdict(self.slo),
            "seed": self.seed,
        }
        return tag("serve_scenario", obj)

    def to_json(self) -> bytes:
        return json_dumps(self.to_json_obj(), indent=True)

    @staticmethod
    def from_json_obj(obj: dict) -> "ScenarioSpec":
        if not isinstance(obj, dict):
            raise ValueError(f"scenario must be a dict, got {type(obj).__name__}")
        obj = dict(obj)
        schema = obj.pop("schema", SCENARIO_SCHEMA)
        if schema != SCENARIO_SCHEMA:
            raise ValueError(
                f"scenario schema {schema!r} != {SCENARIO_SCHEMA!r}"
            )
        _check_keys(
            obj,
            ("name", "topology", "windows", "tenants", "churn", "faults",
             "slo", "seed"),
            "scenario",
        )
        topo_obj = dict(obj.get("topology") or {})
        _check_keys(
            topo_obj, ("n_devices", "group_size", "n_pods"),
            "scenario.topology",
        )
        churn = obj.get("churn")
        faults = obj.get("faults")
        return ScenarioSpec(
            name=obj["name"],
            topology=TopologySpec(**topo_obj),
            windows=obj["windows"],
            tenants=tuple(
                _tenant_from_obj(t) for t in obj.get("tenants", [])
            ),
            churn=_churn_from_obj(churn) if churn is not None else None,
            faults=_faults_from_obj(faults) if faults is not None else None,
            slo=_build(SloSpec, obj.get("slo") or {}, "scenario.slo"),
            seed=obj.get("seed", 0),
        )

    @staticmethod
    def from_json(data) -> "ScenarioSpec":
        if isinstance(data, str):
            data = data.encode()
        return ScenarioSpec.from_json_obj(json_loads(data))


# -- (de)serialization helpers ----------------------------------------------------

def _check_keys(obj: dict, allowed, what: str) -> None:
    """Reject unknown keys, naming the first offender — a typo'd scenario
    file must fail loudly, not silently drop a gate."""
    for k in obj:
        if k not in allowed:
            raise ValueError(f"{what}: unknown key {k!r}")


def _build(cls, obj: dict, what: str):
    """Strictly construct a flat frozen dataclass from a JSON dict."""
    if not isinstance(obj, dict):
        raise ValueError(f"{what}: expected a dict, got {type(obj).__name__}")
    _check_keys(obj, tuple(f.name for f in dataclasses.fields(cls)), what)
    return cls(**obj)


def _tenant_to_obj(t: TenantSpec) -> dict:
    obj = dataclasses.asdict(t)
    obj["traffic"] = dataclasses.asdict(t.traffic)
    return obj


def _tenant_from_obj(obj: dict) -> TenantSpec:
    if not isinstance(obj, dict):
        raise ValueError(f"tenant: expected a dict, got {type(obj).__name__}")
    obj = dict(obj)
    _check_keys(
        obj,
        tuple(f.name for f in dataclasses.fields(TenantSpec)),
        f"tenant {obj.get('name', '?')!r}",
    )
    traffic = _build(
        TrafficProgram, obj.pop("traffic", {}),
        f"tenant {obj.get('name', '?')!r}.traffic",
    )
    return TenantSpec(traffic=traffic, **obj)


def _churn_to_obj(c: ChurnSpec) -> dict:
    obj = dataclasses.asdict(c)
    obj["template"] = dataclasses.asdict(c.template)
    return obj


def _churn_from_obj(obj: dict) -> ChurnSpec:
    if not isinstance(obj, dict):
        raise ValueError(f"churn: expected a dict, got {type(obj).__name__}")
    obj = dict(obj)
    _check_keys(
        obj, tuple(f.name for f in dataclasses.fields(ChurnSpec)), "churn"
    )
    template = _build(
        TrafficProgram, obj.pop("template", {}), "churn.template"
    )
    return ChurnSpec(template=template, **obj)


#: fault-scenario list fields -> their leaf spec classes
_FAULT_FIELDS = {
    "flaps": LinkFlapSpec,
    "rail_losses": RailLossSpec,
    "blackouts": TelemetryBlackoutSpec,
    "stragglers": StragglerSpec,
    "crashes": TenantCrashSpec,
    "elephants": ElephantFlowSpec,
}


def _faults_to_obj(f: FaultScenario) -> dict:
    obj: dict = {"name": f.name, "seed": f.seed}
    for field, _ in _FAULT_FIELDS.items():
        specs = getattr(f, field)
        if specs:
            obj[field] = [dataclasses.asdict(s) for s in specs]
    return obj


def _faults_from_obj(obj: dict) -> FaultScenario:
    if not isinstance(obj, dict):
        raise ValueError(f"faults: expected a dict, got {type(obj).__name__}")
    obj = dict(obj)
    _check_keys(obj, ("name", "seed") + tuple(_FAULT_FIELDS), "faults")
    kwargs: dict = {
        "name": obj.get("name", "faults"),
        "seed": obj.get("seed", 0),
    }
    for field, cls in _FAULT_FIELDS.items():
        specs = obj.get(field)
        if specs:
            kwargs[field] = tuple(
                _build(cls, s, f"faults.{field}[{i}]")
                for i, s in enumerate(specs)
            )
    return FaultScenario(**kwargs)


# -- built-in library -------------------------------------------------------------

_TOPO8 = TopologySpec(8, group_size=4)


def _steady() -> ScenarioSpec:
    """Two balanced tenants, no drills: adaptive must match static."""
    return ScenarioSpec(
        name="steady",
        topology=_TOPO8,
        windows=24,
        tenants=(
            TenantSpec("web", TrafficProgram("steady", seed=1)),
            TenantSpec("batch", TrafficProgram("steady", seed=2),
                       qos="scavenger"),
        ),
        slo=SloSpec(
            p99_latency_factor=1.5,
            combined_win_floor=0.99,
            min_drain_ratio=0.95,
            jain_floor=0.9,
            availability_floor=0.95,
        ),
    )


def _diurnal() -> ScenarioSpec:
    """Phase-shifted diurnal skew swell on two tenants: each tenant's
    hotspot concentrates and relaxes on an 18-window day, half a day out
    of phase with its peer — the aggregate shape never stops moving."""
    return ScenarioSpec(
        name="diurnal",
        topology=_TOPO8,
        windows=36,
        tenants=(
            TenantSpec(
                "east",
                TrafficProgram("diurnal", hot=0, period=18, swell=2.0,
                               hot_frac=0.7, seed=3),
            ),
            TenantSpec(
                "west",
                TrafficProgram("diurnal", hot=4, period=18, swell=2.0,
                               hot_frac=0.7, phase=9, seed=4),
            ),
        ),
        slo=SloSpec(
            p99_latency_factor=3.0,
            combined_win_floor=1.0,
            min_drain_ratio=0.9,
            jain_floor=0.8,
        ),
    )


def _churn_storm() -> ScenarioSpec:
    """One long-lived drifting tenant under a storm of short-lived
    scavenger tenants; the survivor's drain must shrug the churn off."""
    return ScenarioSpec(
        name="churn_storm",
        topology=_TOPO8,
        windows=32,
        tenants=(
            TenantSpec("survivor", TrafficProgram("drift", dwell=8, seed=5)),
        ),
        churn=ChurnSpec(
            template=TrafficProgram("steady", bytes_per_src=64 * MB, seed=6),
            n_tenants=5,
            lifetime=6,
            spacing=4,
            start=4,
            jitter=1,
            seed=11,
        ),
        slo=SloSpec(
            p99_latency_factor=3.0,
            combined_win_floor=1.0,
            min_drain_ratio=0.85,
            jain_floor=0.5,      # scavenger churners are *entitled* to less
        ),
    )


def _flap_under_load() -> ScenarioSpec:
    """Drifting skew while a rail link flaps down/up — the execution-time
    case for replanning: static keeps routing into the dead link."""
    return ScenarioSpec(
        name="flap_under_load",
        topology=_TOPO8,
        windows=32,
        tenants=(
            TenantSpec("app", TrafficProgram("drift", dwell=8, seed=7)),
            TenantSpec("side", TrafficProgram("steady",
                                              bytes_per_src=128 * MB,
                                              seed=8)),
        ),
        faults=FaultScenario(
            name="flap_under_load",
            flaps=(
                LinkFlapSpec(src=0, dst=4, start=10, cycles=2,
                             down_windows=2, up_windows=3),
            ),
        ),
        slo=SloSpec(
            p99_latency_factor=6.0,   # flap windows are *supposed* to spike
            combined_win_floor=1.0,
            min_drain_ratio=0.9,
            jain_floor=0.7,
            max_recovery_windows=2,
            availability_floor=0.8,
        ),
    )


def _elephant_victim() -> ScenarioSpec:
    """A victim tenant absorbing sustained background elephant flows on a
    rail pair (arxiv 2604.11432's victim-flow scenario): adaptive re-solves
    spread the elephant across alternates, static funnels it through the
    pre-elephant split and the victim's p99 spikes."""
    return ScenarioSpec(
        name="elephant_victim",
        topology=_TOPO8,
        windows=30,
        tenants=(
            TenantSpec("victim", TrafficProgram("steady", seed=9)),
            TenantSpec("peer", TrafficProgram("steady",
                                              bytes_per_src=128 * MB,
                                              seed=10)),
        ),
        faults=FaultScenario(
            name="elephant_victim",
            seed=13,
            elephants=(
                ElephantFlowSpec(src=1, dst=5, start=8, duration=16,
                                 bytes_per_window=1024.0 * MB, jitter=0.1),
            ),
        ),
        slo=SloSpec(
            p99_latency_factor=6.0,
            combined_win_floor=1.0,
            # priced tenants cede some *solo* drain (longer alternate
            # paths) to win the combined stack — calibrated: worst tenant
            # 0.83x solo for a 1.36x combined win
            min_drain_ratio=0.8,
            jain_floor=0.7,
        ),
    )


def _minimal() -> ScenarioSpec:
    """Smallest end-to-end scenario: two tenants, six windows — the
    ``repro_torch.api.selfcheck`` check-6 fixture, registry-hosted so it stays
    round-trippable and launchable like every other built-in."""
    return ScenarioSpec(
        name="minimal",
        topology=_TOPO8,
        windows=6,
        tenants=(
            TenantSpec("a", TrafficProgram("steady", seed=1)),
            TenantSpec("b", TrafficProgram("steady", seed=2)),
        ),
        slo=SloSpec(p99_latency_factor=2.0, jain_floor=0.8,
                    availability_floor=0.9),
    )


#: name -> the function that makes each built-in scenario
BUILTIN_SCENARIOS = {
    "steady": _steady,
    "diurnal": _diurnal,
    "churn_storm": _churn_storm,
    "flap_under_load": _flap_under_load,
    "elephant_victim": _elephant_victim,
    "minimal": _minimal,
}


def scenario_names() -> List[str]:
    return sorted(BUILTIN_SCENARIOS)


def get_scenario(name: str) -> ScenarioSpec:
    """Resolve a built-in scenario by name (fresh spec every call)."""
    try:
        return BUILTIN_SCENARIOS[name]()
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; one of {scenario_names()}"
        ) from None


def load_scenario(name_or_path: str) -> ScenarioSpec:
    """Registry name or a path to a ``nimble.serve_scenario/v1`` JSON file."""
    if name_or_path in BUILTIN_SCENARIOS:
        return BUILTIN_SCENARIOS[name_or_path]()
    import os

    if os.path.exists(name_or_path):
        with open(name_or_path, "rb") as f:
            return ScenarioSpec.from_json(f.read())
    raise ValueError(
        f"{name_or_path!r} is neither a built-in scenario "
        f"({scenario_names()}) nor a scenario JSON file"
    )
