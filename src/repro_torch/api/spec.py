"""Declarative session specification — everything a NIMBLE stack needs.

Counterpart of ``repro/api/spec.py``, with one field the reference lacks:
``SessionSpec.device``, where the session's runtime solves its replans (the
card unless the caller names the CPU).

The paper's integration claim is that NIMBLE is *endpoint-driven* and
plugs into existing communication libraries "without requiring application
changes".  After the planner (DESIGN.md §2), runtime (§3), and fabric
arbiter (§4) landed, the wiring to get there was anything but declarative:
every caller hand-built ``Topology`` + ``CostModel`` + ``PlannerConfig`` +
``OrchestrationRuntime`` + ``FabricArbiter`` and called
``attach_telemetry`` / ``register_runtime`` in exactly the right order.
:class:`SessionSpec` replaces that plumbing with one frozen value object:
*what* fabric, *which* tenant, *how much* adaptivity — and
:class:`~repro_torch.api.session.Session` turns it into a wired stack.

Adaptivity levels (strictly increasing capability):

  * ``"static"``     — planner only.  ``plan()`` / ``run_trace()`` solve
    one-shot; endpoints carry no telemetry.  Construction-equivalent to
    hand wiring the planner.
  * ``"adaptive"``   — adds an :class:`~repro_torch.runtime.OrchestrationRuntime`
    (monitor → estimate → replan → swap); endpoints auto-attach telemetry.
  * ``"arbitrated"`` — additionally joins a shared
    :class:`~repro_torch.fabric.FabricArbiter` as tenant ``tenant`` (weight /
    QoS / admission from this spec): solves are congestion-priced, replans
    gated, link events and price hints arrive over the shared bus.
    Price-recency protection is ON by default at this level
    (``price_decay`` / ``fabric_staleness``, calibrated on the
    mutual-drift scenarios of ``launch/fairness.py``): exported
    prices fade as peers' telemetry stamps go stale, pending plans are
    re-priced at the swap boundary, and a "prices moved" hint
    force-replans a demand-stable tenant.  Pass ``None`` for either knob
    to opt back out — byte-identical to the raw-ledger arbiter.

Every ``None`` component-config field falls through to the exact library
default the hand-wired constructors use, which is what makes the facade's
bit-exactness guarantee (``tests/test_torch_session.py``) possible at all; the
two recency knobs are the one deliberate exception, and ``None`` there is
the opt-*out*.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple, Union

from ..core.cost import CostModel
from ..core.planner import PlannerConfig
from ..core.topology import LinkCaps, Topology
from ..fabric import AdmissionConfig, ArbiterConfig, QOS_RANK, TenantConfig
from ..runtime import EstimatorConfig, PolicyConfig, RuntimeConfig

#: valid ``SessionSpec.adaptivity`` values, weakest first
ADAPTIVITY_LEVELS = ("static", "adaptive", "arbitrated")

#: calibrated price-recency defaults for **arbitrated** sessions
#: (DESIGN.md §4.3), chosen on the mutual-drift scenarios of the reference's
#: ``benchmarks/bench_fairness.py``: a 4-window half-life fades a peer
#: that stopped refreshing telemetry to ~3% of its committed load within
#: two dwell periods of the drift traces without perturbing fresh or
#: host-committed (unstamped) loads, and a 2-window soft deadline
#: re-prices a demand-stable tenant two windows after a "prices moved"
#: hint — late enough that one in-flight replan absorbs the shift, early
#: enough that stale avoidance never outlives a drift phase.  Both are
#: per-session knobs; ``None`` opts back out to the raw-ledger behavior
#: (byte-identical, pinned by ``tests/test_torch_fabric.py``).
PRICE_DECAY_DEFAULT: float = 4.0      # half-life, windows
FABRIC_STALENESS_DEFAULT: int = 2     # windows from hint to forced replan


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """Declarative fabric geometry — a :class:`Topology` as a value.

    Mirrors the ``Topology`` constructor one-for-one so specs can live in
    configs / JSON-ish call sites without importing the core; ``build()``
    is the only construction path and therefore the single place the
    session layer turns description into geometry.
    """

    n_devices: int
    group_size: int = 4
    n_pods: int = 1
    caps: Optional[LinkCaps] = None
    # (src, dst) -> capacity scale; a mapping or an iterable of pairs
    link_scale: Union[
        Mapping[Tuple[int, int], float],
        Tuple[Tuple[Tuple[int, int], float], ...],
        None,
    ] = None

    def build(self) -> Topology:
        return Topology(
            self.n_devices,
            self.group_size,
            self.n_pods,
            self.caps,
            dict(self.link_scale) if self.link_scale else None,
        )


@dataclasses.dataclass(frozen=True)
class SessionSpec:
    """One declarative description of a full NIMBLE stack.

    ``topology`` accepts either a :class:`TopologySpec` or an existing
    :class:`Topology` (callers that already hold one, e.g. benchmarks
    sweeping a fixed fabric).  ``cost`` accepts a :class:`CostModel`, a
    mapping of field overrides (``{"relay_cap": 9e10}``), or ``None`` for
    library defaults.  ``fabric`` lets an arbitrated session *join* an
    existing :class:`~repro_torch.fabric.FabricArbiter` (multi-session
    deployments share one ledger); ``None`` makes the session construct
    and own its own.  ``device`` is where the session's runtime solves
    (``"cuda"`` unless the caller names ``"cpu"``); it changes no result.
    """

    topology: Union[TopologySpec, Topology]
    cost: Union[CostModel, Mapping, None] = None
    adaptivity: str = "static"
    # -- tenant identity (arbitrated sessions) ---------------------------------
    tenant: str = "default"
    qos: str = "standard"
    weight: float = 1.0
    admission: Optional[AdmissionConfig] = None
    # -- component overrides (None = the hand-wired constructor default) -------
    planner: Optional[PlannerConfig] = None
    runtime: Optional[RuntimeConfig] = None
    policy: Optional[PolicyConfig] = None
    estimator: Optional[EstimatorConfig] = None
    arbiter: Optional[ArbiterConfig] = None
    fabric: Optional[object] = None          # shared FabricArbiter to join
    initial_demand: Optional[object] = None  # [n, n] warm demand matrix
    # -- price recency (arbitrated sessions; ignored otherwise) ----------------
    # half-life (windows) for recency decay of peers' stamped committed
    # load in exported prices, and the soft deadline (windows) between a
    # "prices moved" hint and a forced re-pricing replan.  The calibrated
    # defaults are ON for arbitrated sessions; THESE spec-level knobs are
    # the opt-out — pass None here for raw-ledger / hint-only behavior.
    # An explicit non-None ``arbiter=ArbiterConfig(price_decay=...)`` or
    # ``policy=PolicyConfig(fabric_staleness=...)`` wins over these, but a
    # component-config None means "inherit" (it is indistinguishable from
    # the constructor default), not "disable"; a joined ``fabric`` keeps
    # its owner's arbiter config.
    price_decay: Optional[float] = PRICE_DECAY_DEFAULT
    fabric_staleness: Optional[int] = FABRIC_STALENESS_DEFAULT
    # -- where the runtime's replans are solved --------------------------------
    device: str = "cuda"

    def __post_init__(self):
        if self.adaptivity not in ADAPTIVITY_LEVELS:
            raise ValueError(
                f"unknown adaptivity {self.adaptivity!r}; "
                f"one of {ADAPTIVITY_LEVELS}"
            )
        if self.qos not in QOS_RANK:
            raise ValueError(
                f"unknown qos class {self.qos!r}; one of {sorted(QOS_RANK)}"
            )
        if self.weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {self.weight}")
        if self.runtime is not None and self.planner is not None:
            raise ValueError(
                "give the planner config via runtime=RuntimeConfig("
                "planner=...) when a runtime config is supplied — two "
                "sources of planner truth would desynchronize plan() and "
                "the replan loop"
            )
        adaptive = self.adaptivity in ("adaptive", "arbitrated")
        if not adaptive:
            for field in ("runtime", "policy", "estimator", "initial_demand"):
                if getattr(self, field) is not None:
                    raise ValueError(
                        f"{field!r} requires adaptivity 'adaptive' or "
                        f"'arbitrated', not {self.adaptivity!r}"
                    )
        if self.adaptivity != "arbitrated":
            if self.fabric is not None or self.arbiter is not None:
                raise ValueError(
                    "'fabric'/'arbiter' require adaptivity 'arbitrated'"
                )
        if self.fabric is not None and self.arbiter is not None:
            raise ValueError(
                "'arbiter' configures a session-owned arbiter; a joined "
                "'fabric' already has its own config"
            )
        if self.price_decay is not None and self.price_decay <= 0:
            raise ValueError(
                f"price_decay half-life must be > 0 windows or None, got "
                f"{self.price_decay}"
            )
        if self.fabric_staleness is not None and self.fabric_staleness < 1:
            raise ValueError(
                f"fabric_staleness must be >= 1 window or None, got "
                f"{self.fabric_staleness}"
            )

    # -- builders ----------------------------------------------------------------
    def build_topology(self) -> Topology:
        if isinstance(self.topology, Topology):
            return self.topology
        return self.topology.build()

    def build_cost_model(self) -> Optional[CostModel]:
        """``None`` means "library defaults" and is passed through as-is,
        so Session-built components share the exact code paths (and value
        caches) of hand-wired ones."""
        if self.cost is None or isinstance(self.cost, CostModel):
            return self.cost
        return dataclasses.replace(CostModel(), **dict(self.cost))

    def runtime_config(self) -> Optional[RuntimeConfig]:
        """Runtime config with a bare ``planner`` override folded in."""
        if self.runtime is not None:
            return self.runtime
        if self.planner is not None:
            return RuntimeConfig(planner=self.planner)
        return None

    def tenant_config(self) -> TenantConfig:
        return TenantConfig(
            weight=self.weight,
            qos=self.qos,
            admission=self.admission or AdmissionConfig(),
        )

    def policy_config(self) -> Optional[PolicyConfig]:
        """Replan policy with the calibrated ``fabric_staleness`` folded in.

        Arbitrated sessions get the spec-level soft deadline unless the
        explicit ``policy`` already pins a non-``None`` one (a ``None``
        there is the constructor default and means "inherit" — disabling
        goes through ``SessionSpec.fabric_staleness=None``, the one knob
        that can express the opt-out).  Non-arbitrated sessions pass
        ``policy`` through untouched — without an arbiter there are no
        hints for the deadline to watch, and the hand-wired constructor
        defaults must stay bit-identical.
        """
        if self.adaptivity != "arbitrated" or self.fabric_staleness is None:
            return self.policy
        policy = self.policy or PolicyConfig()
        if policy.fabric_staleness is not None:
            return policy
        return dataclasses.replace(
            policy, fabric_staleness=self.fabric_staleness
        )

    def arbiter_config(self) -> ArbiterConfig:
        """Arbiter config with the calibrated ``price_decay`` folded in.

        Used only when the session constructs and owns its fabric; a
        joined ``fabric`` already runs under its owner's config.  An
        explicit non-``None`` ``arbiter=ArbiterConfig(price_decay=...)``
        wins over the spec-level knob; ``ArbiterConfig(price_decay=None)``
        is the constructor default and means "inherit" — disabling decay
        goes through ``SessionSpec.price_decay=None``.
        """
        cfg = self.arbiter or ArbiterConfig()
        if self.price_decay is not None and cfg.price_decay is None:
            cfg = dataclasses.replace(cfg, price_decay=self.price_decay)
        return cfg
