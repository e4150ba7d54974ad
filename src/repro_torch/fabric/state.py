"""Shared fabric ledger — per-tenant committed load over one resource vector.

Counterpart of ``repro/fabric/state.py``, copied as it is (numpy and the
stdlib only): every sum over tenants and every decay factor is computed in
the reference's order, so priced plans see the same prices to the last bit.

:class:`FabricState` is the arbiter's view of the fabric: one resource
vector (``cost.ResourceModel``: links, relay caps, inject caps) and, per
registered tenant, the *effective bytes* that tenant currently has
committed onto each resource.  Commitments come from two producers:

  * host-level co-planning (:meth:`~repro_torch.fabric.FabricArbiter.arbitrate`)
    commits each tenant's solved ``Plan.resource_bytes``;
  * runtime tenants export telemetry every window — the executed plan's
    per-resource loads land here via ``OrchestrationRuntime.step``.

The ledger is what congestion pricing reads: a tenant's *external load* is
everyone else's committed bytes, which the MWU solvers accept via
``ext_loads`` (priced, never accounted).  Loads are effective bytes — they
depend only on the cost model's charge multipliers, not on link capacities
— so they stay valid across link down/degrade/restore events; only the
capacity vector (used for drain-time fairness accounting) is rebuilt, keyed
by the new topology fingerprint.

**Recency.**  A committed load is only a faithful congestion signal at the
timescale it was measured, so commits may carry a **window stamp**
(telemetry exports do; host co-planning commits are *unstamped* — a solved
plan with no window clock is timeless).  The ledger keeps a fabric
``clock`` (the newest stamped window it has seen) and exposes per-tenant
``staleness``; :meth:`external_load` can apply exponential recency decay
(``half_life`` in windows, weight ``0.5 ** (staleness / half_life)``) so a
peer's load fades unless refreshed by telemetry.  ``half_life=None`` takes
the exact raw-ledger code path — byte-identical prices to the undecayed
ledger — and unstamped entries never decay at any half-life.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from ..core.cost import CostModel, ResourceModel
from ..core.topology import Topology
from ..jsonio import tag


class FabricState:
    """Per-resource committed-load ledger shared by all tenants."""

    def __init__(self, topo: Topology, cost_model: CostModel | None = None):
        self.cm = cost_model or CostModel()
        self._committed: "collections.OrderedDict[str, np.ndarray]" = (
            collections.OrderedDict()
        )
        # window stamp of each tenant's last commit (None = unstamped /
        # timeless) and the fabric clock: the newest stamped window seen
        self._stamp: Dict[str, Optional[int]] = {}
        self._clock = 0
        self._set_topology(topo)

    def _set_topology(self, topo: Topology) -> None:
        self.topo = topo
        self.rm = ResourceModel(topo, self.cm)

    # -- identity ---------------------------------------------------------------
    @property
    def fingerprint(self) -> Tuple:
        return self.topo.fingerprint

    @property
    def n_resources(self) -> int:
        return self.rm.n_resources

    # -- ledger -----------------------------------------------------------------
    def commit(
        self,
        tenant: str,
        resource_bytes: np.ndarray,
        window: Optional[int] = None,
        fingerprint: Optional[Tuple] = None,
    ) -> None:
        """Replace ``tenant``'s committed load with ``resource_bytes`` [R].

        ``window`` stamps the commit for recency accounting (telemetry
        exports pass their window counter; ``None`` leaves the entry
        unstamped/timeless — the host co-planning path).  ``fingerprint``,
        when given, is the topology fingerprint the load was *solved
        against*: a geometry/base-capacity mismatch with the fabric's is
        rejected with an error naming both fingerprints (the tenant
        exported telemetry for a different fabric — typically a
        fingerprint-keyed capacity rebuild racing a window export), while
        a mismatch only in the trailing per-link scale component is
        accepted — runtimes apply broadcast link events at their own
        window boundaries, so transient scale divergence is expected and
        effective-bytes loads stay valid across it.
        """
        if fingerprint is not None and fingerprint[:-1] != self.fingerprint[:-1]:
            raise ValueError(
                f"tenant {tenant!r} committed loads solved against topology "
                f"fingerprint {fingerprint!r}, but the fabric ledger is at "
                f"{self.fingerprint!r} — geometry/base capacities disagree "
                "(stale export across a topology rebuild?)"
            )
        loads = np.asarray(resource_bytes, dtype=np.float64)
        if loads.shape != (self.rm.n_resources,):
            raise ValueError(
                f"committed loads shape {loads.shape} != "
                f"({self.rm.n_resources},) — tenant topology disagrees with "
                "the fabric's (pass the solve's topology fingerprint to "
                "commit() to get the mismatch named explicitly)"
            )
        if (loads < 0).any():
            raise ValueError(f"negative committed load from tenant {tenant!r}")
        self._committed[tenant] = loads.copy()
        self._stamp[tenant] = None if window is None else int(window)
        if window is not None:
            self._clock = max(self._clock, int(window))

    def withdraw(self, tenant: str) -> None:
        """Remove ``tenant``'s ledger entry (load and stamp).

        Withdrawing an unknown — or already-withdrawn — tenant is a
        documented **no-op**, not an error: teardown paths race (session
        close vs. arbiter staleness eviction vs. explicit unregister), and
        "this tenant contributes nothing to the ledger" is already true.
        The reference pins it in ``tests/test_faults.py``.
        """
        self._committed.pop(tenant, None)
        self._stamp.pop(tenant, None)

    def committed_load(self, tenant: str) -> Optional[np.ndarray]:
        loads = self._committed.get(tenant)
        return None if loads is None else loads.copy()

    def tenants(self) -> List[str]:
        return list(self._committed)

    def total_load(self) -> np.ndarray:
        """Sum of all tenants' committed loads [R] (zeros when empty)."""
        total = np.zeros(self.rm.n_resources, dtype=np.float64)
        for loads in self._committed.values():
            total += loads
        return total

    def external_load(
        self, tenant: str, half_life: Optional[float] = None
    ) -> np.ndarray:
        """Everyone-but-``tenant``'s committed load [R] (always >= 0).

        With ``half_life`` set, each peer's contribution is scaled by its
        recency weight (:meth:`decay_factor`) — stamped entries fade as the
        fabric clock runs past them, unstamped entries count in full.
        ``half_life=None`` is the raw-ledger path, byte-identical to the
        pre-recency ledger (total minus own, no per-peer arithmetic).
        """
        if half_life is None:
            total = self.total_load()
            own = self._committed.get(tenant)
            if own is not None:
                total -= own
            # float cancellation can leave tiny negatives; prices must not
            return np.maximum(total, 0.0)
        ext = np.zeros(self.rm.n_resources, dtype=np.float64)
        for peer, loads in self._committed.items():
            if peer == tenant:
                continue
            factor = self.decay_factor(peer, half_life)
            # factor == 1.0 skips the multiply so fresh/unstamped peers
            # contribute their exact committed bytes
            ext += loads if factor == 1.0 else loads * factor
        return ext

    # -- recency ----------------------------------------------------------------
    @property
    def clock(self) -> int:
        """The fabric clock: newest stamped commit window seen (0 when no
        stamped commit has landed yet)."""
        return self._clock

    def staleness(self, tenant: str) -> Optional[float]:
        """Windows since ``tenant``'s last stamped commit, against the
        fabric clock; ``None`` for unstamped (timeless) or unknown
        tenants.  Never negative — a commit stamped ahead of the clock
        advances the clock instead."""
        stamp = self._stamp.get(tenant)
        if stamp is None:
            return None
        return float(max(self._clock - stamp, 0))

    def decay_factor(self, tenant: str, half_life: Optional[float]) -> float:
        """Recency weight of ``tenant``'s ledger entry in decayed prices:
        ``0.5 ** (staleness / half_life)``, monotone non-increasing in
        staleness, exactly 1.0 for fresh or unstamped entries (and for
        ``half_life=None`` / non-positive half-lives, which disable
        decay)."""
        if half_life is None or half_life <= 0:
            return 1.0
        stale = self.staleness(tenant)
        if stale is None or stale == 0.0:
            return 1.0
        return float(0.5 ** (stale / float(half_life)))

    # -- drain accounting -------------------------------------------------------
    def drain_time_s(self, loads: np.ndarray) -> float:
        """Seconds to drain ``loads`` at current capacities (max resource)."""
        return float(np.max(loads / self.rm.capacity)) if len(loads) else 0.0

    def drain_times(self) -> Dict[str, float]:
        """Per-tenant drain time of each tenant's own committed load."""
        return {t: self.drain_time_s(l) for t, l in self._committed.items()}

    def combined_drain_s(self) -> float:
        """Drain time of the *stacked* fabric load — the co-planning metric."""
        return self.drain_time_s(self.total_load())

    # -- observability ----------------------------------------------------------
    def summary(self) -> dict:
        """Compact health snapshot for the metrics registry (DESIGN.md §11).

        Unlike :meth:`to_json_obj` this stays numeric-only (no schema
        envelope, no per-tenant drain map) so the flight recorder can map
        it straight onto gauges; unstamped tenants report staleness 0.0 —
        a timeless entry is never stale.
        """
        return {
            "clock": int(self._clock),
            "tenants": len(self._committed),
            "combined_drain_s": self.combined_drain_s(),
            "staleness": {
                t: (self.staleness(t) or 0.0) for t in self._committed
            },
        }

    # -- link events ------------------------------------------------------------
    def apply_link_overrides(
        self, overrides: Mapping[Tuple[int, int], float]
    ) -> Tuple:
        """Rescale link capacities; returns the new topology fingerprint.

        Geometry is unchanged (same resource vector length), so committed
        loads remain valid; drain accounting follows the new capacities.
        """
        self._set_topology(self.topo.with_link_scale(overrides))
        return self.fingerprint

    # -- serialization ----------------------------------------------------------
    def to_json_obj(self) -> dict:
        drains = self.drain_times()
        return tag(
            "fabric_state",
            {
                "n_resources": int(self.rm.n_resources),
                "tenants": sorted(self._committed),
                "drain_s": {t: drains[t] for t in sorted(drains)},
                "combined_drain_s": self.combined_drain_s(),
                "down_links": [int(l) for l in self.topo.down_link_ids()],
                "clock": int(self._clock),
                "staleness": {
                    t: self.staleness(t) for t in sorted(self._committed)
                },
            },
        )
