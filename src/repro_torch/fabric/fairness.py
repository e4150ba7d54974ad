"""Fairness accounting over the shared fabric ledger.

Counterpart of ``repro/fabric/fairness.py``, copied as it is (numpy and the
stdlib only).

Two scalar summaries of how the fabric's capacity is split, both computed
over **weighted per-tenant drain times** ``x_i = drain_i * weight_i``
(a tenant with weight 2 is entitled to finish twice as fast on the same
demand, so scaling by the weight normalizes entitlement away):

  * **Jain's index** ``J = (sum x)^2 / (N * sum x^2)`` — 1.0 when every
    tenant drains in (weighted) lockstep, ``1/N`` when one tenant starves
    all others;
  * **weighted max-min violation** ``(max x - min x) / max x`` — 0 when
    weighted max-min fair; 1 when some tenant is fully crowded out.

Reports are emitted through the shared ``repro_torch.jsonio`` schema
(``nimble.fabric_fairness/v1``) so benches and ``experiments/make_report``
consume them like any other record.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

import numpy as np

from ..jsonio import tag
from .state import FabricState


def jains_index(values: Iterable[float]) -> float:
    """Jain's fairness index over ``values`` (1.0 for empty/uniform)."""
    x = np.asarray(list(values), dtype=np.float64)
    if x.size == 0:
        return 1.0
    if (x < 0).any():
        raise ValueError("Jain's index is defined over non-negative values")
    sq = float((x * x).sum())
    if sq <= 0.0:
        return 1.0
    s = float(x.sum())
    return s * s / (x.size * sq)


def maxmin_violation(values: Iterable[float]) -> float:
    """Relative spread ``(max - min) / max``; 0.0 = max-min fair."""
    x = np.asarray(list(values), dtype=np.float64)
    if x.size <= 1:
        return 0.0
    hi = float(x.max())
    if hi <= 0.0:
        return 0.0
    return (hi - float(x.min())) / hi


def weighted_drains(
    drains: Mapping[str, float], weights: Mapping[str, float]
) -> Dict[str, float]:
    """``drain_i * weight_i`` per tenant (missing weights default to 1)."""
    return {t: d * float(weights.get(t, 1.0)) for t, d in drains.items()}


def fairness_report(
    state: FabricState, weights: Mapping[str, float] | None = None
) -> dict:
    """Tagged fairness record for the current ledger contents.

    Fairness is accounted over the **raw** committed loads — drain times
    measure bytes a tenant actually put on the fabric, so price-recency
    decay never touches them.  The record carries the recency view
    alongside (``clock``, per-tenant ``staleness``; ``None`` = unstamped)
    so report consumers can tell a fresh ledger from one whose prices have
    largely faded.
    """
    weights = weights or {}
    drains = state.drain_times()
    wd = weighted_drains(drains, weights)
    order = sorted(drains)
    return tag(
        "fabric_fairness",
        {
            "tenants": order,
            "drain_s": {t: drains[t] for t in order},
            "weights": {t: float(weights.get(t, 1.0)) for t in order},
            "weighted_drain_s": {t: wd[t] for t in order},
            "jain_index": jains_index(wd.values()),
            "maxmin_violation": maxmin_violation(wd.values()),
            "combined_drain_s": state.combined_drain_s(),
            "clock": int(state.clock),
            "staleness": {t: state.staleness(t) for t in order},
        },
    )
