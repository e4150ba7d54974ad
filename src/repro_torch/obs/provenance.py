"""Plan-provenance audit trail (counterpart of ``repro/obs/provenance.py``).

Every plan the runtime issues gets a :class:`PlanProvenance` record in
the recorder's :class:`ProvenanceLog`: who asked for it (trigger
reason), what demand it solved (signature hash + totals), whether the
plan cache hit, the congestion prices at issue vs. at swap, the solver
source (``solve`` / ``cache`` / ``reprice`` / ``watchdog`` / initial),
and the fault context active when it was issued.  The record outlives
the Session that produced it — retired tenants' plans stay queryable —
so "why did tenant B swap at window 17?" is answerable after the run.

Records are mutated in place as the plan moves through its lifecycle
(`issue` → `mark_ready` → `mark_swapped` | `mark_abandoned`); the
runtime holds the record on ``PlanHandle.provenance`` and the log keeps
the authoritative ordered list.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Tuple

from ..jsonio import tag

PROVENANCE_KIND = "plan_provenance"
PROVENANCE_LOG_KIND = "provenance_log"


def signature_hash(signature) -> str:
    """Stable short hash of a plan-cache demand signature."""
    return hashlib.sha1(repr(signature).encode()).hexdigest()[:12]


def price_summary(prices) -> Optional[dict]:
    """Compact JSON summary of a congestion-price vector (or None)."""
    if prices is None:
        return None
    import numpy as np

    arr = np.asarray(prices, dtype=float).ravel()
    if arr.size == 0:
        return {"links": 0, "max": 0.0, "mean": 0.0, "nonzero": 0}
    return {
        "links": int(arr.size),
        "max": float(arr.max()),
        "mean": float(arr.mean()),
        "nonzero": int(np.count_nonzero(arr)),
    }


@dataclasses.dataclass
class PlanProvenance:
    """Audit record for one issued plan (see module docstring)."""

    tenant: str
    version: int
    source: str                 # solve | cache | reprice | watchdog | initial
    trigger: str                # replan reason (congestion/topology/...) or
                                # "initial" for the construction-time plan
    cache_hit: bool
    issued_window: int
    signature: str              # short demand-signature hash
    demand_bytes: float
    baseline_ratio: float
    planner: dict               # solver-parameter fingerprint
    prices_at_issue: Optional[dict] = None
    repriced: bool = False
    ready_window: Optional[int] = None
    swapped_window: Optional[int] = None
    prices_at_swap: Optional[dict] = None
    reprice_rel_change: Optional[float] = None
    abandoned: bool = False
    fault_context: Tuple[str, ...] = ()

    @property
    def swapped(self) -> bool:
        return self.swapped_window is not None

    def mark_ready(self, window: int) -> None:
        self.ready_window = int(window)

    def mark_swapped(self, window: int, prices=None,
                     rel_change: Optional[float] = None,
                     repriced: bool = False) -> None:
        self.swapped_window = int(window)
        self.prices_at_swap = price_summary(prices)
        if rel_change is not None:
            self.reprice_rel_change = float(rel_change)
        if repriced:
            self.repriced = True

    def mark_abandoned(self) -> None:
        self.abandoned = True

    def to_json_obj(self) -> dict:
        return tag(PROVENANCE_KIND, dataclasses.asdict(self))


class ProvenanceLog:
    """Ordered, queryable log of every plan issued under one recorder."""

    def __init__(self):
        self._records: List[PlanProvenance] = []

    def issue(self, *, tenant: str, version: int, source: str, trigger: str,
              cache_hit: bool, issued_window: int, signature,
              demand_bytes: float, baseline_ratio: float, planner: dict,
              prices=None, repriced: bool = False,
              fault_context: Tuple[str, ...] = ()) -> PlanProvenance:
        rec = PlanProvenance(
            tenant=tenant,
            version=int(version),
            source=source,
            trigger=trigger,
            cache_hit=bool(cache_hit),
            issued_window=int(issued_window),
            signature=signature_hash(signature),
            demand_bytes=float(demand_bytes),
            baseline_ratio=float(baseline_ratio),
            planner=dict(planner),
            prices_at_issue=price_summary(prices),
            repriced=bool(repriced),
            fault_context=tuple(fault_context),
        )
        self._records.append(rec)
        return rec

    def __len__(self) -> int:
        return len(self._records)

    def __iter__(self):
        return iter(self._records)

    def records(self) -> List[PlanProvenance]:
        return list(self._records)

    def for_tenant(self, tenant: str) -> List[PlanProvenance]:
        return [r for r in self._records if r.tenant == tenant]

    def swapped(self) -> List[PlanProvenance]:
        return [r for r in self._records if r.swapped]

    def find(self, tenant: Optional[str] = None,
             version: Optional[int] = None) -> List[PlanProvenance]:
        out = self._records
        if tenant is not None:
            out = [r for r in out if r.tenant == tenant]
        if version is not None:
            out = [r for r in out if r.version == version]
        return list(out)

    def to_json_obj(self) -> dict:
        return tag(PROVENANCE_LOG_KIND, {
            "records": [dataclasses.asdict(r) for r in self._records],
        })
