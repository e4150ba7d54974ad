"""Topology events — link degradation, link down, link restore.

Counterpart of ``repro/runtime/events.py``, copied as it is (numpy and the
stdlib only).

The paper's runtime is defined against a fabric that *changes*: congestion
from cross-traffic, but also NIC flaps and switch-port brownouts that no
one-shot plan can anticipate.  A :class:`LinkEvent` rescales one directed
link's capacity at a window boundary; the controller applies due events by
deriving a new :class:`~repro.core.topology.Topology` via
``with_link_scale`` — same geometry, new capacities, new fingerprint — so
the planner core rebuilds (and re-caches) incidence tables for the degraded
fabric, and the policy force-replans.

Scales: ``0.0`` = down (capacity ``topology.DOWN_CAP``), ``(0, 1)`` =
degraded, ``1.0`` = restored.  Events compose by replacement, so a restore
after a degrade returns the link to its calibrated capacity exactly.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Iterable, List, Optional, Tuple


@dataclasses.dataclass(frozen=True, order=True)
class LinkEvent:
    """Rescale link ``src -> dst`` to ``scale`` at ``window``."""

    window: int
    src: int
    dst: int
    scale: float

    @property
    def kind(self) -> str:
        if self.scale <= 0.0:
            return "link_down"
        if self.scale >= 1.0:
            return "link_restored"
        return "link_degraded"

    def describe(self) -> str:
        extra = "" if self.scale in (0.0, 1.0) else f" x{self.scale:g}"
        return f"{self.kind}[{self.src}->{self.dst}]@w{self.window}{extra}"

    def to_json_obj(self) -> dict:
        """Tagged ``nimble.link_event/v1`` record — the structured twin of
        :meth:`describe`, for trace args and provenance fault context."""
        from ..jsonio import tag

        return tag("link_event", {
            "window": int(self.window),
            "src": int(self.src),
            "dst": int(self.dst),
            "scale": float(self.scale),
            "kind": self.kind,
        })


def link_down(window: int, src: int, dst: int) -> LinkEvent:
    return LinkEvent(window, src, dst, 0.0)


def link_degraded(window: int, src: int, dst: int, scale: float) -> LinkEvent:
    if not 0.0 < scale < 1.0:
        raise ValueError(f"degraded scale must be in (0, 1), got {scale}")
    return LinkEvent(window, src, dst, scale)


def link_restored(window: int, src: int, dst: int) -> LinkEvent:
    return LinkEvent(window, src, dst, 1.0)


@dataclasses.dataclass(frozen=True)
class PricesMovedHint:
    """Fabric-pressure broadcast: the shared ledger moved materially.

    Published by the fabric arbiter on the shared
    :class:`~repro.core.topology.LinkEventBus` (next to the
    :class:`LinkEvent` batches it already carries) when a tenant commit
    shifts the total committed load by more than the arbiter's
    ``price_hint_rel`` threshold.  ``tenant`` names the committer whose
    load moved — its *own* runtime skips the hint on delivery, because a
    tenant's own commit never changes its own exported prices.  Receiving
    runtimes forward it to ``ReplanPolicy.notify_fabric_pressure``, which
    treats it as a soft staleness deadline (``PolicyConfig.
    fabric_staleness``): a demand-stable tenant still re-prices a fabric
    that shifted under it.  Hints complement the pull side of the same
    recency machinery: the arbiter's decayed prices and its swap-boundary
    ``reprice`` hook (DESIGN.md §4.3) close the issue→swap staleness
    window for plans already in flight, while the hint wakes tenants whose
    own triggers would otherwise never fire.

    ``clock`` is the fabric ledger clock (newest stamped commit window) at
    publish time — 0 when no stamped commit has landed yet (matching
    ``FabricState.clock``), ``None`` only from publishers that predate
    recency stamps; diagnostic only, receivers key off their own window
    counters.
    """

    tenant: str
    rel_change: float
    clock: Optional[int] = None


def merge_overrides(events: Iterable[LinkEvent]
                    ) -> List[Tuple[Tuple[int, int], float]]:
    """(endpoints, scale) pairs for a batch of events (last one wins).

    The single definition of the override-merge semantics, shared by
    :meth:`EventLog.overrides` (per-runtime application) and the fabric
    arbiter's broadcast path — the ledger and the runtimes must never
    disagree on how same-link events compose.
    """
    merged = {}
    for ev in events:
        merged[(ev.src, ev.dst)] = ev.scale
    return list(merged.items())


class EventLog:
    """Window-ordered queue of scheduled topology events.

    Events due in the same window pop in **schedule order** (a per-log
    sequence number breaks heap ties), so "last one wins" in
    :meth:`overrides` means the last *scheduled*, not an accident of how
    scales happen to sort.
    """

    def __init__(self, events: Iterable[LinkEvent] = ()):
        self._heap: List[tuple] = []   # (window, seq, event)
        self._seq = 0
        for ev in events:
            self.schedule(ev)

    def schedule(self, event: LinkEvent) -> None:
        heapq.heappush(self._heap, (event.window, self._seq, event))
        self._seq += 1

    def pop_due(self, window: int) -> List[LinkEvent]:
        """All events with ``event.window <= window``, in schedule order."""
        due = []
        while self._heap and self._heap[0][0] <= window:
            due.append(heapq.heappop(self._heap)[2])
        return due

    def peek_next_window(self) -> Optional[int]:
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def snapshot(self) -> List[LinkEvent]:
        """Pending events in pop order, without consuming them."""
        return [ev for _, _, ev in sorted(self._heap)]

    def copy(self) -> "EventLog":
        return EventLog(self.snapshot())

    def overrides(self, events: Iterable[LinkEvent]
                  ) -> List[Tuple[Tuple[int, int], float]]:
        """(endpoints, scale) pairs for a batch of events (last one wins)."""
        return merge_overrides(events)
