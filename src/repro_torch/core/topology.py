"""Hierarchical interconnect topology for NIMBLE.

Models the paper's target fabric (Fig. 4) adapted to a TPU pod:

  * ``n_groups`` *node groups* of ``group_size`` chips each sit along the
    NIMBLE orchestration axis (the "model" mesh axis).  A group plays the
    role of the paper's 4-GPU node: chips inside a group are all-to-all
    connected by *intra* links (NVLink analogue / intra-group ICI).
  * Chip ``i`` of every group owns *rail* ``i`` (the paper's NIC-GPU
    affinity).  Rail-matched *inter* links connect chip ``i`` of group ``A``
    to chip ``i`` of group ``B`` (NDR rail analogue / inter-group ICI).
  * Groups may span *pods*; links that cross a pod boundary use the (lower)
    DCI capacity.

All links are directed.  Capacities are bytes/second; the defaults are the
paper's H100 node numbers so the fabric simulator reproduces Fig. 6 scales,
and can be swapped for TPU v5e ICI constants via :class:`LinkCaps`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np

# Link kinds -----------------------------------------------------------------
INTRA = 0  # chip->chip inside a node group (NVLink / intra-group ICI)
RAIL = 1   # rail-matched chip_i(groupA) -> chip_i(groupB), same pod
DCI = 2    # rail-matched, crossing a pod boundary

#: capacity (bytes/s) assigned to a *down* link (scale <= 0).  Non-zero so
#: load/capacity cost and drain-time math never divide by zero; any traffic
#: actually routed onto a down link shows up as a catastrophic completion
#: time, which is what the orchestration runtime's replan loop reacts to.
DOWN_CAP = 1e-3


@dataclasses.dataclass(frozen=True)
class LinkCaps:
    """Per-kind link capacity in bytes/s.

    Defaults follow the paper's testbed: NVLink4 P2P ~120 GB/s peak per
    direct GPU pair (Fig. 6a) and one NDR400 rail ~45.1 GB/s measured
    (Fig. 6d).  ``dci`` models a cross-pod link at a fraction of rail
    bandwidth (TPU DCI is ~an order of magnitude below ICI).
    """

    intra: float = 120e9
    rail: float = 45.1e9
    dci: float = 11.3e9

    def of(self, kind: int) -> float:
        return (self.intra, self.rail, self.dci)[kind]


@dataclasses.dataclass(frozen=True)
class Link:
    lid: int
    src: int
    dst: int
    kind: int
    capacity: float


class Topology:
    """Directed link graph over ``n_devices`` chips along the NIMBLE axis."""

    def __init__(
        self,
        n_devices: int,
        group_size: int = 4,
        n_pods: int = 1,
        caps: LinkCaps | None = None,
        link_scale: Mapping[Tuple[int, int], float] | None = None,
    ):
        if n_devices % group_size != 0:
            raise ValueError(
                f"n_devices={n_devices} not divisible by group_size={group_size}"
            )
        n_groups = n_devices // group_size
        if n_groups % n_pods != 0:
            raise ValueError(
                f"n_groups={n_groups} not divisible by n_pods={n_pods}"
            )
        self.n_devices = n_devices
        self.group_size = group_size
        self.n_groups = n_groups
        self.n_pods = n_pods
        self.groups_per_pod = n_groups // n_pods
        self.caps = caps or LinkCaps()
        # per-link capacity scale (fault / degradation events): (src, dst) ->
        # scale in [0, 1]; scale <= 0 means *down* (capacity DOWN_CAP).
        # Entries equal to 1.0 are dropped so the fingerprint stays canonical.
        self.link_scale: Dict[Tuple[int, int], float] = {
            (int(s), int(d)): float(sc)
            for (s, d), sc in (link_scale or {}).items()
            if float(sc) != 1.0
        }

        self.links: List[Link] = []
        self._by_endpoints: Dict[Tuple[int, int], int] = {}
        self._build()
        for s, d in self.link_scale:
            if (s, d) not in self._by_endpoints:
                raise KeyError(f"link_scale names nonexistent link {s}->{d}")

        self.capacity = np.array([l.capacity for l in self.links], dtype=np.float64)
        self.kind = np.array([l.kind for l in self.links], dtype=np.int32)

    # -- construction ---------------------------------------------------------
    def _add(self, src: int, dst: int, kind: int) -> int:
        lid = len(self.links)
        cap = self.caps.of(kind)
        scale = self.link_scale.get((src, dst), 1.0)
        cap = cap * scale if scale > 0.0 else DOWN_CAP
        self.links.append(Link(lid, src, dst, kind, cap))
        self._by_endpoints[(src, dst)] = lid
        return lid

    def _build(self) -> None:
        G = self.group_size
        # intra-group all-to-all (the paper's per-node NVLink mesh)
        for g in range(self.n_groups):
            base = g * G
            for a in range(G):
                for b in range(G):
                    if a != b:
                        self._add(base + a, base + b, INTRA)
        # rail-matched inter-group links (the paper's NIC rails)
        for ga in range(self.n_groups):
            for gb in range(self.n_groups):
                if ga == gb:
                    continue
                kind = RAIL if self.pod_of_group(ga) == self.pod_of_group(gb) else DCI
                for r in range(G):
                    self._add(ga * G + r, gb * G + r, kind)

    # -- identity -------------------------------------------------------------
    @property
    def fingerprint(self) -> Tuple:
        """Hashable key that fully determines the link graph.

        ``_build`` is deterministic in these parameters, so two topologies
        with equal fingerprints have identical link ids, kinds, and
        capacities — the caching key for planner tables (DESIGN.md §2).
        """
        return (
            self.n_devices,
            self.group_size,
            self.n_pods,
            float(self.caps.intra),
            float(self.caps.rail),
            float(self.caps.dci),
            tuple(sorted(self.link_scale.items())),
        )

    # -- fault / degradation events -------------------------------------------
    def with_link_scale(
        self, overrides: Mapping[Tuple[int, int], float]
    ) -> "Topology":
        """New :class:`Topology` with per-link capacity scales replaced.

        ``overrides`` maps ``(src, dst)`` endpoints to a new scale: ``0``
        marks the link *down* (capacity :data:`DOWN_CAP`), values in (0, 1)
        model degradation, and ``1.0`` restores the link.  Scales compose by
        replacement, not multiplication, so restoring is idempotent.  The
        link *geometry* (ids, kinds) is unchanged — only capacities move —
        which keeps candidate-path enumeration and slot schedules valid
        while forcing fresh incidence tables via the fingerprint.
        """
        merged = dict(self.link_scale)
        for (s, d), sc in overrides.items():
            if (s, d) not in self._by_endpoints:
                raise KeyError(f"no link {s}->{d} in topology")
            merged[(int(s), int(d))] = float(sc)
        return Topology(
            self.n_devices, self.group_size, self.n_pods, self.caps, merged
        )

    def down_link_ids(self) -> List[int]:
        """Link ids currently marked down (capacity == DOWN_CAP)."""
        return [l.lid for l in self.links if l.capacity <= DOWN_CAP]

    # -- lookups --------------------------------------------------------------
    def pod_of_group(self, g: int) -> int:
        return g // self.groups_per_pod

    def group_of(self, dev: int) -> int:
        return dev // self.group_size

    def rail_of(self, dev: int) -> int:
        """Rail index = position inside the group (paper: NIC ordinal)."""
        return dev % self.group_size

    def same_group(self, a: int, b: int) -> bool:
        return self.group_of(a) == self.group_of(b)

    def link_id(self, src: int, dst: int) -> int:
        try:
            return self._by_endpoints[(src, dst)]
        except KeyError:
            raise KeyError(f"no direct link {src}->{dst} in topology") from None

    def has_link(self, src: int, dst: int) -> bool:
        return (src, dst) in self._by_endpoints

    @property
    def n_links(self) -> int:
        return len(self.links)

    # -- convenience ----------------------------------------------------------
    def describe(self) -> str:
        kinds = {INTRA: "intra", RAIL: "rail", DCI: "dci"}
        counts: Dict[str, int] = {}
        for l in self.links:
            counts[kinds[l.kind]] = counts.get(kinds[l.kind], 0) + 1
        return (
            f"Topology(devices={self.n_devices}, groups={self.n_groups}x"
            f"{self.group_size}, pods={self.n_pods}, links={counts})"
        )


class LinkEventBus:
    """Synchronous fan-out of link events to every registered listener.

    One physical fabric is shared by N tenants, but each tenant runtime
    keeps its *own* :class:`~repro_torch.runtime.events.EventLog` and derives its
    own degraded :class:`Topology`.  Without a shared bus, a NIC flap
    delivered to one tenant leaves every other tenant planning against a
    stale fingerprint.  The bus closes that gap: a publisher (typically the
    fabric arbiter) calls :meth:`publish` once and every subscriber — each
    tenant's event-scheduling callback — receives the same event batch, so
    all tenants rebuild their fingerprint-keyed planner tables for the same
    fabric state.

    Delivery is synchronous and in subscription order; callbacks must not
    publish re-entrantly.  The payload is opaque to the bus (a sequence of
    :class:`~repro_torch.runtime.events.LinkEvent` by convention).
    """

    def __init__(self):
        self._subs: Dict[int, Callable[[Sequence], None]] = {}
        self._next_token = 0

    def subscribe(self, callback: Callable[[Sequence], None]) -> int:
        """Register ``callback(events)``; returns an unsubscribe token."""
        token = self._next_token
        self._next_token += 1
        self._subs[token] = callback
        return token

    def unsubscribe(self, token: int) -> None:
        self._subs.pop(token, None)

    def publish(self, events: Sequence) -> int:
        """Deliver ``events`` to every subscriber; returns listener count."""
        events = list(events)
        for callback in list(self._subs.values()):
            callback(events)
        return len(self._subs)

    def __len__(self) -> int:
        return len(self._subs)
