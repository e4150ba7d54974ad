"""Offset-parameterized path schedule — the TPU-native dataplane layout.

Under XLA SPMD every device executes the same program, so NIMBLE's candidate
paths are expressed as *offset decompositions* that are symmetric across
devices (DESIGN.md §2).  With devices numbered ``dev = group*G + pos`` along
the NIMBLE axis:

  hop alphabet (each hop is ONE uniform ``lax.ppermute``):
    rot(a)   : (g, p) -> (g, (p+a) % G)          intra-group rotation
    shift(m) : (g, p) -> ((g+m) % NG, p)         rail-matched group shift

  destination *relations*  rel = (m, dq), m in [0,NG), dq in [0,G), != (0,0):
    dest(s=(g,p)) = ((g+m) % NG, (p+dq) % G)

  candidate paths (paper §IV-B, normalized to 3 stages):
    intra (m=0):  k=0 direct        [rot dq,  -,        -      ]
                  k>=1 via a        [rot a,   rot dq-a, -      ]   a != dq
    inter (m>0):  k in [0,G)        [rot r,   shift m,  rot dq-r]
                  with r = (dq + k) % G; k=0 is the destination-rail (PXN)
                  path, the static-baseline default.

Every (relation, path, chunk-slot) gets a static slot in a flat state array;
a communication round is one ppermute of the slot subset whose current hop
matches that permutation.  Which *slots are filled* is decided at runtime by
the planner (flow amounts), which is how "execution-time planning" coexists
with a static SPMD program.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .cost import CostModel
from .incidence import MAX_CHARGE, PathIncidence, incidence_for, topology_fingerprint
from .topology import Topology

# hop kinds
ROT = 0
SHIFT = 1

Hop = Tuple[int, int]  # (kind, amount); None entries are identity


@dataclasses.dataclass(frozen=True)
class Relation:
    rel_id: int
    m: int   # group offset
    dq: int  # position (rail) offset


def enumerate_relations(n_groups: int, G: int) -> List[Relation]:
    rels = []
    rid = 0
    for m in range(n_groups):
        for dq in range(G):
            if m == 0 and dq == 0:
                continue
            rels.append(Relation(rid, m, dq))
            rid += 1
    return rels


def path_hops(rel: Relation, k: int, G: int) -> List[Optional[Hop]]:
    """Normalized 3-stage hop list for candidate ``k`` of ``rel``."""
    m, dq = rel.m, rel.dq
    if m == 0:
        if k == 0:
            return [(ROT, dq), None, None]
        alts = [a for a in range(1, G) if a != dq]
        a = alts[k - 1]
        return [(ROT, a), (ROT, (dq - a) % G), None]
    r = (dq + k) % G
    h0 = (ROT, r) if r else None
    h2 = (ROT, (dq - r) % G) if (dq - r) % G else None
    return [h0, (SHIFT, m), h2]


def n_candidates(rel: Relation, G: int) -> int:
    return (G - 1) if rel.m == 0 else G


def path_nodes(rel: Relation, k: int, src: int, G: int, n_groups: int) -> List[int]:
    """Concrete device sequence for source ``src`` on path (rel, k)."""
    g, p = divmod(src, G)
    nodes = [src]
    for hop in path_hops(rel, k, G):
        if hop is None:
            continue
        kind, amt = hop
        if kind == ROT:
            p = (p + amt) % G
        else:
            g = (g + amt) % n_groups
        nodes.append(g * G + p)
    return nodes


# The dense planner tables are now a view of the shared planner core
# (incidence.py): one sparse path→resource incidence per (Topology,
# CostModel), cached under the topology fingerprint.  ``PlannerTables`` is
# kept as the historical name — it IS the incidence structure.
PlannerTables = PathIncidence


def build_planner_tables(topo: Topology, cm: CostModel | None = None) -> PlannerTables:
    """Cached planner tables for ``topo`` (see ``incidence.incidence_for``)."""
    return incidence_for(topo, cm)


# ---------------------------------------------------------------------------
# slot / round layout for the dataplane
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CommSchedule:
    """Static slot layout + ppermute rounds for ``nimble_all_to_allv``.

    ``C`` chunk slots are provisioned per destination on the direct path
    (k=0) — enough for the whole demand as fallback — and
    ``ceil(C * alt_frac)`` on each alternate, trading wire padding for
    rerouting headroom (tunable; see EXPERIMENTS.md §Perf).
    """

    topo: Topology
    C: int                      # max chunks per destination
    alt_frac: float
    rels: List[Relation]
    K: int
    S: np.ndarray               # [n_rel, K] slot capacity (0 = invalid path)
    slot_rel: np.ndarray        # [n_slots]
    slot_k: np.ndarray          # [n_slots]
    slot_pos: np.ndarray        # [n_slots] position within (rel, k)
    rounds: List[List[Tuple[Hop, np.ndarray]]]  # 3 rounds of (hop, slot ids)

    @property
    def n_slots(self) -> int:
        return len(self.slot_rel)

    def perm_pairs(self, hop: Hop) -> List[Tuple[int, int]]:
        """Device permutation for a hop, as (src, dst) pairs for ppermute."""
        kind, amt = hop
        G, NG = self.topo.group_size, self.topo.n_groups
        pairs = []
        for dev in range(self.topo.n_devices):
            g, p = divmod(dev, G)
            if kind == ROT:
                dst = g * G + (p + amt) % G
            else:
                dst = ((g + amt) % NG) * G + p
            pairs.append((dev, dst))
        return pairs


_SCHED_CACHE: "collections.OrderedDict[tuple, CommSchedule]" = (
    collections.OrderedDict()
)
#: LRU bound — link events mint fresh fingerprints (see incidence._CACHE_CAP)
_SCHED_CACHE_CAP = 64


def build_schedule(
    topo: Topology, C: int, alt_frac: float = 0.5
) -> CommSchedule:
    """Build (or fetch the cached) slot layout for ``(topo, C, alt_frac)``.

    Cached under the topology fingerprint: every MoE layer / tenant with the
    same geometry shares one schedule, so repeated dataplane construction
    stops re-enumerating slots and rounds.  Treat the result as immutable.
    """
    key = (topology_fingerprint(topo), int(C), float(alt_frac))
    hit = _SCHED_CACHE.get(key)
    if hit is not None:
        _SCHED_CACHE.move_to_end(key)
        return hit
    sched = _build_schedule(topo, C, alt_frac)
    _SCHED_CACHE[key] = sched
    while len(_SCHED_CACHE) > _SCHED_CACHE_CAP:
        _SCHED_CACHE.popitem(last=False)
    return sched


def _build_schedule(
    topo: Topology, C: int, alt_frac: float = 0.5
) -> CommSchedule:
    G, NG = topo.group_size, topo.n_groups
    rels = enumerate_relations(NG, G)
    K = max(n_candidates(r, G) for r in rels)

    S = np.zeros((len(rels), K), dtype=np.int64)
    alt_slots = int(np.ceil(C * alt_frac))
    for rel in rels:
        for k in range(n_candidates(rel, G)):
            S[rel.rel_id, k] = C if k == 0 else alt_slots

    slot_rel, slot_k, slot_pos = [], [], []
    for rel in rels:
        for k in range(K):
            for j in range(int(S[rel.rel_id, k])):
                slot_rel.append(rel.rel_id)
                slot_k.append(k)
                slot_pos.append(j)
    slot_rel = np.array(slot_rel, dtype=np.int64)
    slot_k = np.array(slot_k, dtype=np.int64)
    slot_pos = np.array(slot_pos, dtype=np.int64)

    # group slots by their hop at each of the 3 normalized stages
    rounds: List[List[Tuple[Hop, np.ndarray]]] = []
    for t in range(3):
        by_hop: Dict[Hop, List[int]] = {}
        for sid in range(len(slot_rel)):
            rel = rels[slot_rel[sid]]
            hop = path_hops(rel, int(slot_k[sid]), G)[t]
            if hop is not None:
                by_hop.setdefault(hop, []).append(sid)
        rounds.append(
            [(hop, np.array(ids, dtype=np.int64)) for hop, ids in sorted(by_hop.items())]
        )
    return CommSchedule(
        topo=topo,
        C=C,
        alt_frac=alt_frac,
        rels=rels,
        K=K,
        S=S,
        slot_rel=slot_rel,
        slot_k=slot_k,
        slot_pos=slot_pos,
        rounds=rounds,
    )
