"""Candidate path enumeration (paper §IV-B).

NIMBLE restricts the MCF search space to three path families, matching the
paper exactly:

  * intra-node **direct**:    ``s -> d``                       (1 hop)
  * intra-node **2-hop**:     ``s -> i -> d``  (i in same node) (2 hops)
  * inter-node **rail-matched**: ``s -> rail_r(node_s) -> rail_r(node_d) -> d``
    where the middle hop is the rail link and the first/last hops are elided
    when ``s``/``d`` already sit on rail ``r``            (1..3 hops)

Deeper multi-hop is deliberately excluded (§V-B "Deeper multi-hop paths":
negative returns beyond one intra-node hop).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Tuple

from .topology import Topology

# path families
DIRECT = 0
TWO_HOP = 1
RAIL_MATCHED = 2


@dataclasses.dataclass(frozen=True)
class Path:
    """A candidate route: ordered link ids from source to destination."""

    links: Tuple[int, ...]
    nodes: Tuple[int, ...]  # device sequence, len(links)+1
    family: int

    @property
    def n_hops(self) -> int:
        return len(self.links)

    @property
    def n_relays(self) -> int:
        """Intermediate devices that only forward (paper's relay GPUs)."""
        return max(0, len(self.nodes) - 2)


def enumerate_paths(topo: Topology, s: int, d: int) -> List[Path]:
    """All candidate paths for ordered pair (s, d), direct-first."""
    if s == d:
        return []
    G = topo.group_size
    out: List[Path] = []
    if topo.same_group(s, d):
        # direct NVLink-analogue
        out.append(Path((topo.link_id(s, d),), (s, d), DIRECT))
        # one intermediate hop via every other chip in the group
        base = topo.group_of(s) * G
        for i in range(base, base + G):
            if i in (s, d):
                continue
            out.append(
                Path((topo.link_id(s, i), topo.link_id(i, d)), (s, i, d), TWO_HOP)
            )
    else:
        # rail-matched only (paper: PXN-style, avoids switch-level mismatch)
        gs, gd = topo.group_of(s), topo.group_of(d)
        for r in range(G):
            rs = gs * G + r
            rd = gd * G + r
            links: List[int] = []
            nodes: List[int] = [s]
            if rs != s:
                links.append(topo.link_id(s, rs))
                nodes.append(rs)
            links.append(topo.link_id(rs, rd))
            nodes.append(rd)
            if rd != d:
                links.append(topo.link_id(rd, d))
                nodes.append(d)
            out.append(Path(tuple(links), tuple(nodes), RAIL_MATCHED))
        # put the fully rail-matched route (no relay at either end) first so
        # that "direct" indexing (k=0) means the least-hop path, as in NCCL.
        out.sort(key=lambda p: (p.n_hops, p.nodes))
    return out


_PATHS_CACHE: "collections.OrderedDict[tuple, Dict[Tuple[int, int], List[Path]]]" = (
    collections.OrderedDict()
)
#: LRU bound — link events mint fresh fingerprints (see incidence._CACHE_CAP)
_PATHS_CACHE_CAP = 64


def all_pairs_paths(topo: Topology) -> Dict[Tuple[int, int], List[Path]]:
    """Candidate path table for every ordered device pair.

    Memoized under the topology fingerprint (two topologies with equal
    fingerprints have identical link ids) — callers must treat the returned
    table as read-only.
    """
    hit = _PATHS_CACHE.get(topo.fingerprint)
    if hit is not None:
        _PATHS_CACHE.move_to_end(topo.fingerprint)
        return hit
    table: Dict[Tuple[int, int], List[Path]] = {}
    for s in range(topo.n_devices):
        for d in range(topo.n_devices):
            if s != d:
                table[(s, d)] = enumerate_paths(topo, s, d)
    _PATHS_CACHE[topo.fingerprint] = table
    while len(_PATHS_CACHE) > _PATHS_CACHE_CAP:
        _PATHS_CACHE.popitem(last=False)
    return table


def max_candidates(topo: Topology) -> int:
    """Upper bound on candidate paths per pair (used for dense padding)."""
    # intra: 1 direct + (G-2) two-hop ; inter: G rail paths
    return max(topo.group_size - 1, topo.group_size)
