"""Sparse path→resource incidence — the shared planner core (DESIGN.md §2).

Both Algorithm-1 implementations (the faithful host solver ``mcf.solve_mwu``
and the jitted vectorized MWU ``planner.plan_flows``) price candidate paths
against the same resource vector ``[links (E), relay (n), inject (n)]``.
This module precomputes that path→resource mapping ONCE per
``(Topology, CostModel)`` as a :class:`PathIncidence`:

  * **CSR form** (``indptr`` / ``indices`` / ``multipliers``): exact sparse
    incidence over the E + 2n real resources, for host-side numpy sweeps and
    analysis tooling;
  * **dense padded form** (``path_rids`` / ``path_mult``, shape
    ``[P, MAX_CHARGE]``): fixed-width rows padded with a trailing dummy
    resource of infinite capacity, for gather-based jit kernels;
  * per-path metadata: relay flag (size-threshold gating), fill/flush
    penalty seconds, bottleneck capacity, and the concrete
    :class:`~repro_torch.core.paths.Path` object so host plans keep reporting
    real routes;
  * the pair→candidate table ``pair_path_ids [n*n, K]`` in the
    offset-relation order of ``schedule.py`` (k=0 = least-hop / PXN).

Instances are cached under a **topology fingerprint key** (geometry + link
capacities + every cost-model knob), so repeated planner/dataplane
construction — one per MoE layer, per tenant, per benchmark section —
reuses one set of tables.  Cached arrays are frozen (``writeable=False``);
treat them as immutable.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np

from .cost import CostModel
from .paths import DIRECT, Path, RAIL_MATCHED, TWO_HOP
from .topology import INTRA, Topology

#: fixed dense row width: 3 links + src inject + 2 relays + 2 relay injects
MAX_CHARGE = 8

#: max links per candidate path (3-stage normalized schedule)
MAX_HOPS = 3


@dataclasses.dataclass(frozen=True)
class PairCandidates:
    """Per-pair candidate incidence rows, gathered once per table build.

    Shapes are ``[n*n, K, MAX_CHARGE]`` (``rids`` / ``mult`` / ``mask``) and
    ``[n*n, K]`` (the rest); K-padding entries have ``valid=False``.  Both
    the host sweep solver and the jitted planner index these directly, so
    no gather/scatter bookkeeping is rebuilt inside their iteration loops.
    """

    valid: np.ndarray     # [n*n, K] bool
    rids: np.ndarray      # [n*n, K, MAX_CHARGE] int32 (dummy-padded)
    mult: np.ndarray      # [n*n, K, MAX_CHARGE] float32 (0-padded)
    mask: np.ndarray      # [n*n, K, MAX_CHARGE] bool (mult > 0)
    penalty: np.ndarray   # [n*n, K] float32
    relay: np.ndarray     # [n*n, K] bool
    min_cap: np.ndarray   # [n*n, K] float64 — path bottleneck capacity


@dataclasses.dataclass(frozen=True)
class PathIncidence:
    """Precomputed path→resource incidence for one (Topology, CostModel).

    Resource ids follow ``cost.ResourceModel``: ``[links (E), relay (n),
    inject (n)]``; the dense form appends one dummy resource (id
    ``n_resources - 1``, capacity 1e30) used only as row padding.
    """

    n: int                      # devices
    K: int                      # max candidate paths per pair
    n_links: int                # E
    n_resources: int            # E + 2n + 1 (incl. trailing dummy)
    caps: np.ndarray            # [n_resources] float64
    # dense padded form (jit gathers):
    path_rids: np.ndarray       # [P, MAX_CHARGE] int32, dummy-padded
    path_mult: np.ndarray       # [P, MAX_CHARGE] float32, 0-padded
    path_penalty: np.ndarray    # [P] float32 — fill/flush seconds
    path_relay: np.ndarray      # [P] bool — has relay GPUs (threshold gate)
    path_min_cap: np.ndarray    # [P] float64 — bottleneck capacity
    path_links: np.ndarray      # [P, MAX_HOPS] int32 link ids, -1-padded
    path_n_hops: np.ndarray     # [P] int32 — len(links)
    path_link_min_cap: np.ndarray  # [P] float64 — min over *link* caps only
    pair_path_ids: np.ndarray   # [n*n, K] int32, -1 invalid/self
    # CSR form over real resources (host sweeps):
    indptr: np.ndarray          # [P + 1] int32
    indices: np.ndarray         # [nnz] int32 (all < n_resources - 1)
    multipliers: np.ndarray     # [nnz] float64
    # concrete routes, one per path id (None on K-padding rows):
    paths: Tuple[Optional[Path], ...]

    @property
    def n_paths(self) -> int:
        return len(self.path_penalty)

    @property
    def dummy_rid(self) -> int:
        return self.n_resources - 1

    @functools.cached_property
    def pair_candidates(self) -> PairCandidates:
        """Candidate rows regrouped by ordered pair (cached on the tables)."""
        c = np.where(self.pair_path_ids >= 0, self.pair_path_ids, 0)
        mult = self.path_mult[c]
        return PairCandidates(
            valid=_freeze(self.pair_path_ids >= 0),
            rids=_freeze(self.path_rids[c]),
            mult=_freeze(mult),
            mask=_freeze(mult > 0),
            penalty=_freeze(self.path_penalty[c]),
            relay=_freeze(self.path_relay[c]),
            min_cap=_freeze(self.path_min_cap[c]),
        )

    @functools.cached_property
    def path_index(self) -> Dict[Path, int]:
        """Concrete :class:`Path` -> path id, for host-plan lookups.

        Host plans (``mcf``) and the incidence enumerate identical routes,
        so flows can be mapped back to their precomputed per-path metadata
        (``fabsim``'s vectorized pipeline-fill) without re-walking links.
        """
        return {p: i for i, p in enumerate(self.paths) if p is not None}

    def charges_of(self, pid: int) -> List[Tuple[int, float]]:
        """CSR row of path ``pid`` as (resource_id, multiplier) pairs."""
        lo, hi = int(self.indptr[pid]), int(self.indptr[pid + 1])
        return [
            (int(r), float(m))
            for r, m in zip(self.indices[lo:hi], self.multipliers[lo:hi])
        ]


def topology_fingerprint(topo: Topology) -> tuple:
    """Hashable key that fully determines the link graph of ``topo``."""
    return topo.fingerprint


def cost_model_key(cm: CostModel) -> tuple:
    """Hashable key over every CostModel knob that shapes the tables."""
    return dataclasses.astuple(cm)


def _freeze(a: np.ndarray) -> np.ndarray:
    a.setflags(write=False)
    return a


def _build(topo: Topology, cm: CostModel) -> PathIncidence:
    # Import here: schedule.py re-exports our tables, so a module-level
    # import would be circular.
    from .schedule import enumerate_relations, n_candidates, path_nodes

    n, G, NG = topo.n_devices, topo.group_size, topo.n_groups
    rels = enumerate_relations(NG, G)
    K = max(n_candidates(r, G) for r in rels)
    E = topo.n_links
    n_res = E + 2 * n + 1
    dummy = n_res - 1
    caps = np.empty(n_res)
    caps[:E] = topo.capacity
    caps[E : E + n] = cm.relay_cap
    caps[E + n : E + 2 * n] = cm.inject_cap
    caps[dummy] = 1e30

    P = n * len(rels) * K
    rids = np.full((P, MAX_CHARGE), dummy, dtype=np.int32)
    mult = np.zeros((P, MAX_CHARGE), dtype=np.float32)
    pen = np.zeros(P, dtype=np.float32)
    relay = np.zeros(P, dtype=bool)
    min_caps = np.full(P, np.inf)
    plinks = np.full((P, MAX_HOPS), -1, dtype=np.int32)
    pn_hops = np.zeros(P, dtype=np.int32)
    plink_min = np.full(P, np.inf)
    pair_paths = np.full((n * n, K), -1, dtype=np.int32)
    indptr = np.zeros(P + 1, dtype=np.int32)
    idx_flat: List[int] = []
    mult_flat: List[float] = []
    path_objs: List[Optional[Path]] = []

    pid = 0
    for s in range(n):
        for rel in rels:
            for k in range(K):
                if k < n_candidates(rel, G):
                    nodes = path_nodes(rel, k, s, G, NG)
                    d = nodes[-1]
                    links = [topo.link_id(a, b) for a, b in zip(nodes, nodes[1:])]
                    relayed = len(nodes) > 2
                    c = 0
                    min_cap = np.inf
                    for l in links:
                        m = (
                            1.0 / cm.rail_relay_eff
                            if relayed and topo.kind[l] != INTRA
                            else 1.0
                        )
                        rids[pid, c], mult[pid, c] = l, m
                        min_cap = min(min_cap, topo.capacity[l])
                        c += 1
                    rids[pid, c], mult[pid, c] = E + n + s, 1.0  # src inject
                    c += 1
                    for mid in nodes[1:-1]:
                        rids[pid, c], mult[pid, c] = E + mid, 1.0       # relay
                        rids[pid, c + 1], mult[pid, c + 1] = E + n + mid, 1.0
                        c += 2
                        min_cap = min(min_cap, cm.relay_cap)
                    if relayed:
                        pen[pid] = cm.hop_setup_bytes * (len(nodes) - 2) / min_cap
                        relay[pid] = True
                    min_caps[pid] = min_cap
                    plinks[pid, : len(links)] = links
                    pn_hops[pid] = len(links)
                    plink_min[pid] = topo.capacity[links].min()
                    pair_paths[s * n + d, k] = pid
                    idx_flat.extend(int(r) for r in rids[pid, :c])
                    mult_flat.extend(float(m) for m in mult[pid, :c])
                    if rel.m == 0:
                        family = DIRECT if k == 0 else TWO_HOP
                    else:
                        family = RAIL_MATCHED
                    path_objs.append(Path(tuple(links), tuple(nodes), family))
                else:
                    path_objs.append(None)
                indptr[pid + 1] = len(idx_flat)
                pid += 1

    return PathIncidence(
        n=n,
        K=K,
        n_links=E,
        n_resources=n_res,
        caps=_freeze(caps),
        path_rids=_freeze(rids),
        path_mult=_freeze(mult),
        path_penalty=_freeze(pen),
        path_relay=_freeze(relay),
        path_min_cap=_freeze(min_caps),
        path_links=_freeze(plinks),
        path_n_hops=_freeze(pn_hops),
        path_link_min_cap=_freeze(plink_min),
        pair_path_ids=_freeze(pair_paths),
        indptr=_freeze(indptr),
        indices=_freeze(np.asarray(idx_flat, dtype=np.int32)),
        multipliers=_freeze(np.asarray(mult_flat, dtype=np.float64)),
        paths=tuple(path_objs),
    )


# -- topology-keyed cache ------------------------------------------------------

_CACHE: "collections.OrderedDict[tuple, PathIncidence]" = (
    collections.OrderedDict()
)
#: LRU bound: topology events (link down/degrade) mint a fresh fingerprint
#: per distinct scale map, so the cache must evict or a long fault-injection
#: run would leak one O(n² K) table set per fault state
_CACHE_CAP = 64
_HITS = 0
_MISSES = 0


def incidence_for(topo: Topology, cm: CostModel | None = None) -> PathIncidence:
    """Cached :class:`PathIncidence` for ``(topo, cm)``.

    Two topologies with the same :func:`topology_fingerprint` share one
    instance, so per-layer / per-tenant planner construction stops paying
    the O(n² K) table build.
    """
    global _HITS, _MISSES
    cm = cm or CostModel()
    key = (topology_fingerprint(topo), cost_model_key(cm))
    hit = _CACHE.get(key)
    if hit is not None:
        _HITS += 1
        _CACHE.move_to_end(key)
        return hit
    _MISSES += 1
    inc = _build(topo, cm)
    _CACHE[key] = inc
    while len(_CACHE) > _CACHE_CAP:
        _CACHE.popitem(last=False)
    return inc


def cache_info() -> Dict[str, int]:
    return {"size": len(_CACHE), "hits": _HITS, "misses": _MISSES}


def cache_clear() -> None:
    global _HITS, _MISSES
    _CACHE.clear()
    _HITS = 0
    _MISSES = 0
