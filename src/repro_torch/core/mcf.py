"""Algorithm 1 — Link Load Balancing with Iterative Approximation.

Counterpart of ``repro/core/mcf.py``, numpy only and equal to it bit for
bit: the host-side implementation of the paper's multiplicative-weights /
Garg–Könemann-inspired min-congestion MCF approximation:

  * iterate over communication pairs with remaining demand;
  * for each, evaluate the candidate paths (direct / intra 2-hop /
    rail-matched) under the **bottleneck** path-cost metric;
  * route a λ fraction of the remaining demand (quantized to the chunk
    granularity ε) on the cheapest path;
  * bump the cost of every resource used (``c = F(L)``) and repeat until
    all demand is routed.

Two refresh disciplines are provided (DESIGN.md §2.3):

  * ``refresh="sweep"`` (default) — one **vectorized** pass over all live
    pairs per iteration against the cached path→resource incidence
    (``incidence.py``), with a single cost refresh per sweep.  This is the
    execution-time-budget implementation (Table I) and matches the parallel
    dynamics of the tensor planner (``planner.plan_flows``).
  * ``refresh="sequential"`` — the faithful paper loop that refreshes costs
    after *every* assignment; kept for fidelity cross-checks.

The exact IP (eqs. 1–5) is NP-hard; both loops converge geometrically since
each pair keeps ``(1-λ)^n`` of its demand after ``n`` visits (paper §IV-B).

Baselines implemented alongside (paper §II-B):
  * :func:`solve_direct` — NCCL-like static fastest path **with PXN**
    semantics: inter-node traffic is staged intra-node onto the chip owning
    the *destination's* rail, then crosses that single rail.  This is what
    funnels skewed traffic onto one NIC and produces the paper's up-to-5.2x
    headroom (Fig. 7).
  * :func:`solve_static_striping` — UCX-style load-oblivious even multirail
    striping.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Tuple

import numpy as np

from .cost import CostModel, ResourceModel
from .incidence import incidence_for
from .paths import DIRECT, Path, all_pairs_paths
from .topology import INTRA, Topology

PairKey = Tuple[int, int]

#: cost refreshes per sweep in the vectorized host solver — bounds parallel
#: MWU herding on near-balanced traffic while staying fully vectorized
_SUBSWEEPS = 8

#: host-solver price tiers, mirroring the tensor planner's (planner.py):
#: a relay candidate gated by the small-message threshold is priced at
#: ``_BIG`` and a candidate crossing a *down* link at ``_BIG_DOWN`` —
#: finite, so argmin degrades in tier order (healthy > gated-relay > dead
#: path) instead of funneling early zero-cost assignments onto a dead link;
#: structurally invalid candidates stay at +inf.  On a fabric with no down
#: links a finite healthy candidate always exists (the direct path), so
#: these tiers never change the argmin — plans stay bit-identical.
_HOST_BIG = 1e30
_HOST_BIG_DOWN = 1e32


@dataclasses.dataclass
class RoutedFlow:
    path: Path
    bytes: float


@dataclasses.dataclass
class Plan:
    """Output of the planner: per-pair path flows + resource accounting."""

    topo: Topology
    rm: ResourceModel
    flows: Dict[PairKey, List[RoutedFlow]]
    resource_bytes: np.ndarray   # effective bytes per resource
    link_bytes: np.ndarray       # raw payload bytes per link (first E entries)
    iterations: int
    # degraded-mode provenance (DESIGN.md §9): True when this plan came
    # from the survivor-striping fallback instead of a converged MWU solve
    degraded: bool = False

    # -- aggregate metrics ------------------------------------------------------
    def max_normalized_load(self) -> float:
        """The IP objective Z, capacity-normalized (seconds to drain)."""
        return float(np.max(self.resource_bytes / self.rm.capacity))

    def per_pair_bytes(self) -> Dict[PairKey, float]:
        return {k: sum(f.bytes for f in fl) for k, fl in self.flows.items()}

    def n_paths_used(self, pair: PairKey) -> int:
        return len({f.path for f in self.flows.get(pair, []) if f.bytes > 0})

    def consolidated(self) -> Dict[PairKey, List[RoutedFlow]]:
        """Merge repeated routings of the same path into one flow entry."""
        out: Dict[PairKey, List[RoutedFlow]] = {}
        for key, fl in self.flows.items():
            agg: Dict[Path, float] = {}
            for f in fl:
                agg[f.path] = agg.get(f.path, 0.0) + f.bytes
            out[key] = [RoutedFlow(p, b) for p, b in agg.items() if b > 0]
        return out


def _route(plan_loads, raw, rm, path, f):
    for rid, eff in rm.charges(path, f):
        plan_loads[rid] += eff
        if rid < rm.n_links:
            raw[rid] += f


def solve_mwu(
    topo: Topology,
    demands: Mapping[PairKey, float],
    cost_model: CostModel | None = None,
    *,
    lam: float = 0.25,
    eps: float = 1 << 20,
    prev_loads: np.ndarray | None = None,
    ext_loads: np.ndarray | None = None,
    max_iters: int = 10_000,
    refresh: str = "sweep",
) -> Plan:
    """Run Algorithm 1 over ``demands`` (bytes per ordered pair).

    ``refresh`` selects the cost-refresh discipline: ``"sweep"`` (default)
    is the vectorized incidence-matrix solver with one refresh per sweep
    over all live pairs; ``"sequential"`` is the legacy per-assignment
    refresh kept for fidelity cross-checks.

    ``prev_loads`` and ``ext_loads`` both raise resource prices before the
    first assignment, but with different contracts:

      * ``prev_loads`` is *this* job's previous loads — folded through the
        EMA (``CostModel.hysteresis``) and carried into the returned plan's
        ``resource_bytes`` (oscillation damping across replans);
      * ``ext_loads`` is *other tenants'* committed load (effective bytes
        per resource, e.g. a fabric arbiter's exported prices) —
        priced as-is, never EMA-smoothed, and **excluded** from the
        returned plan's accounting, so ``resource_bytes`` stays this
        tenant's own traffic.  ``ext_loads=None`` and all-zero
        ``ext_loads`` produce bit-identical plans.
    """
    if refresh == "sweep":
        return _solve_mwu_sweep(
            topo, demands, cost_model, lam=lam, eps=eps,
            prev_loads=prev_loads, ext_loads=ext_loads, max_iters=max_iters,
        )
    if refresh == "sequential":
        return _solve_mwu_sequential(
            topo, demands, cost_model, lam=lam, eps=eps,
            prev_loads=prev_loads, ext_loads=ext_loads, max_iters=max_iters,
        )
    raise ValueError(f"unknown refresh discipline {refresh!r}")


def _quantized_fraction(r: np.ndarray, lam: float, eps: float) -> np.ndarray:
    """Algorithm 1 lines 24-28: quantized λ-fraction of the residual."""
    f = np.where(r < eps, r, np.floor(r * lam / eps) * eps)
    return np.where((r >= eps) & (f <= 0), np.minimum(eps, r), f)


def _solve_mwu_sweep(
    topo: Topology,
    demands: Mapping[PairKey, float],
    cost_model: CostModel | None = None,
    *,
    lam: float = 0.25,
    eps: float = 1 << 20,
    prev_loads: np.ndarray | None = None,
    ext_loads: np.ndarray | None = None,
    max_iters: int = 10_000,
) -> Plan:
    """Vectorized Algorithm 1: batch path-cost evaluation per sweep.

    Live pairs are priced in a few interleaved sub-batches per sweep
    (``_SUBSWEEPS`` cost refreshes per sweep instead of one per
    assignment); each pair routes a quantized λ-fraction on its cheapest
    candidate, all in a handful of numpy ops over the cached incidence
    tables.  The sub-batching bounds the herding error of fully parallel
    MWU on near-balanced traffic (DESIGN.md §2.3) at negligible cost.
    """
    rm = ResourceModel(topo, cost_model)
    cm = rm.cm
    inc = incidence_for(topo, cm)
    n, E = topo.n_devices, topo.n_links

    keys: List[PairKey] = [
        (int(s), int(d)) for (s, d), v in demands.items()
        if v > 0 and s != d
    ]
    total = float(sum(float(demands[k]) for k in keys))
    # loads carry the trailing dummy slot so padded gathers stay in-bounds
    loads = np.zeros(inc.n_resources, dtype=np.float64)
    if prev_loads is not None:
        loads[:-1] = rm.smooth_loads(prev_loads, loads[:-1])
    # external (other-tenant) committed load: priced, never accounted.
    # Adding an all-zero vector is IEEE-exact, so ext_loads=None and zeros
    # yield bit-identical plans (the arbiter's zero-overhead contract).
    ext = np.zeros(inc.n_resources, dtype=np.float64)
    if ext_loads is not None:
        ext[:-1] = np.asarray(ext_loads, dtype=np.float64)
        if (ext < 0).any():
            raise ValueError("ext_loads must be non-negative")
    raw = np.zeros(E, dtype=np.float64)
    flows: Dict[PairKey, List[RoutedFlow]] = {k: [] for k in keys}
    if not keys:
        return Plan(topo, rm, flows, loads[:-1], raw, 0)

    res = np.array([float(demands[k]) for k in keys], dtype=np.float64)
    pair_ids = np.array([s * n + d for s, d in keys], dtype=np.int64)

    # per-pair candidate incidence rows, gathered once per table build
    pcand = inc.pair_candidates
    cand_c = np.where(pcand.valid, inc.pair_path_ids, 0)[pair_ids]  # [M, K]
    cand_rids = pcand.rids[pair_ids]                    # [M, K, MC]
    cand_mask = pcand.mask[pair_ids]                    # [M, K, MC]
    cand_mult = pcand.mult[pair_ids].astype(np.float64)
    cand_pen = pcand.penalty[pair_ids].astype(np.float64)
    # tiered gating (mirrors the tensor planner): invalid candidates are
    # +inf, small-message relays +_HOST_BIG, candidates crossing a down
    # link +_HOST_BIG_DOWN — so dead paths lose to *any* live option even
    # at zero accumulated load, instead of winning the first assignments
    tier = np.where(pcand.valid[pair_ids], 0.0, np.inf)
    tier += _HOST_BIG * (
        pcand.relay[pair_ids] & (res[:, None] <= cm.split_threshold)
    )
    down = topo.down_link_ids()
    if down:
        down_res = np.zeros(inc.n_resources, dtype=bool)
        down_res[np.asarray(down, dtype=np.int64)] = True
        tier += _HOST_BIG_DOWN * (
            (down_res[cand_rids] & cand_mask).any(axis=-1)
        )

    caps = inc.caps
    sweeps: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    alive = np.arange(len(keys))
    it = 0
    while alive.size and it < max_iters:
        it += 1
        nb = min(_SUBSWEEPS, alive.size)
        for b in range(nb):
            batch = alive[b::nb]                        # interleaved sub-batch
            costs = (loads + ext) / caps                # refresh per sub-batch
            pc = (
                np.max(costs[cand_rids[batch]] * cand_mask[batch], axis=-1)
                + cand_pen[batch]
                + tier[batch]
            )                                           # [Mb, K]
            best_k = np.argmin(pc, axis=-1)             # [Mb]
            f = _quantized_fraction(res[batch], lam, eps)
            rids_sel = cand_rids[batch, best_k]         # [Mb, MC]
            mult_sel = cand_mult[batch, best_k]         # [Mb, MC]
            np.add.at(loads, rids_sel.ravel(), (f[:, None] * mult_sel).ravel())
            link_sel = rids_sel < E
            np.add.at(
                raw,
                np.where(link_sel, rids_sel, 0).ravel(),
                (f[:, None] * link_sel).ravel(),
            )
            sweeps.append((batch, cand_c[batch, best_k], f))
            res[batch] = res[batch] - f
        alive = alive[res[alive] > 1e-9]

    if sweeps:
        # consolidate all (pair, path) assignments in one vectorized pass
        all_m = np.concatenate([b for b, _, _ in sweeps])
        all_pid = np.concatenate([p for _, p, _ in sweeps]).astype(np.int64)
        all_f = np.concatenate([f for _, _, f in sweeps])
        combo = all_m * inc.n_paths + all_pid
        uniq, inv = np.unique(combo, return_inverse=True)
        tot = np.zeros(len(uniq))
        np.add.at(tot, inv, all_f)
        for u, fb in zip(uniq, tot):
            m, pid = divmod(int(u), inc.n_paths)
            flows[keys[m]].append(RoutedFlow(inc.paths[pid], float(fb)))

    routed = total - float(res.sum())
    if abs(routed - total) > 1e-6 * max(total, 1.0):
        if topo.down_link_ids():
            # degraded fabric: serve a survivor-striped plan instead of
            # crashing the replan path (DESIGN.md §9)
            return solve_degraded(topo, demands, cost_model)
        raise RuntimeError(
            f"MWU failed to route all demand: {routed} of {total} bytes"
        )
    return Plan(topo, rm, flows, loads[:-1], raw, it)


def _solve_mwu_sequential(
    topo: Topology,
    demands: Mapping[PairKey, float],
    cost_model: CostModel | None = None,
    *,
    lam: float = 0.25,
    eps: float = 1 << 20,
    prev_loads: np.ndarray | None = None,
    ext_loads: np.ndarray | None = None,
    max_iters: int = 10_000,
) -> Plan:
    """Faithful paper loop: costs refreshed after every single assignment."""
    rm = ResourceModel(topo, cost_model)
    path_table = all_pairs_paths(topo)

    loads = np.zeros(rm.n_resources, dtype=np.float64)
    if prev_loads is not None:
        loads = rm.smooth_loads(prev_loads, loads)
    ext = np.zeros(rm.n_resources, dtype=np.float64)
    if ext_loads is not None:
        ext = ext + np.asarray(ext_loads, dtype=np.float64)
        if (ext < 0).any():
            raise ValueError("ext_loads must be non-negative")
    raw = np.zeros(topo.n_links, dtype=np.float64)

    residual: Dict[PairKey, float] = {
        k: float(v) for k, v in demands.items() if v > 0 and k[0] != k[1]
    }
    msg_size: Dict[PairKey, float] = dict(residual)
    flows: Dict[PairKey, List[RoutedFlow]] = {k: [] for k in residual}

    total = sum(residual.values())
    it = 0
    while residual and it < max_iters:
        it += 1
        costs = rm.resource_cost(loads + ext)
        for key in list(residual.keys()):
            r = residual[key]
            cands = path_table[key]
            pcosts = [rm.path_cost(p, costs, msg_size[key]) for p in cands]
            best = int(np.argmin(pcosts))
            path = cands[best]
            f = float(_quantized_fraction(np.float64(r), lam, eps))
            _route(loads, raw, rm, path, f)
            costs = rm.resource_cost(loads + ext)  # refresh per assignment
            flows[key].append(RoutedFlow(path, float(f)))
            residual[key] = r - f
            if residual[key] <= 1e-9:
                residual.pop(key)
    routed = sum(sum(fl.bytes for fl in v) for v in flows.values())
    if abs(routed - total) > 1e-6 * max(total, 1.0):
        if topo.down_link_ids():
            return solve_degraded(topo, demands, cost_model)
        raise RuntimeError(
            f"MWU failed to route all demand: {routed} of {total} bytes"
        )
    return Plan(topo, rm, flows, loads, raw, it)


def pxn_path(topo: Topology, key: PairKey) -> Path:
    """Static fastest path for ``key``: intra direct, else the PXN rail.

    PXN (NCCL v2.12+, §II-B): inter-node traffic uses the rail matching the
    *destination* chip, staging intra-node at the source side if needed.
    This is the per-pair rule of :func:`solve_direct`, exposed so stale-plan
    execution (``apply_plan_fractions``) can route previously-unseen pairs
    exactly like the static baseline would.
    """
    cands = all_pairs_paths(topo)[key]
    if topo.same_group(*key):
        return next(p for p in cands if p.family == DIRECT)
    dest_rail = topo.rail_of(key[1])

    def rail_of_path(p: Path) -> int:
        for l in p.links:
            if topo.kind[l] != INTRA:
                return topo.rail_of(topo.links[l].src)
        return -1

    return next(p for p in cands if rail_of_path(p) == dest_rail)


def solve_direct(
    topo: Topology,
    demands: Mapping[PairKey, float],
    cost_model: CostModel | None = None,
) -> Plan:
    """NCCL/MPI-style static fastest-path baseline with PXN rail selection."""
    rm = ResourceModel(topo, cost_model)
    loads = np.zeros(rm.n_resources, dtype=np.float64)
    raw = np.zeros(topo.n_links, dtype=np.float64)
    flows: Dict[PairKey, List[RoutedFlow]] = {}
    for key, d in demands.items():
        if d <= 0 or key[0] == key[1]:
            continue
        path = pxn_path(topo, key)
        _route(loads, raw, rm, path, float(d))
        flows[key] = [RoutedFlow(path, float(d))]
    return Plan(topo, rm, flows, loads, raw, 1)


def solve_static_striping(
    topo: Topology,
    demands: Mapping[PairKey, float],
    cost_model: CostModel | None = None,
) -> Plan:
    """UCX-style static multirail striping (§II-B): even, load-oblivious."""
    rm = ResourceModel(topo, cost_model)
    path_table = all_pairs_paths(topo)
    loads = np.zeros(rm.n_resources, dtype=np.float64)
    raw = np.zeros(topo.n_links, dtype=np.float64)
    flows: Dict[PairKey, List[RoutedFlow]] = {}
    for key, d in demands.items():
        if d <= 0 or key[0] == key[1]:
            continue
        cands = path_table[key]
        if topo.same_group(*key):
            chosen = [(p, float(d)) for p in cands if p.family == DIRECT]
        else:
            share = float(d) / len(cands)
            chosen = [(p, share) for p in cands]
        flows[key] = []
        for p, f in chosen:
            _route(loads, raw, rm, p, f)
            flows[key].append(RoutedFlow(p, f))
    return Plan(topo, rm, flows, loads, raw, 1)


def solve_degraded(
    topo: Topology,
    demands: Mapping[PairKey, float],
    cost_model: CostModel | None = None,
) -> Plan:
    """Survivor-striping fallback for a partially-dead fabric (DESIGN.md §9).

    When a fault leaves MWU with no converging residual (every candidate
    for some pair crosses a down link, or the iteration budget burns out
    against near-zero capacities), the runtime still needs *a* plan — a
    dead dataplane is strictly worse than an uneven one.  Each pair
    stripes evenly across its candidates that avoid every down link; a
    pair with no surviving candidate routes on the single candidate with
    the largest bottleneck capacity (least-dead path).  The returned plan
    is flagged ``degraded=True`` so reports and drills can tell a fallback
    from a converged solve.
    """
    rm = ResourceModel(topo, cost_model)
    path_table = all_pairs_paths(topo)
    down = set(topo.down_link_ids())
    loads = np.zeros(rm.n_resources, dtype=np.float64)
    raw = np.zeros(topo.n_links, dtype=np.float64)
    flows: Dict[PairKey, List[RoutedFlow]] = {}
    for key, d in demands.items():
        if d <= 0 or key[0] == key[1]:
            continue
        cands = path_table[key]
        alive = [
            p for p in cands if not any(l in down for l in p.links)
        ]
        if not alive:
            alive = [
                max(
                    cands,
                    key=lambda p: min(
                        topo.links[l].capacity for l in p.links
                    ),
                )
            ]
        share = float(d) / len(alive)
        flows[key] = []
        for p in alive:
            _route(loads, raw, rm, p, share)
            flows[key].append(RoutedFlow(p, share))
    return Plan(topo, rm, flows, loads, raw, 1, degraded=True)


# -- plan bridges (orchestration runtime) ---------------------------------------

def plan_from_flows(
    topo: Topology,
    flows_nnK: np.ndarray,
    demands: Mapping[PairKey, float],
    cost_model: CostModel | None = None,
    iterations: int = 0,
) -> Plan:
    """Materialize a host :class:`Plan` from the tensor planner's output.

    ``flows_nnK`` is the ``[n, n, K]`` per-candidate byte assignment of
    ``planner.plan_flows`` / ``plan_flows_batch`` (one batch entry).  Each
    pair's flows are rescaled to sum *exactly* to its demand (the tensor loop
    runs in float32), attached to the concrete routes of the shared
    incidence tables, and recharged onto a fresh resource vector — so the
    returned plan simulates and reports identically to a host-solved one.
    """
    rm = ResourceModel(topo, cost_model)
    inc = incidence_for(topo, rm.cm)
    n, K = topo.n_devices, inc.K
    loads = np.zeros(rm.n_resources, dtype=np.float64)
    raw = np.zeros(topo.n_links, dtype=np.float64)
    flows: Dict[PairKey, List[RoutedFlow]] = {}
    for (s, d), dem in demands.items():
        if dem <= 0 or s == d:
            continue
        row = np.asarray(flows_nnK[s, d], dtype=np.float64)
        tot = float(row.sum())
        scale = float(dem) / tot if tot > 0 else 0.0
        fl: List[RoutedFlow] = []
        for k in range(K):
            pid = int(inc.pair_path_ids[s * n + d, k])
            if pid < 0:
                continue
            b = float(row[k]) * scale if tot > 0 else (
                float(dem) if k == 0 else 0.0
            )
            if b <= 0:
                continue
            fl.append(RoutedFlow(inc.paths[pid], b))
            _route(loads, raw, rm, inc.paths[pid], b)
        flows[(s, d)] = fl
    return Plan(topo, rm, flows, loads, raw, iterations)


def apply_plan_fractions(
    plan: Plan,
    demands: Mapping[PairKey, float],
    topo: Topology | None = None,
    cost_model: CostModel | None = None,
) -> Plan:
    """Execute a (possibly stale) plan's per-pair split ratios on new demand.

    This is what actually happens between replans: the dataplane keeps
    moving traffic along the last plan's paths while the demand drifts
    underneath it.  Each pair's new demand is split across the old plan's
    paths proportionally to their planned bytes; pairs the old plan never
    routed fall back to the static PXN rule (:func:`pxn_path`).  ``topo``
    may differ from ``plan.topo`` in link capacities (degradation events) —
    geometry must match, since paths are reused by link id.
    """
    topo = topo if topo is not None else plan.topo
    rm = ResourceModel(topo, cost_model or plan.rm.cm)
    stale = plan.consolidated()
    loads = np.zeros(rm.n_resources, dtype=np.float64)
    raw = np.zeros(topo.n_links, dtype=np.float64)
    flows: Dict[PairKey, List[RoutedFlow]] = {}
    for key, dem in demands.items():
        if dem <= 0 or key[0] == key[1]:
            continue
        old = stale.get(key)
        tot = sum(f.bytes for f in old) if old else 0.0
        if tot > 0:
            fl = [
                RoutedFlow(f.path, float(dem) * f.bytes / tot)
                for f in old
                if f.bytes > 0
            ]
        else:
            fl = [RoutedFlow(pxn_path(topo, key), float(dem))]
        for f in fl:
            _route(loads, raw, rm, f.path, f.bytes)
        flows[key] = fl
    return Plan(topo, rm, flows, loads, raw, plan.iterations)


# -- optimality accounting ------------------------------------------------------

def congestion_lower_bound(topo: Topology, demands: Mapping[PairKey, float],
                           cost_model: CostModel | None = None) -> float:
    """Cut lower bound on the min-max normalized congestion Z*.

    Valid cuts: (i) egress of s over min(out-link sum, inject cap);
    (ii) ingress of d over in-link sum; (iii) inter-group demand over the
    group's rail cut.  Z* >= max cut demand/capacity.
    """
    cm = cost_model or CostModel()
    n = topo.n_devices
    out_cap = np.zeros(n)
    in_cap = np.zeros(n)
    group_rail_cap = np.zeros(topo.n_groups)
    for l in topo.links:
        out_cap[l.src] += l.capacity
        in_cap[l.dst] += l.capacity
        if l.kind != INTRA:
            group_rail_cap[topo.group_of(l.src)] += l.capacity
    out_cap = np.minimum(out_cap, cm.inject_cap)
    egress = np.zeros(n)
    ingress = np.zeros(n)
    group_out = np.zeros(topo.n_groups)
    for (s, d), v in demands.items():
        if s == d or v <= 0:
            continue
        egress[s] += v
        ingress[d] += v
        if not topo.same_group(s, d):
            group_out[topo.group_of(s)] += v
    bounds = [0.0]
    with np.errstate(divide="ignore", invalid="ignore"):
        bounds.append(float(np.max(np.where(out_cap > 0, egress / out_cap, 0.0))))
        bounds.append(float(np.max(np.where(in_cap > 0, ingress / in_cap, 0.0))))
        gb = np.where(group_rail_cap > 0, group_out / group_rail_cap, 0.0)
        if len(gb):
            bounds.append(float(np.max(gb)))
    return max(bounds)
