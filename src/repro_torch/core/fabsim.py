"""Link-time fabric simulator.

Counterpart of ``repro/core/fabsim.py``, numpy only and equal to it bit for
bit.  Executes a routing :class:`~.mcf.Plan` on the calibrated resource
graph and reports completion time / effective bandwidth, modeling the
paper's chunked bottleneck-rate pipeline (§IV-C):

  * each resource (link / relay-throughput / injection) drains its assigned
    effective bytes at capacity;
  * a multi-hop path additionally pays a pipeline **fill** latency of
    ``(n_hops - 1) * chunk / bottleneck_cap`` before reaching steady state
    (the P2P staging buffers must fill once);
  * the exchange completes when the slowest resource drains — the max-load
    objective Z of the IP is exactly the simulated completion time, which is
    why Algorithm 1 minimizes the right thing.

This is the evaluation vehicle for the paper's bandwidth claims: Fig. 6/7/8
ratios are reproduced analytically from plans, while bit-exact data movement
is validated separately by the stacked-rank dataplane (``dataplane.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping

import numpy as np

from ..jsonio import json_dumps, tag
from .incidence import incidence_for
from .mcf import PairKey, Plan, RoutedFlow


@dataclasses.dataclass
class SimResult:
    completion_time: float          # seconds
    total_payload: float            # bytes
    effective_bandwidth: float      # payload / time
    per_resource_time: np.ndarray
    per_resource_util: np.ndarray   # fraction of completion time busy
    bottleneck_resource: int        # < n_links => a link; then relay; then inject

    def bandwidth_gbs(self) -> float:
        return self.effective_bandwidth / 1e9

    def bottleneck_kind(self, plan: Plan) -> str:
        rid = self.bottleneck_resource
        E, n = plan.rm.n_links, plan.topo.n_devices
        if rid < E:
            l = plan.topo.links[rid]
            return f"link[{l.src}->{l.dst}]"
        if rid < E + n:
            return f"relay[{rid - E}]"
        return f"inject[{rid - E - n}]"

    # -- serialization (shared schema, jsonio.py) --------------------------
    def to_json_obj(self) -> dict:
        """Tagged dict (``nimble.simresult/v1``) for cross-file consumers."""
        return tag(
            "simresult",
            {
                "completion_time_s": float(self.completion_time),
                "total_payload_bytes": float(self.total_payload),
                "effective_bandwidth_gbs": self.bandwidth_gbs(),
                "bottleneck_resource": int(self.bottleneck_resource),
                "per_resource_time_s": [
                    float(x) for x in self.per_resource_time
                ],
                "per_resource_util": [
                    float(x) for x in self.per_resource_util
                ],
            },
        )

    def to_json(self, *, indent: bool = False) -> bytes:
        return json_dumps(self.to_json_obj(), indent=indent)


def _pipeline_fill_reference(plan: Plan, chunk_bytes: float) -> np.ndarray:
    """Reference per-flow fill loop (kept for the equivalence test)."""
    rm = plan.rm
    fill = np.zeros(rm.n_resources)
    for key, flows in plan.consolidated().items():
        for f in flows:
            if f.path.n_relays > 0 and f.bytes > 0:
                caps = rm.topo.capacity[list(f.path.links)]
                extra = (f.path.n_hops - 1) * min(chunk_bytes, f.bytes) / caps.min()
                for l in f.path.links:
                    fill[l] = max(fill[l], extra)
    return fill


#: below this many relayed flows the scalar loop beats a (possibly cold)
#: O(n²K) incidence-table fetch — e.g. one-shot simulations of host plans
#: on fingerprints outside the table cache
_VECTORIZE_MIN_FLOWS = 8


def _pipeline_fill(plan: Plan, chunk_bytes: float) -> np.ndarray:
    """Vectorized pipeline-fill: per-path bottleneck caps come precomputed
    from the shared incidence tables (``path_link_min_cap`` / ``path_links``)
    instead of being re-derived per flow; values are bit-identical to
    :func:`_pipeline_fill_reference`.  Plans with few relayed flows take
    the scalar loop — not worth a table build."""
    rm = plan.rm
    n_res = rm.n_resources
    relayed: List[RoutedFlow] = [
        f
        for flows in plan.consolidated().values()
        for f in flows
        if f.path.n_relays > 0 and f.bytes > 0
    ]
    # extra slot collects the -1 padding scatter so real rows stay exact
    buf = np.zeros(n_res + 1)
    slow: List[RoutedFlow] = []
    if len(relayed) < _VECTORIZE_MIN_FLOWS:
        slow = relayed
    else:
        inc = incidence_for(plan.topo, rm.cm)
        pid_of = inc.path_index
        pids: List[int] = []
        byts: List[float] = []
        for f in relayed:
            pid = pid_of.get(f.path)
            if pid is None:   # path unknown to the tables (none expected)
                slow.append(f)
            else:
                pids.append(pid)
                byts.append(f.bytes)
        if pids:
            pid_a = np.asarray(pids, dtype=np.int64)
            b = np.asarray(byts, dtype=np.float64)
            extra = (
                (inc.path_n_hops[pid_a] - 1)
                * np.minimum(chunk_bytes, b)
                / inc.path_link_min_cap[pid_a]
            )
            links = inc.path_links[pid_a]             # [F, MAX_HOPS]
            np.maximum.at(
                buf,
                np.where(links >= 0, links, n_res).ravel(),
                np.repeat(extra, links.shape[1]),
            )
    for f in slow:
        caps = rm.topo.capacity[list(f.path.links)]
        extra = (f.path.n_hops - 1) * min(chunk_bytes, f.bytes) / caps.min()
        for l in f.path.links:
            buf[l] = max(buf[l], extra)
    return buf[:n_res]


def simulate(plan: Plan, chunk_bytes: float = 1 << 20) -> SimResult:
    rm = plan.rm
    drain = plan.resource_bytes / rm.capacity
    # pipeline fill: charged once per multi-hop path on its bottleneck resource
    fill = _pipeline_fill(plan, chunk_bytes)
    per_res = drain + fill
    t = float(per_res.max()) if len(per_res) else 0.0
    total = float(sum(sum(x.bytes for x in v) for v in plan.flows.values()))
    bw = total / t if t > 0 else 0.0
    util = per_res / t if t > 0 else np.zeros_like(per_res)
    return SimResult(
        completion_time=t,
        total_payload=total,
        effective_bandwidth=bw,
        per_resource_time=per_res,
        per_resource_util=util,
        bottleneck_resource=int(np.argmax(per_res)) if len(per_res) else -1,
    )


def pair_bandwidth(plan: Plan, pair: PairKey, chunk_bytes: float = 1 << 20) -> float:
    """Effective bandwidth seen by a single (s, d) pair under the plan."""
    flows = plan.consolidated().get(pair, [])
    if not flows:
        return 0.0
    rm = plan.rm
    t = 0.0
    for f in flows:
        rids = [rid for rid, _ in rm.charges(f.path, 1.0)]
        drain = max(plan.resource_bytes[r] / rm.capacity[r] for r in rids)
        caps = rm.topo.capacity[list(f.path.links)]
        fillt = (f.path.n_hops - 1) * min(chunk_bytes, f.bytes) / caps.min()
        t = max(t, drain + fillt)
    total = sum(f.bytes for f in flows)
    return total / t if t > 0 else 0.0


def compare(
    plans: Mapping[str, Plan], chunk_bytes: float = 1 << 20
) -> Dict[str, SimResult]:
    return {name: simulate(p, chunk_bytes) for name, p in plans.items()}


def simulate_nccl_rounds(
    topo, demands: Mapping[PairKey, float], cost_model=None
) -> float:
    """Round-serialized NCCL-like All-to-Allv completion time (seconds).

    NCCL executes grouped p2p as n-1 rounds (rank r talks to r+k in round
    k) over a fixed channel set; a round's duration is its slowest transfer
    on the statically chosen (PXN) path, and rounds serialize on the shared
    channels.  This kernel-level behaviour — not just static routing — is
    what the paper's Fig. 7 baseline pays under skew, and it is why measured
    NCCL losses (up to 5.2x) exceed the pure link-funneling bound (~4x).
    """
    from .mcf import solve_direct

    n = topo.n_devices
    total = 0.0
    for k in range(1, n):
        round_d = {}
        for s in range(n):
            dpair = (s, (s + k) % n)
            if dpair in demands and demands[dpair] > 0:
                round_d[dpair] = demands[dpair]
        if not round_d:
            continue
        plan = solve_direct(topo, round_d, cost_model)
        total += simulate(plan).completion_time
    return total
