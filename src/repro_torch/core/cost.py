"""Capacity-normalized resource/cost model F(L) (paper §IV-B, §V-B).

The paper replaces Garg–Könemann's exponential link cost with a custom
``c_e = F(L_e)`` "designed according to hardware features and potential
overhead in multi-path routing".  Our F is *serialization time*:

    F(L_r) = L_r / capacity_r        (seconds to drain resource r)

evaluated over a **resource vector** that extends the raw link set with the
two hardware effects the paper measures but never names as resources:

  * a per-device **relay throughput** cap — a forwarding GPU streams data
    through its L2/HBM, observed at ~93.1 GB/s per relay path
    (Fig. 6a: 213.1 - 120 = 93.1 for one intermediate);
  * a per-device **injection** cap — a sender cannot source more than
    ~278.2 GB/s aggregate (Fig. 6a: three concurrent paths saturate at
    278.2, not 120 + 2 x 93.1 = 306);
  * concurrent rails derate to ``rail_relay_eff`` of single-rail bandwidth
    when fed through relays (Fig. 6b: 45.1 + 3 x 45.1 x 0.923 = 170.0).

Path cost is the **max** over the path's resources (bottleneck metric,
matching the chunked pipeline dataplane of §IV-C), so min-max routing
directly minimizes modeled completion time.

Policies from the paper, all implemented here:
  * **size threshold** — relay splitting disabled at or below
    ``split_threshold`` (paper: 1 MB, Fig. 6c);
  * **size-aware hop penalty** — relay paths pay a pipeline fill/flush cost,
    only amortized by large messages (§V-B);
  * **hysteresis** — loads fold into an EMA across invocations to avoid
    oscillation (§I).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .paths import DIRECT, Path
from .topology import INTRA, Topology


@dataclasses.dataclass
class CostModel:
    # --- policy knobs (paper defaults) ---------------------------------------
    split_threshold: float = 1 << 20   # bytes; <=1 MB stays single-path
    hop_setup_bytes: float = 2.0e6     # pipeline fill/flush, equivalent bytes
    # EMA weight on this job's OWN previous loads (0 = off).  This is the
    # single definition of the hysteresis factor: `prev_loads` inputs are
    # folded as `hysteresis * prev + (1 - hysteresis) * now`.  External
    # (other-tenant) load must enter through the solvers' `ext_loads`
    # instead — priced raw, never EMA-folded, never accounted (the fabric
    # arbiter's export; DESIGN.md §4).
    hysteresis: float = 0.5
    # --- hardware calibration (fit to the paper's Fig. 6) --------------------
    relay_cap: float = 93.1e9          # per-device forwarding throughput
    inject_cap: float = 278.2e9        # per-device egress aggregate
    rail_relay_eff: float = 0.923      # concurrent relayed-rail derate


class ResourceModel:
    """Resource vector = [links (E), relay (n), inject (n)]."""

    def __init__(self, topo: Topology, cm: CostModel | None = None):
        self.topo = topo
        self.cm = cm or CostModel()
        n, E = topo.n_devices, topo.n_links
        self.n_links = E
        self.n_resources = E + 2 * n
        caps = np.empty(self.n_resources, dtype=np.float64)
        caps[:E] = topo.capacity
        caps[E : E + n] = self.cm.relay_cap
        caps[E + n :] = self.cm.inject_cap
        self.capacity = caps

    # resource ids -------------------------------------------------------------
    def relay_rid(self, dev: int) -> int:
        return self.n_links + dev

    def inject_rid(self, dev: int) -> int:
        return self.n_links + self.topo.n_devices + dev

    # charging -----------------------------------------------------------------
    def charges(self, path: Path, f: float) -> List[Tuple[int, float]]:
        """(resource_id, effective_bytes) pairs for routing ``f`` bytes."""
        cm = self.cm
        out: List[Tuple[int, float]] = []
        relayed = path.n_relays > 0
        for l in path.links:
            if relayed and self.topo.kind[l] != INTRA:
                out.append((l, f / cm.rail_relay_eff))
            else:
                out.append((l, f))
        src = path.nodes[0]
        out.append((self.inject_rid(src), f))
        for relay in path.nodes[1:-1]:
            out.append((self.relay_rid(relay), f))
            out.append((self.inject_rid(relay), f))  # forwarding egress
        return out

    # cost ----------------------------------------------------------------------
    def resource_cost(self, load: np.ndarray) -> np.ndarray:
        """F(L): drain time per resource (seconds)."""
        return load / self.capacity

    def path_cost(
        self, path: Path, costs: np.ndarray, msg_bytes: float
    ) -> float:
        """Bottleneck (max) cost of the path + size-aware relay policies."""
        rids = [rid for rid, _ in self.charges(path, 1.0)]
        base = float(max(costs[r] for r in rids))
        if path.n_relays == 0:
            return base
        if msg_bytes <= self.cm.split_threshold:
            return float("inf")  # paper: no multi-path for small messages
        bottleneck_cap = float(
            min(self.capacity[rid] for rid, _ in self.charges(path, 1.0))
        )
        penalty = self.cm.hop_setup_bytes * path.n_relays / bottleneck_cap
        return base + penalty

    def smooth_loads(self, prev: np.ndarray | None, now: np.ndarray) -> np.ndarray:
        if prev is None or self.cm.hysteresis <= 0.0:
            return now
        return self.cm.hysteresis * prev + (1.0 - self.cm.hysteresis) * now


def capacity_normalized(topo: Topology, loads: np.ndarray) -> np.ndarray:
    """Per-link normalized congestion L_e / cap_e (the IP objective Z)."""
    return loads / topo.capacity
