"""Roofline terms of a step from its counted ops, at the card's rates.

Counterpart of ``repro/roofline/analysis.py``.  Three terms per
(arch x shape x mesh):

    compute    = sum over dtypes of FLOPs(dtype) / peak FLOP/s(dtype)
    memory     = bytes      / HBM bandwidth
    collective = coll_bytes / link bandwidth

all per device: the counter (``hlo_cost.CostCounter``) counts what this
process runs, so each term divides by one card's rate; the dominant term is
the larger.  The compute term prices each dtype at its own peak: the port's
plain backwards run in float32, and a roofline that priced them at the bf16
peak would be no bound on the card.

The reference parses collective bytes out of the HLO text
(``collective_bytes(hlo_text)``); the port has no HLO text, and the counter
sees the ``c10d`` ops themselves, so there is no counterpart of that
function.  ``analyze`` builds a :class:`Roofline` from the counter's dict
rather than from a compiled object.

The rates are one NVIDIA H100 SXM's (NVIDIA's data sheet, dense, at its 700 W
limit) and one NDR400 InfiniBand rail a GPU, as in the paper's testbed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..tree import leaves

#: FLOP/s a card: bf16 dense on the tensor cores (989 TFLOP/s) and float32 on
#: the CUDA cores (67 TFLOP/s), NVIDIA H100 SXM data sheet, no sparsity
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
#: bytes/s of one H100 SXM's HBM3 (NVIDIA data sheet: 3.35 TB/s)
HBM_BW = 3.35e12
#: bytes/s of one NDR400 rail a GPU (400 Gb/s), the paper's testbed; the
#: fabric model keeps its measured 45.1 GB/s (``core/topology.py``)
LINK_BW = 50e9


def peak_flops(dtype: str) -> float:
    """A dtype's peak; one not listed at the fastest listed, so the compute
    term stays a lower bound."""
    return PEAK_FLOPS.get(dtype, max(PEAK_FLOPS.values()))


def kernel_bound(flops: float, nbytes: float, dtype: str) -> Tuple[float, str]:
    """(seconds, ``"operations"`` or ``"bytes"``): one kernel call's least
    time on the card, the larger of its FLOPs at ``dtype``'s peak and its
    bytes at HBM rate; the costs come from each ``kernels/*/ops.py``."""
    t_ops, t_bytes = flops / peak_flops(dtype), nbytes / HBM_BW
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def least_train_step(model_flops_total: float, params, state) -> Tuple[float, float]:
    """(compute_s, memory_s) a train step needs however it is computed: the
    model's FLOPs (6·N·D) at the bf16 peak, and one fused AdamW update's
    traffic at HBM rate, each parameter and its gradient read once, the
    parameter written once, and both moments read and written once.

    Unlike a :class:`Roofline` from the counter, which counts the port's own
    ops one by one, this does not move when the code fuses or splits ops.
    """
    p_bytes = sum(t.numel() * t.element_size() for t in leaves(params)
                  if isinstance(t, torch.Tensor))
    mv_bytes = sum(t.numel() * t.element_size() for t in leaves((state.m, state.v))
                   if isinstance(t, torch.Tensor))
    return model_flops_total / PEAK_FLOPS["bf16"], (3 * p_bytes + 2 * mv_bytes) / HBM_BW


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: Dict[str, int]
    n_chips: int
    model_flops_total: float     # 6·N·D (or 2·N·D for inference)
    flops_by_dtype: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        if not self.flops_by_dtype:
            return self.flops_per_device / PEAK_FLOPS["bf16"]
        return sum(f / peak_flops(dt) for dt, f in self.flops_by_dtype.items())

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_device / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """The least time of the step: its largest term."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.n_chips
        return self.model_flops_total / total if total else 0.0

    def as_dict(self) -> dict:
        """The reference's keys, and the port's ``flops_by_dtype``."""
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "coll_breakdown": self.coll_breakdown,
            "n_chips": self.n_chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops_total": self.model_flops_total,
            "useful_flops_ratio": self.useful_flops_ratio,
            "flops_by_dtype": dict(self.flops_by_dtype),
        }


def analyze(cost: Dict, n_chips: int, model_flops_total: float) -> Roofline:
    """Roofline terms from a ``CostCounter.result()`` dict."""
    coll = {k: int(v) for k, v in cost["collectives"].items()}
    return Roofline(
        flops_per_device=float(cost["flops"]),
        bytes_per_device=float(cost["bytes"]),
        coll_bytes_per_device=float(sum(coll.values())),
        coll_breakdown=coll,
        n_chips=n_chips,
        model_flops_total=model_flops_total,
        flops_by_dtype=dict(cost.get("flops_by_dtype", {})),
    )


# --------------------------------------------------------------------------- #
# model FLOPs (analytic)
# --------------------------------------------------------------------------- #


def count_params(tree) -> int:
    """Elements of every tensor leaf (fake tensors included)."""
    return sum(int(t.numel()) for t in leaves(tree) if isinstance(t, torch.Tensor))


def active_param_fraction(cfg) -> float:
    """MoE: fraction of expert params active per token (top_k / n_experts)."""
    if cfg.n_experts and cfg.top_k:
        return cfg.top_k / cfg.n_experts
    return 1.0


def model_flops(cfg, n_params: int, tokens: int, kind: str) -> float:
    """6·N·D train / 2·N·D inference; MoE uses active params."""
    if cfg.n_experts and cfg.top_k:
        expert_params = cfg.n_layers * cfg.n_experts * 3 * cfg.d_model * cfg.d_ff
        n_active = n_params - expert_params + expert_params * (
            cfg.top_k / cfg.n_experts
        )
    else:
        n_active = n_params
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * tokens
