"""The benchmark's frozen arithmetic of work: the operations and bytes of
each kernel launch, the model's FLOPs a step, and the card's peaks.

Each formula counts what these inputs need: the rows the capacity rule
keeps, the causal pairs of the sequence; each input byte read once and
each output byte written once.  Peaks: NVIDIA's data sheet for the H100
SXM, dense rates, at its 700 W limit.
"""

from __future__ import annotations

from typing import Tuple

#: bf16 products on the tensor cores, FLOP/s
PEAK_BF16 = 989e12
#: HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12


def least_s(flops: float, nbytes: float) -> Tuple[float, str]:
    """The least time of a launch and what bounds it."""
    tc, tm = flops / PEAK_BF16, nbytes / HBM_BW
    return (tc, "compute") if tc >= tm else (tm, "memory")


def ffn_launch(valid: float, used: int, d: int, f: int, itemsize: int = 2):
    """(flops, bytes) of one grouped SwiGLU FFN launch over ``valid`` token
    rows: gate, up and down products (6 d f a row); the rows read and
    written, and each used expert's three matrices read once."""
    return 6.0 * valid * d * f, (2.0 * valid * d + 3.0 * used * d * f) * itemsize


def causal_pairs(s: int) -> int:
    """Query-key pairs a causal sequence of s positions scores."""
    return s * (s + 1) // 2


def flash_launch(b: int, h: int, hkv: int, s: int, dh: int, itemsize: int = 2):
    """(flops, bytes) of one causal attention launch over [b, h, s, dh]
    queries and [b, hkv, s, dh] keys and values: 4 dh flops a pair; q, k, v
    read and o written once."""
    return 4.0 * dh * b * h * causal_pairs(s), itemsize * (2.0 * b * h * s * dh
                                                           + 2.0 * b * hkv * s * dh)


def active_products(cfg: dict) -> Tuple[float, float]:
    """(multiply-adds a token of the layers' products, of the output head)
    over the active parameters: attention's four projections, the router,
    the top-k experts' three matrices; and the head.  The embedding is a
    lookup, not a product."""
    d, dh = cfg["d_model"], cfg["head_dim"]
    h, hkv = cfg["n_heads"], cfg["n_kv_heads"]
    layer = (d * h * dh * 2 + d * hkv * dh * 2 + d * cfg["n_experts"]
             + cfg["top_k"] * 3 * d * cfg["d_ff"])
    return cfg["n_layers"] * layer, d * cfg["vocab"]


def attention_flops(cfg: dict, b: int, s: int) -> float:
    """Forward FLOPs of the layers' score and value products over the
    causal pairs."""
    return cfg["n_layers"] * 4.0 * cfg["head_dim"] * b * cfg["n_heads"] * causal_pairs(s)


def train_step_flops(cfg: dict, b: int, s: int) -> float:
    """A train step's model FLOPs: 6 a product's multiply-add a token, and 3
    times the attention's forward; recomputation not counted."""
    layers, head = active_products(cfg)
    return 6.0 * (layers + head) * b * s + 3.0 * attention_flops(cfg, b, s)


def prefill_flops(cfg: dict, b: int, s: int) -> float:
    """A prefill's model FLOPs: 2 a multiply-add, every token through the
    layers, the head at the last position only."""
    layers, head = active_products(cfg)
    return 2.0 * layers * b * s + 2.0 * head * b + attention_flops(cfg, b, s)
