"""The numbers that decide ``correct``: the program's readings against the
plain reference's.

Training (each a share; smaller is closer):

  * ``grad_gap``: the first gradient's norm, as the optimizer took it
    (before its clipping), by the worst leaf: the gap between the
    program's norm and the reference's, over the larger of the reference's
    norm of that leaf and of the median leaf;
  * ``update_gap``: the parameters' change over the judged steps, by the
    worst leaf, measured as ``grad_gap`` is.  A leaf whose reference
    gradient is under a thousandth of the median leaf's moves by rounding
    alone and is left out.

Serving (``reference/model.py::Judge``), over the judged serves: ``gap``,
the widest gap by which a served token's reference logit lies below the
reference's best; ``moe_gap``, the widest distance of the expert layer's
output at a judged row from the reference's, over the median row's norm;
``drops_out``, the assignments by which a serve's dropped count lies
outside what the reference drops.  Each is the least over the routings
that bfloat16 rounding could give.
"""

from __future__ import annotations

from statistics import median
from typing import Dict, Iterable, Optional

#: a leaf whose reference gradient is under this share of the median leaf's
#: moves by rounding alone
STILL = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of the reference's norm of that leaf and of the median leaf."""
    keys = list(ref) if leaves is None else list(leaves)
    med = median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               leaves: Optional[Iterable[str]] = None) -> float:
    return max(leaf_gaps(prog, ref, leaves).values())


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    return {"grad_gap": worst_leaf(prog["raw"], ref["raw"]),
            "update_gap": worst_leaf(prog["update"], ref["update"], moving_leaves(ref))}


def loss_gap(prog: dict, ref: dict) -> float:
    """The largest gap of a judged step's loss, over the reference's loss:
    read, not compared (no fault or control separates it from sound runs
    at the cells' size)."""
    return max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))


def moving_leaves(ref: dict):
    """The leaves whose reference gradient is at least :data:`STILL` of the
    median leaf's."""
    med = median(ref["raw"].values())
    return [k for k, v in ref["raw"].items() if v >= STILL * med]
