"""Checkpoints in the reference's on-disk format: npz payload shards + a JSON index.

Counterpart of ``repro/checkpoint/ckpt.py``.  Layout:

    <dir>/step_<N>/index.json      — tree structure, dtypes, shapes, shard map
    <dir>/step_<N>/shard_<k>.npz   — flat arrays owned by host shard k

Leaves are flattened under stable path keys (``a/b/0/c``, dict keys
sorted); ``restore`` rebuilds the tree (dicts, lists, tuples and named
tuples, through ``namedtuple_types``).  A checkpoint written by either
package restores in the other.

Two leaves need care:

  * **bfloat16.**  numpy has no bfloat16 without ``ml_dtypes``: the
    reference's files hold such a leaf as 2-byte raw data (``np.load`` gives
    ``|V2``) with ``"dtype": "bfloat16"`` in the index.  The port writes the
    same and reads it back by the index's dtype.
  * **The optimizer's step.**  The reference's ``OptState.step`` is a 0-d
    int32 array; the port's is a Python ``int``.  An ``int`` leaf is written
    as a 0-d int32 array, and a named tuple's field annotated ``int`` is
    restored to an ``int``.

Leaves restore onto ``device``: the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import os
import typing
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..jsonio import json_dumps, json_loads

_BF16 = "bfloat16"


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}{k}/")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, f"{prefix}{i}/")
        return out
    return [(prefix.rstrip("/"), tree)]


def _structure(tree) -> Any:
    if isinstance(tree, dict):
        return {"__kind__": "dict", "items": {k: _structure(v) for k, v in tree.items()}}
    if hasattr(tree, "_fields"):  # namedtuple
        return {"__kind__": "namedtuple", "name": type(tree).__name__,
                "items": [_structure(v) for v in tree]}
    if isinstance(tree, tuple):
        return {"__kind__": "tuple", "items": [_structure(v) for v in tree]}
    if isinstance(tree, list):
        return {"__kind__": "list", "items": [_structure(v) for v in tree]}
    return {"__kind__": "leaf"}


def _int_fields(t) -> set:
    hints = typing.get_type_hints(t)
    return {f for f in t._fields if hints.get(f) is int}


def _rebuild(struct, leaves: List[Any], namedtuple_types: Dict[str, Any]):
    kind = struct["__kind__"]
    if kind == "leaf":
        return leaves.pop(0)
    if kind == "dict":
        return {k: _rebuild(v, leaves, namedtuple_types)
                for k, v in sorted(struct["items"].items())}
    items = [_rebuild(v, leaves, namedtuple_types) for v in struct["items"]]
    if kind == "namedtuple":
        t = namedtuple_types.get(struct["name"])
        if t is None:
            return tuple(items)
        ints = _int_fields(t)
        return t(*(int(x) if f in ints else x for f, x in zip(t._fields, items)))
    return tuple(items) if kind == "tuple" else items


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the reference's file holds it (bfloat16 as 2-byte raw)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, dtype=np.int32)
    return np.asarray(leaf)


def _to_torch(arr: np.ndarray, meta: dict, device) -> torch.Tensor:
    """A stored array -> a tensor on ``device``, bfloat16 by the index's dtype."""
    if meta["dtype"] == _BF16:
        raw = np.ascontiguousarray(arr).view(np.int16)
        t = torch.from_numpy(raw).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.reshape(meta["shape"]).to(device)


def save(path: str, step: int, tree, shard: int = 0) -> str:
    """Write ``tree`` as ``<path>/step_<step>``; -> that directory."""
    d = os.path.join(path, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    flat = _flatten(tree)
    arrays = {k: _to_numpy(v) for k, v in flat}
    dtypes = {k: (_BF16 if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16
                  else str(arrays[k].dtype)) for k, v in flat}
    np.savez(os.path.join(d, f"shard_{shard}.npz"), **arrays)
    index = {
        "step": step,
        "structure": _structure(tree),
        "keys": [k for k, _ in flat],
        "meta": {k: {"shape": list(a.shape), "dtype": dtypes[k], "shard": shard}
                 for k, a in arrays.items()},
    }
    with open(os.path.join(d, "index.json"), "wb") as f:
        f.write(json_dumps(index))
    return d


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(n.split("_")[1]) for n in os.listdir(path) if n.startswith("step_")]
    return max(steps) if steps else None


def restore(path: str, step: Optional[int] = None,
            namedtuple_types: Optional[Dict[str, Any]] = None, *, device="cuda"):
    """-> (tree, step): the checkpoint at ``step`` (the latest by default),
    its leaves as tensors on ``device`` (the card unless ``"cpu"`` is asked)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ckpt.restore: device='cuda' and no CUDA device is present; "
                           "pass device='cpu' to restore on the host")
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "index.json"), "rb") as f:
        index = json_loads(f.read())
    shards = {}
    for m in index["meta"].values():
        s = m["shard"]
        if s not in shards:
            shards[s] = np.load(os.path.join(d, f"shard_{s}.npz"))
    leaves = [_to_torch(shards[index["meta"][k]["shard"]][k], index["meta"][k], device)
              for k in index["keys"]]
    return _rebuild(index["structure"], leaves, namedtuple_types or {}), step
