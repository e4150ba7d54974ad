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

Across processes a tree holds this process's blocks of the parameters and of
AdamW's moments (``sharding/gather.py``).  ``save(place=)`` gathers each
leaf whose key path ends in a parameter's path whole (every process takes
part), one leaf at a time, each copied to the host before the next is
gathered, and lets the first process write the reference's files;
``restore(place=)`` cuts each such leaf to the block of the world that
reads it on the host, so only the block reaches the device.  So a checkpoint is the same files whatever the world that wrote
it, and restores in any other.
"""

from __future__ import annotations

import functools
import os
import typing
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

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


def _to_torch(arr: np.ndarray, meta: dict, device, cut=None) -> torch.Tensor:
    """A stored array -> a tensor on ``device``, bfloat16 by the index's dtype;
    ``cut`` (the whole host tensor -> the part to keep) runs before the upload."""
    if meta["dtype"] == _BF16:
        raw = np.ascontiguousarray(arr).view(np.int16)
        t = torch.from_numpy(raw).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    t = t.reshape(meta["shape"])
    return (t if cut is None else cut(t)).to(device)


def _param_path(key: str, place) -> Optional[tuple]:
    """The parameter path that ``key`` (``a/b/0/c``) ends in, if any: a
    parameter, its gradient and its moments share one placement."""
    parts = tuple(int(p) if p.isdigit() else p for p in key.split("/"))
    for i in range(len(parts)):
        path = parts[i:]
        if place.spec(path) is not None:
            return path
    return None


def save(path: str, step: int, tree, shard: int = 0, *, place=None) -> str:
    """Write ``tree`` as ``<path>/step_<step>``; -> that directory.

    ``place`` (a ``sharding.gather.Placement`` over a mesh): ``tree`` holds
    this process's blocks; every process gathers them whole, one leaf at a
    time, and the first copies each to the host before the next is gathered
    and writes (all return once it has)."""
    d = os.path.join(path, f"step_{step:08d}")
    placed = place is not None and place.placed
    write = not placed or dist.get_rank() == 0
    arrays, dtypes = {}, {}
    for k, v in _flatten(tree):
        if placed:
            v = _whole(v, k, place)
        if write:
            arrays[k] = _to_numpy(v)
            dtypes[k] = (_BF16 if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16
                         else str(arrays[k].dtype))
    if write:
        _write(d, step, tree, arrays, dtypes, shard)
    if placed:
        dist.barrier()
    return d


def _whole(leaf, key: str, place):
    at = _param_path(key, place) if isinstance(leaf, torch.Tensor) else None
    return leaf if at is None else place.whole_leaf(leaf, at)


def _write(d: str, step: int, tree, arrays: Dict[str, np.ndarray],
           dtypes: Dict[str, str], shard: int) -> None:
    os.makedirs(d, exist_ok=True)
    np.savez(os.path.join(d, f"shard_{shard}.npz"), **arrays)
    index = {
        "step": step,
        "structure": _structure(tree),
        "keys": list(arrays),
        "meta": {k: {"shape": list(a.shape), "dtype": dtypes[k], "shard": shard}
                 for k, a in arrays.items()},
    }
    with open(os.path.join(d, "index.json"), "wb") as f:
        f.write(json_dumps(index))


def _block(t: torch.Tensor, key: str, place) -> torch.Tensor:
    at = _param_path(key, place)
    return t if at is None else place.block(t, at)


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(n.split("_")[1]) for n in os.listdir(path) if n.startswith("step_")]
    return max(steps) if steps else None


def restore(path: str, step: Optional[int] = None,
            namedtuple_types: Optional[Dict[str, Any]] = None, *, device="cuda",
            place=None):
    """-> (tree, step): the checkpoint at ``step`` (the latest by default),
    its leaves as tensors on ``device`` (the card unless ``"cpu"`` is asked);
    with ``place`` over a mesh, each parameter-shaped leaf as this process's
    block of it, cut on the host before the upload."""
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
    placed = place is not None and place.placed
    leaves = [_to_torch(shards[index["meta"][k]["shard"]][k], index["meta"][k], device,
                        functools.partial(_block, key=k, place=place) if placed else None)
              for k in index["keys"]]
    return _rebuild(index["structure"], leaves, namedtuple_types or {}), step
