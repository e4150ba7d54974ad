"""Resolve a cell of ``BENCHMARK.json`` to its files by name, build what it
runs, and assemble its result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

  * the model configuration as it is run, in the file that the
    configuration's ``file`` names (``configs/<config>.json``);
  * ``traffic/<mix>.json``: the mix's parameters, read by ``gen.py``; its
    ``kind`` names the window that drives it, ``kinds/<kind>.py``;
  * ``limits/<cell>.json``: the limit of each number that decides
    ``correct`` in the cell;
  * ``metrics/<metric>.py``: a per-layer metric's reader, ``read(obs)`` ->
    a number, or ``None`` where it finds nothing to read.

A later cell, mix or metric adds files and entries; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict              # the configuration's file
    mix: dict                 # the traffic mix's file
    limits: Dict[str, float]
    kind: object              # the window's module
    end_to_end: List[dict]
    per_layer: List[dict]
    dirs: Sequence[Path]


def _find(dirs: Sequence[Path], sub: str, name: str, suffix: str) -> Path:
    for d in dirs:
        p = Path(d) / sub / f"{name}{suffix}"
        if p.is_file():
            return p
    raise FileNotFoundError(f"no {sub}/{name}{suffix} under {[str(d) for d in dirs]}")


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"chipbench_{path.stem.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _in_cell(metric: dict, cell: str, e2e_names: Optional[Sequence[str]] = None) -> bool:
    """Whether the cell reports the metric: one that lists its cells, where
    it lists this one; an end-to-end metric that lists none, everywhere; a
    per-layer one that lists none, wherever the metric it moves is."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def resolve(bench: dict, workload: str, dirs: Sequence[Path] = (HERE,),
            root: Path = ROOT) -> Cell:
    """The cell named ``workload`` with its files: the configuration's by
    its path under ``root``, the others searched in ``dirs``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the benchmark has {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((Path(root) / conf["file"]).read_text())
    mix = json.loads(_find(dirs, "traffic", w["traffic"], ".json").read_text())
    limits = json.loads(_find(dirs, "limits", workload, ".json").read_text())
    kind = load_module(_find(dirs, "kinds", mix["kind"], ".py"))
    e2e = [m for m in bench["end_to_end"] if _in_cell(m, workload)]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _in_cell(m, workload, names)]
    return Cell(workload, w["chips"], config, mix, limits, kind, e2e, per_layer, list(dirs))


# -- what the program runs --------------------------------------------------------

def program_config(config: dict):
    """(the program's ModelConfig, the ParallelContext's keywords) of a
    configuration's file."""
    import torch
    from repro_torch.configs.base import get_config

    cfg = dataclasses.replace(get_config(config["registry"]), **config["model"])
    par = dict(config["parallel"])
    for k in ("param_dtype", "compute_dtype"):
        par[k] = getattr(torch, par[k])
    return cfg, par


def reference_config(config: dict) -> dict:
    """The plain reference's view of a configuration's file."""
    m, par = config["model"], config["parallel"]
    return dict(
        n_layers=m["n_layers"], d_model=m["d_model"], n_heads=m["n_heads"],
        n_kv_heads=m["n_kv_heads"],
        head_dim=m.get("head_dim_override") or m["d_model"] // m["n_heads"],
        d_ff=m["d_ff"], vocab=m["vocab"], n_experts=m["n_experts"], top_k=m["top_k"],
        capacity_factor=m["moe_capacity_factor"], rope_theta=m["rope_theta"],
        norm_eps=m["norm_eps"], ep=par["ep_size"], chunk_tokens=par["moe_chunk_tokens"])


def leaf_seed(seed: int, j: int) -> int:
    return int(np.random.SeedSequence([seed, j]).generate_state(1, dtype=np.uint64)[0] >> 1)


def seed_of(config: dict, path: str, seed: int) -> int:
    """The seed a leaf is drawn from: the configuration's ``routing_seed``
    for the leaves that decide the routing (``routing_leaves``, by path or
    prefix), one draw a configuration as a served checkpoint's are; the
    run's ``seed`` for the rest."""
    w = config.get("weights", {})
    fixed = any(path == p or path.startswith(p + ".") for p in w.get("routing_leaves", ()))
    return w["routing_seed"] if fixed else seed


def make_leaf(path: str, shape: tuple, j: int, seed: int, dtype, device, config: dict):
    """Leaf j of the weights of ``seed`` (see :func:`seed_of`), on
    ``device`` in ``dtype``: norms ones, the embedding N(0, 0.02^2), every
    other matrix N(0, 1/d_in) with d_in its second-last dimension."""
    import torch

    last = path.rsplit(".", 1)[-1]
    if last.startswith("ln") or last.endswith("norm"):
        return torch.ones(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed_of(config, path, seed), j))
    w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return w.mul_(0.02 if last == "embed" else 1.0 / math.sqrt(shape[-2]))


def make_weights(shapes: dict, seed: int, dtype, device, config: dict) -> dict:
    """The weights of ``seed`` as a tree shaped like ``shapes``."""
    out: dict = {}
    for j, (path, shape) in enumerate(flat(shapes).items()):
        node = out
        *head, last = path.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = make_leaf(path, shape, j, seed, dtype, device, config)
    return out


def flat(tree, prefix: str = "") -> dict:
    """A tree of dicts -> {dotted path: leaf}, paths in sorted order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out.update(flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def free_device() -> None:
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one that no run may load."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Outcome:
    """What a window reports: its end-to-end metrics by name, the numbers
    that decide ``correct`` (name -> value), what the traced run observed
    (``obs``, for the per-layer readers), and the device's figures."""

    metrics: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, float]
    memory_peak_bytes: int
    obs: Optional[object] = None
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None


def result(cell: Cell, out: Outcome, trace: bool, device: dict):
    """-> (the result line's object, the check lines for standard error,
    an error or None)."""
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if trace:
        for m in cell.per_layer:
            reader = load_module(_find(cell.dirs, "metrics", m["name"], ".py"))
            v = reader.read(out.obs)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": units[m["name"]]}
    else:
        for m in cell.end_to_end:
            if m["name"] not in out.metrics:
                return None, [], f"the window reported no {m['name']}"
            metrics[m["name"]] = {"value": float(out.metrics[m["name"]]),
                                  "unit": units[m["name"]]}
    checks = {}
    for name, value in out.checks.items():
        limit = cell.limits[name]
        checks[name] = {"value": float(value), "limit": float(limit)}
    correct = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    dev = dict(device, memory_peak_bytes=int(out.memory_peak_bytes))
    if trace:
        dev.update(busy_s=out.busy_s, window_s=out.window_s)
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": dev}
    if trace and out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["check"] = checks
    lines = [f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in checks.items()]
    return line, lines, None
