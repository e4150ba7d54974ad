"""Dry run: count one step of every (arch x shape x mesh) combo, with no card.

Counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each combo for 256 or 512 forced host devices; the port runs its
own step abstractly, as rank 0 of a fake world of that size:

  * a fake process group (``torch.testing``'s ``FakeStore``, backend
    ``"fake"``: collectives return at once) at rank 0 of 256, or 512 with
    ``--multi-pod``, and the production mesh over it
    (``launch/mesh.py::production_shape``, ``init_device_mesh("cpu", ...)``);
  * everything else under one ``FakeTensorMode`` (shapes and dtypes, no
    storage): ``Model.init`` (this process's shards), the inputs, and the
    step under :class:`~repro_torch.roofline.hlo_cost.CostCounter`, which
    gives the roofline's FLOPs, bytes and collective bytes and the step's
    live bytes.  Tensors read as CPU tensors, so the step takes the
    kernels' plain routes, as the reference's dry run lowers its non-TPU
    paths.

The step by kind: train, one ``make_train_step`` step (forward, backward,
AdamW) on the global batch, of which it runs this process's block
(``train/step.py::shard_batch``: over data x model, or where that does
not divide the batch over the data axes that do); prefill,
``forward(last_only=True)`` (``NIMBLE_PREFILL_FULL=1``: all positions);
decode, one ``make_serve_step`` step against a cache of the shape's
length at position length - 1.  Prefill and decode inputs are placed as
``sharding/specs.py::input_specs_sharding`` places them: over the data axes
where they divide, else replicated.

``bytes_per_device`` is the counterpart of ``memory_analysis()``:
``argument`` the step's inputs in this process (its shards of the
parameters, AdamW's moments, the batch, the cache), ``output`` what the step
returns, ``temp`` the peak of live bytes the step allocates beyond its
arguments, ``peak = argument + temp``.  ``compile_s`` holds the run's
seconds.  Records go to ``experiments/dryrun_torch/``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time
import traceback
from typing import Dict

import torch
import torch.distributed as dist

from ..configs.base import ARCH_IDS, INPUT_SHAPES, get_config
from ..jsonio import json_dumps
from ..models.registry import build_model
from ..optim import adamw
from ..roofline.analysis import analyze, count_params, model_flops
from ..roofline.hlo_cost import CostCounter, nbytes
from ..serve.engine import make_serve_step
from ..sharding.context import ParallelContext
from ..sharding.specs import input_specs_sharding, local_shard, mesh_coord, shard_params
from ..train.step import make_train_step
from ..tree import leaves
from .mesh import production_shape

OUT_DIR = os.path.join(os.path.dirname(__file__), "../../../experiments/dryrun_torch")


def make_ctx(mesh, multi_pod: bool, moe_mode: str = "nimble", *,
             experts: bool = True) -> ParallelContext:
    """The reference's context: EP 16 in groups of 4, bf16, remat.  A family
    without experts takes EP 1 (``build_model`` refuses experts to place)."""
    return ParallelContext(
        mesh=mesh,
        data_axes=("pod", "data") if multi_pod else ("data",),
        model_axis="model",
        ep_size=16 if experts else 1,
        group_size=4,
        moe_mode=moe_mode,
        param_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16,
        remat=True,
        device="cpu",
    )


def _storage_bytes(*trees) -> int:
    """Bytes of the distinct storages under ``trees`` (a view adds nothing)."""
    seen, total = set(), 0
    for t in leaves(list(trees)):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                total += st.nbytes()
    return total


def _fake_world(n_chips: int) -> None:
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("dryrun: a process group already exists; the dry run "
                           "starts its own fake world")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_chips)


def _local_inputs(specs: Dict[str, torch.Tensor], placement, mesh) -> Dict:
    """This process's block of each input (zeros of the global shape), placed
    by its batch dim's spec: the port holds the dense leaves replicated (no
    tensor parallelism), so a modality stub's width stays whole."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    coord = mesh_coord(mesh)
    return {k: local_shard(torch.zeros(s.shape, dtype=s.dtype),
                           placement[k][:1] + (None,) * (s.dim() - 1), sizes, coord)
            for k, s in specs.items()}


def _step(model, shape, params, mesh):
    """-> (the step, its arguments, their bytes in this process, the tokens
    that the step's model FLOPs count)."""
    ctx = model.ctx
    specs = model.input_specs(shape)
    if shape.kind == "train":
        opt = adamw.init(params)
        batch = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in specs.items()}
        step = make_train_step(model, adamw.AdamWConfig())
        # the step takes the global batch and reads this process's block of it
        count = ctx.row_block(shape.global_batch).count
        held = sum(nbytes(t) // count for t in batch.values())
        return (step, (params, opt, batch), _storage_bytes(params, opt) + held,
                shape.global_batch * shape.seq_len)
    placement = input_specs_sharding(specs, mesh, ctx.data_axes, shape.global_batch)
    inputs = _local_inputs(specs, placement, mesh)
    if shape.kind == "prefill":
        last_only = int(os.environ.get("NIMBLE_PREFILL_FULL", "0")) == 0

        @torch.no_grad()
        def prefill(params, batch):
            logits, _ = model.forward(params, batch, last_only=last_only)
            return logits[:, -1]
        args = (params, inputs)
        return prefill, args, _storage_bytes(args), shape.global_batch * shape.seq_len
    cache = model.init_cache(inputs["token"].shape[0], shape)
    serve = torch.no_grad()(make_serve_step(model))
    pos = max(model.cache_len(shape), 1) - 1
    args = (params, cache, inputs["token"], pos)
    return serve, args, _storage_bytes(args), shape.global_batch


def run_one(arch: str, shape_name: str, *, multi_pod: bool,
            moe_mode: str = "nimble", alt_frac: float = 0.5,
            cfg_overrides: Dict | None = None,
            ctx_overrides: Dict | None = None, attribute: bool = False) -> Dict:
    """One combo's record (``attribute``: keep the counter, for the breakdown,
    under the record's ``"_counter"``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh

    t0 = time.time()
    sizes = production_shape(multi_pod=multi_pod)
    n_chips = math.prod(sizes.values())
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = INPUT_SHAPES[shape_name]
    rec: Dict = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "mode": moe_mode,
    }
    if shape.name in cfg.skip_shapes:            # Model.supports
        rec["status"] = "skipped (DESIGN.md §7)"
        return rec
    if shape.name == "long_500k" and cfg.arch_type == "audio":
        rec["status"] = "skipped"
        return rec

    _fake_world(n_chips)
    try:
        mesh = init_device_mesh("cpu", tuple(sizes.values()),
                                mesh_dim_names=tuple(sizes))
        ctx = make_ctx(mesh, multi_pod, moe_mode, experts=cfg.arch_type == "moe")
        if alt_frac != 0.5:
            ctx = dataclasses.replace(ctx, moe_alt_frac=alt_frac)
        if ctx_overrides:
            ctx = dataclasses.replace(ctx, **ctx_overrides)
        model = build_model(cfg, ctx)
        with FakeTensorMode():
            full = model.mod.init(0, cfg, ctx)
            n_params = count_params(full)
            params = shard_params(full, ctx)
            del full
            step, args, argument, tokens = _step(model, shape, params, mesh)
            with CostCounter(attribute=attribute) as counter:
                out = step(*args)
            output = _storage_bytes(out)
    finally:
        dist.destroy_process_group()
    rec["n_params"] = n_params
    rec["bytes_per_device"] = {
        "argument": argument,
        "output": output,
        "temp": counter.temp_peak,
        "peak": argument + counter.temp_peak,
    }
    mf = model_flops(cfg, n_params, tokens, shape.kind)
    rec["roofline"] = analyze(counter.result(), n_chips, mf).as_dict()
    rec["status"] = "ok"
    rec["compile_s"] = round(time.time() - t0, 1)
    if attribute:
        rec["_counter"] = counter
    return rec


def _parse_kv(items):
    out = {}
    for it in items:
        k, v = it.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("True", "true"):
            v = True
        elif v in ("False", "false"):
            v = False
        out[k] = v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--moe-mode", default="nimble",
                    choices=["nimble", "direct", "stripe"])
    ap.add_argument("--alt-frac", type=float, default=0.5)
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="ModelConfig override, e.g. --set mlstm_chunk=64")
    ap.add_argument("--set-ctx", action="append", default=[], metavar="K=V",
                    help="ParallelContext override, e.g. --set-ctx remat=False")
    ap.add_argument("--tag", default="", help="suffix for the output json")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    if not args.all and args.arch is None:
        ap.error("give --arch (and --shape) or --all")

    cfg_overrides = _parse_kv(args.set)
    ctx_overrides = _parse_kv(args.set_ctx)
    os.makedirs(args.out, exist_ok=True)
    archs = ARCH_IDS[:-1] if args.all else [args.arch]  # paper-moe via chip_smoke
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]

    failures = 0
    for a in archs:
        for s in shapes:
            tag = f"{a}_{s}_{'2x16x16' if args.multi_pod else '16x16'}_{args.moe_mode}"
            if args.alt_frac != 0.5:
                tag += f"_alt{args.alt_frac}"
            if args.tag:
                tag += f"_{args.tag}"
            try:
                rec = run_one(a, s, multi_pod=args.multi_pod, moe_mode=args.moe_mode,
                              alt_frac=args.alt_frac, cfg_overrides=cfg_overrides,
                              ctx_overrides=ctx_overrides)
                if cfg_overrides or ctx_overrides:
                    rec["overrides"] = {**cfg_overrides,
                                        **{f"ctx.{k}": v for k, v in ctx_overrides.items()}}
            except Exception as e:   # a combo's failure is its record; the run goes on
                rec = {"arch": a, "shape": s, "status": "FAIL",
                       "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
                failures += 1
            with open(os.path.join(args.out, tag + ".json"), "wb") as f:
                f.write(json_dumps(rec, indent=True))
            print(format_line(rec), flush=True)
    return 1 if failures else 0


def format_line(rec: Dict) -> str:
    """The reference's one-line summary of a record."""
    roof = rec.get("roofline", {})
    return (f"[dryrun] {rec['arch']:24s} {rec['shape']:12s} {rec.get('status'):8s} "
            f"dom={roof.get('dominant', '-'):10s} "
            f"comp={roof.get('compute_s', 0):.3e}s "
            f"mem={roof.get('memory_s', 0):.3e}s "
            f"coll={roof.get('collective_s', 0):.3e}s "
            f"({rec.get('compile_s', '-')}s)")


if __name__ == "__main__":
    sys.exit(main())
