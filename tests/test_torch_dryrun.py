"""The port's dry run (``launch/dryrun.py``) against the reference's rules, on the CPU.

Each combo runs in this process, as rank 0 of a fake world (256 processes on
16 x 16, 512 on 2 x 16 x 16), over fake tensors, at the published widths
and 2 layers (the full depths trace in ``chip_smoke.py`` phase 26a, and
``test_torch_roofline.py`` counts every full-size model's parameters):
smollm-135m x the four shapes and granite-moe-1b-a400m x train_4k on 16 x
16, then granite x decode_32k (a second MoE model traced in the same
process: the planner's device tables must not outlive a fake mode),
smollm-135m x prefill_32k and x train_4k on 2 x 16 x 16 (train_4k's 256
sequences over pod x data, replicated over model), internvl2-2b x
prefill_32k (its
patches placed by the batch dim only) and whisper-small x long_500k (a
skip).  Each record must have the reference's keys, its ``status`` rule, its
``n_params`` and ``model_flops_total`` (the reference's ``count_params`` of
``jax.eval_shape(model.init)`` and ``model_flops``), and leave no process
group behind.  smollm's train step must count, per device, the FLOPs of
the same step on one process without a mesh at the per-device batch [1,
4096]: the mesh adds collectives only; and the ``all-reduce`` bytes of both
train steps are the gradients that ``train/step.py`` reduces, plus the
scalars it sums.  The CLI writes the records and a ``FAIL`` record (exit 1)
where a combo fails (a ``run_one`` made to raise).  ``chip_smoke.py``'s
``DRYRUN_PINNED`` (phase 26a)
must be the reference's values.
"""

import dataclasses
import json

import jax
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.configs.base import get_config as j_get_config
from repro.models.registry import build_model as j_build_model
from repro.roofline.analysis import count_params as j_count_params
from repro.roofline.analysis import model_flops as j_model_flops
from repro.sharding.context import SINGLE as J_SINGLE
from repro_torch.configs.base import InputShape, get_config
from repro_torch.launch import dryrun
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw
from repro_torch.roofline.hlo_cost import CostCounter, nbytes
from repro_torch.sharding.context import ParallelContext
from repro_torch.sharding.specs import expert_leaf_mask
from repro_torch.train.step import make_train_step
from repro_torch.tree import leaves

pytestmark = pytest.mark.torch_port

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
DEPTH = {"n_layers": 2}          # the ModelConfig overrides of every combo
# (arch, shape, multi_pod)
COMBOS = ([("smollm-135m", s, False) for s in SHAPES]
          + [("granite-moe-1b-a400m", "train_4k", False),
             ("granite-moe-1b-a400m", "decode_32k", False),
             ("smollm-135m", "prefill_32k", True),
             ("smollm-135m", "train_4k", True),
             ("internvl2-2b", "prefill_32k", False),
             ("whisper-small", "long_500k", False)])
IDS = [f"{a}-{s}-{'2x16x16' if mp else '16x16'}" for a, s, mp in COMBOS]
OK_KEYS = {"arch", "shape", "mesh", "mode", "n_params", "bytes_per_device", "roofline",
           "status", "compile_s"}
SKIP_KEYS = {"arch", "shape", "mesh", "mode", "status"}
ROOF_KEYS = {"flops_per_device", "bytes_per_device", "coll_bytes_per_device",
             "coll_breakdown", "n_chips", "compute_s", "memory_s", "collective_s",
             "dominant", "model_flops_total", "useful_flops_ratio"}


@pytest.fixture(scope="module")
def records():
    """Every combo's record, in order, in this one process; and whether a
    process group was left after each."""
    out = {}
    for arch, shape, mp in COMBOS:
        rec = dryrun.run_one(arch, shape, multi_pod=mp, cfg_overrides=DEPTH)
        out[(arch, shape, mp)] = (rec, dist.is_initialized())
    return out


def _reference(arch: str, shape: str, over: dict):
    """(status, n_params, model_flops_total) by the reference's own rules."""
    cfg = dataclasses.replace(j_get_config(arch), **over)
    sh = J_SHAPES[shape]
    model = j_build_model(cfg, J_SINGLE)
    if not model.supports(sh):
        return "skipped (DESIGN.md §7)", None, None
    if sh.name == "long_500k" and cfg.arch_type == "audio":
        return "skipped", None, None
    n = j_count_params(jax.eval_shape(model.init, jax.random.PRNGKey(0)))
    tokens = sh.global_batch * (1 if sh.kind == "decode" else sh.seq_len)
    return "ok", n, j_model_flops(cfg, n, tokens, sh.kind)


@pytest.mark.parametrize("arch,shape,mp", COMBOS, ids=IDS)
def test_record_follows_the_reference(records, arch, shape, mp):
    rec, left = records[(arch, shape, mp)]
    assert not left, "a process group was left behind"
    status, n_params, mf = _reference(arch, shape, DEPTH)
    assert rec["status"] == status, rec.get("error")
    assert rec["mesh"] == ("2x16x16" if mp else "16x16") and rec["mode"] == "nimble"
    if status != "ok":
        assert set(rec) == SKIP_KEYS
        return
    assert set(rec) == OK_KEYS
    assert ROOF_KEYS <= set(rec["roofline"])
    assert rec["n_params"] == n_params
    assert rec["roofline"]["model_flops_total"] == mf
    assert rec["roofline"]["n_chips"] == (512 if mp else 256)
    mem = rec["bytes_per_device"]
    assert mem["peak"] == mem["argument"] + mem["temp"] and min(mem.values()) > 0
    assert rec["roofline"]["flops_per_device"] > 0


def test_no_process_group_is_left(records):
    assert not dist.is_initialized()
    assert not any(left for _, left in records.values())


def test_mesh_adds_collectives_only(records):
    """smollm's train step on 16 x 16 counts, per device, the FLOPs of the same
    step on one process without a mesh at the per-device batch [1, 4096]."""
    rec, _ = records[("smollm-135m", "train_4k", False)]
    ctx = ParallelContext(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                          remat=True, device="cpu")
    model = build_model(dataclasses.replace(get_config("smollm-135m"), **DEPTH), ctx)
    with FakeTensorMode():
        params = model.init(0)
        specs = model.input_specs(InputShape("one", 4096, 1, "train"))
        batch = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in specs.items()}
        step = make_train_step(model, adamw.AdamWConfig())
        state = adamw.init(params)
        with CostCounter() as c:
            step(params, state, batch)
    one = c.result()
    roof = rec["roofline"]
    assert roof["flops_per_device"] == one["flops"]
    assert roof["flops_by_dtype"] == one["flops_by_dtype"]
    assert one["collective_bytes"] == 0
    assert roof["coll_breakdown"]["all-reduce"] > 0


def _param_tree(arch: str):
    """(config, the full parameter tree's leaves, their expert-leaf mask), fake,
    bf16, at the records' depth."""
    cfg = dataclasses.replace(get_config(arch), **DEPTH)
    with FakeTensorMode():
        params = build_model(cfg, ParallelContext(param_dtype=torch.bfloat16,
                                                  device="cpu")).init(0)
    mask = expert_leaf_mask(params)
    return cfg, leaves(params), mask


def test_all_reduce_bytes_are_the_reduced_gradients(records):
    """train/step.py sums every replicated leaf's gradient over the world and
    each expert block's over the data axes (one all_reduce a bucket), then
    the loss (f32); AdamW's norm sums the expert blocks' squared norms (f64,
    one a leaf) over the model group; granite's router sums its two means
    (E f32 each) over the data and model groups in each forward (twice with
    remat) and the gradient of the second in the backward."""
    rec, _ = records[("smollm-135m", "train_4k", False)]
    _, ls, _ = _param_tree("smollm-135m")
    assert rec["roofline"]["coll_breakdown"]["all-reduce"] == sum(map(nbytes, ls)) + 4
    assert rec["roofline"]["coll_breakdown"]["collective-permute"] == 0

    rec, _ = records[("granite-moe-1b-a400m", "train_4k", False)]
    cfg, ls, mask = _param_tree("granite-moe-1b-a400m")
    model_procs = 16
    grads = sum(nbytes(t) // (model_procs if m else 1) for t, m in zip(ls, mask))
    norm = 8 * len(ls)
    router = cfg.n_layers * (2 * 2 * 2 + 2) * cfg.n_experts * 4
    assert rec["roofline"]["coll_breakdown"]["all-reduce"] == grads + 4 + norm + router
    assert rec["roofline"]["coll_breakdown"]["collective-permute"] > 0


def test_cli_writes_records_and_fails_a_combo_it_cannot_place(tmp_path, capsys, monkeypatch):
    """The reference's CLI: a record a combo, its one-line summary, and a
    ``FAIL`` record with the error and exit 1 where a combo fails (here a
    ``run_one`` made to raise: 2 x 16 x 16 places train_4k since the
    batch's rows go over the data axes that divide them)."""
    assert dryrun.main(["--arch", "smollm-135m", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "smollm-135m_long_500k_16x16_nimble.json").read_text())
    assert set(rec) == OK_KEYS and rec["status"] == "ok"
    assert "[dryrun] smollm-135m" in capsys.readouterr().out

    def cannot_place(arch, shape, **kw):
        raise ValueError(f"{arch} {shape} does not place on this mesh")

    monkeypatch.setattr(dryrun, "run_one", cannot_place)
    assert dryrun.main(["--arch", "smollm-135m", "--shape", "train_4k", "--multi-pod",
                        "--out", str(tmp_path)]) == 1
    rec = json.loads((tmp_path / "smollm-135m_train_4k_2x16x16_nimble.json").read_text())
    assert set(rec) == {"arch", "shape", "status", "error", "trace"}
    assert rec["status"] == "FAIL"
    assert rec["error"] == "ValueError: smollm-135m train_4k does not place on this mesh"
    assert "[dryrun] smollm-135m" in capsys.readouterr().out
    assert not dist.is_initialized()


def test_refuses_to_start_inside_a_process_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        with pytest.raises(RuntimeError, match="already exists"):
            dryrun.run_one("smollm-135m", "decode_32k", multi_pod=False)
    finally:
        dist.destroy_process_group()


def test_expert_free_context_on_any_mesh():
    """A family without experts takes ep_size 1 on a mesh of any model width;
    an MoE layer with ep_size 1 whose experts the mesh splits is refused."""
    from types import SimpleNamespace

    from repro_torch.models.moe import make_moe_ffn

    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(16, 16),
                           get_group=lambda axis: None)
    ctx = ParallelContext(mesh=mesh, ep_size=1, device="cpu")
    assert ctx.model_procs == 16 and ctx.data_procs == 16
    with pytest.raises(ValueError, match="does not divide ep_size"):
        ParallelContext(mesh=mesh, ep_size=8, device="cpu")
    with pytest.raises(ValueError, match="splits the experts"):
        make_moe_ffn(get_config("granite-moe-1b-a400m"), ctx)


def test_chip_smoke_pins_the_reference_s_records():
    """chip_smoke.py phase 26a holds the card machine's dry runs to these values."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_pins", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for (arch, shape), want in mod.DRYRUN_PINNED.items():
        status, n_params, mf = _reference(arch, shape, {})
        assert status == "ok"
        assert want == {"n_params": n_params, "model_flops_total": mf}
