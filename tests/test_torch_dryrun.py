"""The port's dry run (``launch/dryrun.py``) against the reference's rules, on the CPU.

Each combo runs in this process, as rank 0 of a fake world (256 processes on
16 x 16, 512 on 2 x 16 x 16), over fake tensors, at the published widths
and 2 layers (the full depths trace in ``chip_smoke.py`` phase 26a, and
``test_torch_roofline.py`` counts every full-size model's parameters):
smollm-135m x the four shapes and granite-moe-1b-a400m x train_4k on 16 x
16, then granite x decode_32k (a second MoE model traced in the same
process: the planner's device tables must not outlive a fake mode),
smollm-135m x prefill_32k and x train_4k on 2 x 16 x 16 (train_4k's 256
sequences over pod x data, replicated over model: its MLP and logits
tensor-parallel), internvl2-2b x prefill_32k (its
patches placed by the batch dim only) and whisper-small x long_500k (a
skip); llama3-8b x train_4k at full depth on both meshes (the model
group's shared products against the reference's count).  Each record must have the reference's keys, its ``status`` rule, its
``n_params`` and ``model_flops_total`` (the reference's ``count_params`` of
``jax.eval_shape(model.init)`` and ``model_flops``), and leave no process
group behind.  Serving at full depth (llama3-8b x decode_32k and x
prefill_32k, smollm-135m x decode_32k) must count within the stated
factors of the reference's FLOPs and bytes a device.  smollm's train step must count, per device, the FLOPs of
the same step on one process without a mesh at the per-device batch [1,
4096]: the mesh adds collectives only (on 2 x 16 x 16, [8, 4096] with the
split products at 1/16 and 1 of the 9 heads); zamba2, qwen2.5-14b and
whisper-small at full depth must count within the stated factors of the
reference's FLOPs and bytes a device; and the ``all-reduce`` bytes of both
train steps are the gradients that ``train/step.py`` reduces, plus the
scalars it sums.  The CLI writes the records and a ``FAIL`` record (exit 1)
where a combo fails (a ``run_one`` made to raise).  ``chip_smoke.py``'s
``DRYRUN_PINNED`` (phase 26a)
must be the reference's values.
"""

import dataclasses
import json

import jax
import numpy as np
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
from repro_torch.roofline.hlo_cost import CostCounter
from repro_torch.sharding.context import ParallelContext
from repro_torch.train.step import make_train_step

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


def _one_process(arch: str, rows: int, **over):
    """The counter's result of the same train step on one process without a
    mesh at the batch [rows, 4096] (``over``: more config overrides)."""
    ctx = ParallelContext(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                          remat=True, device="cpu")
    model = build_model(dataclasses.replace(get_config(arch), **DEPTH, **over), ctx)
    with FakeTensorMode():
        params = model.init(0)
        specs = model.input_specs(InputShape("one", 4096, rows, "train"))
        batch = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in specs.items()}
        step = make_train_step(model, adamw.AdamWConfig())
        state = adamw.init(params)
        with CostCounter() as c:
            step(params, state, batch)
    return c.result()


def test_mesh_adds_collectives_only(records):
    """smollm's train step counts, per device, the FLOPs of the same step on
    one process without a mesh at the rows the device runs.  On 16 x 16,
    [1, 4096] (256 sequences over data x model): every product reads whole
    leaves, and the placement adds collectives only (AdamW's elementwise
    pass over blocks counts no FLOPs).  On 2 x 16 x 16, [8, 4096] (over pod
    x data, replicated over the 16 processes of a model group): the group
    shares the products it splits (``sharding/tp.py``), the MLP on d_ff
    1536 and the logits on vocab 49152, which count 1/16 of their
    one-process FLOPs, and the attention by uneven whole heads: this
    device, rank 0, runs 1 of the 9 query heads and the 1 KV head it reads.
    The one-process step on 1 head (and 1 KV head, of head dim 64) counts
    the rest; with d_ff and vocab cut by 16 as well it counts the rest and
    1/16 of the split products: the same FLOPs, by dtype too; the split
    products' own FLOPs are the difference's 16/15."""
    rec, _ = records[("smollm-135m", "train_4k", False)]
    one = _one_process("smollm-135m", 1)
    roof = rec["roofline"]
    assert roof["flops_per_device"] == one["flops"]
    assert roof["flops_by_dtype"] == one["flops_by_dtype"]
    assert one["collective_bytes"] == 0
    assert roof["coll_breakdown"]["all-gather"] > 0
    assert roof["coll_breakdown"]["reduce-scatter"] > 0

    rec, _ = records[("smollm-135m", "train_4k", True)]
    cfg = get_config("smollm-135m")
    head = dict(n_heads=1, n_kv_heads=1, head_dim_override=cfg.head_dim)
    one = _one_process("smollm-135m", 8, **head)
    cut = _one_process("smollm-135m", 8, d_ff=cfg.d_ff // 16, vocab=cfg.vocab // 16, **head)
    split = (one["flops"] - cut["flops"]) * 16 / 15
    rest = one["flops"] - split
    roof = rec["roofline"]
    assert split > 0 and rest > 0
    assert roof["flops_per_device"] == cut["flops"] == rest + split / 16
    assert roof["flops_by_dtype"] == cut["flops_by_dtype"]
    assert roof["coll_breakdown"]["all-reduce"] > 0


#: the reference's count of llama3-8b x train_4k on 2 x 16 x 16, a device:
#: ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.dryrun --arch
#: llama3-8b --shape train_4k --multi-pod`` (its ``cost_analysis`` FLOPs,
#: ``memory_analysis`` peak bytes)
REFERENCE_LLAMA_2X16X16_FLOPS = 130.70e12
REFERENCE_LLAMA_2X16X16_PEAK = 9.22e9


def test_llama3_8b_train_4k_model_group_shares_the_work():
    """llama3-8b x train_4k at full depth.  On 2 x 16 x 16 each process runs
    8 sequences that its model group of 16 holds replicated: the blocks'
    products split 16 ways (32 query heads; the 8 KV heads read whole, each
    process projecting the one its 2 heads read; d_ff 14336; vocab
    128256), so a device counts within 10% of the reference's FLOPs (the
    whole-leaf step: 2091.20 TFLOP, 133.27 GB); and it keeps for its
    backward what the reference does (attention's row statistics, not its
    scores; no float32 copy of a norm's input, nor the norms' outputs, nor
    the logits past a row chunk), peaking within 1.20 x the reference's.  Its all-reduces carry the group sums: in each of the 32
    layers two in the forward, the attention's again in remat's recompute,
    and two in the backward, each of [8, 4096, 4096] bf16.  On 16 x 16 (one
    sequence a process) nothing is tensor-parallel: the record is the
    tree's before."""
    rec = dryrun.run_one("llama3-8b", "train_4k", multi_pod=True)
    assert rec["status"] == "ok", rec.get("error")
    roof, mem = rec["roofline"], rec["bytes_per_device"]
    assert roof["flops_per_device"] <= 1.10 * REFERENCE_LLAMA_2X16X16_FLOPS
    assert mem["peak"] <= 1.20 * REFERENCE_LLAMA_2X16X16_PEAK
    assert roof["coll_breakdown"]["all-reduce"] >= 5 * 32 * 8 * 4096 * 4096 * 2
    assert not dist.is_initialized()
    rec = dryrun.run_one("llama3-8b", "train_4k", multi_pod=False)
    assert rec["roofline"]["flops_per_device"] == 260300787941376.0
    assert rec["bytes_per_device"]["argument"] == 931995648
    assert rec["bytes_per_device"]["peak"] == 5426241544
    assert rec["roofline"]["coll_breakdown"]["all-reduce"] == 131866756


#: the reference's counts of serving on 16 x 16, a device: ``PYTHONPATH=src
#: JAX_PLATFORMS=cpu python -m repro.launch.dryrun --arch A --shape S`` (its
#: ``cost_analysis`` FLOPs, ``memory_analysis`` argument and peak bytes)
REFERENCE_SERVE_16X16 = {
    ("llama3-8b", "decode_32k"): dict(flops=16.09e9, argument=2.34e9, peak=9.32e9),
    ("llama3-8b", "prefill_32k"): dict(flops=127.54e12, argument=0.19e9, peak=3.94e9),
    ("smollm-135m", "decode_32k"): dict(flops=1.27e9, argument=0.389e9, peak=1.39e9),
}
#: how far the port's count may lie above the reference's, by figure
SERVE_LIMITS = {
    ("llama3-8b", "decode_32k"): dict(flops=1.15, argument=1.10, peak=1.25),
    ("llama3-8b", "prefill_32k"): dict(flops=1.10, peak=2.0),
    ("smollm-135m", "decode_32k"): dict(argument=1.10),
}


@pytest.mark.parametrize("arch,shape", list(SERVE_LIMITS), ids=[
    f"{a}-{s}" for a, s in SERVE_LIMITS])
def test_serving_model_group_shares_the_work(arch, shape):
    """Serving at full depth on 16 x 16: a decode step's 128 rows, or a
    prefill's 32, over the 16 data processes (8 or 2 a process), replicated
    over each model group of 16, which shares the blocks' products
    (``sharding/tp.py``) and holds the KV cache split over it as the
    reference's ``build_cache_specs`` places it: llama3-8b's 8 KV heads and
    smollm's 3 do not divide by 16, so each process holds every head at
    2048 of the 32768 slots (``KVLayout`` "seq").  The FLOPs, the
    arguments (the parameters' and the cache's blocks) and the peak a
    device within :data:`SERVE_LIMITS` of the reference's counts (the step
    on whole leaves and a cache whole over model: llama3-8b decode 257.51
    GFLOP, 34.55 GB of arguments, a peak of 45.73 GB; its prefill 2040.70
    TFLOP, 73.61 GB; smollm's decode 6.06 GB of arguments)."""
    rec = dryrun.run_one(arch, shape, multi_pod=False)
    assert rec["status"] == "ok", rec.get("error")
    got = dict(flops=rec["roofline"]["flops_per_device"], **rec["bytes_per_device"])
    ref = REFERENCE_SERVE_16X16[(arch, shape)]
    for key, limit in SERVE_LIMITS[(arch, shape)].items():
        assert got[key] <= limit * ref[key], (key, got[key], ref[key])
    assert not dist.is_initialized()


#: the reference's counts a device of the combos whose work the model group
#: shared only from here on (``PYTHONPATH=src JAX_PLATFORMS=cpu python -m
#: repro.launch.dryrun --arch A --shape S [--multi-pod]``: its
#: ``cost_analysis`` FLOPs, ``memory_analysis`` argument and peak bytes)
REFERENCE_SHARED = {
    ("zamba2-1.2b", "train_4k", True): dict(flops=24.21e12, peak=30.63e9),
    ("qwen2.5-14b", "train_4k", True): dict(flops=261.60e12, peak=17.57e9),
    ("zamba2-1.2b", "decode_32k", False): dict(flops=0.0071e12, argument=0.85e9),
    ("whisper-small", "decode_32k", False): dict(flops=0.0215e12, peak=0.41e9),
}
#: how far the port's count may lie above the reference's, by figure
SHARED_LIMITS = {
    ("zamba2-1.2b", "train_4k", True): dict(flops=1.15, peak=1.00),
    ("qwen2.5-14b", "train_4k", True): dict(flops=1.15, peak=1.20),
    ("zamba2-1.2b", "decode_32k", False): dict(argument=1.10),
    ("whisper-small", "decode_32k", False): dict(flops=1.25),
}


@pytest.mark.parametrize("arch,shape,mp", list(SHARED_LIMITS), ids=[
    f"{a}-{s}-{'2x16x16' if mp else '16x16'}" for a, s, mp in SHARED_LIMITS])
def test_model_group_shares_uneven_heads_and_ssm_heads(arch, shape, mp):
    """At full depth, the model group of 16 shares what it computed whole
    before: qwen2.5-14b's 40 query heads over 16 (3 or 2 a process, cut
    from the leaves read whole; the whole-head step: 1482.05 TFLOP, 171.90
    GB), zamba2's Mamba layers by SSM heads (32 over 16), its shared
    block's heads, MLP and vocab (train: 387.27 TFLOP, 405.38 GB; decode
    13.19 GB of arguments: every process held its rows' whole conv, SSM
    and KV caches), whisper's decode on 12 heads over 16 (0.3425 TFLOP: the
    cross attention projected 1500 frames whole every step).  Each count a
    device within :data:`SHARED_LIMITS` of the reference's
    (``test_torch_dryrun_xlstm.py`` holds xlstm-125m the same way)."""
    rec = dryrun.run_one(arch, shape, multi_pod=mp)
    assert rec["status"] == "ok", rec.get("error")
    got = dict(flops=rec["roofline"]["flops_per_device"], **rec["bytes_per_device"])
    ref = REFERENCE_SHARED[(arch, shape, mp)]
    for key, limit in SHARED_LIMITS[(arch, shape, mp)].items():
        assert got[key] <= limit * ref[key], (key, got[key], ref[key])
    assert not dist.is_initialized()


def _param_tree(arch: str):
    """(config, the full parameter tree), fake, bf16, at the records' depth."""
    cfg = dataclasses.replace(get_config(arch), **DEPTH)
    with FakeTensorMode():
        params = build_model(cfg, ParallelContext(param_dtype=torch.bfloat16,
                                                  device="cpu")).init(0)
    return cfg, params


def _collective_bytes(cfg, params, sizes, uses):
    """The gathers' and the gradient reductions' bytes of one train step, from
    the specs (``sharding/gather.py``, ``train/step.py``): a leaf's gather
    counts each step's input (its block, then the block of the axes still to
    join; an expert leaf keeps its "model" block), its reduce-scatter each
    step's input, the other way round;
    ``uses(path)`` is how often the step reads a leaf: each layer once in
    the forward and once in remat's backward, a top-level leaf at each read.
    Then the all_reduce of each block over the axes that do not split it (the
    world at once, else one an axis) and AdamW's norm (f64, a leaf) over each
    axis that splits it."""
    from repro_torch.sharding.gather import gather_plan, norm_axes, reduce_axes, use_spec
    from repro_torch.sharding.specs import at_path, block_shape, build_param_specs, leaf_paths

    specs = build_param_specs(params, sizes)
    every = tuple(a for a, n in sizes.items() if n > 1)
    out = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
    for path, t in leaf_paths(params):
        spec = at_path(specs, path)
        lead = 1 if path[0] in ("blocks", "mamba", "enc", "dec") else 0
        use = use_spec(path, t.shape, spec)[lead:]
        cur = list(block_shape(tuple(t.shape)[lead:], spec[lead:], sizes))
        gathered = scattered = 0
        for dim, axis in gather_plan(use, sizes):
            gathered += int(np.prod(cur)) * t.element_size()
            cur[dim] *= sizes[axis]
        for dim, axis in reversed(gather_plan(use, sizes)):
            scattered += int(np.prod(cur)) * t.element_size()
            cur[dim] //= sizes[axis]
        n_gather, n_scatter = uses(path)
        out["all-gather"] += n_gather * gathered * (t.shape[0] if lead else 1)
        out["reduce-scatter"] += n_scatter * scattered * (t.shape[0] if lead else 1)
        axes = reduce_axes(spec, sizes)
        held = int(np.prod(block_shape(t.shape, spec, sizes))) * t.element_size()
        out["all-reduce"] += held * (1 if axes == every else len(axes))
        out["all-reduce"] += 8 * len(norm_axes(spec, sizes))
    return out


def test_all_reduce_bytes_are_the_reduced_gradients(records):
    """Every leaf and both AdamW moments held as the full specs' blocks:
    the step's all-gathers and reduce-scatters are the leaves' gathers on use
    and their backward (each layer twice forward under remat, once back; a
    tied embedding at each of its two reads), its all-reduces the blocks
    over the axes that do not split them, AdamW's norm over those that do,
    and the loss (f32); granite's router adds its two means (E f32 each)
    over the data and model groups in each forward (twice with remat) and
    the gradient of the second in the backward, and its dataplane gathers
    the EP ranks' counts at each dispatch.  No all_reduce sums a whole leaf's
    gradient any more."""
    sizes = {"data": 16, "model": 16}

    def uses(cfg):
        def n(path):
            if path[0] == "blocks":
                return 2, 1
            if path[0] == "embed" and cfg.tie_embeddings:
                return 2, 2
            return 1, 1
        return n

    rec, _ = records[("smollm-135m", "train_4k", False)]
    cfg, params = _param_tree("smollm-135m")
    want = _collective_bytes(cfg, params, sizes, uses(cfg))
    coll = rec["roofline"]["coll_breakdown"]
    assert coll["all-gather"] == want["all-gather"]
    assert coll["reduce-scatter"] == want["reduce-scatter"]
    assert coll["all-reduce"] == want["all-reduce"] + 4
    assert coll["collective-permute"] == 0

    rec, _ = records[("granite-moe-1b-a400m", "train_4k", False)]
    cfg, params = _param_tree("granite-moe-1b-a400m")
    want = _collective_bytes(cfg, params, sizes, uses(cfg))
    router = cfg.n_layers * (2 * 2 * 2 + 2) * cfg.n_experts * 4
    # the dataplane's count exchange: this process's [1, 16] int32 counts (EP
    # 16 over model 16), gathered at each dispatch (forward and remat's)
    counts = cfg.n_layers * 2 * 16 * 4
    coll = rec["roofline"]["coll_breakdown"]
    assert coll["all-gather"] == want["all-gather"] + counts
    assert coll["reduce-scatter"] == want["reduce-scatter"]
    assert coll["all-reduce"] == want["all-reduce"] + 4 + router
    assert coll["collective-permute"] > 0


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
