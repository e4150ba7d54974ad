"""Fixtures of the benchmark's CPU tests: a cell of a small configuration,
its mix, limits and metric in a temporary folder, found by the harness as
the benchmark's own files are.

    python -m pytest -q chipbench/tests      # from the checkout's root
"""

import json
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
# the reference's rule on the CPU: the grouped FFN drops no row by capacity
os.environ["NIMBLE_FFN_IMPL"] = "scan"

#: a seed past 32 signed bits, as the driver's are
SEED = 2**31 + 11

TRAIN = {"kind": "train", "batch": 2, "seq": 64, "zipf_a": 1.2, "ngram_repeat": 0.3,
         "ngram_seed": 7, "pool": 4, "check_steps": 3,
         "optimizer": {"lr": 3e-4, "warmup_steps": 20, "total_steps": 100}}
PREFILL = {"kind": "prefill", "batch": 8, "seq": 64, "zipf_a": 1.2, "ngram_repeat": 0.3,
           "ngram_seed": 7, "pool": 4, "judge_serves": 4, "judge_rows_per_rank": 8}


def _write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj))


@pytest.fixture
def small(tmp_path):
    """(bench, dirs): BENCHMARK.json's metrics and limits over cells
    ``small.train`` and ``small.prefill`` of a small paper-moe-8e in
    ``dtype`` (float32 by default) in ``tmp_path``."""

    def make(dtype: str = "float32", n_layers: int = 1, capacity: float = 2.0):
        from chipbench import harness

        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        cfg = json.loads((ROOT / "chipbench/configs/paper-moe-8e.json").read_text())
        cfg["model"].update(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
                            n_layers=n_layers, moe_capacity_factor=capacity)
        cfg["parallel"].update(param_dtype=dtype, compute_dtype=dtype)
        _write(tmp_path / "configs/small.json", cfg)
        _write(tmp_path / "traffic/small.train.json", TRAIN)
        _write(tmp_path / "traffic/small.prefill.json", PREFILL)
        real = {"train": "paper-moe-8e.train.uniform", "prefill": "paper-moe-8e.prefill.zipf"}
        for kind, cell in real.items():
            lim = json.loads((ROOT / f"chipbench/limits/{cell}.json").read_text())
            if kind == "prefill":
                # a model this small spreads its logits less than the cell's: its
                # gaps are judged at 0.1, above its sound runs' (0 in float32) and
                # below its control's (0.45 in bfloat16)
                lim["gap"] = 0.1
            _write(tmp_path / f"limits/small.{kind}.json", lim)
        bench["configs"] = [{"name": "small", "file": str(tmp_path / "configs/small.json")}]
        bench["workloads"] = [{"name": f"small.{k}", "config": "small", "traffic": f"small.{k}",
                               "chips": 1} for k in real]
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m:
                m["workloads"] = [f"small.{k}" for k, c in real.items() if c in m["workloads"]]
        return bench, [tmp_path, harness.HERE]

    return make
