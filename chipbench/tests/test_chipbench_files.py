"""BENCHMARK.json against the benchmark's contract, and every entry found by
name; new configurations, mixes and metrics found without an edit."""

import json
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for p in b["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/") and ".." not in p
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in b[k]}) == len(b[k])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and UNIT.match(m["unit"]) and m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith(tuple(b["paths"]))
        assert any(w["config"] == c["name"] for w in b["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_every_cell_resolves_to_its_files(workload):
    from chipbench import harness

    b = bench()
    cell = harness.resolve(b, workload)
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer, "a cell reports at least one per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in e2e
        mod = harness.load_module(harness.HERE / "metrics" / f"{m['name']}.py")
        assert mod.read(None) is None          # nothing to read: no number
    assert set(cell.limits) and all(v >= 0 for v in cell.limits.values())
    assert cell.config["registry"] and cell.mix["kind"] in ("train", "prefill")


def test_a_new_config_mix_metric_and_kind_are_found_without_an_edit(tmp_path):
    from chipbench import harness

    b = bench()
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "limits").mkdir()
    (tmp_path / "kinds").mkdir()
    (tmp_path / "configs/newcfg.json").write_text(json.dumps({"registry": "x", "model": {}}))
    (tmp_path / "traffic/newmix.json").write_text(json.dumps({"kind": "newkind", "rate": 3}))
    (tmp_path / "limits/newcfg.newmix.json").write_text(json.dumps({"n": 0}))
    (tmp_path / "kinds/newkind.py").write_text("def run(*a):\n    return 'ran'\n")
    (tmp_path / "metrics/new.metric.py").write_text("def read(obs):\n    return obs * 2\n")
    b["configs"].append({"name": "newcfg", "source": "s",
                         "file": str(tmp_path / "configs/newcfg.json"), "reduced": [], "why": "w"})
    b["workloads"].append({"name": "newcfg.newmix", "config": "newcfg", "traffic": "newmix",
                           "chips": 1, "why": "w"})
    b["end_to_end"].append({"name": "new_rate", "unit": "1/s", "better": "higher",
                            "bound": 0.05, "source": "host_clock",
                            "workloads": ["newcfg.newmix"]})
    b["per_layer"].append({"name": "new.metric", "unit": "ms", "better": "lower",
                           "source": "program_span", "layer": "New", "moves": "new_rate"})
    cell = harness.resolve(b, "newcfg.newmix", dirs=[tmp_path, harness.HERE])
    assert cell.mix["rate"] == 3 and cell.limits == {"n": 0} and cell.kind.run() == "ran"
    assert sorted(m["name"] for m in cell.end_to_end) == ["new_rate", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["new.metric"]
    reader = harness.load_module(tmp_path / "metrics/new.metric.py")
    assert reader.read(21) == 42
    # the benchmark's own cells do not report the new metric
    assert "new.metric" not in [m["name"] for m in harness.resolve(
        b, b["workloads"][0]["name"]).per_layer]
