"""The port stands alone: no JAX, no ``repro``, and the card by default."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro  # noqa: F401  (the reference sits beside the port)
from repro_torch.sharding.context import SINGLE, ParallelContext

pytestmark = pytest.mark.torch_port

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
ROOT = PORT.parents[1]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {mod}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import pkgutil, importlib, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(PORT.parent))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_entry_points_default_to_the_card():
    import inspect

    from repro_torch.api import SessionSpec, TopologySpec
    from repro_torch.api import selfcheck
    from repro_torch.launch import fairness

    assert ParallelContext().device == "cuda"
    assert SINGLE.device == "cuda"
    assert SessionSpec(topology=TopologySpec(8, 4)).device == "cuda"
    for fn in list(fairness.SECTIONS.values()) + [fairness.mutual_drift_arm,
                                                  *selfcheck.CHECKS]:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
