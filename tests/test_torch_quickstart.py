"""The port's quickstart against the reference's ``examples/quickstart.py``.

Both run on the CPU as subprocesses (the flight recorder's correlation id
counts recorders per process): parts 1-3, the Session's plans on the
calibrated fabric simulator, the MWU gap to the congestion lower bound, the
flight-recorded adaptive run and the reduced granite forward, must print the
same lines.  Part 4 (``repro.analysis``) has no counterpart in the port yet.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parent.parent


def _run(*cmd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, *cmd], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.strip().split("\n\n")


@pytest.fixture(scope="module")
def outputs():
    return (_run("-m", "repro_torch.examples.quickstart", "--device", "cpu"),
            _run("examples/quickstart.py"))


def test_quickstart_parts_1_to_3_print_the_references_figures(outputs):
    got, want = outputs
    # topology, the hotspot sweep, the lower bound, the recorder, the model
    assert len(got) == len(want) == 6
    assert got[:5] == want[:5]
    assert "speedup" in got[1] and "finite=True" in got[4]


def test_quickstart_says_the_static_checker_is_not_ported(outputs):
    got, want = outputs
    assert want[5].startswith("static checker: 1 finding(s)")
    assert got[5].startswith("static checker: not in this package")
    assert len(got[5].splitlines()) == 1


def test_quickstart_defaults_to_the_card():
    from repro_torch.examples import quickstart

    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit):
        quickstart.main([])
