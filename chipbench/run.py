"""Run one cell of the port's benchmark once, on the card, and print its result.

    python3 chipbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic mix,
limits and metrics are found by name (``BENCHMARK.json``, then
``chipbench/harness.py``).  Set-up builds the model of ``repro_torch`` (the
PyTorch and CUDA port) from the configuration's file, makes its weights
and inputs from ``--seed`` on the card, and runs the mix's first batches;
the window then drives the mix for ``--seconds``.  With ``--trace 0`` the
last line of standard output carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled window.  After
the window the plain reference (``chipbench/reference/``) judges what the
window produced; each number compared is printed beside its limit, on
standard error and last in the result line.

Exits 2, printing no result, without a CUDA card (or with fewer than the
cell asks for), and 3 when a module of JAX or of the JAX package is loaded.
The kernels build once into ``src/repro_torch/csrc/build`` inside the
checkout; every later run loads them.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from chipbench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.resolve(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips}
    out = cell.kind.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or of the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    line, checks, err = harness.result(cell, out, bool(args.trace), device)
    if err:
        print(err, file=sys.stderr)
        return 1
    for c in checks:
        print(c, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
