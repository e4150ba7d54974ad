"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds).  Libraries
go to ``csrc/build/`` under a name that carries a digest of the kernel's
source, every shared header (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt and a stale library is never loaded.  Nothing
is built when a module is imported: :func:`library` builds on first use and
:func:`build` builds several sources at once, one ``nvcc`` each, in
parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
KERNELS = ("token_gather", "token_scatter_add", "grouped_ffn", "flash_attention",
           "mlstm_scan", "relay_copy")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}

#: launches of each CUDA kernel; a wrapper adds one where it launches its
#: kernel, and nowhere else.  ``grouped_ffn_blocked`` and ``flash_attention``
#: count their bf16 tensor-core routes (the serving path's); the ``_f32``
#: names count their float32 CUDA-core routes.  ``token_scatter_index``
#: counts the inverse-index launch (``token_scatter_add`` makes one before
#: its row sums); ``mlstm_cummax_bwd`` counts the chunk body's cumulative-max
#: VJP (an entry of the ``mlstm_scan`` library); ``relay_copy`` counts its
#: TMA bulk route, ``relay_copy_w4`` and ``relay_copy_w2`` its 4- and 2-byte
#: word routes.
LAUNCHES: Dict[str, int] = {
    "token_gather": 0, "token_scatter_add": 0, "token_scatter_index": 0,
    "grouped_ffn_blocked": 0, "grouped_ffn_blocked_f32": 0, "flash_attention": 0,
    "flash_attention_f32": 0, "mlstm_scan": 0, "mlstm_cummax_bwd": 0, "relay_copy": 0,
    "relay_copy_w4": 0, "relay_copy_w2": 0}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, all at once.

    Returns the seconds taken (0.0 for a library that was already there).
    ``nvcc``'s register and shared-memory report goes to
    ``csrc/build/<name>.log``.  Raises with the compiler's output if a
    build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    took = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def library(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def function(lib: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point ``name`` of kernel library ``lib``, returning an int."""
    fn = getattr(library(lib), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
