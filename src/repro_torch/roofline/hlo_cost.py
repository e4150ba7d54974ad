"""Op-level cost counter: FLOPs, bytes and collective bytes of one step.

Counterpart of ``repro/roofline/hlo_cost.py``.  The reference parses the
optimized HLO text of a compiled step (``HloModule.analyze``); the port has
no HLO, so :class:`CostCounter` is a ``TorchDispatchMode`` that sees every
aten op the step dispatches (forward, autograd's backward and the
optimizer, on the card or over fake tensors alike) and returns the
reference's dict:

  * **flops** — torch's own formulas (``torch.utils.flop_counter``) for
    every op that has one (an in-place variant, ``addmm_``, its op's): the products and attention, as the reference
    counts its ``dot`` ops; also split by the operands' dtype
    (``flops_by_dtype``), since a float32 product runs at another peak;
  * **bytes** — each op's operand and result bytes, the counterpart of the
    reference's bytes at fusion boundaries (the port does not fuse, so every
    op is a boundary).  Views cost 0 (``view``, ``expand``, ``slice``,
    ``select``, ``transpose``, ``permute``, ``as_strided``, ``alias``, ...:
    any op whose result aliases an operand without writing it, the
    counterpart of ``_SKIP_BYTES_OPS``); so do allocations (``empty``).
    Reads are slice-accurate: ``index``, ``index_select``, ``gather``,
    ``embedding`` and ``take`` charge the rows they take, not the whole
    source (the dynamic-slice rule).  Writes into a slice charge the slice:
    ``copy_`` into a view (by the view's size), ``index_put_``,
    ``index_add_``, ``slice_scatter``, ``select_scatter`` and the scatters
    (the dynamic-update-slice rule).  An op that overwrites an operand
    (``copy_``, ``fill_``, ``zero_``, an ``out=`` argument) does not read it;
    one that returns no tensor (a query of a device or a size) costs 0;
  * **collectives** — each ``c10d`` op's operand bytes under the reference's
    five kind names.  ``send`` counts as ``collective-permute`` (the
    reference's dataplane moves hops by ``ppermute``, one operand a hop);
    its peer's ``recv_`` moves the same bytes and adds none;
  * **kernels** — the port's CUDA kernels run outside dispatch (``ctypes``),
    so each launch site reports its launch's FLOPs and bytes
    (``kernels/_build.py::report``, with ``chip_smoke.py``'s bound formula
    for that kernel).  ``uncounted`` is the launches (``_build.LAUNCHES``)
    made while the counter was open that reported nothing: it must be 0.

Loops in Python unroll, so every op is seen as often as it runs: the port
needs neither the reference's while-loop trip counts nor its
``unknown_loops``, and has no counterpart of either.

The counter also tracks live bytes (``temp_peak``): the most bytes of
storages allocated inside the step alive at once, a storage counting while
any tensor on it lives (views add nothing); storages the step received are
its arguments and are not counted.  With ``attribute=True`` it keeps, for
``roofline/breakdown.py``, each op's bytes by where it was dispatched: the
innermost frame under ``src/repro_torch/``; and each live storage's bytes by
the site that allocated it, the set live at ``temp_peak`` in ``peak_sites``
(a new peak's set is taken at the first free after it, when the live bytes
are still the peak's).
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import weakref
from collections import defaultdict
from typing import Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from ..kernels import _build

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: c10d op (as ``torch.distributed`` dispatches it) -> (kind, index of the
#: operand whose bytes count; None: adds none)
_C10D = {
    "allreduce_": ("all-reduce", 0), "_allgather_base_": ("all-gather", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1), "alltoall_base_": ("all-to-all", 1),
    "send": ("collective-permute", 0), "recv_": ("collective-permute", None),
}
_DTYPES = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
           torch.float64: "f64"}
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}
#: ops that write operand 0 without reading it
_OVERWRITE = {"copy_", "fill_", "zero_"}
#: reads that take rows of operand 0 by an index
_GATHERS = {"index", "index_select", "gather", "embedding", "take"}
#: writes into a slice of operand 0: op -> the operand that sets the slice's
#: size ("index": index_put's indices), and whether the slice is also read
_SCATTERS = {
    "index_put_": ("index", False), "index_put": ("index", False),
    "_index_put_impl_": ("index", False),
    "index_add_": (3, True), "index_add": (3, True),
    "slice_scatter": (1, False), "select_scatter": (1, False),
    "scatter_add_": (2, True), "scatter_add": (2, True),
}
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SELF = os.path.dirname(os.path.abspath(__file__))


def dtype_name(dtype: torch.dtype) -> str:
    return _DTYPES.get(dtype, str(dtype).replace("torch.", ""))


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x, out=None) -> list:
    """The tensors in ``x`` (nested lists, tuples and dicts), in order."""
    if out is None:
        out = []
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


@functools.lru_cache(maxsize=None)
def _aliasing(func) -> Tuple[bool, bool]:
    """(a view: a result aliases an operand unwritten, a result aliases an operand)."""
    infos = [r.alias_info for r in func._schema.returns]
    return (any(a is not None and not a.is_write for a in infos),
            any(a is not None for a in infos))


@functools.lru_cache(maxsize=None)
def _flop_formula(packet):
    """torch's FLOP formula of an op, an in-place variant (``addmm_``) taking
    its op's."""
    formula = flop_registry.get(packet)
    if formula is None and packet.__name__.endswith("_"):
        base = getattr(torch.ops.aten, packet.__name__[:-1], None)
        formula = None if base is None else flop_registry.get(base)
    return formula


def _write_only(func, args, kwargs) -> set:
    """ids of the operands this op overwrites without reading."""
    name = func.overloadpacket.__name__
    out = {id(v) for k, v in kwargs.items() if k.startswith("out")
           and isinstance(v, torch.Tensor)}
    if name in _OVERWRITE and args and isinstance(args[0], torch.Tensor):
        out.add(id(args[0]))
    return out


def _slice_elems(which, args) -> int:
    """Elements of operand 0 that a scatter-like op writes."""
    dest = args[0]
    if which == "index":                     # index_put: the indexed positions
        indices = args[1]
        idx = [i for i in indices if i is not None]
        if not idx:
            return dest.numel()
        n = torch.broadcast_shapes(*(i.shape for i in idx)).numel()
        for d in range(len(indices), dest.dim()):
            n *= dest.shape[d]
        return n
    return args[which].numel()


def op_bytes(func, args, kwargs, out) -> float:
    """HBM bytes of one dispatched op, by the rules of the module docstring."""
    name = func.overloadpacket.__name__
    if name in _FREE or _aliasing(func)[0]:
        return 0.0
    outs = _tensors(out)
    if not outs:                              # a query of metadata (``device``, sizes)
        return 0.0
    ins = _tensors((args, kwargs))
    if name in _GATHERS:
        src = args[0]
        taken = sum(nbytes(t) for t in outs)
        index = sum(nbytes(t) for t in ins[1:])
        return float(min(nbytes(src), taken) + index + taken)
    if name in _SCATTERS:
        which, accumulate = _SCATTERS[name]
        dest = args[0]
        region = _slice_elems(which, args) * dest.element_size()
        others = sum(nbytes(t) for t in ins if t is not dest)
        if name.startswith("index_put") or name == "_index_put_impl_":
            accumulate = bool(args[3] if len(args) > 3 else kwargs.get("accumulate", False))
        return float(others + region * (2 if accumulate else 1))
    skip = _write_only(func, args, kwargs)
    seen, total = set(), 0
    for t in ins:
        if id(t) in seen or id(t) in skip:
            continue
        seen.add(id(t))
        total += nbytes(t)
    written = set()
    for t in outs:
        if id(t) not in written:
            written.add(id(t))
            total += nbytes(t)
    return float(total)


def _site() -> str:
    """``module.function:line`` of the innermost frame under ``src/repro_torch/``
    (outside this package's counter), or ``"?"``."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_PKG) and not path.startswith(_SELF) \
                and not path.endswith("_build.py"):
            mod = os.path.relpath(path, _PKG)[:-3].replace(os.sep, ".")
            return f"{mod}.{f.f_code.co_name}:{f.f_lineno}"
        f = f.f_back
    return "?"


class CostCounter(TorchDispatchMode):
    """Counts what a step dispatches; ``result()`` is the reference's dict.

    Use it as a context manager around the step (inside a ``FakeTensorMode``
    for an abstract count, or on the card for a real one)::

        with CostCounter() as c:
            step(params, opt_state, batch)
        c.result()["flops"], c.temp_peak
    """

    def __init__(self, *, attribute: bool = False):
        super().__init__()
        self.attribute = attribute
        self.flops_by_dtype: Dict[str, float] = defaultdict(float)
        self.bytes = 0.0
        self.collectives: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.kernels: Dict[str, list] = {}       # name -> [launches, flops, bytes]
        self.live = 0
        self.temp_peak = 0
        self.rows: Dict[Tuple[str, str], list] = defaultdict(lambda: [0.0, 0.0, 0])
        self.coll_rows: Dict[Tuple[str, str], list] = defaultdict(lambda: [0.0, 0])
        self._storages = WeakIdKeyDictionary()   # storage -> True if allocated here
        #: (attribute) site -> [bytes, storages] live now, and at temp_peak
        self.live_sites: Dict[str, list] = defaultdict(lambda: [0, 0])
        self.peak_sites: Dict[str, list] = {}
        self._peak_open = False
        self._paused = 0
        self._launches0: Dict[str, int] = {}
        self.uncounted = 0

    # -- the mode ------------------------------------------------------------------
    def __enter__(self):
        self._launches0 = dict(_build.LAUNCHES)
        _build.COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _build.COUNTERS.remove(self)
        self._take_peak()
        reported = {k: v[0] for k, v in self.kernels.items()}
        self.uncounted = sum(
            _build.LAUNCHES[k] - self._launches0.get(k, 0) - reported.get(k, 0)
            for k in _build.LAUNCHES)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def paused(self):
        """Ops dispatched inside are not counted (a launch's own cost arithmetic)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._paused:
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            self._collective(func, args)
            return out
        flops = 0.0
        formula = _flop_formula(func.overloadpacket)
        if formula is not None:
            flops = float(formula(*args, **kwargs, out_val=out))
            self.flops_by_dtype[dtype_name(_tensors((args, kwargs))[0].dtype)] += flops
        b = op_bytes(func, args, kwargs, out)
        self.bytes += b
        site = _site() if self.attribute else None
        # a result that aliases an operand (a view, an in-place or out= op)
        # lies on a storage allocated before, here or outside the step
        fresh = not _aliasing(func)[1]
        for t in _tensors(out):
            self._track(t, fresh, site)
        if self.attribute:
            row = self.rows[(site, func.overloadpacket.__name__)]
            row[0] += b
            row[1] += flops
            row[2] += 1
        return out

    def _collective(self, func, args) -> None:
        kind, which = _C10D.get(func.overloadpacket.__name__, (None, None))
        if kind is None or which is None:
            return
        b = float(sum(nbytes(t) for t in _tensors(args[which])))
        self.collectives[kind] += b
        if self.attribute:
            row = self.coll_rows[(_site(), kind)]
            row[0] += b
            row[1] += 1

    def _track(self, t: torch.Tensor, allocated: bool, site=None) -> None:
        """Note ``t``'s storage; one ``allocated`` by this op counts as live
        until it is freed (under ``site``, when attributing), one seen first
        as an alias is an argument's."""
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        if st in self._storages:
            return
        self._storages[st] = allocated
        if allocated:
            n = st.nbytes()
            self.live += n
            if self.live > self.temp_peak:
                self.temp_peak = self.live
                self._peak_open = self.attribute
            if site is None:
                weakref.finalize(st, self._free, n)
            else:
                row = self.live_sites[site]
                row[0] += n
                row[1] += 1
                weakref.finalize(st, self._free, n, site)

    def _take_peak(self) -> None:
        """Keep the live set as ``peak_sites`` if it is a new peak's."""
        if self._peak_open:
            self.peak_sites = {k: list(v) for k, v in self.live_sites.items() if v[1]}
            self._peak_open = False

    def _free(self, n: int, site=None) -> None:
        self._take_peak()
        self.live -= n
        if site is not None:
            row = self.live_sites[site]
            row[0] -= n
            row[1] -= 1

    # -- kernels ---------------------------------------------------------------------
    def launched(self, name: str,
                 cost: Callable[[], Tuple[float, float, torch.dtype]]) -> None:
        """One launch of kernel ``name``; ``cost()`` -> (flops, bytes, operand dtype)."""
        with self.paused():
            flops, b, dt = cost()
        k = self.kernels.setdefault(name, [0, 0.0, 0.0])
        k[0] += 1
        k[1] += flops
        k[2] += b
        self.bytes += b
        if flops:
            self.flops_by_dtype[dtype_name(dt)] += flops
        if self.attribute:
            row = self.rows[(_site(), f"kernel {name}")]
            row[0] += b
            row[1] += flops
            row[2] += 1

    # -- the result --------------------------------------------------------------------
    def result(self) -> Dict:
        """The reference's ``analyze`` dict, plus ``flops_by_dtype``, ``uncounted``,
        ``kernels`` and ``temp_peak``."""
        return {
            "flops": float(sum(self.flops_by_dtype.values())),
            "bytes": self.bytes,
            "collectives": dict(self.collectives),
            "collective_bytes": float(sum(self.collectives.values())),
            "flops_by_dtype": dict(self.flops_by_dtype),
            "uncounted": self.uncounted,
            "kernels": {k: {"launches": v[0], "flops": v[1], "bytes": v[2]}
                        for k, v in self.kernels.items()},
            "temp_peak": self.temp_peak,
        }
