"""Host syncs on a step's path: where the host waits for the card, and
which of those waits track the plan.

Counterpart of ``repro/analysis/provenance.py``.  The reference classifies
the values that reach a JAX trace boundary (jit statics, Pallas arguments,
scan carries, slot schedules), since a plan-dependent one there forces a
retrace.  The port has no tracing; its counterpart of a trace boundary is a
**host sync**: a call that makes the host wait for the card to hand back a
value.  A step with one cannot be captured as a CUDA graph and leaves the
card idle while the host reads, and a sync whose value tracks the plan
comes back on every step.  The sites:

  * explicit reads: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``.to("cpu")`` (and ``torch.equal``/``allclose``, which return a host
    bool), on anything not known to be a numpy array;
  * ``int()``, ``float()`` or ``bool()`` of a tensor expression;
  * the ops whose output size is data (``torch.nonzero``, ``argwhere``,
    ``unique``, ``masked_select``, a one-argument ``where``) and
    ``torch.bincount``: on the card it reads its input's largest value on
    the host, ``minlength`` or not;
  * an ``if``/``while``/``assert`` test, or a conditional expression's,
    on a tensor expression;
  * uploads, which copy pageable host memory and wait for the copy:
    ``torch.tensor``/``as_tensor``/``from_numpy`` given a ``device=``, a
    host-made tensor's ``.to(<device>)``/``.cuda()``, and a Python value
    stored into a tensor (``t[i] = x``);
  * ``torch.cuda.synchronize()``.

A site counts only in a function that the call graph reaches from the step
entry points (``context.STEP_ENTRY_POINTS`` and the autograd Functions of
``kernels/``; :meth:`~repro_torch.analysis.callgraph.Program.reachable`).
Each takes the reference's lattice, with the reference's seeds

    TOPOLOGY_STABLE  ⊑  WINDOW_DEPENDENT  ⊑  PLAN_DEPENDENT

(the value synced is fixed by the cluster geometry and the config; changes
per telemetry window; or changes with every plan or routing), by the
reference's bounded interprocedural fixpoint over the
:class:`~repro_torch.analysis.callgraph.Program` summaries: every site
goes into the ``nimble.retrace/v1`` inventory with the boundary kind
``host-sync``, and the PLAN_DEPENDENT ones are findings.  A tensor
expression is known locally: a ``torch.*`` call's result, a method of a
tensor (or a method only tensors have), an arithmetic or comparison over
one, a name bound to one or a parameter annotated ``torch.Tensor``, an
item by name of a parameter annotated ``Dict[str, torch.Tensor]``.  The
card checks the list: ``launch/sync_audit.py`` records the syncs of a real
train step and decode step and fails on one outside the inventory.

``retrace.lock.json`` (``nimble.retrace_lock/v1``) pins the inventory
with line-free keys, so a new host read on a step's path makes the lock
stale.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, List, Optional, Set, Tuple

from ..jsonio import read_json_file, tag, write_json_file
from .callgraph import Program, module_name_of
from .context import FileContext

RETRACE_KIND = "retrace"
RETRACE_LOCK_KIND = "retrace_lock"

#: the inventory's boundary kind for a host sync
HOST_SYNC = "host-sync"

# -- the lattice -----------------------------------------------------------------

TOPOLOGY_STABLE = "TOPOLOGY_STABLE"
WINDOW_DEPENDENT = "WINDOW_DEPENDENT"
PLAN_DEPENDENT = "PLAN_DEPENDENT"

_ORDER = {TOPOLOGY_STABLE: 0, WINDOW_DEPENDENT: 1, PLAN_DEPENDENT: 2}


def join(a: str, b: str) -> str:
    """Least upper bound — plan-dependence absorbs everything below it."""
    return a if _ORDER[a] >= _ORDER[b] else b


# -- seeds (the reference's) -----------------------------------------------------

#: callables whose return value IS the plan (or a plan artifact): the
#: Algorithm-1 solvers, the planner entry points, the dataplane chunk
#: schedulers.  Matched by basename so wrappers inherit via the
#: interprocedural pass, not by listing.
PLAN_RETURNING = {
    "solve_mwu", "solve_direct", "solve_static_striping", "solve_degraded",
    "plan_from_flows", "apply_plan_fractions",
    "plan_flows", "plan_flows_batch", "quantize_chunks",
    "plan_chunks_jit", "plan_chunks_batch_jit",
    "solve_plans_batch", "plan_batch", "plan_from_counts", "plan_batched",
    "_plan",
}

#: identifier tokens (underscore-split, exact match) that seed a class
#: when no call-site evidence exists.  Deliberately exact: ``block_chunk``
#: (a block *size*) must not match ``chunks`` (a chunk *schedule*).
PLAN_TOKENS = {"plan", "plans", "flow", "flows", "chunks", "slots"}
WINDOW_TOKENS = {
    "window", "windows", "price", "prices", "telemetry",
    "demand", "demands", "load", "loads", "staleness",
}

#: attribute accesses that read metadata: reading shape metadata off a
#: plan-dependent tensor yields geometry, not plan (and no sync)
_METADATA_ATTRS = {"shape", "dtype", "ndim", "size"}


def classify_name(name: str) -> str:
    tokens = set(name.lower().split("_"))
    if tokens & PLAN_TOKENS:
        return PLAN_DEPENDENT
    if tokens & WINDOW_TOKENS:
        return WINDOW_DEPENDENT
    return TOPOLOGY_STABLE


# -- tensor expressions ----------------------------------------------------------

#: ``torch.<sub>`` namespaces and ``torch.*`` callables that return no tensor
_TORCH_NON_TENSOR_NS = {
    "cuda", "distributed", "autograd", "utils", "testing", "backends",
    "profiler", "library", "jit", "fx", "compiler", "overrides", "hub",
}
_TORCH_NON_TENSOR = {
    "torch.device", "torch.dtype", "torch.Size", "torch.Generator",
    "torch.is_tensor", "torch.is_grad_enabled", "torch.no_grad",
    "torch.enable_grad", "torch.inference_mode", "torch.set_grad_enabled",
    "torch.get_default_dtype", "torch.finfo", "torch.iinfo", "torch.compile",
    "torch.manual_seed", "torch.numel", "torch.is_floating_point",
    "torch.is_complex", "torch.promote_types", "torch.result_type",
    "torch.equal", "torch.allclose",
}
#: methods that return host values or metadata
_NON_TENSOR_METHODS = {
    "item", "tolist", "numpy", "dim", "numel", "nelement", "size",
    "element_size", "data_ptr", "stride", "is_contiguous", "is_floating_point",
    "get_device", "untyped_storage", "storage_offset", "equal", "allclose",
    "is_set_to", "is_pinned",
}
#: methods only tensors have: a call of one is a tensor, whatever its base
_TENSOR_METHODS = {
    "float", "double", "half", "bfloat16", "long", "int", "short", "bool",
    "to", "cuda", "detach", "clone", "contiguous", "view_as", "masked_fill",
    "index_select", "index_add", "index_add_", "index_put", "index_put_",
    "new_zeros", "new_ones", "new_empty", "new_full", "new_tensor",
    "type_as", "expand", "expand_as", "unsqueeze", "permute", "narrow",
    "softmax", "log_softmax", "sigmoid", "exp", "log", "sqrt", "rsqrt",
    "pow", "eq", "ne", "lt", "le", "gt", "ge", "isfinite", "isnan", "norm",
    "amax", "amin", "logical_and", "logical_or", "logical_not", "cumsum",
    "repeat_interleave", "scatter", "scatter_add", "scatter_add_",
}
#: attributes of a tensor that are tensors
_TENSOR_ATTRS = {"T", "mT", "grad", "data", "real", "imag"}

#: explicit host reads (method spellings)
_READ_METHODS = {"item", "tolist", "cpu", "numpy", "equal", "allclose"}
#: ops whose output size is data, and bincount (its largest value)
_SHAPE_OPS = {
    "torch.nonzero": "nonzero", "torch.argwhere": "argwhere",
    "torch.unique": "unique", "torch.unique_consecutive": "unique",
    "torch.masked_select": "masked_select", "torch.bincount": "bincount",
    "torch.equal": "equal", "torch.allclose": "allclose",
}
_HOST_CASTS = {"int", "float", "bool"}
#: builtins that return a Python number
_SCALAR_CALLS = {"int", "float", "bool", "len", "round", "abs", "min", "max",
                 "sum", "math.prod", "math.ceil", "math.floor", "math.sqrt"}
#: tensor makers: with ``device=`` an upload, without one a host tensor
_MAKERS = {"torch.tensor", "torch.as_tensor", "torch.from_numpy"}


def _is_cpu(ctx: FileContext, node: ast.AST) -> bool:
    """A ``"cpu"`` device literal, or ``torch.device("cpu")``."""
    if ctx.string_value(node) == "cpu":
        return True
    return (
        isinstance(node, ast.Call)
        and ctx.resolve(node.func) == "torch.device"
        and bool(node.args)
        and ctx.string_value(node.args[0]) == "cpu"
    )


class _Types:
    """Which local names of one function hold tensors, and which numpy
    arrays (two forward passes over its assignments in source order)."""

    def __init__(self, ctx: FileContext, node: ast.AST):
        self.ctx = ctx
        self.tensors: Set[str] = set()
        self.arrays: Set[str] = set()
        self.host: Set[str] = set()          # tensors made on the host
        self.tensor_dicts: Set[str] = set()  # Dict[str, torch.Tensor]
        self.scalars: Set[str] = set()       # Python numbers
        args = getattr(node, "args", None)
        for a in (args.posonlyargs + args.args + args.kwonlyargs) if args else ():
            if a.annotation is None:
                continue
            if self._annotated_tensor(a.annotation):
                self.tensors.add(a.arg)
            elif self._annotated_tensor_dict(a.annotation):
                self.tensor_dicts.add(a.arg)
            elif self.ctx.resolve(a.annotation) in ("int", "float", "bool"):
                self.scalars.add(a.arg)
        stmts = sorted(
            (n for n in ast.walk(node)
             if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign,
                               ast.NamedExpr))),
            key=lambda n: (n.lineno, n.col_offset),
        )
        for _ in range(2):
            for stmt in stmts:
                if stmt.value is None:
                    continue
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                for t in targets:
                    self._bind(t, stmt.value)

    def _annotated_tensor(self, ann: ast.AST) -> bool:
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            return ann.value in ("torch.Tensor", "Tensor")
        return self.ctx.resolve(ann) == "torch.Tensor"

    def _annotated_tensor_dict(self, ann: ast.AST) -> bool:
        """``Dict[str, torch.Tensor]``, spelled out or by a module alias."""
        if isinstance(ann, ast.Name):
            for stmt in self.ctx.tree.body:
                if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                        and isinstance(stmt.targets[0], ast.Name)
                        and stmt.targets[0].id == ann.id):
                    ann = stmt.value
                    break
        return (
            isinstance(ann, ast.Subscript)
            and (self.ctx.resolve(ann.value) or "").rsplit(".", 1)[-1] in ("Dict", "dict")
            and isinstance(ann.slice, ast.Tuple)
            and len(ann.slice.elts) == 2
            and self._annotated_tensor(ann.slice.elts[1])
        )

    def host_made(self, node: ast.AST) -> bool:
        """A tensor made on the host: ``torch.tensor``/``as_tensor``/
        ``from_numpy`` with no ``device=``, a ``.cpu()``, or a numpy array."""
        if isinstance(node, ast.Name):
            return node.id in self.host or node.id in self.arrays
        if self.array(node):
            return True
        if isinstance(node, ast.Call):
            target = self.ctx.resolve(node.func)
            if target in _MAKERS:
                return not any(kw.arg == "device" for kw in node.keywords)
            if isinstance(node.func, ast.Attribute) and node.func.attr == "cpu":
                return True
        return False

    def _bind(self, target: ast.AST, value: ast.AST) -> None:
        names = _target_names(target)
        if isinstance(target, (ast.Tuple, ast.List)):
            # a tuple of tensors from a tensor-returning call
            is_t = self.tensor(value) or (
                isinstance(value, ast.Call)
                and (self.ctx.resolve(value.func) or "").startswith("torch.")
            )
            is_a = False
        else:
            is_t, is_a = self.tensor(value), self.array(value)
        single = not isinstance(target, (ast.Tuple, ast.List))
        is_h = single and self.host_made(value)
        is_s = single and self.scalar(value)
        for n in names:
            if is_s:
                self.scalars.add(n)
            if is_t:
                self.tensors.add(n)
            if is_a:
                self.arrays.add(n)
            if is_h:
                self.host.add(n)

    def scalar(self, node: ast.AST) -> bool:
        """A Python number: a numeric literal, a name bound to one, a
        parameter annotated ``int``/``float``/``bool``, ``int()``/
        ``float()``/``len()``/... of anything, arithmetic over them."""
        if isinstance(node, ast.Constant):
            return isinstance(node.value, (int, float)) and node.value is not None
        if isinstance(node, ast.Name):
            return node.id in self.scalars
        if isinstance(node, ast.BinOp):
            return self.scalar(node.left) and self.scalar(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.scalar(node.operand)
        if isinstance(node, ast.Call):
            return self.ctx.resolve(node.func) in _SCALAR_CALLS
        return False

    def array(self, node: ast.AST) -> bool:
        """A numpy array, by its making: a ``numpy.*`` call or ``.numpy()``."""
        if isinstance(node, ast.Name):
            return node.id in self.arrays
        if isinstance(node, ast.Subscript):
            return self.array(node.value)
        if isinstance(node, ast.Call):
            target = self.ctx.resolve(node.func) or ""
            if target.startswith("numpy."):
                return True
            if isinstance(node.func, ast.Attribute):
                if node.func.attr == "numpy":
                    return True
                if node.func.attr in ("astype", "copy", "reshape", "sum"):
                    return self.array(node.func.value)
        if isinstance(node, ast.BinOp):
            return self.array(node.left) or self.array(node.right)
        return False

    def tensor(self, node: ast.AST) -> bool:
        ctx = self.ctx
        if isinstance(node, ast.Name):
            return node.id in self.tensors
        if isinstance(node, ast.Call):
            target = ctx.resolve(node.func)
            if target is not None and target.startswith("torch."):
                ns = target.split(".")[1]
                return ns not in _TORCH_NON_TENSOR_NS and target not in _TORCH_NON_TENSOR
            if isinstance(node.func, ast.Attribute):
                meth = node.func.attr
                if meth in _NON_TENSOR_METHODS or self.array(node.func.value):
                    return False
                if meth in _TENSOR_METHODS:
                    return True
                return self.tensor(node.func.value)
            return False
        if isinstance(node, ast.Attribute):
            return node.attr in _TENSOR_ATTRS and self.tensor(node.value)
        if isinstance(node, ast.Subscript):
            if (isinstance(node.value, ast.Name) and node.value.id in self.tensor_dicts
                    and isinstance(node.slice, ast.Constant)):
                return True
            return self.tensor(node.value)
        if isinstance(node, ast.BinOp):
            return self.tensor(node.left) or self.tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.tensor(node.operand)
        if isinstance(node, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return any(self.tensor(o) for o in [node.left, *node.comparators])
        if isinstance(node, ast.BoolOp):
            return any(self.tensor(v) for v in node.values)
        if isinstance(node, ast.IfExp):
            return self.tensor(node.body) or self.tensor(node.orelse)
        return False


def _target_names(target: ast.AST) -> List[str]:
    """The names an assignment target binds (not those it subscripts)."""
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for elt in target.elts for n in _target_names(elt)]
    if isinstance(target, ast.Starred):
        return _target_names(target.value)
    return []


def _text(node: Optional[ast.AST], limit: int = 60) -> str:
    """A line-free spelling of ``node`` for a site's key (``:`` -> ``|``)."""
    if node is None:
        return ""
    text = ast.unparse(node).replace(":", "|").replace("\n", " ")
    return text if len(text) <= limit else text[: limit - 3] + "..."


#: calls whose function arguments run off a step: a launch's cost, called
#: only while a roofline counter is open (``kernels/_build.py::report``)
DEFERRED_CALLS = {"repro_torch.kernels._build.report"}


def _on_cpu(ctx: FileContext, test: ast.AST) -> bool:
    """``<t>.device.type == "cpu"``, alone or in an ``and``."""
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        return any(_on_cpu(ctx, v) for v in test.values)
    return (
        isinstance(test, ast.Compare)
        and len(test.ops) == 1
        and isinstance(test.ops[0], ast.Eq)
        and isinstance(test.left, ast.Attribute)
        and test.left.attr == "type"
        and isinstance(test.left.value, ast.Attribute)
        and test.left.value.attr == "device"
        and ctx.string_value(test.comparators[0]) == "cpu"
    )


def off_step(ctx: FileContext, node: ast.AST) -> bool:
    """Whether ``node`` runs only off the card's step: on the CPU route (the
    body of an ``if <t>.device.type == "cpu"``: a tensor on the CPU has no
    card to wait for), or in a lambda handed to a :data:`DEFERRED_CALLS`
    call."""
    child, cur = node, ctx.parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.If) and child in cur.body and _on_cpu(ctx, cur.test):
            return True
        if isinstance(cur, ast.IfExp) and child is cur.body and _on_cpu(ctx, cur.test):
            return True
        if (isinstance(child, ast.Lambda) and isinstance(cur, ast.Call)
                and child is not cur.func
                and ctx.resolve(cur.func) in DEFERRED_CALLS):
            return True
        child, cur = cur, ctx.parents.get(cur)
    return False


def host_syncs(ctx: FileContext, node: ast.AST
               ) -> List[Tuple[ast.AST, str, Optional[ast.AST]]]:
    """(site node, detail, the value synced or None) of each host sync in
    the function ``node``'s own body (a nested ``def`` is its own; a
    lambda's body is its function's)."""
    types = _Types(ctx, node)
    out: List[Tuple[ast.AST, str, Optional[ast.AST]]] = []
    for sub in ast.walk(node):
        if sub is node or ctx.enclosing_def(sub) is not node or off_step(ctx, sub):
            continue
        if isinstance(sub, ast.Call):
            site = _call_site(ctx, types, sub)
            if site is not None:
                out.append((sub, *site))
        elif isinstance(sub, (ast.Assign, ast.AugAssign)):
            targets = sub.targets if isinstance(sub, ast.Assign) else [sub.target]
            for t in targets:
                if (isinstance(t, ast.Subscript) and types.tensor(t.value)
                        and types.scalar(sub.value)):
                    out.append((sub, f"store:{_text(t)}", sub.value))
        elif isinstance(sub, (ast.If, ast.While, ast.Assert, ast.IfExp)):
            if types.tensor(sub.test):
                kw = {ast.If: "if", ast.While: "while", ast.Assert: "assert",
                      ast.IfExp: "ifexp"}[type(sub)]
                out.append((sub, f"{kw}:{_text(sub.test)}", sub.test))
    return out


def _call_site(ctx: FileContext, types: _Types, call: ast.Call
               ) -> Optional[Tuple[str, Optional[ast.AST]]]:
    target = ctx.resolve(call.func)
    if target == "torch.cuda.synchronize":
        return "synchronize", None
    if target in _MAKERS and call.args and any(
            kw.arg == "device" and not _is_cpu(ctx, kw.value) for kw in call.keywords):
        return f"upload:{_text(call.args[0])}", call.args[0]
    if target in _SHAPE_OPS and call.args:
        return f"{_SHAPE_OPS[target]}:{_text(call.args[0])}", call.args[0]
    if target == "torch.where" and len(call.args) == 1 and not call.keywords:
        return f"where:{_text(call.args[0])}", call.args[0]
    if target in _HOST_CASTS and len(call.args) == 1 and not isinstance(
            call.args[0], ast.Constant) and types.tensor(call.args[0]):
        return f"{target}:{_text(call.args[0])}", call.args[0]
    if not isinstance(call.func, ast.Attribute):
        return None
    base, meth = call.func.value, call.func.attr
    if types.array(base):
        return None
    if meth in _READ_METHODS and (
            not call.args or meth in ("equal", "allclose")):
        return f"{meth}:{_text(base)}", base
    if meth == "nonzero" and not call.args:
        return f"nonzero:{_text(base)}", base
    if meth == "to" and (
            (call.args and _is_cpu(ctx, call.args[0]))
            or any(kw.arg == "device" and _is_cpu(ctx, kw.value)
                   for kw in call.keywords)):
        return f"to-cpu:{_text(base)}", base
    if types.host_made(base) and (meth == "cuda" or (meth == "to" and (
            (call.args and not _is_dtype(ctx, call.args[0]))
            or any(kw.arg == "device" for kw in call.keywords)))):
        return f"upload:{_text(base)}", base
    return None


def _is_dtype(ctx: FileContext, node: ast.AST) -> bool:
    """A dtype argument: ``torch.<dtype>``, or a name that says so."""
    target = ctx.resolve(node) or ""
    return (target.startswith("torch.") and target.split(".")[1] not in (
        "device", "cuda")) or target.rsplit(".", 1)[-1] in ("dtype", "dt")


# -- sites -----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TraceSite:
    """One host sync on a step's path (the reference's trace-boundary
    record, with ``kind`` ``host-sync``)."""

    kind: str
    path: str
    line: int
    function: str    # qualname of the function holding the sync
    detail: str      # "<op>:<the value synced>"
    provenance: str
    note: str = ""

    def lock_key(self) -> str:
        """Line-free identity — line churn must not invalidate the lock."""
        return f"{self.kind}:{self.path}:{self.function}:{self.detail}"

    def to_json_obj(self) -> dict:
        return {
            "kind": self.kind,
            "path": self.path,
            "line": self.line,
            "function": self.function,
            "detail": self.detail,
            "provenance": self.provenance,
            "note": self.note,
        }


_NOTES = {
    PLAN_DEPENDENT: "the value tracks the plan or the routing, so the host "
                    "waits for the card on every step and no CUDA graph can "
                    "hold the step; keep it on the card",
    WINDOW_DEPENDENT: "the value changes per telemetry window: a sync each "
                      "window",
    TOPOLOGY_STABLE: "the value is fixed by the geometry and the config: "
                     "a sync that could be read once",
}


# -- interprocedural fixpoint ----------------------------------------------------

class ProvenanceAnalysis:
    """Bounded fixpoint: call-site args -> param provenance -> returns (the
    reference's), then the host syncs of the functions a step reaches.

    Monotone over a finite 3-point lattice, so ≤ 8 sorted rounds is far
    past convergence for any real call chain in this tree; iteration is
    sorted everywhere so the result is bit-stable run to run.
    """

    MAX_ROUNDS = 8

    def __init__(self, program: Program):
        self.program = program
        #: qualname -> param -> joined call-site provenance
        self.param_prov: Dict[str, Dict[str, str]] = {}
        #: qualname -> return-value provenance
        self.ret_prov: Dict[str, str] = {}
        self.rounds = 0
        #: autograd Function class -> the join of what its forward saves
        self.saved: Dict[str, str] = {}
        self._env_cache: Dict[str, Dict[str, str]] = {}
        #: qualname -> its nodes (``ast.walk`` order), its binding statements
        self._walk: Dict[str, List[ast.AST]] = {}
        self._stmts: Dict[str, List[ast.AST]] = {}
        for qual, summary in sorted(program.summaries.items()):
            self.param_prov[qual] = {}
            base = qual.rsplit(".", 1)[1]
            self.ret_prov[qual] = (
                PLAN_DEPENDENT if base in PLAN_RETURNING
                else classify_name(base)
            )

    # -- expression provenance --------------------------------------------------
    def param_provenance(self, qual: str, param: str) -> str:
        """Final class of a param: name seed ⊔ every call-site argument."""
        seeded = classify_name(param)
        return join(seeded, self.param_prov.get(qual, {}).get(
            param, TOPOLOGY_STABLE
        ))

    def _expr(self, ctx: FileContext, env: Dict[str, str],
              node: ast.AST) -> str:
        if isinstance(node, ast.Constant):
            return TOPOLOGY_STABLE
        if isinstance(node, ast.Name):
            return env.get(node.id, TOPOLOGY_STABLE)
        if isinstance(node, ast.Attribute):
            if node.attr in _METADATA_ATTRS:
                return TOPOLOGY_STABLE  # shape/dtype of anything is geometry
            return join(
                classify_name(node.attr), self._expr(ctx, env, node.value)
            )
        if isinstance(node, ast.Subscript):
            return join(
                self._expr(ctx, env, node.value),
                self._expr(ctx, env, node.slice),
            )
        if isinstance(node, ast.Call):
            target = ctx.resolve(node.func)
            base = target.rsplit(".", 1)[-1] if target else ""
            if base in PLAN_RETURNING:
                return PLAN_DEPENDENT
            if target is not None:
                resolved = self.program.resolve_target(
                    target, module_name_of(ctx.path)
                )
                if resolved is not None:
                    return self.ret_prov.get(resolved, TOPOLOGY_STABLE)
            out = TOPOLOGY_STABLE
            if isinstance(node.func, ast.Attribute):
                # a method's result carries its object's class
                out = self._expr(ctx, env, node.func.value)
            for arg in node.args:
                out = join(out, self._expr(ctx, env, arg))
            for kw in node.keywords:
                out = join(out, self._expr(ctx, env, kw.value))
            return out
        if isinstance(node, ast.Lambda):
            return TOPOLOGY_STABLE  # a lambda value is code, not data
        out = TOPOLOGY_STABLE
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.expr, ast.keyword)):
                target = child.value if isinstance(child, ast.keyword) else child
                out = join(out, self._expr(ctx, env, target))
        return out

    # -- per-function environment -----------------------------------------------
    def _env_for(self, qual: str, cache: bool = False) -> Dict[str, str]:
        if cache and qual in self._env_cache:
            return self._env_cache[qual]
        ctx, node = self.program.nodes[qual]
        summary = self.program.summaries[qual]
        env: Dict[str, str] = {
            p: self.param_provenance(qual, p) for p in summary.params
        }
        cls, _, name = qual.rpartition(".")
        if name == "backward" and cls in self.saved and summary.params:
            # ``ctx.saved_tensors``: what the forward saved
            ctx_param = summary.params[0]
            env[ctx_param] = join(env[ctx_param], self.saved[cls])
        # two forward passes in source order picks up loop-carried joins
        if qual not in self._stmts:
            self._stmts[qual] = sorted(
                (
                    n for n in self._nodes(qual)
                    if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign,
                                      ast.For, ast.NamedExpr))
                ),
                key=lambda n: (n.lineno, n.col_offset),
            )
        stmts = self._stmts[qual]
        for _ in range(2):
            for stmt in stmts:
                if isinstance(stmt, ast.For):
                    prov = self._expr(ctx, env, stmt.iter)
                    self._bind(env, stmt.target, prov)
                    continue
                value = stmt.value
                if value is None:
                    continue
                prov = self._expr(ctx, env, value)
                targets = (
                    stmt.targets if isinstance(stmt, ast.Assign)
                    else [stmt.target]
                )
                for t in targets:
                    self._bind(env, t, prov, augment=isinstance(
                        stmt, ast.AugAssign
                    ))
        if cache:
            self._env_cache[qual] = env
        return env

    def _nodes(self, qual: str) -> List[ast.AST]:
        if qual not in self._walk:
            self._walk[qual] = list(ast.walk(self.program.nodes[qual][1]))
        return self._walk[qual]

    def _bind(self, env: Dict[str, str], target: ast.AST, prov: str,
              augment: bool = False) -> None:
        if isinstance(target, ast.Name):
            old = env.get(target.id, TOPOLOGY_STABLE)
            env[target.id] = join(old, prov) if augment else join(
                prov, old if target.id in env else TOPOLOGY_STABLE
            )
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(env, elt, prov, augment)
        elif isinstance(target, ast.Starred):
            self._bind(env, target.value, prov, augment)

    # -- fixpoint ---------------------------------------------------------------
    def run(self) -> "ProvenanceAnalysis":
        for self.rounds in range(1, self.MAX_ROUNDS + 1):
            if not self._round():
                break
        self._env_cache.clear()
        return self

    def _round(self) -> bool:
        changed = False
        for qual in sorted(self.program.nodes):
            ctx, node = self.program.nodes[qual]
            summary = self.program.summaries[qual]
            env = self._env_for(qual)
            module = summary.module
            # returns: only this function's own return statements
            ret = self.ret_prov[qual]
            for sub in self._nodes(qual):
                if isinstance(sub, ast.Return) and sub.value is not None:
                    if ctx.enclosing_function(sub) is node:
                        ret = join(ret, self._expr(ctx, env, sub.value))
                elif isinstance(sub, ast.Call):
                    changed |= self._flow_call(ctx, env, module, sub)
                    changed |= self._flow_saved(ctx, env, qual, sub)
            if ret != self.ret_prov[qual]:
                self.ret_prov[qual] = ret
                changed = True
        return changed

    def _flow_saved(self, ctx: FileContext, env: Dict[str, str], qual: str,
                    call: ast.Call) -> bool:
        """``ctx.save_for_backward(...)`` in an autograd Function's forward:
        the saved values' join, which its backward's ``ctx`` then carries."""
        cls, _, name = qual.rpartition(".")
        if name != "forward" or not (
            isinstance(call.func, ast.Attribute)
            and call.func.attr == "save_for_backward"
        ):
            return False
        prov = self.saved.get(cls, TOPOLOGY_STABLE)
        for arg in call.args:
            value = arg.value if isinstance(arg, ast.Starred) else arg
            prov = join(prov, self._expr(ctx, env, value))
        if prov != self.saved.get(cls, TOPOLOGY_STABLE):
            self.saved[cls] = prov
            return True
        return False

    def _flow_call(self, ctx: FileContext, env: Dict[str, str],
                   module: str, call: ast.Call) -> bool:
        target = ctx.resolve(call.func)
        if target is None:
            return False
        offset = 0
        forward = f"{module}.{target[:-6]}.forward" if target.endswith(".apply") else ""
        if forward in self.program.summaries:
            # an autograd Function's apply: its forward, after ``ctx``
            resolved, offset = forward, 1
        else:
            resolved = self.program.resolve_target(target, module)
        if resolved is None:
            return False
        callee = self.program.summaries[resolved]
        params = list(callee.params)
        if params and params[0] in ("self", "cls") and isinstance(
            call.func, ast.Attribute
        ):
            offset = 1
        changed = False
        slots = self.param_prov[resolved]
        for i, arg in enumerate(call.args):
            idx = i + offset
            if isinstance(arg, ast.Starred):
                # ``*xs``: each remaining parameter may take any of them
                prov = self._expr(ctx, env, arg.value)
                for p in params[idx:]:
                    changed |= self._join_param(slots, p, prov)
                break
            if idx >= len(params):
                break
            changed |= self._join_param(
                slots, params[idx], self._expr(ctx, env, arg)
            )
        for kw in call.keywords:
            if kw.arg is None or kw.arg not in params:
                continue
            changed |= self._join_param(
                slots, kw.arg, self._expr(ctx, env, kw.value)
            )
        return changed

    @staticmethod
    def _join_param(slots: Dict[str, str], param: str, prov: str) -> bool:
        old = slots.get(param, TOPOLOGY_STABLE)
        new = join(old, prov)
        if new != old:
            slots[param] = new
            return True
        return False

    # -- the step's host syncs --------------------------------------------------
    def entry_points(self) -> List[str]:
        """Qualnames of the step entry points in the program."""
        node_to_qual = {
            node: qual for qual, (_, node) in self.program.nodes.items()
        }
        return sorted(
            node_to_qual[e.node]
            for ctx in self.program.contexts for e in ctx.step_entries
            if e.node in node_to_qual
        )

    def trace_sites(self) -> List[TraceSite]:
        """Every host sync in a function a step entry point reaches."""
        sites: List[TraceSite] = []
        reach = self.program.reachable(self.entry_points(), skip=off_step)
        for qual in sorted(reach):
            ctx, node = self.program.nodes[qual]
            env = self._env_for(qual, cache=True)
            for sub, detail, value in host_syncs(ctx, node):
                prov = (TOPOLOGY_STABLE if value is None
                        else self._expr(ctx, env, value))
                sites.append(TraceSite(
                    HOST_SYNC, ctx.path, sub.lineno, qual, detail, prov,
                    _NOTES[prov],
                ))
        dedup: Dict[str, TraceSite] = {}
        for s in sorted(sites, key=lambda s: (s.path, s.line, s.detail)):
            dedup.setdefault(s.lock_key(), s)
        return sorted(
            dedup.values(), key=lambda s: (s.path, s.line, s.detail)
        )


# -- inventory + lock ------------------------------------------------------------

def analyze_program(program: Program) -> ProvenanceAnalysis:
    return ProvenanceAnalysis(program).run()


def build_retrace_inventory(
    program: Program, analysis: Optional[ProvenanceAnalysis] = None
) -> dict:
    """The ``nimble.retrace/v1`` site inventory — the work-list of the
    PRs that take a step's host reads off its path."""
    analysis = analysis or analyze_program(program)
    sites = analysis.trace_sites()
    counts = {TOPOLOGY_STABLE: 0, WINDOW_DEPENDENT: 0, PLAN_DEPENDENT: 0}
    for s in sites:
        counts[s.provenance] += 1
    return tag(RETRACE_KIND, {
        "files": len(program.contexts),
        "sites": [s.to_json_obj() for s in sites],
        "counts": counts,
        "rounds": analysis.rounds,
    })


def default_retrace_lock_path() -> str:
    return os.path.join(os.path.dirname(__file__), "retrace.lock.json")


def generate_retrace_lock_obj(
    program: Program, analysis: Optional[ProvenanceAnalysis] = None
) -> dict:
    analysis = analysis or analyze_program(program)
    entries = {
        s.lock_key(): s.provenance for s in analysis.trace_sites()
    }
    return tag(RETRACE_LOCK_KIND, {
        "entries": {k: entries[k] for k in sorted(entries)},
    })


def write_retrace_lock(
    program: Program, path: str,
    analysis: Optional[ProvenanceAnalysis] = None,
) -> dict:
    obj = generate_retrace_lock_obj(program, analysis)
    write_json_file(path, obj)
    return obj


def retrace_lock_is_fresh(
    path: str, program: Program,
    analysis: Optional[ProvenanceAnalysis] = None,
) -> bool:
    if not os.path.exists(path):
        return False
    committed = read_json_file(path)
    return committed == generate_retrace_lock_obj(program, analysis)


