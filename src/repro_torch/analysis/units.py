"""Units lattice: bytes | bytes_per_s | fraction | price | windows.

Counterpart of ``repro/analysis/units.py``, over the port's modules.
The cost/fabric stack moves five physically different quantities through
plain floats: raw/effective **bytes** (demands, committed loads),
**bytes_per_s** capacities (link caps, ``relay_cap``/``inject_cap``),
dimensionless **fractions** (``hysteresis``, ``rail_relay_eff``, EMA
weights), congestion **prices** (the fabric arbiter's export), and
**windows** (telemetry window counters, ``half_life`` recency).  Nothing
in the type system separates them, and the ledger contract is strict:
``FabricState.commit`` takes *effective bytes per resource* — committing
a fraction or a price there corrupts every other tenant's costs
silently.

This analysis seeds units from the explicitly annotated signatures below
(``core/cost.py``, ``core/mcf.py``, ``fabric/state.py``) plus identifier
conventions (``*_bytes``, ``*_cap``, ``*_eff``, ``price``, ``window``,
``half_life``), derives function return units through a short
interprocedural fixpoint over the :class:`~repro_torch.analysis.callgraph.Program`,
and flags **unit mixing**:

  * ``+`` / ``-`` / comparison between two different known units;
  * a call-site argument whose unit contradicts the callee's param unit.

``*`` and ``/`` legitimately *change* units, so they never flag; instead
the algebra is modeled where it is unambiguous — a fraction scales
without changing the other operand's unit, ``bytes / bytes`` is a
fraction, a bare numeric literal is unitless.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Tuple

from ..jsonio import tag
from .callgraph import Program, module_name_of
from .context import FileContext

UNITS_KIND = "units"

BYTES = "bytes"
BYTES_PER_S = "bytes_per_s"
FRACTION = "fraction"
PRICE = "price"
WINDOWS = "windows"

UNITS = (BYTES, BYTES_PER_S, FRACTION, PRICE, WINDOWS)

#: explicit signature seeds: qualname -> {param: unit} (+ "return")
UNIT_SIGNATURES: Dict[str, Dict[str, str]] = {
    # core/cost.py
    "repro_torch.core.cost.ResourceModel.charges": {"f": BYTES},
    "repro_torch.core.cost.ResourceModel.resource_cost": {"load": BYTES},
    "repro_torch.core.cost.ResourceModel.path_cost": {"msg_bytes": BYTES},
    "repro_torch.core.cost.ResourceModel.smooth_loads": {
        "prev": BYTES, "now": BYTES, "return": BYTES,
    },
    "repro_torch.core.cost.capacity_normalized": {
        "loads": BYTES, "return": FRACTION,
    },
    # core/mcf.py
    "repro_torch.core.mcf.solve_mwu": {
        "lam": FRACTION, "eps": BYTES,
        "prev_loads": BYTES, "ext_loads": BYTES,
    },
    "repro_torch.core.mcf._quantized_fraction": {"lam": FRACTION, "eps": BYTES},
    "repro_torch.core.mcf.solve_degraded": {"prev_loads": BYTES,
                                      "ext_loads": BYTES},
    # fabric/state.py — the ledger contract the module docstring names
    "repro_torch.fabric.state.FabricState.commit": {
        "resource_bytes": BYTES, "window": WINDOWS,
    },
    # fabric/arbiter.py: the exported "prices" are *denominated in
    # weighted effective bytes* ("external load over tenant weight" —
    # prices_for docstring), which is why solve_mwu prices ext_loads
    # as-is.  The PRICE unit is reserved for genuinely per-unit prices.
    "repro_torch.fabric.arbiter.FabricArbiter.prices_for": {"return": BYTES},
    "repro_torch.fabric.state.FabricState.decay_factor": {
        "half_life": WINDOWS, "return": FRACTION,
    },
    "repro_torch.fabric.state.FabricState.drain_time_s": {"loads": BYTES},
}

#: attribute-name units (CostModel fields and friends)
ATTR_UNITS: Dict[str, str] = {
    "split_threshold": BYTES,
    "hop_setup_bytes": BYTES,
    "hysteresis": FRACTION,
    "relay_cap": BYTES_PER_S,
    "inject_cap": BYTES_PER_S,
    "rail_relay_eff": FRACTION,
    "capacity": BYTES_PER_S,
    "half_life": WINDOWS,
    "price_decay": WINDOWS,
}

#: metadata attrs carry no unit and block suffix matching
_NO_UNIT_ATTRS = {"shape", "dtype", "ndim", "size"}

#: unit-preserving casts/selections (same quantity, new container)
_CAST_CALLS = {
    "int", "float", "abs", "round",
    "asarray", "array", "copy", "minimum", "maximum", "min", "max",
    "where", "clip", "floor", "ceil", "sum",
}


def unit_of_name(name: str) -> Optional[str]:
    """Identifier-convention unit (params, locals, attrs)."""
    if name in ATTR_UNITS:
        return ATTR_UNITS[name]
    low = name.lower()
    tokens = low.split("_")
    if low.endswith("_bytes") or low == "bytes":
        return BYTES
    if low.endswith("_cap"):
        return BYTES_PER_S
    if low.endswith("_frac") or low.endswith("_eff") or low == "fraction":
        return FRACTION
    if "price" in tokens or "prices" in tokens:
        return PRICE
    if low in ("window", "windows") or low.endswith("_window"):
        return WINDOWS
    return None


@dataclasses.dataclass(frozen=True)
class UnitMix:
    path: str
    line: int
    col: int
    function: str
    message: str


class UnitsAnalysis:
    """Seed -> propagate return units -> flag mixing at use sites."""

    MAX_ROUNDS = 4

    def __init__(self, program: Program,
                 signatures: Optional[Dict[str, Dict[str, str]]] = None):
        self.program = program
        self.signatures = dict(
            UNIT_SIGNATURES if signatures is None else signatures
        )
        #: qualname -> derived return unit
        self.ret_unit: Dict[str, Optional[str]] = {}
        self.mixes: List[UnitMix] = []

    # -- seeds ------------------------------------------------------------------
    def param_unit(self, qual: str, param: str) -> Optional[str]:
        sig = self.signatures.get(qual)
        if sig and param in sig:
            return sig[param]
        return unit_of_name(param)

    def _seeded_return(self, qual: str) -> Optional[str]:
        sig = self.signatures.get(qual)
        if sig and "return" in sig:
            return sig["return"]
        return unit_of_name(qual.rsplit(".", 1)[1])

    # -- expression units -------------------------------------------------------
    def _expr(self, ctx: FileContext, env: Dict[str, Optional[str]],
              node: ast.AST, sink: Optional[List[UnitMix]] = None,
              function: str = "") -> Optional[str]:
        if isinstance(node, ast.Constant):
            return None  # bare literals are unitless scalars
        if isinstance(node, ast.Name):
            if node.id in env:
                return env[node.id]
            return unit_of_name(node.id)
        if isinstance(node, ast.Attribute):
            if node.attr in _NO_UNIT_ATTRS:
                return None
            return unit_of_name(node.attr)
        if isinstance(node, ast.BinOp):
            return self._binop(ctx, env, node, sink, function)
        if isinstance(node, ast.UnaryOp):
            return self._expr(ctx, env, node.operand, sink, function)
        if isinstance(node, ast.Call):
            return self._call_unit(ctx, env, node, sink, function)
        if isinstance(node, ast.IfExp):
            # `x if cond else None` keeps x's unit — None is absence,
            # not a differently-dimensioned value
            units = {
                self._expr(ctx, env, branch, sink, function)
                for branch in (node.body, node.orelse)
                if not (
                    isinstance(branch, ast.Constant)
                    and branch.value is None
                )
            }
            return units.pop() if len(units) == 1 else None
        if isinstance(node, ast.Subscript):
            return self._expr(ctx, env, node.value, sink, function)
        return None

    def _binop(self, ctx, env, node: ast.BinOp, sink, function):
        left = self._expr(ctx, env, node.left, sink, function)
        right = self._expr(ctx, env, node.right, sink, function)
        if isinstance(node.op, (ast.Add, ast.Sub)):
            if left and right and left != right:
                self._mix(ctx, node, function, sink,
                          f"{left} {_op_str(node.op)} {right}",
                          node.left, node.right)
                return None
            return left or right
        if isinstance(node.op, ast.Mult):
            # a fraction (or unitless scalar) scales without changing units
            if left == FRACTION or left is None:
                return right
            if right == FRACTION or right is None:
                return left
            return None
        if isinstance(node.op, (ast.Div, ast.FloorDiv)):
            if left == BYTES and right == BYTES:
                return FRACTION
            if right == FRACTION or right is None:
                return left
            return None
        return None

    def _call_unit(self, ctx, env, node: ast.Call, sink, function):
        target = ctx.resolve(node.func)
        base = target.rsplit(".", 1)[-1] if target else ""
        resolved = (
            self.program.resolve_target(target, module_name_of(ctx.path))
            if target else None
        )
        # check args against the callee's seeded/derived param units
        if resolved is not None and sink is not None:
            self._check_call_args(ctx, env, node, resolved, sink, function)
        if resolved is not None:
            derived = self.ret_unit.get(resolved)
            if derived is not None:
                return derived
        if base in _CAST_CALLS:
            units = {
                u for u in (
                    self._expr(ctx, env, a, sink, function)
                    for a in node.args
                ) if u is not None
            }
            return units.pop() if len(units) == 1 else None
        return None

    def _check_call_args(self, ctx, env, call: ast.Call, callee_qual: str,
                         sink: List[UnitMix], function: str) -> None:
        callee = self.program.summaries.get(callee_qual)
        if callee is None:
            return
        params = list(callee.params)
        offset = 0
        if params and params[0] in ("self", "cls") and isinstance(
            call.func, ast.Attribute
        ):
            offset = 1
        pairs: List[Tuple[str, ast.AST]] = []
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred):
                continue
            idx = i + offset
            if idx < len(params):
                pairs.append((params[idx], arg))
        for kw in call.keywords:
            if kw.arg is not None and kw.arg in params:
                pairs.append((kw.arg, kw.value))
        for param, arg in pairs:
            expected = self.param_unit(callee_qual, param)
            if expected is None:
                continue
            got = self._expr(ctx, env, arg, None, function)
            if got is not None and got != expected:
                sink.append(UnitMix(
                    ctx.path, arg.lineno, arg.col_offset, function,
                    f"passes {got} where `{callee_qual}` expects "
                    f"{expected} for param `{param}`",
                ))

    def _mix(self, ctx, node, function, sink, desc, left, right):
        if sink is None:
            return
        sink.append(UnitMix(
            ctx.path, node.lineno, node.col_offset, function,
            f"mixes units: {desc} "
            f"(`{_short(left)}` vs `{_short(right)}`)",
        ))

    # -- per-function env + checks ----------------------------------------------
    def _env_for(self, qual: str) -> Tuple[FileContext, ast.AST,
                                           Dict[str, Optional[str]]]:
        ctx, node = self.program.nodes[qual]
        summary = self.program.summaries[qual]
        env: Dict[str, Optional[str]] = {
            p: self.param_unit(qual, p) for p in summary.params
        }
        stmts = sorted(
            (
                n for n in ast.walk(node)
                if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign))
            ),
            key=lambda n: (n.lineno, n.col_offset),
        )
        for stmt in stmts:
            if stmt.value is None:
                continue
            unit = self._expr(ctx, env, stmt.value)
            targets = (
                stmt.targets if isinstance(stmt, ast.Assign)
                else [stmt.target]
            )
            for t in targets:
                if isinstance(t, ast.Name):
                    named = unit_of_name(t.id)
                    env[t.id] = unit if unit is not None else named
        return ctx, node, env

    # -- fixpoint + sweep -------------------------------------------------------
    def run(self) -> "UnitsAnalysis":
        for qual in sorted(self.program.summaries):
            self.ret_unit[qual] = self._seeded_return(qual)
        for _ in range(self.MAX_ROUNDS):
            if not self._round():
                break
        self._sweep()
        return self

    def _round(self) -> bool:
        changed = False
        for qual in sorted(self.program.nodes):
            if self.ret_unit.get(qual) is not None:
                continue
            ctx, node, env = self._env_for(qual)
            units = set()
            for sub in ast.walk(node):
                if isinstance(sub, ast.Return) and sub.value is not None:
                    if ctx.enclosing_function(sub) is node:
                        units.add(self._expr(ctx, env, sub.value))
            units.discard(None)
            if len(units) == 1:
                self.ret_unit[qual] = units.pop()
                changed = True
        return changed

    def _sweep(self) -> None:
        """Final pass: flag mixing at every +, -, comparison, call site."""
        sink: List[UnitMix] = []
        for qual in sorted(self.program.nodes):
            ctx, node, env = self._env_for(qual)
            for sub in ast.walk(node):
                if isinstance(sub, ast.BinOp) and isinstance(
                    sub.op, (ast.Add, ast.Sub)
                ):
                    self._binop(ctx, env, sub, sink, qual)
                elif isinstance(sub, ast.Compare):
                    operands = [sub.left, *sub.comparators]
                    if any(
                        isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                        for op in sub.ops
                    ):
                        continue
                    units = [
                        self._expr(ctx, env, o, None, qual)
                        for o in operands
                    ]
                    known = [u for u in units if u is not None]
                    if len(set(known)) > 1:
                        sink.append(UnitMix(
                            ctx.path, sub.lineno, sub.col_offset, qual,
                            f"compares {' vs '.join(sorted(set(known)))} — "
                            "different units never order meaningfully",
                        ))
                elif isinstance(sub, ast.Call):
                    self._call_unit(ctx, env, sub, sink, qual)
        seen = set()
        for m in sorted(sink, key=lambda m: (m.path, m.line, m.message)):
            key = (m.path, m.function, m.message)
            if key not in seen:
                seen.add(key)
                self.mixes.append(m)


def _op_str(op: ast.AST) -> str:
    return "+" if isinstance(op, ast.Add) else "-"


def _short(node: ast.AST, limit: int = 40) -> str:
    try:
        text = ast.unparse(node)
    except Exception:  # pragma: no cover - unparse is py3.9+ and total
        text = type(node).__name__
    return text if len(text) <= limit else text[: limit - 3] + "..."


def analyze_units(program: Program) -> UnitsAnalysis:
    return UnitsAnalysis(program).run()


def build_units_inventory(
    program: Program, analysis: Optional[UnitsAnalysis] = None
) -> dict:
    """The ``nimble.units/v1`` inventory: seeds, derived returns, mixes."""
    analysis = analysis or analyze_units(program)
    derived = {
        q: u for q, u in sorted(analysis.ret_unit.items()) if u is not None
    }
    return tag(UNITS_KIND, {
        "files": len(program.contexts),
        "seeds": len(analysis.signatures),
        "derived_returns": derived,
        "mixes": [
            {
                "path": m.path, "line": m.line, "function": m.function,
                "message": m.message,
            }
            for m in analysis.mixes
        ],
    })
