"""The NIMBLE rule catalog, over the port.

Counterpart of ``repro/analysis/rules.py``.  The per-file rules are the
reference's, with their scopes under ``repro_torch/``:

  * ``determinism`` — wall-clock, unseeded RNG, and order-sensitive
    ``set`` iteration in the seed-deterministic layers (``core/``,
    ``fabric/``, ``faults/``, ``serve/scenario.py``) whose digests,
    arbitration order, and schedules must be bit-stable; torch's global
    RNG too (a ``torch.rand``/``randn``/... call with no ``generator=``,
    ``torch.manual_seed``): the port draws from explicit generators;
  * ``schema-discipline`` — every ``nimble.<kind>/vN`` literal and
    ``tag()`` call must strict-parse, use a kind registered in
    ``repro_torch.jsonio.KNOWN_SCHEMAS`` at the registered version, and emit
    only keys recorded in ``schemas.lock.json`` (new keys require a
    version bump + lock regeneration);
  * ``frozen-spec`` — ``object.__setattr__`` outside a frozen
    dataclass's ``__post_init__``, and mutable defaults on frozen spec
    fields;
  * ``float-eq`` — ``==`` / ``!=`` against NaN anywhere (always False —
    NaN is a *sentinel* in telemetry/estimator paths, probed with
    ``isnan``), and float-literal equality in those paths.

The reference's ``jit-purity`` and ``retrace-provenance`` check JAX
tracing, which the port does not have; ``host-sync`` (host reads on a
step's path, :mod:`repro_torch.analysis.provenance`) takes their place.
``units`` and ``xmodule-determinism`` are the reference's interprocedural
rules.

Rules are stateless over a :class:`~repro_torch.analysis.context.FileContext`;
scoping is by path prefix so test fixtures opt in by naming their
virtual path accordingly.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

from ..jsonio import known_schemas
from .context import FileContext
from .engine import Finding
from .schemas import collect_schema_sites, generate_lock_obj, load_lock


def _norm(path: str) -> str:
    return path.replace("\\", "/")


def _in_scope(path: str, prefixes: Sequence[str]) -> bool:
    p = _norm(path)
    return any(f"/{frag}" in f"/{p}" for frag in prefixes)


# -- rule 1: determinism ---------------------------------------------------------

#: layers whose outputs must be seed/ordering-deterministic
_DETERMINISM_SCOPE = (
    "repro_torch/core/", "repro_torch/fabric/", "repro_torch/faults/",
    "repro_torch/serve/scenario.py",
)
_WALLCLOCK = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.date.today",
}
_ENTROPY = {
    "os.urandom", "uuid.uuid1", "uuid.uuid4",
    "secrets.token_bytes", "secrets.token_hex", "secrets.randbits",
    "secrets.choice",
}
_NP_RANDOM_ALLOWED = {
    "numpy.random.default_rng", "numpy.random.Generator",
    "numpy.random.SeedSequence",
}
#: torch draws that take a ``generator=``: without one they use the global RNG
_TORCH_RANDOM = {
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.multinomial", "torch.bernoulli", "torch.normal",
}
#: seeding torch's global RNG (state shared by every caller)
_TORCH_GLOBAL_SEED = {
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
}
#: iteration-order-sensitive consumers of a set-producing expression
_ORDER_SENSITIVE_CALLS = {"list", "tuple", "enumerate"}


class DeterminismRule:
    rule_id = "determinism"
    description = (
        "wall-clock, unseeded RNG, and set-iteration in deterministic layers"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not _in_scope(ctx.path, _DETERMINISM_SCOPE):
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                yield from self._check_call(ctx, node)
            elif isinstance(node, (ast.For, ast.comprehension)):
                it = node.iter
                if self._set_producing(ctx, it):
                    yield Finding(
                        self.rule_id, ctx.path, it.lineno, it.col_offset,
                        "iteration over a set — order is hash-dependent; "
                        "wrap in sorted(...) to keep digests/arbitration "
                        "order bit-stable",
                    )

    def _check_call(self, ctx: FileContext, call: ast.Call) -> Iterator[Finding]:
        target = ctx.resolve(call.func)
        if target in _WALLCLOCK:
            yield Finding(
                self.rule_id, ctx.path, call.lineno, call.col_offset,
                f"`{target}` in a deterministic layer — wall-clock breaks "
                "replayability; thread a window/clock value in instead",
            )
        elif target in _ENTROPY:
            yield Finding(
                self.rule_id, ctx.path, call.lineno, call.col_offset,
                f"`{target}` in a deterministic layer — unseeded entropy; "
                "derive from the scenario seed",
            )
        elif target and target.startswith("random."):
            yield Finding(
                self.rule_id, ctx.path, call.lineno, call.col_offset,
                f"`{target}` uses the process-global RNG — use a seeded "
                "`random.Random(seed)` / `np.random.default_rng(seed)`",
            )
        elif (
            target
            and target.startswith("numpy.random.")
            and target not in _NP_RANDOM_ALLOWED
        ):
            yield Finding(
                self.rule_id, ctx.path, call.lineno, call.col_offset,
                f"`{target}` uses numpy's global RNG — use a seeded "
                "`np.random.default_rng(seed)` generator",
            )
        elif target in _TORCH_RANDOM and not any(
            kw.arg == "generator" for kw in call.keywords
        ):
            yield Finding(
                self.rule_id, ctx.path, call.lineno, call.col_offset,
                f"`{target}` without `generator=` draws from torch's global "
                "RNG — pass a seeded `torch.Generator`",
            )
        elif target in _TORCH_GLOBAL_SEED:
            yield Finding(
                self.rule_id, ctx.path, call.lineno, call.col_offset,
                f"`{target}` seeds torch's process-global RNG — seed a "
                "`torch.Generator` and pass it instead",
            )
        elif (
            target in _ORDER_SENSITIVE_CALLS
            and call.args
            and self._set_producing(ctx, call.args[0])
        ):
            yield Finding(
                self.rule_id, ctx.path, call.lineno, call.col_offset,
                f"`{target}(<set>)` materializes hash order — use "
                "sorted(...) for a deterministic sequence",
            )

    def _set_producing(self, ctx: FileContext, node: ast.AST) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call):
            if ctx.resolve(node.func) in ("set", "frozenset"):
                return True
            # set.union/intersection/difference chains keep set order
            if isinstance(node.func, ast.Attribute) and node.func.attr in (
                "union", "intersection", "difference",
                "symmetric_difference",
            ):
                return self._set_producing(ctx, node.func.value)
        if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)
        ):
            return self._set_producing(ctx, node.left) or self._set_producing(
                ctx, node.right
            )
        return False


# -- rule 2: schema-discipline ---------------------------------------------------

class SchemaDisciplineRule:
    rule_id = "schema-discipline"
    description = (
        "frozen nimble.<kind>/vN ids: strict parse, registry, lock manifest"
    )

    def __init__(self, lock: Optional[dict] = None):
        # default: the committed lock, loaded lazily so fixture runs can
        # inject their own manifest
        self._lock = lock
        self._lock_loaded = lock is not None

    @property
    def lock(self) -> Optional[dict]:
        if not self._lock_loaded:
            from .engine import default_lock_path

            self._lock = load_lock(default_lock_path())
            self._lock_loaded = True
        return self._lock

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        registry = known_schemas()
        lock_kinds = (self.lock or {}).get("kinds", {})
        for site in collect_schema_sites(ctx):
            if site.error is not None:
                yield Finding(
                    self.rule_id, ctx.path, site.line, site.col,
                    f"malformed schema reference {site.raw!r}: {site.error}",
                )
                continue
            assert site.kind is not None and site.version is not None
            if site.kind not in registry:
                yield Finding(
                    self.rule_id, ctx.path, site.line, site.col,
                    f"schema kind {site.kind!r} is not registered in "
                    "repro_torch.jsonio.KNOWN_SCHEMAS",
                )
                continue
            if site.version != registry[site.kind]:
                yield Finding(
                    self.rule_id, ctx.path, site.line, site.col,
                    f"{site.raw} pins v{site.version} but "
                    f"{site.kind!r} is registered at "
                    f"v{registry[site.kind]} — stale reference or missing "
                    "registry bump",
                )
                continue
            if site.source != "tag" or site.keys is None:
                continue
            locked = lock_kinds.get(site.kind)
            if locked is None:
                yield Finding(
                    self.rule_id, ctx.path, site.line, site.col,
                    f"kind {site.kind!r} is emitted here but absent from "
                    "schemas.lock.json — regenerate with "
                    "`python -m repro_torch.analysis --write-lock`",
                )
                continue
            if locked.get("version") != site.version:
                yield Finding(
                    self.rule_id, ctx.path, site.line, site.col,
                    f"{site.raw} emits v{site.version} but the lock "
                    f"records v{locked.get('version')} — bump the registry "
                    "and regenerate the lock",
                )
                continue
            locked_keys = locked.get("keys")
            if locked_keys is None:
                continue
            extra = sorted(site.keys - set(locked_keys))
            if extra:
                yield Finding(
                    self.rule_id, ctx.path, site.line, site.col,
                    f"{site.raw} emits key(s) {extra} not in "
                    "schemas.lock.json — emitted keys changed: bump the "
                    "schema version and regenerate the lock",
                )


# -- rule 3: frozen-spec ---------------------------------------------------------

_MUTABLE_DEFAULT_CALLS = {
    "list", "dict", "set", "bytearray",
    "numpy.array", "numpy.zeros", "numpy.ones", "numpy.empty",
    "numpy.full", "numpy.arange",
}


class FrozenSpecRule:
    rule_id = "frozen-spec"
    description = (
        "object.__setattr__ outside __post_init__; mutable frozen defaults"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for info in ctx.dataclasses.values():
            if not info.frozen:
                continue
            for name, default in info.fields.items():
                if default is not None and self._mutable_default(ctx, default):
                    yield Finding(
                        self.rule_id, ctx.path, default.lineno,
                        default.col_offset,
                        f"frozen spec `{info.name}.{name}` has a mutable "
                        "default — shared across every instance; use "
                        "dataclasses.field(default_factory=...) or an "
                        "immutable value",
                    )
        for node in ast.walk(ctx.tree):
            if not (
                isinstance(node, ast.Call)
                and ctx.resolve(node.func) == "object.__setattr__"
            ):
                continue
            fn = ctx.enclosing_function(node)
            cls = ctx.enclosing_class(node)
            in_post_init = (
                fn is not None
                and getattr(fn, "name", "") == "__post_init__"
                and cls is not None
                and cls.name in ctx.dataclasses
                and ctx.dataclasses[cls.name].frozen
            )
            if not in_post_init:
                yield Finding(
                    self.rule_id, ctx.path, node.lineno, node.col_offset,
                    "object.__setattr__ outside a frozen dataclass's "
                    "__post_init__ — defeats the frozen-spec contract "
                    "(hash/eq stability, safe sharing across sessions)",
                )

    def _mutable_default(self, ctx: FileContext, node: ast.expr) -> bool:
        if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                             ast.DictComp, ast.SetComp)):
            return True
        if isinstance(node, ast.Call):
            return ctx.resolve(node.func) in _MUTABLE_DEFAULT_CALLS
        return False


# -- rule 4: float-eq ------------------------------------------------------------

#: files where NaN is a live sentinel and float equality is a trap
_FLOAT_EQ_SCOPE = (
    "repro_torch/runtime/telemetry.py", "repro_torch/runtime/estimator.py",
)
_NAN_NAMES = {"numpy.nan", "numpy.NaN", "math.nan", "jax.numpy.nan", "torch.nan"}


class FloatEqRule:
    rule_id = "float-eq"
    description = "== / != against NaN or float literals in sentinel paths"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        scoped = _in_scope(ctx.path, _FLOAT_EQ_SCOPE)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Compare):
                continue
            if not any(isinstance(op, (ast.Eq, ast.NotEq)) for op in node.ops):
                continue
            operands = [node.left, *node.comparators]
            if any(self._is_nan(ctx, o) for o in operands):
                yield Finding(
                    self.rule_id, ctx.path, node.lineno, node.col_offset,
                    "comparison against NaN is always False — NaN is a "
                    "telemetry sentinel; probe with np.isnan/math.isnan",
                )
            elif scoped and any(
                isinstance(o, ast.Constant) and isinstance(o.value, float)
                for o in operands
            ):
                yield Finding(
                    self.rule_id, ctx.path, node.lineno, node.col_offset,
                    "float-literal equality in a NaN-sentinel path — "
                    "rounding/telemetry noise makes exact equality flaky; "
                    "compare with a tolerance or an integer state",
                )

    def _is_nan(self, ctx: FileContext, node: ast.AST) -> bool:
        if ctx.resolve(node) in _NAN_NAMES:
            return True
        return (
            isinstance(node, ast.Call)
            and ctx.resolve(node.func) == "float"
            and len(node.args) == 1
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
            and node.args[0].value.lower() == "nan"
        )


# -- interprocedural rules ------------------------------------------------------
#
# These run over the whole-program view: the engine calls ``prepare(program)``
# once per run, the rule computes findings there, and ``check(ctx)`` replays
# them per file so suppressions/baseline apply exactly like per-file rules.

class _InterprocRule:
    """Shared prepare/replay plumbing for whole-program rules."""

    def __init__(self):
        self._findings: Dict[str, List[Finding]] = {}

    def _store(self, finding: Finding) -> None:
        self._findings.setdefault(finding.path, []).append(finding)

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        yield from self._findings.get(ctx.path, ())


class HostSyncRule(_InterprocRule):
    """PLAN_DEPENDENT host syncs on a step's path (the port's counterpart of
    ``retrace-provenance``).

    The inventory (``nimble.retrace/v1``, boundary kind ``host-sync``)
    records *every* host sync a step entry point reaches with its lattice
    class; only PLAN_DEPENDENT sites are findings — reads whose value
    changes with every plan or routing, so the host waits on each step and
    no CUDA graph can hold the step.  The others stay inventory-only.
    """

    rule_id = "host-sync"
    description = "plan-dependent host syncs on a step's path"

    def __init__(self):
        super().__init__()
        self.analysis = None
        self.sites: List = []

    def prepare(self, program) -> None:
        from .provenance import PLAN_DEPENDENT, analyze_program

        self._findings = {}
        self.analysis = analyze_program(program)
        self.sites = self.analysis.trace_sites()
        for s in self.sites:
            if s.provenance != PLAN_DEPENDENT:
                continue
            self._store(Finding(
                self.rule_id, s.path, s.line, 0,
                f"{s.kind} `{s.detail}` in `{s.function}` is "
                f"PLAN_DEPENDENT — {s.note}",
            ))


class UnitsRule(_InterprocRule):
    """Unit mixing across bytes | bytes_per_s | fraction | price | windows."""

    rule_id = "units"
    description = (
        "unit mixing against the seeded bytes/rate/fraction/price/window "
        "lattice"
    )

    def __init__(self):
        super().__init__()
        self.analysis = None

    def prepare(self, program) -> None:
        from .units import analyze_units

        self._findings = {}
        self.analysis = analyze_units(program)
        for m in self.analysis.mixes:
            self._store(Finding(
                self.rule_id, m.path, m.line, m.col,
                f"`{m.function}` {m.message}",
            ))


class CrossModuleDeterminismRule(_InterprocRule):
    """Hash-ordered returns iterated in deterministic layers.

    The per-file determinism rule sees ``for x in {a, b}``; it cannot see
    ``for x in other_module.live_set()``.  This rule propagates the
    "returns set-iteration order" bit through the call graph (a function
    returning another hash-ordered function's result is hash-ordered too)
    and flags order-sensitive consumption — ledger commit order, schedule
    order, report key order — anywhere in the deterministic scope.
    """

    rule_id = "xmodule-determinism"
    description = (
        "set-iteration order flowing across call boundaries into "
        "deterministic outputs"
    )

    _CONSUMERS = {"list", "tuple", "enumerate"}

    def prepare(self, program) -> None:
        from .callgraph import module_name_of

        self._findings = {}
        hash_order = {
            q for q, s in program.summaries.items() if s.return_hash_order
        }
        # propagate through return_calls until stable (finite, monotone)
        while True:
            grew = False
            for qual, s in sorted(program.summaries.items()):
                if qual in hash_order:
                    continue
                for target in s.return_calls:
                    resolved = program.resolve_target(target, s.module)
                    if resolved in hash_order:
                        hash_order.add(qual)
                        grew = True
                        break
            if not grew:
                break
        self._hash_order = hash_order
        for ctx in program.contexts:
            if not _in_scope(ctx.path, _DETERMINISM_SCOPE):
                continue
            module = module_name_of(ctx.path)
            for node in ast.walk(ctx.tree):
                call = self._consumed_call(ctx, node)
                if call is None:
                    continue
                target = ctx.resolve(call.func)
                if target is None:
                    continue
                resolved = program.resolve_target(target, module)
                if resolved is None or resolved not in hash_order:
                    continue
                # anchor on the call: `ast.comprehension` has no lineno
                self._store(Finding(
                    self.rule_id, ctx.path, call.lineno, call.col_offset,
                    f"iterates the hash-ordered return of `{resolved}` — "
                    "set iteration order leaks into a deterministic "
                    "output; sort at the producer or wrap in sorted(...)",
                ))

    def _consumed_call(
        self, ctx: FileContext, node: ast.AST
    ) -> Optional[ast.Call]:
        """The function call whose result ``node`` consumes order from."""
        if isinstance(node, (ast.For, ast.comprehension)):
            it = node.iter
            return it if isinstance(it, ast.Call) else None
        if isinstance(node, ast.Call) and ctx.resolve(node.func) in (
            self._CONSUMERS
        ):
            if node.args and isinstance(node.args[0], ast.Call):
                return node.args[0]
        return None


# -- registry --------------------------------------------------------------------

RULES = (
    DeterminismRule(),
    SchemaDisciplineRule(),
    FrozenSpecRule(),
    FloatEqRule(),
    HostSyncRule(),
    UnitsRule(),
    CrossModuleDeterminismRule(),
)


def generate_schema_lock(contexts: Iterable[FileContext]) -> dict:
    """Public alias for the lock generator (CLI + selfcheck)."""
    return generate_lock_obj(contexts)
