"""Whole-program model: modules, function summaries, call graph, cache.

Counterpart of ``repro/analysis/callgraph.py``.  The interprocedural
analyses ask questions across module boundaries ("does this host read on
the train step's path derive from the plan?"), which the per-file
:class:`~repro_torch.analysis.context.FileContext` cannot answer alone.  This
module builds the shared whole-program substrate:

  * :func:`module_name_of` — file path -> dotted module name;
  * :class:`FunctionSummary` — the compact, JSON-serializable facts one
    function contributes to the interprocedural fixpoints: parameters,
    resolved call targets, which params/calls flow into its return value,
    and whether the return value carries set/hash iteration order;
  * :class:`Program` — every summary plus the AST handles the analyses
    still need, with cross-module call resolution (module-level
    functions, ``self.method`` within a class, and unique-basename
    method resolution with a stoplist for stdlib-shaped names);
  * :class:`CallGraph` — caller -> callee qualname edges, with a stable
    JSON form pinned by the reference's golden fixture (the port's tests
    hold both packages to it);
  * :meth:`Program.reachable` — every function a set of entry points may
    reach, over an edge set that errs the other way: where a method name is
    ambiguous every function of that name in the modules the caller
    imports is a callee (``host-sync`` counts sites on a step's path, and a
    missing edge would hide one);
  * :class:`SummaryCache` — summaries keyed by per-file source digest
    (``sha256``), so re-analysis after an edit recomputes only the edited
    file's summaries.  The cache rides the same JSON conventions as
    ``schemas.lock.json`` (``nimble.callgraph/v1``) and is regenerated by
    ``python -m repro_torch.analysis --write-lock``.

Summaries are deliberately shallow — they record *syntactic* dataflow
facts; the lattice semantics (provenance classes, units) live in
:mod:`repro_torch.analysis.provenance` and :mod:`repro_torch.analysis.units`,
which run their fixpoints over this graph.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import os
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..jsonio import read_json_file, tag, write_json_file
from .context import FileContext

CALLGRAPH_KIND = "callgraph"

#: the package directory that anchors module names
ANCHOR = "repro_torch"

#: method basenames never resolved by unique-suffix matching — they are
#: stdlib/container-shaped and a wrong edge is worse than a missing one
_RESOLVE_STOPLIST = {
    "append", "extend", "insert", "add", "update", "pop", "remove",
    "clear", "get", "items", "keys", "values", "setdefault", "copy",
    "join", "split", "strip", "startswith", "endswith", "format",
    "sum", "mean", "max", "min", "astype", "reshape", "sort", "tolist",
    "item", "read", "write", "close", "encode", "decode", "count",
}


def module_name_of(path: str) -> str:
    """Dotted module name for a (repo-relative) file path.

    ``repro_torch/core/cost.py`` -> ``repro_torch.core.cost``;
    ``repro_torch/obs/__init__.py`` -> ``repro_torch.obs``.  Fixture paths
    without a package anchor fall back to the slash-to-dot spelling so
    virtual test files still get stable names.
    """
    p = path.replace("\\", "/")
    if p.endswith(".py"):
        p = p[:-3]
    parts = [seg for seg in p.split("/") if seg]
    if ANCHOR in parts:
        parts = parts[parts.index(ANCHOR):]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def source_digest(source: str) -> str:
    return hashlib.sha256(source.encode("utf-8")).hexdigest()


@dataclasses.dataclass
class FunctionSummary:
    """Per-function facts consumed by the interprocedural fixpoints."""

    qualname: str                  # module.Class.func or module.func
    module: str
    params: Tuple[str, ...]
    line: int
    calls: Tuple[str, ...]         # resolved call-target spellings
    return_params: Tuple[str, ...]  # params that flow into return exprs
    return_calls: Tuple[str, ...]   # call targets whose results are returned
    return_hash_order: bool         # return carries set/hash iteration order

    def to_json_obj(self) -> dict:
        return {
            "qualname": self.qualname,
            "module": self.module,
            "params": list(self.params),
            "line": self.line,
            "calls": sorted(set(self.calls)),
            "return_params": sorted(set(self.return_params)),
            "return_calls": sorted(set(self.return_calls)),
            "return_hash_order": self.return_hash_order,
        }

    @classmethod
    def from_json_obj(cls, obj: dict) -> "FunctionSummary":
        return cls(
            qualname=obj["qualname"],
            module=obj["module"],
            params=tuple(obj["params"]),
            line=int(obj["line"]),
            calls=tuple(obj["calls"]),
            return_params=tuple(obj["return_params"]),
            return_calls=tuple(obj["return_calls"]),
            return_hash_order=bool(obj["return_hash_order"]),
        )


def _params_of(node: ast.AST) -> Tuple[str, ...]:
    args = getattr(node, "args", None)
    if args is None:
        return ()
    names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    if args.vararg:
        names.append(args.vararg.arg)
    if args.kwarg:
        names.append(args.kwarg.arg)
    return tuple(names)


def _set_producing(ctx: FileContext, node: ast.AST) -> bool:
    """Syntactically set-ordered expression (mirrors the determinism rule;
    ``sorted(...)`` neutralizes)."""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        target = ctx.resolve(node.func)
        if target in ("set", "frozenset"):
            return True
        if target in ("list", "tuple") and node.args:
            return _set_producing(ctx, node.args[0])
        if isinstance(node.func, ast.Attribute) and node.func.attr in (
            "union", "intersection", "difference", "symmetric_difference",
        ):
            return _set_producing(ctx, node.func.value)
    if isinstance(node, ast.BinOp) and isinstance(
        node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)
    ):
        return _set_producing(ctx, node.left) or _set_producing(
            ctx, node.right
        )
    return False


def summarize_module(ctx: FileContext) -> List[FunctionSummary]:
    """Extract every function's summary from one parsed file."""
    module = module_name_of(ctx.path)
    out: List[FunctionSummary] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        cls = ctx.enclosing_class(node)
        qual = (
            f"{module}.{cls.name}.{node.name}" if cls is not None
            else f"{module}.{node.name}"
        )
        params = _params_of(node)
        calls: List[str] = []
        return_params: List[str] = []
        return_calls: List[str] = []
        hash_order = False
        for sub in ast.walk(node):
            # skip nested defs' internals for return facts but keep their
            # calls (a nested body still runs under the outer's contract)
            if isinstance(sub, ast.Call):
                target = _resolve_call(ctx, cls, module, sub)
                if target:
                    calls.append(target)
            if isinstance(sub, (ast.Return, ast.Yield, ast.YieldFrom)):
                value = getattr(sub, "value", None)
                if value is None:
                    continue
                if ctx.enclosing_function(sub) is not node and not isinstance(
                    sub, (ast.Yield, ast.YieldFrom)
                ):
                    continue  # a nested def's return, not ours
                pset = set(params)
                for n in ast.walk(value):
                    if isinstance(n, ast.Name) and n.id in pset:
                        return_params.append(n.id)
                    elif isinstance(n, ast.Call):
                        t = _resolve_call(ctx, cls, module, n)
                        if t:
                            return_calls.append(t)
                if _set_producing(ctx, value):
                    hash_order = True
        out.append(FunctionSummary(
            qual, module, params, node.lineno,
            tuple(sorted(set(calls))),
            tuple(sorted(set(return_params))),
            tuple(sorted(set(return_calls))),
            hash_order,
        ))
    out.sort(key=lambda s: (s.line, s.qualname))
    return out


def _resolve_call(
    ctx: FileContext,
    cls: Optional[ast.ClassDef],
    module: str,
    call: ast.Call,
) -> Optional[str]:
    """Best-effort spelling of a call target.

    ``self.foo`` / ``cls.foo`` keep their prefix (the Program qualifies
    them against the enclosing class); everything else goes through the
    context's alias resolution, so imported names come back fully dotted.
    """
    target = ctx.resolve(call.func)
    if target is None:
        return None
    head = target.split(".", 1)[0]
    if head in ("self", "cls") and cls is not None:
        return f"{module}.{cls.name}.{target.split('.', 1)[1]}" if (
            "." in target
        ) else None
    return target


class Program:
    """Whole-program view: summaries + AST handles + call resolution."""

    def __init__(self, contexts: Iterable[FileContext],
                 cache: Optional["SummaryCache"] = None):
        self.contexts: List[FileContext] = sorted(
            contexts, key=lambda c: c.path
        )
        self.modules: Dict[str, FileContext] = {}
        self.summaries: Dict[str, FunctionSummary] = {}
        #: qualname -> (ctx, FunctionDef) for analyses that re-walk bodies
        self.nodes: Dict[str, Tuple[FileContext, ast.AST]] = {}
        self._by_basename: Dict[str, List[str]] = {}
        for ctx in self.contexts:
            module = module_name_of(ctx.path)
            self.modules[module] = ctx
            digest = source_digest(ctx.source)
            cached = cache.get(ctx.path, digest) if cache is not None else None
            summaries = (
                cached if cached is not None else summarize_module(ctx)
            )
            if cache is not None and cached is None:
                cache.put(ctx.path, digest, summaries)
            for s in summaries:
                self.summaries[s.qualname] = s
                base = s.qualname.rsplit(".", 1)[1]
                self._by_basename.setdefault(base, []).append(s.qualname)
        #: module -> the program's modules it imports
        self._imports: Dict[str, Set[str]] = {}
        for ctx in self.contexts:
            module = module_name_of(ctx.path)
            mods: Set[str] = set()
            for dotted in ctx.aliases.values():
                parts = dotted.split(".")
                for k in range(len(parts), 0, -1):
                    if ".".join(parts[:k]) in self.modules:
                        mods.add(".".join(parts[:k]))
                        break
            self._imports[module] = mods
        # AST handles are always re-derived (cheap; the cache only spares
        # the summary extraction walk)
        for ctx in self.contexts:
            module = module_name_of(ctx.path)
            for node in ast.walk(ctx.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    c = ctx.enclosing_class(node)
                    qual = (
                        f"{module}.{c.name}.{node.name}" if c is not None
                        else f"{module}.{node.name}"
                    )
                    self.nodes.setdefault(qual, (ctx, node))

    # -- resolution --------------------------------------------------------------
    def resolve_target(
        self, target: str, module: Optional[str] = None
    ) -> Optional[str]:
        """Canonical qualname for a call-target spelling, if known.

        Resolution order: exact qualname; module-local bare name; imported
        dotted name; unique method basename across the program (stoplisted
        names never match — a missing edge beats a wrong one).
        """
        if target in self.summaries:
            return target
        if module is not None and f"{module}.{target}" in self.summaries:
            return f"{module}.{target}"
        base = target.rsplit(".", 1)[-1]
        if base in _RESOLVE_STOPLIST:
            return None
        candidates = self._by_basename.get(base, ())
        if len(candidates) == 1:
            cand = candidates[0]
            # a dotted spelling must not contradict the candidate's module
            if "." not in target or cand.endswith(
                "." + ".".join(target.split(".")[-2:])
            ) or target.split(".")[0] in ("self", "cls"):
                return cand
            return cand if cand.endswith("." + base) else None
        return None

    # -- reachability (may-call) -------------------------------------------------
    def may_callees(self, qual: str, skip=None) -> List[str]:
        """Every function ``qual`` may call or hand on.

        A call target resolves as in :meth:`resolve_target`; where that
        finds none, a method name stands for every function of that name in
        the modules the caller's module imports (or its own; stoplisted
        names match none), and a call through a local name that resolves to
        nothing for every ``__call__`` there.  Names from outside the
        package (``torch``, ``numpy``, the stdlib) are no callees.  A class called is its
        ``__init__``/``__post_init__``/``__call__``, an autograd Function's
        ``apply`` its ``forward``/``backward``.  A function named as a value
        (passed on, a method read as an attribute) is a callee when it
        resolves exactly.  The functions defined inside ``qual`` are
        reachable from it.  ``skip(ctx, node)`` leaves out the code it is
        true of.
        """
        ctx, node = self.nodes[qual]
        module = self.summaries[qual].module
        cls = ctx.enclosing_class(node)
        local = set(self.summaries[qual].params) | {
            n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)
        }
        external = {v.split(".")[0] for v in ctx.aliases.values()} - {ANCHOR}
        out: Set[str] = set()
        for sub in ast.walk(node):
            if skip is not None and sub is not node and skip(ctx, sub):
                continue
            if sub is not node and isinstance(sub, (ast.FunctionDef,
                                                    ast.AsyncFunctionDef)):
                c = ctx.enclosing_class(sub)
                out.add(f"{module}.{c.name}.{sub.name}" if c is not None
                        else f"{module}.{sub.name}")
                continue
            if not isinstance(sub, (ast.Name, ast.Attribute)):
                continue
            target = ctx.resolve(sub)
            if target is None:
                continue
            head, _, rest = target.partition(".")
            if head in ("self", "cls") and cls is not None and rest:
                target = f"{module}.{cls.name}.{rest}"
            if target.split(".")[0] in external:
                continue                 # torch.*, numpy.*, the stdlib
            parent = ctx.parents.get(sub)
            called = isinstance(parent, ast.Call) and parent.func is sub
            if isinstance(sub, ast.Name) and called and sub.id not in local:
                called = False           # a builtin or a global, not an object
            out.update(self._may_resolve(target, module, sub, called))
        out.discard(qual)
        return sorted(q for q in out if q in self.summaries)

    def _may_resolve(self, target: str, module: str, node: ast.AST,
                     called: bool) -> List[str]:
        for cand in (target, f"{module}.{target}"):
            if cand in self.summaries:
                return [cand]
            members = [f"{cand}.{m}" for m in ("__init__", "__post_init__",
                                               "__call__")]
            if cand.endswith(".apply"):
                members = [f"{cand[:-6]}.forward", f"{cand[:-6]}.backward"]
            members = [m for m in members if m in self.summaries]
            if members:
                return members
        if not called:
            return []
        exact = self.resolve_target(target, module)
        if exact is not None:
            return [exact]
        base = target.rsplit(".", 1)[-1]
        if isinstance(node, ast.Attribute) and base not in _RESOLVE_STOPLIST:
            names = self._by_basename.get(base, ())
        elif isinstance(node, ast.Name):
            names = self._by_basename.get("__call__", ())
        else:
            return []
        seen = self._imports.get(module, set()) | {module}
        return [q for q in names if self.summaries[q].module in seen]

    def reachable(self, entries: Iterable[str], skip=None) -> Set[str]:
        """Every function that ``entries`` may reach (themselves included),
        not through the code ``skip`` is true of (:meth:`may_callees`)."""
        seen: Set[str] = set()
        todo = sorted(q for q in entries if q in self.nodes)
        while todo:
            qual = todo.pop()
            if qual in seen:
                continue
            seen.add(qual)
            todo.extend(q for q in self.may_callees(qual, skip)
                        if q not in seen and q in self.nodes)
        return seen

    def function(self, qualname: str) -> Optional[FunctionSummary]:
        return self.summaries.get(qualname)

    def iter_functions(self) -> Iterable[FunctionSummary]:
        for qual in sorted(self.summaries):
            yield self.summaries[qual]

    def call_graph(self) -> "CallGraph":
        edges: Dict[str, List[str]] = {}
        for s in self.iter_functions():
            resolved = []
            for target in s.calls:
                r = self.resolve_target(target, s.module)
                if r is not None and r != s.qualname:
                    resolved.append(r)
            edges[s.qualname] = sorted(set(resolved))
        return CallGraph(edges)


class CallGraph:
    """Caller -> callee qualname edges with a stable JSON form."""

    def __init__(self, edges: Dict[str, List[str]]):
        self.edges = edges

    def callees(self, qualname: str) -> List[str]:
        return self.edges.get(qualname, [])

    def callers(self, qualname: str) -> List[str]:
        return sorted(
            caller for caller, callees in self.edges.items()
            if qualname in callees
        )

    @property
    def n_edges(self) -> int:
        return sum(len(v) for v in self.edges.values())

    def to_json_obj(self) -> dict:
        return tag(CALLGRAPH_KIND, {
            "functions": len(self.edges),
            "edges": {
                k: self.edges[k] for k in sorted(self.edges) if self.edges[k]
            },
        })


# -- summary cache ----------------------------------------------------------------

class SummaryCache:
    """Digest-keyed per-file summary cache (``nimble.callgraph/v1``).

    ``get`` misses when the file's source digest changed — edits
    invalidate exactly the edited file.  ``save`` persists only entries
    touched this run (``prune=True`` drops entries for files that were
    neither hit nor recomputed, keeping the cache in lockstep with the
    scanned tree).
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._entries: Dict[str, dict] = {}
        self._live: Set[str] = set()
        self.hits = 0
        self.misses = 0
        if path is not None and os.path.exists(path):
            obj = read_json_file(path)
            self._entries = dict(obj.get("files", {}))

    def get(self, path: str, digest: str) -> Optional[List[FunctionSummary]]:
        entry = self._entries.get(path)
        if entry is None or entry.get("digest") != digest:
            self.misses += 1
            return None
        self.hits += 1
        self._live.add(path)
        return [
            FunctionSummary.from_json_obj(o) for o in entry["functions"]
        ]

    def put(
        self, path: str, digest: str, summaries: List[FunctionSummary]
    ) -> None:
        self._entries[path] = {
            "digest": digest,
            "functions": [s.to_json_obj() for s in summaries],
        }
        self._live.add(path)

    def to_json_obj(self, prune: bool = True) -> dict:
        files = {
            p: self._entries[p] for p in sorted(self._entries)
            if not prune or p in self._live
        }
        return tag(CALLGRAPH_KIND, {"files": files})

    def save(self, path: Optional[str] = None, prune: bool = True) -> str:
        out = path or self.path
        if out is None:
            raise ValueError("SummaryCache has no path to save to")
        write_json_file(out, self.to_json_obj(prune=prune))
        return out


def build_program(
    contexts: Iterable[FileContext], cache: Optional[SummaryCache] = None
) -> Program:
    """The analyses' entry point: contexts -> resolved whole program."""
    return Program(contexts, cache=cache)
