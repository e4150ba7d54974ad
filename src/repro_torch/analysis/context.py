"""Shared per-file resolution context for the lint rules.

Counterpart of ``repro/analysis/context.py``.  One parse + one resolution
pass per file, consumed by every rule:

  * **import/alias resolution** — ``import numpy as np`` makes
    ``np.random.rand`` resolve to ``numpy.random.rand``; relative
    imports (``from ..jsonio import tag``) canonicalize against the
    file's package so ``tag(...)`` resolves to ``repro_torch.jsonio.tag``;
  * **module-level string constants** — ``TRACE_KIND = "trace"`` lets
    the schema rule see through ``tag(TRACE_KIND, ...)``;
  * **dataclass detection** — which classes are ``@dataclasses.dataclass``
    (and which are ``frozen=True``), their field names/default nodes, so
    the frozen-spec rule and ``dataclasses.asdict(self)`` key inference
    work without executing anything;
  * **step entry points** — where the reference finds its jit entry points
    and ``lax.scan`` bodies (the bodies JAX traces), the port finds the
    functions a step runs from (:data:`STEP_ENTRY_POINTS`, and the
    ``forward``/``backward`` of every ``torch.autograd.Function`` under
    ``kernels/``), which the ``host-sync`` rule walks the call graph from;
  * **parent links** — every node knows its enclosing function/class.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Tuple

#: the port's step entry points: (file, enclosing function or None, function)
#: -> the kind of step
STEP_ENTRY_POINTS = {
    ("repro_torch/train/step.py", "make_train_step", "train_step"): "train-step",
    ("repro_torch/serve/engine.py", "make_serve_step", "serve_step"): "serve-step",
    ("repro_torch/core/planner.py", None, "plan_flows_batch"): "planner",
}
#: files whose ``torch.autograd.Function`` classes' forward and backward are
#: entry points
_AUTOGRAD_SCOPE = "repro_torch/kernels/"
_FUNCTION_BASES = {"torch.autograd.Function"}
_DATACLASS_NAMES = {"dataclasses.dataclass", "dataclass"}


@dataclasses.dataclass
class DataclassInfo:
    """A ``@dataclass`` class found in the file."""

    node: ast.ClassDef
    frozen: bool
    # field name -> default expression node (None when no default)
    fields: Dict[str, Optional[ast.expr]]

    @property
    def name(self) -> str:
        return self.node.name


@dataclasses.dataclass
class StepEntryInfo:
    """A function a step runs from."""

    node: ast.FunctionDef
    kind: str                      # train-step | serve-step | planner | autograd

    @property
    def name(self) -> str:
        return self.node.name


def _norm(path: str) -> str:
    return "/" + path.replace("\\", "/").lstrip("/")


class FileContext:
    """Everything the rules need to know about one parsed file."""

    def __init__(self, path: str, source: str, package: str = ""):
        self.path = path
        self.source = source
        self.package = package
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self.aliases = self._collect_imports()
        self.constants = self._collect_constants()
        self.dataclasses = self._collect_dataclasses()
        self.step_entries = self._collect_step_entries()

    # -- imports ---------------------------------------------------------------
    def _collect_imports(self) -> Dict[str, str]:
        aliases: Dict[str, str] = {}
        pkg_parts = self.package.split(".") if self.package else []
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    # ``import a.b`` binds ``a``; ``import a.b as c`` binds c
                    if a.asname:
                        aliases[a.asname] = a.name
                    else:
                        root = a.name.split(".")[0]
                        aliases.setdefault(root, root)
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if node.level:
                    # relative: resolve against this file's package
                    base = pkg_parts[: len(pkg_parts) - (node.level - 1)]
                    mod = ".".join(base + ([mod] if mod else []))
                for a in node.names:
                    if a.name == "*":
                        continue
                    bound = a.asname or a.name
                    aliases[bound] = f"{mod}.{a.name}" if mod else a.name
        return aliases

    def _collect_constants(self) -> Dict[str, str]:
        """Module-level ``NAME = "literal"`` string constants."""
        out: Dict[str, str] = {}
        for node in self.tree.body:
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
            ):
                out[node.targets[0].id] = node.value.value
        return out

    # -- name resolution -------------------------------------------------------
    def resolve(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted name for a Name/Attribute chain (else None).

        ``np.random.rand`` -> ``numpy.random.rand`` given
        ``import numpy as np``; bare builtins resolve to themselves.
        """
        parts: List[str] = []
        cur = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if not isinstance(cur, ast.Name):
            return None
        root = self.aliases.get(cur.id, cur.id)
        parts.append(root)
        return ".".join(reversed(parts))

    def string_value(self, node: ast.AST) -> Optional[str]:
        """Constant string value of a node, seeing through module constants."""
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.Name):
            return self.constants.get(node.id)
        return None

    # -- dataclasses -----------------------------------------------------------
    def _collect_dataclasses(self) -> Dict[str, DataclassInfo]:
        out: Dict[str, DataclassInfo] = {}
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            frozen = None
            for dec in node.decorator_list:
                target, kws = self._decorator_call(dec)
                if target in _DATACLASS_NAMES:
                    frozen = any(
                        kw.arg == "frozen"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value is True
                        for kw in kws
                    )
            if frozen is None:
                continue
            fields: Dict[str, Optional[ast.expr]] = {}
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name
                ):
                    if isinstance(stmt.annotation, ast.Name) and (
                        stmt.annotation.id == "ClassVar"
                    ):
                        continue
                    fields[stmt.target.id] = stmt.value
            out[node.name] = DataclassInfo(node, frozen, fields)
        return out

    def _decorator_call(
        self, dec: ast.AST
    ) -> Tuple[Optional[str], List[ast.keyword]]:
        """(resolved target, keywords) of a decorator, Call or bare."""
        if isinstance(dec, ast.Call):
            return self.resolve(dec.func), dec.keywords
        return self.resolve(dec), []

    # -- step entry points -----------------------------------------------------
    def _collect_step_entries(self) -> List[StepEntryInfo]:
        path = _norm(self.path)
        named = {
            (outer, name): kind
            for (file, outer, name), kind in STEP_ENTRY_POINTS.items()
            if path.endswith("/" + file)
        }
        autograd = f"/{_AUTOGRAD_SCOPE}" in path
        out: List[StepEntryInfo] = []
        for node in ast.walk(self.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            outer = self.enclosing_function(node)
            key = (getattr(outer, "name", None), node.name)
            if key in named:
                out.append(StepEntryInfo(node, named[key]))
                continue
            cls = self.enclosing_class(node)
            if (
                autograd
                and node.name in ("forward", "backward")
                and cls is not None
                and self.parents.get(node) is cls
                and any(self.resolve(b) in _FUNCTION_BASES for b in cls.bases)
            ):
                out.append(StepEntryInfo(node, "autograd"))
        return out

    # -- lexical queries -------------------------------------------------------
    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return cur
            cur = self.parents.get(cur)
        return None

    def enclosing_def(self, node: ast.AST) -> Optional[ast.AST]:
        """The innermost ``def`` around ``node`` (lambdas see through)."""
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self.parents.get(cur)
        return None

    def enclosing_class(self, node: ast.AST) -> Optional[ast.ClassDef]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return cur
            cur = self.parents.get(cur)
        return None


def build_context(path: str, source: str, package: str = "") -> FileContext:
    """Parse ``source`` into a :class:`FileContext` (rules' entry point)."""
    return FileContext(path, source, package)
