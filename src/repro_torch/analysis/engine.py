"""Lint engine: file discovery, suppressions, baseline, report.

Counterpart of ``repro/analysis/engine.py``, anchored on the ``repro_torch``
package.  The engine owns everything that is not rule logic:

  * walking roots for ``.py`` files and building one
    :class:`~repro_torch.analysis.context.FileContext` per file;
  * inline suppressions — ``# nimble: ignore[<rule-id>] -- reason`` on
    the flagged line or the comment line directly above it.  The reason is
    mandatory: a suppression without one (or naming an unknown rule, or
    suppressing nothing) is itself a finding (rule id ``suppression``),
    so every grandfathered violation carries a written justification;
  * the committed baseline (``baseline.json``): findings matching a
    baseline entry by ``(rule, path, message)`` — line numbers churn —
    are reported as *baselined*, not failures.  The port's baseline holds
    only the ``host-sync`` debt, each entry naming the ROADMAP item that
    retires it;
  * the ``nimble.lint/v1`` report through :mod:`repro_torch.jsonio`.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Protocol, Sequence, Tuple

from ..jsonio import read_json_file, tag, write_json_file
from .context import FileContext, build_context

#: inline suppression: ``# nimble: ignore[<rule-a>,<rule-b>] -- why``
SUPPRESS_RE = re.compile(
    r"#\s*nimble:\s*ignore\[(?P<rules>[a-z0-9_,\s-]*)\]"
    r"(?:\s*--\s*(?P<reason>.*\S))?\s*$"
)

LINT_KIND = "lint"
BASELINE_KIND = "lint_baseline"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def key(self) -> Tuple[str, str, str]:
        """Baseline identity — line/col churn must not invalidate entries."""
        return (self.rule, self.path, self.message)

    def to_json_obj(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


class Rule(Protocol):
    """A lint rule: stateless check over one resolved file context.

    Interprocedural rules additionally implement
    ``prepare(program: repro_torch.analysis.callgraph.Program)`` — the engine
    builds the whole-program view once per run and calls ``prepare`` on
    every rule that has it before any ``check``; such rules compute their
    findings there and replay them per file from ``check(ctx)``, so
    suppressions and the baseline apply uniformly.
    """

    rule_id: str
    description: str

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        """Yield findings for ``ctx`` (relative paths, 1-based lines)."""
        ...


@dataclasses.dataclass
class Suppression:
    line: int              # line the comment sits on (1-based)
    rules: Tuple[str, ...]
    reason: str
    used: bool = False


def parse_suppressions(source: str) -> List[Suppression]:
    out: List[Suppression] = []
    for i, text in enumerate(source.splitlines(), start=1):
        m = SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = tuple(
            r.strip() for r in m.group("rules").split(",") if r.strip()
        )
        out.append(Suppression(i, rules, (m.group("reason") or "").strip()))
    return out


def _comment_only(line_text: str) -> bool:
    stripped = line_text.strip()
    return stripped.startswith("#")


@dataclasses.dataclass
class AnalysisReport:
    """Aggregate result of one engine run."""

    root: str
    files: int
    findings: List[Finding]              # live (not suppressed/baselined)
    suppressed: List[Finding]
    baselined: List[Finding]
    counts: Dict[str, int]

    @property
    def clean(self) -> bool:
        return not self.findings

    def to_json_obj(self) -> dict:
        return tag(LINT_KIND, {
            "root": self.root,
            "files": self.files,
            "clean": self.clean,
            "counts": {k: self.counts[k] for k in sorted(self.counts)},
            "findings": [f.to_json_obj() for f in self.findings],
            "suppressed": len(self.suppressed),
            "baselined": len(self.baselined),
        })


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(__file__), "baseline.json")


def default_lock_path() -> str:
    return os.path.join(os.path.dirname(__file__), "schemas.lock.json")


def load_baseline(path: Optional[str] = None) -> List[dict]:
    """Baseline entries as dicts (``rule``/``path``/``message`` plus the
    optional ``reason``/``since`` debt fields); missing file = empty."""
    path = path or default_baseline_path()
    if not os.path.exists(path):
        return []
    obj = read_json_file(path)
    out = []
    for e in obj.get("entries", []):
        out.append({
            "rule": e["rule"], "path": e["path"], "message": e["message"],
            "reason": e.get("reason", ""), "since": e.get("since", ""),
        })
    return out


def write_baseline(
    findings: Sequence[Finding], path: str, since: str = ""
) -> None:
    """Write ``findings`` as a fresh baseline (``--update-baseline``).

    Reasons survive regeneration: an existing entry's ``reason``/``since``
    carry over by ``(rule, path, message)`` key.  New entries land with an
    empty reason — which the engine reports as a ``baseline`` finding
    until someone writes the justification, so the baseline can only grow
    *loudly*.
    """
    previous = {
        (e["rule"], e["path"], e["message"]): e
        for e in load_baseline(path)
    }
    entries = []
    for f in sorted(findings, key=lambda f: f.key()):
        old = previous.get(f.key(), {})
        entries.append({
            "rule": f.rule, "path": f.path, "message": f.message,
            "reason": old.get("reason", ""),
            "since": old.get("since", "") or since,
        })
    write_json_file(path, tag(BASELINE_KIND, {"entries": entries}))


class AnalysisEngine:
    """Run a rule set over a file set and classify the findings."""

    def __init__(
        self,
        rules: Sequence[Rule],
        baseline: Optional[Sequence] = None,
    ):
        self.rules = list(rules)
        self.rule_ids = {r.rule_id for r in self.rules} | {
            "suppression", "baseline",
        }
        # entries arrive as (rule, path, message) keys or as full dicts
        self.baseline_entries: Dict[Tuple[str, str, str], dict] = {}
        for e in baseline or []:
            if isinstance(e, dict):
                key = (e["rule"], e["path"], e["message"])
                self.baseline_entries[key] = {
                    "reason": e.get("reason", ""),
                    "since": e.get("since", ""),
                }
            else:
                self.baseline_entries[tuple(e)] = {"reason": "", "since": ""}
        self.baseline = set(self.baseline_entries)
        self.program = None  # whole-program view of the last run()

    # -- per-file --------------------------------------------------------------
    def check_file(self, ctx: FileContext) -> List[Finding]:
        """All raw findings for one file, suppression hygiene included."""
        findings: List[Finding] = []
        for rule in self.rules:
            findings.extend(rule.check(ctx))
        suppressions = parse_suppressions(ctx.source)
        live = self._apply_suppressions(ctx, findings, suppressions)
        live.extend(self._suppression_hygiene(ctx, suppressions))
        return live

    def _apply_suppressions(
        self,
        ctx: FileContext,
        findings: List[Finding],
        suppressions: List[Suppression],
    ) -> List[Finding]:
        by_line: Dict[int, Suppression] = {s.line: s for s in suppressions}
        live: List[Finding] = []
        for f in findings:
            sup = by_line.get(f.line)
            if sup is None:
                above = by_line.get(f.line - 1)
                if above is not None and _comment_only(
                    ctx.lines[above.line - 1]
                ):
                    sup = above
            if sup is not None and f.rule in sup.rules and sup.reason:
                sup.used = True
                live.append(dataclasses.replace(f, rule=f"~{f.rule}"))
            else:
                live.append(f)
        return live

    def _suppression_hygiene(
        self, ctx: FileContext, suppressions: List[Suppression]
    ) -> List[Finding]:
        out: List[Finding] = []
        for s in suppressions:
            if not s.rules:
                out.append(Finding(
                    "suppression", ctx.path, s.line, 0,
                    "suppression names no rule id — use "
                    "`# nimble: ignore[<rule-id>] -- reason`",
                ))
                continue
            unknown = [r for r in s.rules if r not in self.rule_ids]
            if unknown:
                out.append(Finding(
                    "suppression", ctx.path, s.line, 0,
                    f"suppression names unknown rule(s) {unknown}",
                ))
            if not s.reason:
                out.append(Finding(
                    "suppression", ctx.path, s.line, 0,
                    f"suppression of {list(s.rules)} has no written "
                    "justification (append `-- reason`)",
                ))
            elif not s.used and not unknown:
                out.append(Finding(
                    "suppression", ctx.path, s.line, 0,
                    f"suppression of {list(s.rules)} matches no finding — "
                    "stale, remove it",
                ))
        return out

    # -- aggregate -------------------------------------------------------------
    def run(
        self,
        contexts: Iterable[FileContext],
        root: str = "",
        cache=None,
    ) -> AnalysisReport:
        contexts = list(contexts)
        self.program = self.prepare_rules(contexts, cache=cache)
        live: List[Finding] = []
        suppressed: List[Finding] = []
        baselined: List[Finding] = []
        files = 0
        for ctx in contexts:
            files += 1
            for f in self.check_file(ctx):
                if f.rule.startswith("~"):
                    suppressed.append(
                        dataclasses.replace(f, rule=f.rule[1:])
                    )
                elif f.key() in self.baseline:
                    baselined.append(f)
                else:
                    live.append(f)
        live.extend(self._police_baseline(contexts, baselined))
        live.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
        counts: Dict[str, int] = {}
        for f in live:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        return AnalysisReport(root, files, live, suppressed, baselined, counts)

    def prepare_rules(
        self, contexts: Sequence[FileContext], cache=None
    ):
        """Build the whole-program view once and hand it to every rule
        that wants it.  Returns the Program (None when no rule needs it)."""
        interproc = [r for r in self.rules if hasattr(r, "prepare")]
        if not interproc:
            return None
        from .callgraph import build_program

        program = build_program(contexts, cache=cache)
        for rule in interproc:
            rule.prepare(program)
        return program

    def _police_baseline(
        self,
        contexts: Sequence[FileContext],
        baselined: Sequence[Finding],
    ) -> List[Finding]:
        """The baseline's own teeth: entries matching nothing in a scanned
        file are stale, and entries in active use must carry a written
        reason — either way the committed baseline cannot drift silently."""
        scanned = {ctx.path for ctx in contexts}
        used = {f.key() for f in baselined}
        out: List[Finding] = []
        for key in sorted(self.baseline_entries):
            rule, path, message = key
            entry = self.baseline_entries[key]
            if key in used:
                if not entry.get("reason"):
                    out.append(Finding(
                        "baseline", path, 0, 0,
                        f"baseline entry for [{rule}] {message!r} has no "
                        "written reason — justify it or fix the finding",
                    ))
            elif path in scanned:
                out.append(Finding(
                    "baseline", path, 0, 0,
                    f"baseline entry for [{rule}] {message!r} matches no "
                    "finding — stale, remove it",
                ))
        return out


# -- discovery ------------------------------------------------------------------

def iter_python_files(root: str) -> Iterable[str]:
    if os.path.isfile(root):
        yield root
        return
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(
            d for d in dirnames if d != "__pycache__" and not d.startswith(".")
        )
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


#: the package directory that anchors dotted names
ANCHOR = "repro_torch"


def _package_of(path: str) -> str:
    """Dotted package for a file path (``.../src/repro_torch/x/y.py`` ->
    ``repro_torch.x``); empty when no ``repro_torch`` anchor is present."""
    parts = os.path.normpath(os.path.abspath(path)).split(os.sep)
    if ANCHOR not in parts:
        return ""
    pkg = parts[parts.index(ANCHOR):-1]
    return ".".join(pkg)


def build_contexts(
    paths: Sequence[str], rel_to: Optional[str] = None
) -> List[FileContext]:
    contexts: List[FileContext] = []
    for root in paths:
        for path in iter_python_files(root):
            with open(path, encoding="utf-8") as f:
                source = f.read()
            rel = os.path.relpath(path, rel_to) if rel_to else path
            contexts.append(build_context(rel, source, _package_of(path)))
    return contexts


def analyze_paths(
    paths: Sequence[str],
    rules: Optional[Sequence[Rule]] = None,
    baseline: Optional[Sequence[Tuple[str, str, str]]] = None,
    rel_to: Optional[str] = None,
) -> AnalysisReport:
    """Lint ``paths`` with ``rules`` (default: the full registry)."""
    if rules is None:
        from .rules import RULES

        rules = RULES
    engine = AnalysisEngine(rules, baseline)
    contexts = build_contexts(paths, rel_to=rel_to)
    return engine.run(contexts, root=";".join(paths))


def analyze_source(
    source: str,
    path: str = "<fixture>.py",
    rules: Optional[Sequence[Rule]] = None,
    package: str = "",
) -> AnalysisReport:
    """Lint one in-memory source blob (the test-fixture entry point)."""
    if rules is None:
        from .rules import RULES

        rules = RULES
    engine = AnalysisEngine(rules)
    return engine.run([build_context(path, source, package)], root=path)


def _package_from_rel(path: str) -> str:
    """``repro_torch/core/x.py`` -> ``repro_torch.core`` (virtual fixture
    paths)."""
    parts = path.replace("\\", "/").split("/")[:-1]
    if ANCHOR in parts:
        parts = parts[parts.index(ANCHOR):]
    return ".".join(parts)


def analyze_sources(
    files: Sequence[Tuple[str, str]],
    rules: Optional[Sequence[Rule]] = None,
    baseline: Optional[Sequence] = None,
) -> AnalysisReport:
    """Lint several in-memory ``(path, source)`` blobs as one program —
    the fixture entry point for the interprocedural rules, where the
    finding lives in a different file than its cause."""
    if rules is None:
        from .rules import RULES

        rules = RULES
    engine = AnalysisEngine(rules, baseline)
    contexts = [
        build_context(path, source, _package_from_rel(path))
        for path, source in files
    ]
    return engine.run(contexts, root=";".join(p for p, _ in files))


# -- suppression/baseline debt ---------------------------------------------------

def collect_debt(
    contexts: Iterable[FileContext],
    baseline_entries: Optional[Sequence[dict]] = None,
) -> dict:
    """Every grandfathered violation in one ledger (``--debt``).

    Inline suppressions are read straight from the scanned sources;
    baseline entries come from the committed file, with their
    ``reason``/``since`` age fields.  The port ships no suppression and
    only ``host-sync`` baseline entries: its tests pin both.
    """
    suppressions = []
    for ctx in sorted(contexts, key=lambda c: c.path):
        for s in parse_suppressions(ctx.source):
            suppressions.append({
                "path": ctx.path,
                "line": s.line,
                "rules": sorted(s.rules),
                "reason": s.reason,
            })
    entries = [dict(e) for e in (baseline_entries or [])]
    entries.sort(key=lambda e: (e["rule"], e["path"], e["message"]))
    return {
        "suppressions": suppressions,
        "baseline": entries,
        "total": len(suppressions) + len(entries),
    }
