"""Schema-site collection and the ``schemas.lock.json`` manifest.

Counterpart of ``repro/analysis/schemas.py``; the port's lock records its
own record sites.  The schema-discipline rule and the lock generator share one scanner:
:func:`collect_schema_sites` finds, per file,

  * every ``nimble.<kind>/vN`` string literal (validators, docstrings —
    stale version references in prose are staleness too), strict-parsed
    through :func:`repro_torch.jsonio.parse_schema_id`;
  * every ``repro_torch.jsonio.tag(kind, payload, version=...)`` call, with the
    kind seen through module-level string constants and the payload keys
    statically recovered from dict literals or ``dataclasses.asdict(self)``
    against the enclosing dataclass's fields.

The lock (``schemas.lock.json``, a ``nimble.schemas_lock/v1`` record) is
the committed manifest of every kind emitted under ``src/repro_torch`` with its
version and the union of statically-known emitted keys.  The rule checks
call sites against it (a new key without a version bump + regeneration is
a finding); ``--check-lock`` and the selfcheck's check 8 check that
regenerating it is a no-op, so key *removals* fail closed too.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, FrozenSet, Iterable, List, Optional

from ..jsonio import parse_schema_id, read_json_file, tag, write_json_file
from .context import FileContext

#: loose detection net for schema-id-shaped strings; strict validation is
#: ``parse_schema_id`` so near-misses surface as findings, not silence
SCHEMA_LITERAL_RE = re.compile(r"nimble\.[A-Za-z0-9_.-]*/v[A-Za-z0-9_.-]*")

LOCK_KIND = "schemas_lock"


@dataclasses.dataclass(frozen=True)
class SchemaSite:
    """One place a schema id is minted or referenced."""

    path: str
    line: int
    col: int
    kind: Optional[str]            # None when not statically resolvable
    version: Optional[int]         # None when not statically resolvable
    keys: Optional[FrozenSet[str]]  # None when payload keys are unknown
    source: str                    # "literal" | "tag"
    raw: str                       # the literal text / call description
    error: Optional[str] = None    # strict-parse failure, if any


def collect_schema_sites(ctx: FileContext) -> List[SchemaSite]:
    sites: List[SchemaSite] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            sites.extend(_literal_sites(ctx, node))
        elif isinstance(node, ast.Call) and _is_tag_call(ctx, node):
            sites.append(_tag_site(ctx, node))
    return sites


def _literal_sites(
    ctx: FileContext, node: ast.Constant
) -> Iterable[SchemaSite]:
    for m in SCHEMA_LITERAL_RE.finditer(node.value):
        raw = m.group(0)
        try:
            kind, version = parse_schema_id(raw)
            err = None
        except ValueError as e:
            kind = version = None
            err = str(e)
        yield SchemaSite(
            ctx.path, node.lineno, node.col_offset, kind, version,
            None, "literal", raw, err,
        )


def _is_tag_call(ctx: FileContext, call: ast.Call) -> bool:
    target = ctx.resolve(call.func)
    return target is not None and (
        target.endswith("jsonio.tag") or target == "jsonio.tag"
    )


def _tag_site(ctx: FileContext, call: ast.Call) -> SchemaSite:
    kind = ctx.string_value(call.args[0]) if call.args else None
    version: Optional[int] = 1
    if len(call.args) >= 3:
        version = _const_int(call.args[2])
    for kw in call.keywords:
        if kw.arg == "version":
            version = _const_int(kw.value)
    error = None
    if kind is None:
        error = "tag() kind is not a static string"
    elif version is None:
        error = f"tag({kind!r}) version is not a static integer"
    keys = _payload_keys(ctx, call) if kind is not None else None
    return SchemaSite(
        ctx.path, call.lineno, call.col_offset, kind, version, keys,
        "tag", f"tag({kind!r})", error,
    )


def _const_int(node: ast.AST) -> Optional[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) and (
        not isinstance(node.value, bool)
    ):
        return node.value
    return None


def _payload_keys(
    ctx: FileContext, call: ast.Call
) -> Optional[FrozenSet[str]]:
    if len(call.args) < 2:
        return None
    payload = call.args[1]
    if isinstance(payload, ast.Dict):
        keys: List[str] = []
        for k in payload.keys:
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                keys.append(k.value)
            else:
                return None  # **splat or computed key — keys unknown
        return frozenset(keys)
    if isinstance(payload, ast.Call):
        target = ctx.resolve(payload.func)
        if target in ("dataclasses.asdict", "asdict") and payload.args:
            arg = payload.args[0]
            if isinstance(arg, ast.Name) and arg.id == "self":
                cls = ctx.enclosing_class(call)
                if cls is not None and cls.name in ctx.dataclasses:
                    return frozenset(ctx.dataclasses[cls.name].fields)
    return None


# -- lock generation / freshness -------------------------------------------------

def generate_lock_obj(contexts: Iterable[FileContext]) -> dict:
    """Scan ``contexts`` into a ``nimble.schemas_lock/v1`` manifest."""
    kinds: Dict[str, dict] = {}
    for ctx in contexts:
        for site in collect_schema_sites(ctx):
            if site.kind is None or site.version is None:
                continue  # malformed sites are rule findings, not lock input
            entry = kinds.setdefault(
                site.kind,
                {"version": site.version, "keys": None, "sites": 0},
            )
            entry["sites"] += 1
            entry["version"] = max(entry["version"], site.version)
            if site.keys is not None:
                known = set(entry["keys"] or [])
                entry["keys"] = sorted(known | site.keys)
    return tag(LOCK_KIND, {"kinds": {k: kinds[k] for k in sorted(kinds)}})


def write_lock(contexts: Iterable[FileContext], path: str) -> dict:
    obj = generate_lock_obj(contexts)
    write_json_file(path, obj)
    return obj


def load_lock(path: str) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    return read_json_file(path)


def lock_is_fresh(path: str, contexts: Iterable[FileContext]) -> bool:
    """True iff regenerating the lock from ``contexts`` is a no-op."""
    committed = load_lock(path)
    if committed is None:
        return False
    return _normalize(committed) == _normalize(generate_lock_obj(contexts))


def _normalize(obj):
    if isinstance(obj, dict):
        return {k: _normalize(obj[k]) for k in sorted(obj)}
    if isinstance(obj, list):
        return [_normalize(x) for x in obj]
    return obj
