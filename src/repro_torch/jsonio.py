"""JSON bytes IO and the shared record envelope.

Counterpart of ``repro/jsonio.py`` with the stdlib ``json`` backend only:
the same on-disk format, the same ``schema`` envelope and registry, so the
port's records (fabsim results, runtime windows and traces) parse into the
same objects as the reference's.

Records that cross files share one envelope: :func:`tag` stamps a
``schema`` field of the form ``nimble.<kind>/v<version>`` so consumers can
dispatch on it without per-file format knowledge.
"""

from __future__ import annotations

import json
import re as _re


def json_dumps(obj, *, indent: bool = False) -> bytes:
    return json.dumps(obj, indent=2 if indent else None).encode()


def json_loads(data: bytes):
    return json.loads(data)


# -- shared record schema -------------------------------------------------------

SCHEMA_PREFIX = "nimble"

#: a well-formed kind: lowercase snake, leading letter
_KIND_RE = _re.compile(r"^[a-z][a-z0-9_]*$")

#: registry of known record kinds -> current schema version, the same as
#: the reference's: tagging a registered kind at another version raises.
KNOWN_SCHEMAS = {
    # core / fabsim
    "simresult": 1,
    # runtime (telemetry, estimator, controller, events)
    "telemetry_window": 1,
    "telemetry_aggregate": 1,
    "telemetry_log": 1,
    "runtime_window": 1,
    "runtime_stats": 1,
    "runtime_trace": 1,
    "link_event": 1,
    # fabric
    "fabric_state": 1,
    "fabric_arbiter": 1,
    "fabric_arbiter_stats": 1,
    "fabric_fairness": 1,
    # faults
    "fault_schedule": 1,
    "fault_drill": 1,
    # serve
    "serve_scenario": 1,
    "serve": 1,
    # api
    "session": 1,
    # obs
    "trace": 1,
    "metrics": 1,
    "plan_provenance": 1,
    "provenance_log": 1,
    # analysis
    "lint": 1,
    "lint_baseline": 1,
    "schemas_lock": 1,
    # analysis dataflow
    "retrace": 1,
    "retrace_lock": 1,
    "units": 1,
    "callgraph": 1,
    "lint_debt": 1,
    # bench outputs (benchmarks/run.py)
    "bench_runtime_adapt": 1,
    "bench_fairness": 1,
    "bench_faults": 1,
    "bench_obs": 1,
    "bench_lint": 1,
}


def known_schemas() -> dict:
    """Copy of the kind -> current-version registry."""
    return dict(KNOWN_SCHEMAS)


def parse_schema_id(schema_id: str):
    """Strictly parse ``nimble.<kind>/v<version>`` -> ``(kind, version)``.

    Rejects malformed ids — wrong prefix, bad kind spelling, missing or
    non-integer version — with a ``ValueError`` naming the offending id.
    """
    if not isinstance(schema_id, str):
        raise ValueError(f"schema id must be a string, got {schema_id!r}")
    prefix, dot, rest = schema_id.partition(".")
    if not dot or prefix != SCHEMA_PREFIX:
        raise ValueError(
            f"malformed schema id {schema_id!r}: expected prefix "
            f"'{SCHEMA_PREFIX}.'"
        )
    kind, slash, tail = rest.rpartition("/")
    if not slash:
        raise ValueError(
            f"malformed schema id {schema_id!r}: missing '/v<version>'"
        )
    if not _KIND_RE.match(kind):
        raise ValueError(
            f"malformed schema id {schema_id!r}: kind {kind!r} must match "
            f"{_KIND_RE.pattern}"
        )
    if not tail.startswith("v") or not tail[1:].isdigit():
        raise ValueError(
            f"malformed schema id {schema_id!r}: version {tail!r} must be "
            "'v<integer>'"
        )
    version = int(tail[1:])
    if version < 1:
        raise ValueError(
            f"malformed schema id {schema_id!r}: version must be >= 1"
        )
    return kind, version


def tag(kind: str, payload: dict, version: int = 1) -> dict:
    """Wrap ``payload`` in the shared record envelope.

    Adds a ``schema`` field (``nimble.<kind>/v<version>``) for consumers to
    dispatch on; ``payload`` keys are carried unchanged.  Key *order* is
    not part of the contract — file writers sort keys for diff stability.

    Strict by construction: a malformed kind or version raises, and a
    *registered* kind (:data:`KNOWN_SCHEMAS`) tagged at a version other
    than its registered one raises — version bumps go through the
    registry, never through a lone call site.
    """
    if not _KIND_RE.match(kind or ""):
        raise ValueError(
            f"malformed schema kind {kind!r}: must match {_KIND_RE.pattern}"
        )
    if not isinstance(version, int) or isinstance(version, bool) or version < 1:
        raise ValueError(
            f"malformed schema version {version!r} for kind {kind!r}: "
            "must be an integer >= 1"
        )
    registered = KNOWN_SCHEMAS.get(kind)
    if registered is not None and version != registered:
        raise ValueError(
            f"schema kind {kind!r} is registered at v{registered} but was "
            f"tagged v{version} — update KNOWN_SCHEMAS to bump it"
        )
    return {"schema": f"{SCHEMA_PREFIX}.{kind}/v{version}", **payload}


def schema_kind(record: dict) -> str:
    """Extract ``<kind>`` from a tagged record ('' if untagged)."""
    schema = record.get("schema", "")
    if "." not in schema or "/" not in schema:
        return ""
    return schema.split(".", 1)[1].rsplit("/", 1)[0]


def schema_version(record: dict) -> int:
    """Extract ``<version>`` from a tagged record (0 if untagged/bad).

    Consumers dispatch on this rather than string matching the whole
    envelope.
    """
    schema = record.get("schema", "")
    if "/" not in schema:
        return 0
    tail = schema.rsplit("/", 1)[1]
    if not tail.startswith("v"):
        return 0
    try:
        return int(tail[1:])
    except ValueError:
        return 0


def write_json_file(path: str, obj, *, indent: bool = True) -> None:
    """Serialize ``obj`` to ``path`` with sorted keys + trailing newline.

    Sorted keys keep git-tracked artifacts (bench metrics, reports) free of
    pure key-reordering churn between runs.
    """
    with open(path, "wb") as f:
        f.write(json_dumps(_sorted(obj), indent=indent))
        f.write(b"\n")


def _sorted(obj):
    """Recursively sort dict keys (tuples become lists, as in JSON)."""
    if isinstance(obj, dict):
        return {k: _sorted(obj[k]) for k in sorted(obj)}
    if isinstance(obj, (list, tuple)):
        return [_sorted(x) for x in obj]
    return obj


def read_json_file(path: str):
    with open(path, "rb") as f:
        return json_loads(f.read())
