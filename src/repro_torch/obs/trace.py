"""Chrome/Perfetto trace emission for the flight recorder.

Counterpart of ``repro/obs/trace.py`` (the stdlib only): the same events,
the same causal clock, the same export byte for byte.

The :class:`Tracer` collects typed spans and instant events — ``solve``,
``arbitrate``, ``swap``, ``replan``, ``fault``, ``scenario-window``,
``drain`` and friends — from every layer of the stack and exports them
as Chrome trace-event JSON (the object format, tagged
``nimble.trace/v1``) that loads directly in ``chrome://tracing`` or
https://ui.perfetto.dev.

Timestamps are *causal*, not wall-clock: the orchestration stack is a
windowed simulation, so the tracer keeps a monotonic microsecond
counter that every emission advances by one tick, and the serve /
runtime layers align window boundaries to 1 ms marks via
:meth:`Tracer.advance_to`.  The result renders as a per-tenant timeline
(one Perfetto track per tenant plus ``fabric`` and ``cluster`` tracks)
where ordering and nesting are exact even though durations are
synthetic.

Every event carries the recorder's correlation id in ``args["corr"]``
so multi-layer traces can be joined back to one run after the fact;
:func:`validate_trace` checks the invariants the test-suite and
selfcheck pin (sorted ``ts``, matched ``B``/``E`` pairs, properly
nested ``X`` spans per track, one correlation id).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..jsonio import schema_kind, schema_version, tag

TRACE_KIND = "trace"


class _Span:
    """Handle returned by :meth:`Tracer.begin`; closed by :meth:`Tracer.end`."""

    __slots__ = ("name", "cat", "tid", "args", "start", "closed")

    def __init__(self, name: str, cat: str, tid: str, args: Optional[dict],
                 start: int):
        self.name = name
        self.cat = cat
        self.tid = tid
        self.args = args
        self.start = start
        self.closed = False


class _SpanContext:
    """Context-manager sugar over ``begin``/``end``."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: _Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> _Span:
        return self._span

    def __exit__(self, *exc) -> None:
        self._tracer.end(self._span)


class Tracer:
    """Collects trace events; zero work unless methods are called.

    Disabled runs never construct one — the instrumentation sites guard
    on ``recorder is None`` so the disabled path stays bit-identical.
    """

    def __init__(self, correlation_id: str, capacity: int = 1_000_000):
        self.correlation_id = correlation_id
        self.capacity = int(capacity)
        self.dropped = 0
        self._events: List[dict] = []
        self._now = 0                      # causal microsecond clock
        self._tids: Dict[str, int] = {}    # track name -> tid int

    # -- clock ---------------------------------------------------------------

    def _tick(self) -> int:
        t = self._now
        self._now += 1
        return t

    def advance_to(self, ts_us: int) -> None:
        """Advance the causal clock to at least ``ts_us`` (never backwards)."""
        if ts_us > self._now:
            self._now = int(ts_us)

    # -- emission ------------------------------------------------------------

    def _tid(self, name: str) -> int:
        tid = self._tids.get(name)
        if tid is None:
            tid = len(self._tids) + 1
            self._tids[name] = tid
        return tid

    def _emit(self, ev: dict) -> None:
        if len(self._events) >= self.capacity:
            self.dropped += 1
            return
        self._events.append(ev)

    def instant(self, name: str, cat: str, tid: str,
                args: Optional[dict] = None) -> None:
        """Emit an instant (``i``) marker — swap/fault/admit/... points."""
        a = {"corr": self.correlation_id}
        if args:
            a.update(args)
        self._emit({
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": self._tick(), "pid": 1, "tid": self._tid(tid), "args": a,
        })

    def begin(self, name: str, cat: str, tid: str,
              args: Optional[dict] = None) -> _Span:
        """Open a span; close it with :meth:`end` (emits one ``X`` event)."""
        return _Span(name, cat, tid, args, self._tick())

    def end(self, span: _Span, extra_args: Optional[dict] = None) -> None:
        if span.closed:
            return
        span.closed = True
        end = self._tick()
        if end <= span.start:
            end = span.start + 1
        a = {"corr": self.correlation_id}
        if span.args:
            a.update(span.args)
        if extra_args:
            a.update(extra_args)
        self._emit({
            "name": span.name, "cat": span.cat, "ph": "X",
            "ts": span.start, "dur": end - span.start,
            "pid": 1, "tid": self._tid(span.tid), "args": a,
        })

    def span(self, name: str, cat: str, tid: str,
             args: Optional[dict] = None) -> _SpanContext:
        """``with tracer.span(...):`` — begin/end as a context manager."""
        return _SpanContext(self, self.begin(name, cat, tid, args))

    # -- export --------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._events)

    def export(self) -> dict:
        """Chrome trace-event JSON (object format), tagged ``nimble.trace/v1``.

        Events are sorted by ``ts`` (emission order breaks ties) — the
        sortedness is part of the schema contract and is pinned by
        :func:`validate_trace`.
        """
        meta = [{
            "name": "process_name", "ph": "M", "pid": 1, "ts": 0,
            "args": {"name": f"nimble:{self.correlation_id}"},
        }]
        for track, tid in self._tids.items():
            meta.append({
                "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                "ts": 0, "args": {"name": track},
            })
        events = meta + sorted(
            self._events, key=lambda e: e["ts"]
        )
        return tag(TRACE_KIND, {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "correlation_id": self.correlation_id,
                "dropped": self.dropped,
            },
        })


def validate_trace(record: dict) -> dict:
    """Validate a ``nimble.trace/v1`` export; raise ``ValueError`` on the
    first violated invariant, return a summary dict on success.

    Checks: schema tag; ``traceEvents`` sorted by ``ts``; every ``X``
    event carries a non-negative ``dur``; ``B``/``E`` pairs match per
    track; ``X`` spans nest properly per track; all non-metadata events
    carry the same correlation id.
    """
    if schema_kind(record) != TRACE_KIND or schema_version(record) != 1:
        raise ValueError(
            f"not a nimble.trace/v1 record: {record.get('schema')!r}"
        )
    events = record.get("traceEvents")
    if not isinstance(events, list) or not events:
        raise ValueError("trace has no traceEvents")
    corr = None
    last_ts = None
    open_be: Dict[Tuple[int, int], list] = {}     # (pid, tid) -> B stack
    open_x: Dict[Tuple[int, int], list] = {}      # (pid, tid) -> [end ts]
    n_spans = 0
    cats = set()
    for ev in events:
        ph = ev.get("ph")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, int) or ts < 0:
            raise ValueError(f"event {ev.get('name')!r} has bad ts {ts!r}")
        if last_ts is not None and ts < last_ts:
            raise ValueError(
                f"traceEvents not sorted: ts {ts} after {last_ts}"
            )
        last_ts = ts
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, int) or dur < 0:
                raise ValueError(
                    f"X event {ev.get('name')!r} has bad dur {dur!r}"
                )
            stack = open_x.setdefault(key, [])
            while stack and ts >= stack[-1]:
                stack.pop()
            if stack and ts + dur > stack[-1]:
                raise ValueError(
                    f"X event {ev.get('name')!r} at ts={ts} dur={dur} "
                    f"overlaps its enclosing span (ends {stack[-1]}) on "
                    f"track {key}"
                )
            stack.append(ts + dur)
            n_spans += 1
        elif ph == "B":
            open_be.setdefault(key, []).append(ev.get("name"))
            n_spans += 1
        elif ph == "E":
            stack = open_be.get(key)
            if not stack:
                raise ValueError(
                    f"E event on track {key} with no open B span"
                )
            stack.pop()
        elif ph not in ("i", "I", "C"):
            raise ValueError(f"unsupported event phase {ph!r}")
        ev_corr = (ev.get("args") or {}).get("corr")
        if ev_corr is None:
            raise ValueError(
                f"event {ev.get('name')!r} missing args.corr"
            )
        if corr is None:
            corr = ev_corr
        elif ev_corr != corr:
            raise ValueError(
                f"mixed correlation ids: {corr!r} vs {ev_corr!r}"
            )
        cats.add(ev.get("cat"))
    for key, stack in open_be.items():
        if stack:
            raise ValueError(
                f"unmatched B event(s) {stack!r} on track {key}"
            )
    return {
        "events": sum(1 for e in events if e.get("ph") != "M"),
        "spans": n_spans,
        "cats": sorted(c for c in cats if c),
        "correlation_id": corr,
    }
