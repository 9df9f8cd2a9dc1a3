"""Structured request tracing for the serving runtime (port of
``repro/obs/trace.py``; a copy of that jax-free module, kept here so the
port imports nothing of the reference package. Records, JSONL and
Perfetto output are the reference's byte for byte under the same clock).

One ``Tracer`` per serve run collects bounded, ring-buffered *records*:

- **spans** — named intervals with explicit ``[t0, t1)`` stamps on a named
  *track* ("scheduler", "requests", "slot0".."slotN-1", "profiler"). The
  scheduler emits one lifecycle chain per request — ``queued`` (submit ->
  admit), ``prefill`` (admit -> first token, with nested ``prefill_chunk``
  children on the paged path) and ``decode`` (first token -> done) — whose
  durations reconcile EXACTLY with ``RunMetrics`` TTFT/TPOT because both
  read the same clock stamps.
- **events** — point-in-time markers: ``submit``, ``prefix_hit`` /
  ``prefix_miss``, ``admission_deferral``, ``cow_copy``,
  ``prefix_eviction``, ``spec_round``; ``compile`` spans mark the first
  run of each prefill shape and of the decode tick.

Every stamp is the host clock: a span around device work measures the
launches, not the device time, unless something inside it synchronises
(the sampled ticks of ``obs.profile.StepTimer`` do).

The clock is injectable (``Tracer(clock=fake)``), so span ordering and
export are unit-testable without wall time; schedulers share the same clock
object, which is what makes the metrics<->trace reconciliation exact.

Exports:

- ``write_jsonl`` — one JSON object per line: a ``meta`` header (schema
  version), every record, and an optional ``meta`` footer carrying the run's
  ``RunMetrics`` summary + per-request dump.
- ``write_perfetto`` — Chrome ``trace_event`` JSON loadable in
  ``ui.perfetto.dev``: one named thread per track (complete ``"X"`` events,
  instants), plus async ``"b"``/``"e"`` pairs for records carrying an
  ``async_id`` (the per-request ``queued``/``request`` intervals, which may
  overlap arbitrarily and so cannot live on a synchronous track).

``NullTracer`` is the default everywhere: every method is a no-op and
``enabled`` is False, so disabled-path call sites skip even the args-dict
construction — tracing off costs a single attribute check per site.
"""
from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional

__all__ = [
    "NULL_TRACER",
    "NullTracer",
    "TRACE_SCHEMA_VERSION",
    "TraceRecord",
    "Tracer",
    "get_tracer",
    "records_to_perfetto",
    "set_tracer",
]

TRACE_SCHEMA_VERSION = 1

# canonical track names (anything else is allowed; these get sort priority;
# "autotune" is the reference's, kept so both packages lay out tracks alike)
_TRACK_ORDER = ("scheduler", "requests", "profiler", "autotune")


@dataclasses.dataclass
class TraceRecord:
    kind: str  # "span" | "event"
    name: str
    track: str
    ts: float  # span start / event time, in tracer-clock seconds
    dur: Optional[float] = None  # spans only (>= 0)
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # spans whose intervals may overlap on one track (per-request lifecycle)
    # export as Perfetto async b/e pairs keyed on this id instead of "X"
    async_id: Optional[int] = None

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "kind": self.kind, "name": self.name, "track": self.track,
            "ts": self.ts,
        }
        if self.dur is not None:
            out["dur"] = self.dur
        if self.async_id is not None:
            out["async_id"] = self.async_id
        if self.args:
            out["args"] = self.args
        return out


class _SpanCtx:
    """Context manager for ``Tracer.span``: stamps the clock at enter/exit."""

    __slots__ = ("_tracer", "_name", "_track", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, track: str, args: Dict):
        self._tracer = tracer
        self._name = name
        self._track = track
        self._args = args

    def __enter__(self) -> "_SpanCtx":
        self._t0 = self._tracer.clock()
        return self

    def __exit__(self, *exc) -> None:
        self._tracer.add_span(
            self._name, self._track, self._t0, self._tracer.clock(), **self._args
        )


class Tracer:
    """Bounded in-memory trace collector with an injectable clock."""

    enabled = True

    def __init__(self, *, clock: Callable[[], float] = time.monotonic,
                 capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.clock = clock
        self.capacity = capacity
        self._buf: "deque[TraceRecord]" = deque(maxlen=capacity)
        self.dropped = 0  # records evicted by the ring buffer

    # -- collection ---------------------------------------------------------

    def _append(self, rec: TraceRecord) -> None:
        if len(self._buf) == self.capacity:
            self.dropped += 1  # deque(maxlen) evicts the oldest on append
        self._buf.append(rec)

    def event(self, name: str, track: str = "scheduler", **args) -> None:
        """Point event stamped with the tracer clock."""
        self._append(TraceRecord("event", name, track, self.clock(), args=args))

    def add_span(self, name: str, track: str, t0: float, t1: float,
                 async_id: Optional[int] = None, **args) -> None:
        """Span with explicit stamps — callers that already stamp their own
        clock (the scheduler's RequestMetrics path) pass the same floats
        here, which is what makes trace<->metrics reconciliation exact."""
        self._append(TraceRecord("span", name, track, t0, dur=max(t1 - t0, 0.0),
                                 args=args, async_id=async_id))

    def span(self, name: str, track: str = "scheduler", **args) -> _SpanCtx:
        """Context manager stamping the clock at enter/exit."""
        return _SpanCtx(self, name, track, args)

    # -- introspection ------------------------------------------------------

    @property
    def records(self) -> List[TraceRecord]:
        return list(self._buf)

    def __len__(self) -> int:
        return len(self._buf)

    # -- export -------------------------------------------------------------

    def header(self) -> Dict[str, Any]:
        return {
            "kind": "meta",
            "schema_version": TRACE_SCHEMA_VERSION,
            "capacity": self.capacity,
            "dropped": self.dropped,
            "n_records": len(self._buf),
        }

    def write_jsonl(self, path: str, *, summary: Optional[Dict] = None,
                    requests: Optional[List[Dict]] = None) -> None:
        """Header meta + one record per line + optional footer meta carrying
        the run's metrics summary / per-request dump for reconciliation."""
        with open(path, "w") as fh:
            fh.write(json.dumps(self.header(), sort_keys=True) + "\n")
            for rec in self._buf:
                fh.write(json.dumps(rec.to_json(), sort_keys=True) + "\n")
            if summary is not None or requests is not None:
                footer: Dict[str, Any] = {"kind": "meta", "footer": True}
                if summary is not None:
                    footer["summary"] = summary
                if requests is not None:
                    footer["requests"] = requests
                fh.write(json.dumps(footer, sort_keys=True) + "\n")

    def to_perfetto(self) -> Dict[str, Any]:
        return records_to_perfetto(self._buf)

    def write_perfetto(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_perfetto(), fh, sort_keys=True)


class _NullSpanCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL_SPAN = _NullSpanCtx()


class NullTracer(Tracer):
    """Allocation-free disabled tracer: every method is a no-op. Call sites
    that would build args dicts guard on ``tracer.enabled``."""

    enabled = False

    def __init__(self):
        super().__init__(capacity=1)

    def event(self, name, track="scheduler", **args):
        return None

    def add_span(self, name, track, t0, t1, async_id=None, **args):
        return None

    def span(self, name, track="scheduler", **args):
        return _NULL_SPAN


NULL_TRACER = NullTracer()

# process-global tracer hook: components with no constructor path from the
# serve engine report through this (the launcher installs its tracer here).
_GLOBAL_TRACER: Tracer = NULL_TRACER


def get_tracer() -> Tracer:
    return _GLOBAL_TRACER


def set_tracer(tracer: Optional[Tracer]) -> Tracer:
    """Install a process-global tracer (None -> NULL_TRACER); returns the
    previous one so callers can restore it."""
    global _GLOBAL_TRACER
    prev = _GLOBAL_TRACER
    _GLOBAL_TRACER = tracer if tracer is not None else NULL_TRACER
    return prev


# ---------------------------------------------------------------------------
# Perfetto (Chrome trace_event) export
# ---------------------------------------------------------------------------


def _track_sort_key(track: str):
    try:
        return (0, _TRACK_ORDER.index(track), track)
    except ValueError:
        return (1, 0, track)


def records_to_perfetto(records: Iterable) -> Dict[str, Any]:
    """Records (TraceRecord or equivalent dicts) -> ``trace_event`` JSON.

    Layout: pid 1, one named tid per track (scheduler first, then one per
    slot), ``"X"`` complete events for spans, ``"i"`` instants for events,
    and ``"b"``/``"e"`` async pairs for spans with an ``async_id``.
    Timestamps are microseconds relative to the earliest record.
    """
    recs: List[Dict[str, Any]] = []
    for r in records:
        recs.append(r.to_json() if isinstance(r, TraceRecord) else dict(r))
    recs = [r for r in recs if r.get("kind") in ("span", "event")]
    t_base = min((r["ts"] for r in recs), default=0.0)

    def us(t: float) -> float:
        return (t - t_base) * 1e6

    tids: Dict[str, int] = {}
    for track in sorted({r["track"] for r in recs}, key=_track_sort_key):
        tids[track] = len(tids) + 1

    events: List[Dict[str, Any]] = []
    for track, tid in tids.items():
        events.append({"ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
                       "args": {"name": track}})
        events.append({"ph": "M", "name": "thread_sort_index", "pid": 1,
                       "tid": tid, "args": {"sort_index": tid}})
    for r in recs:
        base = {"name": r["name"], "pid": 1, "tid": tids[r["track"]],
                "ts": us(r["ts"]), "args": r.get("args", {})}
        if r["kind"] == "event":
            events.append({**base, "ph": "i", "s": "t"})
        elif r.get("async_id") is not None:
            aid = int(r["async_id"])
            events.append({**base, "ph": "b", "cat": r["name"], "id": aid})
            events.append({"name": r["name"], "pid": 1, "tid": tids[r["track"]],
                           "ts": us(r["ts"] + r.get("dur", 0.0)), "ph": "e",
                           "cat": r["name"], "id": aid, "args": {}})
        else:
            events.append({**base, "ph": "X", "dur": r.get("dur", 0.0) * 1e6})
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {"schema_version": TRACE_SCHEMA_VERSION},
    }
