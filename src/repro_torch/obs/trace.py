"""Span tracer — contextvar-propagated, monotonic-clock, ring-bounded.

One :class:`Tracer` per session records :class:`SpanRecord` rows into a
bounded deque.  ``span()`` returns a context manager; nesting is tracked
through a module-level :class:`~contextvars.ContextVar` holding the current
span id, so a stage deep inside the pipeline (e.g. the fused delta pack in
``core/delta.py``) lands under the right parent without threading a handle
through every call signature.  Contextvars do *not* propagate into worker
threads — spans opened from the async-writer drain or the publish worker
simply become roots (parent ``None``), which is the honest picture: those
stages genuinely run off the commit's critical path.

Disabled cost is one attribute check plus returning a shared no-op context
manager — no allocation, no clock read — so the tracer can stay wired into
every hot path unconditionally.

While a ``torch.profiler`` records, an enabled span also enters a
``record_function`` range of its own name on its own thread, so the
pipeline's stages sit in the profiler's trace, on its clock, around the
kernels they launched.  Without a profiler that costs one check a span; a
span that a profiler's start or stop crosses opens no range, or closes the
one it opened (closing after the stop is a no-op for the profiler).

Export is Chrome trace-event JSON (``ph: "X"`` complete events, µs
timestamps), loadable in Perfetto / ``chrome://tracing`` with no deps.
"""
from __future__ import annotations

import contextvars
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional

import torch
from torch.autograd.profiler import record_function

# current span id for the *calling* context; shared across tracers — span ids
# are globally unique per process so a stale id from another tracer can never
# be mistaken for a parent in this one (records are matched by id).
_current_span: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "kishu_obs_current_span", default=None)

_ids = iter(range(1, 1 << 62)).__next__
_ids_lock = threading.Lock()


def _next_id() -> int:
    with _ids_lock:
        return _ids()


@dataclass
class SpanRecord:
    """One completed span: ``t0_s`` is seconds since the tracer's epoch
    (``time.monotonic`` at construction), ``dur_s`` the wall duration."""
    span_id: int
    parent_id: Optional[int]
    name: str
    t0_s: float
    dur_s: float
    thread: int = 0
    args: Dict[str, Any] = field(default_factory=dict)


class _NullSpan:
    """Shared no-op context manager returned when tracing is disabled."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "args", "span_id", "parent_id",
                 "_t0", "_token", "_range")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.span_id = _next_id()
        self.parent_id: Optional[int] = None
        self._t0 = 0.0
        self._token = None
        self._range = None

    def __enter__(self) -> "_Span":
        self.parent_id = _current_span.get()
        self._token = _current_span.set(self.span_id)
        if torch.autograd._profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.monotonic()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self._token is not None:
            _current_span.reset(self._token)
        self._tracer._record(SpanRecord(
            span_id=self.span_id, parent_id=self.parent_id, name=self.name,
            t0_s=self._t0 - self._tracer.epoch, dur_s=t1 - self._t0,
            thread=threading.get_ident(), args=self.args))
        return False


class Tracer:
    """Ring-bounded span recorder.  ``enabled`` may be flipped at runtime;
    ``span()`` reads it per call, so benches can turn tracing on after the
    session is built."""

    def __init__(self, enabled: bool = False, max_spans: int = 16384):
        self.enabled = bool(enabled)
        self.epoch = time.monotonic()
        self.spans: deque = deque(maxlen=int(max_spans))
        self._lock = threading.Lock()

    def span(self, name: str, **args: Any):
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, args)

    def _record(self, rec: SpanRecord) -> None:
        with self._lock:
            self.spans.append(rec)

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()

    # ---- aggregation / export ----

    def stage_totals(self) -> Dict[str, float]:
        """Total seconds per span name (for bench stage vectors)."""
        out: Dict[str, float] = {}
        with self._lock:
            for rec in self.spans:
                out[rec.name] = out.get(rec.name, 0.0) + rec.dur_s
        return out

    def to_doc(self) -> List[dict]:
        """JSON-serializable span dump (persisted under ``obs/trace/``)."""
        with self._lock:
            return [{"id": r.span_id, "parent": r.parent_id, "name": r.name,
                     "t0": r.t0_s, "dur": r.dur_s, "tid": r.thread,
                     "args": r.args} for r in self.spans]


def spans_from_doc(doc: Iterable[dict]) -> List[SpanRecord]:
    return [SpanRecord(span_id=int(d["id"]),
                       parent_id=(None if d.get("parent") is None
                                  else int(d["parent"])),
                       name=str(d["name"]), t0_s=float(d["t0"]),
                       dur_s=float(d["dur"]), thread=int(d.get("tid", 0)),
                       args=dict(d.get("args") or {}))
            for d in doc]


def chrome_trace(spans: Iterable[SpanRecord], *, pid: int = 1) -> dict:
    """Chrome trace-event JSON (Perfetto-loadable).  Complete ``"X"`` events
    with µs timestamps; span/parent ids ride in ``args`` so nesting survives
    round-trips even when viewers re-sort by timestamp."""
    spans = list(spans)
    # compact per-process thread ids: viewers lay tracks out per tid, and raw
    # thread idents are unreadable 15-digit numbers
    tids: Dict[int, int] = {}
    for r in spans:
        tids.setdefault(r.thread, len(tids) + 1)
    events = []
    for r in spans:
        args = {"span_id": r.span_id, "parent_id": r.parent_id}
        args.update(r.args)
        events.append({
            "name": r.name, "ph": "X", "cat": "kishu",
            "ts": round(r.t0_s * 1e6, 3),
            "dur": max(round(r.dur_s * 1e6, 3), 0.001),
            "pid": pid, "tid": tids[r.thread], "args": args,
        })
    events.sort(key=lambda e: e["ts"])
    return {"traceEvents": events, "displayTimeUnit": "ms"}
