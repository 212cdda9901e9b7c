"""Unified observability plane — spans, metrics, exporters (DESIGN.md §16).

One :class:`SessionObs` per :class:`~repro_torch.core.session.KishuSession` bundles
a :class:`~repro_torch.obs.trace.Tracer` (pipeline spans) and a
:class:`~repro_torch.obs.metrics.MetricsRegistry` (counters + log-bucket
histograms).  The session *activates* its handle around ``run()`` /
``checkout()`` via a module-level contextvar, so deep library code — the
delta kernels, the txn recovery path — reports into whichever session is
executing on the current thread without plumbing a handle through every
signature.  Under kishud many sessions share the process; activation is
what keeps their counters (e.g. kernel fallbacks) from cross-attributing.

Tracing is off by default (``KISHU_TRACE=1`` or ``trace=True`` opts in) and
costs one attribute check per call site when off.  Metrics are always on:
an :class:`InstrumentedStore` times every store op, and pipeline code bumps
counters/histograms — no store writes of its own, so crash-injection op
accounting is unchanged.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import uuid
from typing import Dict, Optional

from repro_torch.obs.metrics import (Counter, Gauge, Histogram, LATENCY_BASE_S,
                               MetricsRegistry, SIZE_BASE_BYTES, render)
from repro_torch.obs.trace import (NULL_SPAN, SpanRecord, Tracer, chrome_trace,
                             spans_from_doc)

TRACE_META_PREFIX = "obs/trace/"

_INSTRUMENT_NAMES = ("InstrumentedStore", "instrument_tree", "backend_label")


def __getattr__(name: str):
    # repro_torch.obs.instrument imports repro_torch.core (for the ChunkStore base),
    # and repro_torch.core.session imports repro_torch.obs — re-exporting lazily keeps
    # this package importable from either direction
    if name in _INSTRUMENT_NAMES:
        from repro_torch.obs import instrument
        return getattr(instrument, name)
    raise AttributeError(f"module 'repro_torch.obs' has no attribute {name!r}")

_active_obs: contextvars.ContextVar[Optional["SessionObs"]] = \
    contextvars.ContextVar("kishu_obs_active", default=None)


def active() -> Optional["SessionObs"]:
    """The SessionObs activated on the current context, if any."""
    return _active_obs.get()


class SessionObs:
    """Per-session observability handle: tracer + metrics registry."""

    def __init__(self, *, trace: Optional[bool] = None,
                 tenant: Optional[str] = None, max_spans: int = 16384):
        if trace is None:
            trace = os.environ.get("KISHU_TRACE", "").strip() in (
                "1", "true", "on")
        self.sid = uuid.uuid4().hex[:12]
        self.tracer = Tracer(enabled=bool(trace), max_spans=max_spans)
        labels: Dict[str, str] = {"tenant": tenant} if tenant else {}
        self.registry = MetricsRegistry(const_labels=labels)
        self._fallback_logged = False

    # ---- spans ----

    def span(self, name: str, **args):
        return self.tracer.span(name, **args)

    @contextlib.contextmanager
    def activate(self):
        token = _active_obs.set(self)
        try:
            yield self
        finally:
            _active_obs.reset(token)

    # ---- kernel-fallback scoping (satellite: core/delta.py globals) ----

    def note_kernel_fallback(self, where: str) -> bool:
        """Count one device-kernel→host degradation; True if it is this
        session's first (caller logs the once-per-session warning)."""
        self.registry.counter("kishu_kernel_fallbacks_total",
                              where=where).inc()
        first = not self._fallback_logged
        self._fallback_logged = True
        return first

    def kernel_fallbacks(self) -> int:
        return int(self.registry.counter_total(
            "kishu_kernel_fallbacks_total"))

    # ---- persistence ----

    def to_doc(self) -> dict:
        return {"sid": self.sid,
                "tenant": self.registry.const_labels.get("tenant"),
                "spans": self.tracer.to_doc(),
                "metrics": self.registry.to_doc()}


__all__ = [
    "SessionObs", "active", "Tracer", "SpanRecord", "chrome_trace",
    "spans_from_doc", "NULL_SPAN", "MetricsRegistry", "Counter", "Gauge",
    "Histogram", "render", "LATENCY_BASE_S", "SIZE_BASE_BYTES",
    "InstrumentedStore", "instrument_tree", "backend_label",
    "TRACE_META_PREFIX",
]
