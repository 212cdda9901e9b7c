"""Counters, gauges, and log-bucket histograms with Prometheus text export.

Dependency-free, thread-safe, and cheap: a histogram ``observe`` is one
``frexp`` (power-of-two bucket index), one list bump, two adds.  Buckets
are ``base * 2**i`` — for latency ``base=1e-6`` spans 1µs…>1s in ~21
buckets; for sizes ``base=64`` spans 64B…>4GB in ~27.  Exponential buckets
match the phenomena: store-op latencies and chunk sizes both spread over
orders of magnitude, and ratios (p99/p50) matter more than absolutes.

:func:`render` emits Prometheus text exposition (``# TYPE`` headers,
cumulative ``_bucket{le=...}`` rows, ``_sum``/``_count``) and can merge
several registries — kishud serves one scrape covering the daemon plus
every live tenant session, disambiguated by each registry's const labels.
"""
from __future__ import annotations

import math
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

LATENCY_BASE_S = 1e-6       # first bucket upper bound for *_seconds
SIZE_BASE_BYTES = 64.0      # first bucket upper bound for *_bytes
_MAX_BUCKETS = 40


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(pairs: Iterable[Tuple[str, str]]) -> str:
    items = [f'{k}="{_escape(v)}"' for k, v in pairs]
    return "{" + ",".join(items) + "}" if items else ""


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def _fmt_num(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Counter:
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n          # single bytecode add under the GIL


class Gauge:
    """Instantaneous value: either ``set()`` explicitly or backed by a
    zero-arg callable sampled at render time (live cache stats etc.)."""
    __slots__ = ("name", "labels", "value", "fn")

    def __init__(self, name: str, labels: Dict[str, str],
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.labels = labels
        self.value = 0.0
        self.fn = fn

    def set(self, v: float) -> None:
        self.value = float(v)

    def sample(self) -> float:
        if self.fn is not None:
            try:
                return float(self.fn())
            except Exception:  # noqa: BLE001 — a dead source reads as 0
                return 0.0
        return self.value


class Histogram:
    """Power-of-two buckets: bucket ``i`` holds observations in
    ``(base*2**(i-1), base*2**i]``; index 0 is ``<= base``."""
    __slots__ = ("name", "labels", "base", "counts", "sum", "count", "_lock")

    def __init__(self, name: str, labels: Dict[str, str],
                 base: float = LATENCY_BASE_S):
        self.name = name
        self.labels = labels
        self.base = float(base)
        self.counts: List[int] = []
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def bucket_index(self, v: float) -> int:
        if v <= self.base:
            return 0
        i = int(math.ceil(math.log2(v / self.base)))
        return min(i, _MAX_BUCKETS)

    def observe(self, v: float) -> None:
        i = self.bucket_index(v)
        with self._lock:
            if i >= len(self.counts):
                self.counts.extend([0] * (i + 1 - len(self.counts)))
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def upper_bounds(self) -> List[float]:
        return [self.base * (2 ** i) for i in range(len(self.counts))]


class MetricsRegistry:
    """Get-or-create keyed on ``(name, labels)``; ``const_labels`` (e.g.
    ``tenant=...``) stamp every sample at render time so merged scrapes
    stay disambiguated."""

    def __init__(self, const_labels: Optional[Dict[str, str]] = None):
        self.const_labels = dict(const_labels or {})
        self._lock = threading.Lock()
        self._counters: Dict[Tuple, Counter] = {}
        self._gauges: Dict[Tuple, Gauge] = {}
        self._histograms: Dict[Tuple, Histogram] = {}

    def counter(self, name: str, **labels: str) -> Counter:
        key = (name, _label_key(labels))
        c = self._counters.get(key)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(key, Counter(name, labels))
        return c

    def gauge(self, name: str, fn: Optional[Callable[[], float]] = None,
              **labels: str) -> Gauge:
        key = (name, _label_key(labels))
        g = self._gauges.get(key)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(key, Gauge(name, labels, fn))
        if fn is not None:
            g.fn = fn
        return g

    def histogram(self, name: str, base: float = LATENCY_BASE_S,
                  **labels: str) -> Histogram:
        key = (name, _label_key(labels))
        h = self._histograms.get(key)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(
                    key, Histogram(name, labels, base=base))
        return h

    def counter_total(self, name: str) -> float:
        """Sum of one counter family across all label sets."""
        return sum(c.value for (n, _), c in list(self._counters.items())
                   if n == name)

    # ---- persistence (snapshot into a meta doc and back) ----

    def to_doc(self) -> dict:
        with self._lock:
            return {
                "const_labels": dict(self.const_labels),
                "counters": [{"name": c.name, "labels": dict(c.labels),
                              "value": c.value}
                             for c in self._counters.values()],
                "histograms": [{"name": h.name, "labels": dict(h.labels),
                                "base": h.base, "counts": list(h.counts),
                                "sum": h.sum, "count": h.count}
                               for h in self._histograms.values()],
            }

    @classmethod
    def from_doc(cls, doc: dict) -> "MetricsRegistry":
        reg = cls(const_labels=doc.get("const_labels") or {})
        for c in doc.get("counters", []):
            reg.counter(c["name"], **c.get("labels", {})).value = \
                float(c.get("value", 0))
        for h in doc.get("histograms", []):
            hist = reg.histogram(h["name"], base=float(h.get("base", 1e-6)),
                                 **h.get("labels", {}))
            hist.counts = [int(x) for x in h.get("counts", [])]
            hist.sum = float(h.get("sum", 0.0))
            hist.count = int(h.get("count", 0))
        return reg


def render(registries: Iterable[MetricsRegistry]) -> str:
    """Prometheus text exposition over one or more registries.  Families
    with the same name merge under one ``# TYPE`` header; each sample
    carries its registry's const labels."""
    registries = list(registries)
    counters: Dict[str, List[Tuple[Tuple, float]]] = {}
    gauges: Dict[str, List[Tuple[Tuple, float]]] = {}
    hists: Dict[str, List[Tuple[Tuple, Histogram]]] = {}
    for reg in registries:
        const = tuple(sorted(reg.const_labels.items()))
        for c in list(reg._counters.values()):
            counters.setdefault(c.name, []).append(
                (const + _label_key(c.labels), c.value))
        for g in list(reg._gauges.values()):
            gauges.setdefault(g.name, []).append(
                (const + _label_key(g.labels), g.sample()))
        for h in list(reg._histograms.values()):
            hists.setdefault(h.name, []).append(
                (const + _label_key(h.labels), h))
    lines: List[str] = []
    for name in sorted(counters):
        lines.append(f"# TYPE {name} counter")
        for labels, value in counters[name]:
            lines.append(f"{name}{_fmt_labels(labels)} {_fmt_num(value)}")
    for name in sorted(gauges):
        lines.append(f"# TYPE {name} gauge")
        for labels, value in gauges[name]:
            lines.append(f"{name}{_fmt_labels(labels)} {_fmt_num(value)}")
    for name in sorted(hists):
        lines.append(f"# TYPE {name} histogram")
        for labels, h in hists[name]:
            cum = 0
            with h._lock:
                counts = list(h.counts)
                total, hsum = h.count, h.sum
            for i, n in enumerate(counts):
                cum += n
                le = h.base * (2 ** i)
                row = labels + (("le", f"{le:.6g}"),)
                lines.append(
                    f"{name}_bucket{_fmt_labels(row)} {cum}")
            row = labels + (("le", "+Inf"),)
            lines.append(f"{name}_bucket{_fmt_labels(row)} {total}")
            lines.append(f"{name}_sum{_fmt_labels(labels)} {_fmt_num(hsum)}")
            lines.append(f"{name}_count{_fmt_labels(labels)} {total}")
    return "\n".join(lines) + ("\n" if lines else "")
