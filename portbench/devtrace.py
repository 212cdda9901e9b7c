"""Reading a ``torch.profiler`` trace of a run's traced cycles.

Device operations are the trace's events on the card (kernels, copies,
fills), the ``record_function`` ranges' own device-side markers left
out.  The harness closes each of its ranges (``kishu_checkout`` around
an undo, ``kishu_commit`` around ``session.run``, ``cell_exec`` around the
cell's body) with a device synchronize, so an operation belongs to the
range in whose host interval it starts on the device.

The digest gives: the traced window (from the first range's start to the
last one's end), the union of the device operations' intervals in it
(busy seconds: overlapping operations count once), the device seconds of
the operations inside ``kishu_commit`` but outside ``cell_exec`` (the
commit's) and inside ``kishu_checkout`` (the undo's), the operations that
took most time, and the idle gaps summed by what the host was doing: the
innermost of the program's spans over the gap, else the harness's range.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

RANGES = ("kishu_commit", "kishu_checkout", "cell_exec")


def _union(iv: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _inside(t: int, iv: Sequence[Tuple[int, int]]) -> bool:
    return any(a <= t < b for a, b in iv)


def _events(prof):
    """(device operations [(name, start_ns, end_ns)], harness ranges
    {name: [(start_ns, end_ns)]}) from the profiler's raw events."""
    from torch.autograd import DeviceType
    ops, ranges = [], {n: [] for n in RANGES}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name in ranges:
            if e.device_type() == DeviceType.CPU:
                ranges[name].append((e.start_ns(), e.end_ns()))
            continue
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0 \
                and not e.is_user_annotation():
            ops.append((name, e.start_ns(), e.end_ns()))
    return ops, ranges


def summarize(ops: List[Tuple[str, int, int]],
              ranges: Dict[str, List[Tuple[int, int]]],
              spans: List[Tuple[str, int, int]]) -> Optional[dict]:
    """The digest from device operations, harness ranges and program
    spans (each ``(name, start_ns, end_ns)`` on the trace's clock)."""
    marks = [iv for n in RANGES for iv in ranges.get(n, [])]
    if not marks:
        return None
    w0, w1 = min(a for a, _ in marks), max(b for _, b in marks)
    ops = [(n, max(a, w0), min(b, w1)) for n, a, b in ops
           if b > w0 and a < w1]
    busy = _union([(a, b) for _, a, b in ops])
    commit, cell = ranges.get("kishu_commit", []), ranges.get("cell_exec",
                                                              [])
    undo = ranges.get("kishu_checkout", [])
    commit_ns = sum(b - a for _, a, b in ops
                    if _inside(a, commit) and not _inside(a, cell))
    undo_ns = sum(b - a for _, a, b in ops if _inside(a, undo))
    by_name: Dict[str, int] = {}
    for n, a, b in ops:
        by_name[n] = by_name.get(n, 0) + (b - a)
    # idle gaps, labelled by the innermost span (or range) over them
    labels = sorted([(a, b, n) for n, a, b in spans]
                    + [(a, b, n) for n in RANGES
                       for a, b in ranges.get(n, [])])
    gaps: Dict[str, int] = {}
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    active: List[Tuple[int, int, str]] = []
    i = 0
    for a, b in zip(edges[0::2], edges[1::2]):   # in time order
        if b <= a:
            continue
        mid = (a + b) // 2
        while i < len(labels) and labels[i][0] <= mid:
            active.append(labels[i])
            i += 1
        active = [x for x in active if x[1] > mid]
        label = min(active, key=lambda x: x[1] - x[0])[2] if active \
            else "harness"
        gaps[label] = gaps.get(label, 0) + (b - a)

    def top(d):
        return [[n[:96], v / 1e9] for n, v in
                sorted(d.items(), key=lambda x: -x[1])[:10]]
    return {"window_s": (w1 - w0) / 1e9,
            "busy_s": sum(b - a for a, b in busy) / 1e9,
            "commit_device_s": commit_ns / 1e9,
            "undo_device_s": undo_ns / 1e9,
            "n_commits": len(commit), "n_undos": len(undo),
            "device_ops": top(by_name), "idle_gaps": top(gaps)}


def digest(prof, marks: List[tuple], spans, epoch: float) -> Optional[dict]:
    """:func:`summarize` of a stopped profiler.  ``marks`` are the
    harness's ranges on the host monotonic clock (``(name, t0_ns,
    t1_ns)``), which place the program's spans (``SpanRecord``s, seconds
    since ``epoch`` on that clock) on the trace's clock."""
    ops, ranges = _events(prof)
    host = {n: [(a, b) for m, a, b in marks if m == n] for n in RANGES}
    offsets = [tr[0] - h[0] for n in RANGES
               for tr, h in zip(sorted(ranges[n]), sorted(host[n]))]
    off = sorted(offsets)[len(offsets) // 2] if offsets else 0
    sp = [(r.name, int((epoch + r.t0_s) * 1e9) + off,
           int((epoch + r.t0_s + r.dur_s) * 1e9) + off) for r in spans]
    return summarize(ops, ranges, sp)
