"""The port's tracer (``repro_torch.obs``) on the CPU.

- A traced commit records, inside its ``serialize`` span, one ``d2h``,
  one ``chunk_keys`` and one ``enqueue`` span a co-variable, on the full
  path inside a ``write_whole`` span and on the dirty-range path inside a
  ``write_delta`` span; ``meta_docs`` (the commit, refcount and HEAD
  documents) nests in ``commit`` and ends before ``publish``.
- A checkout that loads a leaf in full records ``stage_h2d`` inside
  ``materialize``.
- With tracing off no span is recorded and every site gets the shared
  ``NULL_SPAN``.
- Under ``torch.profiler`` with tracing on the spans are profiler ranges,
  each inside its parent's; with tracing off there are none, and a span
  that the profiler's start or stop crosses does not raise.
"""
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.core import KishuSession, MemoryStore  # noqa: E402

CHUNK = 1 << 10
N = 4096                     # float32: 16 chunks
WRITE = ("d2h", "chunk_keys", "enqueue")
NEW = WRITE + ("meta_docs", "stage_h2d")


def _session(trace: bool) -> KishuSession:
    s = KishuSession(MemoryStore(), chunk_bytes=CHUNK, device="cpu",
                     trace=trace)

    def make(ns):
        ns["x"] = torch.arange(N, dtype=torch.float32)

    def poke(ns):
        ns["x"][:10] += 1.0          # one dirty chunk of 16

    def reshape(ns):
        ns["x"] = torch.zeros(N // 2, dtype=torch.float32)

    s.register("make", make)
    s.register("poke", poke)
    s.register("reshape", reshape)
    s.init_state({})
    s.obs.tracer.clear()
    return s


def _by_name(spans, name):
    return [r for r in spans if r.name == name]


def _ancestors(rec, by_id):
    out = []
    while rec.parent_id is not None and rec.parent_id in by_id:
        rec = by_id[rec.parent_id]
        out.append(rec.name)
    return out


def _inside(child, parent, eps=1e-6):
    return (parent.t0_s - eps <= child.t0_s
            and child.t0_s + child.dur_s <= parent.t0_s + parent.dur_s + eps)


@pytest.mark.parametrize("path", ["full", "dirty"])
def test_write_spans_nest_in_serialize(path):
    s = _session(True)
    s.run("make")
    if path == "dirty":
        s.obs.tracer.clear()
        s.run("poke")
        assert s.last_run.write.covs_delta == 1
    else:
        assert s.last_run.write.covs_delta == 0
    spans = list(s.obs.tracer.spans)
    by_id = {r.span_id: r for r in spans}
    (ser,) = _by_name(spans, "serialize")
    # the first commit declines nothing (no parent manifest) yet still
    # opens write_delta around the attempt; the poke's attempt is taken
    (delta,) = _by_name(spans, "write_delta")
    whole = _by_name(spans, "write_whole")
    assert delta.parent_id == ser.span_id and _inside(delta, ser)
    assert len(whole) == (path == "full")
    (outer,) = whole or [delta]
    assert outer.parent_id == ser.span_id and _inside(outer, ser)
    for name in WRITE:
        recs = _by_name(spans, name)
        assert len(recs) == 1, (name, len(recs))     # one a co-variable
        assert recs[0].parent_id == outer.span_id, name
        assert _inside(recs[0], outer), name
    s.close()


def test_meta_docs_nest_in_commit_before_publish():
    s = _session(True)
    s.obs.tracer.clear()
    s.run("make")
    spans = list(s.obs.tracer.spans)
    by_id = {r.span_id: r for r in spans}
    (meta,) = _by_name(spans, "meta_docs")
    (pub,) = _by_name(spans, "publish")
    (commit,) = _by_name(spans, "commit")
    assert "commit" in _ancestors(meta, by_id) and _inside(meta, commit)
    assert "meta_docs" not in _ancestors(pub, by_id)
    assert meta.t0_s + meta.dur_s <= pub.t0_s
    s.close()


def test_full_load_stages_inside_materialize():
    s = _session(True)
    c1 = s.run("make")
    s.run("reshape")
    s.obs.tracer.clear()
    st = s.checkout(c1)
    assert st.covs_loaded == 1
    assert torch.equal(s.ns["x"], torch.arange(N, dtype=torch.float32))
    spans = list(s.obs.tracer.spans)
    by_id = {r.span_id: r for r in spans}
    (stage,) = _by_name(spans, "stage_h2d")
    (mat,) = _by_name(spans, "materialize")
    assert stage.parent_id == mat.span_id and _inside(stage, mat)
    assert stage.args["nbytes"] == N * 4
    assert "checkout" in _ancestors(stage, by_id)
    s.close()


def test_tracing_off_records_nothing():
    assert obs.span("d2h") is obs.NULL_SPAN       # outside a session
    s = _session(False)
    seen = []

    def probe(ns):
        seen.append(obs.span("d2h"))
        ns["y"] = 1

    s.register("probe", probe)
    c1 = s.run("make")
    s.run("poke")
    s.run("reshape")
    s.run("probe")
    s.checkout(c1)
    assert seen == [obs.NULL_SPAN]
    assert len(s.obs.tracer.spans) == 0
    s.close()


def _cpu_ranges(prof):
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()]


def _profiled(trace: bool):
    s = _session(trace)
    c1 = s.run("make")
    s.obs.tracer.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.run("poke")
        s.run("reshape")
        s.checkout(c1)
    spans = list(s.obs.tracer.spans)
    s.close()
    return _cpu_ranges(prof), spans


def test_spans_are_profiler_ranges_inside_their_parents():
    ranges, spans = _profiled(True)
    names = {n for n, _, _ in ranges}
    assert set(NEW) | {"commit", "serialize", "publish", "checkout",
                       "materialize"} <= names
    # the k-th span of a name is the k-th range of that name
    event = {}
    for name in {r.name for r in spans}:
        recs = sorted(_by_name(spans, name), key=lambda r: r.t0_s)
        evs = sorted((a, b) for n, a, b in ranges if n == name)
        assert len(recs) == len(evs), name
        event.update({r.span_id: ev for r, ev in zip(recs, evs)})
    by_id = {r.span_id: r for r in spans}
    nested = 0
    for r in spans:
        if r.parent_id in by_id:
            (a, b), (pa, pb) = event[r.span_id], event[r.parent_id]
            assert pa <= a and b <= pb, (r.name, by_id[r.parent_id].name)
            nested += 1
    assert nested >= len(NEW)


def test_tracing_off_opens_no_profiler_range():
    ranges, spans = _profiled(False)
    assert not spans
    names = {n for n, _, _ in ranges}
    assert not names & (set(NEW) | {"commit", "serialize", "publish",
                                    "checkout", "materialize"})


def test_span_across_profiler_start_and_stop():
    tracer = obs.Tracer(enabled=True)
    prof = profile(activities=[ProfilerActivity.CPU])
    with tracer.span("across_start"):
        prof.start()
        with tracer.span("during"):
            torch.ones(4).add_(1)
    with tracer.span("across_stop"):
        prof.stop()
    assert [r.name for r in tracer.spans] == ["during", "across_start",
                                              "across_stop"]
    names = {n for n, _, _ in _cpu_ranges(prof)}
    assert "during" in names and "across_start" not in names
