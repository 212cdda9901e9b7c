"""The readers of the program's spans inside a commit and an undo
(``d2h_ms``, ``keys_ms``, ``meta_ms``, ``stage_ms``) and of the graphed
step's capture counter (``capture_ms``): medians over hand-built cycles,
sums where a metric adds spans, nothing where the span is absent (as on a
program without it), their ``BENCHMARK.json`` entries, and a traced run
on the CPU that reads the commit's three."""
import json

import pytest

import pb_env

from portbench import harness

ROOT = pb_env.ROOT
NEW = ("d2h_ms", "keys_ms", "meta_ms", "stage_ms", "capture_ms")
ALL = ["smollm-360m.regen", "mamba2-780m.regen", "smollm-360m.regen_sqlite"]


def _run(cells):
    """A Run of one cycle per ``(spans_cell, spans_undo, captures,
    capture_s)``."""
    cycles = [harness.Cycle(0.1, 1.0,
                            {"captures": n, "capture_s": cs},
                            {}, dict(sc), dict(su))
              for sc, su, n, cs in cells]
    return harness.Run({}, {}, cycles, 10.0, 100, 1.0, 0)


def read(name, run):
    return harness.reader(name)(run)


def test_span_readers_take_the_median_in_ms():
    run = _run([({"d2h": 0.010, "chunk_keys": 0.004}, {"stage_h2d": 0.3},
                 1, 0.2),
                ({"d2h": 0.030, "chunk_keys": 0.002}, {"stage_h2d": 0.1},
                 1, 0.4),
                ({"d2h": 0.020, "chunk_keys": 0.006}, {"stage_h2d": 0.2},
                 1, 0.3)])
    assert read("d2h_ms", run) == pytest.approx(20.0)
    assert read("keys_ms", run) == pytest.approx(4.0)
    assert read("stage_ms", run) == pytest.approx(200.0)
    assert read("capture_ms", run) == pytest.approx(300.0)


def test_meta_ms_sums_meta_docs_and_publish():
    run = _run([({"meta_docs": 0.05, "publish": 0.30}, {}, 0, 0.0),
                ({"meta_docs": 0.07, "publish": 0.40}, {}, 0, 0.0),
                ({"meta_docs": 0.06}, {}, 0, 0.0)])     # publish deferred
    assert read("meta_ms", run) == pytest.approx(350.0)


def test_cycles_without_the_span_are_left_out():
    run = _run([({"d2h": 0.010}, {}, 0, 0.0),
                ({}, {"stage_h2d": 0.25}, 0, 0.0),
                ({"d2h": 0.030}, {}, 0, 0.0)])
    assert read("d2h_ms", run) == pytest.approx(20.0)
    assert read("stage_ms", run) == pytest.approx(250.0)


def test_capture_ms_takes_every_cell_once_any_captured():
    run = _run([({}, {}, 1, 0.3), ({}, {}, 0, 0.0), ({}, {}, 0, 0.0)])
    assert read("capture_ms", run) == 0.0
    run = _run([({}, {}, 1, 0.3), ({}, {}, 1, 0.2), ({}, {}, 0, 0.0)])
    assert read("capture_ms", run) == pytest.approx(200.0)


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_gives_none(name):
    # a program without the spans (the parent of this change) publishes
    # and serializes all the same: its other spans are there
    run = _run([({"serialize": 0.2, "publish": 0.3}, {"materialize": 0.4},
                 0, 0.0)] * 3)
    assert read(name, run) is None


def test_entries_and_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    want = {"d2h_ms": ("program_span", "write and store", "cell_ms_p50",
                       ALL),
            "keys_ms": ("program_span", "write and store", "cell_ms_p50",
                        ALL),
            "meta_ms": ("program_span", "write and store", "cell_ms_p50",
                        ALL),
            "stage_ms": ("program_span", "checkout", "tokens_per_s",
                         ["mamba2-780m.regen"]),
            "capture_ms": ("program_counter", "model step", "tokens_per_s",
                           ["mamba2-780m.regen"])}
    assert [m["name"] for m in bench["per_layer"][-len(NEW):]] == list(NEW)
    layers = {m["layer"] for m in bench["per_layer"][:-len(NEW)]}
    for name, (source, layer, moves, cells) in want.items():
        m = per_layer[name]
        assert (m["unit"], m["better"]) == ("ms", "lower")
        assert (m["source"], m["layer"], m["moves"]) == (source, layer,
                                                         moves)
        assert m["workloads"] == cells and layer in layers
        for cell in cells:
            spec = harness.load_spec(cell, ROOT)
            assert name in {e["name"] for e in spec.trace_metrics}
            assert moves in {e["name"] for e in spec.metrics}


def test_traced_cpu_run_reads_the_commits_spans():
    spec = pb_env.tiny_spec("llama")
    out = harness.run_cell(spec, 2**31 + 11, 0.3, True, device="cpu")
    run = out["run"]
    assert out["correct"] is True
    for name in ("d2h_ms", "keys_ms", "meta_ms"):
        assert read(name, run) > 0, name
    assert read("capture_ms", run) is None        # the CPU step is eager
    for c in run.cycles:
        # the write's parts lie inside its serialize span
        parts = sum(c.spans_cell.get(n, 0.0)
                    for n in ("d2h", "chunk_keys", "enqueue"))
        assert 0 < parts <= c.spans_cell["serialize"]
