"""BENCHMARK.json against the rules its keys keep, and every cell against
the files the harness finds by name."""
import json
import re

import pb_env

from portbench import harness, traffic

ROOT = pb_env.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    cells = len(BENCH["workloads"])
    # a full check at 24 cells: 2 + 14 runs a cell, each run_seconds + 60,
    # each cell 2 x 90 s to compile, 1200 s spare, all within 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= cells <= 24
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= cells // 4


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group if group in ("configs", "workloads")
                          else "metric", e["name"]))
            for k in ("why", "layer", "source"):
                if k in e and group != "end_to_end" and group != "per_layer" \
                        or k == "layer" and k in e:
                    assert LINE.match(e[k]), (e["name"], k)
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for word in BENCH["command"]:
        assert LINE.match(word)


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_resolves_by_name():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = set()
    for w in BENCH["workloads"]:
        spec = harness.load_spec(w["name"], ROOT)
        used.add(w["config"])
        assert spec.config["name"] == w["config"]
        assert (ROOT / configs[w["config"]]["file"]).is_file()
        assert configs[w["config"]]["file"].startswith("portbench/")
        assert (ROOT / "portbench/mixes" / f"{w['traffic']}.json").is_file()
        assert traffic.check_mix(spec.mix)
        assert (ROOT / "portbench/reference"
                / f"{spec.config['reference']}.py").is_file()
        assert spec.limits["logit_gap"]["limit"] > 0
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer metric
        assert "setup_s" in {m["name"] for m in spec.metrics}
        assert len(spec.metrics) >= 2 and spec.trace_metrics
    assert used == set(configs)
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


def test_every_metric_has_its_reader():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]))
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        # a per-layer metric's cells report the end-to-end metric it moves
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


def test_config_files_are_the_programs_configuration():
    from repro_torch.models.config import get_config
    for c in BENCH["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["name"] == c["name"] and f["source"] == c["source"]
        assert f["reduced"] == c["reduced"] == []
        cfg = harness.program_config(f)
        ref = get_config(f["arch"])
        # nothing is cut: the registered architecture, number for number
        # (a head size of 0 there means d_model / n_heads)
        assert cfg.resolved_head_dim == ref.resolved_head_dim
        assert cfg.replace(head_dim=ref.head_dim) == ref, (cfg, ref)
