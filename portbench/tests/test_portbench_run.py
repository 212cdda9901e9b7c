"""The result's line and the measurement path without a card."""
import json
import os
import subprocess
import sys

import pytest

import pb_env

from portbench import harness
from portbench import run as run_mod

ROOT = pb_env.ROOT
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace, tmp_path):
    spec = pb_env.tiny_spec("llama")
    out = harness.run_cell(spec, 5, 0.3, trace, device="cpu")
    line = json.loads(json.dumps(run_mod.result_line(spec, out, trace,
                                                     "cpu", 1)))
    want = KEYS + (["breakdown"] if trace else []) + ["host", "checks"]
    assert list(line) == want
    assert list(line["checks"]) == ["logit_gap", "undo_diff", "bad_tokens"]
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    names = {m["name"] for m in (spec.trace_metrics if trace
                                 else spec.metrics)}
    assert set(line["metrics"]) <= names
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == names      # host clock: all read
        assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == len(out["run"].cycles) * spec.mix["batch"]
    detail = tmp_path / "d" / "detail.json"
    run_mod.write_detail(detail, line, out["run"])
    doc = json.loads(detail.read_text())
    assert doc["line"] == line and len(doc["cycles"]) == len(out["run"].cycles)


def test_no_card_fails_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "smollm-360m.regen", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "CUDA" in p.stderr


def test_readers_find_nothing_without_a_trace():
    spec = pb_env.tiny_spec("mamba2")
    out = harness.run_cell(spec, 9, 0.3, False, device="cpu")
    run = out["run"]
    for name in ("device_idle_share", "commit_kernel_roofline",
                 "checkout_kernel_roofline", "detect_ms", "put_ms"):
        assert harness.reader(name)(run) is None
