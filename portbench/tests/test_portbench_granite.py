"""The Granite 4.0-H cell on the CPU at a tiny size: a sound run is
correct, a run with the timed path broken underneath is not, and the
readers of the commit's ``write_delta`` and ``write_whole`` spans.

The tiny model keeps the published period (five Mamba-2 layers, one
attention layer, four Mamba-2), NoPE, the four multipliers, an MoE on
every layer with a shared expert, and a capacity factor of experts / top-k
(dropless).  Its limit, 0.00025, sits between the widest gap of sound CPU
runs (0.00022 on six seeds) and the narrowest gap of the float8 control
(0.00028 on the same six)."""
import json

import pytest

import pb_env
from test_portbench_faults import (altered_token, half_batch, no_undo,
                                   unchanged_state)

from portbench import harness

ROOT = pb_env.ROOT
SEED = 2**31 + 77
TINY = {"family": "hybrid", "n_layers": 10, "d_model": 64, "n_heads": 4,
        "n_kv_heads": 2, "head_dim": 16, "d_ff": 0, "vocab_size": 512,
        "tie_embeddings": True, "rope_type": "nope", "norm_eps": 1e-05,
        "dtype": "bfloat16", "vocab_pad_multiple": 256,
        "hybrid_pattern": ["ssm"] * 5 + ["attn"] + ["ssm"] * 4,
        "moe": {"n_experts": 8, "top_k": 3, "d_ff_expert": 32,
                "n_shared_experts": 2, "capacity_factor": 8 / 3},
        "ssm": {"d_state": 16, "head_dim": 16, "expand": 2,
                "chunk_size": 16, "n_groups": 1, "conv_width": 4},
        "embedding_multiplier": 12.0, "attention_multiplier": 0.0078125,
        "residual_multiplier": 0.22, "logits_scaling": 16.0}
LIMIT = 0.00025


def tiny_spec():
    config = {"name": "tiny-granite", "arch": "granite-4.0-h-small",
              "reference": "granite_hybrid", "model": TINY,
              "session": {"chunk_bytes": 1024}}
    mix = {"batch": 4, "prompt": 16, "gen": 8, "store": "memory",
           "check_cycles": 2, "trace_cycles": 2}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return harness.Spec({"name": config["name"], "chips": 1}, config, mix,
                        {"logit_gap": {"limit": LIMIT}}, bench["end_to_end"],
                        bench["per_layer"])


def _run(trace=False, **faults):
    return harness.run_cell(tiny_spec(), SEED, 0.5, trace, device="cpu",
                            **faults)


def test_sound_run_is_correct_and_reads_both_write_spans():
    out = _run(trace=True)
    assert out["correct"], out["checks"]
    run = out["run"]
    # each commit writes the KV rows by the dirty-range path and the SSM
    # state whole: both spans, nested in the commit's serialize
    for c in run.cycles:
        assert 0 < c.spans_cell["write_delta"] <= c.spans_cell["serialize"]
        assert 0 < c.spans_cell["write_whole"] <= c.spans_cell["serialize"]
    for name in ("delta_write_ms", "whole_write_ms"):
        assert harness.reader(name)(run) > 0, name
    assert run.cycles[0].run["chunks_written"] > 0


@pytest.mark.parametrize("fault", [unchanged_state, half_batch,
                                   altered_token])
def test_broken_step_is_not_correct(fault):
    out = _run(step_wrapper=fault)
    assert not out["correct"]
    assert out["checks"]["logit_gap"]["value"] \
        > out["checks"]["logit_gap"]["limit"], out["checks"]


def test_undo_that_restores_nothing_is_not_correct():
    out = _run(checkout_wrapper=no_undo)
    assert not out["correct"]
    assert out["checks"]["undo_diff"]["value"] > 0


def _cycles(spans):
    cycles = [harness.Cycle(0.1, 1.0, {}, {}, dict(sc), {}) for sc in spans]
    return harness.Run({}, {}, cycles, 10.0, 100, 1.0, 0)


def test_write_readers_take_the_median_in_ms():
    run = _cycles([{"write_delta": 0.010, "write_whole": 0.9},
                   {"write_delta": 0.030, "write_whole": 0.7},
                   {"write_delta": 0.020}])
    assert harness.reader("delta_write_ms")(run) == pytest.approx(20.0)
    assert harness.reader("whole_write_ms")(run) == pytest.approx(800.0)


@pytest.mark.parametrize("name", ["delta_write_ms", "whole_write_ms"])
def test_write_readers_find_nothing_without_the_spans(name):
    # a program without the spans (the parent of this change) serializes
    # and publishes all the same
    run = _cycles([{"serialize": 0.2, "d2h": 0.1, "publish": 0.3}] * 3)
    assert harness.reader(name)(run) is None


def test_entries():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in ("delta_write_ms", "whole_write_ms"):
        m = per_layer[name]
        assert (m["unit"], m["better"], m["source"], m["layer"],
                m["moves"]) == ("ms", "lower", "program_span",
                                "write and store", "cell_ms_p50")
        assert m["workloads"] == ["granite-4.0-h-small.regen"]
    spec = harness.load_spec("granite-4.0-h-small.regen", ROOT)
    assert [m["name"] for m in spec.metrics] == [
        "cell_ms_p50", "stored_mb_per_cell", "setup_s"]
    assert {"delta_write_ms", "whole_write_ms"} <= {
        m["name"] for m in spec.trace_metrics}
