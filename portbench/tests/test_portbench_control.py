"""The control: the reference computed from float8 e4m3 operands put in
the program's place must read a wider gap than the program does.  On the
CPU at a tiny size of each family; on the card at a cell's own size
(``-m cuda``), against the cell's limit."""
import json

import pytest
import torch

import pb_env

from portbench import harness

ROOT = pb_env.ROOT


@pytest.mark.parametrize("family", ["llama", "mamba2"])
def test_control_reads_wider_than_the_program_on_cpu(family):
    spec = pb_env.tiny_spec(family)
    for seed in (21, 22, 23):
        out = harness.run_cell(spec, seed, 0.3, False, device="cpu",
                               control="fp8")
        assert out["correct"]
        prog = out["checks"]["logit_gap"]["value"]
        assert out["control_gap"] > max(3 * prog, 1e-3), (seed, prog,
                                                          out["control_gap"])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_control_fails_the_cells_limit_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = harness.load_spec(workload, ROOT)
    limit = spec.limits["logit_gap"]["limit"]
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        out = harness.run_cell(spec, seed, 3.0, False, control="fp8")
        print(workload, seed, "program", out["checks"]["logit_gap"]["value"],
              "control", out["control_gap"], "limit", limit)
        assert out["correct"], out["checks"]
        assert out["control_gap"] > limit, (seed, out["control_gap"], limit)
