"""Paths and tiny cells for the benchmark's CPU tests."""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

TINY_MODELS = {
    "llama": {"family": "dense", "n_layers": 2, "d_model": 64, "n_heads": 4,
              "n_kv_heads": 2, "head_dim": 16, "d_ff": 128,
              "vocab_size": 512, "tie_embeddings": True,
              "rope_type": "standard", "rope_theta": 10000.0,
              "norm_eps": 1e-05, "dtype": "bfloat16",
              "vocab_pad_multiple": 256},
    "mamba2": {"family": "ssm", "n_layers": 2, "d_model": 64, "n_heads": 8,
               "n_kv_heads": 8, "d_ff": 0, "vocab_size": 500,
               "tie_embeddings": True, "rope_type": "none",
               "norm_eps": 1e-05, "dtype": "bfloat16",
               "vocab_pad_multiple": 256,
               "ssm": {"d_state": 16, "head_dim": 16, "expand": 2,
                       "chunk_size": 16, "n_groups": 1, "conv_width": 4}},
}
ARCH = {"llama": "smollm-360m", "mamba2": "mamba2-780m"}


TINY_LIMITS = {"llama": 0.02, "mamba2": 0.15}


def tiny_spec(family: str, store: str = "memory"):
    """A cell of the family's tiny model on the real mix's code path, with
    this repository's metric lists.  Its limit sits between the gaps of
    sound CPU runs (llama up to 0.002, mamba2 up to 0.06 on four seeds)
    and the fp8 control's (0.043, 0.26)."""
    from portbench import harness
    config = {"name": f"tiny-{family}", "arch": ARCH[family],
              "reference": family, "model": TINY_MODELS[family],
              "session": {"chunk_bytes": 1024}}
    mix = {"batch": 4, "prompt": 16, "gen": 8, "store": store,
           "check_cycles": 2, "trace_cycles": 2}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return harness.Spec({"name": config["name"], "chips": 1}, config, mix,
                        {"logit_gap": {"limit": TINY_LIMITS[family]}}, bench["end_to_end"],
                        bench["per_layer"])
