"""Readings that set a cell's correctness limit, on the card.

    python3 portbench/control.py --workload smollm-360m.regen \
        --seeds 11,12,13 --seconds 4

For each seed: one run of the cell with a short window at its own load
(the same set-up, batch, lengths and sample as a benchmark run), the
served tokens' widest logit gap against the float32 reference (the
program's reading), and the gap of the tokens that the reference computed
from float8 e4m3 operands ranks first at the same positions (the
control's reading).  One JSON line a seed, then the largest program gap
and the smallest control gap.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys

from run import _environment


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--quant", default="fp8")
    args = ap.parse_args(argv)
    _environment()
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    spec = harness.load_spec(args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(spec, seed, args.seconds, False,
                               control=args.quant)
        rows.append({"seed": seed, "program_gap": out["checks"]
                     ["logit_gap"]["value"], "control_gap":
                     out["control_gap"], "undo_diff": out["checks"]
                     ["undo_diff"]["value"], "cycles":
                     len(out["run"].cycles)})
        print(json.dumps(rows[-1]), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "quant": args.quant,
                      "lower": max(r["program_gap"] for r in rows),
                      "upper": min(r["control_gap"] for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
