"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload smollm-360m.regen --seed 7 \
        --seconds 30 --trace 0

Prints the metrics of ``BENCHMARK.json`` for the cell as the last line
of standard output, one JSON object (``--trace 0``: the end-to-end
metrics; ``--trace 1``: the per-layer ones, the device's busy seconds
and the breakdown), and each number the correctness check compared,
beside its limit, as the last lines of standard error.  Exits with 2
and prints no result without a CUDA card (or with fewer cards than the
cell asks for), and with 3 where a module of JAX or the JAX package was
loaded.  Build and kernel caches live under ``build/`` in the checkout.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _environment() -> None:
    """Every cache the program, PyTorch and CUDA keep goes to a fixed
    directory inside the checkout; no library may load JAX by itself."""
    build = ROOT / "build"
    os.environ["KISHU_KERNEL_BUILD_DIR"] = str(build / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--detail", default=None,
                    help="also write every cycle's host times, session "
                         "stats and spans, and the trace's digest, to "
                         "this JSON file")
    return ap.parse_args(argv)


def result_line(spec, out: dict, trace: bool, kind: str, chips: int
                ) -> dict:
    """The result's line: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device`` (and ``breakdown`` in a traced run), ``host``,
    and last the numbers the check compared, each beside its limit."""
    from portbench import harness
    run = out["run"]
    metrics = harness.metrics_of(run, spec.trace_metrics if trace
                                 else spec.metrics)
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if trace:
        d = run.device or {"busy_s": 0.0, "window_s": run.window_s,
                           "device_ops": [], "idle_gaps": []}
        device["busy_s"], device["window_s"] = d["busy_s"], d["window_s"]
        line["breakdown"] = {"device_ops": d["device_ops"],
                             "idle_gaps": d["idle_gaps"]}
    line["host"] = {"rss_peak_bytes": out["host_rss_peak_bytes"],
                    "cycles": len(run.cycles), "window_s": run.window_s,
                    "setup_s": run.setup_s}
    line["checks"] = out["checks"]
    return line


def write_detail(path: Path, line: dict, run) -> None:
    """The result's line, every window cycle's host times, session stats
    and spans, and the trace's digest, as one JSON file."""
    import dataclasses
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(
        {"line": line, "window_s": run.window_s, "setup_s": run.setup_s,
         "device": run.device,
         "cycles": [dataclasses.asdict(c) for c in run.cycles]}))


def main(argv=None) -> int:
    args = parse_args(argv)
    _environment()
    import torch

    from portbench import harness

    spec = harness.load_spec(args.workload)
    chips = spec.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace))
    line = result_line(spec, out, bool(args.trace),
                       torch.cuda.get_device_name(0), chips)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: loaded modules of JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 3
    if args.detail:
        write_detail(Path(args.detail), line, out["run"])
    print(json.dumps(line))
    sys.stdout.flush()
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
