"""The benchmark's harness: one cell, one seed, one run.

A cell names a configuration file (``configs/<name>.json``: the model's
numbers as the port runs them, the session's chunk size, the reference
family) and a traffic mix (``mixes/<traffic>.json``, read by
``traffic.py``).  The run builds the weights and the prompts from the seed
on the device, fills the prefix caches with the port's graphed decode
step inside a ``KishuSession`` cell, commits them, warms the cycle, and
then measures cycles of (undo to the prefix, regenerate) for the window.
Per-cycle host times, the session's own stats and spans (traced runs),
the bytes the store took and, in a traced run, a ``torch.profiler`` trace
of a few cycles are what the metric readers (``metrics/<name>.py``) take
their numbers from; each phase's CPU seconds and garbage-collection
pauses go to the detail file alone.  Once the window has closed the program's state is
freed and ``check.py`` replays a sample of the served tokens through the
plain reference.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import resource
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from portbench import traffic as traffic_mod
from portbench import weights
from portbench.reference import family
from portbench.store import CountingStore

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


# ---------------------------------------------------------------------------
# the cell's files, found by name
# ---------------------------------------------------------------------------

@dataclass
class Spec:
    workload: dict
    config: dict
    mix: dict
    limits: dict
    metrics: List[dict]              # BENCHMARK.json entries this cell reads
    trace_metrics: List[dict]


def load_spec(workload: str, root: Path = ROOT) -> Spec:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    mix = traffic_mod.check_mix(json.loads(
        (root / "portbench" / "mixes" / f"{cell['traffic']}.json")
        .read_text()))
    limits = json.loads((root / "portbench" / "limits"
                         / f"{workload}.json").read_text())

    def mine(ms):
        return [m for m in ms if workload in m.get("workloads", [workload])]
    return Spec(cell, config, mix, limits, mine(bench["end_to_end"]),
                mine(bench["per_layer"]))


def reader(name: str) -> Callable[["Run"], Optional[float]]:
    """``metrics/<name>.py``'s ``read``."""
    import importlib.util
    path = Path(__file__).resolve().parent / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# what a run leaves for the readers
# ---------------------------------------------------------------------------

@dataclass
class Cycle:
    undo_s: float
    cell_s: float
    run: Dict[str, float]            # the commit's RunStats / WriteStats
    checkout: Dict[str, float]       # the undo's CheckoutStats
    spans_cell: Dict[str, float] = field(default_factory=dict)
    spans_undo: Dict[str, float] = field(default_factory=dict)
    host: Dict[str, Dict[str, float]] = field(default_factory=dict)


@dataclass
class Run:
    config: dict
    mix: dict
    cycles: List[Cycle]
    window_s: float
    tokens: int
    setup_s: float
    stored_bytes: int
    device: Optional[dict] = None    # devtrace.digest of the traced cycles

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def chunk_bytes(self) -> int:
        return self.config["session"]["chunk_bytes"]


def median(xs) -> Optional[float]:
    xs = [x for x in xs if x is not None]
    return statistics.median(xs) if xs else None


# ---------------------------------------------------------------------------
# time since the process started
# ---------------------------------------------------------------------------

_T_IMPORT = time.monotonic()


def process_age_s() -> float:
    """Seconds since this process started (``/proc``'s start time against
    the uptime clock); since this module's import where that is not
    readable."""
    try:
        start = int(Path("/proc/self/stat").read_text()
                    .rsplit(")", 1)[1].split()[19])
        up = float(Path("/proc/uptime").read_text().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _T_IMPORT


# ---------------------------------------------------------------------------
# what the process did in a phase (the detail file; read by no metric)
# ---------------------------------------------------------------------------

_GC = {"s": 0.0, "full": 0, "t0": 0.0}


def _gc_clock(phase: str, info: dict) -> None:
    if phase == "start":
        _GC["t0"] = time.perf_counter()
    else:
        _GC["s"] += time.perf_counter() - _GC["t0"]
        _GC["full"] += int(info.get("generation") == 2)


def host_reading() -> Dict[str, float]:
    """CPU seconds (all threads) and Python's garbage-collection pauses
    (seconds, and full collections) of this process so far."""
    if _gc_clock not in gc.callbacks:
        gc.callbacks.append(_gc_clock)
    r = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": r.ru_utime + r.ru_stime, "gc_s": _GC["s"],
            "gc_full": _GC["full"]}


def host_delta(a: Dict[str, float], b: Dict[str, float]
               ) -> Dict[str, float]:
    return {k: b[k] - a[k] for k in a}


# ---------------------------------------------------------------------------
# the program under test
# ---------------------------------------------------------------------------

def program_config(config: dict):
    """The port's ``ArchConfig`` with every number of the file's
    ``model`` (the configuration as it is run)."""
    from repro_torch.models.config import SSMConfig, get_config
    model = dict(config["model"])
    if isinstance(model.get("ssm"), dict):
        model["ssm"] = SSMConfig(**model["ssm"])
    return get_config(config["arch"]).replace(**model)


def open_run_store(kind: str, tmp: Path):
    from repro_torch.core import open_store
    if kind == "memory":
        return open_store("memory://")
    return open_store(f"sqlite://{tmp / 'kishu.db'}")


class Ranges:
    """``record_function`` ranges a traced run marks, with their host
    monotonic times (to place the program's spans on the trace's clock);
    nothing at all in an untraced run."""

    def __init__(self, on: bool):
        self.on = on
        self.marks: List[tuple] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        from torch.profiler import record_function
        t0 = time.monotonic_ns()
        with record_function(name):
            yield
        self.marks.append((name, t0, time.monotonic_ns()))


def _int_view(t: torch.Tensor) -> torch.Tensor:
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool,
             device: str = "cuda", step_wrapper=None,
             checkout_wrapper=None, control: Optional[str] = None) -> dict:
    """One run.  Returns ``{"run": Run, "checks": {...}, "correct": bool,
    "attempted", "failed", "memory_peak_bytes", "host_rss_peak_bytes"}``.
    ``step_wrapper`` / ``checkout_wrapper`` plant faults for the tests;
    ``control`` (``"fp8"``) also reads the control's gap on the same
    sample (``out["control_gap"]``)."""
    from repro_torch.core import KishuSession
    from repro_torch.train.step import GraphedDecodeStep

    from portbench import check, devtrace

    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    config, mix = spec.config, spec.mix
    model, ref = config["model"], family(config["reference"])
    cfg = program_config(config)
    b, plen, glen = mix["batch"], mix["prompt"], mix["gen"]
    vocab = model["vocab_size"]
    params = weights.make(ref.layout(model),
                          traffic_mod.sub_seed(seed, "weights"), dev)
    tr = traffic_mod.make(mix, vocab, seed, dev)
    prompts = tr.prompts
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    tmp = tempfile.TemporaryDirectory(prefix="portbench-")
    store = CountingStore(open_run_store(mix["store"], Path(tmp.name)))
    sess = KishuSession(store, chunk_bytes=config["session"]["chunk_bytes"],
                        trace=trace, device=dev)
    tracer = sess.obs.tracer
    ranges = Ranges(trace)
    step = GraphedDecodeStep(cfg)
    if step_wrapper is not None:
        step = step_wrapper(step)

    def prefill(ns):
        from repro_torch.models import lm
        caches = lm.init_caches(cfg, b, plen + glen, device=dev)
        tok = prompts[:, :1]
        for t in range(plen):
            nxt, caches = step(params, caches, {"tokens": tok, "index": t})
            tok = prompts[:, t + 1:t + 2] if t + 1 < plen else nxt
        ns.set_tree("caches", caches)
        ns["last_tok"] = tok
        ns["pos"] = plen

    def generate(ns, n, flavor):
        with ranges("cell_exec"):
            caches = ns.get_tree("caches")
            tok, pos, outs = ns["last_tok"], ns["pos"], []
            for t in range(n):
                tok, caches = step(params, caches,
                                   {"tokens": (tok + flavor) % vocab,
                                    "index": pos + t})
                outs.append(tok)
            ns.set_tree("caches", caches)
            ns["last_tok"] = tok
            ns["pos"] = pos + n
            ns["generated"] = torch.cat(outs, dim=1)
            sync()

    sess.register("prefill", prefill)
    sess.register("generate", generate)
    sess.init_state({})
    checkout = sess.checkout if checkout_wrapper is None \
        else checkout_wrapper(sess)

    # ---- set-up: the prefix, its commit, the state's own copy, warm-up
    c_prefix = sess.run("prefill")
    sync()
    snap = {n: sess.ns[n].clone() for n in sess.ns.names()
            if isinstance(sess.ns[n], torch.Tensor)}
    snap_names = set(sess.ns.names())
    prefix_last = sess.ns["last_tok"].clone()
    flavors = iter(tr.flavors)
    sess.run("generate", n=glen, flavor=next(flavors))
    checkout(c_prefix)
    sess.run("generate", n=glen, flavor=next(flavors))
    sync()
    tracer.clear()
    setup_s = process_age_s()

    # ---- the window
    undo_diff = torch.zeros((), dtype=torch.int64, device=dev)
    undo_other = 0                   # undos that left other names or pos
    spans_raw: list = []

    def cycle(flavor: int, keep_spans: bool) -> Cycle:
        """Undo to the prefix, check the restored state on the device
        (read after the window), regenerate."""
        nonlocal undo_diff, undo_other
        h0 = host_reading()
        t0 = time.perf_counter()
        with ranges("kishu_checkout"):
            st = checkout(c_prefix)
            sync()
        undo_s = time.perf_counter() - t0
        h1 = host_reading()
        sp_undo = tracer.stage_totals()
        if keep_spans:
            spans_raw.extend(tracer.spans)
        tracer.clear()
        for name, want in snap.items():
            undo_diff += torch.ne(_int_view(sess.ns[name]),
                                  _int_view(want)).sum()
        undo_other += int(set(sess.ns.names()) != snap_names
                          or sess.ns["pos"] != plen)
        sync()
        cap0 = (getattr(step, "captures", 0), getattr(step, "capture_s", 0.0))
        h2 = host_reading()
        t1 = time.perf_counter()
        with ranges("kishu_commit"):
            sess.run("generate", n=glen, flavor=flavor)
            sync()
        cell_s = time.perf_counter() - t1
        h3 = host_reading()
        sp_cell = tracer.stage_totals()
        if keep_spans:
            spans_raw.extend(tracer.spans)
        tracer.clear()
        r, w = sess.last_run, sess.last_run.write
        return Cycle(
            undo_s, cell_s,
            {"exec_s": r.exec_s, "detect_s": r.detect_s,
             "write_s": r.write_s, "total_s": r.total_s,
             "bytes_dev2host": w.bytes_dev2host,
             "bytes_written": w.bytes_written,
             "chunks_written": w.chunks_written,
             "captures": getattr(step, "captures", 0) - cap0[0],
             "capture_s": getattr(step, "capture_s", 0.0) - cap0[1]},
            {"covs_loaded": st.covs_loaded, "covs_patched": st.covs_patched,
             "chunks_patched": st.chunks_patched,
             "bytes_loaded": st.bytes_loaded,
             "bytes_cached": st.bytes_cached,
             "bytes_host2dev": st.bytes_host2dev},
            sp_cell, sp_undo,
            {"undo": host_delta(h0, h1), "cell": host_delta(h2, h3)})

    cycles: List[Cycle] = []
    gens: List[tuple] = []           # (flavor, generated [B, gen])
    store.reset()
    t_w0 = time.perf_counter()
    while not cycles or time.perf_counter() - t_w0 < seconds:
        flavor = next(flavors)
        cycles.append(cycle(flavor, False))
        gens.append((flavor, sess.ns["generated"].clone()))
    window_s = time.perf_counter() - t_w0
    stored = store.written
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    # ---- a traced run profiles a few more cycles once the window closed
    digest = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
        m0 = len(ranges.marks)
        for _ in range(mix["trace_cycles"]):
            cycle(next(flavors), True)
        prof.stop()
        digest = devtrace.digest(prof, ranges.marks[m0:], spans_raw,
                                 tracer.epoch)
        del prof

    # ---- then the check, on the window's served tokens
    k = len(cycles)
    run = Run(config, mix, cycles, window_s, k * b * glen, setup_s, stored,
              digest)
    failed = sum(int(((g < 0) | (g >= vocab)).any(dim=1).sum())
                 for _, g in gens)
    sess.close()
    del sess, step, snap
    tmp.cleanup()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    sample = traffic_mod.check_sample(len(gens), mix["check_cycles"], seed)
    picked = [gens[i] for i in sample]
    gap = check.served_gap(ref, model, params, prompts, prefix_last, picked)
    ctl = check.control_gap(ref, model, params, prompts, prefix_last,
                            picked, control) if control else None
    checks = {
        "logit_gap": {"value": gap,
                      "limit": spec.limits["logit_gap"]["limit"]},
        "undo_diff": {"value": int(undo_diff) + undo_other,
                      "limit": 0},
        "bad_tokens": {"value": failed, "limit": 0},
    }
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return {"run": run, "checks": checks, "correct": correct,
            "control_gap": ctl,
            "attempted": k * b, "failed": failed,
            "memory_peak_bytes": int(peak),
            "host_rss_peak_bytes": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * 1024}


def metrics_of(run: Run, entries: List[dict]) -> Dict[str, dict]:
    """Each entry's reader on ``run``; a reader that finds nothing to read
    leaves its metric out."""
    out = {}
    for m in entries:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its relatives' or the
    JAX package's, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)
