"""Multi-pod dry run: build and run every (arch x shape x mesh) cell on the
production meshes in one process (the port of the JAX package's
``launch/dryrun.py``).

For each cell the dry run:
  1. builds abstract inputs (``meta`` tensors: shapes and dtypes, no
     storage),
  2. derives DTensor placements from ShardingRules on the production mesh
     (16x16 or 2x16x16 ranks of a ``fake`` process group: collectives
     return at once and move nothing),
  3. runs the step once on meta DTensors — proving the distribution
     config is coherent (placements, sharding propagation, collectives),
  4. records the step's FLOPs on one rank (``FlopCounterMode``; the
     products run on each rank's local shards, ``models.layers``, so the
     count is per rank, as XLA's per-device cost analysis is) and its
     collectives with their result bytes on one rank
     (:class:`CollectiveCounter`, a ``CommDebugMode``) into a JSON
     artifact under ``build/dryrun/``.

Decode cells run as the JAX package builds them: the caches are meta
DTensors placed by ``ShardingRules.cache_spec`` (K/V and MLA's
compressed cache sharded on the sequence over ``model``, SSM state on
its heads, ``enc_out`` on the batch), the batch by ``batch_spec``, and
each rank writes and attends over its own sequence shard
(``models.layers.sharded_decode_write``, ``SeqShard.attention``), so no
collective moves a cache.

Torch runs no compiler here, so there is no HLO to parse: the collectives
are counted as DTensor issues them.  XLA's cost analysis counts a loop
body once, which is why the JAX package calibrates; eager counting sees
every layer, and :func:`calibrate_cell` fits the same linear model from
small variants as a cross-check that needs no full-depth run.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--force]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs  # noqa: F401  (registers the archs)
from repro_torch.configs.shapes import (SHAPES, abstract, abstract_params,
                                        cells, input_specs, shape_applicable)
from repro_torch.launch.mesh import (PRODUCTION_SHAPES, init_fake_group,
                                     make_production_mesh)
from repro_torch.models.config import get_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding.resharding import local_box
from repro_torch.sharding.rules import ShardingRules
from repro_torch.train import step as step_lib

ART_DIR = str(Path(__file__).resolve().parents[3] / "build" / "dryrun")

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "broadcast")
_KIND = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
         "all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all", "broadcast": "broadcast"}


def _nbytes(out: Any) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(o) for o in out)
    return 0


class CollectiveCounter(CommDebugMode):
    """``CommDebugMode`` that also sums each collective's result bytes on
    this rank, by kind (all-reduce, all-gather, reduce-scatter,
    all-to-all, broadcast) — what the JAX package reads off the
    optimized HLO's result types."""

    def __init__(self):
        super().__init__()
        self.bytes: Dict[str, int] = defaultdict(int)
        self.counts: Dict[str, int] = defaultdict(int)
        self.results: list = []          # (kind, result bytes), in order

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = sum(self.comm_counts.values())
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is not NotImplemented and \
                sum(self.comm_counts.values()) > before:
            kind = _KIND.get(func._overloadpacket.__name__.rstrip("_"),
                             func._overloadpacket.__name__)
            self.bytes[kind] += _nbytes(out)
            self.counts[kind] += 1
            self.results.append((kind, _nbytes(out)))
        return out


def collective_bytes(counter: CollectiveCounter) -> Dict[str, Any]:
    """Result bytes and counts per collective kind, and their total (the
    JAX package's record, keys included)."""
    out = {k: int(counter.bytes.get(k, 0)) for k in COLLECTIVES}
    counts = {f"n_{k}": int(counter.counts.get(k, 0)) for k in COLLECTIVES}
    return {**out, **counts, "total": sum(out.values())}


def meta_dtensor(x: torch.Tensor, mesh, placements) -> DTensor:
    """A DTensor over ``mesh`` whose local shard is a ``meta`` tensor of
    this rank's shape: no storage, no communication."""
    local, _ = local_box(tuple(x.shape), tuple(mesh.shape),
                         mesh.get_coordinate(), placements)
    return DTensor.from_local(
        torch.empty(local, dtype=x.dtype, device="meta"), mesh,
        list(placements), run_check=False, shape=x.shape, stride=x.stride())


def _dtree(tree: Any, mesh, placements: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _dtree(v, mesh, placements[k]) for k, v in tree.items()}
    return meta_dtensor(tree, mesh, placements)


def _tree_device_bytes(tree: Any) -> int:
    """Bytes of this rank's shards of a tree of (meta) DTensors."""
    if isinstance(tree, dict):
        return sum(_tree_device_bytes(v) for v in tree.values())
    t = tree.to_local() if isinstance(tree, DTensor) else tree
    return t.numel() * t.element_size()


def stage_unit_counts(cfg) -> list:
    """Current number of units per stage (decoder stages [+ encoder])."""
    from repro_torch.models import lm as lm_lib
    counts = [s.n_units for s in lm_lib.build_stages(cfg)]
    if cfg.enc_dec:
        counts.append(lm_lib.encoder_stages(cfg)[0].n_units)
    return counts


def with_stage_counts(cfg, counts: list):
    """Config surgery: rebuild cfg so each stage has the given unit count."""
    from repro_torch.models import lm as lm_lib
    stages = lm_lib.build_stages(cfg)
    kw = {}
    if cfg.moe is not None and cfg.moe.n_dense_layers:
        assert len(stages) == 2
        kw["moe"] = dataclasses.replace(cfg.moe, n_dense_layers=counts[0])
        kw["n_layers"] = counts[0] + counts[1] * len(stages[1].unit)
    else:
        assert len(stages) == 1
        kw["n_layers"] = counts[0] * len(stages[0].unit)
    if cfg.enc_dec:
        kw["n_encoder_layers"] = counts[-1]
    return cfg.replace(**kw)


def calibration_points(cfg) -> list:
    """(variant_cfg, counts) points for solving cost = outer + sum N_i*body_i:
    a base with 1 unit per stage plus one +1 point per stage."""
    n_stages = len(stage_unit_counts(cfg))
    base = [1] * n_stages
    pts = [list(base)]
    for i in range(n_stages):
        v = list(base)
        v[i] = 2
        pts.append(v)
    return [(with_stage_counts(cfg, c), c) for c in pts]


def opt_config(cfg) -> AdamWConfig:
    """The AdamW config of ``cfg``'s train cells, as the JAX package's dry
    run picks it: bf16 moments above 5e10 total params, else float32."""
    return AdamWConfig(
        moment_dtype="bfloat16" if cfg.param_counts()["total"] > 5e10
        else "float32")


def build_cell(arch: str, shape: str, mesh, *, cfg_override=None,
               rules_opts: Optional[dict] = None) -> Dict[str, Any]:
    """(fn, meta DTensor args, placements) for one cell on ``mesh``."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    spec = input_specs(cfg, shape)
    rules = ShardingRules(cfg, mesh, **(rules_opts or {}))
    s = SHAPES[shape]
    hidden = ((mesh, rules.hidden_spec(s.global_batch, s.seq_len))
              if rules.seq_shard_activations else None)
    bshard = rules.batch_spec(spec["batch"])
    batch = _dtree(spec["batch"], mesh, bshard)

    if spec["kind"] == "train":
        opt_cfg = opt_config(cfg)
        state = abstract(step_lib.init_train_state, cfg, 0, opt_cfg,
                         device="cpu")
        pshard = rules.param_shardings(state["params"])
        sstate = {"params": _dtree(state["params"], mesh, pshard),
                  "opt": {"mu": _dtree(state["opt"]["mu"], mesh, pshard),
                          "nu": _dtree(state["opt"]["nu"], mesh, pshard),
                          "count": state["opt"]["count"]},
                  "step": state["step"], "rng": state["rng"]}
        fn = step_lib.make_train_step(cfg, opt_cfg, hidden_sharding=hidden)
        return {"fn": fn, "args": (sstate, batch), "cfg": cfg,
                "rules": rules, "arg_shards": (pshard, bshard)}

    params = abstract_params(cfg)
    pshard = rules.param_shardings(params)
    dparams = _dtree(params, mesh, pshard)
    if spec["kind"] == "prefill":
        fn = step_lib.make_prefill_step(cfg, hidden_sharding=hidden)
        return {"fn": fn, "args": (dparams, batch), "cfg": cfg,
                "rules": rules, "arg_shards": (pshard, bshard)}
    # decode: caches placed by cache_spec, as the JAX package jits it
    cshard = rules.cache_spec(spec["caches"], s.global_batch)
    caches = _dtree(spec["caches"], mesh, cshard)
    fn = step_lib.make_decode_step(cfg)
    return {"fn": fn, "args": (dparams, caches, batch), "cfg": cfg,
            "rules": rules, "arg_shards": (pshard, cshard, bshard)}


def ensure_fake_group(world_size: int) -> None:
    """A ``fake`` default group of ``world_size`` ranks (replacing another
    fake group of another size; any other group is left alone)."""
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("a non-fake process group is initialised")
        dist.destroy_process_group()
    init_fake_group(world_size)


def _measure(cell) -> Dict[str, Any]:
    from repro_torch.sharding import context as shctx
    counter, flops = CollectiveCounter(), FlopCounterMode(display=False)
    with shctx.moe_weight_gather(cell["rules"]), counter, flops:
        cell["fn"](*cell["args"])
    return {"flops": float(flops.get_total_flops()),
            "collectives": collective_bytes(counter),
            "results": list(counter.results)}


def run_cell(arch: str, shape: str, mesh_kind: str, *,
             out_dir: str = ART_DIR, force: bool = False,
             save: bool = True, variant: str = "",
             rules_opts: Optional[dict] = None, mesh=None) -> Dict[str, Any]:
    """Run one cell on the production mesh of ``mesh_kind`` ("single" or
    "multi"; ``mesh`` overrides it) and record it; an existing artifact is
    returned unless ``force``."""
    suffix = f"__{variant}" if variant else ""
    path = os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}{suffix}.json")
    if save and os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    cfg = get_config(arch)
    ok, why = shape_applicable(cfg, shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "variant": variant, "rules_opts": rules_opts or {}}
    if ok:
        t0 = time.monotonic()
        try:
            if mesh is None:
                dims, _ = PRODUCTION_SHAPES[mesh_kind]
                ensure_fake_group(int(torch.tensor(dims).prod()))
                mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                            device_type="cpu")
            cell = build_cell(arch, shape, mesh, rules_opts=rules_opts)
            t_build = time.monotonic() - t0
            m = _measure(cell)
            pc = cfg.param_counts()
            rec.update({
                "status": "ok", "n_devices": int(mesh.size()),
                "build_s": round(t_build, 2),
                "run_s": round(time.monotonic() - t0 - t_build, 2),
                "flops": m["flops"],
                "collectives": m["collectives"],
                "arg_bytes_per_device": int(sum(
                    _tree_device_bytes(a) for a in cell["args"])),
                "params_total": pc["total"], "params_active": pc["active"]})
        except Exception as e:  # noqa: BLE001 — recorded per cell
            rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-4000:]})
    else:
        rec.update({"status": "skip", "reason": why})
    if save:
        os.makedirs(out_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def _cost_vector(cell) -> Dict[str, float]:
    m = _measure(cell)
    vec = {"flops": m["flops"]}
    for k in COLLECTIVES:
        vec[f"coll_{k}"] = float(m["collectives"][k])
    vec["coll_total"] = float(m["collectives"]["total"])
    return vec


def calibrate_cell(arch: str, shape: str, mesh_kind: str, *,
                   out_dir: str = ART_DIR, force: bool = False,
                   variant: str = "",
                   rules_opts: Optional[dict] = None) -> Optional[dict]:
    """Fit cost = outer + sum_i N_i * body_i from small variants (1 unit
    per stage, plus one +1 point per stage) and evaluate it at the real
    unit counts; stored under "calibrated" in the cell's artifact."""
    suffix = f"__{variant}" if variant else ""
    path = os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}{suffix}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        rec = json.load(f)
    if rec.get("status") != "ok":
        return None
    if "calibrated" in rec and not force:
        return rec["calibrated"]
    rules_opts = rules_opts or rec.get("rules_opts") or {}
    cfg = get_config(arch)
    dims, _ = PRODUCTION_SHAPES[mesh_kind]
    vecs = []
    try:
        ensure_fake_group(int(torch.tensor(dims).prod()))
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                    device_type="cpu")
        for vcfg, counts in calibration_points(cfg):
            cell = build_cell(arch, shape, mesh, cfg_override=vcfg,
                              rules_opts=rules_opts)
            vecs.append((counts, _cost_vector(cell)))
    except Exception as e:  # noqa: BLE001 — recorded per cell
        rec["calibrated"] = {"error": f"{type(e).__name__}: {e}"}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        return rec["calibrated"]
    base = vecs[0][1]
    n_true = stage_unit_counts(cfg)
    calibrated = {"points": [{"counts": c, **v} for c, v in vecs],
                  "n_units": n_true}
    for metric in base:
        bodies = [vecs[1 + i][1][metric] - base[metric]
                  for i in range(len(n_true))]
        outer = base[metric] - sum(bodies)
        calibrated[metric] = outer + sum(
            n * b for n, b in zip(n_true, bodies))
        calibrated[f"{metric}_outer"] = outer
        calibrated[f"{metric}_bodies"] = bodies
    rec["calibrated"] = calibrated
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return calibrated


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--calibrate", action="store_true",
                    help="add calibrated costs to artifacts")
    ap.add_argument("--out", default=ART_DIR)
    args = ap.parse_args()

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        todo = [(a, s, mk) for a, s, _ok, _why in cells() for mk in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        todo = [(args.arch, args.shape, mk) for mk in meshes]

    failures = 0
    for arch, shape, mk in todo:
        t0 = time.monotonic()
        if args.calibrate:
            cal = calibrate_cell(arch, shape, mk, out_dir=args.out,
                                 force=args.force)
            dt = time.monotonic() - t0
            if cal is None:
                print(f"[n/a  ] {arch:24s} {shape:12s} {mk:6s}", flush=True)
            elif "error" in cal:
                failures += 1
                print(f"[error] {arch:24s} {shape:12s} {mk:6s} ({dt:5.1f}s) "
                      f"{cal['error'][:120]}", flush=True)
            else:
                print(f"[ok   ] {arch:24s} {shape:12s} {mk:6s} ({dt:5.1f}s) "
                      f"cal_flops={cal['flops']:.3e} "
                      f"cal_coll={cal['coll_total']:.3e}B", flush=True)
            continue
        rec = run_cell(arch, shape, mk, out_dir=args.out, force=args.force)
        dt = time.monotonic() - t0
        status = rec["status"]
        extra = ""
        if status == "ok":
            extra = (f" flops={rec['flops']:.3e}"
                     f" coll={rec['collectives']['total']:.3e}B"
                     f" arg/dev={rec['arg_bytes_per_device'] / 2**30:.2f}GiB")
        elif status == "error":
            failures += 1
            extra = " " + rec["error"][:160]
        print(f"[{status:5s}] {arch:24s} {shape:12s} {mk:6s}"
              f" ({dt:5.1f}s){extra}", flush=True)
    if failures:
        print(f"{failures} FAILURES", flush=True)
        sys.exit(1)
    print("dry-run complete", flush=True)


if __name__ == "__main__":
    main()
