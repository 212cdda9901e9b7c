"""The port's dry-run machinery (``tests/test_distribution.py``'s
``test_dryrun_machinery_small_mesh`` and its HLO-parser test): a reduced
qwen3-1.7b train step on a (2,4) mesh of a ``fake`` process group moves
more than 0 collective bytes; the collective counter counts a hand-built
DTensor program exactly; prefill and decode cells run, and a decode
cell's collectives do not grow with the cache; ``long_500k`` runs for a
sub-quadratic arch and skips otherwise; cells, shapes and the production
meshes build with no allocation; artifacts land under ``build/``."""
import os
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs import shapes
from repro_torch.core.namespace import flatten_tree
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake_group
from repro_torch.models.config import get_config
from repro_torch.models.testing import reduced

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def fake8():
    init_fake_group(8)
    try:
        yield init_device_mesh("cpu", (2, 4), mesh_dim_names=("data",
                                                              "model"))
    finally:
        dist.destroy_process_group()


def test_dryrun_machinery_small_mesh(fake8):
    small = reduced(get_config("qwen3-1.7b"), n_layers=2)
    cell = dryrun.build_cell("qwen3-1.7b", "train_4k", fake8,
                             cfg_override=small)
    params = cell["args"][0]["params"]
    leaf = params["stages"]["stage_0"]["sub_0"]["attn"]["wq"]
    assert isinstance(leaf, DTensor) and leaf.to_local().is_meta
    m = dryrun._measure(cell)
    coll = m["collectives"]
    assert coll["total"] > 0, "expected collectives in sharded train step"
    assert coll["n_all-reduce"] + coll["n_all-gather"] \
        + coll["n_reduce-scatter"] > 0
    assert m["flops"] > 0


def test_prefill_and_decode_cells_run(fake8, tmp_path):
    """A reduced qwen3-1.7b prefill on the (2,4) fake mesh runs as one
    SPMD program (flash attention on each rank's local batch and heads)
    and moves collective bytes; so does its decode cell, on meta DTensor
    caches placed by ``cache_spec`` (the sequence over model), as the
    JAX package builds it; a full-size decode cell is recorded ok with
    the reference's keys."""
    small = reduced(get_config("qwen3-1.7b"), n_layers=2)
    cell = dryrun.build_cell("qwen3-1.7b", "prefill_32k", fake8,
                             cfg_override=small)
    m = dryrun._measure(cell)
    assert m["flops"] > 0 and m["collectives"]["total"] > 0
    cell = dryrun.build_cell("qwen3-1.7b", "decode_32k", fake8,
                             cfg_override=small)
    params, caches, batch = cell["args"]
    k = caches["stages"]["stage_0"]["sub_0"]["attn"]["k"]
    assert isinstance(k, DTensor) and k.to_local().is_meta
    assert tuple(k.placements) == (Shard(1), Shard(2))   # batch, sequence
    m = dryrun._measure(cell)
    assert m["flops"] > 0 and m["collectives"]["n_all-reduce"] > 0
    rec = dryrun.run_cell("qwen3-1.7b", "decode_32k", "single",
                          out_dir=str(tmp_path))      # on 256 fake ranks
    dist.destroy_process_group()
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_devices"] == 256 and rec["flops"] > 0
    assert set(rec["collectives"]) >= set(dryrun.COLLECTIVES) | {"total"}
    assert rec["arg_bytes_per_device"] > 0
    init_fake_group(8)                    # the fixture destroys a group


def _decode_cell_at(mesh, arch, seq, monkeypatch):
    """A reduced decode cell whose caches hold ``seq`` slots (encoder
    frames stay min(seq, 4096), as ``input_specs`` sizes them)."""
    monkeypatch.setitem(shapes.SHAPES, "decode_32k",
                        shapes.ShapeSpec("decode_32k", seq, 8, "decode"))
    cell = dryrun.build_cell(arch, "decode_32k", mesh,
                             cfg_override=reduced(get_config(arch)))
    return cell, dryrun._measure(cell)


@pytest.mark.parametrize("arch,lengths", [
    ("qwen3-1.7b", (72, 264)), ("deepseek-v3-671b", (72, 264)),
    ("jamba-1.5-large-398b", (72, 264)),
    ("whisper-large-v3", (4104, 16392))])
def test_decode_collectives_do_not_grow_with_the_cache(fake8, monkeypatch,
                                                       arch, lengths):
    """No cache is gathered: on the (2,4) fake mesh a reduced decode
    cell moves the same collective bytes, kind by kind, at two cache
    lengths, and no collective's result is the size of a
    sequence-sharded cache leaf (global, local or one unit's, with the
    sequence gathered or not; the lengths are no powers of two, so that
    no weight of the reduced configs has such a size).  Whisper keeps
    its encoder frames fixed (4096 at both lengths): its cross-attention
    recomputes K/V from ``enc_out`` every step, as the reference does,
    and what that moves scales with the frames, not the cache."""
    recs = []
    for seq in lengths:
        cell, m = _decode_cell_at(fake8, arch, seq, monkeypatch)
        sizes = set()
        for name, leaf in flatten_tree(cell["args"][1]).items():
            if name.split("/")[-1] not in ("k", "v", "c_kv", "k_rope"):
                continue
            local = leaf.to_local()
            item, u = leaf.element_size(), leaf.shape[0]
            g = leaf.numel() * item
            lo = local.numel() * item
            sizes |= {g, g // u, lo, lo // u, lo * 4 // u, lo * 4}
        assert sizes
        hit = [r for r in m["results"] if r[1] in sizes]
        assert not hit, (arch, seq, hit[:4])
        recs.append(m["collectives"])
    assert recs[0] == recs[1], (arch, recs)
    assert recs[0]["n_all-reduce"] > 0


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "deepseek-v3-671b",
                                  "jamba-1.5-large-398b", "qwen2-vl-72b"])
def test_train_cells_run_where_the_reference_trains(fake8, monkeypatch,
                                                    arch):
    """The ``train_4k`` cells that raised before, reduced, on the (2,4)
    fake mesh: MoE layers on DTensors (phi3.5-moe, deepseek-v3 with MLA
    and MTP, jamba's hybrid stack) take their gradients through the
    dispatch's gather and un-gather, and qwen2-vl trains from the
    frontend's ``embeds`` (its ``embed`` leaf unused, given a zero
    gradient on its placements).  The step runs, counts FLOPs and moves
    collective bytes, and the moments keep their placements.  The cell's
    sequence is cut to 64 tokens: the SSM's chunked scan issues ops in
    proportion to it."""
    monkeypatch.setitem(shapes.SHAPES, "train_4k",
                        shapes.ShapeSpec("train_4k", 64, 8, "train"))
    n_layers = 8 if arch.startswith("jamba") else 2   # one hybrid unit
    cell = dryrun.build_cell(arch, "train_4k", fake8, cfg_override=reduced(
        get_config(arch), n_layers=n_layers))
    state, batch = cell["args"]
    assert ("embeds" in batch) == (arch == "qwen2-vl-72b")
    m = dryrun._measure(cell)
    assert m["flops"] > 0 and m["collectives"]["total"] > 0
    flat, mu = flatten_tree(state["params"]), flatten_tree(state["opt"]["mu"])
    for k, p in flat.items():
        assert isinstance(mu[k], DTensor), k
        assert mu[k].placements == p.placements, k


def test_long_500k_runs_for_sub_quadratic_and_skips_otherwise(tmp_path):
    """mamba2 (reduced, registered for this test) runs ``long_500k`` on
    the (16,16) mesh; qwen3-1.7b is skipped with the reference's
    reason."""
    from repro.configs.shapes import shape_applicable as jshape_applicable
    from repro.models.config import get_config as jget
    import repro.configs  # noqa: F401
    from repro_torch.models import config as config_mod
    name = "mamba2-780m-reduced-dryrun-test"
    config_mod._REGISTRY[name] = reduced(get_config("mamba2-780m")).replace(
        name=name)
    try:
        rec = dryrun.run_cell(name, "long_500k", "single",
                              out_dir=str(tmp_path))
    finally:
        del config_mod._REGISTRY[name]
        if dist.is_initialized():
            dist.destroy_process_group()
    assert rec["status"] == "ok", rec.get("error")
    assert rec["flops"] > 0 and rec["collectives"]["total"] > 0
    rec = dryrun.run_cell("qwen3-1.7b", "long_500k", "single",
                          out_dir=str(tmp_path))
    assert rec["status"] == "skip"
    assert rec["reason"] == jshape_applicable(jget("qwen3-1.7b"),
                                              "long_500k")[1]


def test_collective_counter_counts_a_hand_built_program(fake8):
    """One all-gather over data, one all-reduce over model, one
    reduce-scatter over model, with their result bytes on this rank."""
    mesh = fake8
    x = DTensor.from_local(torch.zeros(4, 16), mesh, [Shard(0), Replicate()],
                           run_check=False)                # global [8, 16]
    p = DTensor.from_local(torch.zeros(8, 16), mesh,
                           [Replicate(), Partial()], run_check=False)
    q = DTensor.from_local(torch.zeros(8, 16), mesh,
                           [Replicate(), Partial()], run_check=False)
    counter = dryrun.CollectiveCounter()
    with counter:
        x.redistribute(mesh, [Replicate(), Replicate()])
        p.redistribute(mesh, [Replicate(), Replicate()])
        q.redistribute(mesh, [Replicate(), Shard(0)])
    c = dryrun.collective_bytes(counter)
    assert c["all-gather"] == 8 * 16 * 4
    assert c["all-reduce"] == 8 * 16 * 4
    assert c["reduce-scatter"] == 2 * 16 * 4            # 8 rows over 4
    assert (c["n_all-gather"], c["n_all-reduce"], c["n_reduce-scatter"],
            c["n_all-to-all"]) == (1, 1, 1, 0)
    assert c["total"] == 8 * 16 * 4 * 2 + 2 * 16 * 4


def test_run_cell_writes_under_build(tmp_path, monkeypatch):
    assert Path(dryrun.ART_DIR) == ROOT / "build" / "dryrun"
    rec = dryrun.run_cell("qwen3-1.7b", "long_500k", "single",
                          out_dir=str(tmp_path))
    assert rec["status"] == "skip"
    assert os.path.exists(tmp_path / "qwen3-1.7b__long_500k__single.json")


def test_shapes_and_cells_allocate_nothing():
    cells = shapes.cells()
    assert len(cells) == 40
    assert sum(1 for c in cells if not c[2]) == \
        sum(1 for a in {c[0] for c in cells}
            if not get_config(a).sub_quadratic)
    cfg = get_config("deepseek-v3-671b")
    spec = shapes.input_specs(cfg, "decode_32k")
    from repro_torch.optim.adamw import tree_leaves
    leaves = tree_leaves(spec["batch"]) + tree_leaves(spec["caches"])
    assert leaves and all(t.is_meta for t in leaves)
    p = shapes.abstract_params(cfg)
    assert p["embed"].is_meta and tuple(p["embed"].shape) == \
        (cfg.padded_vocab, cfg.d_model)
    with pytest.raises(ValueError):
        shapes.input_specs(get_config("qwen3-1.7b"), "long_500k")


def test_calibration_points_are_the_references():
    from repro.launch.dryrun import calibration_points as jpoints
    from repro.models.config import get_config as jget
    import repro.configs  # noqa: F401
    for arch in ("deepseek-v3-671b", "whisper-large-v3", "qwen3-1.7b"):
        got = [(c.n_layers, c.n_encoder_layers, counts)
               for c, counts in dryrun.calibration_points(get_config(arch))]
        want = [(c.n_layers, c.n_encoder_layers, counts)
                for c, counts in jpoints(jget(arch))]
        assert got == want, arch


def test_calibrated_cost_reproduces_the_full_run(tmp_path, monkeypatch):
    """Eager counting sees every layer, so the linear model fitted from
    the 1- and 2-unit variants gives the full-depth run's FLOPs and
    collective bytes back (the JAX package needs it because XLA's cost
    analysis counts a loop body once).  A 6-layer qwen3-1.7b at full
    width, registered for this test only, on the (16,16) mesh."""
    from repro_torch.models import config as config_mod
    name = "qwen3-1.7b-6-layers-dryrun-test"
    monkeypatch.setitem(config_mod._REGISTRY, name, get_config(
        "qwen3-1.7b").replace(name=name, n_layers=6))
    rec = dryrun.run_cell(name, "train_4k", "single", out_dir=str(tmp_path))
    try:
        assert rec["status"] == "ok", rec.get("error")
        cal = dryrun.calibrate_cell(name, "train_4k", "single",
                                    out_dir=str(tmp_path))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert "error" not in cal and cal["n_units"] == [6]
    assert cal["flops"] == pytest.approx(rec["flops"], rel=1e-9)
    assert cal["coll_total"] == pytest.approx(
        rec["collectives"]["total"], rel=1e-9)
