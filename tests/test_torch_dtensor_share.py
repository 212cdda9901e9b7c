"""Each rank of a DTensor step computes its share, as the JAX package's
GSPMD step does: the label-level DTensor einsum (``layers.label_plan``),
the batch-sharded embedding (``layers.embed_lookup``) and the sharded MoE
layer (``moe._moe_sharded``).

- (a) On a ``fake`` (4,4) mesh, reduced dense (qwen3), MoE (phi3.5-moe),
  MLA (deepseek-v3), enc-dec (whisper) and SSM (mamba2) configs run their
  train, prefill and decode cells; each rank's product FLOPs are at most
  1.25x the same cell's count on a one-rank fake mesh / 16.
- (b) The embedding's output and each stage boundary keep ``Shard(0)``
  over the batch axes (``embeds`` inputs as they arrive).
- (c) On 4 gloo ranks, the DTensor einsum of every two-operand equation
  the port calls gives the plain einsum's values and gradients under
  several operand placements, and its local product is a quarter of the
  global one (every label is 4 wide, so every mesh dim finds one).
- (d) At full size, ``qwen3-1.7b train_4k`` on the (16,16) mesh counts at
  most the JAX package's calibrated per-device FLOPs and at most 1.5x the
  unsharded step's FLOPs / 256 (the JAX dry run runs in a subprocess,
  writing under ``tmp_path``).
- (e) On a (1, 3) gloo mesh, where neither the batch nor the 4 heads
  divide the model dim, the sharded prefill runs flash on uneven head
  shards (2, 2 and 0 heads, k and v repeated to q's heads first) and
  gives the single-device prefill's logits.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import shapes
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake_group, run_local_ranks
from repro_torch.models import layers, lm
from repro_torch.models.config import get_config
from repro_torch.models.testing import reduced

from test_torch_einsum_route import TWO_OPERAND

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3-1.7b", "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b",
         "whisper-large-v3", "mamba2-780m"]
CELLS = ["train_4k", "prefill_32k", "decode_32k"]
RANK_TIMEOUT = 120.0


@pytest.fixture
def small_shapes(monkeypatch):
    """Every cell at 64 tokens (or cache slots) and a batch of 16."""
    for name in CELLS:
        monkeypatch.setitem(shapes.SHAPES, name, shapes.ShapeSpec(
            name, 64, 16, shapes.SHAPES[name].kind))


def _on_fake_mesh(dims, fn):
    init_fake_group(int(np.prod(dims)))
    try:
        return fn(init_device_mesh("cpu", dims,
                                   mesh_dim_names=("data", "model")))
    finally:
        dist.destroy_process_group()


def _cell_flops(arch, shape, dims):
    def run(mesh):
        cell = dryrun.build_cell(arch, shape, mesh,
                                 cfg_override=reduced(get_config(arch)))
        return dryrun._measure(cell)["flops"]
    return _on_fake_mesh(dims, run)


@pytest.mark.parametrize("shape", CELLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_a_rank_computes_its_share(small_shapes, arch, shape):
    one = _cell_flops(arch, shape, (1, 1))
    share = _cell_flops(arch, shape, (4, 4))
    assert one > 0
    assert share <= 1.25 * one / 16, (arch, shape, share * 16 / one)


@pytest.mark.parametrize("shape", CELLS)
@pytest.mark.parametrize("arch", ARCHS + ["qwen2-vl-72b"])
def test_activations_stay_batch_sharded(small_shapes, monkeypatch, arch,
                                        shape):
    seen = []
    lookup, constrain = layers.embed_lookup, lm.constrain

    def record(fn, what):
        def wrapped(*args):
            out = fn(*args)
            seen.append((what, out))
            return out
        return wrapped
    monkeypatch.setattr(layers, "embed_lookup", record(lookup, "embed"))
    monkeypatch.setattr(lm, "constrain", record(constrain, "stage"))

    def run(mesh):
        cell = dryrun.build_cell(arch, shape, mesh,
                                 cfg_override=reduced(get_config(arch)))
        batch = cell["args"][-1]
        inputs = batch["embeds"] if "embeds" in batch else batch["tokens"]
        assert inputs.placements[0] == Shard(0)
        cell["fn"](*cell["args"])
    _on_fake_mesh((4, 4), run)
    kinds = {what for what, _ in seen}
    assert "embed" in kinds or arch == "qwen2-vl-72b"
    assert "stage" in kinds or shape == "decode_32k"
    for what, x in seen:
        assert isinstance(x, DTensor), what
        assert x.placements[0] == Shard(0), (what, x.placements)


def _operands(eq, seed):
    """Seeded float32 operands and a cotangent, every label 4 wide."""
    rng = np.random.default_rng(seed)
    ins, out = eq.split("->")
    return [torch.from_numpy(rng.standard_normal([4] * len(t))
                             .astype(np.float32))
            for t in ins.split(",") + [out]]


def _layouts(eq):
    """Operand placements on the (2,2) mesh: both replicated (b plain),
    and each operand sharded on one of its dims over one mesh dim."""
    la, lb = eq.split("->")[0].split(",")
    return [(None, None),
            ((Shard(0), Replicate()), (Replicate(), Shard(len(lb) - 1))),
            ((Replicate(), Shard(len(la) - 1)), (Shard(0), Replicate())),
            ((Shard(0), Shard(len(la) - 1)), (Shard(len(lb) - 1),
                                              Replicate()))]


def _einsum_rank(rank, world, eqs):
    from torch.distributed.tensor import distribute_tensor
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = []
    for i, eq in enumerate(eqs):
        a0, b0, g0 = _operands(eq, i)
        a_ref, b_ref = a0.clone().requires_grad_(), b0.clone() \
            .requires_grad_()
        want = torch.einsum(eq, a_ref, b_ref)
        ga_want, gb_want = torch.autograd.grad(want, [a_ref, b_ref], g0)
        whole = FlopCounterMode(display=False)
        with whole:
            torch.einsum(eq, a0, b0)
        for pa, pb in _layouts(eq):
            a = distribute_tensor(a0, mesh, pa or [Replicate()] * 2)
            a.requires_grad_(True)
            b = b0.clone().requires_grad_(True) if pb is None else \
                distribute_tensor(b0, mesh, pb).requires_grad_(True)
            local = FlopCounterMode(display=False)
            with local:
                got = layers.einsum_f32(eq, a, b)
            ga, gb = torch.autograd.grad(
                got, [a, b], distribute_tensor(g0, mesh, got.placements))
            full = [t.full_tensor() if isinstance(t, DTensor) else t
                    for t in (got, ga, gb)]
            err = max(float((x - y).abs().max()) for x, y in
                      zip(full, (want.detach(), ga_want, gb_want)))
            out.append((eq, str(pa), str(pb), err,
                        local.get_total_flops(), whole.get_total_flops()))
    return out


def test_label_einsum_on_four_gloo_ranks():
    results = run_local_ranks(_einsum_rank, 4, TWO_OPERAND,
                              timeout=RANK_TIMEOUT)
    assert len(results[0]) == 4 * len(TWO_OPERAND)
    for rank in results:
        for eq, pa, pb, err, local, whole in rank:
            assert err < 1e-4, (eq, pa, pb, err)
            assert local * 4 == whole, (eq, pa, pb, local, whole)


def _uneven_prefill_rank(rank, world, tokens):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding.rules import ShardingRules, distribute_tree
    from repro_torch.train import step as step_lib
    cfg = reduced(get_config("qwen3-1.7b"), n_layers=2)
    mesh = make_local_mesh(model=3)
    rules = ShardingRules(cfg, mesh)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    params = distribute_tree(params, mesh, rules.param_shardings(params))
    batch = {"tokens": torch.from_numpy(tokens)}
    batch = {"tokens": distribute_tensor(
        batch["tokens"], mesh, list(rules.batch_spec(batch)["tokens"]))}
    heads, flash = [], layers.flash_attention

    def spy(q, k, v, **kw):
        heads.append((q.shape[2], k.shape[2]))
        return flash(q, k, v, **kw)
    layers.flash_attention = spy
    logits = step_lib.make_prefill_step(cfg)(params, batch)
    return logits.full_tensor().numpy(), heads


def test_prefill_on_uneven_head_shards():
    from repro_torch.train import step as step_lib
    cfg = reduced(get_config("qwen3-1.7b"), n_layers=2)
    assert (cfg.n_heads, cfg.n_kv_heads) == (4, 2)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    got = run_local_ranks(_uneven_prefill_rank, 3, tokens,
                          timeout=RANK_TIMEOUT)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    want = step_lib.make_prefill_step(cfg)(
        params, {"tokens": torch.from_numpy(tokens)}).numpy()
    assert [h for _, h in got] == [[(2, 2)] * 2, [(2, 2)] * 2, []]
    for logits, _ in got:
        np.testing.assert_allclose(logits, want, rtol=1e-5, atol=1e-5)


def _ideal_flops(arch, shape, n_ranks):
    """The unsharded step's FLOPs on meta tensors, divided by the ranks."""
    cfg = get_config(arch)
    spec = shapes.input_specs(cfg, shape)
    from repro_torch.train import step as step_lib
    opt = dryrun.opt_config(cfg)
    state = shapes.abstract(step_lib.init_train_state, cfg, 0, opt,
                            device="cpu")
    flops = FlopCounterMode(display=False)
    with flops:
        step_lib.make_train_step(cfg, opt)(state, spec["batch"])
    return flops.get_total_flops() / n_ranks


def test_full_size_train_cell_against_the_reference(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro.launch.dryrun", "--arch",
            "qwen3-1.7b", "--shape", "train_4k", "--mesh", "single",
            "--out", str(tmp_path / "jax")]
    jax_run = subprocess.Popen(base, env=env, cwd=ROOT,
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
    try:
        rec = dryrun.run_cell("qwen3-1.7b", "train_4k", "single",
                              out_dir=str(tmp_path / "port"))
        assert rec["status"] == "ok", rec.get("error")
        if dist.is_initialized():
            dist.destroy_process_group()
        ideal = _ideal_flops("qwen3-1.7b", "train_4k", 256)
    finally:
        log, _ = jax_run.communicate(timeout=600)
    assert jax_run.returncode == 0, log[-2000:]
    cal = subprocess.run(base + ["--calibrate"], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert cal.returncode == 0, cal.stdout[-2000:] + cal.stderr[-2000:]
    with open(tmp_path / "jax" / "qwen3-1.7b__train_4k__single.json") as f:
        jax_rec = json.load(f)
    jax_flops = jax_rec["calibrated"]["flops"]
    assert rec["flops"] <= jax_flops, (rec["flops"], jax_flops)
    assert rec["flops"] <= 1.5 * ideal, (rec["flops"], ideal)
