"""The port's sharding rules against the JAX package's, and sharded steps
against single-device ones.

- ``ShardingRules`` placements for every parameter of all ten configs at
  full size, on the (16,16) and (2,16,16) production meshes of a 512-rank
  ``fake`` process group, under each tunable, equal the JAX package's
  ``PartitionSpec``s translated placement-for-axis; so do the batch,
  cache, logits, hidden and replicated layouts.
- Two 2x2 gloo train steps of a reduced qwen3-1.7b with DTensor params
  under the rules (hidden constraint on) equal the single-device port
  step and the single-device JAX step: loss within 1e-3, params within
  2e-2 (the tolerances of ``tests/test_distribution.py``), and, tighter,
  each leaf's first gradient and its change over each step at float32
  tolerances; the sharded prefill equals the single-device one.
- The MoE weight gather on a reduced phi3.5-moe (a 2x2x1 pod mesh,
  expert weights pod-sharded) gives the single-device result, and the
  context issues the weight gathers.
"""
import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro_torch import configs as tconfigs
from repro_torch.configs.shapes import abstract_caches, abstract_params
from repro_torch.core.namespace import flatten_tree
from repro_torch.launch.mesh import (init_fake_group, make_production_mesh,
                                     run_local_ranks)
from repro_torch.models.config import get_config
from repro_torch.models.testing import reduced
from repro_torch.sharding.rules import ShardingRules

RANK_TIMEOUT = 150.0
TUNABLES = [{}, {"fsdp_pods": False}, {"expert_pod_shard": True},
            {"attn_fallback": "replicate"}, {"expert_fsdp_pod": True},
            {"dp_only": True},
            {"seq_shard_activations": True, "moe_dispatch_shard": True}]


@pytest.fixture(scope="module")
def meshes():
    init_fake_group(512)
    try:
        yield {"single": make_production_mesh(device_type="cpu"),
               "multi": make_production_mesh(multi_pod=True,
                                             device_type="cpu")}
    finally:
        dist.destroy_process_group()


def _translate(spec, names):
    """A JAX PartitionSpec as DTensor placements, one per mesh dim."""
    out = []
    for name in names:
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        assert len(dims) <= 1
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _leaves(arch):
    return {k: tuple(v.shape)
            for k, v in flatten_tree(abstract_params(get_config(arch))).items()}


def _jax_rules(arch, kind, opts):
    from jax.sharding import AbstractMesh
    import repro.configs  # noqa: F401
    from repro.models.config import get_config as jget
    from repro.sharding.rules import ShardingRules as JRules
    shape = (16, 16) if kind == "single" else (2, 16, 16)
    names = ("data", "model") if kind == "single" \
        else ("pod", "data", "model")
    return JRules(jget(arch), AbstractMesh(shape, names), **opts)


@pytest.mark.parametrize("opts", TUNABLES,
                         ids=lambda o: ",".join(o) or "default")
@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_param_placements_equal_the_reference(meshes, arch, kind, opts):
    mesh = meshes[kind]
    rules = ShardingRules(get_config(arch), mesh, **opts)
    jr = _jax_rules(arch, kind, opts)
    names = mesh.mesh_dim_names
    leaves = _leaves(arch)
    shardings = flatten_tree(rules.param_shardings(
        {k: torch.empty(s, device="meta") for k, s in leaves.items()}))
    for path, shape in leaves.items():
        want = _translate(jr.param_spec(path, shape), names)
        assert rules.param_spec(path, shape) == want, path
        assert tuple(rules.param_axes(path, shape)) == \
            tuple(jr.param_spec(path, shape)), path
        assert shardings[path] == want, path
    # activations, caches, logits
    b, s = 256, 4096
    batch = {"tokens": torch.empty(b, s, device="meta"),
             "step": torch.empty((), device="meta")}
    jb = jr.batch_spec({"tokens": np.empty((b, s)),
                        "step": np.empty(())})
    got_b = rules.batch_spec(batch)
    for k in batch:
        assert got_b[k] == _translate(jb[k].spec, names), k
    assert rules.logits_spec(b) == _translate(jr.logits_spec(b).spec, names)
    assert rules.hidden_spec(b, s) == \
        _translate(jr.hidden_spec(b, s).spec, names)
    assert rules.replicated() == _translate(jr.replicated().spec, names)


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-780m",
                                  "deepseek-v3-671b", "whisper-large-v3",
                                  "jamba-1.5-large-398b"])
def test_cache_placements_equal_the_reference(meshes, arch):
    import jax
    mesh = meshes["multi"]
    cfg = get_config(arch)
    rules = ShardingRules(cfg, mesh)
    jr = _jax_rules(arch, "multi", {})
    caches = abstract_caches(cfg, 128, 1024)
    got = flatten_tree(rules.cache_spec(caches, 128))
    want = flatten_tree(jax.tree.map(
        lambda x: x, jr.cache_spec(caches, 128),
        is_leaf=lambda x: hasattr(x, "spec")))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == _translate(want[k].spec, mesh.mesh_dim_names), k


# ---------------------------------------------------------------------------
# a sharded train step on 2x2 gloo ranks
# ---------------------------------------------------------------------------

def _qwen():
    return dict(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16)


def _grads_at(loss_fn, params, batch):
    """{leaf: gradient of the total loss} at ``params`` (DTensor gradients
    gathered whole)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.train import step as tstep
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in flatten_tree(params).items()}
    tree = _unflatten(leaves)
    with tstep.spmd(tree):
        total, _ = loss_fn(tree, batch)
        gs = torch.autograd.grad(total, list(leaves.values()))
    return {k: (g.full_tensor() if isinstance(g, DTensor) else g).numpy()
            for k, g in zip(leaves, gs)}


def _unflatten(flat):
    out: dict = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def _sharded_steps(rank, world, state_np, batches, opt):
    """On a 2x2 (data, model) mesh: the first batch's gradients, the prefill
    logits and, after each train step, the loss and the parameters (all
    gathered whole), and whether the moments kept the placements."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.interop import train_state_to_torch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding.rules import shard_train_state
    from repro_torch.train import step as tstep
    cfg = reduced(get_config("qwen3-1.7b"), n_layers=2).replace(**_qwen())
    mesh = make_local_mesh(model=2)
    rules = ShardingRules(cfg, mesh)
    state = shard_train_state(train_state_to_torch(state_np, "cpu"), rules)
    b, s = batches[0]["tokens"].shape
    hidden = (mesh, rules.hidden_spec(b, s))
    fn = tstep.make_train_step(cfg, AdamWConfig(**opt),
                               hidden_sharding=hidden)

    def place(bt):
        bpl = rules.batch_spec(bt)
        return {k: distribute_tensor(torch.from_numpy(v), mesh, list(bpl[k]))
                for k, v in bt.items()}
    grads = _grads_at(tstep.make_loss_fn(cfg, hidden_sharding=hidden),
                      state["params"], place(batches[0]))
    logits = tstep.make_prefill_step(cfg, hidden_sharding=hidden)(
        state["params"], place({"tokens": batches[0]["tokens"]}))
    logits = logits.full_tensor().numpy()
    losses, params = [], []
    for bt in batches:
        state, m = fn(state, place(bt))
        losses.append(float(m["loss"].full_tensor()))
        # copied: a replicated leaf's full_tensor() is the local tensor,
        # which the next step updates in place
        params.append({k: v.full_tensor().numpy().copy() for k, v in
                       flatten_tree(state["params"]).items()})
    flat = flatten_tree(state["params"])
    mu = flatten_tree(state["opt"]["mu"])
    placed = all(isinstance(mu[k], DTensor)
                 and mu[k].placements == flat[k].placements for k in flat)
    return losses, params, grads, logits, placed


def test_sharded_train_step_equals_single_device():
    """Two steps.  Besides the reference tolerances (loss 1e-3, params
    2e-2, which one step at lr 1e-3 cannot fail), every leaf's first
    gradient and its change over each step are held against the
    single-device port step and the JAX step at float32 tolerances, about
    3x the largest readings on the CPU (gradients 5.6e-7 and 9.2e-7 of
    the leaf's largest, changes 6.0e-7 and 7.1e-7 absolute, losses 4.8e-7
    against both: Adam's first step turns float32 summation noise into
    up to lr/eps times as much); a skipped update or a wrong gradient
    moves them by ~1e-3.  The sharded prefill's logits equal the
    single-device prefill's (3.3e-7)."""
    import jax
    import jax.numpy as jnp
    from repro.data.pipeline import DataState as JDataState
    from repro.data.pipeline import TokenPipeline as JPipe
    from repro.models.config import get_config as jget
    from repro.models.testing import reduced as jreduced
    from repro.optim import adamw as jadamw
    from repro.train import step as jstep
    from repro_torch.interop import train_state_to_torch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import step as tstep
    opt = dict(lr=1e-3, eps=1e-6)
    jcfg = jreduced(jget("qwen3-1.7b"), n_layers=2).replace(**_qwen())
    tcfg = reduced(get_config("qwen3-1.7b"), n_layers=2).replace(**_qwen())
    jstate = jstep.init_train_state(jcfg, jax.random.key(0),
                                    jadamw.AdamWConfig(**opt))
    state_np = jax.tree.map(np.asarray, jstate)
    batches = [JPipe(jcfg.vocab_size, 4, 16).batch_at(JDataState(1, i))
               for i in range(2)]
    losses, params, grads, logits, placed = run_local_ranks(
        _sharded_steps, 4, state_np, batches, opt,
        timeout=RANK_TIMEOUT)[0]
    assert placed                           # moments keep the placements

    tstate = train_state_to_torch(state_np, "cpu")
    tgrads = _grads_at(tstep.make_loss_fn(tcfg), tstate["params"],
                       {k: torch.from_numpy(v) for k, v in
                        batches[0].items()})
    jloss = jstep.make_loss_fn(jcfg, remat=False)
    jgrads = flatten_tree(jax.tree.map(np.asarray, jax.grad(
        lambda p: jloss(p, {k: jnp.asarray(v) for k, v in
                            batches[0].items()})[0])(jstate["params"])))
    assert sorted(grads) == sorted(tgrads) == sorted(jgrads)
    for k, g in grads.items():
        scale = float(np.abs(tgrads[k]).max())
        np.testing.assert_allclose(g, tgrads[k], rtol=0,
                                   atol=2e-6 * scale, err_msg=k)
        np.testing.assert_allclose(g, jgrads[k], rtol=0,
                                   atol=3e-6 * scale, err_msg=k)
    with torch.no_grad():
        want = tstep.make_prefill_step(tcfg)(
            tstate["params"], {"tokens": torch.from_numpy(
                batches[0]["tokens"])}).numpy()
    np.testing.assert_allclose(logits, want, rtol=1e-5, atol=1e-5)

    jfn = jstep.make_train_step(jcfg, jadamw.AdamWConfig(**opt),
                                remat=False)
    tfn = tstep.make_train_step(tcfg, AdamWConfig(**opt))
    before = {"s": flatten_tree(state_np["params"]),
              "t": flatten_tree(state_np["params"]),
              "j": flatten_tree(state_np["params"])}
    for i, bt in enumerate(batches):
        jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in bt.items()})
        tstate, tm = tfn(tstate, {k: torch.from_numpy(v)
                                  for k, v in bt.items()})
        assert abs(losses[i] - float(tm["loss"])) < 1e-3, i
        assert abs(losses[i] - float(jm["loss"])) < 1e-3, i
        assert abs(losses[i] - float(tm["loss"])) < 1e-5, i
        assert abs(losses[i] - float(jm["loss"])) < 1e-5, i
        now = {"s": params[i],
               "t": {k: v.numpy().copy() for k, v in
                     flatten_tree(tstate["params"]).items()},
               "j": flatten_tree(jax.tree.map(np.asarray,
                                              jstate["params"]))}
        assert sorted(now["s"]) == sorted(now["j"])
        for k, v in now["s"].items():
            np.testing.assert_allclose(v, now["t"][k], atol=2e-2,
                                       rtol=2e-2, err_msg=k)
            np.testing.assert_allclose(v, now["j"][k], atol=2e-2,
                                       rtol=2e-2, err_msg=k)
            d = {w: now[w][k] - before[w][k] for w in now}
            assert np.abs(d["t"]).max() > 0, (i, k)
            np.testing.assert_allclose(d["s"], d["t"], rtol=0, atol=2e-6,
                                       err_msg=f"step {i + 1} {k}")
            np.testing.assert_allclose(d["s"], d["j"], rtol=0, atol=2e-6,
                                       err_msg=f"step {i + 1} {k}")
        before = now


# ---------------------------------------------------------------------------
# the MoE weight gather
# ---------------------------------------------------------------------------

def _moe_rank(rank, world):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import lm, moe
    from repro_torch.sharding import context as shctx
    mesh = init_device_mesh("cpu", (2, 2, 1),
                            mesh_dim_names=("pod", "data", "model"))
    cfg = reduced(get_config("phi3.5-moe-42b-a6.6b"), n_layers=2)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    p = {k: v[0] for k, v in
         params["stages"]["stage_0"]["sub_0"]["moe"].items()}
    rules = ShardingRules(cfg, mesh, expert_fsdp_pod=True,
                          moe_dispatch_shard=True)
    dp = {k: distribute_tensor(v, mesh, list(rules.param_spec(
        f"stages/stage_0/sub_0/moe/{k}", tuple(v.shape))))
        for k, v in p.items()}
    x = torch.randn(4, 8, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    want = moe.moe_forward(p, cfg, x)
    dx = distribute_tensor(x, mesh, list(rules.batch_spec({"x": x})["x"]))
    comm = CommDebugMode()
    with implicit_replication(), shctx.moe_weight_gather(rules), comm:
        got = moe.moe_forward(dp, cfg, dx)
    assert shctx.get_moe_weight_shardings() is None
    counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    gathers = sum(v for k, v in counts.items() if "all_gather" in k)
    return (float((got.full_tensor() - want).abs().max()),
            str(dp["w_gate"].placements), gathers)


def test_moe_weight_gather_gives_the_single_device_result():
    out = run_local_ranks(_moe_rank, 4, timeout=RANK_TIMEOUT)
    for err, wg, gathers in out:
        assert err <= 1e-5
        # persistent weights: experts over data, d over pod, ff over model
        assert wg == str((Shard(1), Shard(0), Shard(2)))
        assert gathers >= 3                  # w_gate, w_up, w_down at least


def test_moe_without_context_is_the_single_device_path():
    from repro_torch.models import lm, moe
    from repro_torch.sharding import context as shctx
    cfg = reduced(get_config("phi3.5-moe-42b-a6.6b"), n_layers=2)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    p = {k: v[0] for k, v in
         params["stages"]["stage_0"]["sub_0"]["moe"].items()}
    x = torch.randn(2, 8, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    want = moe.moe_forward(p, cfg, x)
    assert shctx.get_moe_weight_shardings() is None

    class Rules:
        expert_fsdp_pod = moe_dispatch_shard = False
    with shctx.moe_weight_gather(Rules()):
        assert shctx.get_moe_weight_shardings() is None
        assert torch.equal(moe.moe_forward(p, cfg, x), want)
