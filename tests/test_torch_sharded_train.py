"""Sharded training where the JAX package trains: the MoE families and the
vision frontend's embeddings on DTensors.

On gloo ranks of a (1, 2) and a (2, 2) ("data", "model") mesh, two train
steps of float32 reduced configs with DTensor params and moments under
``ShardingRules`` (the hidden constraint on, inside the MoE weight-gather
context, as the dry run builds its cells): phi3.5-moe (MoE), deepseek-v3
(MLA + MoE + MTP), jamba (hybrid MoE, one unit of its pattern) and
qwen2-vl trained from ``embeds`` and ``positions_thw`` (``embed`` unused,
so given a zero gradient on its own placements).  Each step's loss and
parameters are held against the single-device port and the JAX package
at ``test_torch_sharding_rules.py``'s tolerances: loss within 1e-3 (and,
tighter, 1e-5), parameters within 2e-2, and, tighter, each leaf's change
over each step within 2e-5 of both (2% of lr: a skipped update or a wrong
gradient moves a change by ~lr).  2e-5 is the parameter tolerance of
``test_torch_train.py``'s family tests: Adam's first step moves a
parameter whose gradient sits at the float32 summation noise by
lr * d / eps, and on the 8-layer hybrid d reaches 1e-8 (2.3e-6 readings
here, sharded against single-device as well as against JAX).  The
moments keep the parameters' placements.

The JAX references and the single-device port run in this process, while
each mesh's ranks (one spawn a mesh, every arch in it) run beside it.
"""
import concurrent.futures
import functools
import types

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro_torch.core.namespace import flatten_tree  # noqa: E402
from repro_torch.launch.mesh import run_local_ranks  # noqa: E402
from repro_torch.models.config import get_config as tget  # noqa: E402
from repro_torch.models.testing import reduced as treduced  # noqa: E402

ARCHS = ["phi3.5-moe-42b-a6.6b", "deepseek-v3-671b", "jamba-1.5-large-398b",
         "qwen2-vl-72b"]
MESHES = {"1x2": (2, 2), "2x2": (4, 2)}          # world, model
OPT = dict(lr=1e-3, eps=1e-6)
B, S, STEPS = 4, 16, 2
RANK_TIMEOUT = 240.0


@functools.lru_cache(maxsize=None)
def J():
    """The JAX package's modules, imported in the test's process only:
    the ranks import this file and need none of them."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.models.config import get_config
    from repro.models.testing import reduced
    from repro.optim import adamw
    from repro.train import step
    return types.SimpleNamespace(jax=jax, jnp=jnp, get=get_config,
                                 reduced=reduced, adamw=adamw, step=step)


def _layers(arch):
    # Jamba: one unit of its hybrid pattern (an attention layer among
    # seven SSM layers, MoE every other layer)
    return 8 if arch.startswith("jamba") else 2


def _tcfg(arch):
    return treduced(tget(arch), n_layers=_layers(arch))


def _batches(cfg):
    """Two seeded batches [B, S]: tokens (the port's pipeline, byte for
    byte the JAX package's), or the vision frontend's ``embeds`` and
    ``positions_thw`` with token labels."""
    from repro_torch.data.pipeline import DataState, TokenPipeline
    out = []
    for i in range(STEPS):
        if cfg.frontend != "vision":
            out.append(TokenPipeline(cfg.vocab_size, B, S).batch_at(
                DataState(1, i)))
            continue
        rng = np.random.default_rng(30 + i)
        t = np.arange(S, dtype=np.int32)
        thw = np.stack([t // 8, (t // 4) % 2, t % 4], -1)
        out.append({
            "embeds": rng.standard_normal((B, S, cfg.d_model))
            .astype(np.float32),
            "positions_thw": np.ascontiguousarray(
                np.broadcast_to(thw, (B, S, 3)).astype(np.int32)),
            "labels": rng.integers(0, cfg.vocab_size, (B, S),
                                   dtype=np.int32)})
    return out


def _cases():
    """Per arch: a seeded initial train state (the port's init, as numpy:
    the JAX package takes the same leaves) and its batches."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import step as tstep
    out = {}
    for arch in ARCHS:
        state = tstep.init_train_state(_tcfg(arch), 0, AdamWConfig(**OPT),
                                       "cpu")
        out[arch] = (_numpy_tree(state), _batches(_tcfg(arch)))
    return out


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.numpy()


def _copy_params(state):
    """The parameters gathered whole, as numpy copies (a replicated
    DTensor's ``full_tensor()`` is the local tensor, which the next step
    updates in place)."""
    from torch.distributed.tensor import DTensor
    return {k: (v.full_tensor() if isinstance(v, DTensor) else v)
            .detach().numpy().copy()
            for k, v in flatten_tree(state["params"]).items()}


def _sharded_train(rank, world, model, cases):
    """Every arch's two sharded steps on this rank's mesh: per step the
    loss and the parameters gathered whole, and whether the moments kept
    the parameters' placements."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.interop import train_state_to_torch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import context as shctx
    from repro_torch.sharding.rules import ShardingRules, shard_train_state
    from repro_torch.train import step as tstep
    torch.set_num_threads(1)            # tiny tensors; ranks share cores
    mesh = make_local_mesh(model=model)
    out = {}
    for arch, (state_np, batches) in cases.items():
        cfg = _tcfg(arch)
        rules = ShardingRules(cfg, mesh)
        state = shard_train_state(train_state_to_torch(state_np, "cpu"),
                                  rules)
        fn = tstep.make_train_step(cfg, AdamWConfig(**OPT),
                                   hidden_sharding=(mesh,
                                                    rules.hidden_spec(B, S)))
        losses, params = [], []
        for bt in batches:
            pl = rules.batch_spec(bt)
            placed = {k: distribute_tensor(torch.from_numpy(v), mesh,
                                           list(pl[k]))
                      for k, v in bt.items()}
            with shctx.moe_weight_gather(rules):
                state, m = fn(state, placed)
            losses.append(float(m["loss"].full_tensor()))
            params.append(_copy_params(state))
        flat = flatten_tree(state["params"])
        mu = flatten_tree(state["opt"]["mu"])
        kept = all(isinstance(mu[k], DTensor)
                   and mu[k].placements == flat[k].placements for k in flat)
        out[arch] = (losses, params, kept)
    return out


def _references(cases):
    """Per arch and step: the loss and parameters of the single-device
    port and of the JAX package's step from the same state and batch."""
    from repro_torch.interop import train_state_to_torch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import step as tstep
    j = J()
    out = {}
    for arch, (state_np, batches) in cases.items():
        jcfg = j.reduced(j.get(arch), n_layers=_layers(arch))
        jstate = j.jax.tree.map(j.jnp.asarray, state_np)
        jfn = j.step.make_train_step(jcfg, j.adamw.AdamWConfig(**OPT),
                                     remat=False)
        tstate = train_state_to_torch(state_np, "cpu")
        tfn = tstep.make_train_step(_tcfg(arch), AdamWConfig(**OPT))
        steps = []
        for bt in batches:
            jstate, jm = jfn(jstate, {k: j.jnp.asarray(v)
                                      for k, v in bt.items()})
            tstate, tm = tfn(tstate, {k: torch.from_numpy(v)
                                      for k, v in bt.items()})
            steps.append({
                "t": (float(tm["loss"]), _copy_params(tstate)),
                "j": (float(jm["loss"]), flatten_tree(j.jax.tree.map(
                    np.asarray, jstate["params"])))})
        out[arch] = steps
    return out


@functools.lru_cache(maxsize=None)
def _runs():
    """(cases, references, {mesh: sharded results}): both meshes' ranks
    run in the background while this process computes the references."""
    cases = _cases()
    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as ex:
        futs = {name: ex.submit(run_local_ranks, _sharded_train, world,
                                model, cases, timeout=RANK_TIMEOUT)
                for name, (world, model) in MESHES.items()}
        refs = _references(cases)
        sharded = {name: f.result()[0] for name, f in futs.items()}
    return cases, refs, sharded


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_train_steps_equal_single_device_and_jax(mesh_name, arch):
    cases, refs, sharded = _runs()
    state_np, steps = cases[arch][0], refs[arch]
    losses, params, kept = sharded[mesh_name][arch]
    assert kept                             # moments keep the placements
    before = {w: flatten_tree(state_np["params"]) for w in ("s", "t", "j")}
    for i, ref in enumerate(steps):
        for w in ("t", "j"):
            assert abs(losses[i] - ref[w][0]) < 1e-3, (i, w)
            assert abs(losses[i] - ref[w][0]) < 1e-5, (i, w)
        now = {"s": params[i], "t": ref["t"][1], "j": ref["j"][1]}
        assert sorted(now["s"]) == sorted(now["t"]) == sorted(now["j"])
        for k, v in now["s"].items():
            d = {w: now[w][k].astype(np.float32)
                 - before[w][k].astype(np.float32) for w in now}
            assert np.abs(d["t"]).max() > 0, (i, k)   # every leaf moves
            for w in ("t", "j"):
                np.testing.assert_allclose(v, now[w][k], atol=2e-2,
                                           rtol=2e-2, err_msg=f"{w} {k}")
                np.testing.assert_allclose(d["s"], d[w], rtol=0, atol=2e-5,
                                           err_msg=f"step {i + 1} {w} {k}")
        before = now
