"""The port's optimizer, loss, train step (gradient accumulation and the
SSM, MoE and hybrid families included) and data pipeline held against the
JAX package's.

States cross from ``repro.train.step.init_train_state`` as raw bytes
(``interop.train_state_to_torch``); gradients, batches and noise are made
from numpy seeds.  float32 throughout (reduced configs), loss and every
parameter within rtol 1e-4 (atol 1e-6 for values near zero): the two
frameworks sum in different orders.  The train steps use AdamW eps 1e-6
(see ``_carried``).
"""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.data.pipeline import DataState as JDataState  # noqa: E402
from repro.data.pipeline import TokenPipeline as JPipe  # noqa: E402
from repro.models.config import get_config as jget  # noqa: E402
from repro.models.testing import reduced as jreduced  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import step as jstep  # noqa: E402

from repro_torch.core.serialize import dtype_name  # noqa: E402
from repro_torch.data.pipeline import DataState, TokenPipeline  # noqa: E402
from repro_torch.interop import (to_torch,  # noqa: E402
                                 train_state_to_torch)
from repro_torch.models.config import get_config as tget  # noqa: E402
from repro_torch.models.testing import reduced as treduced  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, name))
        else:
            out[name] = v
    return out


def _assert_tree_close(got, want, **tol):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for name in w:
        np.testing.assert_allclose(_np(g[name]), _np(w[name]),
                                   err_msg=name, **(tol or TOL))


def _tree(seed, scale=1.0):
    """Leaves of every kind AdamW tells apart: matrices, a stacked norm
    [n_units, d] (decayed) and a final norm [d] (not decayed)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    return {"embed": f(37, 16), "final_norm": {"scale": f(16)},
            "stages": {"stage_0": {"sub_0": {
                "norm1": {"scale": f(3, 16)},
                "attn": {"wq": f(3, 16, 4, 4)}}}}}


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_clip,gscale", [(1.0, 1.0), (1e3, 1e-2),
                                              (0.0, 1.0)])
def test_adamw_matches_jax(moment_dtype, grad_clip, gscale):
    """Three steps with a learning rate that changes between them: clip on
    (norm >> 1), clip off, and no clip at all; fp32 or bf16 moments."""
    cfg = dict(lr=1e-2, weight_decay=0.1, grad_clip=grad_clip,
               moment_dtype=moment_dtype)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)
    params = _tree(0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = to_torch(params, "cpu")
    jopt = jadamw.adamw_init(jp, jcfg)
    topt = tadamw.adamw_init(tp, tcfg)
    assert dtype_name(topt["mu"]["embed"].dtype) == moment_dtype
    for i, lr in enumerate((1e-2, 3e-3, None)):
        grads = _tree(10 + i, gscale)
        jp, jopt, jm = jadamw.adamw_update(
            jax.tree.map(jnp.asarray, grads), jopt, jp, jcfg,
            None if lr is None else jnp.float32(lr))
        tm = tadamw.adamw_update(to_torch(grads, "cpu"), topt, tp, tcfg, lr)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        tol = TOL if moment_dtype == "float32" else dict(rtol=1e-2, atol=1e-4)
        _assert_tree_close(tp, jax.tree.map(np.asarray, jp), **tol)
        _assert_tree_close({"mu": topt["mu"], "nu": topt["nu"]},
                           {"mu": jopt["mu"], "nu": jopt["nu"]}, **tol)
        assert int(topt["count"]) == int(jopt["count"]) == i + 1
        assert topt["count"].dtype == torch.int32


def test_adamw_in_place_and_stacked_norm_decay():
    """Zero gradients: only weight decay moves the parameters — every leaf
    with ndim >= 2, the stacked norm scales included, but not the final
    norm.  The update keeps each tensor's identity."""
    cfg = tadamw.AdamWConfig(lr=0.5, weight_decay=0.1)
    tp = to_torch(_tree(0), "cpu")
    before = {k: v.clone() for k, v in _flat(tp).items()}
    ids = {k: id(v) for k, v in _flat(tp).items()}
    opt = tadamw.adamw_init(tp, cfg)
    zeros = tadamw.tree_map(torch.zeros_like, tp)
    tadamw.adamw_update(zeros, opt, tp, cfg)
    after = _flat(tp)
    assert {k: id(v) for k, v in after.items()} == ids
    for name, t in after.items():
        factor = 1.0 if name == "final_norm/scale" else 1 - 0.5 * 0.1
        np.testing.assert_allclose(_np(t), _np(before[name]) * factor,
                                   rtol=1e-6, err_msg=name)


def test_global_norm():
    g = _tree(3)
    np.testing.assert_allclose(
        float(tadamw.global_norm(to_torch(g, "cpu"))),
        float(jadamw.global_norm(jax.tree.map(jnp.asarray, g))), rtol=1e-6)


# ---------------------------------------------------------------------------
# loss and train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("true_vocab", [503, 512])
def test_cross_entropy(true_vocab):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 512)).astype(np.float32)
    labels = rng.integers(0, true_vocab, (2, 5)).astype(np.int32)
    want = jstep.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                               true_vocab)
    got = tstep.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels), true_vocab)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _carried(arch, n_layers=2, seed=0):
    jcfg = jreduced(jget(arch), n_layers=n_layers)
    tcfg = treduced(tget(arch), n_layers=n_layers)
    # eps 1e-6: with the default 1e-8, Adam's step on a gradient at the
    # float32 summation-noise level (|g| ~ 1e-10, where the two frameworks'
    # sums may even differ in sign) is g / eps ~ 1e-2 and can flip, moving
    # a parameter by 2e-2 x lr; at 1e-6 that is 2e-4 x lr, under atol
    opt = dict(lr=1e-3, eps=1e-6)
    jstate = jstep.init_train_state(jcfg, jax.random.key(seed),
                                    jadamw.AdamWConfig(**opt))
    tstate = train_state_to_torch(jax.tree.map(np.asarray, jstate), "cpu")
    return jcfg, tcfg, jstate, tstate, opt


def test_train_state_carries_bytes_and_layout():
    jcfg, tcfg, jstate, tstate, _ = _carried("smollm-360m")
    jf, tf = _flat(jax.tree.map(np.asarray, jstate)), _flat(tstate)
    assert sorted(jf) == sorted(tf)
    for name, a in jf.items():
        t = tf[name]
        assert dtype_name(t.dtype) == str(a.dtype), name
        assert tuple(t.shape) == a.shape, name
        assert t.reshape(-1).view(torch.uint8).numpy().tobytes() \
            == np.ascontiguousarray(a).tobytes(), name
    assert dtype_name(tstate["rng"].dtype) == "uint32"
    assert tuple(tstate["params"]["stages"]["stage_0"]["sub_0"]["norm1"]
                 ["scale"].shape) == (2, tcfg.d_model)
    with pytest.raises(ValueError, match="TrainState"):
        train_state_to_torch({"params": {}}, "cpu")


def test_init_train_state_layout_matches_jax():
    jcfg, tcfg, jstate, _, opt = _carried("qwen3-1.7b")
    own = tstep.init_train_state(tcfg, 0, tadamw.AdamWConfig(**opt), "cpu")
    jf, tf = _flat(jax.tree.map(np.asarray, jstate)), _flat(own)
    assert sorted(jf) == sorted(tf)
    for name, a in jf.items():
        assert (dtype_name(tf[name].dtype), tuple(tf[name].shape)) \
            == (str(a.dtype), a.shape), name
    assert torch.equal(own["rng"], torch.zeros(2, dtype=torch.uint32))
    assert int(own["step"]) == 0


def _batch(cfg, step, b=2, s=16):
    batch = JPipe(cfg.vocab_size, b, s).batch_at(JDataState(1, step))
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("arch,steps", [("smollm-360m", 1),
                                        ("smollm-360m", 3),
                                        ("qwen3-1.7b", 1),
                                        ("qwen3-1.7b", 3)])
def test_train_steps_match_jax(arch, steps):
    jcfg, tcfg, jstate, tstate, opt = _carried(arch)
    jfn = jstep.make_train_step(jcfg, jadamw.AdamWConfig(**opt),
                                remat=False)
    tfn = tstep.make_train_step(tcfg, tadamw.AdamWConfig(**opt))
    ids = {k: id(v) for k, v in _flat(tstate).items()}
    for i in range(steps):
        lr = 1e-3 / (i + 1)
        jb, tb = _batch(jcfg, i)
        jstate, jm = jfn(jstate, jb, jnp.float32(lr))
        tstate, tm = tfn(tstate, tb, lr)
        for key in ("loss", "total_loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-4, err_msg=key)
        assert int(tm["step"]) == int(jm["step"]) == i + 1
    assert {k: id(v) for k, v in _flat(tstate).items()} == ids  # in place
    _assert_tree_close(tstate["params"],
                       jax.tree.map(np.asarray, jstate["params"]))
    _assert_tree_close(tstate["opt"], jax.tree.map(np.asarray,
                                                   jstate["opt"]))
    assert int(tstate["step"]) == steps
    assert torch.equal(tstate["rng"], torch.zeros(2, dtype=torch.uint32))


@pytest.mark.parametrize("arch", ["mamba2-780m", "phi3.5-moe-42b-a6.6b",
                                  "jamba-1.5-large-398b"])
def test_train_step_matches_jax_ssm_moe(arch):
    """One step of each new family: the loss, the MoE aux loss and every
    parameter and moment (SSD gradients through the chunked form)."""
    n_layers = 8 if arch == "jamba-1.5-large-398b" else 2
    jcfg, tcfg, jstate, tstate, opt = _carried(arch, n_layers=n_layers)
    jfn = jstep.make_train_step(jcfg, jadamw.AdamWConfig(**opt),
                                remat=False)
    tfn = tstep.make_train_step(tcfg, tadamw.AdamWConfig(**opt))
    jb, tb = _batch(jcfg, 0)
    jstate, jm = jfn(jstate, jb, jnp.float32(1e-3))
    tstate, tm = tfn(tstate, tb, 1e-3)
    for key in ("loss", "total_loss", "moe_aux", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-4, atol=1e-7, err_msg=key)
    assert (float(tm["moe_aux"]) > 0) == (tcfg.moe is not None)
    # Adam's first step moves a parameter by lr * g / (|g| + eps); where g
    # is at the float32 summation-noise level, a difference d between the
    # two frameworks' sums moves it by lr * d / eps: d reaches 1e-8 in the
    # 8-layer hybrid, so 1e-5 here (1% of lr), under atol 2e-5
    _assert_tree_close(tstate["params"],
                       jax.tree.map(np.asarray, jstate["params"]),
                       rtol=1e-4, atol=2e-5)
    _assert_tree_close(tstate["opt"], jax.tree.map(np.asarray,
                                                   jstate["opt"]))


@pytest.mark.parametrize("arch,microbatches",
                         [("smollm-360m", 2), ("smollm-360m", 4),
                          ("phi3.5-moe-42b-a6.6b", 2), ("mamba2-780m", 2)])
def test_microbatched_steps_match_jax(arch, microbatches):
    """Gradient accumulation: the batch of 4 split into microbatches, float32
    gradients summed in order and scaled, then one AdamW update — two
    steps against the JAX package's ``make_train_step(microbatches=...)``."""
    jcfg, tcfg, jstate, tstate, opt = _carried(arch)
    jfn = jstep.make_train_step(jcfg, jadamw.AdamWConfig(**opt),
                                remat=False, microbatches=microbatches)
    tfn = tstep.make_train_step(tcfg, tadamw.AdamWConfig(**opt),
                                microbatches=microbatches)
    ids = {k: id(v) for k, v in _flat(tstate).items()}
    for i in range(2):
        jb, tb = _batch(jcfg, i, b=4)
        jstate, jm = jfn(jstate, jb, jnp.float32(1e-3))
        tstate, tm = tfn(tstate, tb, 1e-3)
        for key in ("loss", "total_loss", "moe_aux", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-4, atol=1e-7, err_msg=key)
        assert int(tm["step"]) == int(jm["step"]) == i + 1
    assert {k: id(v) for k, v in _flat(tstate).items()} == ids  # in place
    _assert_tree_close(tstate["params"],
                       jax.tree.map(np.asarray, jstate["params"]))
    _assert_tree_close(tstate["opt"], jax.tree.map(np.asarray,
                                                   jstate["opt"]))


@pytest.mark.parametrize("arch,microbatches",
                         [("deepseek-v3-671b", 1), ("deepseek-v3-671b", 2),
                          ("whisper-large-v3", 1), ("whisper-large-v3", 2),
                          ("qwen2-vl-72b", 1), ("mistral-nemo-12b", 1),
                          ("stablelm-12b", 1)])
def test_train_step_matches_jax_zoo(arch, microbatches):
    """Two steps of the remaining architectures against the JAX package's
    ``make_train_step``: deepseek's loss carries the MTP block's t+2
    cross-entropy (``mtp_coef`` 0.1) and the MoE aux loss, whisper's batch
    its encoder frames (split with the tokens into microbatches)."""
    _two_steps_against_jax(arch, microbatches, _batch)


def _vlm_batch(cfg, step, b=4, s=16):
    """A vision frontend's training batch, as the JAX package's
    ``input_specs`` shapes it: precomputed ``embeds`` [B,S,d] and M-RoPE
    ``positions_thw`` [B,S,3] (a 4-wide grid: time, row, column), with
    token labels; made from a numpy seed."""
    rng = np.random.default_rng(30 + step)
    t = np.arange(s, dtype=np.int32)
    thw = np.broadcast_to(np.stack([t // 8, (t // 4) % 2, t % 4], -1),
                          (b, s, 3)).astype(np.int32)
    batch = {"embeds": rng.standard_normal(
                 (b, s, cfg.d_model)).astype(np.float32),
             "positions_thw": np.ascontiguousarray(thw),
             "labels": rng.integers(0, cfg.vocab_size, (b, s),
                                    dtype=np.int32)}
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_from_embeds_matches_jax(microbatches):
    """qwen2-vl trained from its frontend's embeddings and ``positions_thw``
    (the JAX package's training input for the vision family): two steps at
    the zoo test's tolerances.  ``embed`` takes no part in the loss; its
    gradient is zero in both packages, so AdamW only decays it."""
    _two_steps_against_jax("qwen2-vl-72b", microbatches, _vlm_batch)


def test_zero_gradient_leaves_are_the_reference_zero_set():
    """The leaves the step gives zero gradients (``loss_and_grads``'s
    ``unused``) are, by name, exactly those whose JAX gradient is
    identically zero: ``embed`` for qwen2-vl trained from embeddings, none
    from tokens.  ``embed``'s step is then the decay-only AdamW update."""
    jcfg, tcfg, jstate, tstate, opt = _carried("qwen2-vl-72b")
    jloss = jstep.make_loss_fn(jcfg, remat=False)
    tloss = tstep.make_loss_fn(tcfg)
    for make in (_vlm_batch, _batch):
        jb, tb = make(jcfg, 0, b=4)
        jg = _flat(jax.tree.map(np.asarray, jax.grad(
            lambda p: jloss(p, jb)[0])(jstate["params"])))
        _, _, grads, unused = tstep.loss_and_grads(tloss, tstate["params"],
                                                   tb)
        zero = sorted(k for k, g in jg.items() if not np.any(g))
        assert sorted(unused) == zero, make.__name__
        assert zero == (["embed"] if make is _vlm_batch else [])
        for k in unused:
            assert not torch.any(_flat(grads)[k])
            assert _flat(grads)[k].dtype == _flat(tstate["params"])[k].dtype
    e0 = tstate["params"]["embed"].clone()
    tfn = tstep.make_train_step(tcfg, tadamw.AdamWConfig(**opt))
    tstate, _ = tfn(tstate, _vlm_batch(jcfg, 0)[1], 1e-3)
    # zero moments: the step is lr * 0 / (0 + eps), so only the decay moves
    decayed = (e0.float() * (1 - torch.tensor(1e-3) * 0.1)).to(e0.dtype)
    assert torch.equal(tstate["params"]["embed"], decayed)
    assert not torch.any(tstate["opt"]["mu"]["embed"])


def _two_steps_against_jax(arch, microbatches, make_batch):
    jcfg, tcfg, jstate, tstate, opt = _carried(arch)
    jfn = jstep.make_train_step(jcfg, jadamw.AdamWConfig(**opt),
                                remat=False, microbatches=microbatches)
    tfn = tstep.make_train_step(tcfg, tadamw.AdamWConfig(**opt),
                                microbatches=microbatches)
    ids = {k: id(v) for k, v in _flat(tstate).items()}
    for i in range(2):
        jb, tb = make_batch(jcfg, i, b=4)
        if jcfg.enc_dec:
            e = np.random.default_rng(20 + i).standard_normal(
                (4, 6, jcfg.d_model)).astype(np.float32)
            jb["enc_embeds"], tb["enc_embeds"] = jnp.asarray(e), \
                torch.from_numpy(e)
        jstate, jm = jfn(jstate, jb, jnp.float32(1e-3))
        tstate, tm = tfn(tstate, tb, 1e-3)
        for key in ("loss", "total_loss", "moe_aux", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-4, atol=1e-7, err_msg=key)
    if tcfg.mtp:         # the t+2 term is in the total, not in the loss
        assert float(tm["total_loss"]) > float(tm["loss"]) \
            + 0.01 * float(tm["moe_aux"])
    assert {k: id(v) for k, v in _flat(tstate).items()} == ids  # in place
    # the parameters take the tolerance of the one-step family test: Adam
    # moves a near-zero gradient's parameter by lr * d / eps
    _assert_tree_close(tstate["params"],
                       jax.tree.map(np.asarray, jstate["params"]),
                       rtol=1e-4, atol=2e-5)
    _assert_tree_close(tstate["opt"], jax.tree.map(np.asarray,
                                                   jstate["opt"]))


def test_mtp_loss_is_the_reference_loss():
    """``make_loss_fn``'s total for an MTP model: the token loss, 0.01 x
    the MoE aux loss and ``mtp_coef`` x the t+2 cross-entropy, each as the
    JAX package computes it; ``mtp_coef=0`` leaves the rest."""
    jcfg, tcfg, jstate, tstate, _ = _carried("deepseek-v3-671b")
    jb, tb = _batch(jcfg, 0)
    for coef in (0.1, 0.0, 1.0):
        jtot, jaux = jstep.make_loss_fn(jcfg, remat=False, mtp_coef=coef)(
            jstate["params"], jb)
        ttot, taux = tstep.make_loss_fn(tcfg, mtp_coef=coef)(
            tstate["params"], tb)
        np.testing.assert_allclose(float(ttot), float(jtot), rtol=1e-5)
        np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                                   rtol=1e-5)
        if coef == 0.0:
            np.testing.assert_allclose(
                float(ttot), float(taux["loss"] + 0.01 * taux["moe_aux"]),
                rtol=1e-6)


def test_microbatches_average_to_the_whole_batch():
    """On a dense model the mean of the microbatches' mean losses is the
    whole batch's mean loss, and so are the gradients: one step with 2
    microbatches lands where one step on the whole batch does."""
    _, tcfg, _, whole, opt = _carried("smollm-360m")
    _, _, _, split, _ = _carried("smollm-360m")
    _, tb = _batch(tcfg, 0, b=4)
    _, m1 = tstep.make_train_step(tcfg, tadamw.AdamWConfig(**opt))(
        whole, tb, 1e-3)
    _, m2 = tstep.make_train_step(tcfg, tadamw.AdamWConfig(**opt),
                                  microbatches=2)(split, tb, 1e-3)
    for key in ("loss", "total_loss", "grad_norm"):
        np.testing.assert_allclose(float(m2[key]), float(m1[key]),
                                   rtol=1e-5, err_msg=key)
    _assert_tree_close(split["params"], whole["params"])


@pytest.mark.parametrize("microbatches", [0, 3])
def test_microbatches_must_divide_the_batch(microbatches):
    _, tcfg, _, tstate, opt = _carried("smollm-360m")
    _, tb = _batch(tcfg, 0, b=4)
    with pytest.raises(ValueError, match="microbatch"):
        tstep.make_train_step(tcfg, tadamw.AdamWConfig(**opt),
                              microbatches=microbatches)(tstate, tb)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,batch,seq", [(503, 2, 16), (49152, 8, 128)])
@pytest.mark.parametrize("seed", [0, 100])
def test_token_pipeline_batches_byte_identical(vocab, batch, seq, seed):
    jp, tp = JPipe(vocab, batch, seq), TokenPipeline(vocab, batch, seq)
    js, ts = JDataState(seed, 0), DataState(seed, 0)
    for _ in range(3):
        (jb, js), (tb, ts) = jp.next_batch(js), tp.next_batch(ts)
        assert sorted(jb) == sorted(tb) == ["labels", "tokens"]
        for k in jb:
            assert jb[k].dtype == tb[k].dtype == np.int32
            assert jb[k].tobytes() == tb[k].tobytes()
        assert js.as_tree() == ts.as_tree()
