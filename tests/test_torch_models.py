"""The port's decoder held against the JAX package's, function by
function, on reduced ``smollm-360m``, reduced ``qwen3-1.7b`` (qk-norm) and,
for configs, stages, init and the whole model, reduced ``mamba2-780m``
(SSD, sinusoidal positions), ``phi3.5-moe-42b-a6.6b`` (MoE),
``jamba-1.5-large-398b`` (attention + SSD + MoE), ``deepseek-v3-671b``
(MLA + MoE + MTP), ``whisper-large-v3`` (enc-dec: encoder frames made from
a seed), ``qwen2-vl-72b`` (M-RoPE, with random (t, h, w) positions where a
test takes positions), ``mistral-nemo-12b`` and ``stablelm-12b``.

Parameters come from the JAX package's own initialiser and cross as raw
bytes (``interop.to_torch``); inputs are made from numpy seeds.  float32
tolerance: atol 1e-5 / rtol 1e-4 (logits atol 1e-4) — the two frameworks
sum products in different orders.  One bf16 forward: atol 3e-2, since
bf16 rounds each cast to 8 bits of mantissa.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import get_config as jget  # noqa: E402
from repro.models.testing import reduced as jreduced  # noqa: E402

from repro_torch.core.serialize import dtype_name  # noqa: E402
from repro_torch.interop import to_torch  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.config import (MoEConfig,  # noqa: E402
                                       SSMConfig)
from repro_torch.models.config import get_config as tget  # noqa: E402
from repro_torch.models.testing import reduced as treduced  # noqa: E402

ARCHS = ["smollm-360m", "qwen3-1.7b"]
NEW_ARCHS = ["mamba2-780m", "phi3.5-moe-42b-a6.6b", "jamba-1.5-large-398b"]
# MLA + MTP, enc-dec, M-RoPE with the vision frontend, two dense configs
ZOO_ARCHS = ["deepseek-v3-671b", "whisper-large-v3", "qwen2-vl-72b",
             "mistral-nemo-12b", "stablelm-12b"]
ALL_ARCHS = ARCHS + NEW_ARCHS + ZOO_ARCHS
TOL = dict(atol=1e-5, rtol=1e-4)


def _cfgs(arch, **kw):
    return jreduced(jget(arch)).replace(**kw), \
        treduced(tget(arch)).replace(**kw)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, name))
        else:
            out[name] = v
    return out


def _jax_params(jcfg, seed=0):
    p = jlm.init_params(jcfg, jax.random.key(seed))
    return p, to_torch(jax.tree.map(np.asarray, p), "cpu")


def _x(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _tokens(cfg, b=2, s=12, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _batches(cfg, toks, seed=0, s_enc=10):
    """The JAX and the port's batch of ``toks``; an enc-dec model's gets
    ``enc_embeds`` [B, s_enc, d] made from ``seed``."""
    jb, tb = {"tokens": jnp.asarray(toks)}, \
        {"tokens": torch.from_numpy(toks.copy())}
    if cfg.enc_dec:
        e = _x((toks.shape[0], s_enc, cfg.d_model), 100 + seed)
        jb["enc_embeds"], tb["enc_embeds"] = jnp.asarray(e), \
            torch.from_numpy(e)
    return jb, tb


def _positions(cfg, b, s, seed=0):
    """[B,S] positions, or random (t, h, w) ids [B,S,3] for M-RoPE."""
    if cfg.rope_type == "mrope":
        return np.random.default_rng(seed).integers(
            0, 24, (b, s, 3)).astype(np.int32)
    return np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()


# ---------------------------------------------------------------------------
# configs and layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_configs_are_the_jax_packages(arch):
    """Every field the JAX package has is equal; each field the port has of
    its own (Granite's multipliers) sits at its neutral default."""
    from repro_torch.models.config import PORT_ONLY_FIELDS
    for jc, tc in ((jget(arch), tget(arch)), _cfgs(arch)):
        jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
        assert set(td) == set(jd) | set(PORT_ONLY_FIELDS)
        assert jd == {k: td[k] for k in jd}
        assert {k: td[k] for k in PORT_ONLY_FIELDS} == PORT_ONLY_FIELDS
        assert tc.attn_scale is None
        assert jc.padded_vocab == tc.padded_vocab
        assert jc.param_counts() == tc.param_counts()


def test_arch_ids_are_the_jax_packages():
    """Every architecture of the JAX package is registered in the port, in
    the JAX package's order; besides them the port registers its own
    (``PORT_ONLY_IDS``), which the JAX package lacks, and nothing else."""
    from repro.configs import ARCH_IDS as JAX_IDS
    from repro.models.config import list_configs as jax_list
    from repro_torch.configs import ARCH_IDS, PORT_ONLY_IDS
    from repro_torch.models.config import list_configs
    assert ARCH_IDS == JAX_IDS
    assert list_configs() == sorted(ARCH_IDS + PORT_ONLY_IDS)
    assert not set(PORT_ONLY_IDS) & set(jax_list())
    assert sorted(ALL_ARCHS) == sorted(ARCH_IDS)


@pytest.mark.parametrize("arch,total", [("deepseek-v3-671b", 15_797_352_448),
                                        ("whisper-large-v3", 2_020_682_240)])
def test_card_cells_parameter_counts(arch, total):
    """The parameters Cells G (deepseek-v3, first 4 of 61 layers, the MTP
    block included) and H (whisper-large-v3, whole) hold, from the JAX
    package's abstract parameters, beside the port's own count of the
    same tree on a tiny copy of its leaves' shapes."""
    cut = {"deepseek-v3-671b": {"n_layers": 4}}.get(arch, {})
    jc, tc = jget(arch).replace(**cut), tget(arch).replace(**cut)
    leaves = jax.tree.leaves(jlm.abstract_params(jc))
    assert sum(int(np.prod(a.shape)) for a in leaves) == total
    shapes = _flat(jax.tree.map(lambda a: a.shape, jlm.abstract_params(jc)))
    small = tc.replace(d_model=8, d_ff=8, vocab_size=8, n_heads=2,
                       n_kv_heads=2, head_dim=4)
    assert sorted(_flat(tlm.init_params(small, torch.Generator()
                                        .manual_seed(0)))) == sorted(shapes)


def test_smollm_full_size_counts():
    cfg = tget("smollm-360m")
    assert cfg.param_counts()["total"] == 361_821_120
    assert cfg.padded_vocab == cfg.vocab_size == 49152
    assert cfg.dtype == "bfloat16" and cfg.tie_embeddings


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_stages_match(arch):
    jc, tc = _cfgs(arch)
    for j, t in ((jget(arch), tget(arch)), (jc, tc)):
        js, ts = jlm.build_stages(j), tlm.build_stages(t)
        assert [(tuple((s.kind, s.ffn, s.cross) for s in st.unit),
                 st.n_units) for st in js] == \
               [(tuple((s.kind, s.ffn, s.cross) for s in st.unit),
                 st.n_units) for st in ts]
        assert tlm._min_period(tlm.layer_specs(t)) == \
            jlm._min_period(jlm.layer_specs(j))


def test_jamba_stage_and_leaf_layout():
    """Jamba's unit is [attn, ssm x 7] with MoE on every second layer: one
    stage of eight sub-layers, the JAX package's leaf names under
    ``stage_0/sub_0..sub_7``."""
    jc, tc = _cfgs("jamba-1.5-large-398b")
    (stage,) = tlm.build_stages(tget("jamba-1.5-large-398b"))
    assert stage.n_units == 9
    assert [(s.kind, s.ffn) for s in stage.unit] == \
        [("attn", "dense"), ("ssm", "moe"), ("ssm", "dense"), ("ssm", "moe"),
         ("ssm", "dense"), ("ssm", "moe"), ("ssm", "dense"), ("ssm", "moe")]
    tp = _flat(tlm.init_params(tc, torch.Generator().manual_seed(0)))
    jp = _flat(jax.tree.map(np.asarray, jlm.init_params(jc,
                                                        jax.random.key(0))))
    assert sorted(tp) == sorted(jp)
    assert "stages/stage_0/sub_0/attn/wq" in tp
    assert "stages/stage_0/sub_7/ssm/in_proj" in tp
    assert "stages/stage_0/sub_7/moe/w_gate" in tp
    assert "stages/stage_0/sub_6/mlp/w_gate" in tp
    assert not any(k.startswith("stages/stage_1") for k in tp)


@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_layout(arch, dtype):
    """Same leaf names, shapes (stacked [n_units] axis) and dtype strings;
    the port's draws match the JAX package's distributions."""
    n_layers = 8 if arch == "jamba-1.5-large-398b" else 3    # whole units
    jc, tc = _cfgs(arch, dtype=dtype, n_layers=n_layers)
    jp = _flat(jax.tree.map(np.asarray, jlm.init_params(jc,
                                                        jax.random.key(0))))
    tp = _flat(tlm.init_params(tc, torch.Generator().manual_seed(0)))
    assert sorted(jp) == sorted(tp)
    for name in jp:
        assert tuple(tp[name].shape) == jp[name].shape, name
        assert dtype_name(tp[name].dtype) == str(jp[name].dtype), name
    first = {"mamba2-780m": "ssm/in_proj",
             "deepseek-v3-671b": "attn/wq_a"}.get(arch, "attn/wq")
    assert tp[f"stages/stage_0/sub_0/{first}"].shape[0] == \
        tlm.build_stages(tc)[0].n_units
    assert torch.equal(tp["final_norm/scale"].float(),
                       torch.ones(tc.d_model))
    w = tp[f"stages/stage_0/sub_0/{first}"].float()
    assert w.abs().max() <= 1 / np.sqrt(tc.d_model)
    assert abs(float(tp["embed"].float().std()) - 0.02) < 2e-3
    again = _flat(tlm.init_params(tc, torch.Generator().manual_seed(0)))
    assert all(torch.equal(tp[n], again[n]) for n in tp)   # seeded


def test_untied_head():
    jc, tc = _cfgs("smollm-360m", tie_embeddings=False)
    jp = _flat(jax.tree.map(np.asarray, jlm.init_params(jc,
                                                        jax.random.key(0))))
    tp = _flat(tlm.init_params(tc, torch.Generator().manual_seed(0)))
    assert tuple(tp["lm_head"].shape) == jp["lm_head"].shape
    x = _x((2, 3, jc.d_model), 1)
    _close(tlm.unembed(tc, tp, torch.from_numpy(x)),
           jlm.unembed(jc, {"lm_head": jnp.asarray(
               tp["lm_head"].numpy())}, jnp.asarray(x)), atol=1e-4)


@pytest.mark.parametrize("kw", [
    {"moe": MoEConfig(n_experts=4, d_ff_expert=32)},
    {"family": "ssm", "ssm": SSMConfig(d_state=8, head_dim=16,
                                       chunk_size=4)},
    {"family": "hybrid", "hybrid_pattern": ("attn", "ssm"),
     "ssm": SSMConfig(d_state=8, head_dim=16, chunk_size=4)},
    {"rope_type": "none"}],
    ids=lambda kw: "-".join(kw))
def test_ported_features_run(kw):
    """MoE, SSM, hybrid stacks and sinusoidal positions no longer raise:
    the port's model runs them and matches the JAX package's logits."""
    jc, tc = _cfgs("smollm-360m", n_layers=2, **kw)
    jp, tp = _jax_params(jc)
    toks = _tokens(jc, s=8, seed=6)
    want = jlm.forward(jc, jp, {"tokens": jnp.asarray(toks)})
    got = tlm.forward(tc, tp, {"tokens": torch.from_numpy(toks)})
    _close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("d", [16, 64, 1536])
def test_sinusoidal_embed(d):
    pos = np.broadcast_to(np.arange(0, 600, 37, dtype=np.int32), (2, 17))
    want = jlm._sinusoidal_embed(jnp.asarray(pos), d)
    got = tlm._sinusoidal_embed(torch.from_numpy(pos.copy()), d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 17, d)
    # the two frameworks' float32 exp may differ by an ulp (2**-23
    # relative) in a frequency; at position 592 the angle then moves by
    # up to 592 * 2**-23 = 7.1e-5, and its sine and cosine by as much
    _close(got, want, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [16, 64])
def test_rmsnorm(d):
    x = _x((2, 5, d), 0)
    scale = _x((d,), 1)
    want = jl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5)
    got = tl.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x),
                     1e-5)
    _close(got, want)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    x = _x((2, 9, 3, 16), 2)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32) + 5, (2, 9))
    assert np.array_equal(tl.rope_frequencies(16, theta),
                          jl.rope_frequencies(16, theta))
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                        theta)
    _close(got, want)


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 3),
                                             (False, 0)])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4), (15, 5)])
def test_attention_core(causal, q_offset, hq, hkv):
    q = _x((2, 6, hq, 16), 3)
    k = _x((2, 9, hkv, 16), 4)
    v = _x((2, 9, hkv, 16), 5)
    want = jl.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, q_offset=q_offset)
    got = tl.attention_core(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal,
                            q_offset=q_offset)
    _close(got, want)
    assert np.array_equal(
        tl._repeat_kv(torch.from_numpy(k), hq // hkv).numpy(),
        np.asarray(jl._repeat_kv(jnp.asarray(k), hq // hkv)))


@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_forward(arch):
    jc, tc = _cfgs(arch)
    jp = jl.gqa_init(jax.random.key(1), jc, jnp.float32)
    tp = to_torch(jax.tree.map(np.asarray, jp), "cpu")
    x = _x((2, 7, jc.d_model), 6)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7)).copy()
    jq, jk, jv = jl._project_qkv(jp, jc, jnp.asarray(x), jnp.asarray(pos))
    tq, tk, tv = tl._project_qkv(tp, tc, torch.from_numpy(x),
                                 torch.from_numpy(pos))
    for g, w in ((tq, jq), (tk, jk), (tv, jv)):
        _close(g, w)
    want = jl.gqa_forward(jp, jc, jnp.asarray(x), jnp.asarray(pos))
    got = tl.gqa_forward(tp, tc, torch.from_numpy(x), torch.from_numpy(pos))
    _close(got, want)
    assert ("q_norm" in tp) == (arch == "qwen3-1.7b")


def test_mlp_forward():
    jp = jl.mlp_init(jax.random.key(2), 64, 128, jnp.float32)
    tp = to_torch(jax.tree.map(np.asarray, jp), "cpu")
    x = _x((2, 7, 64), 7)
    _close(tl.mlp_forward(tp, torch.from_numpy(x)),
           jl.mlp_forward(jp, jnp.asarray(x)))


def test_dense_init_shapes():
    g = torch.Generator().manual_seed(0)
    assert tuple(tl.dense_param(g, 8, (3, 4), torch.float32).shape) \
        == tuple(jl.dense_param(jax.random.key(0), 8, (3, 4),
                                jnp.float32).shape)
    assert tuple(tl.dense_param(g, 8, 5, torch.bfloat16, lead=(2,)).shape) \
        == (2, 8, 5)


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_embed_positions_unembed(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _jax_params(jc)
    toks = _tokens(jc)
    batch_j, batch_t = {"tokens": jnp.asarray(toks)}, \
        {"tokens": torch.from_numpy(toks)}
    _close(tlm.embed_inputs(tc, tp, batch_t),
           jlm.embed_inputs(jc, jp, batch_j), atol=0, rtol=0)
    assert np.array_equal(tlm._positions_of(batch_t, tc, 12, 2).numpy(),
                          np.asarray(jlm._positions_of(batch_j, jc, 12, 2)))
    x = _x((2, 12, jc.d_model), 8)
    got = tlm.unembed(tc, tp, torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got, jlm.unembed(jc, jp, jnp.asarray(x)), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_apply_layer_and_run_stages(arch):
    """Every sub-layer of the first stage's second unit (its only one
    where it has one), then the whole stack: outputs and the MoE aux loss
    (zero without MoE layers)."""
    jc, tc = _cfgs(arch)
    jp, tp = _jax_params(jc)
    x = _x((2, 8, jc.d_model), 9)
    pos = _positions(jc, 2, 8, seed=9)
    # an enc-dec decoder layer cross-attends over 6 encoder frames
    enc = _x((2, 6, jc.d_model), 10) if jc.enc_dec else None
    jenc = None if enc is None else jnp.asarray(enc)
    tenc = None if enc is None else torch.from_numpy(enc)
    stage_j, stage_t = jlm.build_stages(jc)[0], tlm.build_stages(tc)[0]
    u = min(1, stage_t.n_units - 1)     # deepseek's dense prefix: 1 unit
    unit_j = jax.tree.map(lambda a: a[u], jp["stages"]["stage_0"])
    unit_t = tlm._unstack(tp["stages"]["stage_0"], stage_t.n_units)[u]
    for j, (spec_j, spec_t) in enumerate(zip(stage_j.unit, stage_t.unit)):
        want, want_aux = jlm._apply_layer(unit_j[f"sub_{j}"], jc, spec_j,
                                          jnp.asarray(x), jnp.asarray(pos),
                                          jenc)
        got, aux = tlm._apply_layer(unit_t[f"sub_{j}"], tc, spec_t,
                                    torch.from_numpy(x),
                                    torch.from_numpy(pos), enc_out=tenc)
        _close(got, want)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    want, want_aux = jlm._run_stages(jp["stages"], jlm.build_stages(jc), jc,
                                     jnp.asarray(x), jnp.asarray(pos), jenc,
                                     remat=False)
    got, aux = tlm._run_stages(tp["stages"], tlm.build_stages(tc), tc,
                               torch.from_numpy(x), torch.from_numpy(pos),
                               enc_out=tenc)
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    assert (float(aux) > 0) == (tc.moe is not None)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_logits(arch):
    """Logits, the aux loss summed over MoE layers (a zero without them)
    and, where a ``routes`` list is passed, one routing record a MoE layer
    with no dropped assignment (the reduced configs' capacity factor 8)."""
    jc, tc = _cfgs(arch)
    jp, tp = _jax_params(jc)
    toks = _tokens(jc, s=12 if arch in ARCHS else 16, seed=3)
    jb, tb = _batches(jc, toks, seed=3)
    want, want_aux = jlm.forward(jc, jp, jb, return_aux=True)
    routes = []
    got, aux = tlm.forward(tc, tp, tb, return_aux=True, routes=routes)
    assert got.shape == (2, toks.shape[1], jc.padded_vocab)
    assert got.dtype == torch.float32 and aux["moe_aux"].dtype == \
        torch.float32
    assert set(aux) == set(want_aux) == {"moe_aux"}
    _close(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(aux["moe_aux"]),
                               float(want_aux["moe_aux"]), rtol=1e-5)
    assert (float(aux["moe_aux"]) == 0.0) == (tc.moe is None)
    n_moe = sum(s.ffn == "moe" for st in tlm.build_stages(tc)
                for s in st.unit * st.n_units)
    assert len(routes) == n_moe and all(bool(v.all()) for _, v in routes)


def test_forward_counts_dropped_assignments():
    """With a capacity factor of 0.25 MoE layers drop assignments; the
    count per sequence is the JAX package's dispatch count, summed over
    the MoE layers, and the recorded experts are its router's."""
    from repro.models import moe as jmoe
    jc, tc = _cfgs("phi3.5-moe-42b-a6.6b", n_layers=1)
    jc = jc.replace(moe=dataclasses.replace(jc.moe, capacity_factor=0.25))
    tc = tc.replace(moe=dataclasses.replace(tc.moe, capacity_factor=0.25))
    jp, tp = _jax_params(jc)
    toks = _tokens(jc, s=16, seed=4)
    routes = []
    got = tlm.forward(tc, tp, {"tokens": torch.from_numpy(toks)},
                      routes=routes)
    _close(got, jlm.forward(jc, jp, {"tokens": jnp.asarray(toks)}),
           atol=1e-4, rtol=1e-4)
    unit = jax.tree.map(lambda a: a[0], jp["stages"]["stage_0"])["sub_0"]
    x = jlm.embed_inputs(jc, jp, {"tokens": jnp.asarray(toks)})
    pos = jnp.broadcast_to(jnp.arange(16)[None], (2, 16))
    x = x + jl.gqa_forward(unit["attn"], jc,
                           jl.rmsnorm(unit["norm1"], x, jc.norm_eps), pos)
    h = jl.rmsnorm(unit["norm2"], x, jc.norm_eps).reshape(32, -1)
    _, top_e = jmoe.route(unit["moe"]["router"], h, jc.moe)
    _, valid = jmoe.dispatch_indices(top_e, jc.moe.n_experts,
                                     jmoe.capacity(32, jc.moe))
    want = (~np.asarray(valid)).reshape(2, -1).sum(1)
    (experts, kept), = routes
    assert (~kept).sum(dim=(1, 2)).tolist() == want.tolist()
    assert want.sum() > 0
    assert np.array_equal(experts.numpy(),
                          np.asarray(top_e).reshape(2, 16, 2))


def test_decode_step_records_the_routing():
    """``decode_step(routes=...)`` collects each MoE layer's experts for
    the token, the ones ``forward(routes=...)`` records at the same
    position (no drops at the reduced capacity factor, float32)."""
    _, tc = _cfgs("jamba-1.5-large-398b")
    tp = tlm.init_params(tc, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(tc, s=8, seed=5))
    with torch.no_grad():
        pre = []
        tlm.forward(tc, tp, {"tokens": toks}, routes=pre)
        caches = tlm.init_caches(tc, 2, 8, device="cpu")
        for t in range(8):
            routes = []
            tlm.decode_step(tc, tp, caches, {"tokens": toks[:, t:t + 1],
                                             "index": t}, routes=routes)
            assert len(routes) == len(pre) == 8
            for (experts, kept), (pre_e, _) in zip(routes, pre):
                assert bool(kept.all())
                assert torch.equal(experts[:, 0], pre_e[:, t])


def test_forward_logits_bf16():
    """bf16 parameters and activations, float32 logits (atol 3e-2)."""
    jc, tc = _cfgs("smollm-360m", dtype="bfloat16")
    jp, tp = _jax_params(jc, seed=4)
    assert tp["embed"].dtype == torch.bfloat16
    toks = _tokens(jc, seed=5)
    want = jlm.forward(jc, jp, {"tokens": jnp.asarray(toks)})
    got = tlm.forward(tc, tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32
    _close(got, want, atol=3e-2, rtol=0)
