"""The model features that close the port's zoo, module by module, held
against the JAX package on the CPU: MLA attention and its compressed
cache (reduced ``deepseek-v3-671b``), the MTP block's t+2 logits,
cross-attention and the causal encoder (reduced ``whisper-large-v3``),
M-RoPE and decoding from precomputed embeddings (reduced
``qwen2-vl-72b``); then MLA and enc-dec caches committed by both
packages' sessions, and rolled back without loading ``enc_out``.

Parameters come from the JAX package's initialiser and cross as raw bytes
(``interop.to_torch``); inputs are made from numpy seeds.  float32
tolerance: atol 1e-5 / rtol 1e-4 (logits atol 1e-4 / rtol 1e-4), the
other model tests' — the two frameworks sum products in different orders.
"""
import os

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import get_config as jget  # noqa: E402
from repro.models.testing import reduced as jreduced  # noqa: E402

from repro_torch.core.chunkstore import chunk_key  # noqa: E402
from repro_torch.interop import to_numpy, to_torch  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.config import get_config as tget  # noqa: E402
from repro_torch.models.testing import reduced as treduced  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-4)
LOGITS = dict(atol=1e-4, rtol=1e-4)
CB = 1 << 12


def _cfgs(arch, **kw):
    return jreduced(jget(arch)).replace(**kw), \
        treduced(tget(arch)).replace(**kw)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _params(jcfg, seed=0):
    jp = jlm.init_params(jcfg, jax.random.key(seed))
    return jp, to_torch(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, name))
        else:
            out[name] = v
    return out


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd,sections,theta", [
    (16, (4, 2, 2), 1_000_000.0), (128, (16, 24, 24), 1_000_000.0),
    (32, (8, 4, 4), 10_000.0)])
def test_apply_mrope(hd, sections, theta):
    x = _x((2, 7, 3, hd), 1)
    pos = np.random.default_rng(2).integers(0, 300, (2, 7, 3)) \
        .astype(np.int32)
    want = jl.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta, sections)
    got = tl.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), theta,
                         sections)
    _close(got, want)
    ids = tl.mrope_section_ids(sections, torch.device("cpu"))
    assert ids.tolist() == [0] * sections[0] + [1] * sections[1] \
        + [2] * sections[2]
    assert tl.mrope_section_ids(sections, torch.device("cpu")) is ids


def test_mrope_with_equal_ids_is_rope():
    """Text tokens carry t = h = w: M-RoPE is then standard RoPE."""
    x = torch.from_numpy(_x((2, 5, 4, 16), 3))
    pos = torch.arange(5, dtype=torch.int32)[None].expand(2, 5) + 11
    thw = torch.stack([pos, pos, pos], dim=-1)
    assert torch.equal(tl.apply_mrope(x, thw, 1e6, (4, 2, 2)),
                       tl.apply_rope(x, pos, 1e6))
    with pytest.raises(ValueError, match="sections"):
        tl.apply_mrope(x, thw, 1e6, (4, 2, 3))


def test_forward_from_embeds_and_positions_thw():
    """qwen2-vl's prefill from precomputed embeddings with (t, h, w)
    position ids, and its decode from embeddings, as the JAX package's."""
    jc, tc = _cfgs("qwen2-vl-72b")
    jp, tp = _params(jc)
    emb = _x((2, 9, jc.d_model), 4)
    thw = np.random.default_rng(5).integers(0, 16, (2, 9, 3)) \
        .astype(np.int32)
    want = jlm.forward(jc, jp, {"embeds": jnp.asarray(emb),
                                "positions_thw": jnp.asarray(thw)})
    got = tlm.forward(tc, tp, {"embeds": torch.from_numpy(emb),
                               "positions_thw": torch.from_numpy(thw)})
    _close(got, want, **LOGITS)
    # positions_thw changes the answer: M-RoPE really reads it
    plain = tlm.forward(tc, tp, {"embeds": torch.from_numpy(emb)})
    assert float((plain - got).abs().max()) > 1e-3
    jcache = jlm.init_caches(jc, 2, 9)
    tcache = tlm.init_caches(tc, 2, 9, device="cpu")
    for t in range(9):
        e = emb[:, t:t + 1]
        jlg, jcache = jlm.decode_step(jc, jp, jcache, {
            "embeds": jnp.asarray(e), "index": jnp.asarray(t, jnp.int32)})
        with torch.no_grad():
            tlg, _ = tlm.decode_step(tc, tp, tcache, {
                "embeds": torch.from_numpy(e.copy()), "index": t})
        _close(tlg, jlg, **LOGITS)
    for name, w in _flat(jax.tree.map(np.asarray, jcache)).items():
        _close(_flat(tcache)[name], w)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla_setup(seed=1):
    jc, tc = _cfgs("deepseek-v3-671b")
    jp = jl.mla_init(jax.random.key(seed), jc, jnp.float32)
    return jc, tc, jp, to_torch(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("training", [False, True])
def test_mla_forward(training):
    """The projections, then the whole block: the prefill (flash, v
    padded) and the training path (attention_core) both match the JAX
    package's ``mla_forward``."""
    jc, tc, jp, tp = _mla_setup()
    x = _x((2, 7, jc.d_model), 6)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7)).copy()
    want = jl._mla_qkv(jp, jc, jnp.asarray(x), jnp.asarray(pos))
    got = tl._mla_qkv(tp, tc, torch.from_numpy(x), torch.from_numpy(pos))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)
    want = jl.mla_forward(jp, jc, jnp.asarray(x), jnp.asarray(pos))
    got = tl.mla_forward(tp, tc, torch.from_numpy(x), torch.from_numpy(pos),
                         training=training)
    _close(got, want)


def test_mla_prefill_pads_v_to_the_flash_contract(monkeypatch):
    """The prefill hands the flash kernel q, k and v of one shape (head
    dim nope + rope; v zero-padded), so its scale 1/sqrt(hd) is MLA's, and
    keeps the first v_head_dim columns, whose values are attention_core's;
    the padded columns come back zero."""
    jc, tc, jp, tp = _mla_setup()
    m = tc.mla
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    seen = []
    real = tl.flash_attention

    def spy(q, k, v, causal=True, softmax_scale=None):
        out = real(q, k, v, causal=causal, softmax_scale=softmax_scale)
        seen.append((q.shape, k.shape, v.shape, causal, out))
        # no scale of its own: the kernel's 1/sqrt(hd), MLA's
        assert softmax_scale is None
        return out
    monkeypatch.setattr(tl, "flash_attention", spy)
    x = torch.from_numpy(_x((2, 6, tc.d_model), 7))
    pos = torch.arange(6, dtype=torch.int32)[None].expand(2, 6)
    q_nope, q_rope, c_kv, k_rope = tl._mla_qkv(tp, tc, x, pos)
    with torch.no_grad():
        got = tl._mla_attend(tp, tc, q_nope, q_rope, c_kv, k_rope,
                             flash=True)
    want = tl._mla_attend(tp, tc, q_nope, q_rope, c_kv, k_rope)
    ((qs, ks, vs, causal, out),) = seen
    assert qs == ks == vs == (2, 6, tc.n_heads, qk_hd) and causal
    assert m.v_head_dim < qk_hd
    assert torch.equal(out[..., m.v_head_dim:], torch.zeros_like(
        out[..., m.v_head_dim:]))
    assert tuple(got.shape) == (2, 6, tc.n_heads, m.v_head_dim)
    _close(got, want)


def test_mla_decode_writes_in_place_at_index():
    """Six decode steps against the compressed cache: each step writes
    row ``index`` of ``c_kv`` and ``k_rope`` in place (the same storage,
    no other row touched) and moves ``index`` by one; the output and the
    cache match the JAX package's ``mla_decode``."""
    jc, tc, jp, tp = _mla_setup(2)
    xs = _x((2, 6, jc.d_model), 8)
    jcache = jl.mla_cache_init(jc, 2, 9, jnp.float32)
    tcache = tl.mla_cache_init(tc, 2, 9, torch.float32, "cpu")
    assert tuple(tcache["c_kv"].shape) == (2, 9, tc.mla.kv_lora_rank)
    assert tuple(tcache["k_rope"].shape) == (2, 9, 1,
                                             tc.mla.qk_rope_head_dim)
    ptrs = {k: v.data_ptr() for k, v in tcache.items()}
    for t in range(6):
        pos = np.full((2, 1), t, np.int32)
        jy, jcache = jl.mla_decode(jp, jc, jnp.asarray(xs[:, t:t + 1]),
                                   jcache, jnp.asarray(pos))
        before = {k: v.clone() for k, v in tcache.items()}
        ty, out = tl.mla_decode(tp, tc, torch.from_numpy(xs[:, t:t + 1]
                                                         .copy()),
                                tcache, torch.from_numpy(pos))
        assert out is tcache and int(tcache["index"]) == t + 1
        assert {k: v.data_ptr() for k, v in tcache.items()} == ptrs
        for leaf in ("c_kv", "k_rope"):
            changed = (tcache[leaf] != before[leaf]).reshape(2, 9, -1) \
                .any(-1).any(0)
            assert changed.nonzero().flatten().tolist() == [t], leaf
        _close(ty, jy)
    for leaf in ("c_kv", "k_rope"):
        _close(tcache[leaf], jcache[leaf])
    assert int(jcache["index"]) == int(tcache["index"]) == 6


# ---------------------------------------------------------------------------
# cross-attention and the encoder
# ---------------------------------------------------------------------------

def test_cross_attn_forward():
    """Non-causal, query and key lengths differ, no qk-norm."""
    jc, tc = _cfgs("whisper-large-v3", qk_norm=True)
    jp = jl.cross_attn_init(jax.random.key(3), jc, jnp.float32)
    tp = to_torch(jax.tree.map(np.asarray, jp), "cpu")
    assert "q_norm" not in tp
    x, enc = _x((2, 5, jc.d_model), 9), _x((2, 11, jc.d_model), 10)
    want = jl.cross_attn_forward(jp, jc, jnp.asarray(x), jnp.asarray(enc))
    got = tl.cross_attn_forward(tp, tc, torch.from_numpy(x),
                                torch.from_numpy(enc))
    _close(got, want)
    # every query sees every frame: the last frame moves the first query
    enc2 = enc.copy()
    enc2[:, -1] += 1.0
    moved = tl.cross_attn_forward(tp, tc, torch.from_numpy(x),
                                  torch.from_numpy(enc2))
    assert float((moved[:, 0] - got[:, 0]).abs().max()) > 1e-4


@pytest.mark.parametrize("training", [False, True])
def test_encode_matches_the_reference_and_is_causal(training):
    """``encode`` is the JAX package's: sinusoidal positions, the encoder
    stack, the final norm — causal, as the reference's encoder is (a
    shared fault, kept for equal logits and stored bytes): changing the
    last frame leaves every earlier output as it was."""
    jc, tc = _cfgs("whisper-large-v3")
    jp, tp = _params(jc, seed=4)
    enc = _x((2, 10, jc.d_model), 11)
    want = jlm.encode(jc, jp, {"enc_embeds": jnp.asarray(enc)}, remat=False)
    got = tlm.encode(tc, tp, {"enc_embeds": torch.from_numpy(enc)},
                     training=training)
    assert tuple(got.shape) == (2, 10, tc.d_model)
    _close(got, want)
    enc2 = enc.copy()
    enc2[:, -1] += 1.0
    got2 = tlm.encode(tc, tp, {"enc_embeds": torch.from_numpy(enc2)},
                      training=training)
    assert torch.equal(got2[:, :-1], got[:, :-1])
    assert not torch.equal(got2[:, -1], got[:, -1])


def test_encoder_params_and_enc_out_cache_layout():
    jc, tc = _cfgs("whisper-large-v3", n_layers=3)
    jp = _flat(jax.tree.map(np.asarray, jlm.init_params(jc,
                                                        jax.random.key(0))))
    tp = _flat(tlm.init_params(tc, torch.Generator().manual_seed(0)))
    assert sorted(tp) == sorted(jp)
    assert tuple(tp["encoder/stages/stage_0/sub_0/attn/wq"].shape)[0] == 2
    assert "stages/stage_0/sub_0/cross/wk" in tp
    assert "stages/stage_0/sub_0/cross_norm/scale" in tp
    jcache = jlm.init_caches(jc, 2, 7, enc_seq=13)
    tcache = tlm.init_caches(tc, 2, 7, device="cpu", enc_seq=13)
    assert tuple(tcache["enc_out"].shape) == jcache["enc_out"].shape \
        == (2, 13, tc.d_model)
    assert tuple(tlm.init_caches(tc, 2, 7, device="cpu")["enc_out"].shape) \
        == (2, 7, tc.d_model)


# ---------------------------------------------------------------------------
# MTP
# ---------------------------------------------------------------------------

def test_mtp_logits():
    """The t+2 logits from the final-normed hidden state and the next
    token's embedding (the last token repeated), through the MTP block;
    the block and its leaves are the JAX package's."""
    jc, tc = _cfgs("deepseek-v3-671b")
    jp, tp = _params(jc, seed=5)
    assert sorted(_flat(tp["mtp"])) == sorted(
        _flat(jax.tree.map(np.asarray, jp["mtp"])))
    assert tuple(tp["mtp"]["proj"].shape) == (2 * tc.d_model, tc.d_model)
    assert tuple(tp["mtp"]["block"]["attn"]["wq_a"].shape) == \
        (tc.d_model, tc.mla.q_lora_rank)            # one layer, unstacked
    toks = _tokens(jc, 2, 10, seed=6)
    h = _x((2, 10, jc.d_model), 12)
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10)).copy()
    want = jlm._mtp_logits(jc, jp, jnp.asarray(h),
                           {"tokens": jnp.asarray(toks)}, jnp.asarray(pos))
    got = tlm._mtp_logits(tc, tp, torch.from_numpy(h),
                          {"tokens": torch.from_numpy(toks)},
                          torch.from_numpy(pos))
    _close(got, want, **LOGITS)
    want_l, want_aux = jlm.forward(jc, jp, {"tokens": jnp.asarray(toks)},
                                   training=True, remat=False,
                                   return_aux=True)
    got_l, aux = tlm.forward(tc, tp, {"tokens": torch.from_numpy(toks)},
                             training=True, return_aux=True)
    assert set(aux) == set(want_aux) == {"moe_aux", "mtp_logits"}
    _close(aux["mtp_logits"], want_aux["mtp_logits"], **LOGITS)
    _, aux = tlm.forward(tc, tp, {"tokens": torch.from_numpy(toks)},
                         return_aux=True)
    assert set(aux) == {"moe_aux"}                  # serving: no MTP


# ---------------------------------------------------------------------------
# MLA and enc-dec caches under Kishu, across the packages
# ---------------------------------------------------------------------------

PREFIX = 8


def _store_files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _jax_decoded(jc, jp, toks, cache_len, enc):
    jcache = jlm.init_caches(jc, toks.shape[0], cache_len,
                             enc_seq=enc.shape[1] if jc.enc_dec else 0)
    if jc.enc_dec:
        jcache["enc_out"] = jlm.encode(jc, jp, {"enc_embeds":
                                                jnp.asarray(enc)},
                                       remat=False)
    for t in range(toks.shape[1]):
        _, jcache = jlm.decode_step(jc, jp, jcache, {
            "tokens": jnp.asarray(toks[:, t:t + 1]),
            "index": jnp.asarray(t, jnp.int32)})
    return jcache


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "whisper-large-v3"])
def test_caches_commit_and_check_out_across_packages(tmp_path, arch):
    """MLA's ``c_kv`` / ``k_rope`` and an enc-dec model's KV and
    ``enc_out``, decoded by the JAX package: committed by each package's
    session they write the same chunk files and commit id; the port checks
    the JAX-written commit out byte for byte and decodes on from it
    within float32 tolerance of the JAX package."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, seed=2)
    toks = _tokens(jc, 3, PREFIX + 2, seed=3)
    enc = _x((3, 7, jc.d_model), 13)
    jcache = _jax_decoded(jc, jp, toks[:, :PREFIX], PREFIX + 2, enc)
    host = jax.tree.map(np.asarray, jcache)
    assert ("enc_out" in host) == jc.enc_dec
    js = jcore.KishuSession(jcore.open_store(f"dir://{tmp_path}/j"),
                            chunk_bytes=CB)
    jcid = js.init_state({"caches": jax.tree.map(jnp.asarray, host)})
    jfiles = _store_files(tmp_path / "j")
    ts = tcore.KishuSession(tcore.open_store(f"dir://{tmp_path}/t"),
                            chunk_bytes=CB, device="cpu")
    assert ts.init_state({"caches": to_torch(host, "cpu")}) == jcid
    ts.close()
    tfiles = _store_files(tmp_path / "t")
    chunks = sorted(n for n in jfiles if n.startswith("chunks"))
    assert chunks and chunks == sorted(n for n in tfiles
                                       if n.startswith("chunks"))
    assert all(jfiles[n] == tfiles[n] for n in chunks)

    def drop(ns):           # the JAX session moves on without the caches
        for name in [n for n in ns.names() if n.startswith("caches/")]:
            del ns[name]
    js.register("drop", drop)
    js.run("drop")
    js.close()

    ts = tcore.KishuSession(tcore.open_store(f"dir://{tmp_path}/j"),
                            chunk_bytes=CB, device="cpu")
    st = ts.checkout(jcid)
    assert st.covs_loaded == len(_flat(host))
    tcache = ts.ns.get_tree("caches")
    got = _flat(to_numpy(tcache))
    for name, w in _flat(host).items():
        assert got[name].tobytes() == w.tobytes(), name
    for t in (PREFIX, PREFIX + 1):
        jlg, jcache = jlm.decode_step(jc, jp, jcache, {
            "tokens": jnp.asarray(toks[:, t:t + 1]),
            "index": jnp.asarray(t, jnp.int32)})
        with torch.no_grad():
            tlg, _ = tlm.decode_step(tc, tp, tcache, {
                "tokens": torch.from_numpy(toks[:, t:t + 1].copy()),
                "index": t})
        _close(tlg, jlg, **LOGITS)
    ts.close()


def test_enc_dec_rollback_loads_no_enc_out(tmp_path):
    """Whisper serving under Kishu: decode never writes ``enc_out``, so a
    rollback to the prefix restores the KV caches only — the session keeps
    its ``enc_out`` tensor, and the store serves none of its chunks."""
    _, tc = _cfgs("whisper-large-v3")
    tp = tlm.init_params(tc, torch.Generator().manual_seed(0))
    store = tcore.open_store(f"dir://{tmp_path}/cas")
    gets = []
    for name in ("get_chunk", "get_chunks"):
        real = getattr(store, name)

        def spy(keys, *a, _real=real, **kw):
            gets.extend([keys] if isinstance(keys, str) else list(keys))
            return _real(keys, *a, **kw)
        setattr(store, name, spy)
    sess = tcore.KishuSession(store, chunk_bytes=CB, device="cpu",
                              cache_bytes=0)
    toks = torch.from_numpy(_tokens(tc, 2, PREFIX, seed=4))
    enc = torch.from_numpy(_x((2, 9, tc.d_model), 14))

    def prefill(ns):
        caches = tlm.init_caches(tc, 2, PREFIX + 4, device="cpu", enc_seq=9)
        with torch.no_grad():
            caches["enc_out"] = tlm.encode(tc, tp, {"enc_embeds": enc})
            for t in range(PREFIX):
                tlm.decode_step(tc, tp, caches, {"tokens": toks[:, t:t + 1],
                                                 "index": t})
        ns.set_tree("caches", caches)

    def generate(ns, n):
        caches = ns.get_tree("caches")
        tok = toks[:, -1:]
        with torch.no_grad():
            for t in range(n):
                lg, _ = tlm.decode_step(tc, tp, caches,
                                        {"tokens": tok, "index": PREFIX + t})
                tok = lg[..., :tc.vocab_size].argmax(-1).to(torch.int32)
    sess.register("prefill", prefill)
    sess.register("generate", generate)
    sess.init_state({})
    prefix = sess.run("prefill")
    enc_out = sess.ns["caches/enc_out"]
    want = {n: to_numpy(sess.ns[n]).tobytes() for n in sess.ns.names()
            if n.startswith("caches/")}
    raw = to_numpy(enc_out).tobytes()
    enc_keys = {chunk_key(raw[i:i + CB]) for i in range(0, len(raw), CB)}
    for _ in range(2):
        sess.run("generate", n=3)
        assert to_numpy(sess.ns["caches/enc_out"]).tobytes() == raw
        gets.clear()
        st = sess.checkout(prefix)
        assert gets and not enc_keys & set(gets)
        assert sess.ns["caches/enc_out"] is enc_out
        assert st.covs_loaded > 0 and st.covs_identical > 0
        assert {n: to_numpy(sess.ns[n]).tobytes() for n in want} == want
    sess.close()
