"""The port's serving path held against the JAX package's, on reduced
``smollm-360m`` and reduced ``qwen3-1.7b`` (qk-norm), on reduced
``mamba2-780m`` (SSM caches), ``phi3.5-moe-42b-a6.6b`` (MoE) and
``jamba-1.5-large-398b`` (KV and SSM caches side by side), and on reduced
``deepseek-v3-671b`` (MLA's compressed caches), ``whisper-large-v3``
(KV caches plus ``enc_out``, from seeded encoder frames), ``qwen2-vl-72b``
(M-RoPE; its serving cells decode from embeddings), ``mistral-nemo-12b``
and ``stablelm-12b``, on the CPU.

Parameters come from the JAX package's initialiser and cross as raw bytes
(``interop.to_torch``); prompts are made with numpy from a seed.  float32
tolerance: logits atol 1e-4 / rtol 1e-4 and cache K/V atol 1e-5 /
rtol 1e-4 (the forward test's; the two frameworks sum products in
different orders); bf16 prefill logits atol 3e-2 (the port's prefill keeps
the probabilities in float32 for P.V, the JAX forward rounds them to
bf16).  Prefill against decode within one package: 2e-3, the JAX test's
bound.  SSM cache leaves: atol 5e-5 / rtol 1e-4 (the SSD tests').  Then
the ``examples/serve_batched.py`` flow under Kishu: prefix commit, rollback
before each generation, and a prefix committed by the JAX package's
session continued by the port's; SSM caches committed by both packages
write the same chunks.
"""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import get_config as jget  # noqa: E402
from repro.models.testing import reduced as jreduced  # noqa: E402
from repro.train import step as jstep  # noqa: E402

from repro_torch.core.serialize import dtype_name  # noqa: E402
from repro_torch.interop import to_numpy, to_torch  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.config import get_config as tget  # noqa: E402
from repro_torch.models.testing import reduced as treduced  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ARCHS = ["smollm-360m", "qwen3-1.7b"]
NEW_ARCHS = ["mamba2-780m", "phi3.5-moe-42b-a6.6b", "jamba-1.5-large-398b"]
# MLA + MTP, enc-dec, M-RoPE with the vision frontend, two dense configs
ZOO_ARCHS = ["deepseek-v3-671b", "whisper-large-v3", "qwen2-vl-72b",
             "mistral-nemo-12b", "stablelm-12b"]
ENC_SEQ = 7                       # encoder frames of the enc-dec tests
LOGITS = dict(atol=1e-4, rtol=1e-4)
KV = dict(atol=1e-5, rtol=1e-4)
CONSISTENCY = 2e-3
CB = 1 << 12


def _cfgs(arch, **kw):
    return jreduced(jget(arch)).replace(**kw), \
        treduced(tget(arch)).replace(**kw)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, name))
        else:
            out[name] = v
    return out


def _params(jcfg, seed=0):
    jp = jlm.init_params(jcfg, jax.random.key(seed))
    return jp, to_torch(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _enc(cfg, b, seed=9):
    """Seeded encoder frames [b, ENC_SEQ, d] of an enc-dec model."""
    return np.random.default_rng(seed).standard_normal(
        (b, ENC_SEQ, cfg.d_model)).astype(np.float32)


def _with_enc(cfg, batch, b, seed=9, jax_side=False):
    """``batch`` plus an enc-dec model's ``enc_embeds``."""
    if cfg.enc_dec:
        e = _enc(cfg, b, seed)
        batch = {**batch, "enc_embeds": jnp.asarray(e) if jax_side
                 else torch.from_numpy(e)}
    return batch


# ---------------------------------------------------------------------------
# caches, prefill and decode against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + NEW_ARCHS + ZOO_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_caches_layout(arch, dtype):
    n_layers = 8 if arch == "jamba-1.5-large-398b" else 3    # whole units
    jc, tc = _cfgs(arch, dtype=dtype, n_layers=n_layers)
    want = _flat(jax.tree.map(np.asarray, jlm.init_caches(jc, 2, 11)))
    got = _flat(tlm.init_caches(tc, 2, 11, device="cpu"))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert dtype_name(got[name].dtype) == str(w.dtype), name
        assert to_numpy(got[name]).tobytes() == w.tobytes(), name
    if arch == "mamba2-780m":
        state = got["stages/stage_0/sub_0/ssm/state"]
        assert state.dtype == torch.float32
        assert tuple(state.shape) == (3, 2, 8, 16, 16)
        assert got["stages/stage_0/sub_0/ssm/conv"].dtype == \
            getattr(torch, dtype)
        return
    if tc.mla is not None:
        c_kv = got["stages/stage_0/sub_0/attn/c_kv"]
        assert tuple(c_kv.shape) == (1, 2, 11, tc.mla.kv_lora_rank)
        assert tuple(got["stages/stage_1/sub_0/attn/k_rope"].shape) == \
            (2, 2, 11, 1, tc.mla.qk_rope_head_dim)
        return
    if tc.enc_dec:
        assert tuple(got["enc_out"].shape) == (2, 11, tc.d_model)
    k = got["stages/stage_0/sub_0/attn/k"]
    n_units = tlm.build_stages(tc)[0].n_units
    assert tuple(k.shape) == (n_units, 2, 11, tc.n_kv_heads,
                              tc.resolved_head_dim)
    assert got["stages/stage_0/sub_0/attn/index"].dtype == torch.int32


def test_init_caches_defaults_to_the_card():
    _, tc = _cfgs("smollm-360m")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init_caches(tc, 1, 4)


@pytest.mark.parametrize("arch", ARCHS + NEW_ARCHS + ZOO_ARCHS)
def test_prefill_logits_match_jax(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc)
    s = 16 if tc.ssm is not None else 13         # SSD: chunks of 8
    toks = _tokens(jc, 2, s, seed=1)
    want = jstep.make_prefill_step(jc)(jp, _with_enc(
        jc, {"tokens": jnp.asarray(toks)}, 2, jax_side=True))
    got = tstep.make_prefill_step(tc)(tp, _with_enc(
        tc, {"tokens": torch.from_numpy(toks)}, 2))
    assert got.shape == (2, s, jc.padded_vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **LOGITS)


def test_prefill_logits_match_jax_bf16():
    jc, tc = _cfgs("smollm-360m", dtype="bfloat16")
    jp, tp = _params(jc, seed=4)
    toks = _tokens(jc, 2, 13, seed=5)
    want = jstep.make_prefill_step(jc)(jp, {"tokens": jnp.asarray(toks)})
    got = tstep.make_prefill_step(tc)(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-2, rtol=0)


def _decode_both(jc, tc, jp, tp, toks, cache_len):
    b, s = toks.shape
    enc_seq = ENC_SEQ if jc.enc_dec else 0
    jcache = jlm.init_caches(jc, b, cache_len, enc_seq=enc_seq)
    tcache = tlm.init_caches(tc, b, cache_len, device="cpu", enc_seq=enc_seq)
    if jc.enc_dec:           # each package encodes the same frames
        jcache["enc_out"] = jlm.encode(jc, jp, _with_enc(jc, {}, b,
                                                         jax_side=True),
                                       remat=False)
        with torch.no_grad():
            tcache["enc_out"] = tlm.encode(tc, tp, _with_enc(tc, {}, b))
    jl, tl = [], []
    for t in range(s):
        lg, jcache = jlm.decode_step(
            jc, jp, jcache, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                             "index": jnp.asarray(t, jnp.int32)})
        jl.append(lg[:, 0])
        with torch.no_grad():
            tg, tcache2 = tlm.decode_step(
                tc, tp, tcache, {"tokens": torch.from_numpy(
                    toks[:, t:t + 1].copy()), "index": t})
        assert tcache2 is tcache                    # updated in place
        tl.append(tg[:, 0])
    return jnp.stack(jl, 1), torch.stack(tl, 1), jcache, tcache


@pytest.mark.parametrize("arch", ARCHS + ZOO_ARCHS)
def test_decode_teacher_forced_matches_jax(arch):
    """Logits and every cache leaf after nine teacher-forced steps: K/V
    (or MLA's ``c_kv`` and ``k_rope``) in the filled slots, the rest zero
    bytes, ``index``, and an enc-dec model's ``enc_out`` (read, never
    written)."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc)
    toks = _tokens(jc, 2, 9, seed=2)
    jl, tl, jcache, tcache = _decode_both(jc, tc, jp, tp, toks, 12)
    np.testing.assert_allclose(_np(tl), _np(jl), **LOGITS)
    want = _flat(jax.tree.map(np.asarray, jcache))
    got = _flat(to_numpy(tcache))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name.endswith("index"):
            assert g.tobytes() == w.tobytes() and set(g.tolist()) == {9}
        elif name == "enc_out":
            np.testing.assert_allclose(g, w, **KV)
            with torch.no_grad():
                assert torch.equal(tcache["enc_out"], tlm.encode(
                    tc, tp, _with_enc(tc, {}, 2)))
        else:
            np.testing.assert_allclose(g[:, :, :9], w[:, :, :9], **KV)
            # the unfilled slots stay zero bytes in both packages
            assert g[:, :, 9:].tobytes() == w[:, :, 9:].tobytes() \
                == bytes(g[:, :, 9:].nbytes)


@pytest.mark.parametrize("arch", ARCHS + NEW_ARCHS + ZOO_ARCHS)
def test_prefill_decode_consistency(arch):
    """The port's prefill (flash attention, chunked SSD) and its decode
    loop (cached attention, the SSM recurrence) give the same logits, as
    the JAX package's do."""
    _, tc = _cfgs(arch)
    tp = tlm.init_params(tc, torch.Generator().manual_seed(0))
    s = 16 if tc.ssm is not None else 8          # SSD: chunks of 8
    toks = torch.from_numpy(_tokens(tc, 2, s, seed=2))
    batch = _with_enc(tc, {"tokens": toks}, 2)
    full = tstep.make_prefill_step(tc)(tp, batch)
    caches = tlm.init_caches(tc, 2, s, device="cpu", enc_seq=ENC_SEQ)
    if tc.enc_dec:
        with torch.no_grad():
            caches["enc_out"] = tlm.encode(tc, tp, batch)
    outs = []
    with torch.no_grad():
        for t in range(s):
            lg, caches = tlm.decode_step(tc, tp, caches,
                                         {"tokens": toks[:, t:t + 1],
                                          "index": t})
            outs.append(lg[:, 0])
    err = float((full - torch.stack(outs, 1)).abs().max())
    assert err < CONSISTENCY, f"{arch}: prefill/decode diverge by {err}"


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_decode_teacher_forced_matches_jax_ssm_moe(arch):
    """Logits and every cache leaf after nine teacher-forced steps: SSM
    ``conv`` and float32 ``state``, and K/V with ``index`` in Jamba's
    attention layers (filled slots; the rest stay zero bytes)."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc)
    toks = _tokens(jc, 2, 9, seed=2)
    jl, tl, jcache, tcache = _decode_both(jc, tc, jp, tp, toks, 12)
    np.testing.assert_allclose(_np(tl), _np(jl), **LOGITS)
    want = _flat(jax.tree.map(np.asarray, jcache))
    got = _flat(to_numpy(tcache))
    assert sorted(got) == sorted(want)
    assert any("/ssm/" in n for n in want) == (tc.ssm is not None)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name.endswith("index"):
            assert g.tobytes() == w.tobytes() and set(g.tolist()) == {9}
        elif "/ssm/" in name:
            np.testing.assert_allclose(g, w, atol=5e-5, rtol=1e-4,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(g[:, :, :9], w[:, :, :9], **KV)
            assert g[:, :, 9:].tobytes() == w[:, :, 9:].tobytes()


def test_decode_step_argmax_and_vocab_mask():
    jc, tc = _cfgs("smollm-360m")
    assert jc.padded_vocab > jc.vocab_size         # padding columns exist
    jp, tp = _params(jc, seed=3)
    toks = _tokens(jc, 3, 1, seed=4)
    jn, _ = jstep.make_decode_step(jc)(
        jp, jlm.init_caches(jc, 3, 4),
        {"tokens": jnp.asarray(toks), "index": jnp.asarray(0, jnp.int32)})
    tn, caches = tstep.make_decode_step(tc)(
        tp, tlm.init_caches(tc, 3, 4, device="cpu"),
        {"tokens": torch.from_numpy(toks), "index": 0})
    assert tn.dtype == torch.int32 and tuple(tn.shape) == (3, 1)
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    assert int(tn.max()) < jc.vocab_size
    assert caches["stages"]["stage_0"]["sub_0"]["attn"]["index"].tolist() \
        == [1] * jc.n_layers


def test_jax_cache_tree_crosses_byte_for_byte():
    """``to_torch`` carries a JAX cache tree (after decode steps, with its
    int32 ``index`` leaves) to the port's layout bit for bit, and the port
    decodes on from it as the JAX package does."""
    jc, tc = _cfgs("qwen3-1.7b", n_layers=2)
    jp, tp = _params(jc, seed=5)
    toks = _tokens(jc, 2, 7, seed=6)
    jcache = jlm.init_caches(jc, 2, 8)
    for t in range(5):
        _, jcache = jlm.decode_step(jc, jp, jcache,
                                    {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                     "index": jnp.asarray(t, jnp.int32)})
    host = jax.tree.map(np.asarray, jcache)
    tcache = to_torch(host, "cpu")
    back = _flat(to_numpy(tcache))
    for name, w in _flat(host).items():
        assert back[name].dtype == w.dtype and back[name].tobytes() \
            == w.tobytes(), name
    for t in (5, 6):
        jl, jcache = jlm.decode_step(jc, jp, jcache,
                                     {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                      "index": jnp.asarray(t, jnp.int32)})
        with torch.no_grad():
            tl, tcache = tlm.decode_step(
                tc, tp, tcache, {"tokens": torch.from_numpy(
                    toks[:, t:t + 1].copy()), "index": t})
        np.testing.assert_allclose(_np(tl), _np(jl), **LOGITS)


def test_serve_launcher_on_the_cpu(capsys):
    """The default architecture is the JAX launcher's, mamba2-780m."""
    tserve.main(["--reduced", "--device", "cpu", "--batch", "2",
                 "--prompt-len", "6", "--gen", "4"])
    out = capsys.readouterr().out
    assert "arch=mamba2-780m batch=2 generated 4 tokens/seq in" in out
    assert "tok/s incl prefill" in out and "sample:" in out


@pytest.mark.parametrize("arch", ARCHS + NEW_ARCHS + ZOO_ARCHS)
def test_serve_launcher_runs_each_arch(arch, capsys):
    """A prefill-then-decode-loop serve run of each registered arch."""
    tserve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch",
                 "2", "--prompt-len", "5", "--gen", "3"])
    out = capsys.readouterr().out
    assert f"arch={arch} batch=2 generated 3 tokens/seq in" in out
    sample = out.split("sample:")[1]
    assert len(sample.strip(" []\n").split()) == 3


def test_serve_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--reduced"])


# ---------------------------------------------------------------------------
# serving under Kishu: the examples/serve_batched.py flow
# ---------------------------------------------------------------------------

B, PREFIX, GEN = 3, 10, 6


def _torch_inputs(tc, tp, tok, index):
    """The decode batch: the token, or for the vision frontend's model its
    embedding (the JAX launcher's)."""
    if tc.frontend == "vision":
        return {"embeds": tp["embed"][tok[:, 0].long()][:, None, :],
                "index": index}
    return {"tokens": tok, "index": index}


def _torch_cells(tc, tp):
    decode = tstep.make_decode_step(tc)

    def prefill(ns, seed):
        caches = tlm.init_caches(tc, B, PREFIX + GEN, device="cpu",
                                 enc_seq=ENC_SEQ)
        if tc.enc_dec:
            with torch.no_grad():
                caches["enc_out"] = tlm.encode(tc, tp,
                                               _with_enc(tc, {}, B, seed))
        toks = torch.from_numpy(_tokens(tc, B, PREFIX, seed))
        tok = toks[:, :1]
        for t in range(PREFIX):
            tok, caches = decode(tp, caches, _torch_inputs(tc, tp, tok, t))
            if t + 1 < PREFIX:
                tok = toks[:, t + 1:t + 2]
        ns.set_tree("caches", caches)
        ns["last_tok"] = tok
        ns["pos"] = PREFIX

    def generate(ns, n, flavor):
        caches = ns.get_tree("caches")
        tok = torch.as_tensor(np.asarray(ns["last_tok"]))
        pos = ns["pos"]
        outs, logits = [], []
        with torch.no_grad():
            for t in range(n):
                lg, caches = tlm.decode_step(tc, tp, caches, _torch_inputs(
                    tc, tp, (tok + flavor) % tc.vocab_size, pos + t))
                tok = lg[..., :tc.vocab_size].argmax(-1).to(torch.int32)
                outs.append(tok)
                logits.append(lg[:, 0])
        ns.set_tree("caches", caches)
        ns["last_tok"] = tok
        ns["pos"] = pos + n
        ns["generated"] = torch.cat(outs, 1)
        ns["logits"] = torch.stack(logits, 1)
    return prefill, generate


def _jax_cells(jc, jp):
    def prefill(ns, seed):
        caches = jlm.init_caches(jc, B, PREFIX + GEN)
        toks = jnp.asarray(_tokens(jc, B, PREFIX, seed))
        tok = toks[:, :1]
        for t in range(PREFIX):
            lg, caches = jlm.decode_step(jc, jp, caches, {
                "tokens": tok, "index": jnp.asarray(t, jnp.int32)})
            tok = jnp.argmax(lg[..., :jc.vocab_size], -1).astype(jnp.int32)
            if t + 1 < PREFIX:
                tok = toks[:, t + 1:t + 2]
        ns.set_tree("caches", caches)
        ns["last_tok"] = np.asarray(tok)
        ns["pos"] = PREFIX

    def generate(ns, n, flavor):
        caches = ns.get_tree("caches")
        tok = jnp.asarray(ns["last_tok"])
        pos = ns["pos"]
        outs, logits = [], []
        for t in range(n):
            lg, caches = jlm.decode_step(jc, jp, caches, {
                "tokens": (tok + flavor) % jc.vocab_size,
                "index": jnp.asarray(pos + t, jnp.int32)})
            tok = jnp.argmax(lg[..., :jc.vocab_size], -1).astype(jnp.int32)
            outs.append(np.asarray(tok))
            logits.append(np.asarray(lg[:, 0]))
        ns.set_tree("caches", caches)
        ns["last_tok"] = np.asarray(tok)
        ns["pos"] = pos + n
        ns["generated"] = np.concatenate(outs, 1)
        ns["logits"] = np.stack(logits, 1)
    return prefill, generate


def _cache_bytes(ns):
    return {n: to_numpy(ns[n]).tobytes() for n in ns.names()
            if n.startswith("caches/")}


@pytest.mark.parametrize("kind", ["memory", "dir"])
def test_serve_batched_flow(tmp_path, kind):
    _, tc = _cfgs("smollm-360m")
    tp = tlm.init_params(tc, torch.Generator().manual_seed(0))
    uri = "memory://" if kind == "memory" else f"dir://{tmp_path}/cas"
    sess = tcore.KishuSession(tcore.open_store(uri), chunk_bytes=CB,
                              device="cpu")
    prefill, generate = _torch_cells(tc, tp)
    sess.register("prefill", prefill)
    sess.register("generate", generate)
    sess.init_state({})
    prefix = sess.run("prefill", seed=7)
    want = _cache_bytes(sess.ns)
    assert len(want) == 3 and sess.ns["pos"] == PREFIX
    results, caches = {}, {}
    for flavor in (1, 2, 3, 1):
        sess.checkout(prefix)
        assert _cache_bytes(sess.ns) == want          # bit for bit
        assert sess.ns["pos"] == PREFIX
        sess.run("generate", n=GEN, flavor=flavor)
        got = (sess.ns["generated"].clone(), _cache_bytes(sess.ns))
        if flavor in results:                          # the repeated flavor
            assert torch.equal(got[0], results[flavor])
            assert got[1] == caches[flavor]
        results[flavor], caches[flavor] = got
    assert not torch.equal(results[1], results[2])     # the example's check
    assert caches[1] != caches[2] and caches[2] != caches[3]
    sess.checkout(prefix)
    assert _cache_bytes(sess.ns) == want
    sess.close()


def test_jax_prefix_checks_out_in_the_port(tmp_path):
    """A prefix committed by the JAX package's session is checked out by a
    port session, which decodes on within float32 tolerance of the JAX
    package decoding on from the same prefix."""
    jc, tc = _cfgs("qwen3-1.7b")
    jp, tp = _params(jc, seed=1)
    uri = f"dir://{tmp_path}/cas"
    js = jcore.KishuSession(jcore.open_store(uri), chunk_bytes=CB)
    jpre, jgen = _jax_cells(jc, jp)
    js.register("prefill", jpre)
    js.register("generate", jgen)
    js.init_state({})
    prefix = js.run("prefill", seed=11)
    want = {n: np.asarray(js.ns[n]).tobytes() for n in js.ns.names()
            if n.startswith("caches/")}
    js.run("generate", n=GEN, flavor=2)
    jtoks, jlogits = js.ns["generated"], js.ns["logits"]
    js.close()

    ts = tcore.KishuSession(tcore.open_store(uri), chunk_bytes=CB,
                            device="cpu")
    tpre, tgen = _torch_cells(tc, tp)
    ts.register("prefill", tpre)
    ts.register("generate", tgen)
    ts.checkout(prefix)
    assert _cache_bytes(ts.ns) == want
    assert all(isinstance(ts.ns[n], torch.Tensor) for n in want)
    ts.run("generate", n=GEN, flavor=2)
    np.testing.assert_allclose(_np(ts.ns["logits"]), jlogits, **LOGITS)
    assert np.array_equal(ts.ns["generated"].numpy(), jtoks)
    ts.close()


def test_serving_never_builds_a_kernel_on_the_cpu(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("the CPU path reached the kernel library")

    for name in ("call", "_lib", "build_all", "note_launch"):
        monkeypatch.setattr(_lib, name, refuse)
    _, tc = _cfgs("smollm-360m", n_layers=2)
    tp = tlm.init_params(tc, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(tc, 2, 5, seed=0))
    tstep.make_prefill_step(tc)(tp, {"tokens": toks})
    tstep.make_decode_step(tc)(tp, tlm.init_caches(tc, 2, 5, device="cpu"),
                               {"tokens": toks[:, :1], "index": 0})


@pytest.mark.parametrize("kind", ["memory", "dir"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_batched_flow_ssm_moe(tmp_path, kind, arch):
    """The serve_batched flow (the JAX example serves mamba2) with SSM
    caches, whose every leaf each decode step rewrites: each rollback to
    the prefix restores the caches bit for bit, and a repeated flavor
    regenerates the same tokens and caches."""
    _, tc = _cfgs(arch)
    tp = tlm.init_params(tc, torch.Generator().manual_seed(0))
    uri = "memory://" if kind == "memory" else f"dir://{tmp_path}/cas"
    sess = tcore.KishuSession(tcore.open_store(uri), chunk_bytes=CB,
                              device="cpu")
    prefill, generate = _torch_cells(tc, tp)
    sess.register("prefill", prefill)
    sess.register("generate", generate)
    sess.init_state({})
    prefix = sess.run("prefill", seed=7)
    want = _cache_bytes(sess.ns)
    assert any(n.endswith("/ssm/state") for n in want) == \
        (tc.ssm is not None)
    results, caches = {}, {}
    for flavor in (1, 2, 1):
        sess.checkout(prefix)
        assert _cache_bytes(sess.ns) == want
        sess.run("generate", n=GEN, flavor=flavor)
        got = (sess.ns["generated"].clone(), _cache_bytes(sess.ns))
        if flavor in results:
            assert torch.equal(got[0], results[flavor])
            assert got[1] == caches[flavor]
        results[flavor], caches[flavor] = got
    assert not torch.equal(results[1], results[2])
    state = [n for n in want if n.endswith("/ssm/state")]
    for n in state:                  # the state is rewritten every step
        assert caches[1][n] != want[n] and caches[2][n] != want[n]
    sess.close()


@pytest.mark.parametrize("kind", ["memory", "dir"])
@pytest.mark.parametrize("arch", ZOO_ARCHS)
def test_serve_batched_flow_zoo(tmp_path, kind, arch):
    """The serve_batched flow with MLA's compressed caches, an enc-dec
    model's KV caches beside ``enc_out`` (committed once, never rewritten:
    every rollback keeps its tensor), decoding from embeddings with M-RoPE,
    and the two dense configs: each rollback to the prefix restores the
    caches bit for bit, and a repeated flavor regenerates the same tokens
    and caches."""
    _, tc = _cfgs(arch)
    tp = tlm.init_params(tc, torch.Generator().manual_seed(0))
    uri = "memory://" if kind == "memory" else f"dir://{tmp_path}/cas"
    sess = tcore.KishuSession(tcore.open_store(uri), chunk_bytes=CB,
                              device="cpu")
    prefill, generate = _torch_cells(tc, tp)
    sess.register("prefill", prefill)
    sess.register("generate", generate)
    sess.init_state({})
    prefix = sess.run("prefill", seed=7)
    want = _cache_bytes(sess.ns)
    assert ("caches/enc_out" in want) == tc.enc_dec
    assert any(n.endswith("/attn/c_kv") for n in want) == (tc.mla is not None)
    enc_out = sess.ns["caches/enc_out"] if tc.enc_dec else None
    results, caches = {}, {}
    for flavor in (1, 2, 1):
        sess.checkout(prefix)
        assert _cache_bytes(sess.ns) == want
        if enc_out is not None:
            assert sess.ns["caches/enc_out"] is enc_out
        sess.run("generate", n=GEN, flavor=flavor)
        got = (sess.ns["generated"].clone(), _cache_bytes(sess.ns))
        if flavor in results:
            assert torch.equal(got[0], results[flavor])
            assert got[1] == caches[flavor]
        results[flavor], caches[flavor] = got
    assert not torch.equal(results[1], results[2])
    if enc_out is not None:
        assert caches[1]["caches/enc_out"] == want["caches/enc_out"]
    sess.close()


def _store_files(root):
    import os
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_ssm_caches_commit_and_roll_back_as_the_jax_package(tmp_path):
    """SSM caches decoded by the JAX package cross to the port as raw
    bytes; committed by each package's session they write the same chunk
    files and keys.  The port then decodes on (rewriting every cache
    leaf in place) and rolls back to the commit, bit for bit."""
    jc, tc = _cfgs("mamba2-780m")
    jp, tp = _params(jc, seed=2)
    toks = _tokens(jc, B, PREFIX, seed=3)
    jcache = jlm.init_caches(jc, B, PREFIX + GEN)
    for t in range(PREFIX):
        _, jcache = jlm.decode_step(jc, jp, jcache,
                                    {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                     "index": jnp.asarray(t, jnp.int32)})
    host = jax.tree.map(np.asarray, jcache)
    js = jcore.KishuSession(jcore.open_store(f"dir://{tmp_path}/j"),
                            chunk_bytes=CB)
    jcid = js.init_state({"caches": jax.tree.map(jnp.asarray, host)})
    js.close()
    ts = tcore.KishuSession(tcore.open_store(f"dir://{tmp_path}/t"),
                            chunk_bytes=CB, device="cpu")
    tcid = ts.init_state({"caches": to_torch(host, "cpu")})
    assert jcid == tcid
    jfiles, tfiles = _store_files(tmp_path / "j"), _store_files(tmp_path / "t")
    chunks = sorted(n for n in jfiles if n.startswith("chunks"))
    assert chunks and chunks == sorted(n for n in tfiles
                                       if n.startswith("chunks"))
    assert all(jfiles[n] == tfiles[n] for n in chunks)
    want = _cache_bytes(ts.ns)

    def decode_on(ns, n):
        caches = ns.get_tree("caches")
        tok = torch.from_numpy(toks[:, -1:].copy())
        with torch.no_grad():
            for t in range(n):
                lg, caches = tlm.decode_step(tc, tp, caches,
                                             {"tokens": tok,
                                              "index": PREFIX + t})
                tok = lg[..., :tc.vocab_size].argmax(-1).to(torch.int32)
    ts.register("decode_on", decode_on)
    ts.run("decode_on", n=3)
    assert all(_cache_bytes(ts.ns)[n] != want[n] for n in want)
    st = ts.checkout(tcid)
    assert _cache_bytes(ts.ns) == want
    assert st.covs_patched + st.covs_loaded == len(want)
    ts.close()
