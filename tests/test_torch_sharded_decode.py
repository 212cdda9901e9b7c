"""Decode at a full cache, and decode on sharded caches.

- ``layers.split_attention`` over a cache cut into 1, 2 and 4 pieces
  against the JAX package's ``attention_core``.
- The full-cache write: at ``index >= S`` the JAX package's
  ``dynamic_update_slice`` clamps the slot to ``S-1``; the port's
  ``gqa_decode``, ``mla_decode`` and ``lm.decode_step`` (reduced
  smollm-360m and deepseek-v3) write that slot and give the JAX logits,
  caches and index at ``index = S`` and ``S + 3``.
- Decode on DTensor caches under ``ShardingRules.cache_spec``, on gloo
  ranks of a (1, 2) and a (2, 2) ("data", "model") mesh, for float32
  reduced configs of the seven decode families: smollm-360m, qwen3-1.7b
  (qk-norm), deepseek-v3 (MLA + MoE, MTP carried), mamba2-780m (SSM),
  jamba (hybrid), whisper-large-v3 (enc-dec) and qwen2-vl (M-RoPE, from
  ``embeds``).  Five teacher-forced steps on 4-slot caches cross the
  boundary between the ranks' slots and end with a step at a full
  cache; logits and ``full_tensor()`` caches are held against the
  single-device port and the JAX package at ``test_torch_serve.py``'s
  tolerances (logits atol 1e-4 / rtol 1e-4, K/V atol 1e-5 / rtol 1e-4,
  SSM leaves atol 5e-5 / rtol 1e-4).  One sharded step runs under
  ``CommDebugMode``: every attention layer runs its three reductions,
  one all-reduce each, counted by op.  ``GraphedDecodeStep`` on these
  CPU DTensors runs the eager step: the same token and caches, no
  capture.
- Kishu on sharded caches (in the (1, 2) ranks): a 2-rank session
  commits DTensor caches whose chunk keys, detection hashes and stored
  bytes equal the single-device commit of the same values, decodes on,
  and checks the prefix out exactly; the JAX package's session then
  checks that commit out with identical bytes.

The JAX references and the single-device port run in this process; each
mesh is one spawn of its ranks.
"""
import collections
import contextlib
import functools
import types

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro_torch.core.namespace import (flatten_tree,  # noqa: E402
                                        unflatten_tree)
from repro_torch.interop import to_torch  # noqa: E402
from repro_torch.launch.mesh import run_local_ranks  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.config import get_config as tget  # noqa: E402
from repro_torch.models.testing import reduced as treduced  # noqa: E402


@functools.lru_cache(maxsize=None)
def J():
    """The JAX package's modules, imported in the test's process only:
    the ranks import this file and need none of them."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import repro.core as jcore
    from repro.models import layers, lm
    from repro.models.config import get_config
    from repro.models.testing import reduced
    return types.SimpleNamespace(jax=jax, jnp=jnp, core=jcore,
                                 layers=layers, lm=lm, get=get_config,
                                 reduced=reduced)


LOGITS = dict(atol=1e-4, rtol=1e-4)
KV = dict(atol=1e-5, rtol=1e-4)
SSM = dict(atol=5e-5, rtol=1e-4)
FAMILIES = ["smollm-360m", "qwen3-1.7b", "deepseek-v3-671b", "mamba2-780m",
            "jamba-1.5-large-398b", "whisper-large-v3", "qwen2-vl-72b"]
B, S = 2, 4                 # batch, cache slots: 2 a rank over model 2
STEPS = S + 1               # indices 0..S: the last at a full cache
ENC_SEQ = 7                 # encoder frames (not B: cache_spec reads dims)
KISHU_ARCH, PREFIX, CB = "smollm-360m", 3, 1 << 10
RANK_TIMEOUT = 240.0


def _layers(arch):
    # Jamba: one unit of its hybrid pattern (an attention layer among
    # seven SSM layers)
    return 8 if arch.startswith("jamba") else None


def _tcfg(arch):
    return treduced(tget(arch), n_layers=_layers(arch))


def _cfgs(arch):
    return J().reduced(J().get(arch), n_layers=_layers(arch)), _tcfg(arch)


def _params(tc, seed):
    """Seeded port parameters as numpy, for both packages (the same
    leaves, shapes and dtypes)."""
    return _numpy_tree(tlm.init_params(tc, torch.Generator()
                                       .manual_seed(seed)))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.numpy()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _inputs(cfg, seed=3):
    """Seeded decode inputs [B, STEPS] (tokens, or embeddings for the
    vision frontend) and an enc-dec model's frames."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "vision":
        out["embeds"] = rng.standard_normal(
            (B, STEPS, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size,
                                     (B, STEPS)).astype(np.int32)
    if cfg.enc_dec:
        out["enc_embeds"] = rng.standard_normal(
            (B, ENC_SEQ, cfg.d_model)).astype(np.float32)
    return out


def _step_batch(inputs, t, conv):
    key = "embeds" if "embeds" in inputs else "tokens"
    return {key: conv(inputs[key][:, t:t + 1].copy()), "index": t}


def _jax_run(jc, jp, inputs, steps=STEPS, seq=S):
    """Per-step logits [B, steps, V] and the final caches of the JAX
    package's teacher-forced decode."""
    caches = J().lm.init_caches(jc, B, seq, enc_seq=ENC_SEQ if jc.enc_dec
                             else 0)
    if jc.enc_dec:
        caches["enc_out"] = J().lm.encode(
            jc, jp, {"enc_embeds": J().jnp.asarray(inputs["enc_embeds"])},
            remat=False)
    step = J().jax.jit(functools.partial(J().lm.decode_step, jc))
    logits = []
    for t in range(steps):
        bt = _step_batch(inputs, t, J().jnp.asarray)
        bt["index"] = J().jnp.asarray(t, J().jnp.int32)
        lg, caches = step(jp, caches, bt)
        logits.append(np.asarray(lg[:, 0]))
    return np.stack(logits, 1), J().jax.tree.map(np.asarray, caches)


def _port_caches(tc, tp, inputs, seq=S):
    caches = tlm.init_caches(tc, B, seq, device="cpu",
                             enc_seq=ENC_SEQ if tc.enc_dec else 0)
    if tc.enc_dec:
        with torch.no_grad():
            caches["enc_out"] = tlm.encode(tc, tp, {"enc_embeds":
                                                    torch.from_numpy(
                                                        inputs["enc_embeds"])})
    return caches


def _port_run(tc, tp, inputs, steps=STEPS, seq=S):
    caches = _port_caches(tc, tp, inputs, seq)
    logits = []
    with torch.no_grad():
        for t in range(steps):
            lg, caches = tlm.decode_step(tc, tp, caches,
                                         _step_batch(inputs, t,
                                                     torch.from_numpy))
            logits.append(lg[:, 0].numpy())
    return np.stack(logits, 1), {k: v.numpy() for k, v in
                                 flatten_tree(caches).items()}


def _tol(name):
    return SSM if "/ssm/" in name else KV


# ---------------------------------------------------------------------------
# Part 0: the full-cache write
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("index", [S, S + 3])
def test_gqa_decode_at_a_full_cache_matches_jax(index):
    jc, tc = _cfgs("smollm-360m")
    p = J().jax.tree.map(lambda x: x[0], _params(tc, 0)["stages"]["stage_0"]
                     ["sub_0"]["attn"])
    rng = np.random.default_rng(1)
    hd = jc.resolved_head_dim
    x = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
    k = rng.standard_normal((B, S, jc.n_kv_heads, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, jc.n_kv_heads, hd)).astype(np.float32)
    pos = np.full((B, 1), index, np.int32)
    jy, jcache = J().layers.gqa_decode(
        J().jax.tree.map(J().jnp.asarray, p), jc, J().jnp.asarray(x),
        {"k": J().jnp.asarray(k), "v": J().jnp.asarray(v),
         "index": J().jnp.asarray(index, J().jnp.int32)}, J().jnp.asarray(pos))
    cache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
             "index": torch.tensor(index, dtype=torch.int32)}
    ty, tcache = tlayers.gqa_decode(to_torch(p, "cpu"), tc,
                                    torch.from_numpy(x), cache,
                                    torch.from_numpy(pos))
    assert tcache is cache
    np.testing.assert_allclose(_np(ty), _np(jy), **LOGITS)
    for n in ("k", "v"):
        got, want = cache[n].numpy(), np.asarray(jcache[n])
        # slot S-1 holds the new row; the others are untouched
        assert got[:, :S - 1].tobytes() == want[:, :S - 1].tobytes()
        assert not np.array_equal(got[:, S - 1], k[:, S - 1] if n == "k"
                                  else v[:, S - 1])
        np.testing.assert_allclose(got, want, **KV)
    assert int(cache["index"]) == int(jcache["index"]) == index + 1


@pytest.mark.parametrize("index", [S, S + 3])
def test_mla_decode_at_a_full_cache_matches_jax(index):
    jc, tc = _cfgs("deepseek-v3-671b")
    p = J().jax.tree.map(lambda x: x[0], _params(tc, 0)["stages"]["stage_0"]
                     ["sub_0"]["attn"])
    m = jc.mla
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
    c = rng.standard_normal((B, S, m.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((B, S, 1, m.qk_rope_head_dim)).astype(
        np.float32)
    pos = np.full((B, 1), index, np.int32)
    jy, jcache = J().layers.mla_decode(
        J().jax.tree.map(J().jnp.asarray, p), jc, J().jnp.asarray(x),
        {"c_kv": J().jnp.asarray(c), "k_rope": J().jnp.asarray(kr),
         "index": J().jnp.asarray(index, J().jnp.int32)}, J().jnp.asarray(pos))
    cache = {"c_kv": torch.from_numpy(c.copy()),
             "k_rope": torch.from_numpy(kr.copy()),
             "index": torch.tensor(index, dtype=torch.int32)}
    ty, _ = tlayers.mla_decode(to_torch(p, "cpu"), tc, torch.from_numpy(x),
                               cache, torch.from_numpy(pos))
    np.testing.assert_allclose(_np(ty), _np(jy), **LOGITS)
    for n in ("c_kv", "k_rope"):
        got, want = cache[n].numpy(), np.asarray(jcache[n])
        assert got[:, :S - 1].tobytes() == want[:, :S - 1].tobytes()
        np.testing.assert_allclose(got, want, **KV)
    assert int(cache["index"]) == int(jcache["index"]) == index + 1


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v3-671b"])
def test_decode_step_past_a_full_cache_matches_jax(arch):
    """Teacher-forced decode to ``index = S + 3`` on S-slot caches: the
    steps at and past the full cache keep writing slot S-1, in both
    packages."""
    jc, tc = _cfgs(arch)
    params_np = _params(tc, 1)
    jp = J().jax.tree.map(J().jnp.asarray, params_np)
    tp = to_torch(params_np, "cpu")
    inputs = _inputs(jc, seed=4)
    n = S + 4
    inputs = {k: np.concatenate([v] * 2, axis=1)[:, :n]
              for k, v in inputs.items()}
    jl, jcache = _jax_run(jc, jp, inputs, steps=n)
    tl, tcache = _port_run(tc, tp, inputs, steps=n)
    np.testing.assert_allclose(tl, jl, **LOGITS)
    want = flatten_tree(jcache)
    assert sorted(want) == sorted(tcache)
    for name, w in want.items():
        g = tcache[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name.endswith("index"):
            assert set(g.tolist()) == {n} and g.tobytes() == w.tobytes()
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **KV)


@pytest.mark.parametrize("pieces", [1, 2, 4])
def test_split_attention_over_cut_caches_matches_jax(pieces):
    """``layers.split_attention`` over a cache cut into pieces along the
    sequence (list reductions) against the JAX package's
    ``attention_core`` on the whole cache, float32, GQA, part of the
    cache past ``q_offset`` (masked): logits tolerance."""
    rng = np.random.default_rng(pieces)
    b, s, hq, hkv, hd, index = 2, 16, 4, 2, 16, 9
    q = rng.standard_normal((b, 1, hq, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    want = J().layers.attention_core(J().jnp.asarray(q), J().jnp.asarray(k),
                                     J().jnp.asarray(v), causal=True,
                                     q_offset=index)
    n = s // pieces
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    got = tlayers.split_attention(
        torch.from_numpy(q), list(tk.split(n, dim=1)),
        list(tv.split(n, dim=1)), list(range(0, s, n)),
        q_offset=torch.tensor(index, dtype=torch.int32),
        reduce_max=lambda xs: functools.reduce(torch.maximum, xs),
        reduce_sum=lambda xs: functools.reduce(torch.add, xs))
    np.testing.assert_allclose(_np(got), _np(want), **LOGITS)


# ---------------------------------------------------------------------------
# decode on sharded caches, on gloo ranks
# ---------------------------------------------------------------------------

def _all_reduces(comm) -> int:
    return sum(v for k, v in comm.get_comm_counts().items()
               if str(k).endswith("all_reduce"))


@contextlib.contextmanager
def _split_reductions(comm):
    """Count the split attention's reductions as they run, by op
    (``SeqShard.reduce``'s closures), and the all-reduces that they, and
    no other code, issue under ``comm`` (key ``"wire"``)."""
    counts = collections.Counter()
    orig = tlayers.SeqShard.reduce

    def reduce(self, op):
        inner = orig(self, op)

        def counted(xs):
            before = _all_reduces(comm)
            out = inner(xs)
            counts[op] += 1
            counts["wire"] += _all_reduces(comm) - before
            return out
        return counted
    tlayers.SeqShard.reduce = reduce
    try:
        yield counts
    finally:
        tlayers.SeqShard.reduce = orig


def _sharded_rank(rank, world, model, cases, kishu):
    """On a (world/model, model) mesh: each case decoded teacher-forced
    from sharded params and caches (logits and full caches gathered), one
    step of each under ``CommDebugMode``; with ``kishu``, a session over
    the group commits sharded caches, decodes on and checks out."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding.rules import (ShardingRules, distribute_tree,
                                            shard_caches)
    from repro_torch.train import step as tstep
    torch.set_num_threads(1)        # ranks share the test's cores
    mesh = make_local_mesh(model=model)
    out = {}
    for arch, (params_np, inputs) in cases.items():
        cfg = _tcfg(arch)
        params = to_torch(params_np, "cpu")
        rules = ShardingRules(cfg, mesh)
        dparams = distribute_tree(params, mesh,
                                  rules.param_shardings(params))
        caches = shard_caches(_port_caches(cfg, params, inputs), rules, B)
        key = "embeds" if "embeds" in inputs else "tokens"

        def batch_at(t):
            x = torch.from_numpy(inputs[key][:, t:t + 1].copy())
            pl = rules.batch_spec({key: x})[key]
            return {key: distribute_tensor(x, mesh, list(pl)), "index": t}
        logits, comm = [], CommDebugMode()
        with torch.no_grad(), tstep.spmd(dparams):
            for t in range(STEPS):
                bt = batch_at(t)
                if t == S // 2:
                    with comm, _split_reductions(comm) as split:
                        lg, _ = tlm.decode_step(cfg, dparams, caches, bt)
                else:
                    lg, _ = tlm.decode_step(cfg, dparams, caches, bt)
                logits.append(lg.full_tensor()[:, 0].numpy())
        leaves = flatten_tree(caches)
        gathered = {k: v.full_tensor().numpy().copy()
                    for k, v in leaves.items()}
        # the greedy step on the same caches: a batch-sharded token.  The
        # graphed step on a copy of them runs that eager step on CPU
        # (gloo) tensors: the same token and caches, no capture
        twin = {k: v.clone() for k, v in leaves.items()}
        nxt, _ = tstep.make_decode_step(cfg)(dparams, caches,
                                             batch_at(STEPS - 1))
        graphed = tstep.GraphedDecodeStep(cfg)
        gnxt, _ = graphed(dparams, unflatten_tree(twin), batch_at(STEPS - 1))
        same = torch.equal(gnxt.full_tensor(), nxt.full_tensor()) and all(
            torch.equal(twin[k].to_local(), v.to_local())
            for k, v in leaves.items())
        out[arch] = {
            "logits": np.stack(logits, 1), "caches": gathered,
            "dtensor": all(isinstance(v, DTensor) for v in leaves.values()),
            "placements": {k: tuple(map(str, v.placements))
                           for k, v in leaves.items()},
            "all_reduce": _all_reduces(comm), "split": dict(split),
            "next": (type(nxt).__name__, nxt.full_tensor().numpy()),
            "graphed": (graphed.captures, same)}
    if kishu is not None:
        out["kishu"] = _kishu_rank(mesh, *kishu)
    return out


def _kishu_rank(mesh, params_np, inputs, uri):
    import torch.distributed as dist
    from repro_torch.core import KishuSession, open_store
    from repro_torch.sharding.rules import (ShardingRules, distribute_tree,
                                            shard_caches)
    from repro_torch.train import step as tstep
    cfg = treduced(tget(KISHU_ARCH))
    params = to_torch(params_np, "cpu")
    rules = ShardingRules(cfg, mesh)
    dparams = distribute_tree(params, mesh, rules.param_shardings(params))
    toks = torch.from_numpy(inputs["tokens"])
    tok_pl = list(rules.batch_spec({"t": toks[:, :1]})["t"])

    def decode(ns, lo, hi):
        from torch.distributed.tensor import distribute_tensor
        caches = ns.get_tree("caches")
        with torch.no_grad(), tstep.spmd(dparams):
            for t in range(lo, hi):
                tlm.decode_step(cfg, dparams, caches, {
                    "tokens": distribute_tensor(toks[:, t:t + 1].clone(),
                                                mesh, tok_pl), "index": t})
    s = KishuSession(open_store(uri), chunk_bytes=CB, device="cpu",
                     group=dist.group.WORLD, cache_bytes=0)
    s.register("decode", decode)
    s.init_state({"caches": shard_caches(
        tlm.init_caches(cfg, B, S, device="cpu"), rules, B)})
    c_prefix = s.run("decode", lo=0, hi=PREFIX)
    rec = _commit_record(s, c_prefix)
    prefix = {n: s.ns[n].full_tensor().numpy().copy()
              for n in s.ns.names() if n.startswith("caches/")}
    c_on = s.run("decode", lo=PREFIX, hi=STEPS)
    on = {n: s.ns[n].full_tensor().numpy().tobytes() for n in prefix}
    moved = [n for n in prefix if on[n] != prefix[n].tobytes()]
    st = s.checkout(c_prefix)
    back = {n: s.ns[n].full_tensor().numpy().tobytes() for n in prefix}
    kinds = {n: type(s.ns[n]).__name__ for n in prefix}
    s.close()
    return {"commits": (c_prefix, c_on), "record": rec, "prefix": prefix,
            "on": on,
            "moved": moved, "back": back, "kinds": kinds,
            "restored": st.covs_patched + st.covs_loaded}


def _commit_record(s, cid):
    from repro_torch.core.graph import key_str
    out = {}
    for n in s.ns.names():
        if not n.startswith("caches/"):
            continue
        man = s.graph.manifest_of(
            (n,), s.graph.nodes[cid].state_index[key_str((n,))])
        keys = [c["key"] for c in man["base"]["chunks"]]
        out[n] = {"keys": keys, "det": man["base"]["det_hashes"],
                  "meta": man["base"]["meta"],
                  "bytes": [s.store.get_chunk(k) for k in keys]}
    return out


@pytest.fixture(scope="module")
def references():
    """Per family: JAX params (numpy), inputs, the JAX run and the
    single-device port's run."""
    out = {}
    for i, arch in enumerate(FAMILIES):
        jc, tc = _cfgs(arch)
        params_np = _params(tc, 10 + i)
        jp = J().jax.tree.map(J().jnp.asarray, params_np)
        inputs = _inputs(jc, seed=20 + i)
        out[arch] = {"params": params_np, "inputs": inputs,
                     "jax": _jax_run(jc, jp, inputs),
                     "port": _port_run(tc, to_torch(params_np, "cpu"),
                                       inputs)}
    return out


def _single_device_commit(prefix):
    """The prefix's cache values (gathered from the ranks) committed as
    plain tensors on one device."""
    from repro_torch.core import KishuSession, MemoryStore
    from repro_torch.core.namespace import unflatten_tree
    caches = unflatten_tree({n[len("caches/"):]: torch.from_numpy(v.copy())
                             for n, v in prefix.items()})
    s = KishuSession(MemoryStore(), chunk_bytes=CB, device="cpu")
    cid = s.init_state({"caches": caches})
    rec = _commit_record(s, cid)
    s.close()
    return rec


def _check_family(arch, got, ref, world):
    jl, jcache = ref["jax"]
    tl, tcache = ref["port"]
    msg = f"{arch} on {world} ranks"
    assert got["dtensor"], msg
    np.testing.assert_allclose(got["logits"], tl, err_msg=msg, **LOGITS)
    np.testing.assert_allclose(got["logits"], jl, err_msg=msg, **LOGITS)
    want = flatten_tree(jcache)
    assert sorted(got["caches"]) == sorted(want) == sorted(tcache), msg
    for name, w in want.items():
        g = got["caches"][name]
        assert g.dtype == w.dtype and g.shape == w.shape, (msg, name)
        if name.endswith("index"):
            assert g.tobytes() == w.tobytes() == tcache[name].tobytes()
            assert set(g.tolist()) == {STEPS}, (msg, name)
            continue
        np.testing.assert_allclose(g, tcache[name], err_msg=f"{msg} {name}",
                                   **_tol(name))
        np.testing.assert_allclose(g, w, err_msg=f"{msg} {name}",
                                   **_tol(name))
    # K/V and the compressed caches are sharded on the sequence over
    # model, the SSM state on its heads
    for name, pl in got["placements"].items():
        if name.split("/")[-1] in ("k", "v", "c_kv", "k_rope", "state"):
            assert pl[-1] == "S(2)", (msg, name, pl)
    # three reductions in every attention layer of the counted step, each
    # one all-reduce over model, the one mesh dim that shards the sequence
    units = sum(w.shape[0] for n, w in want.items()
                if n.endswith("/attn/index"))
    want_split = {"max": units, "sum": 2 * units, "wire": 3 * units}
    assert got["split"] == {k: v for k, v in want_split.items() if v}, (
        msg, got["split"], units)
    assert got["all_reduce"] >= 3 * units, (msg, got["all_reduce"], units)
    kind, nxt = got["next"]
    assert kind == "DTensor" and nxt.shape == (B, 1)
    assert got["graphed"] == (0, True), msg


def _run_mesh(references, world, model, tmp_path=None):
    cases = {a: (r["params"], r["inputs"]) for a, r in references.items()}
    kishu = None
    if tmp_path is not None:
        r = references[KISHU_ARCH]
        kishu = (r["params"], r["inputs"], f"dir://{tmp_path}/cas")
    return run_local_ranks(_sharded_rank, world, model, cases, kishu,
                           timeout=RANK_TIMEOUT)


def test_sharded_decode_on_a_1x2_mesh_and_kishu(references, tmp_path):
    """Two ranks, the sequence over model: every family against the port
    and JAX; then Kishu on the sharded caches (see the module
    docstring)."""
    outs = _run_mesh(references, 2, 2, tmp_path)
    for arch in FAMILIES:
        for rank, out in enumerate(outs):
            _check_family(arch, out[arch], references[arch], 2)
    want = _single_device_commit(outs[0]["kishu"]["prefix"])
    for rank, out in enumerate(outs):
        k = out["kishu"]
        assert k["record"] == want, rank   # keys, hashes, metas, bytes
        assert k["moved"] and k["restored"] >= len(k["moved"]), rank
        assert k["back"] == {n: v.tobytes()
                             for n, v in k["prefix"].items()}, rank
        assert set(k["kinds"].values()) == {"DTensor"}, rank
    # the JAX package's session checks the sharded commits out: the
    # decoded one (from the store), then the prefix
    k = outs[0]["kishu"]
    js = J().core.KishuSession(J().core.open_store(f"dir://{tmp_path}/cas"),
                            chunk_bytes=CB)
    got = []
    for cid in (k["commits"][1], k["commits"][0]):
        js.checkout(cid)
        got.append({n: np.asarray(js.ns[n]).tobytes()
                    for n in js.ns.names() if n.startswith("caches/")})
    js.close()
    assert got[0] == k["on"]
    assert got[1] == {n: v.tobytes() for n, v in k["prefix"].items()}


def test_sharded_decode_on_a_2x2_mesh(references):
    """Four ranks: the batch over data, the sequence over model."""
    outs = _run_mesh(references, 4, 2)
    for arch in FAMILIES:
        for out in outs:
            _check_family(arch, out[arch], references[arch], 4)
