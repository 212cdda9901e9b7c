"""The port's commit -> checkout loop held against the JAX package.

One seeded numpy state and one sequence of cells run through
``repro.core.KishuSession`` (jax arrays, device path forced on so the fused
pack, codec and scatter run through their references) and through
``repro_torch.core.KishuSession(device="cpu")`` (CPU tensors, the plain
torch versions of the kernels).  The two must write the same chunk keys,
the same stored bytes (raw chunks and device-encoded ``bshuf`` frames
alike), the same manifests and the same commit docs, restore bit-identical
states — and each must check out the other's stores.
"""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.interop import to_torch  # noqa: E402

CB = 4096
DEVICE_ENV = ("KISHU_DEVICE_DELTA", "KISHU_DEVICE_HASH", "KISHU_DEVICE_CODEC",
              "KISHU_DEVICE_SCATTER")


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal(3000).astype(np.float32),       # ragged
        "emb": rng.standard_normal((700, 64)).astype(np.float32),
        "e16": rng.standard_normal(9999).astype(jnp.bfloat16),   # odd bf16
        "h": rng.standard_normal(5001).astype(np.float16),
        "ids": rng.integers(0, 1000, 10001).astype(np.int32),
        "mask": rng.random(7777) < 0.5,
        "u8": rng.integers(0, 256, 12345).astype(np.uint8),
        "tiny": rng.standard_normal(10).astype(np.float32),       # < 1 chunk
    }


def _host_state(seed=0):
    rng = np.random.default_rng(seed + 1)
    return {"host64": rng.integers(-2**40, 2**40, 5000), "step": 0}


# the same cells, written once per package (jax rebinds, torch mutates)

def _jax_cells():
    def attach(ns):
        for k, v in _state().items():
            ns[k] = jnp.asarray(v)
        ns["tied"] = ns["w"]
        for k, v in _host_state().items():
            ns[k] = v.copy() if isinstance(v, np.ndarray) else v

    def sparse(ns, seed):
        ns["emb"] = ns["emb"].at[jnp.array([3, 300, 650])].set(float(seed))
        ns["ids"] = ns["ids"].at[::2500].set(seed)
        ns["e16"] = ns["e16"].at[5000:5010].set(1.5)
        ns["host64"][5] = seed
        ns["step"] = ns["step"] + 1

    def zero_rows(ns):
        ns["emb"] = ns["emb"].at[100:400].set(0.0)
        # an all-True bool chunk: compressible, and unlike an all-zero chunk
        # it shares its key with no other chunk, so its stored bytes show
        # how bool chunks are stored
        ns["mask"] = ns["mask"].at[:4096].set(True)

    def full(ns):
        ns["h"] = ns["h"] * 2

    def reshape(ns):
        ns["extra"] = jnp.arange(2048, dtype=jnp.int32)
        del ns["u8"]
        w = ns["w"].at[7].set(3.0)
        ns["w"], ns["tied"] = w, w

    return {"attach": attach, "sparse": sparse, "zero_rows": zero_rows,
            "full": full, "reshape": reshape}


def _torch_cells(device="cpu"):
    def attach(ns):
        for k, v in to_torch(_state(), device).items():
            ns[k] = v
        ns["tied"] = ns["w"]
        for k, v in _host_state().items():
            ns[k] = v.copy() if isinstance(v, np.ndarray) else v

    def sparse(ns, seed):
        ns["emb"][[3, 300, 650]] = float(seed)
        ns["ids"][::2500] = seed
        ns["e16"][5000:5010] = 1.5
        ns["host64"][5] = seed
        ns["step"] = ns["step"] + 1

    def zero_rows(ns):
        ns["emb"][100:400] = 0.0
        ns["mask"][:4096] = True

    def full(ns):
        ns["h"].mul_(2)

    def reshape(ns):
        ns["extra"] = torch.arange(2048, dtype=torch.int32, device=device)
        del ns["u8"]
        ns["w"][7] = 3.0
        ns["tied"] = ns["w"]

    return {"attach": attach, "sparse": sparse, "zero_rows": zero_rows,
            "full": full, "reshape": reshape}


SCRIPT = [("sparse", {"seed": 5}), ("zero_rows", {}), ("sparse", {"seed": 6}),
          ("full", {}), ("reshape", {}), ("sparse", {"seed": 7})]


def _leaf_bytes(v):
    if isinstance(v, torch.Tensor):
        return v.reshape(-1).contiguous().view(torch.uint8).cpu().numpy() \
            .tobytes()
    if hasattr(v, "__array__"):
        return np.ascontiguousarray(np.asarray(v)).tobytes()
    return v


def _snapshot(sess):
    return {n: _leaf_bytes(sess.ns[n]) for n in sess.ns.names()}


def _drive(sess, cells):
    for name, fn in cells.items():
        sess.register(name, fn)
    sess.init_state({})
    cids = [sess.run("attach")]
    snaps = {cids[0]: _snapshot(sess)}
    for name, args in SCRIPT:
        cid = sess.run(name, **args)
        cids.append(cid)
        snaps[cid] = _snapshot(sess)
    return cids, snaps


@pytest.fixture
def device_path(monkeypatch):
    for k in DEVICE_ENV:
        monkeypatch.setenv(k, "1")


def _jax_session(store):
    return jcore.KishuSession(store, chunk_bytes=CB, cache_bytes=0)


def _torch_session(store):
    return tcore.KishuSession(store, chunk_bytes=CB, cache_bytes=0,
                              device="cpu")


def _commit_docs(store):
    out = {}
    for name in store.list_meta("commit/"):
        doc = dict(store.get_meta(name))
        doc.pop("timestamp", None)
        doc.pop("stats", None)
        out[name] = doc
    return out


def test_same_store_bytes_and_docs(device_path):
    js, ts = jcore.MemoryStore(), tcore.MemoryStore()
    jsess, tsess = _jax_session(js), _torch_session(ts)
    jc, jsnaps = _drive(jsess, _jax_cells())
    tc, tsnaps = _drive(tsess, _torch_cells())
    assert jc == tc
    assert jsnaps == tsnaps
    # chunk keys and stored bytes (raw and bshuf frames) are identical for
    # every chunk, the bool leaf's included (both packages store it raw)
    assert set(js.chunks) == set(ts.chunks)
    bool_keys = {c["key"] for cid in jc
                 for m in jsess.graph.nodes[cid].manifests.values()
                 if not m.get("unserializable")
                 and m["base"]["meta"].get("dtype") == "bool"
                 for c in m["base"]["chunks"]}
    assert bool_keys
    for k in js.chunks:
        assert js.chunks[k] == ts.chunks[k], k
    frames = [v for v in ts.chunks.values() if v[:5] == b"KZC1\x04"]
    assert frames, "the on-device codec never produced a stored frame"
    # per-co-variable manifests and whole commit docs match
    for cid in jc:
        assert jsess.graph.nodes[cid].manifests \
            == tsess.graph.nodes[cid].manifests
    assert _commit_docs(js) == _commit_docs(ts)
    assert sum(tsess.last_run.write.__dict__[k] for k in ("covs_packed",)) > 0
    jsess.close()
    tsess.close()


def test_checkouts_bit_identical_and_in_place(device_path):
    js, ts = jcore.MemoryStore(), tcore.MemoryStore()
    jsess, tsess = _jax_session(js), _torch_session(ts)
    cids, snaps = _drive(jsess, _jax_cells())
    _drive(tsess, _torch_cells())
    emb, e16 = tsess.ns["emb"], tsess.ns["e16"]
    view = emb[100:110]                     # a live alias of the storage
    scattered = 0
    for cid in [cids[1], cids[4], cids[0], cids[6], cids[2], cids[-1]]:
        jsess.checkout(cid)
        st = tsess.checkout(cid)
        scattered += st.covs_scattered
        assert _snapshot(jsess) == snaps[cid]
        assert _snapshot(tsess) == snaps[cid]
    assert scattered > 0
    # patched in place: same tensor objects, the alias sees the data
    assert tsess.ns["emb"] is emb and tsess.ns["e16"] is e16
    assert torch.equal(view, tsess.ns["emb"][100:110])
    jsess.close()
    tsess.close()


def test_torch_views_restore_in_place(device_path):
    """Torch views are real aliases: a co-variable of a tensor and its view
    patches in place and the view keeps seeing the storage."""
    sess = _torch_session(tcore.MemoryStore())

    def init(ns):
        base = torch.arange(6000, dtype=torch.float32)
        ns["base"] = base
        ns["win"] = base[1000:5000].view(40, 100)
        ns["col"] = base.view(60, 100)[:, 3]

    def bump(ns, v):
        ns["base"][::1997] = v           # 4 of 6 chunks

    sess.register("init", init)
    sess.register("bump", bump)
    sess.init_state({})
    c0 = sess.run("init")
    assert len(sess.covs) == 1
    win, col = sess.ns["win"], sess.ns["col"]
    c1 = sess.run("bump", v=-1.0)
    st = sess.checkout(c0)
    assert st.covs_patched == 1 and st.covs_scattered == 1
    assert sess.ns["win"] is win and sess.ns["col"] is col
    assert float(win[0, 0]) == 1000.0 and float(col[10]) == 1003.0
    sess.checkout(c1)
    assert float(sess.ns["base"][1997]) == -1.0 and float(col[0]) == 3.0
    sess.close()


@pytest.mark.parametrize("kind", ["dir", "sqlite"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cross_package_checkout(tmp_path, device_path, kind, writer):
    uri = f"dir://{tmp_path}/cas" if kind == "dir" \
        else f"sqlite://{tmp_path}/cas.db"
    if writer == "jax":
        w = _jax_session(jcore.open_store(uri))
        cids, snaps = _drive(w, _jax_cells())
    else:
        w = _torch_session(tcore.open_store(uri))
        cids, snaps = _drive(w, _torch_cells())
    w.close()
    if writer == "jax":
        r = _torch_session(tcore.open_store(uri))
    else:
        r = _jax_session(jcore.open_store(uri))
    assert set(cids) <= set(r.graph.nodes)
    r.records, _ = r.loader.materialize_state(r.tracked, cids[0])
    r.covs = (tcore if writer == "jax" else jcore) \
        .group_covariables(r.records)
    assert _snapshot(r) == snaps[cids[0]]
    patched = 0
    for cid in cids[1:] + [cids[2], cids[0]]:
        patched += r.checkout(cid).covs_patched
        assert _snapshot(r) == snaps[cid]
    assert patched > 0
    r.close()


def test_device_defaults_and_unported_paths(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcore.KishuSession(tcore.MemoryStore())
    # the planner and the fabric, once placeholders that raised, open
    s = tcore.KishuSession(tcore.MemoryStore(), device="cpu",
                           plan_mode="auto")
    assert s.plan_mode == "auto" and s.loader.planner is s.planner
    s.close()
    fab = tcore.open_store("fabric://shard(memory://,memory://)")
    assert isinstance(fab, tcore.ShardedStore) and len(fab.shards) == 2
    s = tcore.KishuSession(fab, device="cpu", plan_mode="off")
    assert s.device == torch.device("cpu") and s.loader.planner is None
    s.close()


def test_interop_defaults_to_cuda():
    """``to_torch`` puts state on the card unless the caller names the CPU,
    as the session does; with no card the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    tree = {"a": np.arange(6, dtype=np.float32), "n": 3}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        to_torch(tree)
    out = to_torch(tree, "cpu")
    assert out["a"].device == torch.device("cpu") and out["n"] == 3


def _patch_session():
    """A session whose checkout back chunk-patches one tensor."""
    sess = _torch_session(tcore.MemoryStore())

    def init(ns):
        ns["base"] = torch.arange(6000, dtype=torch.float32)

    def bump(ns):
        ns["base"][::1997] = -1.0          # 4 of 6 chunks

    sess.register("init", init)
    sess.register("bump", bump)
    sess.init_state({})
    c0 = sess.run("init")
    sess.run("bump")
    return sess, c0


def test_tensor_patch_failure_raises(monkeypatch):
    """A tensor patch runs its scatter or raises: a failure is never hidden
    behind a host reload of the co-variable."""
    from repro_torch.kernels.patch_scatter import ops as scatter_ops

    def broken(*args, **kwargs):
        raise RuntimeError("injected scatter failure")

    sess, c0 = _patch_session()
    monkeypatch.setattr(scatter_ops, "patch_scatter_plain", broken)
    with pytest.raises(RuntimeError, match="injected scatter failure"):
        sess.checkout(c0)
    monkeypatch.undo()
    st = sess.checkout(c0)
    assert st.covs_scattered == 1 and st.kernel_fallbacks == 0
    assert torch.equal(sess.ns["base"], torch.arange(6000,
                                                     dtype=torch.float32))
    sess.close()


# ---------------------------------------------------------------------------
# the reference session's behaviours (tests/test_session.py) on tensors
# ---------------------------------------------------------------------------

@pytest.fixture
def tsess():
    s = tcore.KishuSession(tcore.MemoryStore(), chunk_bytes=1 << 12,
                           device="cpu")

    def make_data(ns, n):
        g = torch.Generator().manual_seed(int(ns["seed"]))
        ns["data/x"] = torch.randn((n, 8), generator=g)
        ns["data/step"] = 0

    def train(ns, steps):
        x, w = ns["data/x"], ns["model/w"]
        for _ in range(steps):
            w.sub_(0.01 * (x.T @ (x @ w)) / len(x))     # in place
            ns["data/step"] = ns["data/step"] + 1

    s.register("make_data", make_data)
    s.register("train", train)
    s.init_state({"seed": 7, "model": {"w": torch.ones((8, 4))}})
    s.run("make_data", n=32)
    yield s
    s.close()


def test_undo_exact_in_place(tsess):
    c1 = tsess.run("train", steps=3)
    w1 = tsess.ns["model/w"].clone()
    tsess.run("train", steps=4)
    st = tsess.checkout(c1)
    assert torch.equal(tsess.ns["model/w"], w1)
    assert st.covs_loaded >= 1 and st.covs_identical >= 1


def test_identical_covs_not_reloaded(tsess):
    c1 = tsess.run("train", steps=1)
    tsess.run("train", steps=1)
    x_obj = tsess.ns["data/x"]
    st = tsess.checkout(c1)
    assert tsess.ns["data/x"] is x_obj
    assert st.bytes_loaded < x_obj.numel() * 4 + 1000


def test_branch_switching(tsess):
    c1 = tsess.run("train", steps=2)
    wa = tsess.ns["model/w"].clone()
    tsess.checkout(tsess.graph.nodes[c1].parent)
    tsess.run("train", steps=5)
    assert not torch.allclose(wa, tsess.ns["model/w"])
    tsess.checkout(c1)
    assert torch.equal(tsess.ns["model/w"], wa)


def test_opaque_skip_and_replay():
    s = tcore.KishuSession(tcore.MemoryStore(), device="cpu")

    def put(ns):
        ns["payload"] = torch.full((4,), float(ns["counter"]))
        ns["gen"] = tcore.OpaqueLeaf(payload=int(ns["counter"]))

    def bump(ns):
        ns["counter"] = ns["counter"] + 1
        ns["gen"] = tcore.OpaqueLeaf(payload=int(ns["counter"]))

    s.register("put", put)
    s.register("bump", bump)
    s.init_state({"counter": 0})
    s.run("put")
    c2 = s.run("bump")
    s.run("bump")
    st = s.checkout(c2)
    assert s.ns["gen"].payload == 1
    assert st.covs_recomputed >= 1
    s.close()


def test_recursive_fallback_on_tensors():
    """A missing co-variable whose dependency is missing too: recursive
    replay, with tensor values copied before a replay can mutate them."""
    store = tcore.MemoryStore()
    s = tcore.KishuSession(store, chunk_bytes=1 << 10, cache_bytes=0,
                           device="cpu")

    def stage1(ns):
        ns["a"] = torch.full((2000,), 1.0)

    def stage2(ns):
        ns["b"] = ns["a"] * 2

    def stage3(ns):
        ns["c"] = ns["b"] + 1
        ns["b"].add_(10.0)                   # mutates its input in place

    def clobber(ns):
        ns["b"] = torch.zeros(1)
        ns["c"] = torch.zeros(1)

    for n, f in [("s1", stage1), ("s2", stage2), ("s3", stage3),
                 ("clobber", clobber)]:
        s.register(n, f)
    s.init_state({})
    s.run("s1")
    c2 = s.run("s2")
    c3 = s.run("s3")
    for key, ver in [(("b",), c2), (("c",), c3)]:
        for ch in s.graph.manifest_of(key, ver)["base"]["chunks"]:
            store.delete_chunk(ch["key"])
    s.run("clobber")
    s.checkout(c3)
    assert float(s.ns["c"][0]) == 3.0 and float(s.ns["b"][0]) == 12.0
    assert s.restorer.replays >= 2
    s.close()


def test_delete_branch_and_gc(tsess):
    base = tsess.head
    tip = tsess.run("train", steps=2)
    tsess.checkout(base)
    tsess.run("train", steps=1)
    before = tsess.store.n_chunks()
    assert tsess.delete_branch(tip) == [tip]
    out = tsess.gc()
    assert out["chunks_dropped"] >= 1
    assert tsess.store.n_chunks() == before - out["chunks_dropped"]


def test_async_writer_commits_restore(tmp_path):
    s = tcore.KishuSession(tcore.open_store(f"sqlite://{tmp_path}/a.db"),
                           chunk_bytes=1 << 12, async_write=True,
                           device="cpu")

    def fill(ns, v):
        ns["t"] = torch.full((5000,), float(v))
    s.register("fill", fill)
    s.init_state({})
    cids = [s.run("fill", v=v) for v in range(4)]
    for i, cid in enumerate(cids):
        s.checkout(cid)
        assert torch.equal(s.ns["t"], torch.full((5000,), float(i)))
    s.close()
