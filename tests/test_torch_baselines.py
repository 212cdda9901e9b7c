"""The port's baselines (DumpSession, PageIncremental, DetReplay) on
``device="cpu"``, held against the JAX package's: with jax present, the
same state through both writes byte-identical dump blobs and the same
page keys, and each package's dump reads back in the other."""
import numpy as np
import pytest
import torch

from repro_torch.core import MemoryStore, Namespace, OpaqueLeaf
from repro_torch.core.baselines import (DetReplaySession, DumpSession,
                                        PageIncremental)


def _ns(**kw):
    ns = Namespace()
    for k, v in kw.items():
        ns[k] = v
    return ns


def test_dumpsession_roundtrip():
    d = DumpSession(MemoryStore(), device="cpu")
    ns = _ns(a=torch.arange(10, dtype=torch.float32), b=np.ones(5),
             h=torch.arange(7, dtype=torch.bfloat16), step=3)
    st = d.checkpoint(ns, "t1")
    assert not st.failed and st.bytes_written > 0
    ns["a"] = ns["a"] * 3
    ns["step"] = 4
    st = d.checkout(ns, "t1")
    assert st.bytes_loaded == d.stats[0].bytes_written
    assert isinstance(ns["a"], torch.Tensor) and ns["a"].device.type == "cpu"
    assert torch.equal(ns["a"], torch.arange(10, dtype=torch.float32))
    assert torch.equal(ns["h"], torch.arange(7, dtype=torch.bfloat16))
    assert isinstance(ns["b"], np.ndarray) and ns["step"] == 3


def test_dumpsession_fails_on_opaque():
    d = DumpSession(MemoryStore(), device="cpu")
    st = d.checkpoint(_ns(g=OpaqueLeaf()), "t1")
    assert st.failed


def test_baselines_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    for cls in (DumpSession, PageIncremental):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(MemoryStore())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DetReplaySession(MemoryStore())


def test_page_incremental_stores_only_dirty_pages():
    p = PageIncremental(MemoryStore(), device="cpu")
    ns = _ns(big=torch.zeros(1 << 16, dtype=torch.uint8),
             small=torch.zeros(16, dtype=torch.uint8))
    st1 = p.checkpoint(ns, "t1", parent=None)
    ns["small"] = ns["small"] + 1
    st2 = p.checkpoint(ns, "t2", parent="t1")
    assert st2.bytes_written < st1.bytes_written / 4
    ns["small"] = ns["small"] * 0
    p.checkout(ns, "t2")
    assert int(ns["small"][0]) == 1
    p.checkout(ns, "t1")
    assert int(ns["small"][0]) == 0


def test_page_incremental_fragmentation_hurts():
    p = PageIncremental(MemoryStore(), device="cpu")
    g = torch.Generator().manual_seed(0)
    arrs = {f"k{i:02d}": torch.randint(0, 256, (3000,), generator=g,
                                       dtype=torch.uint8)
            for i in range(20)}
    ns = _ns(**arrs)
    p.checkpoint(ns, "t1", parent=None)
    ns["k10"] = ns["k10"] ^ 1
    st = p.checkpoint(ns, "t2", parent="t1")
    inplace_bytes = st.bytes_written
    ns["k00"] = torch.randint(0, 256, (3001,), generator=g,
                              dtype=torch.uint8)
    st = p.checkpoint(ns, "t3", parent="t2")
    assert st.bytes_written > 5 * inplace_bytes


def test_detreplay_skips_storage_and_replays():
    s = DetReplaySession(MemoryStore(), device="cpu")

    def det_step(ns):
        ns["w"] = ns["w"] * 2.0
    s.register("det_step", det_step, deterministic=True)
    s.init_state({"w": torch.ones(1000)})
    base_bytes = s.store.chunk_bytes_total()
    c1 = s.run("det_step")
    assert s.store.chunk_bytes_total() == base_bytes
    s.run("det_step")
    s.checkout(c1)
    assert float(s.ns["w"][0]) == 2.0 and s.ns["w"].device.type == "cpu"
    assert s.restorer.replays >= 1


# ---------------------------------------------------------------------------
# cross-package: the same bytes as the JAX package's baselines
# ---------------------------------------------------------------------------

def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"emb": rng.standard_normal((300, 64)).astype(np.float32),
            "ids": rng.integers(0, 1000, 4001).astype(np.int32),
            "host": rng.integers(-2**40, 2**40, 999),
            "step": 7}


def _both(jnp):
    st = _state()
    jns, tns = Namespace(), Namespace()
    for k, v in st.items():
        if k in ("emb", "ids"):
            jns[k] = jnp.asarray(v)
            tns[k] = torch.from_numpy(v.copy())
        else:
            jns[k] = v.copy() if isinstance(v, np.ndarray) else v
            tns[k] = v.copy() if isinstance(v, np.ndarray) else v
    return jns, tns


def test_dump_blobs_byte_identical_and_cross_readable():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import MemoryStore as JMemoryStore
    from repro.core.baselines import DumpSession as JDump
    jns, tns = _both(jnp)
    js, ts = JMemoryStore(), MemoryStore()
    jd, td = JDump(js), DumpSession(ts, device="cpu")
    jd.checkpoint(jns, "t1")
    td.checkpoint(tns, "t1")
    assert js.chunks == ts.chunks and js.meta == ts.meta
    # each package restores the other's dump
    JDump(ts).checkout(jns, "t1")
    DumpSession(js, device="cpu").checkout(tns, "t1")
    assert np.asarray(jns["emb"]).tobytes() \
        == tns["emb"].numpy().tobytes() == _state()["emb"].tobytes()
    assert isinstance(tns["ids"], torch.Tensor)


def test_page_keys_identical_to_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import MemoryStore as JMemoryStore
    from repro.core.baselines import PageIncremental as JPages
    jns, tns = _both(jnp)
    js, ts = JMemoryStore(), MemoryStore()
    jp, tp = JPages(js), PageIncremental(ts, device="cpu")
    for tag, parent in (("t1", None), ("t2", "t1"), ("t3", "t2")):
        jst = jp.checkpoint(jns, tag, parent=parent)
        tst = tp.checkpoint(tns, tag, parent=parent)
        assert jst.bytes_written == tst.bytes_written
        assert jp._images[tag] == tp._images[tag]
        jns["emb"] = jns["emb"].at[5].set(float(len(tag)))
        tns["emb"][5] = float(len(tag))
        jns["step"] = tns["step"] = len(tag) + (parent is not None)
    assert js.chunks == ts.chunks
    for tag in ("t2", "t1"):
        jp.checkout(jns, tag)
        tp.checkout(tns, tag)
        assert np.asarray(jns["emb"]).tobytes() \
            == tns["emb"].numpy().tobytes()
