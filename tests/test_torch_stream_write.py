"""The full-serialize path's staging ring (``core/staging.py``): a base
streamed segment by segment — copied once into each chunk's ``bytes`` and
keyed as it lands — gives the manifest and the stored chunks of the
``leaf_to_bytes`` + slice path, and of the JAX package's writer.

The writer's ring takes CUDA tensors; these tests run the same code path
on the CPU through a ring whose staging is plain host memory (the card
test in ``test_torch_cuda.py`` streams through pinned staging).  Segments
are shrunk to a few small chunks, so a base of tens of chunks cycles
through the ring's slots several times.  A DTensor, on one and on two
gloo ranks, streams its global image.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import KishuSession, MemoryStore, staging  # noqa: E402
from repro_torch.core.checkpoint import (WriteStats,  # noqa: E402
                                         build_manifest)
from repro_torch.core.chunkstore import chunk_key  # noqa: E402
from repro_torch.core.covariable import RecordBuilder  # noqa: E402
from repro_torch.core.namespace import Namespace  # noqa: E402
from repro_torch.interop import array_to_tensor  # noqa: E402

CHUNK = 1024
SEG = 4 * CHUNK                 # four chunks a segment, 16 in the ring

DTYPES = ["bfloat16", "float32", "bool", "int64"]
# under one chunk; an exact multiple (one segment); a multiple plus a
# remainder; more chunks than the ring holds (slots reused)
SIZES = [512, 4096, 5128, 41000]


@pytest.fixture(autouse=True)
def small_segments(monkeypatch):
    monkeypatch.setattr(staging, "SEG_BYTES", SEG)


def _raw(nbytes, dtype, seed=0):
    raw = np.random.default_rng(seed).integers(0, 256, nbytes,
                                               dtype=np.uint8)
    return raw & 1 if dtype == "bool" else raw


def _tensor(raw, dtype):
    t = torch.from_numpy(raw.copy())
    return t.view(torch.bool) if dtype == "bool" else \
        t.view(getattr(torch, dtype))


def _write(t, ring, store=None, chunk=CHUNK):
    """One co-variable ``x`` = ``t`` through build_manifest, no previous
    manifest (so the full path): the manifest, the store and the stats."""
    store = store if store is not None else MemoryStore()
    rec = RecordBuilder(chunk).build("x", t, {})
    stats = WriteStats()
    man = build_manifest(store, ("x",), [rec], Namespace({"x": t}), chunk,
                         None, stats, store.put_chunk, ring=ring)
    return man, store, stats


def _both(t, **kw):
    old = _write(t, None, **kw)
    new = _write(t, staging.StagingRing("cpu"), **kw)
    return old, new


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nbytes", SIZES)
def test_streamed_manifest_and_chunks_equal_the_blob_path(dtype, nbytes):
    t = _tensor(_raw(nbytes, dtype, seed=nbytes), dtype)
    (m0, s0, w0), (m1, s1, w1) = _both(t)
    assert m1 == m0
    assert s1.chunks == s0.chunks
    n_chunks = -(-nbytes // CHUNK)
    assert len(m1["base"]["chunks"]) == n_chunks
    assert (w1.covs_streamed, w1.bytes_streamed) == (1, nbytes)
    assert (w0.covs_streamed, w0.bytes_streamed) == (0, 0)
    for k in ("bytes_serialized", "bytes_logical", "bytes_written",
              "chunks_written", "chunks_dedup", "chunks_reused"):
        assert getattr(w1, k) == getattr(w0, k), k
    # each stored chunk is an exact bytes: the store keeps what streamed
    assert all(type(v) is bytes for v in s1.chunks.values())


def test_non_contiguous_base_streams_its_c_order_image():
    src = torch.from_numpy(_raw(96 * 40 * 4, "float32", 3)) \
        .view(torch.float32).reshape(40, 96)
    t = torch.empty_strided((96, 40), (1, 96), dtype=torch.float32)
    t.copy_(src.t())
    assert not t.is_contiguous() and t._base is None
    (m0, s0, _), (m1, s1, w1) = _both(t)
    assert m1 == m0 and s1.chunks == s0.chunks
    assert w1.bytes_streamed == t.numel() * 4
    joined = b"".join(s1.chunks[c["key"]] for c in m1["base"]["chunks"])
    assert joined == t.contiguous().numpy().tobytes()


def test_a_chunk_already_stored_counts_as_dedup():
    t = torch.from_numpy(_raw(9 * CHUNK + 100, "uint8", 5))
    third = t.numpy()[2 * CHUNK:3 * CHUNK].tobytes()
    stores = []
    for _ in range(2):
        st = MemoryStore()
        st.put_chunk(chunk_key(third), third)
        stores.append(st)
    m0, s0, w0 = _write(t, None, store=stores[0])
    m1, s1, w1 = _write(t, staging.StagingRing("cpu"), store=stores[1])
    assert m1 == m0 and s1.chunks == s0.chunks
    assert w1.chunks_dedup == w0.chunks_dedup == 1
    assert w1.chunks_written == w0.chunks_written == 9


def test_repeated_chunks_within_a_base_dedup_in_order():
    t = torch.zeros(20 * CHUNK + 8, dtype=torch.uint8)
    (m0, s0, w0), (m1, s1, w1) = _both(t)
    assert m1 == m0 and s1.chunks == s0.chunks
    # the full chunks are one chunk; the short last one is another
    assert w1.chunks_written == w0.chunks_written == 2
    assert w1.chunks_dedup == w0.chunks_dedup == 19


def test_unchanged_chunks_are_reused_not_streamed_again():
    """With the dirty-range path off, the full path still references the
    chunks whose detection hash is unchanged, streamed or not."""
    raw = _raw(12 * CHUNK, "uint8", 7)
    t0 = torch.from_numpy(raw.copy())
    t1 = t0.clone()
    t1[5 * CHUNK + 3] ^= 1
    outs = []
    for ring in (None, staging.StagingRing("cpu")):
        store = MemoryStore()
        rb = RecordBuilder(CHUNK)
        r0 = rb.build("x", t0, {})
        man0 = build_manifest(store, ("x",), [r0], Namespace({"x": t0}),
                              CHUNK, None, WriteStats(), store.put_chunk,
                              ring=ring)
        r1 = rb.build("x", t1, {}, prev=r0)
        st = WriteStats()
        man1 = build_manifest(store, ("x",), [r1], Namespace({"x": t1}),
                              CHUNK, man0, st, store.put_chunk,
                              delta_ranges=False, ring=ring)
        outs.append((man1, store.chunks, st))
    (m0, c0, w0), (m1, c1, w1) = outs
    assert m1 == m0 and c1 == c0
    assert w1.chunks_reused == w0.chunks_reused == 11
    assert w1.chunks_written == w0.chunks_written == 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nbytes", [512, 41000])
def test_streamed_manifest_equals_the_jax_writer(dtype, nbytes):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import MemoryStore as JMemoryStore
    from repro.core import Namespace as JNamespace
    from repro.core import RecordBuilder as JRecordBuilder
    from repro.core.checkpoint import WriteStats as JWriteStats
    from repro.core.checkpoint import build_manifest as jbuild_manifest

    raw = _raw(nbytes, dtype, seed=nbytes + 1)
    a = raw.view(np.bool_) if dtype == "bool" else raw.view(jnp.dtype(dtype))
    m1, s1, _ = _write(array_to_tensor(a, "cpu"), staging.StagingRing("cpu"))
    with jax.enable_x64(dtype == "int64"):
        x = jnp.asarray(a)
        assert str(x.dtype) == dtype
        store = JMemoryStore()
        rec = JRecordBuilder(CHUNK).build("x", x, {})
        m0 = jbuild_manifest(store, ("x",), [rec], JNamespace({"x": x}),
                             CHUNK, None, JWriteStats(), store.put_chunk)
    assert m1 == m0
    assert s1.chunks == store.chunks


def test_a_failed_hand_off_leaves_the_ring_usable():
    """A put that raises mid-stream propagates after the pool's tasks are
    drained; the same ring then streams the next commit correctly."""
    t = torch.from_numpy(_raw(30 * CHUNK, "uint8", 11))
    ring = staging.StagingRing("cpu")
    store = MemoryStore()
    calls = []

    def put(ck, data):
        calls.append(ck)
        if len(calls) == 7:
            raise OSError("injected put failure")
        store.put_chunk(ck, data)

    rec = RecordBuilder(CHUNK).build("x", t, {})
    with pytest.raises(OSError, match="injected"):
        build_manifest(store, ("x",), [rec], Namespace({"x": t}), CHUNK,
                       None, WriteStats(), put, ring=ring)
    m0, s0, _ = _write(t, None)
    m1, s1, _ = _write(t, ring)
    assert m1 == m0 and s1.chunks == s0.chunks


def test_many_workers_and_short_switch_interval(monkeypatch):
    """More pool threads than cores and a short switch interval: every
    slot is recycled only after its chunks were copied, so the chunks of a
    base 64 segments long still equal the blob path's."""
    monkeypatch.setenv("KISHU_IO_THREADS", "16")
    t = torch.from_numpy(_raw(256 * CHUNK + 77, "uint8", 13))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        (m0, s0, _), (m1, s1, w1) = _both(t)
    finally:
        sys.setswitchinterval(old)
    assert m1 == m0 and s1.chunks == s0.chunks
    assert w1.chunks_written == 257


@pytest.mark.parametrize("n", [1, 2, 3, 1023, 1 << 16])
def test_fill_bytes_copies_exactly_into_a_fresh_object(n):
    src = np.arange(n, dtype=np.uint32).astype(np.uint8)
    got = staging.empty_bytes(n)
    staging.fill_bytes(got, src.ctypes.data)
    assert type(got) is bytes and got == src.tobytes()
    again = staging.empty_bytes(n)
    staging.fill_bytes(again, src.ctypes.data)
    assert again == got and again is not got
    assert bytes([0]) == b"\x00" and bytes([1]) == b"\x01"


def test_session_counts_streamed_covs_and_bytes():
    """A session whose writer's ring takes CPU tensors: the commit's
    ``WriteStats`` and the session's counters say what streamed, and the
    write spans nest under ``serialize``; numpy leaves keep their path."""
    sess = KishuSession(MemoryStore(), chunk_bytes=CHUNK, device="cpu",
                        trace=True)
    sess.writer.ring = staging.StagingRing("cpu")

    def init(ns):
        ns["a"] = torch.arange(5000, dtype=torch.float32)     # 20 chunks
        ns["b"] = torch.ones(3, dtype=torch.int64)
        ns["h"] = np.arange(700, dtype=np.float64)

    sess.register("init", init)
    sess.init_state({})
    sess.run("init")
    w = sess.last_run.write
    assert (w.covs_streamed, w.bytes_streamed) == (2, 5000 * 4 + 3 * 8)
    reg = sess.obs.registry
    assert reg.counter_total("kishu_covs_streamed_total") == 2
    assert reg.counter_total("kishu_bytes_streamed_total") == 20024
    spans = list(sess.obs.tracer.spans)
    ser = {s.span_id for s in spans if s.name == "serialize"}
    whole = {s.span_id for s in spans
             if s.name == "write_whole" and s.parent_id in ser}
    for name in ("d2h", "chunk_keys", "enqueue"):
        mine = [s for s in spans if s.name == name]
        assert mine and all(s.parent_id in whole for s in mine), name
    sess.close()


DT_SHAPE = (300, 37)            # 44 chunks of float32, more than the ring


def _dtensor_rank(rank, world, raw, dtype):
    """On each gloo rank: the rows of ``raw`` (viewed as ``dtype``)
    sharded over a mesh of ``world``, written through the blob path and
    streamed through a CPU ring; each path's manifest, chunks and
    counters."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor
    staging.SEG_BYTES = SEG
    mesh = init_device_mesh("cpu", (world,))
    x = distribute_tensor(_tensor(raw, dtype).reshape(DT_SHAPE), mesh,
                          [Shard(0)])
    assert isinstance(x, DTensor)
    assert x.to_local().shape[0] == -(-DT_SHAPE[0] // world)
    out = []
    for m, s, w in _both(x):
        out.append((m, s.chunks, (w.covs_streamed, w.bytes_streamed,
                                  w.chunks_written, w.chunks_dedup)))
    return out


@pytest.mark.parametrize("world,dtype", [(1, "float32"), (1, "bfloat16"),
                                         (2, "float32")])
def test_a_dtensor_streams_its_global_image(world, dtype):
    """A DTensor base (gloo ranks) streams its global image: the same
    manifest and chunks as the blob path, as a plain tensor of the same
    values, and as the JAX package's writer."""
    from repro_torch.launch.mesh import run_local_ranks
    item = 2 if dtype == "bfloat16" else 4
    nbytes = DT_SHAPE[0] * DT_SHAPE[1] * item
    raw = _raw(nbytes, dtype, seed=world)
    ranks = run_local_ranks(_dtensor_rank, world, raw, dtype, timeout=120.0)
    plain, _, _ = _write(_tensor(raw, dtype).reshape(DT_SHAPE).clone(), None)
    for (m0, c0, w0), (m1, c1, w1) in ranks:
        assert m1 == m0 == plain
        assert c1 == c0
        assert w1[:2] == (1, nbytes) and w0[:2] == (0, 0)
        assert w1[2:] == w0[2:] and w1[2] == -(-nbytes // CHUNK)
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import MemoryStore as JMemoryStore
    from repro.core import Namespace as JNamespace
    from repro.core import RecordBuilder as JRecordBuilder
    from repro.core.checkpoint import WriteStats as JWriteStats
    from repro.core.checkpoint import build_manifest as jbuild_manifest
    x = jnp.asarray(raw.view(jnp.dtype(dtype)).reshape(DT_SHAPE))
    store = JMemoryStore()
    rec = JRecordBuilder(CHUNK).build("x", x, {})
    m = jbuild_manifest(store, ("x",), [rec], JNamespace({"x": x}), CHUNK,
                        None, JWriteStats(), store.put_chunk)
    assert ranks[0][1][0] == m and ranks[0][1][1] == store.chunks
