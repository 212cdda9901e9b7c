"""The port's plain torch kernel versions held against the JAX package.

Each plain version (what a CPU tensor runs, and what the CUDA kernel is held
against on the card) must agree bit for bit with its JAX counterpart: the
host spec ``hashing.chunk_hashes_np``, the jnp ``ref.py`` oracles, and the
Pallas kernels in interpret mode where the JAX tests already run them so.
8-byte dtypes are held against ``delta.patch_numpy_base`` and
``chunk_hashes_np`` only (the JAX x64 scatter tests are red on this tree).
"""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import delta as jdelta  # noqa: E402
from repro.core import hashing as jhash  # noqa: E402
from repro.kernels.chunk_hash.ops import chunk_hash_u64 as jchunk_hash_u64  # noqa: E402
from repro.kernels.delta_codec import host as jhost  # noqa: E402
from repro.kernels.delta_codec.kernel import codec_encode_pallas  # noqa: E402
from repro.kernels.delta_codec.ref import codec_encode_ref  # noqa: E402
from repro.kernels.delta_pack.kernel import delta_pack_pallas  # noqa: E402
from repro.kernels.delta_pack.ops import delta_pack as jdelta_pack  # noqa: E402
from repro.kernels.delta_pack.ref import delta_pack_ref  # noqa: E402
from repro.kernels.patch_scatter.ops import scatter_chunks as jscatter  # noqa: E402

from repro_torch.core import hashing as thash  # noqa: E402
from repro_torch.core.serialize import tensor_bytes_u8  # noqa: E402
from repro_torch.interop import array_to_tensor, tensor_to_array  # noqa: E402
from repro_torch.kernels.chunk_hash.ops import chunk_hash_u64  # noqa: E402
from repro_torch.kernels.delta_codec import host as thost  # noqa: E402
from repro_torch.kernels.delta_codec.ops import (codec_encode_plain,  # noqa: E402
                                                 encode_rows, i32_bits,
                                                 probe_device_rows,
                                                 u32_values)
from repro_torch.kernels.delta_pack.ops import (delta_pack,  # noqa: E402
                                                delta_pack_plain)
from repro_torch.kernels.patch_scatter.ops import scatter_chunks  # noqa: E402

DTYPES = ["float32", "bfloat16", "float16", "int32", "uint8", "bool"]
SHAPES = [(1,), (7,), (3, 5), (1001,), (4095,), (12289,), (20000,)]


def _array(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    if dtype == "bool":
        return (rng.random(n) < 0.5).reshape(shape)
    if dtype in ("uint8", "int32", "int64", "uint64"):
        return rng.integers(0, 200, n).astype(dtype).reshape(shape)
    np_dt = jnp.bfloat16 if dtype == "bfloat16" else dtype
    return rng.standard_normal(n).astype(np_dt).reshape(shape)


def _bytes(a):
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _words(a, cb):
    """Whole-chunk words and true byte counts, padded as the JAX wrapper
    pads (``delta_pack/ops.py``), for the kernel-level JAX functions."""
    raw = _bytes(a)
    n_chunks = max(-(-raw.size // cb), 1)
    padded = np.zeros(n_chunks * cb, np.uint8)
    padded[:raw.size] = raw
    nbytes = np.minimum(cb, raw.size - np.arange(n_chunks) * cb)
    return padded.view(np.uint32).reshape(n_chunks, cb // 4), \
        nbytes.astype(np.int32)


# ------------------------------------------------------------ chunk_hash

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cb", [4096, 16384])
def test_chunk_hash_plain_matches_spec(dtype, shape, cb):
    a = _array(dtype, shape, seed=len(shape) + cb)
    want = jhash.chunk_hashes_np(_bytes(a), cb)
    got = chunk_hash_u64(array_to_tensor(a, "cpu"), cb)
    assert got.dtype == np.uint64 and np.array_equal(got, want)
    # the copied spec is the spec
    assert np.array_equal(thash.chunk_hashes_np(_bytes(a), cb), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
def test_chunk_hash_plain_matches_jax_kernel(dtype):
    """The JAX wrapper pads to whole chunks; the plain version hashes the
    bytes as they are — both through the jnp oracle and the Pallas kernel
    (interpret mode)."""
    a = _array(dtype, (3000,), seed=3)
    got = chunk_hash_u64(array_to_tensor(a, "cpu"), 4096)
    for backend, kw in (("ref", {}), ("pallas", {"interpret": True})):
        want = jchunk_hash_u64(jnp.asarray(a), 4096, backend=backend, **kw)
        assert np.array_equal(got, want), backend


@pytest.mark.parametrize("dtype", ["int64", "uint64", "float64"])
def test_chunk_hash_plain_8byte(dtype):
    a = _array(dtype, (3001,), seed=8)
    assert np.array_equal(chunk_hash_u64(array_to_tensor(a, "cpu"), 4096),
                          jhash.chunk_hashes_np(_bytes(a), 4096))


def test_chunk_hash_empty_and_clamped():
    assert chunk_hash_u64(torch.zeros(0), 4096).shape == (0,)
    a = _array("float32", (10,))
    # a chunk far larger than the buffer hashes like the clamped spec
    assert np.array_equal(chunk_hash_u64(array_to_tensor(a, "cpu"), 1 << 20),
                          jhash.chunk_hashes_np(_bytes(a), 1 << 20))


# ------------------------------------------------------------ delta_pack

def _mutated(a, rng, n_points):
    b = a.copy().reshape(-1)
    idx = rng.integers(0, b.size, n_points)
    b[idx] = b[(idx + 1) % b.size]
    b[idx[:1]] = np.asarray(1, b.dtype) if b.dtype != bool else ~b[idx[:1]]
    return b.reshape(a.shape)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,cb,points", [
    (20000, 4096, 3), (20001, 4096, 0), (3000, 4096, 2), (50000, 16384, 40),
])
def test_delta_pack_plain_matches_ref(dtype, n, cb, points):
    rng = np.random.default_rng(n + points)
    a0 = _array(dtype, (n,), seed=n)
    a1 = _mutated(a0, rng, points)
    prev = jhash.chunk_hashes_np(_bytes(a0), cb)
    words, nbytes = _words(a1, cb)
    prev32 = jhash.split_u64(prev)
    jh, jd, jpos, jcount, jbuf = delta_pack_ref(
        jnp.asarray(words), jnp.asarray(prev32), jnp.asarray(nbytes))
    th, td, tpos, tcount, tbuf = delta_pack_plain(
        tensor_bytes_u8(array_to_tensor(a1, "cpu")),
        torch.from_numpy(prev32.astype(np.int64)), cb)
    assert np.array_equal(th.numpy(), np.asarray(jh).astype(np.int64))
    assert np.array_equal(td.numpy(), np.asarray(jd).reshape(-1))
    assert np.array_equal(tpos.numpy(), np.asarray(jpos).reshape(-1))
    assert tcount == int(np.asarray(jcount)[0, 0])
    assert np.array_equal(tbuf.numpy(),
                          np.asarray(jbuf)[:tcount].astype(np.int64))


def test_delta_pack_plain_matches_pallas_interpret():
    rng = np.random.default_rng(11)
    a0 = _array("float32", (9000,), seed=1)
    a1 = _mutated(a0, rng, 4)
    prev = jhash.chunk_hashes_np(_bytes(a0), 4096)
    words, nbytes = _words(a1, 4096)
    prev32 = jhash.split_u64(prev)
    jh, jd, jpos, jcount, jbuf = delta_pack_pallas(
        jnp.asarray(words), jnp.asarray(prev32), jnp.asarray(nbytes),
        interpret=True)
    th, td, tpos, tcount, tbuf = delta_pack_plain(
        tensor_bytes_u8(array_to_tensor(a1, "cpu")),
        torch.from_numpy(prev32.astype(np.int64)), 4096)
    assert tcount == int(np.asarray(jcount)[0, 0]) > 0
    assert np.array_equal(th.numpy(), np.asarray(jh).astype(np.int64))
    assert np.array_equal(tpos.numpy(), np.asarray(jpos).reshape(-1))
    assert np.array_equal(tbuf.numpy(),
                          np.asarray(jbuf)[:tcount].astype(np.int64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8", "bool"])
def test_delta_pack_wrapper_matches_jax_wrapper(dtype):
    """Hashes, dirty set and the dirty chunks' bytes, raw and encoded, as
    the JAX wrapper (jnp backend) yields them."""
    rng = np.random.default_rng(5)
    a0 = _array(dtype, (30001,), seed=2)
    a1 = _mutated(a0, rng, 5)
    a1.reshape(-1)[12000:20000] = 0                     # compressible run
    prev = jhash.chunk_hashes_np(_bytes(a0), 4096)
    tp = delta_pack(array_to_tensor(a1, "cpu"), prev, 4096)
    assert np.array_equal(tp.hashes, jhash.chunk_hashes_np(_bytes(a1), 4096))
    if dtype != "bool":         # the JAX device path cannot bitcast bool
        jp = jdelta_pack(jnp.asarray(a1), prev, 4096, backend="ref")
        assert np.array_equal(tp.hashes, jp.hashes)
        assert np.array_equal(tp.dirty, jp.dirty)
        assert list(tp.read_chunks()) == list(jp.read_chunks())
        assert list(tp.read_chunks_encoded()) == \
            list(jp.read_chunks_encoded())
    raw = _bytes(a1).tobytes()
    for ci, data in tp.read_chunks():
        assert data == raw[ci * 4096:(ci + 1) * 4096]


def test_delta_pack_rejects_bad_prev():
    t = torch.zeros(5000)
    with pytest.raises(ValueError):
        delta_pack(t, np.zeros(3, np.uint64), 4096)


# ------------------------------------------------------------ codec

def _codec_rows(r, w, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 12, (r, w)).astype(np.uint32)
    rows[:, : w // 4] = 0                       # all-zero planes
    rows[0, w // 2:] = 0xFFFFFFFF               # all-one planes
    return rows


@pytest.mark.parametrize("r,w", [(1, 32), (3, 1024), (2, 4096), (5, 64)])
def test_codec_plain_matches_ref(r, w):
    rows = _codec_rows(r, w, seed=r * w)
    gw = min(1024, w)
    jm, jc, jp = codec_encode_ref(jnp.asarray(rows), gw=gw)
    tm, tc, tp = codec_encode_plain(torch.from_numpy(rows.astype(np.int64)),
                                    gw)
    assert tc == int(np.asarray(jc)[0, 0])
    assert np.array_equal(tm.numpy(), np.asarray(jm).astype(np.int64))
    assert np.array_equal(tp.numpy(), np.asarray(jp)[:tc].astype(np.int64))


def test_codec_plain_matches_pallas_interpret():
    rows = _codec_rows(2, 1024, seed=4)
    jm, jc, jp = codec_encode_pallas(jnp.asarray(rows), gw=1024,
                                     interpret=True)
    tm, tc, tp = codec_encode_plain(torch.from_numpy(rows.astype(np.int64)),
                                    1024)
    assert tc == int(np.asarray(jc)[0, 0])
    assert np.array_equal(tm.numpy(), np.asarray(jm).astype(np.int64))
    assert np.array_equal(tp.numpy(), np.asarray(jp)[:tc].astype(np.int64))


@pytest.mark.parametrize("w,lens", [(1024, [4096, 4096, 1000]),
                                    (64, [256, 3]), (4096, [16384])])
def test_encode_rows_frames_match_host(w, lens):
    rows = _codec_rows(len(lens), w, seed=w)
    for r, n in enumerate(lens):
        rows.reshape(len(lens), -1).view(np.uint8)[r, n:] = 0
    masks, planes, gw = encode_rows(i32_bits(torch.from_numpy(
        rows.astype(np.int64))))
    frames = thost.frames_from_encoded(
        masks, planes.numpy().view(np.uint32), w // gw, gw, lens)
    for r, n in enumerate(lens):
        data = rows[r].tobytes()[:n]
        want = jhost.make_frame(jhost.bitplane_compress(data, gw), n)
        assert frames[r] == want
        assert thost.bitplane_decompress(frames[r][thost._FRAME_HDR:]) \
            == data


def test_probe_matches_host_estimate():
    rows = np.random.default_rng(9).integers(0, 1 << 12, (4, 1024)) \
        .astype(np.uint32)                      # 12 of 32 planes vary
    noisy = np.random.default_rng(1).integers(0, 2**32, (4, 1024),
                                              dtype=np.uint64) \
        .astype(np.uint32)
    for r, want in ((rows, True), (noisy, False)):
        t = i32_bits(torch.from_numpy(r.astype(np.int64)))
        assert probe_device_rows(t) is want
    assert np.array_equal(u32_values(i32_bits(torch.tensor([0, 2**32 - 1,
                                                            2**31]))).numpy(),
                          [0, 2**32 - 1, 2**31])


# ------------------------------------------------------------ patch_scatter

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16",
                                   "int32", "uint8", "bool"])
@pytest.mark.parametrize("n,cb,dirty", [
    (4096, 1024, [0, 3]), (1001, 256, [3]), (1001, 256, [0, 1]),
    (100, 1024, [0]), (20000, 4096, [0, 2, 4])])
def test_scatter_plain_matches_ref(dtype, n, cb, dirty):
    rng = np.random.default_rng(n + len(dirty))
    a = _array(dtype, (n,), seed=n)
    nbytes = a.nbytes
    dirty = [i for i in dirty if i * cb < nbytes]
    blobs = [rng.integers(0, 256, min(cb, nbytes - i * cb), dtype=np.uint8)
             .tobytes() for i in dirty]
    if dtype == "bool":
        blobs = [bytes(b & 1 for b in blob) for blob in blobs]
    t = array_to_tensor(a, "cpu")
    keep = t.view(-1)[:1]                       # a live alias
    moved = scatter_chunks(t, dirty, blobs, cb)
    assert moved >= sum(len(b) for b in blobs)
    want = jdelta.patch_numpy_base(_bytes(a).copy(),   # bf16: no buffer
                                   [(i * cb, b) for i, b in zip(dirty, blobs)])
    assert tensor_to_array(t).tobytes() == want.tobytes()
    assert keep.data_ptr() == t.data_ptr()
    if dtype != "bool":         # the JAX scatter cannot bitcast bool
        got, _ = jscatter(jnp.asarray(a), dirty, blobs, cb, backend="ref")
        assert np.asarray(got).tobytes() == want.tobytes()


def test_scatter_plain_matches_pallas_interpret():
    a = _array("float32", (3000,), seed=7)
    blobs = [bytes(range(256)) * 16, bytes(12000 - 8192)]
    got, _ = jscatter(jnp.asarray(a), [0, 2], blobs, 4096, backend="pallas",
                      interpret=True)
    t = array_to_tensor(a, "cpu")
    scatter_chunks(t, [0, 2], blobs, 4096)
    assert tensor_to_array(t).tobytes() == np.asarray(got).tobytes()


@pytest.mark.parametrize("dtype", ["int64", "uint64", "float64"])
def test_scatter_plain_8byte(dtype):
    a = _array(dtype, (2001,), seed=3)
    blobs = [bytes(range(256)) * 16, bytes(16008 - 12288)]
    t = array_to_tensor(a, "cpu")
    scatter_chunks(t, [1, 3], blobs, 4096)
    want = jdelta.patch_numpy_base(a.copy(), [(4096, blobs[0]),
                                              (12288, blobs[1])])
    assert tensor_to_array(t).tobytes() == want.tobytes()


def test_scatter_rejects_bad_chunks():
    t = torch.zeros(3000)
    with pytest.raises(ValueError):
        scatter_chunks(t, [3], [bytes(4096)], 4096)          # out of range
    with pytest.raises(ValueError):
        scatter_chunks(t, [2], [bytes(4096)], 4096)          # short tail
    with pytest.raises(ValueError):
        scatter_chunks(t.view(100, 30).t(), [0], [bytes(4096)], 4096)


# ------------------------------------------------------------ interop

@pytest.mark.parametrize("dtype", DTYPES + ["int64", "float64"])
def test_interop_roundtrip(dtype):
    a = _array(dtype, (3, 7), seed=1)
    t = array_to_tensor(a, "cpu")
    assert t._base is None and tuple(t.shape) == (3, 7)
    back = tensor_to_array(t)
    assert back.dtype == a.dtype and back.tobytes() == a.tobytes()
