"""The port's host paths of a commit and a checkout, held against the JAX
package's, on the CPU.

- The host bit-plane codec (``kernels/delta_codec/host.py``) transposes
  its 32 x 32 bit matrices in five vectorised butterfly stages; its
  ``plane_split`` / ``plane_join`` and ``bitplane_decompress``, and the
  one-pass decode of a whole device-encoded buffer of rows
  (``words_from_planes``, which the commit uses to key those chunks),
  must equal the JAX package's loop versions byte for byte, on random and
  structured frames, with ragged final chunks.
- ``chunkstore.chunk_keys`` (keys hashed on the pool in groups) equals
  ``chunk_key`` one buffer at a time.
- ``serialize.tensor_from_bytes`` copies a byte image (bytes, a numpy
  array, or a manifest's chunks laid end to end) once on the host (into
  pinned memory on a card, straight into the tensor here): the same bytes,
  dtypes and shapes as the per-call copy it replaces.
"""
import numpy as np
import pytest

from _hypothesis_compat import given, settings, st

pytest.importorskip("torch")

import torch  # noqa: E402

from repro.kernels.delta_codec import host as jhost  # noqa: E402
from repro_torch.core import chunkstore  # noqa: E402
from repro_torch.core import serialize as tser  # noqa: E402
from repro_torch.kernels.delta_codec import host as thost  # noqa: E402
from repro_torch.kernels.delta_codec.ops import codec_encode_plain  # noqa: E402


def _structured(kind: str, n_bytes: int, seed: int) -> bytes:
    """Chunk contents a notebook holds: small floats, zeroed rows, small
    ints, a mask, and noise."""
    rng = np.random.default_rng(seed)
    n = -(-n_bytes // 4)
    if kind == "floats":
        w = rng.normal(0, 1e-3, n).astype(np.float32)
    elif kind == "zeros_tail":
        w = rng.normal(size=n).astype(np.float32)
        w[n // 3:] = 0
    elif kind == "small_ints":
        w = rng.integers(-8, 8, n).astype(np.int32)
    elif kind == "ones":
        w = np.full(n, 0xFFFFFFFF, np.uint32)
        w[::7] = 0
    else:
        w = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    return w.tobytes()[:n_bytes]


@pytest.mark.parametrize("gw", [32, 64, 256, 1024])
@pytest.mark.parametrize("ng", [0, 1, 3, 16])
def test_plane_split_and_join_match_jax(gw, ng):
    rng = np.random.default_rng(gw + ng)
    groups = rng.integers(0, 2 ** 32, (ng, gw),
                          dtype=np.uint64).astype(np.uint32)
    before = groups.copy()
    planes = thost.plane_split(groups)
    assert planes.dtype == np.dtype("<u4")
    assert np.array_equal(planes, jhost.plane_split(groups))
    assert np.array_equal(groups, before)              # input untouched
    assert np.array_equal(thost.plane_join(planes), jhost.plane_join(planes))
    assert np.array_equal(thost.plane_join(planes), groups)


def test_transpose32_is_its_own_inverse():
    rng = np.random.default_rng(9)
    a = rng.integers(0, 2 ** 32, (5, 32, 3), dtype=np.uint64) \
        .astype(np.uint32)
    b = thost.transpose32(a)
    assert np.array_equal(thost.transpose32(b), a)
    for r, c in ((0, 0), (3, 17), (31, 5)):            # bit c of b[r] is
        got = (b[:, r, :] >> np.uint32(c)) & 1          # bit r of a[c]
        want = (a[:, c, :] >> np.uint32(r)) & 1
        assert np.array_equal(got, want)


KINDS = ["floats", "zeros_tail", "small_ints", "ones", "noise"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n_bytes", [1, 255, 4096, 16381, 1 << 20,
                                     (1 << 20) - 5])
def test_bitplane_decompress_matches_jax(kind, n_bytes):
    data = _structured(kind, n_bytes, seed=n_bytes)
    for gw in (None, 32, 1024):
        payload = jhost.bitplane_compress(data, gw)
        assert thost.bitplane_compress(data, gw) == payload
        got = thost.bitplane_decompress(payload)
        assert got == jhost.bitplane_decompress(payload) == data


@settings(max_examples=60, deadline=None)
@given(kind=st.sampled_from(KINDS), n_bytes=st.integers(1, 70_000),
       gw_log2=st.integers(5, 10), seed=st.integers(0, 2 ** 16))
def test_bitplane_decompress_matches_jax_property(kind, n_bytes, gw_log2,
                                                  seed):
    data = _structured(kind, n_bytes, seed)
    payload = jhost.bitplane_compress(data, 1 << gw_log2)
    frame = jhost.make_frame(payload, len(data))
    got = thost.bitplane_decompress(
        memoryview(frame)[thost._FRAME_HDR:])            # as ops.py calls it
    assert got == jhost.bitplane_decompress(payload) == data


@settings(max_examples=25, deadline=None)
@given(kinds=st.lists(st.sampled_from(KINDS), min_size=1, max_size=5),
       gw_log2=st.integers(5, 10), row_log2=st.integers(10, 14),
       tail=st.integers(0, 3), seed=st.integers(0, 2 ** 16))
def test_rows_of_an_encoded_buffer_match_jax_frames(kinds, gw_log2, row_log2,
                                                    tail, seed):
    """A device-encoded buffer of rows (the plain encoder's masks and plane
    stream) decodes in one pass to what the JAX package's
    ``bitplane_decompress`` gives for each row's frame, ragged last row
    included: the logical bytes the chunk keys hash."""
    gw, row_bytes = 1 << gw_log2, 1 << row_log2
    if gw * 4 > row_bytes:
        gw = row_bytes // 4
    data = [_structured(k, row_bytes, seed + r) for r, k in enumerate(kinds)]
    lens = [row_bytes] * len(data)
    lens[-1] -= 4 * tail                        # a ragged final chunk
    rows = np.frombuffer(b"".join(data), "<u4").reshape(len(data), -1)
    masks, _, planes = codec_encode_plain(
        torch.from_numpy(rows.astype(np.int64)), gw)
    masks = masks.numpy().astype(np.uint32)
    planes = planes.numpy().astype(np.uint32)
    words = thost.words_from_planes(masks, planes, gw)
    got = words.reshape(len(data), -1).view(np.uint8)
    frames = jhost.frames_from_encoded(masks, planes, row_bytes // 4 // gw,
                                       gw, lens)
    for r, frame in enumerate(frames):
        want = jhost.bitplane_decompress(frame[jhost._FRAME_HDR:])
        assert got[r, :lens[r]].tobytes() == want == data[r][:lens[r]]


@pytest.mark.parametrize("sizes", [[], [5], [1 << 20] * 3,
                                   [16384] * 300 + [3, 0, 1 << 21]])
def test_chunk_keys_match_one_by_one(sizes):
    rng = np.random.default_rng(len(sizes))
    bufs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes]
    views = [memoryview(b) for b in bufs]
    want = [chunkstore.chunk_key(b) for b in bufs]
    assert chunkstore.chunk_keys(bufs) == want == chunkstore.chunk_keys(views)


def test_bitplane_decompress_still_rejects_bad_payloads():
    payload = jhost.bitplane_compress(_structured("floats", 4096, 1))
    for bad in (payload[:10], payload[:-4], payload + b"\0\0\0\0"):
        with pytest.raises(ValueError):
            thost.bitplane_decompress(bad)


# ---------------------------------------------------------------------------
# tensor_from_bytes
# ---------------------------------------------------------------------------

def _old_tensor_from_bytes(data, dtype, shape, device):
    """The per-call copy ``tensor_from_bytes`` replaced."""
    out = torch.empty(list(shape), dtype=tser.torch_dtype(dtype),
                      device=device)
    raw = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else data.reshape(-1).view(np.uint8)
    if raw.size:
        tser.tensor_bytes_u8(out).copy_(torch.from_numpy(raw.copy()))
    return out


DTYPES = ["float32", "bfloat16", "float16", "int32", "uint8", "int64",
          "bool", "float64", "int8", "uint32"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(), (0,), (7,), (3, 5, 2), (4097,)])
def test_tensor_from_bytes_same_as_before(dtype, shape):
    item = torch.empty((), dtype=tser.torch_dtype(dtype)).element_size()
    n = int(np.prod(shape)) * item
    raw = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    if dtype == "bool":
        raw &= 1
    data = raw.tobytes()
    want = _old_tensor_from_bytes(data, dtype, shape, "cpu")
    cut = [0, n // 3, n // 3, n]                       # an empty part too
    parts = [data[a:b] for a, b in zip(cut, cut[1:])]
    for given_ in (data, raw, parts, [memoryview(p) for p in parts]):
        got = tser.tensor_from_bytes(given_, dtype, shape, "cpu")
        assert got.dtype == want.dtype and tuple(got.shape) == tuple(shape)
        assert got._base is None and got.is_contiguous()
        assert tser.tensor_to_bytes(got) == data == tser.tensor_to_bytes(want)


def test_tensor_from_bytes_rejects_a_wrong_size():
    with pytest.raises(tser.SerializationError, match="bytes for a"):
        tser.tensor_from_bytes(b"\0" * 7, "float32", (2,), "cpu")
    with pytest.raises(tser.SerializationError):
        tser.tensor_from_bytes([b"\0" * 4, b"\0" * 8], "float32", (2,), "cpu")


def test_leaf_from_bytes_takes_parts():
    """A manifest's chunks, unjoined, restore every kind of leaf exactly as
    the joined blob does."""
    arr = np.arange(30, dtype=np.float32).reshape(5, 6)
    obj = {"lr": 1e-3, "step": 4}
    t = torch.arange(12, dtype=torch.bfloat16)
    for x in (arr, obj, t):
        data, meta = tser.leaf_to_bytes(x)
        parts = [data[:5], data[5:], b""]
        for device in (None, torch.device("cpu")):
            a = tser.leaf_from_bytes(data, meta, device=device)
            b = tser.leaf_from_bytes(parts, meta, device=device)
            assert type(a) is type(b)
            if isinstance(a, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b)
            elif isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b)
            else:
                assert a == b
