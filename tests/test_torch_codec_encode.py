"""The port's codec encode on the CPU, held against the JAX package.

``csrc/delta_codec.cu`` runs only on a card, so its arithmetic is emulated
here lane for lane in numpy — the five ``__shfl_xor_sync`` butterfly stages
(lane exchange by index XOR), the two ballots, the tile scan with its
decoupled look-back in an arbitrary order of tiles, and the staged,
coalesced plane writes (group by group: a warp that encodes several groups
writes the same rows in the same order) — and held against
``host.transpose32`` and the JAX package's ``codec_encode_ref``.  The wrapper's CPU path (``encode_rows``,
``DeltaPack.read_chunks_encoded``) is held against the JAX package's
reference and its Pallas kernel in interpret mode.
"""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import hashing as jhash  # noqa: E402
from repro.kernels.delta_codec import host as jhost  # noqa: E402
from repro.kernels.delta_codec import ops as jcodec_ops  # noqa: E402
from repro.kernels.delta_codec.ref import codec_encode_ref  # noqa: E402
from repro.kernels.delta_pack.ops import delta_pack as jdelta_pack  # noqa: E402

from repro_torch.interop import array_to_tensor  # noqa: E402
from repro_torch.kernels.delta_codec import host as thost  # noqa: E402
from repro_torch.kernels.delta_codec.ops import (TILE_GROUPS,  # noqa: E402
                                                 encode_rows, i32_bits)
from repro_torch.kernels.delta_pack.ops import delta_pack  # noqa: E402

FULL = 0xFFFFFFFF
LANES = np.arange(32)
# the kernel's stages (J, M), as in transpose_lane
STAGES = ((16, 0x0000FFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F),
          (2, 0x33333333), (1, 0x55555555))


def _butterfly_lanes(v):
    """The kernel's transpose_lane over uint32 ``v`` [..., 32] (lanes on
    the last axis): each stage reads the partner lane's word (lane ^ J)."""
    v = v.astype(np.uint32)
    for j, m in STAGES:
        x = v[..., LANES ^ j]
        upper = (LANES & j) != 0
        take = np.where(upper, m, (m << j) & FULL).astype(np.uint32)
        # __funnelshift_l(x, x, s): x rotated left by s (32 - j: right by j)
        rotl = (x << np.uint32(j)) | (x >> np.uint32(32 - j))
        rotr = (x >> np.uint32(j)) | (x << np.uint32(32 - j))
        y = np.where(upper, rotr, rotl)
        v = (v & ~take) | (y & take)
    return v


def _emulate_encode(rows, gw, order_seed=0):
    """The kernel, lane for lane: returns (masks [ng, 2], count, planes
    [ng*32, gw//32] with rows past count left at a fill value)."""
    pw = gw // 32
    ng = rows.size // gw
    v = _butterfly_lanes(rows.reshape(ng, pw, 32))      # [group, j, lane]
    ones = np.bitwise_and.reduce(v, axis=1) == FULL
    store = ~ones & (np.bitwise_or.reduce(v, axis=1) != 0)
    bit = np.uint64(1) << LANES.astype(np.uint64)
    smask = (store * bit).sum(axis=1).astype(np.uint32)  # the ballots
    omask = (ones * bit).sum(axis=1).astype(np.uint32)
    cnt = store.sum(axis=1)
    n_tiles = -(-ng // TILE_GROUPS)
    padded = np.zeros(n_tiles * TILE_GROUPS, np.int64)
    padded[:ng] = cnt
    per_warp = padded.reshape(n_tiles, TILE_GROUPS)
    warp_off = np.cumsum(per_warp, axis=1) - per_warp   # the tile's scan
    totals = per_warp.sum(axis=1)
    # every tile has published its aggregate; look-back then runs in an
    # arbitrary order, each tile reading 32 predecessors a round and
    # stopping at the nearest one that holds a prefix
    status = {t: ("A", int(totals[t])) for t in range(n_tiles)}
    base = np.zeros(n_tiles, np.int64)
    for t in np.random.default_rng(order_seed).permutation(n_tiles):
        excl, look = 0, t - 1
        while True:
            window = [status[i] if i >= 0 else ("P", 0)
                      for i in range(look, look - 32, -1)]
            flags = [f for f, _ in window]
            stop = flags.index("P") if "P" in flags else 31
            excl += sum(val for _, val in window[:stop + 1])
            if "P" in flags:
                break
            look -= 32
        base[t] = excl
        status[t] = ("P", excl + int(totals[t]))
    planes = np.full((ng * 32, pw), 0xDEADBEEF, np.uint32)
    for g in range(ng):
        if not smask[g]:
            continue
        stage = np.zeros(32 * (pw + 1), np.uint32)
        for p in np.flatnonzero(store[g]):               # lane p, its rank
            rank = int(store[g, :p].sum())
            stage[rank * (pw + 1) + np.arange(pw)] = v[g, :, p]
        t, w = divmod(g, TILE_GROUPS)
        dst = planes.reshape(-1)[(base[t] + warp_off[t, w]) * pw:]
        for i in range(int(cnt[g]) * pw):               # coalesced writes
            dst[i] = stage[(i // pw) * (pw + 1) + i % pw]
    count = int(base[-1] + totals[-1])
    return np.stack([smask, omask], axis=1), count, planes


def _rows(r, w, seed, kind="mixed"):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 2**32, (r, w), dtype=np.uint64) \
            .astype(np.uint32)
    rows = rng.integers(0, 1 << 12, (r, w)).astype(np.uint32)
    rows[:, : w // 4] = 0                       # all-zero planes
    rows[0, w // 2:] = FULL                     # all-one planes
    return rows


@pytest.mark.parametrize("shape", [(32, 1), (3, 32, 4), (7, 32, 33)])
def test_warp_butterfly_matches_transpose32(shape):
    """Lane c holding word c ends with lane p holding plane p: bit c of
    lane p's word is bit p of word c — host.transpose32's result."""
    rng = np.random.default_rng(len(shape))
    a = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    lanes_last = np.moveaxis(a, -2, -1)                 # [..., n, 32]
    got = np.moveaxis(_butterfly_lanes(lanes_last), -1, -2)
    assert np.array_equal(got, thost.transpose32(a))
    bits = (a[..., :, None, :] >> LANES[None, :, None].astype(np.uint32)) & 1
    want = (bits.astype(np.uint64) << LANES[:, None, None]
            .astype(np.uint64)).sum(axis=-3).astype(np.uint32)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("gw", [32, 64, 128, 256, 512, 1024])
@pytest.mark.parametrize("kind", ["mixed", "random"])
def test_kernel_emulation_matches_ref(gw, kind):
    """Groups that are no multiple of the tile, and (at gw 32) more than 32
    tiles, so look-back reads more than one window of predecessors."""
    ng = 8 * 41 + 3 if gw == 32 else 8 * 2 + 5
    rows = _rows(1, ng * gw, seed=gw, kind=kind)
    rows[0, 3 * gw: 4 * gw] = 0                 # a group with no plane
    rows[0, 5 * gw: 6 * gw] = FULL              # a group of ones only
    jm, jc, jp = codec_encode_ref(jnp.asarray(rows), gw=gw)
    jc = int(np.asarray(jc)[0, 0])
    for seed in (0, 1):
        em, ec, ep = _emulate_encode(rows, gw, order_seed=seed)
        assert ec == jc
        assert np.array_equal(em, np.asarray(jm))
        assert np.array_equal(ep[:ec], np.asarray(jp)[:jc])
    if kind == "random":
        assert ec == (ng - 2) * 32              # all stored but two groups


@pytest.mark.parametrize("gw", [32, 64, 128, 256, 512, 1024])
def test_encode_rows_returns_count_rows(gw):
    """The CPU path: uint32 masks, and int32 planes of exactly as many rows
    as the masks store — the JAX reference's stream up to its count.  A
    row of up to 1024 words is one group; a wider row, several."""
    w = 2 * gw if gw == 1024 else gw
    rows = _rows(3, w, seed=gw)
    masks, planes, got_gw = encode_rows(i32_bits(torch.from_numpy(
        rows.astype(np.int64))))
    assert got_gw == gw
    assert masks.dtype == np.uint32 and masks.shape == (3 * w // gw, 2)
    n = int(thost.popcount_u32(masks[:, 0]).sum())
    assert planes.dtype == torch.int32 and planes.shape == (n, gw // 32)
    jm, jc, jp = codec_encode_ref(jnp.asarray(rows), gw=gw)
    assert n == int(np.asarray(jc)[0, 0])
    assert np.array_equal(masks, np.asarray(jm))
    assert np.array_equal(planes.numpy().view(np.uint32),
                          np.asarray(jp)[:n])


@pytest.mark.parametrize("cb", [128, 256, 512, 1024, 2048, 4096, 16384])
def test_read_chunks_encoded_matches_jax(cb):
    """Every group size (cb 128 B is gw 32 ... 4 KiB is gw 1024; 16 KiB is
    four groups a row), a ragged final chunk: the port's (index, logical,
    frame) triples equal the JAX wrapper's, and the frames are those the
    Pallas kernel's stream gives in interpret mode."""
    n_chunks = 6
    rng = np.random.default_rng(cb)
    a0 = rng.integers(0, 1 << 10, n_chunks * cb // 4 - 3).astype(np.int32)
    a1 = a0.copy()
    a1[:: max(1, cb // 8)] += 1                 # every chunk dirty
    a1[-1] += 1
    prev = jhash.chunk_hashes_np(a0.view(np.uint8), cb)
    tp = delta_pack(array_to_tensor(a1, "cpu"), prev, cb)
    got = list(tp.read_chunks_encoded())
    assert [ci for ci, _, _ in got] == list(range(n_chunks))
    assert tp.codec_chunks_encoded > 0
    jp = jdelta_pack(jnp.asarray(a1), prev, cb, backend="ref")
    assert got == list(jp.read_chunks_encoded())
    masks, planes_d, gw = jcodec_ops.encode_rows(
        jnp.asarray(np.asarray(tp.buf).view(np.uint32)), backend="pallas",
        interpret=True)
    lens = [tp._chunk_len(int(ci)) for ci in tp.dirty]
    assert lens[-1] < cb
    frames = jhost.frames_from_encoded(
        masks, np.asarray(planes_d), (cb // 4) // gw, gw, lens)
    for ci, logical, frame in got:
        assert logical == a1.view(np.uint8)[ci * cb:][:lens[ci]].tobytes()
        if frame is not None:
            assert frame == frames[ci]
