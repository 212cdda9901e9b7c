"""Host (numpy) half of the bitshuffle+RLE block codec — the format oracle.

The codec transposes each group of ``gw`` uint32 words into 32 bit-planes
of ``gw`` bits and run-length-encodes at *plane* granularity: planes that
are all-zero or all-one collapse into two 32-bit masks per group; only the
remaining ("stored") planes are kept verbatim.  Typical numeric notebook
state — small-range ints, slowly-varying floats, masks — has most high
bit-planes constant, so dirty chunks shrink 2-20x with a branch-free
transform simple enough to run inside the delta_pack device pipeline
(``ops.py`` and its CUDA kernel produce the identical plane stream).

Payload layout (all little-endian), wrapped by the standard ``KZC1`` chunk
frame (``core/chunkstore.py``) under ``CODEC_ID``:

    header (16 B): u8 version=1 | u8 log2_gw | u16 0 | u32 n_groups
                   | u64 raw_len
    group headers: n_groups x (u32 stored_mask | u32 ones_mask)
    planes:        stored planes in (group, plane-ascending) order,
                   gw/8 bytes each

A plane absent from ``stored_mask`` is all-one if its ``ones_mask`` bit is
set, else all-zero.  ``raw_len`` truncates the reconstruction (groups are
zero-padded on encode), so odd-sized chunks round-trip exactly.  The
decoder validates the header and the exact payload length and raises on
any mismatch — ``decode_chunk`` then returns the bytes verbatim, exactly
like a corrupt zlib frame.

This module is pure numpy (no torch import): ``core/chunkstore.py`` registers
it as a first-class :class:`ChunkCodec`, and chunk stores must stay
importable on hosts without an accelerator stack.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Sequence

import numpy as np

CODEC_ID = 4                 # KZC1 frame codec id (core/chunkstore.py)
CODEC_NAME = "bshuf"
FRAME_MAGIC = b"KZC1"        # must match chunkstore.CHUNK_MAGIC
_FRAME_HDR = len(FRAME_MAGIC) + 1 + 8

_VERSION = 1
_HDR = struct.Struct("<BBHIQ")          # ver, log2_gw, 0, n_groups, raw_len
HEADER_BYTES = _HDR.size                # 16

GROUP_WORDS = 1024           # default group size (4 KiB of words)
MIN_GROUP_WORDS = 32         # one bitmap word per plane
PROBE_THRESHOLD = 0.75       # est. stored-plane fraction above which we skip
PROBE_MIN_BYTES = 256        # below this, framing overhead always loses
_ALL_ONES = np.uint32(0xFFFFFFFF)


def _log2(n: int) -> int:
    return int(n).bit_length() - 1


def pow2ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(0, int(n - 1).bit_length())


def popcount_u32(a: np.ndarray) -> np.ndarray:
    """Per-element popcount of a uint32 array."""
    b = np.ascontiguousarray(a, dtype="<u4").view(np.uint8)
    return np.unpackbits(b).reshape(-1, 32).sum(axis=1).astype(np.int64)


def pick_group_words(n_words: int) -> int:
    """Group size for ``n_words`` of data: the smallest power of two
    covering it, clamped to [MIN_GROUP_WORDS, GROUP_WORDS] — small chunks
    avoid padding a 4 KiB group, large chunks amortize the 8-byte/group
    header."""
    gw = GROUP_WORDS
    while gw > MIN_GROUP_WORDS and gw // 2 >= n_words:
        gw //= 2
    return gw


def _words_of(data: bytes, gw: int) -> np.ndarray:
    """Zero-padded little-endian uint32 words, grouped: [n_groups, gw]."""
    n_words = -(-len(data) // 4)
    n_groups = -(-n_words // gw) if n_words else 0
    buf = np.zeros(max(n_groups, 1) * gw * 4, np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    return buf.view("<u4").reshape(-1, gw)[:n_groups]


# the five butterfly stages of a 32 x 32 bit-matrix transpose: at stage
# (j, m) row r and row r + j (r & j == 0) swap the j x j blocks off the
# diagonal, m selecting the columns c with c & j == 0
_BUTTERFLY = ((16, 0x0000FFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F),
              (2, 0x33333333), (1, 0x55555555))


def transpose32(a: np.ndarray) -> np.ndarray:
    """Bit transpose of every 32 x 32 bit matrix of ``a`` (uint32
    [..., 32, n], rows on axis -2): returns ``b`` with bit ``c`` of
    ``b[..., r, j]`` equal to bit ``r`` of ``a[..., c, j]``.  Five
    butterfly stages over all matrices at once (rows first, so each stage
    runs on long contiguous runs), a shift, two xors and an and per word
    pair each, in place of 32 passes of one bit each."""
    rows = np.array(np.moveaxis(a, -2, 0), dtype="<u4", order="C")
    flat = rows.reshape(32, -1)
    n = flat.shape[1]
    t = np.empty((16, n), "<u4")
    for j, m in _BUTTERFLY:
        v = flat.reshape(32 // (2 * j), 2, j, n)
        lo, hi = v[:, 0], v[:, 1]
        tv = t.reshape(32 // (2 * j), j, n)
        np.right_shift(lo, np.uint32(j), out=tv)
        tv ^= hi
        tv &= np.uint32(m)
        hi ^= tv
        tv <<= np.uint32(j)
        lo ^= tv
    return np.moveaxis(rows, 0, -2)


def plane_split(groups: np.ndarray) -> np.ndarray:
    """Bitshuffle: uint32 [n_groups, gw] -> planes [n_groups, 32, gw//32].

    Bit ``k`` of plane word ``j`` in plane ``p`` is bit ``p`` of source word
    ``j*32 + k`` — identical packing to the device kernels."""
    ng, gw = groups.shape
    w = groups.reshape(ng, gw // 32, 32)
    return np.ascontiguousarray(transpose32(w.transpose(0, 2, 1)))


def plane_join(planes: np.ndarray) -> np.ndarray:
    """Inverse of :func:`plane_split`: planes [ng, 32, gw//32] -> words
    [ng, gw]."""
    ng, _, pw = planes.shape
    return np.ascontiguousarray(transpose32(planes).transpose(0, 2, 1)) \
        .reshape(ng, pw * 32)


def classify_planes(planes: np.ndarray):
    """(stored_mask u32 [ng], ones_mask u32 [ng], store_flags bool [ng,32])."""
    zero = np.all(planes == 0, axis=2)
    ones = np.all(planes == _ALL_ONES, axis=2)
    store = ~zero & ~ones
    weights = (np.uint32(1) << np.arange(32, dtype=np.uint32))
    smask = np.bitwise_or.reduce(
        np.where(store, weights, np.uint32(0)), axis=1)
    omask = np.bitwise_or.reduce(
        np.where(ones, weights, np.uint32(0)), axis=1)
    return smask.astype("<u4"), omask.astype("<u4"), store


def payload_from_planes(smask: np.ndarray, omask: np.ndarray,
                        stored_planes: np.ndarray, gw: int,
                        raw_len: int) -> bytes:
    """Assemble one codec payload from classified planes (host or device
    produced — both emit the same (group, plane) stream)."""
    n_groups = int(smask.shape[0])
    hdr = _HDR.pack(_VERSION, _log2(gw), 0, n_groups, raw_len)
    masks = np.column_stack([smask, omask]).astype("<u4").tobytes()
    return hdr + masks + np.ascontiguousarray(
        stored_planes, dtype="<u4").tobytes()


def bitplane_compress(data: bytes, group_words: Optional[int] = None) -> bytes:
    """Pure-numpy encoder (the host rung of the ladder, and the reference
    the device kernels are tested against)."""
    data = bytes(data)
    gw = group_words or pick_group_words(-(-len(data) // 4))
    if gw < MIN_GROUP_WORDS or gw & (gw - 1):
        raise ValueError(f"group_words {gw}: need a power of two >= "
                         f"{MIN_GROUP_WORDS}")
    groups = _words_of(data, gw)
    planes = plane_split(groups)
    smask, omask, store = classify_planes(planes)
    return payload_from_planes(smask, omask, planes[store], gw, len(data))


def bitplane_decompress(payload: bytes) -> bytes:
    """Strict inverse of :func:`bitplane_compress` / the device encoder.
    Raises ValueError on any malformed payload (decode_chunk treats that as
    "not a frame" and returns the stored bytes verbatim)."""
    payload = bytes(payload)
    if len(payload) < HEADER_BYTES:
        raise ValueError("bitplane payload shorter than header")
    ver, log2_gw, pad, n_groups, raw_len = _HDR.unpack_from(payload)
    gw = 1 << log2_gw
    if ver != _VERSION or pad != 0 or gw < MIN_GROUP_WORDS \
            or gw > (GROUP_WORDS << 8):
        raise ValueError("bitplane payload: bad header")
    if raw_len > n_groups * gw * 4 or (n_groups == 0) != (raw_len == 0):
        raise ValueError("bitplane payload: raw_len out of range")
    masks_end = HEADER_BYTES + n_groups * 8
    if len(payload) < masks_end:
        raise ValueError("bitplane payload: truncated group headers")
    masks = np.frombuffer(payload, "<u4", count=n_groups * 2,
                          offset=HEADER_BYTES).reshape(n_groups, 2)
    counts = popcount_u32(masks[:, 0])
    total = int(counts.sum())
    pw = gw // 32
    if len(payload) != masks_end + total * pw * 4:
        raise ValueError("bitplane payload: plane stream length mismatch")
    flat = np.frombuffer(payload, "<u4", offset=masks_end).reshape(total, pw)
    words = words_from_planes(masks, flat, gw)
    return words.view(np.uint8).reshape(-1)[:raw_len].tobytes()


def words_from_planes(masks: np.ndarray, stored: np.ndarray, gw: int
                      ) -> np.ndarray:
    """Groups of words uint32 [ng, gw] from per-group (stored_mask,
    ones_mask) pairs uint32 [ng, 2] and the stored planes uint32
    [n_stored, gw//32] in (group, plane) order: a frame's payload, or a
    whole device-encoded buffer of rows at once (a row of W words is W//gw
    consecutive groups).  Raises ValueError on a plane both stored and
    all-ones."""
    ng, pw = masks.shape[0], gw // 32
    shifts = np.arange(32, dtype=np.uint32)
    ones = ((masks[:, 1:2] >> shifts) & np.uint32(1)).astype(bool)
    store = ((masks[:, 0:1] >> shifts) & np.uint32(1)).astype(bool)
    if np.any(store & ones):
        raise ValueError("bitplane payload: stored+ones plane conflict")
    planes = np.zeros((ng, 32, pw), dtype="<u4")
    planes[ones] = _ALL_ONES
    planes[store] = stored
    return plane_join(planes)


# ---------------------------------------------------------------------------
# sampled-incompressibility probe (host and device paths share the estimate)
# ---------------------------------------------------------------------------

def estimate_stored_fraction(words: np.ndarray) -> float:
    """Estimated fraction of bit-planes the codec would have to store, from
    a word sample: a plane whose bit differs anywhere in the sample cannot
    be all-zero or all-one.  Biased low (a plane constant in the sample may
    still vary per group) — cheap and good enough to skip the encode for
    already-compressed/random chunks."""
    w = np.ascontiguousarray(words, dtype="<u4").reshape(-1)
    if w.size == 0:
        return 0.0
    varying = np.bitwise_and.reduce(w) ^ np.bitwise_or.reduce(w)
    return float(popcount_u32(np.array([varying], "<u4"))[0]) / 32.0


def bitplane_probe(data: bytes, sample_words: int = 256,
                   threshold: float = PROBE_THRESHOLD) -> bool:
    """True when ``data`` looks worth bit-plane encoding.  Samples ~256
    words spread across the chunk; random/already-compressed data has every
    plane varying and is skipped without touching the full buffer."""
    if len(data) < PROBE_MIN_BYTES:
        return False
    n_words = len(data) // 4
    step = max(1, n_words // sample_words)
    sample = np.frombuffer(data, "<u4",
                           count=n_words)[::step][:sample_words]
    return estimate_stored_fraction(sample) < threshold


# ---------------------------------------------------------------------------
# frame assembly for device-encoded segments (kernels/delta_pack pipeline)
# ---------------------------------------------------------------------------

def make_frame(payload: bytes, raw_len: int) -> bytes:
    """Wrap a codec payload in the standard chunk frame (KZC1 | id |
    raw_len | payload) — byte-identical to ``chunkstore.encode_chunk`` with
    this codec, so any backend decodes it transparently on read."""
    return (FRAME_MAGIC + bytes([CODEC_ID])
            + int(raw_len).to_bytes(8, "little") + payload)


def frames_from_encoded(masks: np.ndarray, planes: np.ndarray,
                        groups_per_row: int, gw: int,
                        row_lens: Sequence[int]) -> List[bytes]:
    """Split a device-encoded segment (per-group masks + compacted plane
    stream, in row order) into one codec payload frame per row (= one
    chunk).  ``row_lens[r]`` is row r's logical byte length (raw_len)."""
    counts = popcount_u32(masks[:, 0])
    bounds = np.concatenate([[0], np.cumsum(counts)])
    out: List[bytes] = []
    for r, raw_len in enumerate(row_lens):
        g0, g1 = r * groups_per_row, (r + 1) * groups_per_row
        payload = payload_from_planes(
            masks[g0:g1, 0], masks[g0:g1, 1],
            planes[int(bounds[g0]):int(bounds[g1])], gw, int(raw_len))
        out.append(make_frame(payload, int(raw_len)))
    return out
