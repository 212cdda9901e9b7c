"""Chunk-hash specification — the VarGraph node-compare, GPU-adapted.

One hash definition, three implementations that MUST agree bit-for-bit
(tested against each other and against the JAX package):

  - :func:`chunk_hashes_np`       — vectorized NumPy, the spec (host path;
                                     used for numpy leaves)
  - :func:`chunk_hashes_plain`    — plain torch in int64 with 32-bit masks
                                     (the CPU-tensor path and the on-card
                                     reference for the kernel)
  - ``repro_torch.kernels.chunk_hash`` — the CUDA kernel for CUDA tensors

Design: an order-sensitive, embarrassingly-parallel 2x32-bit hash.  Each
uint32 word is avalanche-mixed with its position, lanes are XOR-reduced, and
the chunk byte-length is folded in (so zero-padding cannot collide with real
zeros of a different length).  XOR-reduction makes the hash a pure
map-reduce, so one chunk can be split over many thread blocks and combined
in any order.

Detection-grade hashing: equality of the 64-bit pair is treated as
"unchanged" (false-equal probability ~2^-64 per chunk — the same accuracy
class as the paper's pickling assumption, DESIGN.md §2).  *Storage* keys use
blake2b (exact) in the chunk store; this hash only decides what to inspect.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

GOLDEN = np.uint32(0x9E3779B9)
C1 = np.uint32(0x85EBCA6B)
C2 = np.uint32(0xC2B2AE35)
SEEDS = (np.uint32(0), np.uint32(0x517CC1B7))
DEFAULT_CHUNK_BYTES = 1 << 20
MASK32 = 0xFFFFFFFF


def _mix_np(w: np.ndarray, idx: np.ndarray, seed: np.uint32,
            n_valid: np.ndarray) -> np.ndarray:
    """Avalanche-mix words with their position; words past ``n_valid`` (zero
    padding) contribute 0, so the hash is independent of padding length."""
    with np.errstate(over="ignore"):
        m = (w ^ (idx * GOLDEN + seed)) * C1
        m ^= m >> np.uint32(16)
        m = m * C2
        m ^= m >> np.uint32(13)
    return np.where(idx < n_valid, m, np.uint32(0))


def _finalize_np(h: np.ndarray, nbytes: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = (h ^ nbytes.astype(np.uint32)) * C1
        h ^= h >> np.uint32(16)
    return h


def _effective_chunk_bytes(n: int, chunk_bytes: int) -> int:
    """Clamp the chunk size to the buffer length (word-aligned) so a huge
    configured chunk size (whole-co-variable mode) never allocates a huge
    zero pad.  Hash equality only ever compares same-length buffers, so the
    clamp is consistent across versions."""
    if chunk_bytes >= n:
        return max(((n + 3) // 4) * 4, 4)
    return chunk_bytes


def chunk_hashes_np(buf: bytes | np.ndarray,
                    chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> np.ndarray:
    """Per-chunk 64-bit hashes of a byte buffer. Returns uint64 [n_chunks]."""
    raw = np.frombuffer(buf, dtype=np.uint8) if isinstance(buf, (bytes, bytearray, memoryview)) \
        else np.ascontiguousarray(buf).reshape(-1).view(np.uint8)
    n = raw.size
    if n == 0:
        return np.zeros((0,), np.uint64)
    assert chunk_bytes % 4 == 0
    chunk_bytes = _effective_chunk_bytes(n, chunk_bytes)
    n_chunks = -(-n // chunk_bytes)
    padded = np.zeros(n_chunks * chunk_bytes, np.uint8)
    padded[:n] = raw
    words = padded.view(np.uint32).reshape(n_chunks, chunk_bytes // 4)
    idx = np.arange(chunk_bytes // 4, dtype=np.uint32)[None, :]
    nbytes = np.minimum(
        np.full(n_chunks, chunk_bytes, np.int64),
        n - np.arange(n_chunks, dtype=np.int64) * chunk_bytes)
    n_valid = ((nbytes + 3) // 4).astype(np.uint32)[:, None]
    lanes = []
    for seed in SEEDS:
        m = _mix_np(words, idx, seed, n_valid)
        h = np.bitwise_xor.reduce(m, axis=1)
        lanes.append(_finalize_np(h, nbytes))
    return (lanes[0].astype(np.uint64) << np.uint64(32)) | lanes[1].astype(np.uint64)


# ---------------------------------------------------------------------------
# plain torch version (int64 lanes holding uint32 values)
# ---------------------------------------------------------------------------

def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2**32`` for int64 ``a`` in [0, 2**32): split the constant
    in 16-bit halves so no product leaves int64 (torch has no uint32
    arithmetic on every device, and int64 overflow is not defined)."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def xor_reduce_rows(m: torch.Tensor) -> torch.Tensor:
    """XOR-reduce int64 [n, W] along W by a halving tree (torch has no XOR
    reduction); W is zero-padded to a power of two — zeros are neutral."""
    w = m.shape[1]
    p2 = 1 << max(0, (w - 1).bit_length())
    if p2 != w:
        m = torch.nn.functional.pad(m, (0, p2 - w))
    while m.shape[1] > 1:
        half = m.shape[1] // 2
        m = m[:, :half] ^ m[:, half:]
    return m[:, 0]


def words_of_bytes(u8: torch.Tensor, chunk_bytes: int) -> torch.Tensor:
    """Flat uint8 bytes -> int64 [n_chunks, chunk_bytes // 4] of
    little-endian uint32 words, zero-padded past the end (the plain
    version's copy; the kernels read the bytes in place)."""
    n = u8.numel()
    n_chunks = max(-(-n // chunk_bytes), 1)
    padded = torch.zeros(n_chunks * chunk_bytes, dtype=torch.uint8,
                         device=u8.device)
    padded[:n] = u8
    words = padded.view(torch.int32).to(torch.int64) & MASK32
    return words.reshape(n_chunks, chunk_bytes // 4)


def chunk_nbytes(n: int, chunk_bytes: int) -> np.ndarray:
    """True byte count of every chunk of an ``n``-byte buffer (int64)."""
    n_chunks = max(-(-n // chunk_bytes), 1)
    return np.minimum(
        np.full(n_chunks, chunk_bytes, np.int64),
        np.maximum(n - np.arange(n_chunks, dtype=np.int64) * chunk_bytes, 0))


def hash_words_plain(words: torch.Tensor, nbytes: torch.Tensor
                     ) -> torch.Tensor:
    """Hash pairs of pre-chunked words: int64 [n, W] (uint32 values) and
    int64 [n] true byte counts -> int64 [n, 2] (uint32 values, lane 0 the
    high word).  The same arithmetic as the kernel, step for step."""
    idx = torch.arange(words.shape[1], dtype=torch.int64,
                       device=words.device)[None, :]
    n_valid = ((nbytes + 3) // 4)[:, None]
    pos = mul32(idx, int(GOLDEN))
    lanes = []
    for seed in SEEDS:
        m = mul32(words ^ ((pos + int(seed)) & MASK32), int(C1))
        m = m ^ (m >> 16)
        m = mul32(m, int(C2))
        m = m ^ (m >> 13)
        m = torch.where(idx < n_valid, m, torch.zeros_like(m))
        h = xor_reduce_rows(m)
        h = mul32(h ^ nbytes, int(C1))
        lanes.append(h ^ (h >> 16))
    return torch.stack(lanes, dim=1)


def chunk_hashes_plain(u8: torch.Tensor, chunk_bytes: int) -> torch.Tensor:
    """Plain torch hash pairs of a flat uint8 tensor: int64 [n_chunks, 2].
    A chunk size past the buffer is clamped as in :func:`chunk_hashes_np`
    (padding words hash to nothing, so the value is the same)."""
    n = u8.numel()
    nb = torch.from_numpy(chunk_nbytes(n, chunk_bytes)).to(u8.device)
    words = words_of_bytes(u8, _effective_chunk_bytes(max(n, 1), chunk_bytes))
    return hash_words_plain(words, nb)


def hashes_hex(h) -> list:
    """uint64 [n] -> 16-char hex strings (manifest / record interchange)."""
    if h is None:
        return []
    return [format(int(x), "016x") for x in np.asarray(h, dtype=np.uint64)]


def chunk_hashes_device(x: torch.Tensor,
                        chunk_bytes: int = DEFAULT_CHUNK_BYTES
                        ) -> Optional[np.ndarray]:
    """Detection hashes of a tensor where it lies: the CUDA ``chunk_hash``
    kernel for a CUDA tensor (launches or raises), the plain torch version
    for a CPU tensor.  Returns ``None`` only where the path does not apply —
    a chunk size that is not a power of two — and the caller then hashes
    the bytes on host.  Bit-identical to :func:`chunk_hashes_np` (tested)."""
    if chunk_bytes % 4 or chunk_bytes & (chunk_bytes - 1):
        return None
    from repro_torch.kernels.chunk_hash.ops import chunk_hash_u64
    return chunk_hash_u64(x, chunk_bytes)


def combine_u64(lanes) -> np.ndarray:
    """uint32 [n,2] -> uint64 [n] (matches chunk_hashes_np packing)."""
    lanes = np.asarray(lanes).astype(np.uint64)
    return (lanes[:, 0] << np.uint64(32)) | lanes[:, 1]


def split_u64(h) -> np.ndarray:
    """uint64 [n] -> uint32 [n,2] lanes (inverse of :func:`combine_u64`) —
    the previous-hash operand of the fused ``delta_pack`` kernel."""
    h = np.asarray(h, dtype=np.uint64)
    return np.stack([(h >> np.uint64(32)).astype(np.uint32),
                     (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)], axis=1)
