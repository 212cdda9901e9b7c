"""Chunk store keys computed where the bytes lie.

A chunk's store key is ``chunkstore.chunk_key``: the hex of its unkeyed
BLAKE2b digest of 16 bytes (RFC 7693).  ``chunk_key_digests(u8,
chunk_bytes, want)`` gives the 16 digest bytes of each chunk ``i`` of a
flat uint8 tensor with ``want[i]``, the ragged last chunk at its own
length: the CUDA kernel (``csrc/chunk_key.cu``) for a CUDA tensor, which
launches or raises; the plain version below, numpy ``uint64`` vectorised
over chunks, for a CPU tensor.  Both are byte for byte
``hashlib.blake2b(chunk, digest_size=16).digest()``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import _lib

DIGEST_BYTES = 16
BLOCK_BYTES = 128
ROUNDS = 12
IV = np.array([0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
               0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
               0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179], dtype=np.uint64)
# message schedule; round r uses row r % 10
SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)
# parameter block word 0: digest length 16, key length 0, fanout 1, depth 1
PARAM0 = 0x01010000 | DIGEST_BYTES
# a half-round's four G functions take the state's rows 0-3, 4-7, 8-11 and
# 12-15 as their (a, b, c, d): the columns as the state lies, then the
# diagonals once DIAGONALS has gathered it (UNDIAGONALS puts it back)
DIAGONALS = np.array([0, 1, 2, 3, 5, 6, 7, 4, 10, 11, 8, 9, 15, 12, 13, 14])
UNDIAGONALS = np.argsort(DIAGONALS)
# each round's message words in the order its half-rounds take them: the
# columns' x and y words, then the diagonals'
_ORDER = np.array([[s[k] for k in (0, 2, 4, 6, 1, 3, 5, 7,
                                   8, 10, 12, 14, 9, 11, 13, 15)]
                   for s in (SIGMA[r % 10] for r in range(ROUNDS))]
                  ).reshape(-1)
_SHIFTS = {n: (np.uint64(n), np.uint64(64 - n)) for n in (32, 24, 16, 63)}


def _rotr(x: np.ndarray, n: int) -> np.ndarray:
    right, left = _SHIFTS[n]
    return (x >> right) | (x << left)


def _half_round(v: np.ndarray, x: np.ndarray, y: np.ndarray) -> None:
    """Four G functions at once on the rows of ``v`` [16, n], in place."""
    a, b, c, d = v[0:4], v[4:8], v[8:12], v[12:16]
    a += b
    a += x
    d[...] = _rotr(d ^ a, 32)
    c += d
    b[...] = _rotr(b ^ c, 24)
    a += b
    a += y
    d[...] = _rotr(d ^ a, 16)
    c += d
    b[...] = _rotr(b ^ c, 63)


def _compress(h: np.ndarray, m: np.ndarray, t: np.ndarray,
              last: np.ndarray) -> np.ndarray:
    """BLAKE2b's F over ``n`` chains at once: state ``h`` [8, n], message
    words ``m`` [16, n], byte counters ``t`` [n], final flags ``last``
    [n]; returns the new state."""
    v = np.concatenate([h, np.repeat(IV[:, None], h.shape[1], axis=1)])
    v[12] ^= t
    v[14] ^= np.where(last, ~np.uint64(0), np.uint64(0))
    words = m[_ORDER].reshape(ROUNDS, 4, 4, -1)
    for r in range(ROUNDS):
        _half_round(v, words[r, 0], words[r, 1])
        v = v[DIAGONALS]
        _half_round(v, words[r, 2], words[r, 3])
        v = v[UNDIAGONALS]
    return h ^ v[:8] ^ v[8:]


def _want_indices(n_chunks: int, want: Optional[Sequence[bool]]
                  ) -> List[int]:
    if want is None:
        return list(range(n_chunks))
    if len(want) != n_chunks:
        raise ValueError(f"chunk_key: want has {len(want)} entries for "
                         f"{n_chunks} chunks")
    return [i for i in range(n_chunks) if want[i]]


def chunk_key_digests_np(buf, chunk_bytes: int,
                         want: Optional[Sequence[bool]] = None
                         ) -> np.ndarray:
    """Plain version: uint8 [n_want, 16], the BLAKE2b-128 digest of each
    chunk ``i`` of ``buf``'s bytes with ``want[i]`` (every chunk when
    ``want`` is None), in index order.  Each chain of compressions runs
    block by block, all chains at once."""
    raw = np.frombuffer(buf, dtype=np.uint8) \
        if isinstance(buf, (bytes, bytearray, memoryview)) \
        else np.ascontiguousarray(buf).reshape(-1).view(np.uint8)
    if chunk_bytes <= 0:
        raise ValueError(f"chunk_bytes {chunk_bytes} is not positive")
    n = raw.size
    idx = _want_indices(-(-n // chunk_bytes), want)
    if not idx:
        return np.zeros((0, DIGEST_BYTES), np.uint8)
    lens = np.array([min(chunk_bytes, n - i * chunk_bytes) for i in idx],
                    dtype=np.int64)
    blocks = np.maximum(1, -(-lens // BLOCK_BYTES))
    nb = int(blocks.max())
    padded = np.zeros((len(idx), nb * BLOCK_BYTES), np.uint8)
    for row, (i, ln) in enumerate(zip(idx, lens)):
        padded[row, :ln] = raw[i * chunk_bytes:i * chunk_bytes + ln]
    words = padded.view("<u8").reshape(len(idx), nb, 16)
    h = np.repeat(IV[:, None], len(idx), axis=1)
    h[0] ^= np.uint64(PARAM0)
    for b in range(nb):
        live = blocks > b
        t = np.minimum((b + 1) * BLOCK_BYTES, lens).astype(np.uint64)
        new = _compress(h, words[:, b, :].T.astype(np.uint64), t,
                        blocks == b + 1)
        h = np.where(live, new, h)
    return np.ascontiguousarray(h[:2].T).astype("<u8").view(np.uint8) \
        .reshape(len(idx), DIGEST_BYTES)


def hex_keys(digests: np.ndarray) -> List[str]:
    """The store keys (``chunkstore.chunk_key``) of uint8 [n, 16] digests."""
    flat = np.ascontiguousarray(digests, dtype=np.uint8).tobytes().hex()
    step = 2 * DIGEST_BYTES
    return [flat[k:k + step] for k in range(0, len(flat), step)]


def chunk_key_cuda(u8: torch.Tensor, chunk_bytes: int,
                   idx: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on PyTorch's current stream: ``u8`` a flat
    contiguous CUDA uint8 tensor, ``idx`` int64 chunk indices on its card,
    each below the chunk count.  Returns uint8 [len(idx), 16] on the card
    (not yet computed when this returns)."""
    nbytes = u8.numel()
    if u8.dtype != torch.uint8 or u8.dim() != 1 or not u8.is_contiguous() \
            or not u8.is_cuda or nbytes == 0:
        raise ValueError("chunk_key: a flat contiguous non-empty CUDA uint8 "
                         "tensor is required")
    if chunk_bytes <= 0 or idx.dtype != torch.int64 or idx.dim() != 1 \
            or idx.device != u8.device:
        raise ValueError(f"chunk_key: chunk_bytes={chunk_bytes}, idx "
                         f"{idx.dtype} {tuple(idx.shape)} on {idx.device}")
    out = torch.empty((idx.numel(), DIGEST_BYTES), dtype=torch.uint8,
                      device=u8.device)
    if idx.numel():
        with torch.cuda.device(u8.device):
            _lib.call("kishu_chunk_key", u8.data_ptr(), nbytes, chunk_bytes,
                      idx.data_ptr(), idx.numel(), out.data_ptr(),
                      _lib.stream_of(u8))
        _lib.note_launch("chunk_key")
    return out


def chunk_key_digests(u8: torch.Tensor, chunk_bytes: int,
                      want: Optional[Sequence[bool]] = None) -> np.ndarray:
    """uint8 [n_want, 16]: the digest of each chunk ``i`` of the flat uint8
    tensor ``u8`` with ``want[i]``, in index order."""
    if u8.is_cuda:
        idx = _want_indices(-(-u8.numel() // chunk_bytes), want)
        if not idx:
            return np.zeros((0, DIGEST_BYTES), np.uint8)
        dev_idx = torch.tensor(idx, dtype=torch.int64, device=u8.device)
        return chunk_key_cuda(u8, chunk_bytes, dev_idx).cpu().numpy()
    if u8.device.type != "cpu":
        raise ValueError(f"chunk_key: unsupported device {u8.device}")
    return chunk_key_digests_np(u8.numpy(), chunk_bytes, want)
