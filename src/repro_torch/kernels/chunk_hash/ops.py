"""Public wrapper for on-device chunk hashing.

``chunk_hash(x, chunk_bytes)`` hashes a tensor's bytes where they lie: the
CUDA kernel reads a CUDA tensor's storage in place (no padding copy, no
host round-trip) and launches or raises; a CPU tensor goes through the
plain torch version (``repro_torch.core.hashing.chunk_hashes_plain``), the
same arithmetic step for step.  Both are bit-identical to
``hashing.chunk_hashes_np``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core.serialize import tensor_bytes_u8
from repro_torch.kernels import _lib


def chunk_hash_cuda(u8: torch.Tensor, chunk_bytes: int) -> torch.Tensor:
    """Launch the kernel on a flat contiguous CUDA uint8 tensor (non-empty).
    Returns int32 [n_chunks, 2] holding the uint32 hash lanes' bits."""
    nbytes = u8.numel()
    if nbytes == 0 or chunk_bytes <= 0 or chunk_bytes % 4:
        raise ValueError(f"chunk_hash: nbytes={nbytes}, "
                         f"chunk_bytes={chunk_bytes}")
    n_chunks = -(-nbytes // chunk_bytes)
    out = torch.zeros((n_chunks, 2), dtype=torch.int32, device=u8.device)
    splits = _lib.splits_for(n_chunks, chunk_bytes)
    with torch.cuda.device(u8.device):
        _lib.call("kishu_chunk_hash", u8.data_ptr(), nbytes, chunk_bytes,
                  splits, out.data_ptr(), _lib.stream_of(u8))
    _lib.note_launch("chunk_hash")
    return out


def chunk_hash(x: torch.Tensor, chunk_bytes: int) -> np.ndarray:
    """uint32 [n_chunks, 2] detection hash lanes (lane 0 the high word)."""
    if chunk_bytes <= 0 or chunk_bytes % 4:
        raise ValueError(f"chunk_bytes {chunk_bytes} not word-aligned")
    u8 = tensor_bytes_u8(x)
    if u8.numel() == 0:
        return np.zeros((0, 2), np.uint32)
    if x.is_cuda:
        return chunk_hash_cuda(u8, chunk_bytes).cpu().numpy().view(np.uint32)
    if x.device.type != "cpu":
        raise ValueError(f"chunk_hash: unsupported device {x.device}")
    return hashing.chunk_hashes_plain(u8, chunk_bytes).numpy() \
        .astype(np.uint32)


def chunk_hash_u64(x: torch.Tensor, chunk_bytes: int) -> np.ndarray:
    """uint64 [n_chunks], matching ``hashing.chunk_hashes_np``."""
    return hashing.combine_u64(chunk_hash(x, chunk_bytes))
