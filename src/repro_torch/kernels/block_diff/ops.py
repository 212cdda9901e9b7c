"""Public wrapper for the exact per-chunk compare of two tensors.

``block_diff(a, b, chunk_bytes)`` gives int32 [n_chunks]: 1 where chunk i
of ``a``'s bytes differs from chunk i of ``b``'s.  Two CUDA tensors go
through the CUDA kernel, which reads both storages in place (no padding
copy) and launches or raises; two CPU tensors go through the plain torch
version below.  A ragged last chunk compares only its true bytes, which is
what the JAX package's zero padding of both sides computes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.serialize import tensor_bytes_u8
from repro_torch.kernels import _lib


def _check(a_u8: torch.Tensor, b_u8: torch.Tensor, chunk_bytes: int) -> int:
    if chunk_bytes <= 0:
        raise ValueError(f"chunk_bytes {chunk_bytes} is not positive")
    if a_u8.numel() != b_u8.numel():
        raise ValueError(f"block_diff: {a_u8.numel()} vs {b_u8.numel()} "
                         f"bytes")
    return -(-a_u8.numel() // chunk_bytes)


def block_diff_plain(a_u8: torch.Tensor, b_u8: torch.Tensor,
                     chunk_bytes: int) -> torch.Tensor:
    """Plain torch version over two flat uint8 tensors of one length:
    ``(a != b).any(dim=1)`` over chunk rows, the ragged tail padded with
    "equal".  Returns int32 [n_chunks]."""
    n_chunks = _check(a_u8, b_u8, chunk_bytes)
    ne = a_u8 != b_u8
    pad = n_chunks * chunk_bytes - ne.numel()
    if pad:
        ne = torch.cat([ne, ne.new_zeros(pad)])
    return ne.view(n_chunks, chunk_bytes).any(dim=1).to(torch.int32)


def block_diff_cuda(a_u8: torch.Tensor, b_u8: torch.Tensor,
                    chunk_bytes: int) -> torch.Tensor:
    """Launch the kernel on two flat contiguous uint8 CUDA tensors of one
    length (non-empty) on one card.  Returns int32 [n_chunks] on the card."""
    n_chunks = _check(a_u8, b_u8, chunk_bytes)
    if n_chunks == 0 or a_u8.device != b_u8.device \
            or not (a_u8.is_contiguous() and b_u8.is_contiguous()):
        raise ValueError("block_diff: operands must be non-empty, "
                         "contiguous and on one card")
    flags = torch.zeros((n_chunks,), dtype=torch.int32, device=a_u8.device)
    splits = _lib.splits_for(n_chunks, chunk_bytes)
    with torch.cuda.device(a_u8.device):
        _lib.call("kishu_block_diff", a_u8.data_ptr(), b_u8.data_ptr(),
                  a_u8.numel(), chunk_bytes, splits, flags.data_ptr(),
                  _lib.stream_of(a_u8))
    _lib.note_launch("block_diff")
    return flags


def block_diff(a: torch.Tensor, b: torch.Tensor,
               chunk_bytes: int = 1 << 18) -> torch.Tensor:
    """int32 [n_chunks]: 1 iff chunk i of ``a`` and ``b`` differ bitwise.
    Both tensors lie on one device and hold the same number of bytes."""
    ua, ub = tensor_bytes_u8(a), tensor_bytes_u8(b)
    if a.is_cuda and b.is_cuda:
        if ua.numel() == 0:
            _check(ua, ub, chunk_bytes)
            return torch.zeros((0,), dtype=torch.int32, device=a.device)
        return block_diff_cuda(ua, ub, chunk_bytes)
    if a.device.type == b.device.type == "cpu":
        return block_diff_plain(ua, ub, chunk_bytes)
    raise ValueError(f"block_diff: unsupported devices {a.device}, "
                     f"{b.device}")


def dirty_chunks(a: torch.Tensor, b: torch.Tensor,
                 chunk_bytes: int = 1 << 18) -> np.ndarray:
    """Indices of the chunks where ``a`` and ``b`` differ, as a host int64
    array (the flags are read back once)."""
    return np.flatnonzero(block_diff(a, b, chunk_bytes).cpu().numpy())
