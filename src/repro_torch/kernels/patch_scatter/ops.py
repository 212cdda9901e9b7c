"""Bytes-in wrappers for the fused checkout scatter.

``scatter_chunks`` takes the live tensor, the dirty chunk indices and their
logical bytes (as fetched from the store), and writes every chunk into the
tensor's storage *in place* — views and aliases of the tensor stay valid,
as for a numpy base.  For a CUDA tensor the rows are staged in pinned
memory, uploaded with one copy on the current stream (so the kernel, on
the same stream, runs after it and the pinned block is not reused before
the copy ends), and landed by one kernel launch (or the call raises).  For
a CPU tensor the plain torch version writes the bytes.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import _lib


def rows_from_blobs(blobs: Sequence[bytes], width: int, *,
                    pin: bool = False) -> torch.Tensor:
    """Pack per-chunk bytes into a CPU int32 [K, width] row buffer (zero
    tail past a short chunk); pinned when ``pin``."""
    rows = torch.zeros((len(blobs), width), dtype=torch.int32,
                       pin_memory=pin)
    raw = rows.numpy().view(np.uint8)
    for r, blob in enumerate(blobs):
        raw[r, :len(blob)] = np.frombuffer(blob, np.uint8)
    return rows


def patch_scatter_plain(dst_u8: torch.Tensor, chunk_bytes: int,
                        idx: Sequence[int], rows: torch.Tensor) -> None:
    """Plain torch version: chunk ``idx[k]`` of the flat uint8 tensor
    ``dst_u8`` gets the first bytes of row k (int32 [K, W]), in place and
    cut at the tensor's end."""
    n = dst_u8.numel()
    rows_u8 = rows.view(torch.uint8)
    for k, c in enumerate(idx):
        lo = int(c) * chunk_bytes
        hi = min(lo + chunk_bytes, n)
        dst_u8[lo:hi] = rows_u8[k, : hi - lo]


def patch_scatter_cuda(dst_u8: torch.Tensor, chunk_bytes: int,
                       idx: torch.Tensor, rows: torch.Tensor) -> None:
    """Launch the kernel: ``dst_u8`` flat contiguous CUDA uint8 (the live
    tensor's bytes), ``idx`` int32 [K] and ``rows`` int32 [K, W] on the
    same card, indices already checked."""
    k = int(idx.numel())
    if rows.dtype != torch.int32 or tuple(rows.shape) != \
            (k, chunk_bytes // 4) or not rows.is_contiguous() \
            or idx.dtype != torch.int32:
        raise ValueError("patch_scatter: bad operands")
    if k == 0:
        return
    splits = _lib.splits_for(k, chunk_bytes)
    with torch.cuda.device(dst_u8.device):
        _lib.call("kishu_patch_scatter", dst_u8.data_ptr(), dst_u8.numel(),
                  chunk_bytes, splits, idx.data_ptr(), k, rows.data_ptr(),
                  _lib.stream_of(dst_u8))
    _lib.note_launch("patch_scatter")


def scatter_chunks(x: torch.Tensor, idx: Sequence[int],
                   blobs: Sequence[bytes], chunk_bytes: int) -> int:
    """Patch chunks ``idx`` of tensor ``x`` with ``blobs`` in place (``x``
    contiguous; each blob the chunk's full logical length).  Returns the
    bytes moved host->device."""
    if chunk_bytes <= 0 or chunk_bytes % 4:
        raise ValueError(f"chunk_bytes {chunk_bytes} not word-aligned")
    if not x.is_contiguous():
        raise ValueError("scatter target must be contiguous")
    if not blobs:
        return 0
    dst = x.reshape(-1).view(torch.uint8)
    nbytes = dst.numel()
    n_chunks = -(-nbytes // chunk_bytes)
    idx_np = np.asarray(idx, np.int64)
    if idx_np.shape != (len(blobs),) or idx_np.min() < 0 \
            or idx_np.max() >= n_chunks:
        raise ValueError("chunk indices out of range")
    for c, blob in zip(idx_np, blobs):
        if len(blob) != min(chunk_bytes, nbytes - int(c) * chunk_bytes):
            raise ValueError(f"chunk {int(c)}: {len(blob)} bytes")
    width = chunk_bytes // 4
    if x.is_cuda:
        rows = rows_from_blobs(blobs, width, pin=True)
        idx_h = torch.from_numpy(idx_np.astype(np.int32))
        moved = rows.numel() * 4 + idx_h.numel() * 4
        rows_d = rows.to(x.device, non_blocking=True)
        idx_d = idx_h.to(x.device)
        patch_scatter_cuda(dst, chunk_bytes, idx_d, rows_d)
        return moved
    if x.device.type != "cpu":
        raise ValueError(f"scatter_chunks: unsupported device {x.device}")
    rows = rows_from_blobs(blobs, width)
    patch_scatter_plain(dst, chunk_bytes, idx_np.tolist(), rows)
    return rows.numel() * 4 + len(blobs) * 4
