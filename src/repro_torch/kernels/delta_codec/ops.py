"""Wrappers for the on-device bit-plane encoder.

``encode_rows`` encodes a compacted dirty-chunk buffer (``DeltaPack``'s
rows) where it lies and returns the masks on host plus the plane stream
still on the device — the caller moves only the stored planes across PCIe.
For a CUDA tensor the CUDA kernel launches (or raises); for a CPU tensor
the plain torch version below runs.  Both emit the stream
``host.bitplane_compress`` defines, byte for byte.

Unlike the JAX wrapper, rows are not padded to a power of two: that only
bounded jit shapes, and nothing here is compiled per shape.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.hashing import MASK32
from repro_torch.kernels import _lib
from repro_torch.kernels.delta_codec import host


def group_words_for(width: int) -> int:
    """Device group size for a W-word chunk row: one group per row when the
    row fits a group, else the largest group that tiles the row."""
    return min(host.GROUP_WORDS, width)


def u32_values(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 holding the uint32 values."""
    return t.to(torch.int64) & MASK32


def i32_bits(t: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values -> int32 with the same bits."""
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)


def codec_encode_plain(rows: torch.Tensor, gw: int
                       ) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """Plain torch encode of int64 ``rows`` [R, W] (uint32 values).

    Returns (masks int64 [R*W//gw, 2] as (stored_mask, ones_mask),
    n_stored, planes int64 [n_stored, gw//32]) — stored planes in (group,
    plane) order, the order a stable sort of the negated store flags
    gives."""
    r, w = rows.shape
    ng, pw = r * (w // gw), gw // 32
    grouped = rows.reshape(ng, pw, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=rows.device)
    planes = torch.stack(
        [(((grouped >> p) & 1) << shifts).sum(dim=2) for p in range(32)],
        dim=1)                                            # [ng, 32, pw]
    zero = (planes == 0).all(dim=2)
    ones = (planes == MASK32).all(dim=2)
    store = ~zero & ~ones
    smask = (store.to(torch.int64) << shifts).sum(dim=1)
    omask = (ones.to(torch.int64) << shifts).sum(dim=1)
    flags = store.reshape(-1)
    order = torch.argsort((~flags).to(torch.int8), stable=True)
    n_stored = int(flags.sum())
    stored = planes.reshape(ng * 32, pw)[order[:n_stored]]
    return torch.stack([smask, omask], dim=1), n_stored, stored


def codec_encode_cuda(rows: torch.Tensor, gw: int
                      ) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """Launch the kernel on contiguous CUDA int32 ``rows`` [R, W] (uint32
    bits).  Returns (masks int32 [ng, 2], n_stored, planes int32
    [n_stored, gw//32]), bit patterns of the plain version's values."""
    if rows.dtype != torch.int32 or rows.dim() != 2 \
            or not rows.is_contiguous():
        raise ValueError("codec rows must be contiguous int32 [R, W]")
    r, w = rows.shape
    if gw < host.MIN_GROUP_WORDS or gw > host.GROUP_WORDS or gw & (gw - 1) \
            or w % gw:
        raise ValueError(f"codec: row width {w} / group {gw} not eligible")
    ng = r * (w // gw)
    dev = rows.device
    masks = torch.empty((ng, 2), dtype=torch.int32, device=dev)
    offsets = torch.empty((ng,), dtype=torch.int32, device=dev)
    total = torch.empty((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = _lib.stream_of(rows)
        _lib.call("kishu_codec_classify", rows.data_ptr(), ng, gw,
                  masks.data_ptr(), offsets.data_ptr(), total.data_ptr(),
                  stream)
        n_stored = int(total.item())
        planes = torch.empty((n_stored, gw // 32), dtype=torch.int32,
                             device=dev)
        if n_stored:
            _lib.call("kishu_codec_emit", rows.data_ptr(), ng, gw,
                      masks.data_ptr(), offsets.data_ptr(), planes.data_ptr(),
                      stream)
    _lib.note_launch("delta_codec")
    return masks, n_stored, planes


def encode_rows(rows: torch.Tensor) -> Tuple[np.ndarray, torch.Tensor, int]:
    """Encode int32 ``rows`` [R, W] (uint32 bits; R >= 1, W a power of two
    >= MIN_GROUP_WORDS) where they lie.

    Returns (masks np.uint32 [R*gpr, 2], planes int32 [n_stored, gw//32]
    still on the rows' device, gw)."""
    r, w = int(rows.shape[0]), int(rows.shape[1])
    gw = group_words_for(w)
    if gw < host.MIN_GROUP_WORDS or w % gw:
        raise ValueError(f"row width {w} not codec-eligible")
    if rows.is_cuda:
        masks, _, planes = codec_encode_cuda(rows, gw)
        return masks.cpu().numpy().view(np.uint32), planes, gw
    if rows.device.type != "cpu":
        raise ValueError(f"encode_rows: unsupported device {rows.device}")
    masks, _, planes = codec_encode_plain(u32_values(rows), gw)
    return masks.numpy().astype(np.uint32), i32_bits(planes), gw


def probe_device_rows(rows: torch.Tensor, max_rows: int = 4,
                      sample_words: int = 256) -> bool:
    """Device-side analogue of ``host.bitplane_probe``: pull a small word
    sample from the compacted buffer (a few hundred bytes over PCIe) and
    estimate whether the encode is worth launching at all."""
    r, w = int(rows.shape[0]), int(rows.shape[1])
    if r == 0:
        return False
    take = min(r, max_rows)
    step = max(1, (take * w) // sample_words)
    sample = rows[:take].reshape(-1)[::step][:sample_words]
    words = sample.cpu().numpy().view(np.uint32)
    return host.estimate_stored_fraction(words) < host.PROBE_THRESHOLD
