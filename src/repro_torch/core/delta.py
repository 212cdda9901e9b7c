"""Chunk-granular delta planning — shared by the writer and the loader.

Both hot paths move *only the state difference* (the paper's headline):

  - the checkpoint writer serializes just the dirty byte ranges of an
    updated base buffer (checkpoint.build_manifest), and
  - the checkout loader fetches and patches just the chunks that differ
    between the live buffer and the target manifest (checkout.StateLoader).

This module holds the pieces both need: dirty-index computation from
detection hashes, run coalescing, zero-copy/device-sliced range readers,
the fused on-device delta pack (writer side) and the fused in-place scatter
(loader side).

Range extraction never materializes the full buffer: numpy bases are read
through a zero-copy ``memoryview``; tensors are sliced where they lie, so
only the dirty ranges cross the device→host boundary.

For a tensor the device path is the rule: a CUDA tensor launches the CUDA
kernels (or raises), a CPU tensor runs their plain torch versions.  Only
structural reasons return ``None``: no previous hashes, a chunk size that
is not a power of two, a changed shape, a non-aligned segment.
"""
from __future__ import annotations

import contextlib
import logging
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.serialize import tensor_bytes_u8

_log = logging.getLogger(__name__)

# Degradation observability: every demotion to a slower path (a patch chunk
# missing from the store, a patch that failed to apply) bumps a counter
# (snapshotted into WriteStats/CheckoutStats per operation) and the *first*
# one per session logs a warning.  The counter lives in the *active
# session's* metrics registry (repro_torch.obs.active()) when a session is
# executing; the module globals below are the process-wide total for
# callers running outside any session.
_kernel_fallbacks = 0
_fallback_logged = False


def _active_obs():
    from repro_torch import obs as _obs
    return _obs.active()


def note_kernel_fallback(where: str, err: Exception) -> None:
    """Record one degradation to a slower path."""
    global _kernel_fallbacks, _fallback_logged
    _kernel_fallbacks += 1          # process-wide shim stays monotonic
    o = _active_obs()
    if o is not None:
        first = o.note_kernel_fallback(where)
    else:
        first = not _fallback_logged
        _fallback_logged = True
    if first:
        _log.warning(
            "degraded path in %s (%s: %s). Logged once per session — see "
            "the kernel_fallbacks counter in WriteStats/CheckoutStats for "
            "the running total.", where, type(err).__name__, err)


def kernel_fallbacks() -> int:
    """Total degradations — scoped to the active session's metrics registry
    when one is executing; otherwise the process-wide total."""
    o = _active_obs()
    if o is not None:
        return o.kernel_fallbacks()
    return _kernel_fallbacks


def dirty_indices(prev_hex: Sequence[str], cur_hex: Sequence[str]) -> List[int]:
    """Chunk indices whose detection hash differs (index-aligned compare).
    Indices present on only one side count as dirty."""
    n = max(len(prev_hex), len(cur_hex))
    return [i for i in range(n)
            if i >= len(prev_hex) or i >= len(cur_hex)
            or prev_hex[i] != cur_hex[i]]


def coalesce(indices: Sequence[int]) -> List[Tuple[int, int]]:
    """Sorted chunk indices -> [start, stop) runs, merging adjacency (one
    device slice / one store range per run instead of one per chunk)."""
    runs: List[Tuple[int, int]] = []
    for i in sorted(indices):
        if runs and runs[-1][1] == i:
            runs[-1] = (runs[-1][0], i + 1)
        else:
            runs.append((i, i + 1))
    return runs


def chunk_offsets(chunks: Sequence[dict]) -> List[int]:
    """Byte offset of each chunk in the assembled base blob."""
    offs, pos = [], 0
    for c in chunks:
        offs.append(pos)
        pos += int(c["n"])
    return offs


# ---------------------------------------------------------------------------
# dirty-range readers (writer side)
# ---------------------------------------------------------------------------

def range_reader(base: Any, chunk_bytes: int) -> Optional[Callable[[int, int], bytes]]:
    """Callable ``(lo, hi) -> bytes`` over the logical byte image of an
    array base, moving only the requested range; ``None`` when the leaf
    cannot be range-read (non-array, non-contiguous numpy) — callers then
    fall back to full serialization.

    The byte image matches ``leaf_to_bytes`` (C-order raw bytes), so
    range-read chunks are bit-identical to full-path chunks.
    """
    if isinstance(base, np.ndarray):
        if not base.flags["C_CONTIGUOUS"]:
            return None
        try:
            mv = memoryview(base).cast("B")
        except (TypeError, ValueError, BufferError):
            return None
        return lambda lo, hi: bytes(mv[lo:hi])

    if isinstance(base, torch.Tensor):
        flat = tensor_bytes_u8(base)
        return lambda lo, hi: flat[lo:hi].cpu().numpy().tobytes()
    return None


# ---------------------------------------------------------------------------
# fused on-device delta pack (writer side, DESIGN.md §15)
# ---------------------------------------------------------------------------

def device_delta_pack(base: Any, prev_hashes, chunk_bytes: int):
    """One fused pass over a tensor: detection hashes, dirty indices, and a
    *compacted* dirty-chunk buffer still on the tensor's device — only
    dirty bytes ever cross device→host (``DeltaPack.read_chunks``).

    Returns ``None`` when the fused path does not apply — not a tensor, an
    empty one, non-power-of-two chunking, no or mismatched previous
    hashes — and the caller hashes with ``chunk_hashes_device`` and reads
    ranges with ``range_reader``.
    """
    if prev_hashes is None or chunk_bytes % 4 \
            or chunk_bytes & (chunk_bytes - 1):
        return None
    if not isinstance(base, torch.Tensor):
        return None
    nbytes = int(base.numel()) * base.element_size()
    if nbytes <= 0:
        return None
    n_chunks = -(-nbytes // chunk_bytes)
    prev = np.asarray(prev_hashes, dtype=np.uint64).reshape(-1)
    if prev.shape[0] != n_chunks:
        return None                      # structure changed: no valid diff
    from repro_torch.kernels.delta_pack.ops import delta_pack
    o = _active_obs()
    span = o.span("delta_pack", nbytes=nbytes) if o is not None \
        else contextlib.nullcontext()
    with span:
        return delta_pack(base, prev, chunk_bytes)


# ---------------------------------------------------------------------------
# chunk patching (loader side)
# ---------------------------------------------------------------------------

def patch_numpy_base(base: np.ndarray, segs: Sequence[Tuple[int, bytes]]
                     ) -> np.ndarray:
    """Write byte segments into a live base buffer in place (views and
    aliases into it stay valid).  Returns the same object."""
    mv = memoryview(base).cast("B")
    for off, data in segs:
        mv[off:off + len(data)] = data
    return base


def patch_tensor_base(base: torch.Tensor, segs: Sequence[Tuple[int, bytes]]
                      ) -> torch.Tensor:
    """Write byte segments into a contiguous tensor's storage in place, one
    host→device copy per segment (the path for segments the fused scatter
    cannot take).  Returns the same object."""
    flat = base.reshape(-1).view(torch.uint8)
    for off, data in segs:
        src = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
        flat[off:off + len(data)].copy_(src)
    return base


def patch_device_chunks(base: Any, segs: Sequence[Tuple[int, bytes]],
                        chunk_bytes: int) -> Optional[int]:
    """Fused checkout scatter: land all dirty chunks of a tensor in its
    storage in one pass (kernels/patch_scatter) — the mirror image of
    ``device_delta_pack``.  In place, so live views stay valid.

    Returns the bytes moved host→device, or ``None`` when the fused path
    does not apply — not a contiguous tensor, segments not whole chunks —
    and the caller writes the segments with :func:`patch_tensor_base`.
    """
    if not segs or chunk_bytes <= 0 or chunk_bytes % 4:
        return None
    if not isinstance(base, torch.Tensor) or not base.is_contiguous():
        return None
    nbytes = int(base.numel()) * base.element_size()
    if nbytes <= 0:
        return None
    n_chunks = -(-nbytes // chunk_bytes)
    idx: List[int] = []
    blobs: List[bytes] = []
    for off, data in sorted(segs):
        if off % chunk_bytes:
            return None                  # not chunk-aligned
        i = off // chunk_bytes
        want = min((i + 1) * chunk_bytes, nbytes) - off
        if i >= n_chunks or len(data) != want:
            return None                  # partial chunk
        idx.append(i)
        blobs.append(data)
    from repro_torch.kernels.patch_scatter.ops import scatter_chunks
    o = _active_obs()
    span = o.span("scatter_dev", chunks=len(idx)) if o is not None \
        else contextlib.nullcontext()
    with span:
        moved = scatter_chunks(base, idx, blobs, chunk_bytes)
    if o is not None:
        o.registry.counter("kishu_h2d_bytes_total").inc(moved)
    return moved
