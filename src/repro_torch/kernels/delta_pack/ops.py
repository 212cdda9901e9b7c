"""Public wrapper for the fused on-device delta pipeline.

``delta_pack(x, prev_hashes, chunk_bytes)`` runs one fused pass (hash +
diff + compaction) over a tensor and returns a :class:`DeltaPack`: the new
detection hashes, the dirty-chunk indices, and the *compacted* dirty rows
still on the tensor's device.  The checkpoint writer then moves only the
dirty rows to the host (:meth:`DeltaPack.read_chunks`) or, with the
bit-plane codec, only their stored planes
(:meth:`DeltaPack.read_chunks_encoded`).

For a CUDA tensor the kernel launches (or raises); for a CPU tensor the
plain torch version runs.  Device->host copies of the rows go through a
pinned buffer on a side stream in segments, each with its own event, so
the host consumes segment *i* while segment *i+1* is still in flight —
the part of the JAX wrapper's ``copy_to_host_async`` double-buffering that
a GPU needs (the JAX wrapper also segmented launches to bound VMEM, which
a GPU does not).

Traffic accounting: ``bytes_transferred`` counts every byte this pack
moved device->host — 12 bytes per chunk of hashes and flags, 4 of the
count, plus the rows or planes actually copied.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import hashing
from repro_torch.core.serialize import tensor_bytes_u8
from repro_torch.kernels import _lib
from repro_torch.kernels.delta_codec.ops import i32_bits

D2H_SEG_BYTES = 16 << 20        # rows per pinned device->host segment
PROBE_SEG_BYTES = 4 << 20       # the codec probe samples the dirty rows of
                                # one such window, as the JAX wrapper's
                                # per-launch segment, so both packages pick
                                # the codec for the same chunks


def d2h_segments(t: torch.Tensor, seg_rows: int
                 ) -> Iterator[Tuple[int, np.ndarray]]:
    """Yield ``(first_row, host rows)`` of a 2-D tensor in segments of
    ``seg_rows``.  For a CUDA tensor every segment's copy is queued at once
    on a side stream into pinned memory, with one event per segment, so the
    consumer works on segment *i* while later ones are in flight."""
    if not t.is_cuda:
        yield 0, t.numpy()
        return
    main = torch.cuda.current_stream(t.device)
    side = torch.cuda.Stream(device=t.device)
    side.wait_stream(main)                  # t was written on main
    host = torch.empty(tuple(t.shape), dtype=t.dtype, pin_memory=True)
    marks = []
    with torch.cuda.stream(side):
        for lo in range(0, t.shape[0], seg_rows):
            hi = min(lo + seg_rows, t.shape[0])
            host[lo:hi].copy_(t[lo:hi], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(side)
            marks.append((lo, hi, ev))
    t.record_stream(side)                   # keep t's memory until copied
    for lo, hi, ev in marks:
        ev.synchronize()
        yield lo, host[lo:hi].numpy()


# ---------------------------------------------------------------------------
# the kernel and its plain version
# ---------------------------------------------------------------------------

def delta_pack_cuda(u8: torch.Tensor, prev: torch.Tensor, chunk_bytes: int):
    """Launch the kernel on a flat contiguous CUDA uint8 tensor.

    ``prev`` is int32 [n, 2] (the previous hash lanes' bits) on the same
    card.  Returns (hashes int32 [n, 2], dirty int32 [n], pos int32 [n],
    count, buf int32 [count, chunk_bytes // 4]) — ``buf`` holds the dirty
    chunks in ascending chunk order, zero past each chunk's true length."""
    nbytes = u8.numel()
    n = -(-nbytes // chunk_bytes)
    if nbytes == 0 or chunk_bytes % 4 or tuple(prev.shape) != (n, 2) \
            or prev.dtype != torch.int32 or prev.device != u8.device:
        raise ValueError("delta_pack: bad operands")
    dev = u8.device
    prev = prev.contiguous()
    hashes = torch.zeros((n, 2), dtype=torch.int32, device=dev)
    dirty = torch.empty((n,), dtype=torch.int32, device=dev)
    pos = torch.empty((n,), dtype=torch.int32, device=dev)
    count_d = torch.empty((1,), dtype=torch.int32, device=dev)
    splits = _lib.splits_for(n, chunk_bytes)
    with torch.cuda.device(dev):
        stream = _lib.stream_of(u8)
        _lib.call("kishu_delta_pack_scan", u8.data_ptr(), nbytes,
                  chunk_bytes, splits, prev.data_ptr(), hashes.data_ptr(),
                  dirty.data_ptr(), pos.data_ptr(), count_d.data_ptr(),
                  stream)
        count = int(count_d.item())
        buf = torch.empty((count, chunk_bytes // 4), dtype=torch.int32,
                          device=dev)
        if count:
            _lib.call("kishu_delta_pack_gather", u8.data_ptr(), nbytes,
                      chunk_bytes, splits, pos.data_ptr(), buf.data_ptr(),
                      stream)
    _lib.note_launch("delta_pack")
    return hashes, dirty, pos, count, buf


def delta_pack_plain(u8: torch.Tensor, prev: torch.Tensor, chunk_bytes: int):
    """Plain torch version: ``prev`` int64 [n, 2] (uint32 values).  Returns
    (hashes int64 [n, 2], dirty int64 [n], pos int64 [n], count,
    buf int64 [count, chunk_bytes // 4]) — the compaction order is a stable
    argsort of the negated dirty flags, as in the JAX ``ref.py``."""
    words = hashing.words_of_bytes(u8, chunk_bytes)
    nb = torch.from_numpy(hashing.chunk_nbytes(u8.numel(), chunk_bytes)) \
        .to(u8.device)
    hashes = hashing.hash_words_plain(words, nb)
    dirty = (hashes != prev).any(dim=1)
    cum = torch.cumsum(dirty.to(torch.int64), dim=0)
    pos = torch.where(dirty, cum - 1, torch.full_like(cum, -1))
    count = int(cum[-1])
    order = torch.argsort((~dirty).to(torch.int8), stable=True)
    return hashes, dirty.to(torch.int64), pos, count, words[order[:count]]


# ---------------------------------------------------------------------------
# the pack the checkpoint writer consumes
# ---------------------------------------------------------------------------

@dataclass
class DeltaPack:
    """Result of one fused delta pass: detection hashes + dirty indices on
    host, compacted dirty rows (int32 [count, W], uint32 bits) still on the
    tensor's device."""
    nbytes: int
    chunk_bytes: int
    n_chunks: int
    hashes: np.ndarray           # uint64 [n_chunks] detection hashes
    dirty: np.ndarray            # ascending dirty-chunk indices (int64)
    buf: torch.Tensor            # row r = chunk dirty[r]
    bytes_transferred: int = 0   # device->host bytes moved so far
    codec_chunks_encoded: int = 0    # chunks that crossed PCIe as frames
    codec_chunks_skipped: int = 0    # probe veto / frame larger than raw

    @property
    def count(self) -> int:
        return int(self.dirty.size)

    @property
    def dirty_set(self) -> set:
        return set(int(i) for i in self.dirty)

    def _chunk_len(self, i: int) -> int:
        return min((i + 1) * self.chunk_bytes, self.nbytes) \
            - i * self.chunk_bytes

    def _want(self, indices: Optional[Iterable[int]]) -> List[int]:
        """Requested chunk indices, ascending; each must be dirty here."""
        want = sorted(set(int(i) for i in indices)) if indices is not None \
            else [int(i) for i in self.dirty]
        bad = [i for i in want if not (0 <= i < self.n_chunks)]
        if bad:
            raise IndexError(f"chunk indices out of range: {bad[:4]}")
        dirty = self.dirty_set
        missing = [i for i in want if i not in dirty]
        if missing:
            raise KeyError(f"chunks {missing[:4]} are not dirty in this pack")
        return want

    def _rowmap(self) -> dict:
        return {int(ci): r for r, ci in enumerate(self.dirty)}

    def read_chunks(self, indices: Optional[Iterable[int]] = None
                    ) -> Iterator[Tuple[int, bytes]]:
        """Yield ``(chunk_index, chunk_bytes)`` for the requested dirty
        chunks in ascending index order, moving only compacted rows."""
        want = self._want(indices)
        if not want:
            return
        rowmap = self._rowmap()
        rows = sorted(rowmap[ci] for ci in want)
        lo, hi = rows[0], rows[-1] + 1          # ascending rows, one span
        seg = max(1, D2H_SEG_BYTES // self.chunk_bytes)
        wanted = set(want)
        for r0, host in d2h_segments(self.buf[lo:hi], seg):
            self.bytes_transferred += host.nbytes
            raw = host.view(np.uint8)
            for k in range(raw.shape[0]):
                ci = int(self.dirty[lo + r0 + k])
                if ci in wanted:
                    yield ci, raw[k, : self._chunk_len(ci)].tobytes()

    def _probe_rows(self, first: int) -> torch.Tensor:
        """The dirty rows of the PROBE_SEG_BYTES window holding ``first``."""
        seg = max(1, PROBE_SEG_BYTES // self.chunk_bytes)
        s0 = (first // seg) * seg
        lo, hi = np.searchsorted(self.dirty, [s0, s0 + seg])
        return self.buf[int(lo):int(hi)]

    def read_chunks_encoded(self, indices: Optional[Iterable[int]] = None
                            ) -> Iterator[Tuple[int, bytes,
                                                Optional[bytes]]]:
        """Like :meth:`read_chunks`, but encode the rows *on device* with
        the bit-plane codec before they cross PCIe: yields ``(chunk_index,
        logical_bytes, stored_frame)`` where ``stored_frame`` is a
        ready-to-store KZC1 frame (None when the chunk goes raw — rows too
        narrow for a group, probe veto, or the frame would not save bytes).
        Chunk keys stay logical-byte: the logical bytes are rebuilt
        host-side from the masks and planes the frames hold, so the raw
        rows never cross."""
        from repro_torch.kernels.delta_codec import host as codec_host
        from repro_torch.kernels.delta_codec import ops as codec_ops

        want = self._want(indices)
        if not want:
            return
        width = self.chunk_bytes // 4
        engage = (width >= codec_host.MIN_GROUP_WORDS
                  and codec_ops.probe_device_rows(self._probe_rows(want[0])))
        if not engage:
            self.codec_chunks_skipped += len(want)
            for ci, data in self.read_chunks(want):
                yield ci, data, None
            return
        with obs.span("encode_dev", rows=self.count):
            masks, planes_dev, gw = codec_ops.encode_rows(self.buf)
        planes = np.concatenate(
            [h for _, h in d2h_segments(planes_dev, 1 << 20)]
            or [np.zeros((0, gw // 32), np.int32)]).view(np.uint32)
        self.bytes_transferred += masks.nbytes + planes.nbytes
        frames = codec_host.frames_from_encoded(
            masks, planes, width // gw, gw,
            [self._chunk_len(int(ci)) for ci in self.dirty])
        # the logical bytes (the chunk keys hash them) are rebuilt on the
        # host from the masks and planes of every row in one vectorised
        # pass — what decoding each frame gives; the raw rows never cross
        rows = codec_host.words_from_planes(masks, planes, gw) \
            .reshape(self.count, width).view(np.uint8)
        rowmap = self._rowmap()
        for ci in want:
            frame = frames[rowmap[ci]]
            logical = rows[rowmap[ci], :self._chunk_len(ci)].tobytes()
            if len(frame) < len(logical):
                self.codec_chunks_encoded += 1
                yield ci, logical, frame
            else:                       # frame saves nothing: store raw
                self.codec_chunks_skipped += 1
                yield ci, logical, None


def delta_pack(x: torch.Tensor, prev_hashes, chunk_bytes: int) -> DeltaPack:
    """Fused hash + diff + compaction of a tensor against the previous
    commit's detection hashes (uint64 [n_chunks], the previous LeafRecord's
    ``base_hashes``).  ``chunk_bytes`` must be a multiple of 4.  The
    returned hashes are bit-identical to ``hashing.chunk_hashes_np``."""
    if chunk_bytes <= 0 or chunk_bytes % 4:
        raise ValueError(f"chunk_bytes {chunk_bytes} not word-aligned")
    u8 = tensor_bytes_u8(x)
    nbytes = u8.numel()
    if nbytes == 0:
        return DeltaPack(nbytes=0, chunk_bytes=chunk_bytes, n_chunks=0,
                         hashes=np.zeros((0,), np.uint64),
                         dirty=np.zeros((0,), np.int64),
                         buf=torch.zeros((0, chunk_bytes // 4),
                                         dtype=torch.int32, device=x.device))
    n = -(-nbytes // chunk_bytes)
    prev = np.asarray(prev_hashes, dtype=np.uint64).reshape(-1)
    if prev.shape != (n,):
        raise ValueError(f"prev_hashes {prev.shape} for {n} chunks")
    prev32 = hashing.split_u64(prev)
    if x.is_cuda:
        prev_t = torch.from_numpy(prev32.view(np.int32)).to(x.device)
        h, d, _pos, _count, buf = delta_pack_cuda(u8, prev_t, chunk_bytes)
        lanes = h.cpu().numpy().view(np.uint32)
        dflags = d.cpu().numpy()
    elif x.device.type == "cpu":
        h, d, _pos, _count, buf = delta_pack_plain(
            u8, torch.from_numpy(prev32.astype(np.int64)), chunk_bytes)
        lanes = h.numpy().astype(np.uint32)
        dflags = d.numpy()
        buf = i32_bits(buf)
    else:
        raise ValueError(f"delta_pack: unsupported device {x.device}")
    dirty = np.flatnonzero(dflags).astype(np.int64)
    if dirty.size != buf.shape[0]:
        raise RuntimeError(f"delta_pack: {dirty.size} dirty flags but "
                           f"{buf.shape[0]} compacted rows")
    return DeltaPack(nbytes=nbytes, chunk_bytes=chunk_bytes, n_chunks=n,
                     hashes=hashing.combine_u64(lanes), dirty=dirty, buf=buf,
                     bytes_transferred=n * 12 + 4)
