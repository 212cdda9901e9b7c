"""A device tensor's chunks streamed to the host through a reused staging
ring — the full-serialize path of ``core/checkpoint.py`` for CUDA bases.

A commit that writes a CUDA tensor whole (a new or restructured
co-variable, or one whose every chunk is dirty) copies its byte image off
the card segment by segment into a few host segments that the writer keeps
across commits: pinned, so the copies run at PCIe rate, and reused, so no
commit allocates or page-faults its staging.  Segment *k*'s copy is queued
on a side stream (which first waits for the current stream, so it sees the
cell's last write) while earlier segments are consumed; its event says when
the host may read it.

Each chunk leaves its segment once, into a new ``bytes`` of exactly its
length — the object the chunk store and the chunk cache then keep — and is
keyed (``chunkstore.chunk_key``) as it lands, on the shared pool.  The
``bytes`` are made uninitialised on the calling thread, all before the pool
starts, and filled on the pool with the interpreter lock released
(``ctypes.memmove``) before anything else sees them, so the pool's threads
copy, page-fault and key in parallel; ``bytes(view)`` would hold the lock
through each copy.  A segment is recycled only once every chunk read from
it has been copied.
"""
from __future__ import annotations

import ctypes
from concurrent.futures import Future, wait
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.core import parallel
from repro_torch.core.chunkstore import chunk_key

SEG_BYTES = 16 << 20     # staging bytes a segment (a whole number of chunks,
                         # at least one)
SLOTS = 4                # segments in the ring: two in flight off the card
                         # while two are copied and keyed

# PyBytes_FromStringAndSize(NULL, n): an uninitialised bytes of length n
_new_bytes = ctypes.PYFUNCTYPE(ctypes.py_object, ctypes.c_void_p,
                               ctypes.c_ssize_t)(
    ("PyBytes_FromStringAndSize", ctypes.pythonapi))


def empty_bytes(n: int) -> bytes:
    """A new, uninitialised ``bytes`` of length ``n`` > 0 (a length of 0
    would be the shared empty ``bytes``), for :func:`fill_bytes` to fill
    before anything else sees it."""
    return _new_bytes(None, n)


def fill_bytes(out: bytes, addr: int) -> None:
    """Copy ``len(out)`` bytes from host address ``addr`` into ``out``,
    made by :func:`empty_bytes`, with the interpreter lock released."""
    ctypes.memmove(ctypes.cast(ctypes.c_char_p(out), ctypes.c_void_p).value,
                   addr, len(out))


def _fill_and_key(addr: int, chunks: Sequence[Tuple[int, bytes]]
                  ) -> List[str]:
    """Fill each ``(offset, bytes)`` from the segment at ``addr``; the
    chunks' keys."""
    keys = []
    for off, out in chunks:
        fill_bytes(out, addr + off)
        keys.append(chunk_key(out))
    return keys


class StagingRing:
    """``SLOTS`` reused host segments of ``SEG_BYTES`` (rounded down to
    whole chunks) that one writer streams its tensors' bytes through.

    ``device_type`` is the device whose tensors it takes: ``"cuda"``
    (staging pinned, copies queued on a side stream of the tensor's card,
    an event a segment), or ``"cpu"``, where the staging is plain host
    memory and each copy completes before the next step — the same code
    path without a card.  The staging is allocated at first use and grows
    only when a commit needs larger segments."""

    def __init__(self, device_type: str = "cuda"):
        self.device_type = device_type
        self._host = torch.empty(0, dtype=torch.uint8)
        self._sides: Dict[torch.device, torch.cuda.Stream] = {}

    def takes(self, t) -> bool:
        """Whether ``t`` (a base's byte image) streams through this ring."""
        return isinstance(t, torch.Tensor) \
            and t.device.type == self.device_type

    def _staging(self, slot_bytes: int) -> torch.Tensor:
        if self._host.numel() < SLOTS * slot_bytes:
            self._host = torch.empty(SLOTS * slot_bytes, dtype=torch.uint8,
                                     pin_memory=self.device_type == "cuda")
        return self._host

    def stream(self, u8: torch.Tensor, chunk_bytes: int,
               want: Sequence[bool],
               land: Callable[[List[Tuple[int, bytes, str]]], None]
               ) -> None:
        """Copy the flat uint8 tensor ``u8`` off its device segment by
        segment; copy and key each chunk ``i`` with ``want[i]`` on the pool,
        and call ``land`` on the calling thread with each segment's
        ``(index, bytes, key)`` in index order, segment after segment.
        Records ``d2h`` spans around the copies' enqueue and the waits for
        them, and ``chunk_keys`` spans around the waits for the pool."""
        if u8.dtype != torch.uint8 or u8.dim() != 1:
            raise ValueError("stream: a flat uint8 tensor is required")
        n = u8.numel()
        n_chunks = -(-n // chunk_bytes)
        per = max(1, SEG_BYTES // chunk_bytes)          # chunks a segment
        seg = per * chunk_bytes
        n_segs = -(-n_chunks // per)
        slot_bytes = min(seg, n_chunks * chunk_bytes)
        host = self._staging(slot_bytes)
        base_addr = host.data_ptr()
        side = None
        if self.device_type == "cuda":
            side = self._sides.get(u8.device)
            if side is None:
                side = self._sides[u8.device] = torch.cuda.Stream(u8.device)
            side.wait_stream(torch.cuda.current_stream(u8.device))
        workers = parallel.resolve_io_threads()
        marks: Dict[int, object] = {}      # segment -> its copy's event
        tasks: Dict[int, List[Future]] = {}
        # every chunk's object is made here, before the pool starts: made
        # on the pool, or while it page-faults, each allocation would wait
        # on those faults for the process's memory map
        made: List[List[Tuple[int, bytes]]] = [[] for _ in range(n_segs)]
        for i in range(n_chunks):
            if want[i]:
                made[i // per].append((i, empty_bytes(
                    min((i + 1) * chunk_bytes, n) - i * chunk_bytes)))

        def start_copy(j: int) -> None:
            lo, hi = j * seg, min((j + 1) * seg, n)
            s = (j % SLOTS) * slot_bytes
            dst = host[s:s + hi - lo]
            if side is None:
                dst.copy_(u8[lo:hi])
                marks[j] = None
                return
            with torch.cuda.stream(side):
                dst.copy_(u8[lo:hi], non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(side)
            marks[j] = ev

        def submit(j: int) -> None:
            with obs.span("d2h"):
                if marks[j] is not None:
                    marks[j].synchronize()
            del marks[j]
            outs = [(i * chunk_bytes - j * seg, out) for i, out in made[j]]
            step = -(-len(outs) // workers) if outs else 1
            addr = base_addr + (j % SLOTS) * slot_bytes
            tasks[j] = [parallel.submit(_fill_and_key, addr,
                                        outs[k:k + step])
                        for k in range(0, len(outs), step)]

        def gather(j: int) -> List[Tuple[int, bytes, str]]:
            with obs.span("chunk_keys"):
                keys = [k for f in tasks[j] for k in f.result()]
            del tasks[j]
            landed, made[j] = made[j], []
            return [(i, out, k) for (i, out), k in zip(landed, keys)]

        try:
            with obs.span("d2h"):
                for j in range(min(SLOTS, n_segs)):
                    start_copy(j)
            for j in range(n_segs):
                submit(j)
                if j:
                    landed = gather(j - 1)  # slot of j - 1 is free again
                    if j - 1 + SLOTS < n_segs:
                        with obs.span("d2h"):
                            start_copy(j - 1 + SLOTS)
                    land(landed)
            if n_segs:
                land(gather(n_segs - 1))
        finally:
            # on an error, nothing may still read or fill the staging
            wait([f for fs in tasks.values() for f in fs])
            for ev in marks.values():
                if ev is not None:
                    ev.synchronize()
