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
length — the object the chunk store and the chunk cache then keep.  The
``bytes`` are made uninitialised on the calling thread, all before the pool
starts, and filled on the pool with the interpreter lock released
(``ctypes.memmove``) before anything else sees them, so the pool's threads
copy and page-fault in parallel; ``bytes(view)`` would hold the lock
through each copy.  A segment is recycled only once every chunk read from
it has been copied.

The chunks' keys (``chunkstore.chunk_key``) come from one key step a base,
queued before its first segment's copy: on a card, a launch of the
``chunk_key`` kernel over the base on a key stream (which also waits for
the current stream), its digests copied into pinned memory; on the CPU,
hashlib over the base at once.  Filled segments land in order once their
base's digests are there, so the pool only copies.  Within
:meth:`StagingRing.deferred` (one commit), a base whose digests are not
there when its last segment is filled is parked while the next base
streams, whose launch takes another key stream: a commit's chains run side
by side on the card.  Leaving it lands every parked base in the order they
streamed.  Outside it, a base lands before ``stream`` returns.
"""
from __future__ import annotations

import ctypes
import hashlib
from collections import deque
from concurrent.futures import Future, wait
from contextlib import contextmanager
from typing import (Callable, Deque, Dict, Iterator, List, Optional,
                    Sequence, Tuple)

import torch

from repro_torch import obs
from repro_torch.core import parallel
from repro_torch.kernels.chunk_key.ops import (DIGEST_BYTES, chunk_key_cuda,
                                               hex_keys)

SEG_BYTES = 16 << 20     # staging bytes a segment (a whole number of chunks,
                         # at least one)
SLOTS = 4                # segments in the ring: two in flight off the card
                         # while two are copied

# PyBytes_FromStringAndSize(NULL, n): an uninitialised bytes of length n
_new_bytes = ctypes.PYFUNCTYPE(ctypes.py_object, ctypes.c_void_p,
                               ctypes.c_ssize_t)(
    ("PyBytes_FromStringAndSize", ctypes.pythonapi))

Landing = Callable[[List[Tuple[int, bytes, str]]], None]


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


def _fill(addr: int, chunks: Sequence[Tuple[int, bytes]]) -> None:
    """Fill each ``(offset, bytes)`` from the segment at ``addr``."""
    for off, out in chunks:
        fill_bytes(out, addr + off)


class _Done:
    """The event of a key step that completed when it was queued."""

    @staticmethod
    def query() -> bool:
        return True

    @staticmethod
    def synchronize() -> None:
        pass


class _Base:
    """A streamed base whose filled chunks wait for its key step."""

    def __init__(self, u8: torch.Tensor, done, digests: torch.Tensor,
                 stream, land: Landing):
        self.u8 = u8                  # alive until the key step has read it
        self.done = done              # the key step's event
        self.digests = digests        # host uint8, 16 bytes a wanted chunk
        self.stream = stream          # the key stream (None on the CPU)
        self.land = land
        self.filled: List[List[Tuple[int, bytes]]] = []
        self.keys: Optional[Iterator[str]] = None
        self.streamed = False         # every segment filled


class StagingRing:
    """``SLOTS`` reused host segments of ``SEG_BYTES`` (rounded down to
    whole chunks) that one writer streams its tensors' bytes through.

    ``device_type`` is the device whose tensors it takes: ``"cuda"``
    (staging pinned, copies queued on a side stream of the tensor's card,
    an event a segment, the keys from the card), or ``"cpu"``, where the
    staging is plain host memory, each copy completes before the next step
    and the key step is hashlib's — the same code path without a card.
    The staging is allocated at first use and grows only when a commit
    needs more."""

    def __init__(self, device_type: str = "cuda"):
        self.device_type = device_type
        self._host = torch.empty(0, dtype=torch.uint8)
        self._sides: Dict[torch.device, torch.cuda.Stream] = {}
        self._key_streams: Dict[torch.device, List[torch.cuda.Stream]] = {}
        self._bases: Deque[_Base] = deque()    # streamed, not yet landed
        self._defer = False

    def takes(self, t) -> bool:
        """Whether ``t`` (a base's byte image) streams through this ring."""
        return isinstance(t, torch.Tensor) \
            and t.device.type == self.device_type

    def _staging(self, slot_bytes: int) -> torch.Tensor:
        if self._host.numel() < SLOTS * slot_bytes:
            self._host = torch.empty(SLOTS * slot_bytes, dtype=torch.uint8,
                                     pin_memory=self.device_type == "cuda")
        return self._host

    def _key_stream(self, dev: torch.device) -> torch.cuda.Stream:
        """A key stream of card ``dev`` that no parked base's launch is
        queued on."""
        pool = self._key_streams.setdefault(dev, [])
        for ks in pool:
            if all(b.stream is not ks for b in self._bases):
                return ks
        pool.append(torch.cuda.Stream(dev))
        return pool[-1]

    def _key(self, u8: torch.Tensor, chunk_bytes: int, idx: List[int]):
        """Queue the key step of chunks ``idx`` of ``u8``: its event, its
        host digests (16 bytes a chunk, filled once the event has
        completed) and its key stream.  On a card, one ``chunk_key``
        launch after the current stream's work, and the copy of its
        digests into pinned memory; on the CPU, hashlib now."""
        if not idx:
            return _Done(), torch.empty(0, dtype=torch.uint8), None
        if self.device_type != "cuda":
            view = memoryview(u8.numpy())
            digests = b"".join(
                hashlib.blake2b(view[i * chunk_bytes:(i + 1) * chunk_bytes],
                                digest_size=DIGEST_BYTES).digest()
                for i in idx)
            return _Done(), torch.frombuffer(bytearray(digests),
                                             dtype=torch.uint8), None
        ks = self._key_stream(u8.device)
        ks.wait_stream(torch.cuda.current_stream(u8.device))
        idx_host = torch.tensor(idx, dtype=torch.int64).pin_memory()
        with torch.cuda.stream(ks):
            dev_idx = idx_host.to(u8.device, non_blocking=True)
            dev_digests = chunk_key_cuda(u8, chunk_bytes, dev_idx)
            digests = torch.empty(len(idx) * DIGEST_BYTES, dtype=torch.uint8,
                                  pin_memory=True)
            digests.copy_(dev_digests.view(-1), non_blocking=True)
            done = torch.cuda.Event()
            done.record(ks)
        return done, digests, ks

    def _land(self, wait_keys: bool) -> None:
        """Land the filled chunks of the streamed bases, oldest first,
        each once its digests are there; with ``wait_keys``, wait for them
        (in ``chunk_keys`` spans), else stop at the first base whose key
        step is still running."""
        while self._bases:
            b = self._bases[0]
            if b.keys is None:
                if not b.done.query():
                    if not wait_keys:
                        return
                    with obs.span("chunk_keys"):
                        b.done.synchronize()
                b.keys = iter(hex_keys(b.digests.numpy()))
                b.u8 = None
            while b.filled:
                b.land([(i, out, next(b.keys)) for i, out in b.filled[0]])
                b.filled.pop(0)
            if not b.streamed:
                return
            self._bases.popleft()

    def _drop(self) -> None:
        """After an error: wait for every queued key step, land nothing."""
        for b in self._bases:
            b.done.synchronize()
        self._bases.clear()

    @contextmanager
    def deferred(self):
        """Within: ``stream`` leaves a base whose digests are not there
        yet to be landed later, so the next base streams meanwhile.
        Leaving lands every base, waiting for its digests (with them, in
        a ``write_whole`` span: the tail of those bases' whole writes).
        On an error, nothing more lands, and every key step is waited for
        before it propagates."""
        self._defer = True
        try:
            yield self
            if self._bases:
                with obs.span("write_whole"):
                    self._land(True)
        except BaseException:
            self._drop()
            raise
        finally:
            self._defer = False

    def stream(self, u8: torch.Tensor, chunk_bytes: int,
               want: Sequence[bool], land: Landing) -> int:
        """Copy the flat uint8 tensor ``u8`` off its device segment by
        segment; copy each chunk ``i`` with ``want[i]`` on the pool, and
        call ``land`` on the calling thread with each segment's ``(index,
        bytes, key)`` in index order, segment after segment, once the
        base's key step is done (in :meth:`deferred`, possibly after this
        returns).  Returns the number of chunks the key step keyed.
        Records ``d2h`` spans around the copies' enqueue and the waits for
        them, and ``chunk_keys`` spans around the waits for the pool and
        for the key step."""
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
        idx = [i for i in range(n_chunks) if want[i]]
        this = _Base(u8, *self._key(u8, chunk_bytes, idx), land)
        self._bases.append(this)
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
        for i in idx:
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
            tasks[j] = [parallel.submit(_fill, addr, outs[k:k + step])
                        for k in range(0, len(outs), step)]

        def gather(j: int) -> None:
            """Segment ``j``'s chunks, filled, wait to land; its slot is
            free again."""
            with obs.span("chunk_keys"):
                for f in tasks[j]:
                    f.result()
            del tasks[j]
            this.filled.append(made[j])
            made[j] = []

        try:
            with obs.span("d2h"):
                for j in range(min(SLOTS, n_segs)):
                    start_copy(j)
            for j in range(n_segs):
                submit(j)
                if j:
                    gather(j - 1)
                    if j - 1 + SLOTS < n_segs:
                        with obs.span("d2h"):
                            start_copy(j - 1 + SLOTS)
                    self._land(False)
            if n_segs:
                gather(n_segs - 1)
            this.streamed = True
            self._land(not self._defer)
        except BaseException:
            # nothing may still read or fill the staging, nor key a base
            wait([f for fs in tasks.values() for f in fs])
            for ev in marks.values():
                if ev is not None:
                    ev.synchronize()
            self._drop()
            raise
        return len(idx)
