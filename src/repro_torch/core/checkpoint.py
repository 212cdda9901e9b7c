"""Incremental checkpoint writing (§5.1).

For each updated co-variable, serialize its *base* buffer, cut it into
fixed-size chunks, and store only chunks not already present (content
addressing).  When the same co-variable existed in the parent version with
identical structure, chunks whose detection hash is unchanged are *referenced*
from the previous manifest without re-serializing — the beyond-paper
chunk-dedup (DESIGN.md §2).  Unserializable co-variables are skipped (EAFP,
§5.1) and flagged for fallback recomputation.

The async writer overlaps chunk I/O with subsequent compute ("think time",
§2.2): ``commit`` snapshots device tensors to host and enqueues; ``flush``
drains.  A write deadline marks commits non-durable until the writer catches
up (straggler mitigation — checkout of a pending chunk simply falls back to
recomputation).
"""
from __future__ import annotations

import queue
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core import delta as delta_mod
from repro_torch.core import hashing
from repro_torch.core.chunkstore import ChunkCache, ChunkStore, chunk_key
from repro_torch.core.covariable import CovKey, LeafRecord
from repro_torch.core.graph import key_str
from repro_torch.core.serialize import (SerializationError, alias_key,
                                        base_of, leaf_meta, leaf_nbytes,
                                        leaf_to_bytes)


@dataclass
class WriteStats:
    bytes_serialized: int = 0       # *moved*: bytes actually serialized /
                                    # transferred (dirty ranges only on the
                                    # delta path)
    bytes_logical: int = 0          # logical size of updated co-variables
    bytes_written: int = 0          # new chunk bytes actually stored
    chunks_written: int = 0
    chunks_reused: int = 0          # skipped via detection-hash delta
    chunks_dedup: int = 0           # skipped via CAS hit
    covs_delta: int = 0             # covs written via the dirty-range path
    covs_packed: int = 0            # subset served by the fused device pack
    bytes_dev2host: int = 0         # device→host bytes the pack(s) moved
    chunks_encoded: int = 0         # chunks compressed on device (bit-plane
                                    # frames crossed PCIe, not raw rows)
    chunks_codec_skipped: int = 0   # probe said incompressible → raw
    kernel_fallbacks: int = 0       # device-kernel → host degradations
    unserializable: int = 0
    wall_s: float = 0.0


_hashes_hex = hashing.hashes_hex


def _pack_usable(pack, det_hex: List[str], dirty_set, n: int,
                 chunk_bytes: int, n_chunks: int) -> bool:
    """The fused device pack may serve this delta only when it describes
    exactly this base at exactly this chunking AND its dirty set covers
    every chunk the manifest compare wants rewritten.  The pack's dirty set
    is computed against the previous *record* hashes; the manifest compare
    runs against the previous *manifest* — normally identical, but a
    mismatch (recovered graph, size drift forcing extra rewrites) must fall
    back to the device-sliced reader rather than write stale rows."""
    if pack is None or pack.chunk_bytes != chunk_bytes \
            or pack.nbytes != n or pack.n_chunks != n_chunks:
        return False
    if hashing.hashes_hex(pack.hashes) != det_hex:
        return False
    return dirty_set <= pack.dirty_set


def _try_delta_manifest(base, det_hex: List[str], prev_manifest,
                        chunk_bytes: int, stats: WriteStats,
                        put, has, members, pack=None,
                        put_stored=None) -> Optional[dict]:
    """Dirty-range fast path: when the previous manifest matches this base
    structurally, compare detection hashes *first* and serialize only the
    dirty byte ranges — the full blob is never built and device→host
    traffic scales with dirty bytes, not total bytes.  Returns None when
    the fast path doesn't apply (first version, structure change, non-array
    leaf, everything dirty) — the caller falls back to full serialization,
    which produces bit-identical chunks."""
    if not det_hex or not prev_manifest or prev_manifest.get("unserializable"):
        return None
    prev_base = prev_manifest.get("base") or {}
    meta = leaf_meta(base)
    if meta.get("kind") != "array" or prev_base.get("meta") != meta:
        return None
    n = leaf_nbytes(base)
    if n <= 0 or prev_base.get("nbytes") != n:
        return None
    n_chunks = -(-n // chunk_bytes)
    prev_chunks = prev_base.get("chunks", [])
    prev_det = prev_base.get("det_hashes", [])
    if not (len(det_hex) == len(prev_chunks) == len(prev_det) == n_chunks):
        return None
    dirty_set = set(delta_mod.dirty_indices(prev_det, det_hex))
    dirty_set.update(                # stored size drift also forces rewrite
        i for i in range(n_chunks)
        if prev_chunks[i]["n"] != min((i + 1) * chunk_bytes, n)
        - i * chunk_bytes)
    dirty = sorted(dirty_set)
    if len(dirty) == n_chunks:
        return None                  # fully diverged: full path, same cost
    use_pack = _pack_usable(pack, det_hex, dirty_set, n, chunk_bytes,
                            n_chunks)
    reader = None
    if not use_pack:
        reader = delta_mod.range_reader(base, chunk_bytes)
        if reader is None:
            return None

    stats.bytes_logical += n
    stats.covs_delta += 1
    chunks: List[Optional[dict]] = [None] * n_chunks
    for i in range(n_chunks):
        if i not in dirty_set:
            chunks[i] = {"key": prev_chunks[i]["key"],
                         "n": prev_chunks[i]["n"]}
            stats.chunks_reused += 1

    def _store(i: int, cdata, frame=None) -> None:
        # the key is ALWAYS over the logical bytes — codec frames are a
        # storage representation, invisible to dedup and manifests
        ck = chunk_key(cdata)
        if has(ck):
            stats.chunks_dedup += 1
        elif frame is not None and put_stored is not None:
            put_stored(ck, cdata, frame)
            stats.chunks_written += 1
            stats.bytes_written += len(frame)
        else:
            put(ck, cdata)
            stats.chunks_written += 1
            stats.bytes_written += len(cdata)
        chunks[i] = {"key": ck, "n": len(cdata)}

    if use_pack:
        # fused device path: dirty chunks come out of the kernel's
        # compacted buffer — the puts above enqueue into the (possibly
        # async) writer while the reader keeps the *next* segment's
        # device→host DMA in flight (DESIGN.md §15).  With the on-device
        # codec engaged the rows cross PCIe as bit-plane frames and are
        # stored as-is (put_stored); keys stay logical-byte either way.
        stats.covs_packed += 1
        enc0, skip0 = pack.codec_chunks_encoded, pack.codec_chunks_skipped
        if put_stored is not None:
            for i, cdata, frame in pack.read_chunks_encoded(dirty):
                stats.bytes_serialized += len(cdata)
                _store(i, cdata, frame)
        else:
            for i, cdata in pack.read_chunks(dirty):
                stats.bytes_serialized += len(cdata)
                _store(i, cdata)
        stats.chunks_encoded += pack.codec_chunks_encoded - enc0
        stats.chunks_codec_skipped += pack.codec_chunks_skipped - skip0
        stats.bytes_dev2host += pack.bytes_transferred
    else:
        for start, stop in delta_mod.coalesce(dirty):
            lo, hi = start * chunk_bytes, min(stop * chunk_bytes, n)
            data = reader(lo, hi)
            stats.bytes_serialized += len(data)
            for i in range(start, stop):
                clo = i * chunk_bytes - lo
                chi = min((i + 1) * chunk_bytes, n) - lo
                _store(i, data[clo:chi])
    return {"members": members, "unserializable": False,
            "base": {"meta": meta, "nbytes": n, "chunks": chunks,
                     "det_hashes": det_hex}}


def build_manifest(store: ChunkStore, key: CovKey,
                   records: List[LeafRecord], ns,
                   chunk_bytes: int,
                   prev_manifest: Optional[dict],
                   stats: WriteStats,
                   put: Callable[[str, bytes], None],
                   has: Optional[Callable[[str], bool]] = None,
                   delta_ranges: bool = True,
                   packs: Optional[Dict[int, Any]] = None,
                   put_stored: Optional[Callable[[str, bytes, bytes],
                                                 None]] = None) -> dict:
    """Serialize one co-variable into a manifest + chunk puts.

    ``has`` is the CAS-dedup membership test; the writer passes a variant
    that also sees chunks batched/enqueued but not yet landed in the store,
    so deferred (batched or async) puts never double-write within a delta.
    ``delta_ranges=False`` disables the dirty-range fast path (benchmark
    baseline — the pre-delta cov-granular writer)."""
    if has is None:
        has = store.has_chunk
    members = []
    for r in records:
        members.append({"name": r.name, "kind": r.kind, "dtype": r.dtype,
                        "shape": list(r.shape), "view": r.view,
                        "nbytes": r.nbytes})
    if any(r.kind == "opaque" for r in records):
        stats.unserializable += 1
        return {"members": members, "unserializable": True}

    base = base_of(ns[records[0].name])
    det = records[0].base_hashes
    det_hex = _hashes_hex(det)

    # chunk-granular fast path: det-hash compare first, then serialize /
    # transfer only the dirty ranges (bytes_serialized ~ dirty bytes)
    if delta_ranges:
        man = _try_delta_manifest(base, det_hex, prev_manifest, chunk_bytes,
                                  stats, put, has, members,
                                  pack=(packs or {}).get(alias_key(base)),
                                  put_stored=put_stored)
        if man is not None:
            return man

    try:
        blob, meta = leaf_to_bytes(base)
    except SerializationError:
        stats.unserializable += 1
        return {"members": members, "unserializable": True}

    prev_chunks: Dict[int, dict] = {}
    if prev_manifest and not prev_manifest.get("unserializable") \
            and prev_manifest.get("base", {}).get("meta") == meta:
        prev_det = prev_manifest["base"].get("det_hashes", [])
        for i, c in enumerate(prev_manifest["base"].get("chunks", [])):
            if i < len(prev_det):
                prev_chunks[i] = {"det": prev_det[i], **c}

    chunks = []
    n = len(blob)
    n_chunks = max(-(-n // chunk_bytes), 1) if n else 0
    stats.bytes_serialized += n
    stats.bytes_logical += n
    for i in range(n_chunks):
        lo, hi = i * chunk_bytes, min((i + 1) * chunk_bytes, n)
        prev = prev_chunks.get(i)
        if prev is not None and i < len(det_hex) and prev["det"] == det_hex[i]:
            # unchanged chunk: reference previous storage, no hashing/copy
            chunks.append({"key": prev["key"], "n": prev["n"]})
            stats.chunks_reused += 1
            continue
        data = blob[lo:hi]
        ck = chunk_key(data)
        if has(ck):
            stats.chunks_dedup += 1
        else:
            put(ck, data)
            stats.chunks_written += 1
            stats.bytes_written += len(data)
        chunks.append({"key": ck, "n": hi - lo})

    return {"members": members, "unserializable": False,
            "base": {"meta": meta, "nbytes": n, "chunks": chunks,
                     "det_hashes": det_hex}}


class CheckpointWriter:
    """Sync or async (background-thread) chunk writer.

    Both modes route through the batched ``put_chunks`` backend op: the sync
    path accumulates a delta's new chunks and lands them in one batch (one
    SQLite transaction / one thread-pooled file sweep) before the commit
    returns; the async worker drains its queue in batches of up to
    ``drain_batch`` for the same amortization without changing the
    deadline/straggler semantics."""

    def __init__(self, store: ChunkStore, *, chunk_bytes: int = 1 << 20,
                 async_write: bool = False, write_deadline_s: float = 0.0,
                 drain_batch: int = 64,
                 cache: Optional[ChunkCache] = None):
        self.store = store
        self.chunk_bytes = chunk_bytes
        self.cache = cache          # shared with the StateLoader: a chunk
                                    # written here is served back to checkout
                                    # without touching the backend
        self.async_write = async_write
        self.write_deadline_s = write_deadline_s
        self.drain_batch = drain_batch
        # dirty-range serialization; False = pre-delta full-blob writer
        # (benchmark baseline)
        self.delta_ranges = True
        # WAL hook (txn.TxnEngine.journal_chunks): called with a batch's
        # keys immediately before the backend put, so a crashed commit's
        # chunks are journaled and recovery can roll them back exactly
        self.journal: Optional[Callable[[List[str]], None]] = None
        # observability handle (set by the session): spans opened here from
        # the async drain thread become roots — contextvars don't cross
        # threads, and off-thread work genuinely is off the commit path
        self.obs = None
        self._q: "queue.Queue" = queue.Queue()
        # sync-mode delta batch: (key, bytes, stored-form flag)
        self._batch: List[Tuple[str, bytes, bool]] = []
        self._batch_keys: set = set()
        self._worker: Optional[threading.Thread] = None
        self._errors: List[Exception] = []
        self.pending_keys: set = set()
        # epoch fence: chunks enqueued vs chunks that have left the writer
        # (landed or failed) — the txn engine's durability proof for async
        # writes.  wait_epoch(epoch()) == "everything enqueued so far is
        # out of the pipeline".
        self._cv = threading.Condition()
        self._enqueued = 0
        self._completed = 0
        if async_write:
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            batch = [item]
            saw_sentinel = False
            while len(batch) < self.drain_batch:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    saw_sentinel = True
                    break
                batch.append(nxt)
            try:
                journaled = True
                if self.journal is not None:
                    try:        # WAL the keys BEFORE the backend put
                        self.journal([ck for ck, _, _ in batch])
                    except Exception as e:  # noqa: BLE001
                        journaled = False   # unjournaled chunks must not
                        self._errors.append(e)  # land: rollback couldn't
                                                # find them
                if journaled:
                    try:
                        with self._span("put_chunks", n=len(batch)):
                            self._put_batch(batch)
                    except Exception:  # noqa: BLE001
                        # batch op failed somewhere: degrade to per-chunk
                        # puts so one bad chunk doesn't drop its whole batch
                        for ck, data, stored in batch:
                            try:
                                if stored:
                                    self.store.put_chunk_stored(ck, data)
                                else:
                                    self.store.put_chunk(ck, data)
                            except Exception as e:  # noqa: BLE001
                                self._errors.append(e)
            finally:
                for ck, _, _ in batch:
                    self.pending_keys.discard(ck)
                for _ in batch:
                    self._q.task_done()
                with self._cv:
                    self._completed += len(batch)
                    self._cv.notify_all()
            if saw_sentinel:
                return

    def _put_batch(self, batch: List[Tuple[str, bytes, bool]]) -> None:
        """Land one mixed batch: raw chunks through ``put_chunks`` (codec
        wrappers encode them), device-encoded frames through
        ``put_chunks_stored`` (already frames — re-encoding would
        double-frame)."""
        raw = [(ck, d) for ck, d, stored in batch if not stored]
        pre = [(ck, d) for ck, d, stored in batch if stored]
        if raw:
            self.store.put_chunks(raw)
        if pre:
            self.store.put_chunks_stored(pre)

    def _enqueue(self, ck: str, data: bytes, stored: bool) -> None:
        with self._cv:
            self._enqueued += 1
        if self.async_write:
            self.pending_keys.add(ck)
            self._q.put((ck, bytes(data), stored))
        else:
            self._batch.append((ck, bytes(data), stored))
            self._batch_keys.add(ck)
            if len(self._batch) >= self.drain_batch:
                self._flush_batch()      # bound buffered delta memory

    def _put(self, ck: str, data: bytes) -> None:
        if self.cache is not None:
            self.cache.put(ck, bytes(data))
        self._enqueue(ck, data, stored=False)

    def _put_stored(self, ck: str, logical: bytes, frame: bytes) -> None:
        """Store a device-encoded chunk: the *frame* goes to the backend,
        the *logical* bytes feed the shared cache (checkout must see
        logical bytes, same as a backend read after transparent decode)."""
        if self.cache is not None:
            self.cache.put(ck, bytes(logical))
        self._enqueue(ck, frame, stored=True)

    def _span(self, name: str, **args):
        return self.obs.span(name, **args) if self.obs is not None \
            else nullcontext()

    def _flush_batch(self) -> None:
        if not self._batch:
            return
        batch, self._batch = self._batch, []
        self._batch_keys = set()
        try:
            if self.journal is not None:
                # WAL before the puts; a journal failure aborts the batch
                # (the exception propagates to run()) so no chunk ever
                # lands unjournaled
                self.journal([ck for ck, _, _ in batch])
            with self._span("put_chunks", n=len(batch)):
                self._put_batch(batch)
        finally:
            # the batch leaves the pipeline on ANY outcome — journal
            # failures included — or a later epoch fence would wait forever
            with self._cv:
                self._completed += len(batch)
                self._cv.notify_all()

    def epoch(self) -> int:
        """Fence token: number of chunks enqueued so far."""
        with self._cv:
            return self._enqueued

    def wait_epoch(self, token: Optional[int] = None,
                   timeout: Optional[float] = None) -> None:
        """Block until every chunk enqueued at or before ``token`` (default:
        all enqueued so far) has left the writer — landed or failed — then
        surface the first async write error, if any.  The txn engine's
        durability fence: once this returns cleanly, publishing metadata
        that references those chunks is safe."""
        with self._cv:
            tgt = self._enqueued if token is None else token
            self._cv.wait_for(lambda: self._completed >= tgt, timeout)
        if self._errors:
            errs, self._errors = self._errors, []
            raise errs[0]

    def _has(self, ck: str) -> bool:
        """CAS membership including chunks deferred in this delta."""
        return (ck in self.pending_keys or ck in self._batch_keys
                or self.store.has_chunk(ck))

    def write_delta(self, delta, ns,
                    prev_manifest_of: Callable[[CovKey], Optional[dict]],
                    packs: Optional[Dict[int, Any]] = None
                    ) -> Tuple[Dict[str, dict], WriteStats]:
        t0 = time.perf_counter()
        stats = WriteStats()
        manifests: Dict[str, dict] = {}
        with self._span("serialize", covs=len(delta.updated)):
            for key, records in delta.updated.items():
                man = build_manifest(self.store, key, records, ns,
                                     self.chunk_bytes, prev_manifest_of(key),
                                     stats, self._put, self._has,
                                     delta_ranges=self.delta_ranges,
                                     packs=packs,
                                     put_stored=self._put_stored)
                manifests[key_str(key)] = man
        self._flush_batch()                  # sync mode: durable on return
        if self.async_write and self.write_deadline_s:
            # monotonic, never wall-clock: an NTP step would expire this
            # deadline instantly (spurious drain timeout -> the commit
            # references still-pending chunks) or push it out indefinitely
            deadline = time.monotonic() + self.write_deadline_s
            while self.pending_keys and time.monotonic() < deadline:
                time.sleep(0.001)
            # anything still pending is left to the background writer;
            # checkout before completion falls back to recomputation.
        stats.wall_s = time.perf_counter() - t0
        return manifests, stats

    def flush(self) -> None:
        if self.async_write:
            self._q.join()
        if self._errors:
            errs, self._errors = self._errors, []
            raise errs[0]

    def close(self) -> None:
        if self.async_write and self._worker is not None:
            self._q.put(None)
            self._worker.join(timeout=5)
            self._worker = None
