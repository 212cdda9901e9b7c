"""Content-addressed chunk store with pluggable backends.

The Checkpoint Graph stores versioned co-variables as *manifests* referencing
immutable chunks keyed by blake2b-128 of their content (exact, unlike the
detection hash).  Content addressing gives cross-version and cross-branch
dedup for free — the storage-level core of Kishu's "small incremental
checkpoints" result, plus our beyond-paper chunk-level dedup (DESIGN.md §2).

Backends:
  - MemoryStore     — dicts (benchmark baseline for pure algorithm cost)
  - DirectoryStore  — one file per chunk, sharded dirs; shard-local writers
                      on a multi-host cluster never contend (DESIGN.md §8)
  - SQLiteStore     — single-file deployment, as the paper ships (§6.1)

Fault-injection wrappers simulate chunk loss (-> fallback recomputation) and
slow hosts (-> straggler deadline / async writer tests).
"""
from __future__ import annotations

import hashlib
import json
import os
import sqlite3
import threading
import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core import parallel
from repro_torch.core.serialize import ChunkMissingError


def chunk_key(data: bytes) -> str:
    return hashlib.blake2b(data, digest_size=16).hexdigest()


# ---------------------------------------------------------------------------
# per-chunk codec layer
# ---------------------------------------------------------------------------
#
# Chunks are keyed by the blake2b of their *logical* (uncompressed) content,
# so dedup and manifests are codec-agnostic; a compressed chunk is stored as
# a tagged frame:  MAGIC(4) | codec_id(1) | raw_len(8 LE) | payload.
# Reads are transparently decoded by every backend (frame sniffing), so a
# store written with compression stays readable by uncompressed readers and
# vice versa — old stores contain only unframed chunks, which pass through
# untouched.  Incompressible chunks are stored raw (the frame must *save*
# bytes to be used), so pathological data costs nothing.

CHUNK_MAGIC = b"KZC1"
_FRAME_HDR = len(CHUNK_MAGIC) + 1 + 8


@dataclass(frozen=True)
class ChunkCodec:
    codec_id: int
    name: str
    compress: Callable[[bytes], bytes]
    decompress: Callable[[bytes], bytes]
    # optional sampled pre-check: False -> data judged incompressible, the
    # encode is skipped entirely and the chunk stored raw (the skip is what
    # WriteStats.chunks_codec_skipped counts)
    probe: Optional[Callable[[bytes], bool]] = None


def _build_codecs() -> Dict[int, ChunkCodec]:
    out = {1: ChunkCodec(1, "zlib",
                         lambda b: zlib.compress(b, 1), zlib.decompress)}
    try:                                   # optional, not a hard dependency
        import zstandard as _zstd
        _zc, _zd = _zstd.ZstdCompressor(level=3), _zstd.ZstdDecompressor()
        out[2] = ChunkCodec(2, "zstd", _zc.compress, _zd.decompress)
    except Exception:  # noqa: BLE001 — absent/broken module: codec skipped
        pass
    try:
        import lz4.frame as _lz4
        out[3] = ChunkCodec(3, "lz4", _lz4.compress, _lz4.decompress)
    except Exception:  # noqa: BLE001
        pass
    try:
        # bit-plane codec (kernels/delta_codec): the host half is pure
        # numpy, so registering it here keeps every backend/CLI able to
        # decode device-encoded frames without an accelerator stack
        from repro_torch.kernels.delta_codec import host as _bshuf
        out[_bshuf.CODEC_ID] = ChunkCodec(
            _bshuf.CODEC_ID, _bshuf.CODEC_NAME,
            _bshuf.bitplane_compress, _bshuf.bitplane_decompress,
            probe=_bshuf.bitplane_probe)
    except Exception:  # noqa: BLE001
        pass
    return out


_CODECS_BY_ID = _build_codecs()
_CODECS_BY_NAME = {c.name: c for c in _CODECS_BY_ID.values()}


def available_codecs() -> List[str]:
    return sorted(_CODECS_BY_NAME)


def resolve_codec(codec) -> Optional[ChunkCodec]:
    """None/"raw"/"none" -> no compression; "auto" -> best available
    (zstd > lz4 > zlib); a name -> that codec or ValueError."""
    if codec is None or isinstance(codec, ChunkCodec):
        return codec
    name = str(codec).lower()
    if name in ("raw", "none", ""):
        return None
    if name == "auto":
        for pick in ("zstd", "lz4", "zlib"):
            if pick in _CODECS_BY_NAME:
                return _CODECS_BY_NAME[pick]
        return None
    if name not in _CODECS_BY_NAME:
        raise ValueError(f"unknown chunk codec {codec!r}; "
                         f"available: {available_codecs()}")
    return _CODECS_BY_NAME[name]


_CODEC_STORED = 0                 # escape frame: payload is the raw bytes


def encode_chunk(data: bytes, codec: Optional[ChunkCodec]) -> bytes:
    """Frame ``data`` with ``codec`` iff that actually saves bytes.

    Raw data that happens to *begin with the magic* is escaped into a
    "stored" frame (codec id 0) so decoding stays unambiguous — without
    this, such a chunk would be misparsed as a frame on read."""
    if codec is not None and (codec.probe is None or codec.probe(data)):
        comp = codec.compress(data)
        if len(comp) + _FRAME_HDR < len(data):
            return (CHUNK_MAGIC + bytes([codec.codec_id])
                    + len(data).to_bytes(8, "little") + comp)
    if data.startswith(CHUNK_MAGIC):
        return (CHUNK_MAGIC + bytes([_CODEC_STORED])
                + len(data).to_bytes(8, "little") + data)
    return data


def decode_chunk(data: bytes) -> bytes:
    """Transparent inverse of :func:`encode_chunk`: unframed chunks pass
    through; framed chunks decompress (or unwrap the "stored" escape).
    Anything that merely *looks* like a frame but fails to parse — an
    unregistered codec id, a failed decompression, a length mismatch — is
    returned verbatim: it is far more likely a raw legacy chunk whose bytes
    coincide with the magic than a valid frame, and genuinely corrupt or
    codec-unavailable chunks are still caught downstream by the manifest's
    per-chunk size and content-address checks (-> fallback recomputation).
    """
    if len(data) < _FRAME_HDR or not data.startswith(CHUNK_MAGIC):
        return data
    codec_id = data[len(CHUNK_MAGIC)]
    raw_len = int.from_bytes(data[len(CHUNK_MAGIC) + 1:_FRAME_HDR], "little")
    if codec_id == _CODEC_STORED:
        if raw_len == len(data) - _FRAME_HDR:
            return data[_FRAME_HDR:]
        return data
    codec = _CODECS_BY_ID.get(codec_id)
    if codec is None:
        return data
    try:
        raw = codec.decompress(data[_FRAME_HDR:])
    except Exception:  # noqa: BLE001 — not a real frame (or corrupt)
        return data
    if len(raw) != raw_len:
        return data
    return raw


# ---------------------------------------------------------------------------
# shared chunk cache
# ---------------------------------------------------------------------------

DEFAULT_CACHE_BYTES = 64 << 20


def resolve_cache_bytes(n: Optional[int] = None) -> int:
    """Effective cache capacity: explicit arg > $KISHU_CACHE_BYTES > 64 MiB.
    ``0`` disables the cache."""
    if n is None:
        env = os.environ.get("KISHU_CACHE_BYTES", "").strip()
        try:
            n = int(env) if env else DEFAULT_CACHE_BYTES
        except ValueError:
            n = DEFAULT_CACHE_BYTES
    return max(0, int(n))


class ChunkCache:
    """Bounded LRU over *logical* chunk bytes, shared between the
    CheckpointWriter and the StateLoader: chunks written this session are
    served back to checkout without touching the backend at all, and chunks
    fetched once stay warm for the next time-travel hop.  Thread-safe (the
    async writer populates it from its drain thread)."""

    def __init__(self, max_bytes: Optional[int] = None):
        self.max_bytes = resolve_cache_bytes(max_bytes)
        self._d: "OrderedDict[str, bytes]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._d)

    @property
    def bytes_used(self) -> int:
        return self._bytes

    def put(self, key: str, data: bytes) -> None:
        if self.max_bytes <= 0 or len(data) > self.max_bytes:
            return
        with self._lock:
            old = self._d.pop(key, None)
            if old is not None:
                self._bytes -= len(old)
            self._d[key] = data
            self._bytes += len(data)
            while self._bytes > self.max_bytes:
                _, evicted = self._d.popitem(last=False)
                self._bytes -= len(evicted)

    def put_many(self, mapping: Dict[str, bytes]) -> None:
        for k, v in mapping.items():
            self.put(k, v)

    def get(self, key: str) -> Optional[bytes]:
        if self.max_bytes <= 0:
            return None
        with self._lock:
            data = self._d.get(key)
            if data is None:
                self.misses += 1
                return None
            self._d.move_to_end(key)
            self.hits += 1
            return data

    def contains(self, key: str) -> bool:
        """Non-mutating membership probe: no LRU promotion, no hit/miss
        accounting — the checkout planner prices cache-resident chunks at
        zero without perturbing the cache's behavior."""
        if self.max_bytes <= 0:
            return False
        with self._lock:
            return key in self._d

    def get_many(self, keys: Iterable[str]) -> Dict[str, bytes]:
        out: Dict[str, bytes] = {}
        for k in keys:
            data = self.get(k)
            if data is not None:
                out[k] = data
        return out

    def discard(self, key: str) -> None:
        with self._lock:
            old = self._d.pop(key, None)
            if old is not None:
                self._bytes -= len(old)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self._bytes = 0


class ChunkStore:
    """Interface: immutable chunks + small JSON metadata documents.

    Besides the per-chunk primitives, backends implement *batched* operations
    (``get_chunks`` / ``put_chunks`` / ``list_chunk_keys``) natively — one
    transaction for SQLite, a thread pool for the directory store — which the
    parallel I/O engine (parallel.py, DESIGN.md §9) and GC build on.  The
    base-class defaults degrade to per-chunk loops, so wrappers that inject
    per-chunk behavior (faults, delays) inherit correct pass-through
    semantics for free.

    Engine hints (class attributes):
      - ``supports_parallel_get``: False when concurrent fetches cannot beat
        a direct loop (pure in-memory stores have no round-trip to hide);
        the checkout pipeline then takes the serial path.
      - ``min_slab``: minimum keys per batched fetch — backends with
        per-statement overhead (SQL) want large slabs to amortize it.
      - ``native_scatter``: True when ``get_chunks`` drives its own
        cross-device concurrency (the sharded fabric's scatter-gather);
        bulk fetches then hand the store the whole key set in one call —
        slicing it into slabs would only add synchronization barriers on
        top of the store's internal parallelism.
    """

    supports_parallel_get = True
    min_slab = 1
    native_scatter = False

    def put_chunk(self, key: str, data: bytes) -> bool:
        raise NotImplementedError

    def get_chunk(self, key: str) -> bytes:
        raise NotImplementedError

    def get_chunk_stored(self, key: str) -> bytes:
        """The chunk's *stored* representation (codec frame included), for
        replication/placement machinery that moves chunks between backends:
        healing with decoded bytes would silently drop compression.  The
        default degrades to the decoded form — correct, since frames decode
        transparently on read, just not byte-preserving."""
        return self.get_chunk(key)

    def has_chunk(self, key: str) -> bool:
        raise NotImplementedError

    # ---- batched ops (parallel engine + GC entry points) ----
    def get_chunks(self, keys: Sequence[str], *,
                   missing_ok: bool = False) -> Dict[str, bytes]:
        """Fetch many chunks; returns {key: data}.  With ``missing_ok``
        absent chunks are simply omitted, else ChunkMissingError."""
        out: Dict[str, bytes] = {}
        for k in keys:
            if k in out:
                continue
            try:
                out[k] = self.get_chunk(k)
            except ChunkMissingError:
                if not missing_ok:
                    raise
        return out

    def put_chunks(self, pairs: Sequence[Tuple[str, bytes]]) -> int:
        """Store many chunks; returns the number newly written."""
        written = 0
        for k, d in pairs:
            if self.put_chunk(k, d):
                written += 1
        return written

    # ---- stored-form puts (device-encoded frames) ----
    #
    # ``data`` is already a KZC1 codec frame whose key was computed over the
    # *logical* bytes (the on-device codec emits frames directly, so the raw
    # bytes never exist on the host).  The base default just stores the
    # bytes verbatim — correct for every raw backend, since reads decode
    # frames transparently — while codec wrappers override these to bypass
    # re-encoding (double-framing would corrupt the chunk: one decode would
    # yield the inner frame, not the logical bytes).

    def put_chunk_stored(self, key: str, data: bytes) -> bool:
        return self.put_chunk(key, data)

    def put_chunks_stored(self, pairs: Sequence[Tuple[str, bytes]]) -> int:
        # delegating to put_chunks keeps the backend's native batching
        # (sqlite transactions, fabric scatter); only wrappers that
        # *transform* data on put (CompressedStore) must override
        return self.put_chunks(pairs)

    def list_chunk_keys(self) -> List[str]:
        """All chunk keys currently stored (GC / fsck enumeration)."""
        raise NotImplementedError

    def chunk_sizes(self, keys: Sequence[str]) -> Dict[str, int]:
        """Byte size per existing chunk (missing keys omitted) — metadata
        only where the backend allows, for GC accounting."""
        out: Dict[str, int] = {}
        for k in keys:
            try:
                out[k] = len(self.get_chunk(k))
            except ChunkMissingError:
                pass
        return out

    def put_meta(self, name: str, doc: dict) -> None:
        raise NotImplementedError

    def put_meta_batch(self, docs: "Dict[str, dict]") -> None:
        """Publish several metadata documents as one unit, as atomically as
        the backend allows (SQLite: one transaction; directory: staged tmp
        files then a tight rename loop; memory: a single dict update).
        Iteration order is the publish order — the transaction engine puts
        HEAD last so even a torn non-atomic publish can never leave HEAD
        naming a commit whose doc is absent.  The base default degrades to
        ordered per-doc puts, which fault-injection wrappers rely on to
        land a crash *between* documents."""
        for name, doc in docs.items():
            self.put_meta(name, doc)

    def get_meta(self, name: str) -> Optional[dict]:
        raise NotImplementedError

    def list_meta(self, prefix: str) -> List[str]:
        raise NotImplementedError

    def delete_meta(self, name: str) -> None:
        """Remove a metadata document (journal seals, tombstone purges);
        idempotent — deleting an absent doc is a no-op."""
        raise NotImplementedError

    def delete_meta_batch(self, names: Sequence[str]) -> None:
        """Remove several metadata documents, backend-batched where
        possible (one SQLite transaction) — the commit engine seals a
        transaction's journal docs in one round-trip.  Iteration order is
        the delete order; the default degrades to per-doc deletes, which
        fault-injection wrappers rely on to land a crash mid-seal."""
        for name in names:
            self.delete_meta(name)

    def delete_chunk(self, key: str) -> None:
        raise NotImplementedError

    def delete_chunks(self, keys: Sequence[str]) -> int:
        """Delete many chunks with backend-native batching (one SQL
        ``executemany``, pooled unlinks); returns the number of chunks
        actually removed.  The GC paths (``KishuSession.gc`` / CLI ``gc``)
        call this instead of looping ``delete_chunk``."""
        removed = 0
        for k in keys:
            if self.has_chunk(k):
                self.delete_chunk(k)
                removed += 1
        return removed

    # ---- stats ----
    def chunk_bytes_total(self) -> int:
        raise NotImplementedError

    def n_chunks(self) -> int:
        raise NotImplementedError


class MemoryStore(ChunkStore):
    supports_parallel_get = False     # dict access: no latency to overlap

    def __init__(self):
        self.chunks: Dict[str, bytes] = {}
        self.meta: Dict[str, dict] = {}
        self.put_count = 0
        self.put_bytes = 0

    def put_chunk(self, key, data):
        self.put_count += 1
        if key in self.chunks:
            return False
        self.chunks[key] = bytes(data)
        self.put_bytes += len(data)
        return True

    def get_chunk(self, key):
        try:
            return decode_chunk(self.chunks[key])
        except KeyError:
            raise ChunkMissingError(key) from None

    def get_chunk_stored(self, key):
        try:
            return self.chunks[key]
        except KeyError:
            raise ChunkMissingError(key) from None

    def get_chunks(self, keys, *, missing_ok=False):
        chunks = self.chunks
        if missing_ok:
            return {k: decode_chunk(chunks[k]) for k in keys if k in chunks}
        try:
            return {k: decode_chunk(chunks[k]) for k in keys}
        except KeyError as e:
            raise ChunkMissingError(e.args[0]) from None

    def list_chunk_keys(self):
        return list(self.chunks)

    def chunk_sizes(self, keys):
        chunks = self.chunks
        return {k: len(chunks[k]) for k in keys if k in chunks}

    def has_chunk(self, key):
        return key in self.chunks

    def delete_chunk(self, key):
        self.chunks.pop(key, None)

    def delete_chunks(self, keys):
        return sum(self.chunks.pop(k, None) is not None for k in keys)

    def put_meta(self, name, doc):
        self.meta[name] = json.loads(json.dumps(doc))

    def put_meta_batch(self, docs):
        # serialize everything first, install in one update: a failure while
        # preparing leaves the published metadata untouched
        prepared = {n: json.loads(json.dumps(d)) for n, d in docs.items()}
        self.meta.update(prepared)

    def get_meta(self, name):
        return self.meta.get(name)

    def list_meta(self, prefix):
        return sorted(k for k in self.meta if k.startswith(prefix))

    def delete_meta(self, name):
        self.meta.pop(name, None)

    def chunk_bytes_total(self):
        return sum(len(v) for v in self.chunks.values())

    def n_chunks(self):
        return len(self.chunks)


class DirectoryStore(ChunkStore):
    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, "chunks"), exist_ok=True)
        os.makedirs(os.path.join(root, "meta"), exist_ok=True)

    def _chunk_path(self, key: str) -> str:
        return os.path.join(self.root, "chunks", key[:2], key)

    def put_chunk(self, key, data):
        path = self._chunk_path(key)
        if os.path.exists(path):
            return False
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # atomic; idempotent across concurrent writers
        return True

    def get_chunk(self, key):
        try:
            with open(self._chunk_path(key), "rb") as f:
                return decode_chunk(f.read())
        except FileNotFoundError:
            raise ChunkMissingError(key) from None

    def get_chunk_stored(self, key):
        try:
            with open(self._chunk_path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise ChunkMissingError(key) from None

    def has_chunk(self, key):
        return os.path.exists(self._chunk_path(key))

    def get_chunks(self, keys, *, missing_ok=False):
        # Thread-pooled reads: each open/read releases the GIL in the
        # syscall, so concurrent chunk files stream in parallel.
        def read_one(key):
            try:
                return key, self.get_chunk(key)
            except ChunkMissingError:
                if not missing_ok:
                    raise
                return key, None
        uniq = list(dict.fromkeys(keys))
        got = parallel.map_parallel(read_one, uniq)
        return {k: v for k, v in got if v is not None}

    def put_chunks(self, pairs):
        def write_one(pair):
            return self.put_chunk(pair[0], pair[1])
        return sum(bool(w) for w in parallel.map_parallel(write_one,
                                                          list(pairs)))

    def list_chunk_keys(self):
        out = []
        for _, _, files in os.walk(os.path.join(self.root, "chunks")):
            out.extend(f for f in files if not f.endswith(".tmp")
                       and ".tmp." not in f)
        return out

    def chunk_sizes(self, keys):
        out = {}
        for k in keys:
            try:
                out[k] = os.path.getsize(self._chunk_path(k))
            except FileNotFoundError:
                pass
        return out

    def delete_chunk(self, key):
        try:
            os.remove(self._chunk_path(key))
        except FileNotFoundError:
            pass

    def delete_chunks(self, keys):
        # pooled unlinks: each remove releases the GIL in the syscall
        def rm_one(key):
            try:
                os.remove(self._chunk_path(key))
                return True
            except FileNotFoundError:
                return False
        return sum(parallel.map_parallel(rm_one, list(keys)))

    def _meta_path(self, name: str) -> str:
        return os.path.join(self.root, "meta", name.replace("/", "__") + ".json")

    def put_meta(self, name, doc):
        path = self._meta_path(name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)

    def put_meta_batch(self, docs):
        # stage every doc as a tmp file first, then a tight rename loop:
        # each rename is individually atomic, and the torn window between
        # renames is syscall-narrow (the commit journal covers even that)
        staged = []
        for name, doc in docs.items():
            path = self._meta_path(name)
            tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            staged.append((tmp, path))
        for tmp, path in staged:
            os.replace(tmp, path)

    def get_meta(self, name):
        try:
            with open(self._meta_path(name)) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def delete_meta(self, name):
        try:
            os.remove(self._meta_path(name))
        except FileNotFoundError:
            pass

    def list_meta(self, prefix):
        mdir = os.path.join(self.root, "meta")
        pre = prefix.replace("/", "__")
        return sorted(f[:-5].replace("__", "/") for f in os.listdir(mdir)
                      if f.startswith(pre) and f.endswith(".json"))

    def chunk_bytes_total(self):
        total = 0
        cdir = os.path.join(self.root, "chunks")
        for d, _, files in os.walk(cdir):
            for f in files:
                total += os.path.getsize(os.path.join(d, f))
        return total

    def n_chunks(self):
        return sum(len(files) for _, _, files in
                   os.walk(os.path.join(self.root, "chunks")))


class SQLiteStore(ChunkStore):
    min_slab = 32                     # amortize per-SELECT overhead

    def __init__(self, path: str):
        self.path = path
        self._local = threading.local()
        con = self._con()
        con.execute("CREATE TABLE IF NOT EXISTS chunks"
                    " (key TEXT PRIMARY KEY, data BLOB)")
        con.execute("CREATE TABLE IF NOT EXISTS meta"
                    " (name TEXT PRIMARY KEY, doc TEXT)")
        con.commit()

    def _con(self) -> sqlite3.Connection:
        if not hasattr(self._local, "con"):
            self._local.con = sqlite3.connect(self.path)
        return self._local.con

    def put_chunk(self, key, data):
        con = self._con()
        cur = con.execute("INSERT OR IGNORE INTO chunks VALUES (?, ?)",
                          (key, sqlite3.Binary(data)))
        con.commit()
        return cur.rowcount > 0

    def get_chunk(self, key):
        row = self._con().execute(
            "SELECT data FROM chunks WHERE key=?", (key,)).fetchone()
        if row is None:
            raise ChunkMissingError(key)
        return decode_chunk(bytes(row[0]))

    def get_chunk_stored(self, key):
        row = self._con().execute(
            "SELECT data FROM chunks WHERE key=?", (key,)).fetchone()
        if row is None:
            raise ChunkMissingError(key)
        return bytes(row[0])

    def has_chunk(self, key):
        return self._con().execute(
            "SELECT 1 FROM chunks WHERE key=?", (key,)).fetchone() is not None

    # IN-clause batch bound: SQLite's default variable limit is 999.
    _SQL_BATCH = 500

    def get_chunks(self, keys, *, missing_ok=False):
        uniq = list(dict.fromkeys(keys))
        con = self._con()
        out: Dict[str, bytes] = {}
        for i in range(0, len(uniq), self._SQL_BATCH):
            part = uniq[i:i + self._SQL_BATCH]
            marks = ",".join("?" * len(part))
            rows = con.execute(
                f"SELECT key, data FROM chunks WHERE key IN ({marks})", part)
            for k, d in rows:
                out[k] = decode_chunk(bytes(d))
        if not missing_ok and len(out) != len(uniq):
            missing = next(k for k in uniq if k not in out)
            raise ChunkMissingError(missing)
        return out

    def put_chunks(self, pairs):
        # One transaction for the whole batch: a single fsync instead of one
        # per chunk — the dominant cost of the serial write path.
        con = self._con()
        before = con.total_changes
        con.executemany(
            "INSERT OR IGNORE INTO chunks VALUES (?, ?)",
            [(k, sqlite3.Binary(d)) for k, d in pairs])
        con.commit()
        return con.total_changes - before

    def list_chunk_keys(self):
        return [r[0] for r in self._con().execute("SELECT key FROM chunks")]

    def chunk_sizes(self, keys):
        uniq = list(dict.fromkeys(keys))
        con = self._con()
        out: Dict[str, int] = {}
        for i in range(0, len(uniq), self._SQL_BATCH):
            part = uniq[i:i + self._SQL_BATCH]
            marks = ",".join("?" * len(part))
            rows = con.execute(
                f"SELECT key, LENGTH(data) FROM chunks"
                f" WHERE key IN ({marks})", part)
            for k, n in rows:
                out[k] = int(n)
        return out

    def delete_chunk(self, key):
        con = self._con()
        con.execute("DELETE FROM chunks WHERE key=?", (key,))
        con.commit()

    def delete_chunks(self, keys):
        # one transaction for the whole sweep: a single fsync, like put_chunks
        con = self._con()
        before = con.total_changes
        con.executemany("DELETE FROM chunks WHERE key=?",
                        [(k,) for k in keys])
        con.commit()
        return con.total_changes - before

    def put_meta(self, name, doc):
        con = self._con()
        con.execute("INSERT OR REPLACE INTO meta VALUES (?, ?)",
                    (name, json.dumps(doc)))
        con.commit()

    def put_meta_batch(self, docs):
        # one transaction: the whole publish (commit docs + HEAD) is atomic
        con = self._con()
        con.executemany("INSERT OR REPLACE INTO meta VALUES (?, ?)",
                        [(n, json.dumps(d)) for n, d in docs.items()])
        con.commit()

    def get_meta(self, name):
        row = self._con().execute(
            "SELECT doc FROM meta WHERE name=?", (name,)).fetchone()
        return json.loads(row[0]) if row else None

    def delete_meta(self, name):
        con = self._con()
        con.execute("DELETE FROM meta WHERE name=?", (name,))
        con.commit()

    def delete_meta_batch(self, names):
        con = self._con()
        con.executemany("DELETE FROM meta WHERE name=?",
                        [(n,) for n in names])
        con.commit()

    def list_meta(self, prefix):
        rows = self._con().execute(
            "SELECT name FROM meta WHERE name LIKE ?", (prefix + "%",))
        return sorted(r[0] for r in rows)

    def chunk_bytes_total(self):
        row = self._con().execute(
            "SELECT COALESCE(SUM(LENGTH(data)),0) FROM chunks").fetchone()
        return int(row[0])

    def n_chunks(self):
        return int(self._con().execute(
            "SELECT COUNT(*) FROM chunks").fetchone()[0])


class CompressedStore(ChunkStore):
    """Write-side codec wrapper: chunks are framed with ``codec`` on every
    put path; reads pass through (all backends decode frames natively), so
    compressed and uncompressed chunks mix freely in one store and either
    reader works against either writer.  Tracks logical vs stored bytes so
    benchmarks and the CLI can report the compression win."""

    def __init__(self, inner: ChunkStore, codec="auto"):
        self.inner = inner
        self.codec = resolve_codec(codec)
        self.min_slab = getattr(inner, "min_slab", 1)
        self.supports_parallel_get = getattr(inner, "supports_parallel_get",
                                             True)
        self.native_scatter = getattr(inner, "native_scatter", False)
        self.logical_put_bytes = 0
        self.stored_put_bytes = 0
        self.chunks_codec_skipped = 0     # probe said "incompressible"

    def _encode(self, data: bytes) -> bytes:
        codec = self.codec
        if codec is not None and codec.probe is not None \
                and not codec.probe(data):
            self.chunks_codec_skipped += 1
            codec = None                  # probe veto: store raw
        enc = encode_chunk(data, codec)
        self.logical_put_bytes += len(data)
        self.stored_put_bytes += len(enc)
        return enc

    def put_chunk(self, key, data):
        return self.inner.put_chunk(key, self._encode(data))

    def put_chunks(self, pairs):
        return self.inner.put_chunks([(k, self._encode(d)) for k, d in pairs])

    # device-encoded frames are already in stored form: re-encoding would
    # double-frame them (a decode would then yield the inner frame, not the
    # logical bytes) — bypass the codec, keep the byte accounting honest
    def put_chunk_stored(self, key, data):
        self.stored_put_bytes += len(data)
        return self.inner.put_chunk_stored(key, data)

    def put_chunks_stored(self, pairs):
        self.stored_put_bytes += sum(len(d) for _, d in pairs)
        return self.inner.put_chunks_stored(pairs)

    def get_chunk(self, key):
        return self.inner.get_chunk(key)

    def get_chunk_stored(self, key):
        return self.inner.get_chunk_stored(key)

    def get_chunks(self, keys, *, missing_ok=False):
        return self.inner.get_chunks(keys, missing_ok=missing_ok)

    def has_chunk(self, key):
        return self.inner.has_chunk(key)

    def list_chunk_keys(self):
        return self.inner.list_chunk_keys()

    def chunk_sizes(self, keys):
        return self.inner.chunk_sizes(keys)

    def delete_chunk(self, key):
        self.inner.delete_chunk(key)

    def delete_chunks(self, keys):
        return self.inner.delete_chunks(keys)

    def put_meta(self, name, doc):
        self.inner.put_meta(name, doc)

    def put_meta_batch(self, docs):
        self.inner.put_meta_batch(docs)

    def get_meta(self, name):
        return self.inner.get_meta(name)

    def list_meta(self, prefix):
        return self.inner.list_meta(prefix)

    def delete_meta(self, name):
        self.inner.delete_meta(name)

    def delete_meta_batch(self, names):
        self.inner.delete_meta_batch(names)

    def chunk_bytes_total(self):
        return self.inner.chunk_bytes_total()

    def n_chunks(self):
        return self.inner.n_chunks()


# ---------------------------------------------------------------------------
# per-tenant namespaces
# ---------------------------------------------------------------------------

TENANT_PREFIX = "tenant/"


def validate_tenant_id(tenant: str) -> str:
    """Tenant ids become meta-name path components, so they must survive
    every backend's name encoding — in particular DirectoryStore maps
    ``/`` to ``__``, which makes both characters ambiguous inside an id."""
    if not tenant or not all(c.isalnum() or c in ".-" for c in tenant):
        raise ValueError(
            f"invalid tenant id {tenant!r}: need [A-Za-z0-9.-]+")
    return tenant


def tenant_ids(store: "ChunkStore") -> List[str]:
    """Tenant namespaces present in a *root* store, from its meta listing."""
    seen = []
    for name in store.list_meta(TENANT_PREFIX):
        tid = name[len(TENANT_PREFIX):].split("/", 1)[0]
        if tid and tid not in seen:
            seen.append(tid)
    return seen


class NamespacedStore(ChunkStore):
    """Per-tenant view of a shared store: every metadata name is prefixed
    ``tenant/<id>/`` while **chunks pass through unprefixed** — tenants get
    isolated checkpoint graphs, branches, and txn journals, but share one
    content-addressed chunk space, so identical data across sessions is
    stored once (the cross-session dedup the fabric exists for).

    The flip side of shared chunks is that no single tenant may delete a
    chunk just because *its* graph dropped the last reference — GC and
    recovery rollback must consult every namespace (txn.global_live_chunks).
    """

    def __init__(self, inner: ChunkStore, tenant: str):
        self.inner = inner
        self.tenant_id = validate_tenant_id(tenant)
        self.meta_prefix = TENANT_PREFIX + self.tenant_id + "/"
        self.min_slab = getattr(inner, "min_slab", 1)
        self.supports_parallel_get = getattr(inner, "supports_parallel_get",
                                             True)
        self.native_scatter = getattr(inner, "native_scatter", False)

    @property
    def root_store(self) -> ChunkStore:
        """The shared (un-namespaced) store, for cross-tenant operations."""
        return self.inner

    def _n(self, name: str) -> str:
        return self.meta_prefix + name

    # ---- chunks: shared, pass-through ----
    def put_chunk(self, key, data):
        return self.inner.put_chunk(key, data)

    def put_chunks(self, pairs):
        return self.inner.put_chunks(pairs)

    def put_chunk_stored(self, key, data):
        return self.inner.put_chunk_stored(key, data)

    def put_chunks_stored(self, pairs):
        return self.inner.put_chunks_stored(pairs)

    def get_chunk(self, key):
        return self.inner.get_chunk(key)

    def get_chunk_stored(self, key):
        return self.inner.get_chunk_stored(key)

    def get_chunks(self, keys, *, missing_ok=False):
        return self.inner.get_chunks(keys, missing_ok=missing_ok)

    def has_chunk(self, key):
        return self.inner.has_chunk(key)

    def list_chunk_keys(self):
        return self.inner.list_chunk_keys()

    def chunk_sizes(self, keys):
        return self.inner.chunk_sizes(keys)

    def delete_chunk(self, key):
        self.inner.delete_chunk(key)

    def delete_chunks(self, keys):
        return self.inner.delete_chunks(keys)

    # ---- meta: prefixed ----
    def put_meta(self, name, doc):
        self.inner.put_meta(self._n(name), doc)

    def put_meta_batch(self, docs):
        self.inner.put_meta_batch({self._n(n): d for n, d in docs.items()})

    def get_meta(self, name):
        return self.inner.get_meta(self._n(name))

    def list_meta(self, prefix):
        cut = len(self.meta_prefix)
        return [n[cut:] for n in self.inner.list_meta(self._n(prefix))]

    def delete_meta(self, name):
        self.inner.delete_meta(self._n(name))

    def delete_meta_batch(self, names):
        self.inner.delete_meta_batch([self._n(n) for n in names])

    def chunk_bytes_total(self):
        return self.inner.chunk_bytes_total()

    def n_chunks(self):
        return self.inner.n_chunks()


def namespace_views(store: "ChunkStore") -> List[Tuple[str, "ChunkStore"]]:
    """Every checkpoint namespace reachable through ``store``: the root
    namespace itself plus one :class:`NamespacedStore` view per tenant.
    If ``store`` is already a tenant view, enumeration happens on its root
    (so cross-namespace invariants hold no matter which view asks)."""
    root = store.root_store if isinstance(store, NamespacedStore) else store
    views: List[Tuple[str, ChunkStore]] = [("", root)]
    views.extend((tid, NamespacedStore(root, tid))
                 for tid in tenant_ids(root))
    return views


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

class FaultInjectedStore(ChunkStore):
    """Wrapper that drops/corrupts selected chunks and can delay I/O.

    ``fail_get``: predicate(key) -> bool — raise ChunkMissingError on read.
    ``write_delay``: seconds added per put (straggler simulation).
    ``read_delay``: seconds added per get (slow-host restore simulation).

    Batched ops are deliberately *not* overridden: the ChunkStore defaults
    loop through ``get_chunk``/``put_chunk`` here, so every chunk of a batch
    individually passes through the fault predicates and delays — the
    parallel engine is exercised against per-chunk failures, not
    batch-granularity ones.
    """

    def __init__(self, inner: ChunkStore, *, fail_get=None, fail_put=None,
                 write_delay: float = 0.0, read_delay: float = 0.0):
        self.inner = inner
        self.fail_get = fail_get or (lambda k: False)
        self.fail_put = fail_put or (lambda k: False)
        self.write_delay = write_delay
        self.read_delay = read_delay
        self.dropped_puts: List[str] = []
        # engine hints follow the wrapped backend; an injected read delay
        # adds a per-chunk round trip, which parallel fetch can hide even
        # over a store that opts out (e.g. a delayed MemoryStore models a
        # remote RAM-speed host)
        self.min_slab = getattr(inner, "min_slab", 1)
        self.supports_parallel_get = (
            getattr(inner, "supports_parallel_get", True) or read_delay > 0)

    def put_chunk(self, key, data):
        if self.write_delay:
            time.sleep(self.write_delay)
        if self.fail_put(key):
            self.dropped_puts.append(key)
            return False
        return self.inner.put_chunk(key, data)

    def get_chunk(self, key):
        if self.read_delay:
            time.sleep(self.read_delay)
        if self.fail_get(key):
            raise ChunkMissingError(f"injected failure: {key}")
        return self.inner.get_chunk(key)

    def get_chunk_stored(self, key):
        if self.read_delay:
            time.sleep(self.read_delay)
        if self.fail_get(key):
            raise ChunkMissingError(f"injected failure: {key}")
        return self.inner.get_chunk_stored(key)

    def list_chunk_keys(self):
        return self.inner.list_chunk_keys()

    def chunk_sizes(self, keys):
        return self.inner.chunk_sizes(keys)

    def has_chunk(self, key):
        return self.inner.has_chunk(key)

    def delete_chunk(self, key):
        self.inner.delete_chunk(key)

    def put_meta(self, name, doc):
        self.inner.put_meta(name, doc)

    def get_meta(self, name):
        return self.inner.get_meta(name)

    def list_meta(self, prefix):
        return self.inner.list_meta(prefix)

    def delete_meta(self, name):
        self.inner.delete_meta(name)

    def chunk_bytes_total(self):
        return self.inner.chunk_bytes_total()

    def n_chunks(self):
        return self.inner.n_chunks()


class InjectedCrash(RuntimeError):
    """Simulated process kill: raised *instead of* performing a write, so the
    wrapped store keeps exactly the state that had landed before the kill."""


class FaultInjectingStore(ChunkStore):
    """Crash-injection wrapper: kill the process after N write operations.

    Unlike :class:`FaultInjectedStore` (per-key fault predicates and delays),
    this wrapper models a *process death* at a precise point in the commit
    pipeline: every write-side operation (chunk put/delete, meta put/delete)
    advances a counter, and once ``crash_after`` operations have landed the
    next write raises :class:`InjectedCrash` without touching the backend.
    Crash-recovery tests sweep ``crash_after`` over every index, proving the
    transaction engine recovers from a kill between *any* two device writes.

    Batched operations decompose to per-op calls so the kill can land inside
    a batch — modeling a non-atomic backend / a kill mid-scatter — and so op
    indices are deterministic across identical runs.  Reads pass through
    uncounted (a crashed process performs no further reads that matter) and
    engine hints force the serial path, keeping the op order reproducible.
    """

    supports_parallel_get = False
    min_slab = 1
    native_scatter = False

    def __init__(self, inner: ChunkStore, *,
                 crash_after: Optional[int] = None):
        self.inner = inner
        self.crash_after = crash_after
        self.ops = 0                  # write ops that actually landed
        self.op_log: List[str] = []   # labels of landed ops, for tests that
                                      # target a specific pipeline stage

    def _tick(self, label: str) -> None:
        if self.crash_after is not None and self.ops >= self.crash_after:
            raise InjectedCrash(f"injected kill at write op {self.ops} "
                                f"(next: {label})")
        self.ops += 1
        self.op_log.append(label)

    # ---- writes: counted, crashing before the op reaches the backend ----
    def put_chunk(self, key, data):
        self._tick(f"put_chunk:{key}")
        return self.inner.put_chunk(key, data)

    def put_chunks(self, pairs):
        return sum(bool(self.put_chunk(k, d)) for k, d in pairs)

    def delete_chunk(self, key):
        self._tick(f"delete_chunk:{key}")
        self.inner.delete_chunk(key)

    def delete_chunks(self, keys):
        removed = 0
        for k in keys:
            had = self.inner.has_chunk(k)
            self.delete_chunk(k)
            removed += bool(had)
        return removed

    def put_meta(self, name, doc):
        self._tick(f"put_meta:{name}")
        self.inner.put_meta(name, doc)

    # put_meta_batch deliberately NOT overridden: the base default loops
    # per-doc through put_meta above, so a kill lands *between* documents —
    # the torn-publish case the journal must recover from.

    def delete_meta(self, name):
        self._tick(f"delete_meta:{name}")
        self.inner.delete_meta(name)

    # ---- reads: uncounted pass-through ----
    def get_chunk(self, key):
        return self.inner.get_chunk(key)

    def get_chunk_stored(self, key):
        return self.inner.get_chunk_stored(key)

    def get_chunks(self, keys, *, missing_ok=False):
        return self.inner.get_chunks(keys, missing_ok=missing_ok)

    def has_chunk(self, key):
        return self.inner.has_chunk(key)

    def list_chunk_keys(self):
        return self.inner.list_chunk_keys()

    def chunk_sizes(self, keys):
        return self.inner.chunk_sizes(keys)

    def get_meta(self, name):
        return self.inner.get_meta(name)

    def list_meta(self, prefix):
        return self.inner.list_meta(prefix)

    def chunk_bytes_total(self):
        return self.inner.chunk_bytes_total()

    def n_chunks(self):
        return self.inner.n_chunks()


def open_store(uri: str, codec=None, tenant: Optional[str] = None) -> ChunkStore:
    """"memory://", "dir:///path", "sqlite:///path.db", a bare path, or a
    "fabric://TOPOLOGY" composition — the latter raises
    ``NotImplementedError`` until the fabric module is ported.

    A ``?codec=NAME`` suffix (or the ``codec`` argument) wraps the store in
    :class:`CompressedStore` — e.g. ``sqlite:///ckpt.db?codec=auto`` or
    ``fabric://shard(...)?codec=zlib``.  Reading never needs the suffix:
    frames are decoded transparently.

    A ``?tenant=ID`` suffix (or the ``tenant`` argument) scopes the opened
    store to that tenant's namespace (:class:`NamespacedStore`); combine
    with ``&``: ``dir:///ckpt?codec=auto&tenant=alice``."""
    if "?" in uri:
        uri, _, query = uri.partition("?")
        for part in query.split("&"):
            key, _, val = part.partition("=")
            if key == "codec":
                codec = val
            elif key == "tenant":
                tenant = val
            elif part:
                raise ValueError(f"unknown store URI option {part!r}")
    if uri.startswith("fabric://"):
        raise NotImplementedError(
            "fabric:// stores are not ported to repro_torch yet")
    if uri == "memory://" or uri == ":memory:":
        store: ChunkStore = MemoryStore()
    elif uri.startswith("sqlite://"):
        store = SQLiteStore(uri[len("sqlite://"):])
    elif uri.startswith("dir://"):
        store = DirectoryStore(uri[len("dir://"):])
    else:
        store = DirectoryStore(uri)
    if resolve_codec(codec) is not None:
        store = CompressedStore(store, codec)
    if tenant:
        store = NamespacedStore(store, tenant)
    return store
