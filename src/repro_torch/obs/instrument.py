"""InstrumentedStore — per-op latency/bytes metrics around any ChunkStore.

Pure delegation plus one ``perf_counter`` pair per op: every backend (dir /
sqlite / memory) reports
``kishu_store_op_seconds{op,backend}`` histograms and directional
``kishu_store_bytes_total{dir,backend}`` counters without knowing the
observability plane exists.  The wrapper adds *zero* store operations of
its own, so the crash-injection op sweeps (FaultInjectingStore) count the
same writes with or without it.

Placement matters: the session wraps the *root* store and rebuilds the
tenant namespace view on top (``NamespacedStore(InstrumentedStore(root),
tenant)``) — the txn engine's ``isinstance(store, NamespacedStore)``
unwrapping and meta-prefix logic keep working untouched.

:func:`instrument_tree` wraps a store once; the fabric compositions whose
children it would label per shard are not ported yet.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from repro_torch.core.chunkstore import ChunkStore
from repro_torch.obs.metrics import (MetricsRegistry, SIZE_BASE_BYTES)

OP_SECONDS = "kishu_store_op_seconds"
BYTES_TOTAL = "kishu_store_bytes_total"

_BACKEND_LABELS = {
    "MemoryStore": "memory",
    "DirectoryStore": "dir",
    "SQLiteStore": "sqlite",
    "CompressedStore": "codec",
    "NamespacedStore": "ns",
    "ShardedStore": "shard",
    "ReplicatedStore": "rep",
    "TieredStore": "tier",
    "FaultInjectedStore": "fault",
    "FaultInjectingStore": "crash",
}


def backend_label(store: Any) -> str:
    name = type(store).__name__
    if name in _BACKEND_LABELS:
        return _BACKEND_LABELS[name]
    low = name.lower()
    return low[:-5] if low.endswith("store") and len(low) > 5 else low


def _pairs_bytes(pairs: Iterable[Tuple[str, bytes]]
                 ) -> Tuple[List[Tuple[str, bytes]], int]:
    pairs = list(pairs)
    return pairs, sum(len(d) for _, d in pairs)


class InstrumentedStore(ChunkStore):
    """Times every ChunkStore op into a :class:`MetricsRegistry`."""

    def __init__(self, inner: ChunkStore, registry: MetricsRegistry, *,
                 backend: Optional[str] = None):
        self.inner = inner
        self.registry = registry
        self.backend = backend or backend_label(inner)
        self.min_slab = getattr(inner, "min_slab", 1)
        self.supports_parallel_get = getattr(inner, "supports_parallel_get",
                                             True)
        self.native_scatter = getattr(inner, "native_scatter", False)
        self._lat: Dict[str, Any] = {}
        self._get_bytes = registry.counter(BYTES_TOTAL, dir="get",
                                           backend=self.backend)
        self._put_bytes = registry.counter(BYTES_TOTAL, dir="put",
                                           backend=self.backend)

    def _obs(self, op: str, t0: float) -> None:
        h = self._lat.get(op)
        if h is None:
            h = self._lat[op] = self.registry.histogram(
                OP_SECONDS, op=op, backend=self.backend)
        h.observe(time.perf_counter() - t0)

    # ---- chunk data ----

    def put_chunk(self, key: str, data: bytes) -> bool:
        t0 = time.perf_counter()
        try:
            wrote = self.inner.put_chunk(key, data)
        finally:
            self._obs("put_chunk", t0)
        if wrote:
            self._put_bytes.inc(len(data))
        return wrote

    def put_chunks(self, pairs: Iterable[Tuple[str, bytes]]) -> int:
        pairs, nbytes = _pairs_bytes(pairs)
        t0 = time.perf_counter()
        try:
            written = self.inner.put_chunks(pairs)
        finally:
            self._obs("put_chunks", t0)
        self._put_bytes.inc(nbytes)
        return written

    def put_chunk_stored(self, key: str, data: bytes) -> bool:
        t0 = time.perf_counter()
        try:
            wrote = self.inner.put_chunk_stored(key, data)
        finally:
            self._obs("put_chunk", t0)
        if wrote:
            self._put_bytes.inc(len(data))
        return wrote

    def put_chunks_stored(self, pairs: Iterable[Tuple[str, bytes]]) -> int:
        pairs, nbytes = _pairs_bytes(pairs)
        t0 = time.perf_counter()
        try:
            written = self.inner.put_chunks_stored(pairs)
        finally:
            self._obs("put_chunks", t0)
        self._put_bytes.inc(nbytes)
        return written

    def get_chunk(self, key: str) -> bytes:
        t0 = time.perf_counter()
        try:
            data = self.inner.get_chunk(key)
        finally:
            self._obs("get_chunk", t0)
        self._get_bytes.inc(len(data))
        return data

    def get_chunk_stored(self, key: str) -> bytes:
        t0 = time.perf_counter()
        try:
            data = self.inner.get_chunk_stored(key)
        finally:
            self._obs("get_chunk", t0)
        self._get_bytes.inc(len(data))
        return data

    def get_chunks(self, keys: Iterable[str], *, missing_ok: bool = False
                   ) -> Dict[str, bytes]:
        keys = list(keys)
        t0 = time.perf_counter()
        try:
            out = self.inner.get_chunks(keys, missing_ok=missing_ok)
        finally:
            self._obs("get_chunks", t0)
        self._get_bytes.inc(sum(len(d) for d in out.values()))
        return out

    def has_chunk(self, key: str) -> bool:
        t0 = time.perf_counter()
        try:
            return self.inner.has_chunk(key)
        finally:
            self._obs("has_chunk", t0)

    def list_chunk_keys(self) -> List[str]:
        t0 = time.perf_counter()
        try:
            return self.inner.list_chunk_keys()
        finally:
            self._obs("list_chunk_keys", t0)

    def chunk_sizes(self, keys: Iterable[str]) -> Dict[str, int]:
        t0 = time.perf_counter()
        try:
            return self.inner.chunk_sizes(keys)
        finally:
            self._obs("chunk_sizes", t0)

    def delete_chunk(self, key: str) -> None:
        t0 = time.perf_counter()
        try:
            self.inner.delete_chunk(key)
        finally:
            self._obs("delete_chunk", t0)

    def delete_chunks(self, keys: Iterable[str]) -> int:
        t0 = time.perf_counter()
        try:
            return self.inner.delete_chunks(keys)
        finally:
            self._obs("delete_chunks", t0)

    def chunk_bytes_total(self) -> int:
        return self.inner.chunk_bytes_total()

    def n_chunks(self) -> int:
        return self.inner.n_chunks()

    # ---- metadata ----

    def put_meta(self, name: str, doc: dict) -> None:
        t0 = time.perf_counter()
        try:
            self.inner.put_meta(name, doc)
        finally:
            self._obs("put_meta", t0)

    def put_meta_batch(self, docs: Dict[str, dict]) -> None:
        t0 = time.perf_counter()
        try:
            self.inner.put_meta_batch(docs)
        finally:
            self._obs("put_meta", t0)

    def get_meta(self, name: str) -> Optional[dict]:
        t0 = time.perf_counter()
        try:
            return self.inner.get_meta(name)
        finally:
            self._obs("get_meta", t0)

    def list_meta(self, prefix: str = "") -> List[str]:
        t0 = time.perf_counter()
        try:
            return self.inner.list_meta(prefix)
        finally:
            self._obs("list_meta", t0)

    def delete_meta(self, name: str) -> None:
        t0 = time.perf_counter()
        try:
            self.inner.delete_meta(name)
        finally:
            self._obs("delete_meta", t0)

    def delete_meta_batch(self, names: Iterable[str]) -> None:
        t0 = time.perf_counter()
        try:
            self.inner.delete_meta_batch(names)
        finally:
            self._obs("delete_meta", t0)

    # ---- passthrough for backend-specific surface (op_log, tenant_id…) ----

    def __getattr__(self, name: str):
        return getattr(self.inner, name)


def instrument_tree(store: Any, registry: MetricsRegistry) -> Any:
    """Wrap ``store`` in an :class:`InstrumentedStore` (idempotent).  The
    fabric compositions whose children this would label separately are not
    ported yet, so every store is one leaf here."""
    if isinstance(store, InstrumentedStore):
        return store
    return InstrumentedStore(store, registry)


__all__ = ["InstrumentedStore", "instrument_tree", "backend_label",
           "OP_SECONDS", "BYTES_TOTAL", "SIZE_BASE_BYTES"]
