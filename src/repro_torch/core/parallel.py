"""Bounded-concurrency I/O executor — the parallel chunk engine (DESIGN.md §9).

Checkpoint restore latency is bound by per-chunk round-trips when chunks are
fetched one-at-a-time on the calling thread; checkpoint write latency likewise
pays one store round-trip per chunk.  This module provides the shared
primitives that turn both paths into pipelined, bounded-concurrency batch I/O:

  - ``resolve_io_threads``  — one knob (ctor arg > $KISHU_IO_THREADS > default)
  - ``map_parallel``        — ordered parallel map over blocking calls
  - ``prefetch_map``        — streaming unordered map with a bounded
                              submission window: results are yielded on the
                              *calling* thread as they complete, so the
                              consumer (deserialization / materialization)
                              overlaps with in-flight I/O
  - ``iter_slabs``          — contiguous batching that preserves the caller's
                              key order, keeping early co-variables' chunks
                              early in the pipeline

All work runs on one shared, lazily-created, long-lived pool: spawning
threads (and, for SQLite, their thread-local connections) per checkout costs
more than a small restore itself.  Worker threads are tagged so
backend-native batched ops never nest a second level of parallelism inside a
pipeline worker (thread-explosion guard), and per-call concurrency is
enforced by a submission window rather than pool size.

The thread-count default is a small constant, not a large oversubscription:
I/O threads exist to hide per-chunk round-trip latency (network FS, cold
disk, database round trips), which takes a handful of in-flight requests —
while warm-local-cache reads are GIL/memcpy-bound, where a large pool only
thrashes.  ``io_threads=1`` (or $KISHU_IO_THREADS=1) restores the serial
path exactly.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Any, Callable, Iterable, Iterator, List, Optional, Sequence

DEFAULT_IO_THREADS = min(8, max(4, os.cpu_count() or 1))

# Adaptive-engagement latency gate (see StateLoader.load_covs).  A first
# slab fetched below this per-chunk latency means the store is serving at
# memory/cache-bandwidth class, where a thread pipeline only adds GIL and
# FS-client contention — the restore stays serial without further probing.
# Slower stores get an *empirical* trial: a few slabs fetched concurrently,
# and the measured serial vs parallel per-chunk rates pick the strategy for
# the remainder (some transports, e.g. 9p mounts, are high-latency yet
# serialize concurrent requests — only a measurement can tell).
PARALLEL_LATENCY_THRESHOLD_S = 1e-3

# The concurrent trial must beat the serial probe's per-chunk rate by this
# factor to keep the pipeline.  A transport that merely *serializes*
# concurrent requests measures ~1.0 here (and would later lose to
# consumer-side GIL contention); genuine round-trip hiding measures
# ~1/workers.  Between the two, serial is the safe choice.
PARALLEL_TRIAL_MARGIN = 0.75

_POOL_SIZE = 16          # shared-pool capacity; per-call windows bound usage
_pool: Optional[ThreadPoolExecutor] = None
_pool_lock = threading.Lock()

# Dedicated scatter-gather pool for the storage fabric (fabric.py).  Fabric
# concurrency is *topology-shaped* — one in-flight request per shard/replica,
# possibly issued from inside a checkout pipeline worker — so it must not
# share capacity with (or wait on) the chunk I/O pool: a fabric task queued
# behind the very pipeline worker awaiting it would deadlock.
_FABRIC_POOL_SIZE = 16
_fabric_pool: Optional[ThreadPoolExecutor] = None
_fabric_lock = threading.Lock()

_worker_state = threading.local()
_fabric_state = threading.local()


def _shared_pool() -> ThreadPoolExecutor:
    global _pool
    if _pool is None:
        with _pool_lock:
            if _pool is None:
                _pool = ThreadPoolExecutor(
                    max_workers=_POOL_SIZE,
                    thread_name_prefix="kishu-io")
    return _pool


def _fabric_shared_pool() -> ThreadPoolExecutor:
    global _fabric_pool
    if _fabric_pool is None:
        with _fabric_lock:
            if _fabric_pool is None:
                _fabric_pool = ThreadPoolExecutor(
                    max_workers=_FABRIC_POOL_SIZE,
                    thread_name_prefix="kishu-fabric")
    return _fabric_pool


def in_fabric_worker() -> bool:
    """True on a fabric scatter thread (nested fabrics degrade to serial)."""
    return getattr(_fabric_state, "is_worker", False)


def scatter_parallel(fn: Callable[[Any], Any], items: Sequence[Any]
                     ) -> List[Any]:
    """Ordered scatter-gather over fabric children (shards / replicas /
    tiers): one task per item on the dedicated fabric pool, all driven
    concurrently, results gathered in order.  The first child exception
    propagates.

    Scatter tasks are tagged both as fabric workers (a nested fabric — a
    replica set inside a shard ring — runs its own scatter serially instead
    of re-entering the pool) and as I/O workers (``serial_section``), so leaf
    backends' native batching degrades to plain loops: each child store
    behaves like one device that serializes its own requests, and all
    cross-device concurrency lives here, bounded by the topology's width.
    """
    items = list(items)
    if len(items) <= 1 or in_fabric_worker():
        return [fn(it) for it in items]

    def run(it):
        _fabric_state.is_worker = True
        with serial_section():
            return fn(it)

    futs = [_fabric_shared_pool().submit(run, it) for it in items]
    return [f.result() for f in futs]


def resolve_io_threads(n: Optional[int] = None) -> int:
    """Effective worker count: explicit arg > $KISHU_IO_THREADS > default.

    ``<= 1`` means serial (the pre-engine behavior, kept as the benchmark
    baseline and the fallback for tiny transfers)."""
    if n is None:
        env = os.environ.get("KISHU_IO_THREADS", "").strip()
        try:
            n = int(env) if env else DEFAULT_IO_THREADS
        except ValueError:      # unparseable knob: default, don't crash
            n = DEFAULT_IO_THREADS
    return max(1, int(n))


def in_io_worker() -> bool:
    """True when running on one of this module's pool threads (guards
    backend-native batching from nesting another pool)."""
    return getattr(_worker_state, "is_worker", False)


class serial_section:
    """Context manager marking the current thread as an I/O worker, so
    backend-native batched ops inside it degrade to serial loops.  The
    checkout engine owns its concurrency (slabs across pool threads) and
    uses this to keep its probes and serial remainders genuinely serial —
    without it, a main-thread ``get_chunks`` probe would measure the
    backend's own pool, not the store."""

    def __enter__(self):
        self._prev = getattr(_worker_state, "is_worker", False)
        _worker_state.is_worker = True
        return self

    def __exit__(self, *exc):
        _worker_state.is_worker = self._prev
        return False


def _tagged(fn: Callable, item: Any) -> Any:
    _worker_state.is_worker = True
    return fn(item)


def map_parallel(fn: Callable[[Any], Any], items: Sequence[Any],
                 max_workers: Optional[int] = None) -> List[Any]:
    """Ordered parallel map; serial for trivial inputs or nested calls.
    The first worker exception propagates to the caller."""
    items = list(items)
    workers = min(resolve_io_threads(max_workers), len(items))
    if workers <= 1 or len(items) <= 1 or in_io_worker():
        return [fn(it) for it in items]
    out: List[Any] = [None] * len(items)

    def run_at(i):
        return i, fn(items[i])
    for i, result in prefetch_map(run_at, range(len(items)), workers):
        out[i] = result
    return out


def iter_slabs(seq: Sequence[Any], slab_size: int) -> Iterator[List[Any]]:
    """Contiguous slabs preserving order (cov-ordered keys stay cov-ordered,
    so early co-variables complete — and materialize — early)."""
    slab_size = max(1, int(slab_size))
    for i in range(0, len(seq), slab_size):
        yield list(seq[i:i + slab_size])


def slab_size_for(n_items: int, workers: int, *, max_slab: int = 500) -> int:
    """Batch size giving each worker a few slabs to pipeline (granular enough
    that consumption overlaps I/O, coarse enough to amortize dispatch)."""
    if n_items <= 0:
        return 1
    return max(1, min(max_slab, -(-n_items // (max(1, workers) * 3))))


def fetch_chunks(store, keys: Sequence[str],
                 max_workers: Optional[int] = None, *,
                 missing_ok: bool = True) -> dict:
    """Deduplicated bulk chunk fetch through the prefetch pipeline —
    round-trip hiding for latency-bound stores; degrades to one
    backend-native batched call for small requests, non-parallel stores, or
    nested calls.  Shared by the patch-checkout planner and maintenance
    paths; the pipeline's worker tagging keeps backend-native batching from
    nesting a second pool."""
    uniq = list(dict.fromkeys(keys))
    workers = resolve_io_threads(max_workers)
    min_slab = getattr(store, "min_slab", 1)
    if getattr(store, "native_scatter", False) \
            or not getattr(store, "supports_parallel_get", True) \
            or workers <= 1 \
            or in_io_worker() or len(uniq) <= max(min_slab, workers):
        # native_scatter: the store fans the whole request out across its
        # devices itself — one call maximizes its load balance
        return store.get_chunks(uniq, missing_ok=missing_ok)
    slabs = iter_slabs(uniq, max(min_slab, slab_size_for(len(uniq), workers)))
    out: dict = {}
    for got in prefetch_map(
            lambda slab: store.get_chunks(slab, missing_ok=True),
            slabs, workers):
        out.update(got)
    if not missing_ok and len(out) != len(uniq):
        from repro_torch.core.serialize import ChunkMissingError
        raise ChunkMissingError(next(k for k in uniq if k not in out))
    return out


def prefetch_map(fn: Callable[[Any], Any], items: Iterable[Any],
                 max_workers: Optional[int] = None,
                 window: Optional[int] = None) -> Iterator[Any]:
    """Yield ``fn(item)`` results as they complete, submission bounded to a
    sliding window (back-pressure and the effective concurrency limit: never
    more than ``window`` items in flight on the shared pool).  Results
    arrive unordered, on the calling thread — the consumer can materialize
    while the pool keeps fetching.  Worker exceptions propagate on yield;
    remaining futures are cancelled."""
    workers = resolve_io_threads(max_workers)
    if workers <= 1 or in_io_worker():
        for it in items:
            yield fn(it)
        return
    window = window or workers
    it = iter(items)
    ex = _shared_pool()
    inflight = set()
    def refill():
        nonlocal exhausted
        while not exhausted and len(inflight) < window:
            try:
                inflight.add(ex.submit(_tagged, fn, next(it)))
            except StopIteration:
                exhausted = True

    try:
        exhausted = False
        while True:
            refill()
            if not inflight:
                return
            done, inflight = wait(inflight, return_when=FIRST_COMPLETED)
            refill()      # keep workers busy while the consumer processes
            for f in done:
                yield f.result()
    finally:
        for f in inflight:
            f.cancel()
