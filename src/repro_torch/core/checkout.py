"""Incremental checkout — the State Loader (§5.2).

Given the current HEAD and a target commit, compute the diverged co-variables
via the Checkpoint Graph index (Def 6), load *only* those from their
manifests, reconstruct shared references (aliases/views), and swap them into
the live namespace without touching identical co-variables.  Missing or
corrupt data falls back to recomputation (restore.py).

Chunk I/O is planned up front and executed by the parallel engine
(parallel.py, DESIGN.md §9): all chunk keys of the diff plan are deduplicated
into cov-ordered slabs, fetched with bounded concurrency, and each
co-variable is deserialized/materialized on the calling thread the moment its
last chunk lands — restore latency tracks store bandwidth, not per-chunk
round-trips.
"""
from __future__ import annotations

import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.core import delta as delta_mod
from repro_torch.core import parallel
from repro_torch.core.chunkstore import ChunkCache, ChunkStore
from repro_torch.core.covariable import CovKey, LeafRecord
from repro_torch.core.graph import CheckpointGraph, CheckoutPlan, key_str
from repro_torch.core.hashing import hashes_hex
from repro_torch.core.serialize import (ChunkMissingError, SerializationError,
                                        alias_key, base_of, leaf_from_bytes,
                                        leaf_meta, leaf_nbytes,
                                        view_from_base)
from repro_torch.sharding.resharding import local_byte_range, restore_shard


@dataclass
class CheckoutStats:
    covs_loaded: int = 0
    covs_patched: int = 0           # subset of covs_loaded done via patching
    covs_deleted: int = 0
    covs_identical: int = 0
    covs_recomputed: int = 0        # co-variables restored via replay
                                    # (counted once per cov by DataRestorer)
    bytes_loaded: int = 0           # *moved*: bytes fetched from the backend
    bytes_cached: int = 0           # served from the shared chunk cache
    bytes_logical: int = 0          # logical size of restored co-variables
    chunks_patched: int = 0         # dirty chunks fetched + patched in
    chunks_inplace: int = 0         # clean chunks reused from the live buffer
    bytes_host2dev: int = 0         # host→device bytes patch uploads moved
                                    # (mirror of WriteStats.bytes_dev2host)
    covs_scattered: int = 0         # device covs patched in one fused
                                    # scatter pass (kernels/patch_scatter)
    kernel_fallbacks: int = 0       # device-kernel → host degradations
    covs_planned_fetch: int = 0     # planner lane sizes (0 when plan_mode
    covs_planned_replay: int = 0    #  is off — the fixed ladder ran)
    covs_planned_patch: int = 0
    plan_est_s: float = 0.0         # planner's cost estimate for the
                                    # checkout (compare against wall_s)
    wall_s: float = 0.0
    diff_s: float = 0.0


# CheckoutStats fields a concurrent fetch lane accumulates into its own
# instance and merges back after joining (plain += on a shared dataclass
# would race with the replay lane)
_ADDITIVE_STATS = (
    "covs_loaded", "covs_patched", "covs_deleted", "covs_recomputed",
    "bytes_loaded", "bytes_cached", "bytes_logical", "chunks_patched",
    "chunks_inplace", "bytes_host2dev", "covs_scattered", "kernel_fallbacks")


def _merge_stats(dst: CheckoutStats, src: CheckoutStats) -> None:
    for name in _ADDITIVE_STATS:
        setattr(dst, name, getattr(dst, name) + getattr(src, name))


@dataclass
class ChunkPatch:
    """Chunk-level checkout plan for one diverged co-variable: fetch only
    ``dirty`` chunks of the target manifest and patch them into the live
    base buffer, reusing every clean chunk already in memory."""
    key: CovKey
    version: str
    manifest: dict
    base: Any                       # live base buffer (np.ndarray/Tensor)
    dirty: List[int]                # chunk indices to fetch + patch
    offsets: List[int]              # byte offset of every chunk
    is_device: bool                 # tensor base: fused scatter, in place


def materialize_manifest(store: ChunkStore, manifest: dict,
                         stats: Optional[CheckoutStats] = None,
                         chunks: Optional[Dict[str, bytes]] = None,
                         device: Optional[torch.device] = None
                         ) -> Dict[str, Any]:
    """Load a co-variable's values from its manifest.

    Reconstructs shared references: one base buffer, members as views/aliases.
    ``chunks`` is an optional prefetched cache; keys absent from it are
    re-tried against the store (covers async-writer races) before failing.
    Device-array bases (``"jax": true`` metas) land on ``device``.
    Raises ChunkMissingError / SerializationError on failure (-> fallback).
    """
    if manifest.get("unserializable"):
        raise SerializationError("manifest flagged unserializable")
    base_info = manifest["base"]
    parts = []
    for c in base_info["chunks"]:
        data = chunks.get(c["key"]) if chunks is not None else None
        if data is None:
            data = store.get_chunk(c["key"])
            if stats:
                stats.bytes_loaded += len(data)
        if len(data) != c["n"]:
            raise ChunkMissingError(f"chunk {c['key']}: size mismatch")
        parts.append(data)
    nbytes = sum(len(p) for p in parts)
    if nbytes != base_info["nbytes"]:
        raise ChunkMissingError("assembled size mismatch")
    if stats:
        stats.bytes_logical += nbytes
    # the parts go to the leaf unjoined: a tensor copies them once, into
    # its (pinned, on a card) staging buffer
    base = leaf_from_bytes(parts, base_info["meta"], device=device)

    out: Dict[str, Any] = {}
    for m in manifest["members"]:
        if m.get("view"):
            out[m["name"]] = view_from_base(base, m["view"])
        else:
            out[m["name"]] = base
    return out


def records_from_manifest(manifest: dict, values: Dict[str, Any]
                          ) -> Dict[str, LeafRecord]:
    """Rebuild LeafRecords after checkout without rehashing (det hashes are
    stored in the manifest)."""
    det_hex = [] if manifest.get("unserializable") else \
        manifest["base"].get("det_hashes", [])
    det = np.array([int(h, 16) for h in det_hex], dtype=np.uint64)
    base_id = None
    out = {}
    for m in manifest["members"]:
        val = values[m["name"]]
        b = base_of(val)
        out[m["name"]] = LeafRecord(
            name=m["name"], kind=m["kind"], dtype=m["dtype"],
            shape=tuple(m["shape"]), nbytes=m["nbytes"],
            alias_id=alias_key(b),
            view=m.get("view"), base_hashes=det if len(det) else None)
    return out


class StateLoader:
    def __init__(self, graph: CheckpointGraph, store: ChunkStore,
                 fallback=None, *, io_threads: Optional[int] = None,
                 cache: Optional[ChunkCache] = None,
                 device: Optional[torch.device] = None):
        self.graph = graph
        self.store = store
        self.device = device          # where device-array leaves restore
        self.fallback = fallback      # callable (key, version, stats) -> values
        # shared chunk cache (writer-populated): just-committed chunks are
        # served from memory, never the backend
        self.chunk_cache = cache
        # chunk-level patch checkout (dirty-chunk fetch into live buffers);
        # False restores the cov-granular pre-delta path (benchmarks).
        self.patch_enabled = True
        # <=1 forces the serial pre-engine path (benchmark baseline).
        self.io_threads = parallel.resolve_io_threads(io_threads)
        # Adaptive engagement (see parallel.py): first-slab latency below
        # the gate stays serial outright; above it a measured trial decides.
        # probe_threshold_s = 0.0 forces the pipeline; inf forces serial.
        self.probe_threshold_s = parallel.PARALLEL_LATENCY_THRESHOLD_S
        # observability handle (set by the session owning this loader)
        self.obs = None
        # cost-based checkout planner (set by the session when plan_mode is
        # not off); None keeps the fixed patch->fetch->fallback ladder
        self.planner = None
        # name -> (mesh, placements) of the DTensor co-variables (set by
        # the session): these restore shard-locally on their placements
        self.layouts: Dict[str, Tuple[Any, tuple]] = {}

    def _span(self, name: str, **args):
        return self.obs.span(name, **args) if self.obs is not None \
            else nullcontext()

    def _cache_probe(self, keys, stats: Optional[CheckoutStats]
                     ) -> Dict[str, bytes]:
        """Chunks served by the shared cache (accounted as cached bytes)."""
        if self.chunk_cache is None:
            return {}
        hits = self.chunk_cache.get_many(dict.fromkeys(keys))
        if stats and hits:
            stats.bytes_cached += sum(len(v) for v in hits.values())
        return hits

    @staticmethod
    def _fetch_parallel(slabs, fetch, consume, workers):
        """Stream ``slabs`` through the prefetch pipeline; returns [] (all
        consumed) so callers can fall through to the serial remainder."""
        for slab, got in parallel.prefetch_map(fetch, slabs, workers):
            consume(slab, got)
        return []

    def _layout_of(self, key: CovKey):
        """(mesh, placements) of a DTensor co-variable, else None."""
        return self.layouts.get(key[0]) if len(key) == 1 else None

    def _load_shard(self, key: CovKey, manifest: dict,
                    stats: Optional[CheckoutStats]) -> Dict[str, Any]:
        """A DTensor co-variable: this rank reads the chunks of its own
        byte range and rebuilds its shard on its placements."""
        mesh, placements = self._layout_of(key)
        if manifest.get("unserializable"):
            raise SerializationError("manifest flagged unserializable")
        return {key[0]: restore_shard(self.store, manifest, mesh,
                                      placements, self.device, stats)}

    def load_cov(self, key: CovKey, version: str,
                 stats: Optional[CheckoutStats] = None) -> Dict[str, Any]:
        manifest = self.graph.manifest_of(key, version)
        if manifest is not None and self._layout_of(key) is not None:
            try:
                return self._load_shard(key, manifest, stats)
            except (ChunkMissingError, SerializationError):
                pass
        elif manifest is not None and not manifest.get("unserializable"):
            hits = self._cache_probe(
                [c["key"] for c in manifest["base"]["chunks"]], stats)
            try:
                return materialize_manifest(self.store, manifest, stats,
                                            chunks=hits or None,
                                            device=self.device)
            except (ChunkMissingError, SerializationError):
                pass
        if self.fallback is None:
            raise ChunkMissingError(
                f"co-variable {key} @ {version} unavailable and no fallback")
        # covs_recomputed is owned by the DataRestorer (one count per
        # replayed co-variable) — incrementing here too double-counted
        # recursive fallbacks
        return self.fallback(key, version, stats)

    def load_covs(self, items: Sequence[Tuple[CovKey, str]],
                  stats: Optional[CheckoutStats] = None, *,
                  use_fallback: bool = True
                  ) -> Dict[CovKey, Dict[str, Any]]:
        """Load many versioned co-variables through the parallel engine.

        Plans every chunk key up front (deduplicated across co-variables —
        content addressing means branches share chunks), streams cov-ordered
        slabs through a bounded-concurrency prefetch pipeline, and
        materializes each co-variable on the calling thread as soon as its
        last chunk arrives, overlapping deserialization with in-flight I/O.

        Per-cov failures (missing/corrupt chunks, unserializable manifests)
        degrade to the serial ``load_cov`` path, which recomputes via
        ``fallback``.  With ``use_fallback=False`` failed co-variables are
        omitted from the result instead (the Data Restorer drives its own
        recursion bookkeeping).
        """
        out: Dict[CovKey, Dict[str, Any]] = {}
        retry: List[Tuple[CovKey, str]] = []    # -> serial/fallback path
        cache: Dict[str, bytes] = {}            # prefetched chunks
        ready: List[Tuple[CovKey, str, dict, List[str]]] = []
        for key, version in items:
            manifest = self.graph.manifest_of(key, version)
            if manifest is None or manifest.get("unserializable") \
                    or self._layout_of(key) is not None:
                retry.append((key, version))      # DTensors load shard-
            else:                                 # locally (load_cov)
                ready.append((key, version, manifest,
                              [c["key"] for c in manifest["base"]["chunks"]]))

        # shared-cache pass: chunks written or fetched earlier this session
        # are served from memory and never enter the fetch plan
        cache.update(self._cache_probe(
            [ck for _, _, _, cks in ready for ck in cks], stats))

        workers = self.io_threads \
            if getattr(self.store, "supports_parallel_get", True) else 1
        if workers <= 1 or len(ready) == 0:
            for key, version, _, _ in ready:
                retry.append((key, version))
            retry.sort()
        else:
            # chunk key -> indices of covs waiting on it (cov order kept)
            owners: Dict[str, List[int]] = {}
            pending = []
            for i, (_, _, _, cks) in enumerate(ready):
                uniq = set(cks) - cache.keys()    # cache hits need no fetch
                pending.append(len(uniq))
                for ck in uniq:
                    owners.setdefault(ck, []).append(i)
            unique_keys = list(owners)
            # refs: covs not yet finished per chunk key — once a key's last
            # owner materializes its bytes are evicted from the cache, so
            # peak memory is bounded by in-flight covs, not the whole
            # restore.  Keys of *failed* covs stay pinned for the retry.
            refs = {ck: len(own) for ck, own in owners.items()}
            pinned: set = set()

            def fetch(slab):
                # serial_section: the engine owns concurrency (slabs across
                # pool threads); the backend must not nest its own pool.
                with parallel.serial_section():
                    return slab, self.store.get_chunks(slab, missing_ok=True)

            def finish(i):
                key, version, manifest, cks = ready[i]
                try:
                    out[key] = materialize_manifest(self.store, manifest,
                                                    stats, chunks=cache,
                                                    device=self.device)
                except (ChunkMissingError, SerializationError):
                    retry.append((key, version))
                    pinned.update(cks)
                for ck in set(cks):
                    if ck not in refs:            # cache-served key
                        continue
                    refs[ck] -= 1
                    if refs[ck] == 0 and ck not in pinned:
                        cache.pop(ck, None)

            def consume(slab, got):
                cache.update(got)
                if stats:
                    stats.bytes_loaded += sum(len(v) for v in got.values())
                if self.chunk_cache is not None:
                    self.chunk_cache.put_many(got)
                for ck in slab:      # missing keys count as resolved: the
                    for i in owners[ck]:   # cov will fail -> fallback
                        pending[i] -= 1
                        if pending[i] == 0:
                            finish(i)

            for i, n in enumerate(pending):
                if n == 0:           # chunkless manifest (empty buffer)
                    finish(i)

            slabs = list(parallel.iter_slabs(
                unique_keys,
                max(getattr(self.store, "min_slab", 1),
                    parallel.slab_size_for(len(unique_keys), workers))))
            # Adaptive engagement: bandwidth-bound stores (warm cache,
            # RAM-speed media) stay serial — a pipeline only adds
            # contention; round-trip-bound stores engage it after a
            # measured trial.
            if slabs:
                # Slab 0 absorbs cold-start effects (cache revalidation,
                # first touch) so the probe compares steady-state rates.
                consume(*fetch(slabs[0]))
                rest = slabs[1:]
                if self.probe_threshold_s <= 0:     # forced pipeline
                    rest = self._fetch_parallel(rest, fetch, consume, workers)
                elif rest:
                    # Probe: one slab on the calling thread, timed.
                    t0 = time.perf_counter()
                    slab1, got1 = fetch(rest[0])
                    dt = max(time.perf_counter() - t0, 1e-9)
                    consume(slab1, got1)
                    per_chunk_serial = dt / max(1, len(slab1))
                    rest = rest[1:]
                    if per_chunk_serial >= self.probe_threshold_s and rest:
                        # Slow store: trial a few slabs concurrently and
                        # keep the pipeline only if its measured rate beats
                        # serial by a clear margin (high-latency transports
                        # that *serialize* concurrency lose the trial).
                        # Timed around the fetches only — the serial probe
                        # above excludes consume() too.
                        trial, rest = rest[:workers], rest[workers:]
                        t0 = time.perf_counter()
                        trial_got = parallel.map_parallel(
                            lambda s: fetch(s)[1], trial, workers)
                        dt2 = max(time.perf_counter() - t0, 1e-9)
                        for slab, got in zip(trial, trial_got):
                            consume(slab, got)
                        per_chunk_par = dt2 \
                            / max(1, sum(len(s) for s in trial))
                        if per_chunk_par <= per_chunk_serial \
                                * parallel.PARALLEL_TRIAL_MARGIN:
                            rest = self._fetch_parallel(rest, fetch, consume,
                                                        workers)
                for slab in rest:                   # serial remainder
                    consume(*fetch(slab))

        for key, version in retry:
            manifest = self.graph.manifest_of(key, version)
            if manifest is not None and self._layout_of(key) is not None:
                try:
                    out[key] = self._load_shard(key, manifest, stats)
                    continue
                except (ChunkMissingError, SerializationError):
                    pass
            elif manifest is not None \
                    and not manifest.get("unserializable"):
                try:
                    # reuse prefetched chunks; absent keys retry the store
                    out[key] = materialize_manifest(
                        self.store, manifest, stats,
                        chunks=cache if cache else None, device=self.device)
                    continue
                except (ChunkMissingError, SerializationError):
                    pass
            if not use_fallback:
                continue
            if self.fallback is None:
                raise ChunkMissingError(
                    f"co-variable {key} @ {version} unavailable and no "
                    f"fallback")
            out[key] = self.fallback(key, version, stats)
        return out

    # ------------------------------------------------------------------
    # chunk-level patch checkout
    # ------------------------------------------------------------------
    def _patch_candidate(self, key: CovKey, version: str,
                         records: Dict[str, LeafRecord], ns,
                         alias_groups: Dict[int, set]
                         ) -> Optional[ChunkPatch]:
        """Chunk-level plan for one diverged co-variable, or None when only
        full materialization is safe (structure divergence, missing hashes,
        unaligned/non-contiguous buffers, or everything dirty)."""
        manifest = self.graph.manifest_of(key, version)
        if manifest is None or manifest.get("unserializable"):
            return None
        base_info = manifest.get("base") or {}
        meta = base_info.get("meta") or {}
        tgt_det = base_info.get("det_hashes") or []
        tgt_chunks = base_info.get("chunks") or []
        nbytes = base_info.get("nbytes", 0)
        if meta.get("kind") != "array" or not tgt_det or nbytes <= 0 \
                or len(tgt_det) != len(tgt_chunks):
            return None
        man_members = {m["name"]: m for m in manifest["members"]}
        if set(man_members) != set(key):
            return None
        # live side: every member present, same structure, one shared base
        recs = []
        for name in key:
            rec = records.get(name)
            if rec is None or name not in ns:
                return None
            recs.append(rec)
        if len({r.alias_id for r in recs}) != 1 \
                or alias_groups.get(recs[0].alias_id) != set(key):
            return None                 # live aliasing differs from target
        live_det = recs[0].base_hashes
        if live_det is None or len(live_det) != len(tgt_det):
            return None
        for rec, name in zip(recs, key):
            m = man_members[name]
            if (rec.kind, rec.dtype, list(rec.shape), rec.view) != \
                    (m["kind"], m["dtype"], m["shape"], m.get("view")):
                return None
        base = base_of(ns[key[0]])
        if leaf_meta(base) != meta or leaf_nbytes(base) != nbytes:
            return None

        offsets = delta_mod.chunk_offsets(tgt_chunks)
        if offsets and offsets[-1] + int(tgt_chunks[-1]["n"]) != nbytes:
            return None
        dirty = delta_mod.dirty_indices(hashes_hex(live_det), tgt_det)
        if len(dirty) == len(tgt_det) and (
                len(dirty) > 1 or not isinstance(base, torch.Tensor)):
            # fully diverged: a full load is cheaper.  A tensor of one chunk
            # moves that chunk either way, and patched it keeps its storage
            # (a captured decode graph reads a cache's index there)
            return None

        if isinstance(base, DTensor):
            # a DTensor patches its local shard: only the dirty chunks in
            # this rank's byte range are fetched
            rng = local_byte_range(base)
            if rng is None or not base.to_local().is_contiguous():
                return None
            dirty = [i for i in dirty if offsets[i] < rng[1]
                     and offsets[i] + int(tgt_chunks[i]["n"]) > rng[0]]
            is_device = True
        elif isinstance(base, np.ndarray):
            if not (base.flags["C_CONTIGUOUS"] and base.flags["WRITEABLE"]):
                return None
            try:
                memoryview(base).cast("B")
            except (TypeError, ValueError, BufferError):
                return None
            is_device = False
        elif isinstance(base, torch.Tensor):
            # tensors patch in place, like numpy bases, so views of the
            # base stay valid; the byte image must be the storage itself
            if not base.is_contiguous():
                return None
            is_device = True
        else:
            return None
        return ChunkPatch(key=key, version=version, manifest=manifest,
                          base=base, dirty=dirty, offsets=offsets,
                          is_device=is_device)

    def plan_patches(self, plan: CheckoutPlan, records: Dict[str, LeafRecord],
                     ns) -> Tuple[List[ChunkPatch], List[Tuple[CovKey, str]]]:
        """Split the cov-granular diff into chunk-level patches and full
        loads; patches are also recorded on ``plan.patches``."""
        full: List[Tuple[CovKey, str]] = []
        patches: List[ChunkPatch] = []
        if not self.patch_enabled:
            return [], sorted(plan.to_load.items())
        alias_groups: Dict[int, set] = {}
        for name, rec in records.items():
            alias_groups.setdefault(rec.alias_id, set()).add(name)
        for key, version in sorted(plan.to_load.items()):
            p = self._patch_candidate(key, version, records, ns, alias_groups)
            if p is None:
                full.append((key, version))
            else:
                patches.append(p)
        plan.patches = patches
        return patches, full

    def _fetch_patch_chunks(self, patches: List[ChunkPatch],
                            stats: Optional[CheckoutStats]
                            ) -> Tuple[Dict[str, bytes], List[ChunkPatch],
                                       List[Tuple[CovKey, str]]]:
        """Fetch the dirty chunks of all patch plans (cache first, then one
        pipelined bulk fetch).  Plans with missing/short chunks demote to
        full loads."""
        need: Dict[str, int] = {}       # key -> expected logical size
        for p in patches:
            chunks = p.manifest["base"]["chunks"]
            for i in p.dirty:
                need[chunks[i]["key"]] = int(chunks[i]["n"])
        got = self._cache_probe(need, stats)
        missing = [k for k in need if k not in got]
        if missing:
            fetched = parallel.fetch_chunks(self.store, missing,
                                            self.io_threads)
            if stats:
                stats.bytes_loaded += sum(len(v) for v in fetched.values())
            if self.chunk_cache is not None:
                self.chunk_cache.put_many(fetched)
            got.update(fetched)
        ok_patches: List[ChunkPatch] = []
        demoted: List[Tuple[CovKey, str]] = []
        for p in patches:
            chunks = p.manifest["base"]["chunks"]
            bad = [i for i in p.dirty
                   if chunks[i]["key"] not in got
                   or len(got[chunks[i]["key"]]) != int(chunks[i]["n"])]
            if bad:
                # demotion is a degradation like any other: log-once + bump
                # the per-session fallback counter instead of going silent
                delta_mod.note_kernel_fallback(
                    "fetch_patch_chunks",
                    ChunkMissingError(
                        f"{key_str(p.key)}@{p.version}: {len(bad)} patch "
                        f"chunk(s) missing/short (first: "
                        f"{chunks[bad[0]]['key']})"))
                demoted.append((p.key, p.version))
            else:
                ok_patches.append(p)
        return got, ok_patches, demoted

    def _apply_patch(self, p: ChunkPatch, got: Dict[str, bytes],
                     stats: Optional[CheckoutStats], ns) -> Dict[str, Any]:
        """Patch dirty chunks into the live base and return the member
        values of the target state (live view/alias objects are preserved
        for in-place numpy patches)."""
        base_info = p.manifest["base"]
        chunks = base_info["chunks"]
        segs = [(p.offsets[i], got[chunks[i]["key"]]) for i in p.dirty]
        if p.is_device:
            # fused scatter: one compacted upload + one kernel pass for ALL
            # dirty chunks of this co-variable; segments that are not whole
            # chunks are written one copy each
            chunk_bytes = int(chunks[0]["n"]) if len(chunks) > 1 else 0
            moved = delta_mod.patch_device_chunks(p.base, segs, chunk_bytes)
            if moved is not None:
                if stats:
                    stats.covs_scattered += 1
                    stats.bytes_host2dev += moved
            else:
                delta_mod.patch_tensor_base(p.base, segs)
                if stats:
                    stats.bytes_host2dev += sum(len(d) for _, d in segs)
        else:
            delta_mod.patch_numpy_base(p.base, segs)
        # live members already view the patched base: identity preserved
        values = {m["name"]: ns[m["name"]] for m in p.manifest["members"]}
        if stats:
            stats.covs_patched += 1
            stats.chunks_patched += len(p.dirty)
            stats.chunks_inplace += len(chunks) - len(p.dirty)
            stats.bytes_logical += base_info["nbytes"]
        return values

    def _materialize_mixed(self, full_items: List[Tuple[CovKey, str]],
                           replay_items: List[Tuple[CovKey, str]],
                           stats: Optional[CheckoutStats]
                           ) -> Dict[CovKey, Dict[str, Any]]:
        """Execute the planner's lanes: fetch slabs stream on a helper
        thread while replays run on the calling thread (commands may touch
        thread-affine state, and the restorer's own dependency loads nest
        safely through the re-entrant parallel engine).  A replay the
        planner mispredicted demotes to the fetch path after the lanes
        join — planner-on never changes what a checkout can restore.

        Stream order on a card: a full load copies each tensor to the card
        asynchronously on the current stream of the thread that
        materializes it.  The helper thread therefore enters the calling
        thread's current stream, so both lanes issue on one stream and
        the swap (and every later use of a loaded tensor on that stream)
        runs after every copy of either lane."""
        if not replay_items:
            return self.load_covs(full_items, stats)
        box: Dict[str, Any] = {}
        fstats = CheckoutStats()
        th = None
        if full_items:
            stream = torch.cuda.current_stream(self.device) \
                if self.device is not None and self.device.type == "cuda" \
                else None

            def _fetch_lane():
                try:
                    with torch.cuda.stream(stream) if stream is not None \
                            else nullcontext():
                        box["out"] = self.load_covs(full_items, fstats)
                except BaseException as e:  # noqa: BLE001 — raised on join
                    box["err"] = e
            th = threading.Thread(target=_fetch_lane,
                                  name="kishu-fetch-lane", daemon=True)
            th.start()
        loaded: Dict[CovKey, Dict[str, Any]] = {}
        demoted: List[Tuple[CovKey, str]] = []
        for key, version in replay_items:
            try:
                if self.fallback is None:
                    raise ChunkMissingError(
                        f"co-variable {key} @ {version}: replay planned "
                        f"but no fallback wired")
                loaded[key] = self.fallback(key, version, stats)
            except Exception as e:  # noqa: BLE001 — mispredicted replay
                delta_mod.note_kernel_fallback("plan_replay", e)
                demoted.append((key, version))
        if th is not None:
            th.join()
        if stats is not None:
            _merge_stats(stats, fstats)
        if "err" in box:
            raise box["err"]
        loaded.update(box.get("out", {}))
        if demoted:
            loaded.update(self.load_covs(demoted, stats))
        return loaded

    def checkout(self, tracked_ns, records: Dict[str, LeafRecord],
                 target: str) -> Tuple[Dict[str, LeafRecord], CheckoutStats]:
        """Execute an incremental checkout; mutates the namespace in place.

        Returns (updated record map, stats)."""
        stats = CheckoutStats()
        t0 = time.perf_counter()
        fb0 = delta_mod.kernel_fallbacks()
        cur = self.graph.head
        td = time.perf_counter()
        replay_items: List[Tuple[CovKey, str]] = []
        # 1. plan: graph diff + chunk-level refinement — diverged covs whose
        #    live buffer matches the target structurally only fetch their
        #    differing chunks; an engaged planner then prices fetch vs
        #    replay vs patch per co-variable and splits the work into lanes
        with self._span("plan"):
            plan: CheckoutPlan = self.graph.diff(cur, target)
            stats.diff_s = time.perf_counter() - td
            stats.covs_identical = len(plan.identical)
            patches, full_items = self.plan_patches(plan, records,
                                                    tracked_ns.base)
            if self.planner is not None and self.planner.engaged:
                priced = self.planner.price(cur, target, plan, patches,
                                            full_items)
                patches, full_items, replay_items = self.planner.partition(
                    priced, patches, full_items)
                plan.patches = patches
                stats.covs_planned_patch = len(patches)
                stats.covs_planned_fetch = len(full_items)
                stats.covs_planned_replay = len(replay_items)
                stats.plan_est_s = priced.est_total_s
        with self._span("fetch"):
            patch_data, patches, demoted = self._fetch_patch_chunks(patches,
                                                                    stats)
        full_items = sorted(full_items + demoted)

        # 2. load fully-diverged co-variables (before mutating anything),
        #    chunk I/O planned up front and prefetched in parallel; with a
        #    planner mixed plan the fetch slabs stream on a helper thread
        #    while replays run here
        with self._span("materialize",
                        covs=len(full_items) + len(replay_items)):
            loaded = self._materialize_mixed(full_items, replay_items, stats)

        # 3. apply patches (all data is in hand); a numpy patch that fails
        #    falls back to the full serial load of just that co-variable.
        #    A tensor patch launches the scatter kernel or raises: a failure
        #    on the card is never hidden behind a host reload.
        with self._span("patch", covs=len(patches)):
            for p in patches:
                try:
                    loaded[p.key] = self._apply_patch(p, patch_data, stats,
                                                      tracked_ns.base)
                except Exception as e:  # noqa: BLE001 — corrupt patch:
                    if p.is_device:
                        raise
                    delta_mod.note_kernel_fallback("apply_patch", e)
                    loaded[p.key] = self.load_cov(p.key, p.version, stats)

        # 4. swap into the namespace (tracking paused: checkout is not access)
        new_records = dict(records)
        with self._span("swap"), tracked_ns.pause():
            for key in plan.to_delete:
                for name in key:
                    if name in tracked_ns.base:
                        del tracked_ns.base[name]
                    new_records.pop(name, None)
            for key, values in loaded.items():
                manifest = self.graph.manifest_of(key, plan.to_load[key])
                for name, val in values.items():
                    tracked_ns.base[name] = val
                if manifest is not None and not manifest.get("unserializable"):
                    new_records.update(records_from_manifest(manifest, values))
                else:
                    # recomputed: rebuild records by hashing
                    from repro_torch.core.covariable import RecordBuilder
                    rb = RecordBuilder()
                    cache: Dict[int, Any] = {}
                    for name, val in values.items():
                        new_records[name] = rb.build(name, val, cache)

        stats.covs_loaded = len(loaded)
        stats.covs_deleted = len(plan.to_delete)
        self.graph.set_head(target)
        stats.kernel_fallbacks = delta_mod.kernel_fallbacks() - fb0
        stats.wall_s = time.perf_counter() - t0
        return new_records, stats

    def materialize_state(self, tracked_ns, target: str
                          ) -> Tuple[Dict[str, LeafRecord], CheckoutStats]:
        """Full (non-incremental) load of a state into an empty namespace —
        the crash-recovery / elastic-resume path."""
        stats = CheckoutStats()
        t0 = time.perf_counter()
        from repro_torch.core.graph import parse_key
        index = self.graph.nodes[target].state_index
        items = [(parse_key(ks), version)
                 for ks, version in sorted(index.items())]
        loaded = self.load_covs(items, stats)
        versions = dict(items)
        new_records: Dict[str, LeafRecord] = {}
        with tracked_ns.pause():
            for key, values in loaded.items():
                manifest = self.graph.manifest_of(key, versions[key])
                for name, val in values.items():
                    tracked_ns.base[name] = val
                if manifest is not None and not manifest.get("unserializable"):
                    new_records.update(records_from_manifest(manifest, values))
                else:
                    from repro_torch.core.covariable import RecordBuilder
                    rb = RecordBuilder()
                    cache: Dict[int, Any] = {}
                    for name, val in values.items():
                        new_records[name] = rb.build(name, val, cache)
        stats.covs_loaded = len(index)
        self.graph.set_head(target)
        stats.wall_s = time.perf_counter() - t0
        return new_records, stats
