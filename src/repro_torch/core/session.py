"""KishuSession — the public time-traveling API (§3), over torch tensors.

    session = KishuSession(store)             # device="cuda" by default
    session.register("train", train_command)
    session.init_state({...})                 # attach
    session.run("train", steps=10)            # cell execution + incr. ckpt
    session.log()                             # inspect the Checkpoint Graph
    session.checkout("c00003")                # incremental checkout (undo /
                                              #  branch switch)

Each ``run`` executes a registered command against the tracked namespace,
detects the co-variable-granularity state delta (Lemma-1-pruned), writes an
incremental checkpoint, and appends a commit to the Checkpoint Graph.
``checkout`` restores any past state by loading only diverged co-variables,
with recursive fallback recomputation for missing data.

The session runs on a CUDA card unless the caller passes ``device="cpu"``;
with no card and no such request it raises — it never moves to the CPU on
its own.  Tensors restored by a full load land on the session's device.
On a card, a cell's ``exec_s`` ends after the device has finished the
cell's work, so the checkout planner prices a replay by the cell's device
time as well as its host time.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.core import delta as delta_mod
from repro_torch.core import hashing
from repro_torch.core.checkpoint import CheckpointWriter, WriteStats
from repro_torch.core.checkout import CheckoutStats, StateLoader
from repro_torch.core.chunkstore import ChunkCache, ChunkStore, NamespacedStore
from repro_torch.core.covariable import (CovKey, RecordBuilder, StateDelta,
                                   detect_delta, group_covariables)
from repro_torch.core.graph import (CheckpointGraph, key_str,
                              manifest_chunk_entries)
from repro_torch.core.lease import Lease
from repro_torch.core.namespace import Namespace, TrackedNamespace
from repro_torch.core.restore import DataRestorer
from repro_torch.core.serialize import gathered_images, global_image
from repro_torch.core.txn import TxnEngine, global_live_chunks
from repro_torch.core.txn import purge_tombstones as txn_purge_tombstones
from repro_torch.obs import TRACE_META_PREFIX, SessionObs


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The port's device: ``cuda`` unless the caller names another.  No
    card and no explicit ``"cpu"`` is an error, never a silent move."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class QuotaExceededError(RuntimeError):
    """A commit would push the tenant's referenced bytes past its quota.
    The cell has already executed (the namespace is mutated) but nothing
    was committed; chunks staged for the rejected commit surface as
    dangling and are reclaimed by the next ``gc()``."""


@dataclass
class RunStats:
    commit_id: str = ""
    exec_s: float = 0.0
    detect_s: float = 0.0
    write_s: float = 0.0
    total_s: float = 0.0
    covs_updated: int = 0
    covs_deleted: int = 0
    covs_checked: int = 0
    covs_skipped: int = 0
    write: WriteStats = field(default_factory=WriteStats)


@dataclass
class _RunPlan:
    """Output of the *plan* stage of a run: the executed cell's detected
    delta plus everything the *execute* (commit) stage needs."""
    name: str
    args: dict
    delta: StateDelta
    deps: Dict[CovKey, str]
    stats: RunStats
    t_all: float
    fb0: int = 0                     # kernel-fallback counter at plan start


class KishuSession:
    def __init__(self, store: ChunkStore, *,
                 chunk_bytes: int = hashing.DEFAULT_CHUNK_BYTES,
                 async_write: bool = False,
                 write_deadline_s: float = 0.0,
                 check_all: bool = False,
                 hasher=None,
                 io_threads: Optional[int] = None,
                 cache_bytes: Optional[int] = None,
                 group_commit_n: int = 1,
                 async_publish: bool = False,
                 tenant: Optional[str] = None,
                 quota_bytes: Optional[int] = None,
                 lease_ttl_s: Optional[float] = None,
                 lease_wait_s: float = 0.0,
                 lease_steal: bool = False,
                 chunk_cache: Optional[ChunkCache] = None,
                 trace: Optional[bool] = None,
                 plan_mode: Optional[str] = None,
                 device: Union[str, torch.device, None] = None,
                 group=None):
        # multi-session knobs (DESIGN.md §14):
        #   tenant       — scope this session to `tenant/<id>/` metadata on
        #                  the shared store (chunks stay shared/deduped)
        #   quota_bytes  — refuse commits once the tenant's referenced
        #                  bytes pass this (QuotaExceededError)
        #   lease_ttl_s  — acquire the namespace's writer lease before
        #                  opening the graph; None (default) runs
        #                  lease-less with only the HEAD-seq guard, which
        #                  keeps single-writer usage zero-cost
        #   chunk_cache  — share one cache across sessions (kishud)
        #   trace        — pipeline span tracing (DESIGN.md §16); None
        #                  defers to $KISHU_TRACE, default off
        #   plan_mode    — cost-based checkout planner (DESIGN.md §18):
        #                  off/auto/fetch/replay; None defers to
        #                  $KISHU_PLANNER, default off
        #   device       — where device-array leaves live and restore:
        #                  "cuda" (default) or an explicit "cpu"
        #   group        — a torch.distributed process group whose ranks
        #                  each run this session over one store (SPMD,
        #                  DTensor leaves): rank 0 writes and publishes,
        #                  the others follow (detect alike, write nothing,
        #                  reload the graph); every rank checks out its
        #                  own shards.  None: one process.
        from repro_torch.obs.instrument import InstrumentedStore

        self.device = resolve_device(device)
        self.group = group
        self.follower = group is not None and dist.get_rank(group) != 0
        # a follower waits for rank 0 to open (recover, root) the graph
        head = self._from_writer() if self.follower else None

        if tenant is not None and not isinstance(store, NamespacedStore):
            store = NamespacedStore(store, tenant)
        self.tenant = getattr(store, "tenant_id", None)
        # observability plane (DESIGN.md §16): per-session tracer + metrics.
        # The InstrumentedStore sits INSIDE the namespace view — the txn
        # engine's isinstance(NamespacedStore) unwrapping and meta-prefix
        # handling must keep seeing the view as the outermost layer.
        self.obs = SessionObs(trace=trace, tenant=self.tenant)
        if isinstance(store, NamespacedStore):
            inner = store.root_store
            if not isinstance(inner, InstrumentedStore):
                store = NamespacedStore(
                    InstrumentedStore(inner, self.obs.registry),
                    store.tenant_id)
        elif not isinstance(store, InstrumentedStore):
            store = InstrumentedStore(store, self.obs.registry)
        self.store = store
        self.quota_bytes = quota_bytes
        # the lease is taken BEFORE recovery/graph construction: rolling
        # back a journal requires proving its writer is gone, and holding
        # the namespace's writer lease is exactly that proof
        self.lease: Optional[Lease] = None
        if lease_ttl_s is not None and not self.follower:
            self.lease = Lease(store, ttl_s=lease_ttl_s, obs=self.obs
                               ).acquire(wait_s=lease_wait_s,
                                         steal=lease_steal)
        self.ns = Namespace()
        self.tracked = TrackedNamespace(self.ns)
        self.builder = RecordBuilder(chunk_bytes, hasher=hasher)
        # one chunk cache shared by writer and loader: checking out a
        # just-committed state is served from memory, not the backend
        # (cache_bytes=0 disables; default $KISHU_CACHE_BYTES or 64 MiB)
        # (an empty cache is falsy: test for None, or a shared cache that
        # holds nothing yet would be replaced by a private one)
        self.chunk_cache = chunk_cache if chunk_cache is not None \
            else ChunkCache(cache_bytes)
        self.writer = CheckpointWriter(store, chunk_bytes=chunk_bytes,
                                       async_write=async_write,
                                       write_deadline_s=write_deadline_s,
                                       cache=self.chunk_cache)
        # transactional commit engine (DESIGN.md §13): every commit is a
        # journaled transaction — WAL, chunk puts, epoch fence, atomic
        # multi-meta publish, seal.  group_commit_n > 1 batches consecutive
        # cells' metadata into one publish (crash loses at most the last
        # n-1 cells, never tears state); async_publish hides the publish
        # behind the next cell's think time.
        # a write deadline bounds the publish fence too: the straggler
        # feature's contract is that a slow host delays durability, not
        # the cell loop — a commit published past the deadline references
        # still-pending chunks, and checkout of those falls back to
        # recomputation exactly as before the engine existed
        fence_timeout = write_deadline_s or None
        self.engine = TxnEngine(store, group_n=group_commit_n,
                                async_publish=async_publish,
                                fence=(lambda token: self.writer.wait_epoch(
                                    token, timeout=fence_timeout)),
                                fence_token=self.writer.epoch,
                                # sync writer journals a commit's chunks
                                # before commit() returns, so groups can
                                # detach at kick time; the async drain
                                # journals with a lag the fence bounds
                                early_snapshot=not async_write)
        self.engine.lease = self.lease    # checked/renewed on every publish
        self.writer.journal = self.engine.journal_chunks
        # worker threads (async drain, publish worker) don't inherit the
        # activation contextvar — they report through these handles instead
        self.writer.obs = self.obs
        self.engine.obs = self.obs
        # graph open runs txn.recover first: a crashed predecessor's
        # unsealed transactions are replayed or rolled back before loading
        # (activated so recovery counters attribute to this session)
        with self.obs.activate():
            self.graph = CheckpointGraph(store, engine=self.engine,
                                         recover=not self.follower,
                                         read_only=self.follower)
        self.registry: Dict[str, Callable] = {}
        self._replay_unsafe: set = set()   # register(replay_safe=False)
        self.records: Dict[str, Any] = {}
        self.covs: Dict[CovKey, List[str]] = {}
        self.check_all = check_all      # AblatedKishu(Check all) mode (§7.6)
        self.last_run: Optional[RunStats] = None
        self.last_checkout: Optional[CheckoutStats] = None

        self.loader = StateLoader(self.graph, store, io_threads=io_threads,
                                  cache=self.chunk_cache, device=self.device)
        self.loader.obs = self.obs
        self.restorer = DataRestorer(self.graph, self.loader, self.registry)
        self.loader.fallback = self.restorer.recompute
        # cost-based checkout planner (DESIGN.md §18): prices fetch vs
        # replay vs patch per co-variable from the obs registry's store
        # metrics + persisted exec_s; off keeps the fixed fallback ladder
        from repro_torch.core.planner import (CheckoutPlanner,
                                              resolve_plan_mode)
        self.plan_mode = resolve_plan_mode(plan_mode)
        self.planner = CheckoutPlanner(
            self.graph, self.loader, commands=self.registry,
            unsafe=self._replay_unsafe, mode=self.plan_mode,
            cache=self.chunk_cache, obs=self.obs,
            max_depth=self.restorer.max_depth)
        if self.planner.engaged:
            self.loader.planner = self.planner
        # live cache gauges: this session's view of its (possibly shared)
        # chunk cache — kishud disambiguates by tenant const-label
        reg = self.obs.registry
        reg.gauge("kishu_cache_hits_total", fn=lambda: self.chunk_cache.hits)
        reg.gauge("kishu_cache_misses_total",
                  fn=lambda: self.chunk_cache.misses)
        reg.gauge("kishu_cache_bytes", fn=lambda: self.chunk_cache.bytes_used)

        if self.follower:
            self._follow(head)
        elif not self.graph.nodes:
            self.graph.init_root()
        if group is not None and not self.follower:
            self._from_writer(self.graph.head)

    # ------------------------------------------------------------------
    # attachment & commands
    # ------------------------------------------------------------------
    def register(self, name: str, fn: Callable, *,
                 replay_safe: bool = True) -> None:
        """Register a cell command.  ``replay_safe=False`` marks commands
        the planner must never choose to re-run (external side effects,
        non-deterministic inputs outside the namespace); the flag is
        persisted per commit so it survives into other sessions' plans."""
        self.registry[name] = fn
        if replay_safe:
            self._replay_unsafe.discard(name)
        else:
            self._replay_unsafe.add(name)

    def init_state(self, tree: Dict[str, Any], message: str = "attach") -> str:
        """Attach: populate the namespace and commit the initial state."""
        def _init(ns, **_):
            for prefix, sub in tree.items():
                if isinstance(sub, dict):
                    ns.set_tree(prefix, sub)
                else:
                    ns[prefix] = sub
        self.register("__attach__", _init)
        return self.run("__attach__", _message=message)

    @property
    def head(self) -> str:
        return self.graph.head

    # ------------------------------------------------------------------
    # cell execution + incremental checkpoint
    # ------------------------------------------------------------------
    def run(self, command: str, _message: str = "", **args) -> str:
        """Cell execution + incremental checkpoint, split into a *plan*
        stage (execute the cell, detect the state delta) and an *execute*
        stage (write chunks, commit through the transaction engine).  With
        ``async_publish`` the previous commit's metadata publish overlaps
        this cell's plan stage — the engine fences chunk durability on its
        own thread, so the cell loop never waits on the store's metadata
        round-trips."""
        with self.obs.activate(), self.obs.span("commit", command=command), \
                gathered_images():
            plan = self._plan_run(command, args)
            if self.group is None:
                return self._execute_commit(plan, _message)
            # rank 0 publishes the commit and then sends its id; the
            # followers, waiting on it, read the commit back from the store
            if not self.follower:
                cid = self._execute_commit(plan, _message)
                self.engine.flush()
                return self._from_writer(cid)
            self._follow(self._from_writer())
            cid = self.graph.head
            plan.stats.commit_id = cid
            self.last_run = plan.stats
            return cid

    def _plan_run(self, name: str, args: dict) -> "_RunPlan":
        """Stage 1: run the cell against the tracked namespace and detect
        the co-variable-granularity delta (Lemma-1-pruned).  Touches no
        storage — everything durable happens in :meth:`_execute_commit`."""
        fn = self.registry[name]
        stats = RunStats()
        t_all = time.perf_counter()
        fb0 = delta_mod.kernel_fallbacks()

        self.tracked.reset()
        t0 = time.perf_counter()
        with self.obs.span("exec"):
            fn(self.tracked, **args)
            # a cell returns with its kernels still in flight: on a card the
            # span (and exec_s, the planner's replay price) ends when the
            # device has finished them
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        stats.exec_s = time.perf_counter() - t0

        accessed = (set(self.tracked.accessed) | set(self.tracked.written)
                    | set(self.tracked.deleted))
        if self.check_all:
            accessed = set(self.records) | set(self.ns.names())
        # DTensor leaves: remember their layouts for checkout, and gather
        # each global image now, in name order (the same on every rank),
        # so detection and the write read them without a collective
        self._note_layouts(accessed)
        for leaf in sorted(accessed):
            if leaf in self.ns and isinstance(self.ns[leaf], DTensor):
                global_image(self.ns[leaf])

        t0 = time.perf_counter()
        with self.obs.span("detect"):
            delta, self.records = detect_delta(self.records, self.covs,
                                               self.ns, accessed,
                                               self.builder)
            self.covs = group_covariables(self.records)
        stats.detect_s = time.perf_counter() - t0

        # dependencies: co-variables the cell *read* (or deleted — replay
        # must be able to `del` them), at their pre-execution versions.
        # Purely-overwritten co-variables are excluded: their pre-image is
        # dead weight a replay would otherwise have to restore first, which
        # is what makes recompute priceable against fetch (DESIGN.md §18).
        dep_names = set(self.tracked.read) | set(self.tracked.deleted)
        if self.check_all:
            dep_names |= accessed
        prev_index = self.graph.nodes[self.graph.head].state_index
        deps = {}
        for key in delta.candidates:
            ver = prev_index.get(key_str(key))
            if ver is not None and any(n in dep_names for n in key):
                deps[key] = ver
        return _RunPlan(name=name, args=args, delta=delta, deps=deps,
                        stats=stats, t_all=t_all, fb0=fb0)

    def _execute_commit(self, plan: "_RunPlan", message: str = "") -> str:
        """Stage 2: serialize the delta's dirty ranges into journaled chunk
        puts and append the commit to the Checkpoint Graph through the
        transaction engine (WAL ⟶ chunk puts ⟶ fence ⟶ atomic publish ⟶
        seal)."""
        delta, stats = plan.delta, plan.stats
        t0 = time.perf_counter()
        manifests, wstats = self.writer.write_delta(
            delta, self.ns, self._prev_manifest, packs=self.builder.packs)
        stats.write_s = time.perf_counter() - t0
        # degradations anywhere in this run — detection (plan) or write
        wstats.kernel_fallbacks = delta_mod.kernel_fallbacks() - plan.fb0
        stats.write = wstats

        if self.quota_bytes is not None:
            self._check_quota(manifests)
        node = self.graph.commit(
            command={"name": plan.name, "args": plan.args},
            manifests=manifests,
            deleted_keys=delta.deleted,
            accessed=plan.deps,
            updated_keys=list(delta.updated),
            message=message,
            stats={"bytes_written": wstats.bytes_written,
                   "bytes_serialized": wstats.bytes_serialized,
                   "bytes_logical": wstats.bytes_logical,
                   "chunks_written": wstats.chunks_written,
                   "chunks_reused": wstats.chunks_reused,
                   "chunks_encoded": wstats.chunks_encoded,
                   "chunks_codec_skipped": wstats.chunks_codec_skipped,
                   "bytes_dev2host": wstats.bytes_dev2host,
                   "exec_s": stats.exec_s,
                   "replay_safe": plan.name not in self._replay_unsafe})
        stats.commit_id = node.commit_id
        stats.covs_updated = len(delta.updated)
        stats.covs_deleted = len(delta.deleted)
        stats.covs_checked = delta.checked
        stats.covs_skipped = delta.skipped
        stats.total_s = time.perf_counter() - plan.t_all
        self.last_run = stats
        return node.commit_id

    def _from_writer(self, cid: Optional[str] = None) -> str:
        """Rank 0 sends ``cid`` (a commit it has published) to every rank
        of the group; a follower blocks until it arrives, so what it then
        reads from the store includes that publish."""
        box = [cid]
        dist.broadcast_object_list(box, src=dist.get_global_rank(
            self.group, 0), group=self.group)
        return box[0]

    def _follow(self, cid: str) -> None:
        """A follower's graph at rank 0's ``cid``: the published commits
        re-read, HEAD set to ``cid`` in memory (the store's HEAD may
        already name rank 0's next checkout)."""
        self.graph.reload()
        if cid not in self.graph.nodes:
            raise RuntimeError(f"rank 0's commit {cid} is not in the store")
        self.graph.head = cid

    def _note_layouts(self, names) -> None:
        """Record the (mesh, placements) of every DTensor among ``names``;
        a name rebound to anything else loses its layout."""
        for name in names:
            if name not in self.ns:
                continue
            x = self.ns[name]
            if isinstance(x, DTensor):
                self.loader.layouts[name] = (x.device_mesh,
                                             tuple(x.placements))
            else:
                self.loader.layouts.pop(name, None)

    def _check_quota(self, manifests: Dict[str, dict]) -> None:
        """Enforce the tenant byte quota *before* the commit publishes:
        current referenced bytes (from the refcount ledger) plus the bytes
        this commit would newly reference.  Chunks already counted by this
        namespace add nothing — quota follows references, like the ledger."""
        new_bytes = 0
        seen = set()
        for key, nbytes in manifest_chunk_entries(manifests):
            if key in seen or key in self.graph.refs.counts:
                continue
            seen.add(key)
            new_bytes += nbytes
        used = self.graph.refs.bytes_live()
        if used + new_bytes > self.quota_bytes:
            raise QuotaExceededError(
                f"tenant {self.tenant or '<root>'}: commit would reference "
                f"{used + new_bytes} bytes > quota {self.quota_bytes} "
                f"(currently {used}); delete branches and gc(), or raise "
                f"the quota")

    def _prev_manifest(self, key: CovKey) -> Optional[dict]:
        ver = self.graph.nodes[self.graph.head].state_index.get(key_str(key))
        if ver is None:
            return None
        return self.graph.manifest_of(key, ver)

    # ------------------------------------------------------------------
    # incremental checkout
    # ------------------------------------------------------------------
    def checkout(self, commit_id: str) -> CheckoutStats:
        with self.obs.activate(), self.obs.span("checkout",
                                                commit=commit_id):
            self.writer.flush()
            self.engine.flush()  # pending publishes land before time travel
            self.restorer.clear_memo()
            self._note_layouts(self.ns.names())
            try:
                self.records, stats = self.loader.checkout(
                    self.tracked, self.records, commit_id)
            finally:
                # replayed namespaces may hold device memory: let them go
                # once the checkout has taken what it needs
                self.restorer.clear_memo()
            self.covs = group_covariables(self.records)
        self.last_checkout = stats
        return stats

    def plan(self, commit_id: str):
        """Price a checkout of ``commit_id`` without executing it: the
        :class:`~repro_torch.core.planner.PricedPlan` behind ``kishu plan``.
        Pending commits are flushed first so the plan sees the same graph
        a checkout would."""
        with self.obs.activate(), self.obs.span("plan", commit=commit_id):
            self.writer.flush()
            self.engine.flush()
            return self.planner.price_checkout(
                self.graph.head, commit_id, records=self.records, ns=self.ns)

    # ------------------------------------------------------------------
    # introspection & maintenance
    # ------------------------------------------------------------------
    def log(self, limit: int = 0) -> List[dict]:
        return self.graph.log(limit)

    def diff(self, a: str, b: str) -> dict:
        """Human-oriented state diff between two commits: which co-variables
        diverged / exist only on one side (Def 6 over the graph index)."""
        plan = self.graph.diff(a, b)
        return {"diverged": sorted("+".join(k) for k in plan.to_load),
                "only_in_a": sorted("+".join(k) for k in plan.to_delete),
                "identical": len(plan.identical)}

    def delete_branch(self, tip: str) -> List[str]:
        """Delete the commits exclusive to ``tip``'s branch (up to but not
        including the first ancestor with another child or the HEAD path).
        Returns deleted commit ids. Run ``gc()`` afterwards to reclaim
        chunks."""
        self._writer_only("delete_branch")
        assert tip != self.graph.head, "cannot delete the current branch"
        self.engine.flush()     # a queued publish must not resurrect a
                                # commit tombstoned below
        doomed = []
        node = self.graph.nodes[tip]
        while node.parent is not None:
            siblings = self.graph.children.get(node.parent, [])
            doomed.append(node.commit_id)
            if len(siblings) > 1 or node.parent == self.graph.head:
                break
            node = self.graph.nodes[node.parent]
        head_path = set(self.graph.path_from_root(self.graph.head))
        doomed = [c for c in doomed if c not in head_path]
        if not doomed:
            return doomed
        for cid in doomed:
            self.graph.forget(cid)      # updates in-memory refcounts too
        # tombstones + the decremented refcount ledger land in ONE batch:
        # a crash between them could otherwise leave counts claiming
        # chunks that no commit references (or vice versa)
        from repro_torch.core.graph import REFS_DOC
        batch = {f"commit/{cid}": {"deleted": True} for cid in doomed}
        batch[REFS_DOC] = self.graph.refs.to_doc()
        self.store.put_meta_batch(batch)
        return doomed

    def gc(self) -> dict:
        """Content-addressed garbage collection: drop chunks referenced by
        no live manifest (after branch deletion / history truncation), and
        purge ``delete_branch`` tombstone metadata docs — without the purge
        every subsequent ``_load`` re-reads dead ``{"deleted": True}``
        markers forever.  Enumerates through ``list_chunk_keys()`` and
        deletes through the batched ``delete_chunks()`` — so every backend
        (single-file SQLite, sharded/replicated fabrics) reclaims space,
        and a fabric sweeps all its shards and replicas, strays included."""
        self._writer_only("gc")
        self.writer.flush()
        self.engine.flush()     # unpublished manifests must be visible to
                                # fsck/other readers before their chunks
                                # are judged live
        # the mark set is CROSS-SESSION: this graph's references plus every
        # other namespace's published refcounts plus any sibling's unsealed
        # journal — chunks are shared, so gc may only reap what NO session
        # can reach (the refcounted-GC invariant)
        live = self.graph.live_chunk_keys() | global_live_chunks(self.store)
        dead = [k for k in self.store.list_chunk_keys() if k not in live]
        freed = sum(self.store.chunk_sizes(dead).values())
        self.store.delete_chunks(dead)
        purged = txn_purge_tombstones(self.store, self.graph.nodes)
        return {"chunks_dropped": len(dead), "bytes_freed": freed,
                "chunks_live": len(live), "tombstones_purged": purged}

    def storage_stats(self) -> dict:
        out = {"chunk_bytes": self.store.chunk_bytes_total(),
               "n_chunks": self.store.n_chunks(),
               "graph_meta_bytes": self.graph.total_meta_bytes(),
               "n_commits": len(self.graph.nodes),
               "txn_publishes": self.engine.stats.publishes,
               "txn_journal_puts": self.engine.stats.journal_puts,
               "tenant": self.tenant,
               "tenant_ref_bytes": self.graph.refs.bytes_live(),
               "quota_bytes": self.quota_bytes}
        if self.lease is not None:
            out["lease_owner"] = self.lease.owner
            out["lease_token"] = self.lease.token
        return out

    def metrics_text(self) -> str:
        """This session's metrics as Prometheus text exposition."""
        from repro_torch.obs import render
        return render([self.obs.registry])

    def _writer_only(self, what: str) -> None:
        if self.follower:
            raise RuntimeError(f"{what} runs on rank 0 of a distributed "
                               f"session only")

    def _persist_obs(self) -> None:
        """Best-effort span/metric snapshot under ``obs/trace/<sid>`` —
        only when tracing was opted into: the default path must add zero
        store writes (crash-injection op sweeps count every one)."""
        if self.follower or not self.obs.tracer.enabled \
                or not self.obs.tracer.spans:
            return
        try:
            self.store.put_meta(TRACE_META_PREFIX + self.obs.sid,
                                self.obs.to_doc())
        except Exception:  # noqa: BLE001 — a dying store must not block close
            pass

    def close(self) -> None:
        try:
            self.writer.flush()
            self.engine.flush()
            self._persist_obs()
        finally:
            # a flush error (poisoned engine, deferred publish failure)
            # must still join the worker threads; the unsealed journal is
            # the next open's recovery problem, not a thread leak
            self.engine.close()
            self.writer.close()
            if self.lease is not None:
                self.lease.release()
