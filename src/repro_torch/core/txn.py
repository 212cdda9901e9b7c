"""Transactional commit engine — journaled, group-committed, crash-recoverable
checkpoint publication (DESIGN.md §13).

The paper's checkpoint mechanism must be *fault-tolerant*, not just
efficient: before this engine, a commit was two independent ``put_meta``
calls (commit doc, then HEAD), and with the async chunk writer HEAD could
advance to a commit whose chunks were still queued — a crash left dangling
manifests or a torn graph.  Every commit now runs as a journaled
transaction:

    WAL record  ⟶  chunk puts  ⟶  fence  ⟶  atomic multi-meta publish  ⟶  seal

  * **WAL record** — the journal lives under ``txn/`` metadata (atomic
    per-doc replace on every backend, mirrored across a fabric).  The
    chunk writer journals each batch's keys *before* the backend put, as
    a per-batch *part* document (``txn/<id>.pNNNN``) so journal traffic
    stays O(chunks) and rollback knows exactly which chunks a dead
    transaction had landed.  The open state exists on disk purely as
    parts — no parts and no base record means nothing happened — and the
    base record itself rides the publish batch, keeping the default sync
    path at one journal write per chunk batch plus the publish.
  * **Fence** — an epoch counter on the ``CheckpointWriter``
    (enqueued vs completed chunks) proves every chunk the group references
    is durable before any metadata names it; with ``async_publish`` the
    wait leaves the cell loop entirely, and a ``write_deadline_s`` bounds
    it (the straggler feature: a publish past the deadline references
    still-pending chunks, and checkout of those falls back to
    recomputation).  A *failed* fence (a chunk that never landed) aborts
    the group — its journal and chunks are rolled back and the engine
    poisons itself so no later commit can publish on top of the missing
    state; a failed *publish* poisons likewise, leaving its journal for
    recovery.
  * **Atomic publish** — the journal base record (status ``publish``,
    carrying the full docs), the commit docs, and HEAD go through one
    ``ChunkStore.put_meta_batch`` (one SQLite transaction, staged renames
    on a directory store, one scatter per fabric child), ordered base →
    docs → HEAD: even a torn non-atomic publish cannot leave HEAD naming
    an absent commit, and the base lands before anything it publishes so
    recovery can always finish the job.
  * **Seal** — deleting the journal docs marks the transaction complete.

**Group commit** batches the metadata of up to ``group_n`` consecutive
cells into one WAL + one publish + one seal — amortizing per-publish
round-trips/fsyncs (large on fabrics, where metadata mirrors to every
shard) at the cost of classic group-commit semantics: a crash can lose up
to ``group_n - 1`` of the most recent cells, never tear state.  With
``async_publish`` the publish pipeline runs on a background thread, hiding
publish latency behind the next cell's think time.

**Recovery** (:func:`recover`) runs on every session/graph open and behind
the CLI verb ``kishu recover``: a journal still in ``open`` state rolls
*back* (its journaled chunks are deleted; the graph never referenced them),
one in ``publish`` state rolls *forward* (the fence already proved its
chunks durable, and the WAL carries the full docs — the publish is simply
re-applied, idempotently).  Either way the store lands in a state
:func:`fsck` certifies: no torn HEAD, no missing parents or chunks, no
unsealed journals, no dangling chunks.  One scoping note: with
``async_write`` on, a kill can strand chunks whose journal sealed with an
earlier group (keys the drain thread journaled between that group's fence
and its post-fence snapshot); they can only ever surface as fsck-visible
*dangling* chunks that ``gc`` reclaims — never as referenced-but-missing
state, because rollback filters its deletes against every published
reference.  Sync-writer groups detach at kick time instead, which closes
the window entirely.
"""
from __future__ import annotations

import os
import threading
import time
import uuid
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

from repro_torch.core.chunkstore import ChunkStore, namespace_views
from repro_torch.core.graph import REFS_DOC, manifest_chunk_keys
from repro_torch.core.lease import Lease, LeaseError

TXN_PREFIX = "txn/"
PART_SEP = ".p"               # txn/<id>.pNNNN — per-batch chunk-key parts
STATUS_OPEN = "open"          # chunks may have landed; nothing references them
STATUS_PUBLISH = "publish"    # fence passed, docs in WAL: roll forward


class TxnError(RuntimeError):
    """A publish failed (or the engine is poisoned by a failed chunk
    fence); surfaced on the commit/flush that observes it."""


class StaleHeadError(TxnError):
    """A publish would move HEAD *backwards*: the durable HEAD's ``seq`` is
    already at or past the one being published, meaning another writer (or
    an older resurrected session) has advanced the branch since this
    session loaded it.  Publishing anyway would orphan the newer commits —
    the `graph.py` read-modify-write race this guard turns into a hard
    fail.  Leases make the race unreachable in normal operation; the guard
    stays as defense in depth for lease-less sessions."""


def check_publish_guard(store: ChunkStore, docs: Dict[str, dict], *,
                        lease: Optional[Lease] = None) -> None:
    """The two pre-publish safety checks, shared by the engine and by
    direct metadata publishes (``graph.set_head``): the writer still holds
    its lease (:class:`~repro_torch.core.lease.LeaseLost` if not), and the HEAD
    being published strictly advances the durable ``seq``
    (:class:`StaleHeadError` if not).  Reads only — never counted by
    crash-injection op sweeps."""
    if lease is not None:
        lease.ensure()
    head = docs.get("HEAD")
    if head is not None:
        cur = store.get_meta("HEAD")
        if cur is not None \
                and int(cur.get("seq", -1)) >= int(head.get("seq", -1)):
            raise StaleHeadError(
                f"durable HEAD seq {cur.get('seq')} >= publishing seq "
                f"{head.get('seq')}: another writer advanced this branch "
                f"(durable head={cur.get('head')!r}); reopen the session "
                f"to continue from the new state")


@dataclass
class TxnStats:
    txns: int = 0               # journal groups opened
    commits: int = 0            # commit docs routed through the engine
    publishes: int = 0          # multi-meta publish batches issued
    journal_puts: int = 0       # WAL writes (open / parts / amend)
    chunks_journaled: int = 0
    fence_wait_s: float = 0.0   # time publish spent proving chunk durability
    publish_s: float = 0.0      # amend + put_meta_batch + seal wall time


class TxnEngine:
    """Journaled, group-committed publisher for Checkpoint Graph metadata.

    ``fence(token)`` / ``fence_token()`` hook the chunk writer's epoch
    counter (``CheckpointWriter.wait_epoch`` / ``.epoch``): the token is
    captured when a publish starts and the fence blocks until every chunk
    enqueued at or before it is durable.  ``journal_chunks`` is installed
    as the writer's WAL hook, called immediately before each backend put
    batch.  Thread-safe: the async chunk writer journals from its drain
    thread while the async publisher publishes from its own.
    """

    def __init__(self, store: ChunkStore, *, group_n: int = 1,
                 async_publish: bool = False,
                 fence: Optional[Callable[[Optional[int]], None]] = None,
                 fence_token: Optional[Callable[[], int]] = None,
                 early_snapshot: bool = True):
        self.store = store
        self.group_n = max(1, int(group_n))
        self.async_publish = async_publish
        self.fence = fence
        self.fence_token = fence_token
        # early_snapshot: the group can be detached from new journal
        # joins at kick time, because every journaled chunk of a commit
        # is attributed before that commit() returns — true for the sync
        # chunk writer.  The async writer journals from its drain thread
        # with a lag, so there the snapshot must wait until after the
        # fence (see _publish_group).
        self.early_snapshot = early_snapshot
        #: optional writer lease checked (and kept renewed) on every
        #: publish; set by the owning session after acquisition
        self.lease: Optional[Lease] = None
        #: observability handle (set by the session) — used instead of the
        #: activation contextvar because async publishes run on a worker
        #: thread that never sees the session's activation
        self.obs = None
        #: per-engine nonce for journal IDs — two engines in one process
        #: share a pid and both start their counters at zero, so pid +
        #: counter alone collide when they open within the same ms
        self._nonce = uuid.uuid4().hex[:6]
        self.stats = TxnStats()
        self._lock = threading.RLock()     # open-group state
        self._pub_lock = threading.Lock()  # publishes are serialized
        self._open: Optional[dict] = None
        self._open_name: Optional[str] = None
        self._parts = 0                    # part docs written for open group
        self._n = 0
        self._errors: List[Exception] = []
        self._poisoned: Optional[Exception] = None
        self._worker: Optional[threading.Thread] = None
        self._wake = threading.Condition()
        self._pending: List[Optional[tuple]] = []   # queued group snapshots
        self._busy = False                 # worker holds a popped group
        self._closing = False
        if async_publish:
            self._worker = threading.Thread(target=self._publish_loop,
                                            daemon=True)
            self._worker.start()

    # ------------------------------------------------------------------
    # observability (no-ops until the session attaches a handle)
    # ------------------------------------------------------------------
    def _span(self, name: str, **args):
        return self.obs.span(name, **args) if self.obs is not None \
            else nullcontext()

    def _count(self, name: str, **labels) -> None:
        if self.obs is not None:
            self.obs.registry.counter(name, **labels).inc()

    def _observe(self, name: str, v: float) -> None:
        if self.obs is not None:
            self.obs.registry.histogram(name).observe(v)

    # ------------------------------------------------------------------
    # journal (WAL)
    # ------------------------------------------------------------------
    def _ensure_open(self) -> None:
        if self._open is None:
            # unique across sessions sharing a store: time + pid + a random
            # per-engine nonce + counter — pid alone is not enough (kishud
            # runs many engines in one process) and the ms timestamp alone
            # is not either (two sessions commit in the same millisecond)
            tid = (f"{int(time.time() * 1000):013d}"
                   f"-{os.getpid()}-{self._nonce}-{self._n:04d}")
            self._n += 1
            self._open_name = TXN_PREFIX + tid
            # nothing is written to the store yet: the open state exists
            # on disk purely as part docs (absence of any journal == clean
            # rollback by doing nothing), and the base record rides the
            # publish batch — keeping the happy path at one journal write
            # per chunk batch plus one per publish
            self._open = {"txn_id": tid, "status": STATUS_OPEN,
                          "chunks": [], "docs": {}, "n_commits": 0,
                          "ts": time.time()}
            self._parts = 0
            self.stats.txns += 1

    def journal_chunks(self, keys: List[str]) -> None:
        """WAL the chunk keys the writer is about to land (called before
        every backend put batch) — rollback's exact delete set.  Each batch
        is one *part* doc, so journal traffic is O(chunks), not O(chunks²).
        """
        keys = list(keys)
        if not keys:
            return
        with self._lock:
            self._ensure_open()
            part = f"{self._open_name}{PART_SEP}{self._parts:04d}"
            self._parts += 1
            self._open["chunks"].extend(keys)      # in-memory, abort path
            self.stats.chunks_journaled += len(keys)
            self.store.put_meta(part, {"txn_id": self._open["txn_id"],
                                       "chunks": keys})
            self.stats.journal_puts += 1

    # ------------------------------------------------------------------
    # commit / publish
    # ------------------------------------------------------------------
    def commit(self, docs: Dict[str, dict]) -> None:
        """Queue metadata documents for publication.  Iteration order is
        preserved as publish order, except ``HEAD`` which is always moved
        (and, across a group, re-moved) to the end.  Docs are queued
        *before* any deferred background error is raised, so a surfaced
        error never silently drops the commit that observed it."""
        if self._poisoned is not None:
            raise TxnError("commit engine poisoned by a failed chunk "
                           "fence; restart the session (recovery will "
                           "restore the last sealed state)") \
                from self._poisoned
        with self._lock:
            self._ensure_open()
            group = self._open["docs"]
            for name, doc in docs.items():
                if name in group:          # reposition: latest write wins,
                    del group[name]        # and HEAD must stay last
                group[name] = doc
            if "HEAD" in group:
                group["HEAD"] = group.pop("HEAD")
            self._open["n_commits"] += 1
            self.stats.commits += 1
            full = self._open["n_commits"] >= self.group_n
        if full:
            self._kick()
        self._raise_deferred()

    def _kick(self) -> None:
        # With early_snapshot the group detaches HERE, on the commit
        # thread: later journal_chunks calls open a fresh group, so a
        # concurrently publishing group can never seal away another
        # cell's journal parts.
        snap = self._pop_open() if self.early_snapshot else None
        if self.async_publish:
            with self._wake:
                self._pending.append(snap)
                self._wake.notify()
        else:
            self._publish_group(snap)

    def _publish_loop(self) -> None:
        while True:
            with self._wake:
                self._wake.wait_for(lambda: self._pending or self._closing)
                if not self._pending:
                    return            # closing, queue drained
                item = self._pending.pop(0)
                self._busy = True     # flush() must see pop+publish as one
            try:
                self._publish_group(item)
            except Exception as e:  # noqa: BLE001 — surfaced on flush
                self._errors.append(e)     # before _busy clears below, so
            finally:                       # a concurrent flush cannot miss
                with self._wake:           # the error
                    self._busy = False
                    self._wake.notify_all()

    def _pop_open(self):
        with self._lock:
            rec, name, parts = self._open, self._open_name, self._parts
            self._open = None
            self._open_name = None
            self._parts = 0
        return rec, name, parts

    def _seal(self, name: str, parts: int) -> None:
        # one batched round-trip; order is parts before base, so a crash
        # mid-seal (on a decomposing backend) leaves the base record and
        # recovery still sees — and finishes — the transaction
        self.store.delete_meta_batch(
            [f"{name}{PART_SEP}{i:04d}" for i in range(parts)] + [name])

    def _abort(self, snap, cause: Exception) -> None:
        """Fence or guard failure: the group must not publish.  Roll it
        back in-store (journal + journaled chunks) and poison the engine —
        the in-memory graph is ahead of durable state now, and publishing
        any descendant would tear the store.  The chunk delete is filtered
        against every published reference in every namespace: under
        content addressing a journaled key may coincide with a chunk some
        other commit (ours or another tenant's) already owns."""
        self._poisoned = cause
        rec, name, parts = snap
        if rec is None:
            return
        try:
            if rec["chunks"]:
                protected = published_chunks(self.store, use_refs=False)
                self.store.delete_chunks(
                    [k for k in rec["chunks"] if k not in protected])
            self._seal(name, parts)
        except Exception:  # noqa: BLE001 — backend down: recovery on next
            pass           # open rolls the journal back instead

    def _publish_group(self, snap: Optional[tuple]) -> None:
        """Fence, then publish one group.  ``snap`` is the group snapshot
        when it was detached at kick time (early_snapshot); ``None`` means
        detach here, *after* the fence — required for the async chunk
        writer, whose drain thread journals a commit's keys with a lag the
        fence bounds, so only a post-fence snapshot is guaranteed to hold
        them all.  (In that mode, keys for a *later* cell can be journaled
        between fence and snapshot; they seal away with this group and can
        only ever surface as fsck-visible dangling chunks — see the module
        docstring's scoping note.)"""
        with self._pub_lock:
            t0 = time.perf_counter()
            if self.fence is not None:
                with self._span("epoch_fence"):
                    try:
                        token = self.fence_token() if self.fence_token \
                            else None
                        self.fence(token)
                    except Exception as e:
                        self._abort(snap if snap is not None
                                    else self._pop_open(), e)
                        self._count("kishu_txn_aborts_total", kind="fence")
                        raise TxnError("chunk write failed; transaction "
                                       "rolled back") from e
            dt = time.perf_counter() - t0
            self.stats.fence_wait_s += dt
            self._observe("kishu_txn_fence_seconds", dt)
            rec, name, parts = snap if snap is not None else self._pop_open()
            if rec is None:
                return
            if not rec["docs"]:
                # chunks journaled but no commit ever referenced them
                # (flush mid-delta): roll the group back ourselves —
                # filtered like every rollback, since a journaled key may
                # coincide with published content
                if rec["chunks"]:
                    protected = published_chunks(self.store, use_refs=False)
                    self.store.delete_chunks(
                        [k for k in rec["chunks"] if k not in protected])
                self._seal(name, parts)
                return
            try:
                # writer still leased + HEAD strictly advances: both are
                # store reads, checked as late as possible before the batch
                check_publish_guard(self.store, rec["docs"],
                                    lease=self.lease)
            except (LeaseError, StaleHeadError) as e:
                self._abort((rec, name, parts), e)
                self._count("kishu_txn_aborts_total", kind="guard")
                raise TxnError("publish refused: another writer owns this "
                               "branch; transaction rolled back") from e
            t0 = time.perf_counter()
            with self._span("publish", commits=rec.get("n_commits", 0)):
                rec["status"] = STATUS_PUBLISH
                # the point of no return rides the atomic publish itself:
                # the base record (first) flips the journal to roll-forward,
                # then commit docs, then HEAD — one batch, one backend
                # round-trip; a kill inside a decomposed batch still
                # recovers, because the base lands before anything it
                # publishes
                batch = {name: {**rec, "chunks": []}}
                batch.update(rec["docs"])
                try:
                    self.store.put_meta_batch(batch)
                except Exception as e:
                    # the group's docs are gone from memory and may be
                    # partly on disk; recovery finishes (or reverts) the
                    # job from the journal — but a LATER commit must never
                    # publish a child of a commit this failure lost, so
                    # the engine poisons
                    self._poisoned = e
                    raise TxnError("publish failed; journal left for "
                                   "recovery") from e
                self.stats.journal_puts += 1
                self._seal(name, parts)
            self.stats.publishes += 1
            dt = time.perf_counter() - t0
            self.stats.publish_s += dt
            self._observe("kishu_txn_publish_seconds", dt)
            self._count("kishu_txn_publishes_total")

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def _raise_deferred(self) -> None:
        if self._errors:
            errs, self._errors = self._errors, []
            raise TxnError("background publish failed") from errs[0]
        if self._poisoned is not None:
            raise TxnError("commit engine poisoned by a failed chunk "
                           "fence") from self._poisoned

    def pending_commits(self) -> int:
        with self._lock:
            return self._open["n_commits"] if self._open else 0

    def flush(self) -> None:
        """Publish everything queued and surface any background error."""
        if self.async_publish:
            with self._wake:
                self._wake.wait_for(
                    lambda: not self._pending and not self._busy)
        self._publish_group(self._pop_open() if self.early_snapshot
                            else None)
        self._raise_deferred()

    def close(self) -> None:
        if self._worker is not None:
            with self._wake:
                self._closing = True
                self._wake.notify_all()
            self._worker.join(timeout=5)
            self._worker = None


# ---------------------------------------------------------------------------
# recovery
# ---------------------------------------------------------------------------

def _referenced_chunks(store: ChunkStore) -> set:
    """Chunk keys referenced by any non-tombstone commit doc on the store
    (raw-meta version of ``CheckpointGraph.live_chunk_keys`` — same
    ``manifest_chunk_keys`` walker, so they cannot disagree)."""
    refs = set()
    for name in store.list_meta("commit/"):
        doc = store.get_meta(name) or {}
        if doc.get("deleted") is True:
            continue
        refs.update(manifest_chunk_keys(doc.get("manifests", {})))
    return refs


# ---------------------------------------------------------------------------
# cross-namespace reference accounting
# ---------------------------------------------------------------------------
#
# Chunks are content-addressed and SHARED across tenant namespaces (that is
# the dedup win), so no delete may consult a single namespace's references:
# rollback, abort, gc, and fsck's dangling check all build their live set
# from every namespace reachable through the store.

def published_chunks(store: ChunkStore, *, use_refs: bool = True) -> Set[str]:
    """Chunks referenced by published (non-tombstone) commits in *every*
    namespace of ``store`` — the root graph plus each ``tenant/<id>/``.

    With ``use_refs`` a namespace that maintains the transactional refcount
    doc (graph.REFS_DOC, kept consistent by riding the atomic publish
    batch) is read in one meta get; namespaces without one fall back to
    walking their commit docs.  Safety-critical delete filters pass
    ``use_refs=False`` to always walk — the authoritative source."""
    refs: Set[str] = set()
    for _, view in namespace_views(store):
        doc = view.get_meta(REFS_DOC) if use_refs else None
        counts = (doc or {}).get("counts")
        if counts is not None:
            refs.update(k for k, cn in counts.items() if cn[0] > 0)
        else:
            refs.update(_referenced_chunks(view))
    return refs


def journaled_chunks(store: ChunkStore, *,
                     skip_own: bool = False) -> Set[str]:
    """Chunks named by unsealed txn journals (base records + part docs)
    across every namespace.  These landed in the store but are not yet
    referenced by any commit — a *sibling session mid-transaction* — so
    cross-session GC must treat them as live.  ``skip_own`` excludes the
    namespace ``store`` itself is scoped to (rollback of our own dead
    journals must still protect every *other* namespace's in-flight
    chunks, but not its own)."""
    own_prefix = getattr(store, "meta_prefix", "")
    out: Set[str] = set()
    for tid, view in namespace_views(store):
        if skip_own and getattr(view, "meta_prefix", "") == own_prefix:
            continue
        for name in view.list_meta(TXN_PREFIX):
            doc = view.get_meta(name) or {}
            out.update(doc.get("chunks", []) or [])
    return out


def global_live_chunks(store: ChunkStore, *,
                       use_refs: bool = True) -> Set[str]:
    """The full cross-session live set: published references in every
    namespace plus every unsealed journal's chunks.  ``gc()`` may reap
    exactly the stored chunks NOT in this set."""
    return published_chunks(store, use_refs=use_refs) | \
        journaled_chunks(store)


def recover(store: ChunkStore) -> Dict[str, int]:
    """Replay or roll back every unsealed transaction.  Idempotent; runs on
    every graph/session open (a store with no ``txn/`` docs pays one
    ``list_meta`` call) and behind CLI ``kishu recover``.

    Two passes.  First, ``publish`` journals roll forward: their fence
    already proved chunk durability and the WAL carries the full docs, so
    the publish is simply re-applied (HEAD last) and sealed — except that
    a stale journal's HEAD never overwrites a *newer* durable HEAD (seq
    comparison), so a transient publish failure followed by successful
    later publishes cannot time-travel the store backwards on the next
    open.  Then ``open`` journals roll back: their journaled chunks
    (gathered from the per-batch part docs) are deleted and the journal
    dropped — HEAD still names the last sealed state.  The rollback delete
    is filtered against every chunk any (sealed or just-replayed) commit
    references, so it can never reach into published state — journaled
    chunk lists are CAS-new by construction, but the filter makes rollback
    unconditionally safe."""
    out = {"replayed": 0, "rolled_back": 0, "commits_published": 0,
           "chunks_dropped": 0}
    names = store.list_meta(TXN_PREFIX)
    if not names:
        return out
    bases: Dict[str, Optional[dict]] = {}
    parts: Dict[str, List[str]] = {}
    for name in names:
        if PART_SEP in name:
            parts.setdefault(name.split(PART_SEP, 1)[0], []).append(name)
        else:
            bases[name] = store.get_meta(name)
    for base in parts:              # orphan parts: treat as open journals
        bases.setdefault(base, None)

    def part_chunks(base: str) -> List[str]:
        keys: List[str] = []
        for pname in sorted(parts.get(base, [])):
            doc = store.get_meta(pname) or {}
            keys.extend(doc.get("chunks", []))
        return keys

    def seal(base: str) -> None:
        store.delete_meta_batch(sorted(parts.get(base, [])) + [base])

    for base, rec in bases.items():             # pass 1: roll forward
        if not rec or rec.get("status") != STATUS_PUBLISH:
            continue
        docs = dict(rec.get("docs", {}))
        head = docs.get("HEAD")
        cur = store.get_meta("HEAD")
        if head is not None and cur is not None \
                and cur.get("seq", -1) > head.get("seq", -1):
            docs.pop("HEAD")        # stale journal: keep the newer HEAD
        store.put_meta_batch(docs)
        out["replayed"] += 1
        out["commits_published"] += sum(1 for n in docs if n != "HEAD")
        seal(base)
    protected = None
    for base, rec in bases.items():             # pass 2: roll back
        if rec and rec.get("status") == STATUS_PUBLISH:
            continue
        chunks = ((rec or {}).get("chunks", []) or []) + part_chunks(base)
        if chunks:
            if protected is None:
                # global: chunks are shared across namespaces, so the
                # delete must spare content published by ANY tenant and
                # content journaled by a sibling still mid-transaction
                protected = published_chunks(store, use_refs=False) \
                    | journaled_chunks(store, skip_own=True)
            doomed = [k for k in chunks if k not in protected]
            out["chunks_dropped"] += store.delete_chunks(doomed)
        out["rolled_back"] += 1
        seal(base)
    _note_recovery(out)
    return out


def _note_recovery(out: Dict[str, int]) -> None:
    """Attribute a recovery's work to the opening session's metrics (the
    session activates its obs handle around graph construction)."""
    if not (out["replayed"] or out["rolled_back"]):
        return
    try:
        from repro_torch import obs as obs_mod
        o = obs_mod.active()
        if o is None:
            return
        for kind in ("replayed", "rolled_back", "commits_published",
                     "chunks_dropped"):
            if out[kind]:
                o.registry.counter("kishu_txn_recover_total",
                                   kind=kind).inc(out[kind])
    except Exception:  # noqa: BLE001 — observability must not fail recovery
        pass


# ---------------------------------------------------------------------------
# maintenance: tombstone purge (shared by session.gc and CLI gc)
# ---------------------------------------------------------------------------

def purge_tombstones(store: ChunkStore, live_ids, *,
                     dry_run: bool = False) -> int:
    """Delete ``delete_branch`` tombstone docs (``{"deleted": True}``) for
    commits not in ``live_ids`` — without the purge every subsequent graph
    load re-reads the dead markers forever.  Returns the purge count."""
    purged = 0
    for name in store.list_meta("commit/"):
        if name[len("commit/"):] in live_ids:
            continue
        doc = store.get_meta(name)
        if doc is not None and doc.get("deleted") is True:
            if not dry_run:
                store.delete_meta(name)
            purged += 1
    return purged


# ---------------------------------------------------------------------------
# fsck
# ---------------------------------------------------------------------------

FSCK_MAX_DETAILS = 200      # counters stay exact; detail lines are capped
                            # so fsck of a store with 10^5 unreferenced
                            # chunks doesn't build 10^5 strings to print 20


@dataclass
class FsckReport:
    commits: int = 0
    head: Optional[str] = None
    unsealed_txns: int = 0
    torn_head: int = 0          # HEAD names a missing/tombstoned commit
    missing_parents: int = 0
    missing_chunks: int = 0     # referenced by a manifest, absent in store
    dangling_chunks: int = 0    # stored, referenced by nothing
    refs_drift: int = 0         # refcount doc disagrees with commit walk
    tombstones: int = 0         # purgeable delete_branch markers (warning)
    details: List[str] = field(default_factory=list)

    def note(self, line: str) -> None:
        if len(self.details) < FSCK_MAX_DETAILS:
            self.details.append(line)

    @property
    def problems(self) -> int:
        return (self.unsealed_txns + self.torn_head + self.missing_parents
                + self.missing_chunks + self.dangling_chunks
                + self.refs_drift)

    @property
    def clean(self) -> bool:
        return self.problems == 0


def fsck(store: ChunkStore) -> FsckReport:
    """Check every commit-engine invariant over the raw store (no graph
    construction, so the un-recovered state is inspectable): journals all
    sealed, HEAD resolvable, parents present, every referenced chunk
    stored, no unreferenced chunks, refcount doc in agreement with the
    commit walk.  Tombstones are reported but are not problems — ``gc``
    purges them.

    Graph invariants (HEAD, parents, journals, refcounts) are checked for
    the namespace ``store`` is scoped to; the *dangling* check is
    necessarily global — chunks are shared, so "referenced by nothing"
    means by no namespace's commits and no namespace's open journal.
    Use :func:`fsck_all` to audit every namespace of a shared store."""
    rep = FsckReport()
    seen = set()
    for name in store.list_meta(TXN_PREFIX):
        base = name.split(PART_SEP, 1)[0]
        if base in seen:
            continue
        seen.add(base)
        rec = store.get_meta(base) or {}
        rep.unsealed_txns += 1
        rep.note(f"unsealed txn {base} ({rec.get('status', '?')}, "
                 f"{rec.get('n_commits', 0)} commits)")
    nodes: Dict[str, dict] = {}
    for name in store.list_meta("commit/"):
        doc = store.get_meta(name)
        if not doc:
            continue
        if doc.get("deleted") is True:
            rep.tombstones += 1
            continue
        nodes[doc["commit_id"]] = doc
    rep.commits = len(nodes)
    head_doc = store.get_meta("HEAD")
    if head_doc:
        rep.head = head_doc.get("head")
        if rep.head is not None and rep.head not in nodes:
            rep.torn_head = 1
            rep.note(f"HEAD names missing commit {rep.head}")
    referenced = set()
    for cid, doc in nodes.items():
        parent = doc.get("parent")
        if parent is not None and parent not in nodes:
            rep.missing_parents += 1
            rep.note(f"{cid}: parent {parent} missing")
        referenced.update(manifest_chunk_keys(doc.get("manifests", {})))
    refs_doc = store.get_meta(REFS_DOC)
    if refs_doc is not None:
        counted = {k for k, cn in refs_doc.get("counts", {}).items()
                   if cn[0] > 0}
        for k in sorted(counted ^ referenced):
            rep.refs_drift += 1
            rep.note(f"refcount drift: {k} "
                     f"({'counted but unreferenced' if k in counted else 'referenced but uncounted'})")
    present = set(store.chunk_sizes(list(referenced)))
    for k in sorted(referenced - present):
        rep.missing_chunks += 1
        rep.note(f"missing chunk {k}")
    live = global_live_chunks(store, use_refs=False)
    for k in sorted(set(store.list_chunk_keys()) - live):
        rep.dangling_chunks += 1
        rep.note(f"dangling chunk {k}")
    return rep


def fsck_all(store: ChunkStore) -> Dict[str, FsckReport]:
    """Audit every namespace of a shared store — the root graph plus each
    ``tenant/<id>/`` — keyed by tenant id ('' for root).  A store is fully
    healthy iff every report is clean."""
    return {tid: fsck(view) for tid, view in namespace_views(store)}
