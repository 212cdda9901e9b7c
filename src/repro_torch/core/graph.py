"""Checkpoint Graph — branch-based state versioning (§5.1–5.2, Defs 4–6).

A directed tree of commits.  Each node stores:
  - the *state delta*: manifests for co-variables updated by the command
  - the command spec (name/args/seed) — the "cell code" for fallback replay
  - the versioned co-variables the command *accessed* (its dependencies)
  - a snapshot of the full session-state index {co-variable -> version}
    (footnote 5 of the paper), making Def-5 resolution O(1) and checkout
    divergence (Def 6) a single index comparison.

The explicit LCA method (`identical_via_lca`) implements Def 6 literally and
is cross-checked against the index diff in property tests.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch import obs
from repro_torch.core.chunkstore import ChunkStore
from repro_torch.core.covariable import CovKey

KEY_SEP = "\x1f"


def key_str(key: CovKey) -> str:
    return KEY_SEP.join(key)


def parse_key(s: str) -> CovKey:
    return tuple(s.split(KEY_SEP))


def manifest_chunk_keys(manifests: Dict[str, dict]):
    """Chunk keys referenced by a commit doc's manifest map — THE single
    definition of a chunk reference, shared by gc marking
    (``live_chunk_keys``), recovery's rollback filter, and fsck, so the
    three can never disagree about what is referenced."""
    for man in manifests.values():
        if man.get("unserializable"):
            continue
        for c in man.get("base", {}).get("chunks", []):
            yield c["key"]


def manifest_chunk_entries(manifests: Dict[str, dict]):
    """Like :func:`manifest_chunk_keys` but yields ``(key, nbytes)`` pairs
    (the manifest's per-chunk logical length), for refcount accounting."""
    for man in manifests.values():
        if man.get("unserializable"):
            continue
        for c in man.get("base", {}).get("chunks", []):
            yield c["key"], int(c.get("n", 0))


#: per-namespace chunk refcount document.  Rides the same atomic publish
#: batch as the commit docs and HEAD, so it can never disagree with the
#: published graph — crash recovery's roll-forward replays it with them.
REFS_DOC = "refs"


class ChunkRefCounts:
    """Chunk refcounts for one namespace: ``{key: [n_commits, nbytes]}``.

    Counts are per *commit* (a commit referencing one key from several
    co-variables counts once), so ``add``/``remove`` of the same commit's
    manifests are exactly symmetric.  The count answers cross-session GC's
    question — "does any commit in this namespace still need this chunk?"
    — in one meta read instead of a full commit walk, and the per-key
    ``nbytes`` gives the byte total quotas are enforced against
    (:meth:`bytes_live` counts shared chunks toward every tenant that
    references them: dedup is a storage win, not a billing loophole)."""

    def __init__(self, counts: Optional[Dict[str, list]] = None):
        self.counts: Dict[str, list] = counts or {}

    @classmethod
    def from_doc(cls, doc: Optional[dict]) -> "ChunkRefCounts":
        return cls({k: list(v) for k, v in
                    (doc or {}).get("counts", {}).items()})

    @classmethod
    def from_nodes(cls, nodes: Dict[str, "CommitNode"]) -> "ChunkRefCounts":
        """Rebuild from a loaded graph — the upgrade path for stores
        written before refcounts existed."""
        refs = cls()
        for node in nodes.values():
            refs.add(node.manifests)
        return refs

    def to_doc(self) -> dict:
        return {"counts": {k: v for k, v in self.counts.items() if v[0] > 0}}

    def add(self, manifests: Dict[str, dict]) -> None:
        seen = set()
        for key, nbytes in manifest_chunk_entries(manifests):
            if key in seen:
                continue
            seen.add(key)
            cn = self.counts.setdefault(key, [0, nbytes])
            cn[0] += 1
            cn[1] = max(cn[1], nbytes)

    def remove(self, manifests: Dict[str, dict]) -> None:
        seen = set()
        for key, _ in manifest_chunk_entries(manifests):
            if key in seen:
                continue
            seen.add(key)
            cn = self.counts.get(key)
            if cn is not None:
                cn[0] -= 1
                if cn[0] <= 0:
                    del self.counts[key]

    def live_keys(self) -> set:
        return {k for k, cn in self.counts.items() if cn[0] > 0}

    def bytes_live(self) -> int:
        return sum(cn[1] for cn in self.counts.values() if cn[0] > 0)


@dataclass
class CommitNode:
    commit_id: str
    parent: Optional[str]
    depth: int
    timestamp: float
    command: dict                      # {"name", "args"} — the "cell code"
    manifests: Dict[str, dict]         # key_str -> manifest (the delta)
    deleted: List[str]                 # key_strs removed by this command
    accessed: Dict[str, str]           # key_str -> version (dependencies)
    state_index: Dict[str, str]        # key_str -> version (Def 5 snapshot)
    message: str = ""
    stats: dict = field(default_factory=dict)

    def to_doc(self) -> dict:
        return {
            "commit_id": self.commit_id, "parent": self.parent,
            "depth": self.depth, "timestamp": self.timestamp,
            "command": self.command, "manifests": self.manifests,
            "deleted": self.deleted, "accessed": self.accessed,
            "state_index": self.state_index, "message": self.message,
            "stats": self.stats,
        }

    @classmethod
    def from_doc(cls, doc: dict) -> "CommitNode":
        return cls(**doc)


@dataclass
class CheckoutPlan:
    to_load: Dict[CovKey, str]         # cov -> version to load
    to_delete: List[CovKey]
    identical: List[CovKey]
    # chunk-level refinement, filled in by StateLoader.plan_patches: diverged
    # co-variables whose live buffer matches the target structurally are
    # *patched* (fetch only differing chunks) instead of fully materialized
    patches: List[Any] = field(default_factory=list)

    @property
    def n_diverged(self) -> int:
        return len(self.to_load)

    @property
    def n_patched(self) -> int:
        return len(self.patches)


class CheckpointGraph:
    def __init__(self, store: ChunkStore, *, engine=None,
                 recover: bool = True, read_only: bool = False):
        self.store = store
        # a read-only graph (a follower rank of a distributed session)
        # moves HEAD in memory only and never publishes; it learns new
        # commits by reload()
        self.read_only = read_only
        # commit publication routes through the transactional engine when
        # one is attached (txn.TxnEngine): journaled, group-committed,
        # fenced against async chunk writes.  Engine-less graphs still
        # publish through the atomic put_meta_batch (doc before HEAD).
        self.engine = engine
        self.nodes: Dict[str, CommitNode] = {}
        self.children: Dict[str, List[str]] = {}
        self.head: Optional[str] = None
        self._seq = 0
        self._meta_bytes = 0    # cached sum of serialized node docs —
                                # storage_stats() must not re-dump the graph
        if recover:
            from repro_torch.core import txn as txn_mod
            txn_mod.recover(store)     # replay/roll back unsealed txns
        self._load()

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def reload(self) -> None:
        """Re-read the published graph (another writer's new commits)."""
        self.nodes, self.children = {}, {}
        self.head, self._seq, self._meta_bytes = None, 0, 0
        self._load()

    def _load(self) -> None:
        for name in self.store.list_meta("commit/"):
            doc = self.store.get_meta(name)
            if not doc or doc.get("deleted") is True:
                continue    # delete_branch tombstone ({"deleted": True});
                            # a commit's own "deleted" field is a list
            node = CommitNode.from_doc(doc)
            self.nodes[node.commit_id] = node
            self._meta_bytes += len(json.dumps(node.to_doc()))
        for node in self.nodes.values():
            if node.parent is not None:
                self.children.setdefault(node.parent, []).append(node.commit_id)
        head_doc = self.store.get_meta("HEAD")
        if head_doc:
            self.head = head_doc["head"]
            self._seq = head_doc["seq"]
        refs_doc = self.store.get_meta(REFS_DOC)
        if refs_doc is not None:
            self.refs = ChunkRefCounts.from_doc(refs_doc)
        else:
            # pre-refcount store: rebuild from the loaded commits; the doc
            # itself first lands with the next publish that carries it
            self.refs = ChunkRefCounts.from_nodes(self.nodes)

    def _persist(self, node: CommitNode) -> None:
        if self.read_only:
            raise RuntimeError("a read-only graph does not publish commits")
        with obs.span("meta_docs"):
            doc = node.to_doc()
            self._meta_bytes += len(json.dumps(doc))
            self.refs.add(node.manifests)
            # the refcount doc travels in the same atomic batch as the
            # commit and HEAD: a torn publish (or its crash-recovery
            # replay) can never leave counts disagreeing with the published
            # graph.  Order is refs -> commit doc -> HEAD: on a decomposing
            # backend the commit doc still lands immediately before HEAD,
            # preserving the invariant that a torn publish never leaves
            # HEAD naming an absent commit (recovery squares the refs
            # ledger either way)
            docs = {REFS_DOC: self.refs.to_doc(),
                    f"commit/{node.commit_id}": doc,
                    "HEAD": {"head": self.head, "seq": self._seq}}
        if self.engine is not None:
            self.engine.commit(docs)
        else:
            self.store.put_meta_batch(docs)    # atomic where the backend
                                               # allows; always doc-then-HEAD

    # ------------------------------------------------------------------
    # commits
    # ------------------------------------------------------------------
    def init_root(self) -> CommitNode:
        assert not self.nodes, "graph already initialized"
        root = CommitNode(
            commit_id="c00000", parent=None, depth=0, timestamp=time.time(),
            command={"name": "__init__", "args": {}}, manifests={},
            deleted=[], accessed={}, state_index={}, message="session start")
        self.nodes[root.commit_id] = root
        self.head = root.commit_id
        self._seq = 1
        self._persist(root)
        return root

    def commit(self, *, command: dict, manifests: Dict[str, dict],
               deleted_keys: List[CovKey], accessed: Dict[CovKey, str],
               updated_keys: List[CovKey], message: str = "",
               stats: Optional[dict] = None) -> CommitNode:
        assert self.head is not None
        parent = self.nodes[self.head]
        cid = f"c{self._seq:05d}"
        self._seq += 1

        index = dict(parent.state_index)
        for k in deleted_keys:
            index.pop(key_str(k), None)
        for k in updated_keys:
            index[key_str(k)] = cid

        node = CommitNode(
            commit_id=cid, parent=parent.commit_id, depth=parent.depth + 1,
            timestamp=time.time(), command=command, manifests=manifests,
            deleted=[key_str(k) for k in deleted_keys],
            accessed={key_str(k): v for k, v in accessed.items()},
            state_index=index, message=message, stats=stats or {})
        self.nodes[cid] = node
        self.children.setdefault(parent.commit_id, []).append(cid)
        self.head = cid
        self._persist(node)
        return node

    def set_head(self, commit_id: str) -> None:
        assert commit_id in self.nodes, commit_id
        self.head = commit_id
        if self.read_only:
            self._seq += 1
            return
        if self.engine is not None:
            # publish any queued commits first: durable HEAD must never
            # name a commit whose doc is still in an open group
            self.engine.flush()
        # every HEAD movement — checkout included — advances seq, so a
        # concurrent (or resurrected) writer holding a stale seq fails the
        # publish guard instead of silently rewinding the branch.  Commit
        # ids derive from seq, so ids skip a number after a checkout;
        # nothing orders by density, only by monotonicity.
        self._seq += 1
        docs = {"HEAD": {"head": self.head, "seq": self._seq}}
        from repro_torch.core import txn as txn_mod
        txn_mod.check_publish_guard(self.store, docs,
                                    lease=getattr(self.engine, "lease",
                                                  None))
        self.store.put_meta_batch(docs)

    def forget(self, commit_id: str) -> None:
        """Drop a commit from the in-memory graph (branch deletion),
        keeping children, refcounts, and the cached meta-bytes accounting
        in step.  The caller owns the on-store tombstone (and persists the
        decremented refcount doc in the same batch)."""
        node = self.nodes.pop(commit_id, None)
        if node is None:
            return
        self._meta_bytes -= len(json.dumps(node.to_doc()))
        self.refs.remove(node.manifests)
        self.children.pop(commit_id, None)
        if node.parent in self.children:
            self.children[node.parent] = [
                c for c in self.children[node.parent] if c != commit_id]

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def lca(self, a: str, b: str) -> str:
        na, nb = self.nodes[a], self.nodes[b]
        while na.depth > nb.depth:
            na = self.nodes[na.parent]
        while nb.depth > na.depth:
            nb = self.nodes[nb.parent]
        while na.commit_id != nb.commit_id:
            na, nb = self.nodes[na.parent], self.nodes[nb.parent]
        return na.commit_id

    def state_index(self, t: str) -> Dict[str, str]:
        return self.nodes[t].state_index

    def identical_via_lca(self, key: CovKey, ta: str, tb: str) -> bool:
        """Def 6, literally: X identical between states ta and tb iff a single
        versioned co-variable (X, tc) is in the states of ta, tb and their LCA."""
        ks = key_str(key)
        tc = self.lca(ta, tb)
        va = self.nodes[ta].state_index.get(ks)
        vb = self.nodes[tb].state_index.get(ks)
        vc = self.nodes[tc].state_index.get(ks)
        return va is not None and va == vb == vc

    def diff(self, cur: str, tgt: str) -> CheckoutPlan:
        """Divergence between two states via index comparison (== Def 6)."""
        ci = self.nodes[cur].state_index
        ti = self.nodes[tgt].state_index
        to_load = {parse_key(k): v for k, v in ti.items() if ci.get(k) != v}
        to_delete = [parse_key(k) for k in ci if k not in ti]
        identical = [parse_key(k) for k, v in ci.items() if ti.get(k) == v]
        return CheckoutPlan(to_load=to_load, to_delete=to_delete,
                            identical=identical)

    def manifest_of(self, key: CovKey, version: str) -> Optional[dict]:
        return self.nodes[version].manifests.get(key_str(key))

    def live_chunk_keys(self) -> set:
        """Chunk keys referenced by any live commit's manifests — the GC
        mark set (shared by session gc and the CLI so they cannot disagree
        on what is garbage)."""
        live = set()
        for node in self.nodes.values():
            live.update(manifest_chunk_keys(node.manifests))
        return live

    def log(self, limit: int = 0) -> List[dict]:
        out = []
        for cid in sorted(self.nodes):
            n = self.nodes[cid]
            out.append({"commit": cid, "parent": n.parent,
                        "command": n.command.get("name"),
                        "message": n.message,
                        "updated": len(n.manifests),
                        "deleted": len(n.deleted),
                        # measured cell cost (None on pre-planner docs —
                        # the planner substitutes a conservative default)
                        "exec_s": n.stats.get("exec_s"),
                        "replays": int(n.stats.get("replays", 0) or 0),
                        "head": cid == self.head})
        return out[-limit:] if limit else out

    def path_from_root(self, t: str) -> List[str]:
        out = []
        node = self.nodes[t]
        while node is not None:
            out.append(node.commit_id)
            node = self.nodes[node.parent] if node.parent else None
        return out[::-1]

    def total_meta_bytes(self) -> int:
        """Serialized size of all commit docs — maintained incrementally
        (commit/load/forget), so ``storage_stats()`` is O(1) instead of
        re-dumping every node's JSON on each call."""
        return self._meta_bytes
