"""Storage fabric — sharded, replicated, tiered chunk stores (DESIGN.md §12).

The chunk store interface (chunkstore.py) talks to *one* backend; serving a
fleet needs many backends behind that same interface.  This module composes
existing stores into a fabric:

  - ``ShardedStore``    — a consistent-hash ring over N child stores.  Chunk
                          keys are already uniform hashes, so the ring spreads
                          both capacity and *bandwidth*: scatter-gather
                          ``get_chunks``/``put_chunks`` group a plan by shard
                          and drive every shard concurrently
                          (``parallel.scatter_parallel``).  Reads that miss
                          the home shard sweep the others and heal placement
                          in passing — a ring change self-repairs on read.
  - ``ReplicatedStore`` — k-way replication: writes go to every replica,
                          reads are served by the first replica that has the
                          chunk and *read-repair* copies it back to the
                          replicas that missed, so a lost disk heals in place.
                          Only when every replica misses does the chunk count
                          as lost (-> DataRestorer fallback recomputation).
  - ``TieredStore``     — bounded in-memory hot tier over a cold backend:
                          writes go through to cold (durability) and prime
                          hot; reads promote; demotion is plain LRU eviction
                          (cold always holds the chunk).  This is the
                          per-*tier* generalization of the per-*session*
                          ChunkCache.

Topologies nest freely and are spelled as ``fabric://`` URIs understood by
``open_store`` (composable with ``?codec=``):

    fabric://shard(dir:///s0,dir:///s1,dir:///s2,dir:///s3)
    fabric://rep(dir:///a,dir:///b)
    fabric://tier(64M,sqlite:///cold.db)
    fabric://shard(rep(dir:///a0,dir:///a1),rep(dir:///b0,dir:///b1))?codec=auto

Fleet operations (CLI verbs ``topology`` / ``scrub`` / ``rebalance``) walk
the composition recursively: ``scrub`` finds (and with ``repair=True``
heals) replica-missing, misplaced, and content-corrupt chunks; ``rebalance``
moves chunks to their ring homes after a topology edit.
"""
from __future__ import annotations

import bisect
import hashlib
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core import parallel
from repro_torch.core.chunkstore import (ChunkCache, ChunkStore,
                                         CompressedStore, FaultInjectedStore,
                                         NamespacedStore, chunk_key,
                                         open_store)
from repro_torch.core.serialize import ChunkMissingError

DEFAULT_VNODES = 64


# ---------------------------------------------------------------------------
# consistent-hash ring
# ---------------------------------------------------------------------------

class HashRing:
    """Classic consistent hashing: every shard owns ``vnodes`` pseudo-random
    points on a 64-bit ring; a key belongs to the shard owning the first
    point at or after the key's hash.  Adding/removing one shard moves only
    ~1/N of the keys — the contract ``rebalance`` relies on."""

    def __init__(self, n_shards: int, vnodes: int = DEFAULT_VNODES):
        if n_shards < 1:
            raise ValueError("ring needs at least one shard")
        points: List[Tuple[int, int]] = []
        for s in range(n_shards):
            for v in range(vnodes):
                points.append((self._hash(f"{s}#{v}"), s))
        points.sort()
        self._hashes = [h for h, _ in points]
        self._shards = [s for _, s in points]
        self.n_shards = n_shards
        self.vnodes = vnodes

    @staticmethod
    def _hash(s: str) -> int:
        return int.from_bytes(
            hashlib.blake2b(s.encode(), digest_size=8).digest(), "big")

    def shard_for(self, key: str) -> int:
        i = bisect.bisect_right(self._hashes, self._hash(key))
        if i == len(self._hashes):
            i = 0
        return self._shards[i]


# ---------------------------------------------------------------------------
# sharded store
# ---------------------------------------------------------------------------

class ShardedStore(ChunkStore):
    """Consistent-hash ring over child stores with scatter-gather batched I/O.

    Chunks live on their ring home; metadata documents (commit graph, HEAD)
    are tiny and mirrored to *every* shard, so the graph stays readable with
    any single shard alive.  Reads that miss the home shard sweep the other
    shards — a chunk found astray (ring change, manual surgery) is served,
    copied home, and removed from the stray shard (incremental rebalance on
    read, counted in ``heals``)."""

    supports_parallel_get = True
    native_scatter = True       # get_chunks fans out across shards itself

    def __init__(self, shards: Sequence[ChunkStore], *,
                 vnodes: int = DEFAULT_VNODES):
        self.shards = list(shards)
        if not self.shards:
            raise ValueError("ShardedStore needs at least one shard")
        self.ring = HashRing(len(self.shards), vnodes)
        # slabs must be wide enough to give every shard work per scatter
        self.min_slab = len(self.shards) * max(
            getattr(s, "min_slab", 1) for s in self.shards)
        self.heals = 0

    def home(self, key: str) -> int:
        return self.ring.shard_for(key)

    def _group(self, keys: Iterable[str]) -> Dict[int, List[str]]:
        groups: Dict[int, List[str]] = {}
        for k in keys:
            groups.setdefault(self.home(k), []).append(k)
        return groups

    # ---- chunks ----
    def put_chunk(self, key, data):
        return self.shards[self.home(key)].put_chunk(key, data)

    def put_chunks(self, pairs):
        groups: Dict[int, List[Tuple[str, bytes]]] = {}
        for k, d in pairs:
            groups.setdefault(self.home(k), []).append((k, d))
        items = list(groups.items())
        written = parallel.scatter_parallel(
            lambda it: self.shards[it[0]].put_chunks(it[1]), items)
        return sum(written)

    def _heal(self, key: str, stray: int) -> None:
        """Move a stray chunk to its ring home — in its *stored* form, so a
        compressed chunk stays compressed across the move."""
        try:
            stored = self.shards[stray].get_chunk_stored(key)
        except ChunkMissingError:
            return
        self.shards[self.home(key)].put_chunk(key, stored)
        self.shards[stray].delete_chunk(key)
        self.heals += 1

    def get_chunk(self, key):
        home = self.home(key)
        try:
            return self.shards[home].get_chunk(key)
        except ChunkMissingError:
            pass
        for i, shard in enumerate(self.shards):
            if i == home:
                continue
            try:
                data = shard.get_chunk(key)
            except ChunkMissingError:
                continue
            self._heal(key, i)
            return data
        raise ChunkMissingError(key)

    def get_chunks(self, keys, *, missing_ok=False):
        uniq = list(dict.fromkeys(keys))
        groups = list(self._group(uniq).items())
        got: Dict[str, bytes] = {}
        for part in parallel.scatter_parallel(
                lambda it: self.shards[it[0]].get_chunks(it[1],
                                                         missing_ok=True),
                groups):
            got.update(part)
        missing = [k for k in uniq if k not in got]
        if missing:
            # stray sweep: ask every shard for the leftovers, heal hits home
            sweeps = parallel.scatter_parallel(
                lambda shard: shard.get_chunks(missing, missing_ok=True),
                self.shards)
            for i, part in enumerate(sweeps):
                for k, d in part.items():
                    if k not in got and i != self.home(k):
                        self._heal(k, i)
                    got.setdefault(k, d)
        if not missing_ok and len(got) != len(uniq):
            raise ChunkMissingError(next(k for k in uniq if k not in got))
        return got

    def get_chunk_stored(self, key):
        try:
            return self.shards[self.home(key)].get_chunk_stored(key)
        except ChunkMissingError:
            pass
        for i, shard in enumerate(self.shards):
            if i != self.home(key):
                try:
                    return shard.get_chunk_stored(key)
                except ChunkMissingError:
                    continue
        raise ChunkMissingError(key)

    def has_chunk(self, key):
        if self.shards[self.home(key)].has_chunk(key):
            return True
        return any(s.has_chunk(key) for s in self.shards)

    def list_chunk_keys(self):
        parts = parallel.scatter_parallel(
            lambda s: s.list_chunk_keys(), self.shards)
        return list(dict.fromkeys(k for part in parts for k in part))

    def chunk_sizes(self, keys):
        uniq = list(dict.fromkeys(keys))
        groups = list(self._group(uniq).items())
        out: Dict[str, int] = {}
        for part in parallel.scatter_parallel(
                lambda it: self.shards[it[0]].chunk_sizes(it[1]), groups):
            out.update(part)
        missing = [k for k in uniq if k not in out]
        if missing:
            for part in parallel.scatter_parallel(
                    lambda s: s.chunk_sizes(missing), self.shards):
                for k, n in part.items():
                    out.setdefault(k, n)
        return out

    def delete_chunk(self, key):
        # delete everywhere: strays (pre-rebalance copies) must die too
        for s in self.shards:
            s.delete_chunk(key)

    def delete_chunks(self, keys):
        keys = list(keys)
        removed = parallel.scatter_parallel(
            lambda s: s.delete_chunks(keys), self.shards)
        return sum(removed)

    # ---- meta: mirrored to every shard (small, and the graph must stay
    # readable no matter which single shard survives) ----
    def put_meta(self, name, doc):
        parallel.scatter_parallel(lambda s: s.put_meta(name, doc),
                                  self.shards)

    def put_meta_batch(self, docs):
        # one scatter, each shard applying its own atomic batch — the
        # commit engine's publish costs one round per shard, not one per
        # (doc x shard)
        parallel.scatter_parallel(lambda s: s.put_meta_batch(docs),
                                  self.shards)

    def get_meta(self, name):
        for s in self.shards:
            doc = s.get_meta(name)
            if doc is not None:
                return doc
        return None

    def list_meta(self, prefix):
        out = set()
        for s in self.shards:
            out.update(s.list_meta(prefix))
        return sorted(out)

    def delete_meta(self, name):
        # mirrored docs (journal seals, tombstone purges) die everywhere
        parallel.scatter_parallel(lambda s: s.delete_meta(name), self.shards)

    def delete_meta_batch(self, names):
        names = list(names)
        parallel.scatter_parallel(lambda s: s.delete_meta_batch(names),
                                  self.shards)

    # ---- stats ----
    def chunk_bytes_total(self):
        return sum(parallel.scatter_parallel(
            lambda s: s.chunk_bytes_total(), self.shards))

    def n_chunks(self):
        return sum(parallel.scatter_parallel(
            lambda s: s.n_chunks(), self.shards))


# ---------------------------------------------------------------------------
# replicated store
# ---------------------------------------------------------------------------

class ReplicatedStore(ChunkStore):
    """k-way replication with read-repair.

    Writes scatter to every replica; a write that lands on *any* replica is
    durable (per-replica write faults surface as read-repair work, not write
    errors).  Reads serve from the first replica holding the chunk and copy
    it back to the replicas before it that missed — losing a whole replica
    degrades one read per chunk, then heals.  A chunk absent from every
    replica raises ChunkMissingError, which upstream falls back to
    DataRestorer recomputation."""

    supports_parallel_get = True

    def __init__(self, replicas: Sequence[ChunkStore]):
        self.replicas = list(replicas)
        if not self.replicas:
            raise ValueError("ReplicatedStore needs at least one replica")
        self.min_slab = max(getattr(r, "min_slab", 1) for r in self.replicas)
        self.repairs = 0          # chunk copies healed onto a lagging replica
        self.replica_misses = 0   # reads not served by the primary
        self.write_errors = 0     # per-replica write faults absorbed

    def _scatter_writes(self, fn):
        """Run a write against every replica; a write that lands on *any*
        replica is durable, so per-replica faults (full/read-only disk) are
        absorbed — the lagging replica heals via read-repair/scrub — and
        only an all-replicas failure raises."""
        def safe(r):
            try:
                return fn(r)
            except Exception as e:  # noqa: BLE001 — dead replica
                return e
        results = parallel.scatter_parallel(safe, self.replicas)
        errors = [r for r in results if isinstance(r, Exception)]
        self.write_errors += len(errors)
        if len(errors) == len(results):
            raise errors[0]
        return [r for r in results if not isinstance(r, Exception)]

    # ---- chunks ----
    def put_chunk(self, key, data):
        return bool(self._scatter_writes(
            lambda r: r.put_chunk(key, data))[0])

    def put_chunks(self, pairs):
        pairs = list(pairs)
        return self._scatter_writes(lambda r: r.put_chunks(pairs))[0]

    def _repair(self, key: str, served_by: int) -> None:
        """Copy ``key`` onto replicas [0, served_by) that just missed it —
        in its *stored* form, so compression survives the repair."""
        try:
            stored = self.replicas[served_by].get_chunk_stored(key)
        except ChunkMissingError:
            return
        for r in self.replicas[:served_by]:
            try:
                if r.put_chunk(key, stored):
                    self.repairs += 1
            except Exception:  # noqa: BLE001 — dead replica: heal later
                pass

    def get_chunk(self, key):
        for i, r in enumerate(self.replicas):
            try:
                data = r.get_chunk(key)
            except ChunkMissingError:
                continue
            if i > 0:
                self.replica_misses += 1
                self._repair(key, i)
            return data
        raise ChunkMissingError(key)

    def get_chunk_stored(self, key):
        for r in self.replicas:
            try:
                return r.get_chunk_stored(key)
            except ChunkMissingError:
                continue
        raise ChunkMissingError(key)

    def get_chunks(self, keys, *, missing_ok=False):
        uniq = list(dict.fromkeys(keys))
        got: Dict[str, bytes] = {}
        missing = uniq
        for i, r in enumerate(self.replicas):
            if not missing:
                break
            try:
                part = r.get_chunks(missing, missing_ok=True)
            except ChunkMissingError:   # fault-wrapped replica: all lost
                part = {}
            if i > 0 and part:
                self.replica_misses += len(part)
                for k in part:
                    self._repair(k, i)
            got.update(part)
            missing = [k for k in missing if k not in got]
        if missing and not missing_ok:
            raise ChunkMissingError(missing[0])
        return got

    def has_chunk(self, key):
        return any(r.has_chunk(key) for r in self.replicas)

    def list_chunk_keys(self):
        parts = parallel.scatter_parallel(
            lambda r: r.list_chunk_keys(), self.replicas)
        return list(dict.fromkeys(k for part in parts for k in part))

    def chunk_sizes(self, keys):
        uniq = list(dict.fromkeys(keys))
        out: Dict[str, int] = {}
        missing = uniq
        for r in self.replicas:
            if not missing:
                break
            for k, n in r.chunk_sizes(missing).items():
                out.setdefault(k, n)
            missing = [k for k in missing if k not in out]
        return out

    def delete_chunk(self, key):
        for r in self.replicas:
            r.delete_chunk(key)

    def delete_chunks(self, keys):
        keys = list(keys)
        removed = parallel.scatter_parallel(
            lambda r: r.delete_chunks(keys), self.replicas)
        return max(removed) if removed else 0

    # ---- meta ----
    def put_meta(self, name, doc):
        parallel.scatter_parallel(lambda r: r.put_meta(name, doc),
                                  self.replicas)

    def put_meta_batch(self, docs):
        parallel.scatter_parallel(lambda r: r.put_meta_batch(docs),
                                  self.replicas)

    def get_meta(self, name):
        for r in self.replicas:
            doc = r.get_meta(name)
            if doc is not None:
                return doc
        return None

    def list_meta(self, prefix):
        out = set()
        for r in self.replicas:
            out.update(r.list_meta(prefix))
        return sorted(out)

    def delete_meta(self, name):
        parallel.scatter_parallel(lambda r: r.delete_meta(name),
                                  self.replicas)

    def delete_meta_batch(self, names):
        names = list(names)
        parallel.scatter_parallel(lambda r: r.delete_meta_batch(names),
                                  self.replicas)

    # ---- stats: logical (max across replicas), not physical sum ----
    def chunk_bytes_total(self):
        return max(parallel.scatter_parallel(
            lambda r: r.chunk_bytes_total(), self.replicas))

    def n_chunks(self):
        return max(parallel.scatter_parallel(
            lambda r: r.n_chunks(), self.replicas))


# ---------------------------------------------------------------------------
# tiered store
# ---------------------------------------------------------------------------

class TieredStore(ChunkStore):
    """Bounded in-memory hot tier over a cold backend.

    Write-through: every put lands on cold (durability) and primes hot.
    Reads promote on miss; demotion is LRU eviction out of the bounded hot
    tier — cold always holds the chunk, so demotion is a drop, never a
    write-back.  The hot tier holds *logical* (decoded) bytes, so a hit
    skips both the backend round-trip and the codec."""

    def __init__(self, cold: ChunkStore, *, hot_bytes: Optional[int] = None):
        from repro_torch.core.chunkstore import decode_chunk
        self._decode = decode_chunk
        self.cold = cold
        self.hot = ChunkCache(hot_bytes)
        self.min_slab = getattr(cold, "min_slab", 1)
        self.supports_parallel_get = getattr(cold, "supports_parallel_get",
                                             True)
        self.native_scatter = getattr(cold, "native_scatter", False)

    # ---- chunks ----
    def put_chunk(self, key, data):
        wrote = self.cold.put_chunk(key, data)
        self.hot.put(key, self._decode(bytes(data)))
        return wrote

    def put_chunks(self, pairs):
        pairs = list(pairs)
        written = self.cold.put_chunks(pairs)
        for k, d in pairs:
            self.hot.put(k, self._decode(bytes(d)))
        return written

    def get_chunk(self, key):
        data = self.hot.get(key)
        if data is not None:
            return data
        data = self.cold.get_chunk(key)
        self.hot.put(key, data)                      # promotion
        return data

    def get_chunk_stored(self, key):
        return self.cold.get_chunk_stored(key)

    def get_chunks(self, keys, *, missing_ok=False):
        uniq = list(dict.fromkeys(keys))
        got = self.hot.get_many(uniq)
        missing = [k for k in uniq if k not in got]
        if missing:
            cold = self.cold.get_chunks(missing, missing_ok=missing_ok)
            self.hot.put_many(cold)
            got.update(cold)
        return got

    def has_chunk(self, key):
        return self.hot.get(key) is not None or self.cold.has_chunk(key)

    def list_chunk_keys(self):
        return self.cold.list_chunk_keys()

    def chunk_sizes(self, keys):
        return self.cold.chunk_sizes(keys)

    def delete_chunk(self, key):
        self.hot.discard(key)
        self.cold.delete_chunk(key)

    def delete_chunks(self, keys):
        keys = list(keys)
        for k in keys:
            self.hot.discard(k)
        return self.cold.delete_chunks(keys)

    # ---- meta / stats: cold is the source of truth ----
    def put_meta(self, name, doc):
        self.cold.put_meta(name, doc)

    def put_meta_batch(self, docs):
        self.cold.put_meta_batch(docs)

    def get_meta(self, name):
        return self.cold.get_meta(name)

    def list_meta(self, prefix):
        return self.cold.list_meta(prefix)

    def delete_meta(self, name):
        self.cold.delete_meta(name)

    def delete_meta_batch(self, names):
        self.cold.delete_meta_batch(names)

    def chunk_bytes_total(self):
        return self.cold.chunk_bytes_total()

    def n_chunks(self):
        return self.cold.n_chunks()


# ---------------------------------------------------------------------------
# fabric:// topology specs
# ---------------------------------------------------------------------------

_SIZE_SUFFIX = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30}


def parse_size(s: str) -> int:
    """``64M`` / ``1G`` / ``4096`` -> bytes."""
    s = s.strip()
    mult = _SIZE_SUFFIX.get(s[-1:].upper())
    if mult is not None:
        s = s[:-1]
    try:
        return int(s) * (mult or 1)
    except ValueError:
        raise ValueError(f"bad size spec {s!r} (want e.g. 64M, 1G, 4096)")


def _split_top(spec: str) -> List[str]:
    """Split on commas at paren depth 0."""
    parts, depth, cur = [], 0, []
    for ch in spec:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth < 0:
                raise ValueError(f"unbalanced parens in topology {spec!r}")
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if depth != 0:
        raise ValueError(f"unbalanced parens in topology {spec!r}")
    parts.append("".join(cur))
    return [p.strip() for p in parts if p.strip()]


def parse_topology(spec: str) -> ChunkStore:
    """Recursive ``fabric://`` topology grammar:

        expr  := 'shard(' expr {',' expr} ')'
               | 'rep(' expr {',' expr} ')'
               | 'tier(' SIZE ',' expr ')'
               | leaf store URI (memory:// | dir://path | sqlite://path | path)
    """
    spec = spec.strip()
    for comb in ("shard", "rep", "tier"):
        if spec.startswith(comb + "(") and spec.endswith(")"):
            parts = _split_top(spec[len(comb) + 1:-1])
            if comb == "tier":
                if len(parts) != 2:
                    raise ValueError(
                        f"tier(SIZE,COLD) takes exactly 2 args: {spec!r}")
                return TieredStore(parse_topology(parts[1]),
                                   hot_bytes=parse_size(parts[0]))
            if not parts:
                raise ValueError(f"{comb}() needs at least one child: "
                                 f"{spec!r}")
            children = [parse_topology(p) for p in parts]
            if comb == "shard":
                return ShardedStore(children)
            return ReplicatedStore(children)
    # leaf URI — a combinator typo must not silently become a directory path
    if any(ch in spec for ch in "(),"):
        raise ValueError(f"malformed topology spec {spec!r} "
                         "(want shard(...)/rep(...)/tier(...) or a store "
                         "URI)")
    return open_store(spec)


# ---------------------------------------------------------------------------
# fleet ops: topology / scrub / rebalance
# ---------------------------------------------------------------------------

def topology_lines(store: ChunkStore, indent: str = "") -> List[str]:
    """Human-readable tree of a store composition (CLI ``topology``)."""
    bump = indent + "  "
    if isinstance(store, ShardedStore):
        out = [f"{indent}shard(n={len(store.shards)}, "
               f"vnodes={store.ring.vnodes})"]
        for s in store.shards:
            out += topology_lines(s, bump)
        return out
    if isinstance(store, ReplicatedStore):
        out = [f"{indent}rep(k={len(store.replicas)})"]
        for r in store.replicas:
            out += topology_lines(r, bump)
        return out
    if isinstance(store, TieredStore):
        out = [f"{indent}tier(hot={store.hot.max_bytes})"]
        return out + topology_lines(store.cold, bump)
    if isinstance(store, CompressedStore):
        name = store.codec.name if store.codec else "raw"
        return [f"{indent}codec({name})"] + topology_lines(store.inner, bump)
    if isinstance(store, FaultInjectedStore):
        return [f"{indent}fault-injected"] + topology_lines(store.inner, bump)
    if isinstance(store, NamespacedStore):
        return ([f"{indent}tenant({store.tenant_id})"]
                + topology_lines(store.inner, bump))
    root = getattr(store, "root", None) or getattr(store, "path", None)
    kind = type(store).__name__
    return [f"{indent}{kind}({root})" if root else f"{indent}{kind}"]


@dataclass
class ScrubReport:
    chunks_checked: int = 0
    replica_missing: int = 0    # (chunk, replica) pairs absent
    misplaced: int = 0          # chunks off their ring home
    corrupt: int = 0            # content-address mismatches (deep only)
    repaired: int = 0
    details: List[str] = field(default_factory=list)

    @property
    def problems(self) -> int:
        return self.replica_missing + self.misplaced + self.corrupt

    @property
    def remaining(self) -> int:
        return max(0, self.problems - self.repaired)


def _scrub_replicated(store: ReplicatedStore, repair: bool,
                      report: ScrubReport) -> None:
    union = store.list_chunk_keys()
    per_replica = parallel.scatter_parallel(
        lambda r: set(r.list_chunk_keys()), store.replicas)
    for i, have in enumerate(per_replica):
        lost = [k for k in union if k not in have]
        report.replica_missing += len(lost)
        for k in lost:
            report.details.append(f"replica {i} missing {k}")
        if repair and lost:
            for k in lost:
                stored = None
                for j, src in enumerate(store.replicas):
                    if j == i:
                        continue
                    try:        # stored form: compression survives the copy
                        stored = src.get_chunk_stored(k)
                        break
                    except ChunkMissingError:
                        continue
                if stored is None:
                    continue                    # lost everywhere: not ours
                store.replicas[i].put_chunk(k, stored)
                if store.replicas[i].has_chunk(k):
                    report.repaired += 1


def _scrub_sharded(store: ShardedStore, repair: bool,
                   report: ScrubReport) -> None:
    per_shard = parallel.scatter_parallel(
        lambda s: s.list_chunk_keys(), store.shards)
    for i, keys in enumerate(per_shard):
        astray = [k for k in keys if store.home(k) != i]
        report.misplaced += len(astray)
        for k in astray:
            report.details.append(f"shard {i} holds stray {k} "
                                  f"(home {store.home(k)})")
        if repair:
            for k in astray:
                try:        # stored form: compression survives the move
                    stored = store.shards[i].get_chunk_stored(k)
                except ChunkMissingError:
                    continue
                store.shards[store.home(k)].put_chunk(k, stored)
                store.shards[i].delete_chunk(k)
                report.repaired += 1


def _scrub_leaf_deep(store: ChunkStore, report: ScrubReport) -> None:
    keys = store.list_chunk_keys()
    for got in parallel.prefetch_map(
            lambda slab: store.get_chunks(slab, missing_ok=True),
            parallel.iter_slabs(keys, max(getattr(store, "min_slab", 1),
                                          32))):
        for k, data in got.items():
            if chunk_key(data) != k:
                report.corrupt += 1
                report.details.append(f"corrupt {k}")


def _scrub_walk(store: ChunkStore, repair: bool, deep: bool,
                report: ScrubReport) -> None:
    if isinstance(store, ReplicatedStore):
        _scrub_replicated(store, repair, report)
        for r in store.replicas:
            _scrub_walk(r, repair, deep, report)
    elif isinstance(store, ShardedStore):
        _scrub_sharded(store, repair, report)
        for s in store.shards:
            _scrub_walk(s, repair, deep, report)
    elif isinstance(store, TieredStore):
        _scrub_walk(store.cold, repair, deep, report)
    elif isinstance(store, (CompressedStore, FaultInjectedStore,
                            NamespacedStore)):
        _scrub_walk(store.inner, repair, deep, report)
    elif deep:
        _scrub_leaf_deep(store, report)


def scrub(store: ChunkStore, *, repair: bool = False,
          deep: bool = False) -> ScrubReport:
    """Walk a store composition checking fabric invariants.

    Replica sets: every replica holds every chunk (``repair`` copies from a
    live replica, in stored form).  Shard rings: every chunk sits on its
    ring home (``repair`` moves strays home).  With ``deep``, leaf stores
    are also content-address-verified (corruption is reported, not
    repaired — the healthy copy, if any, lives in an enclosing replica
    set).  ``chunks_checked`` reports *logical* chunks (counted once at the
    top of the composition, however many physical copies exist below)."""
    report = ScrubReport()
    _scrub_walk(store, repair, deep, report)
    report.chunks_checked = len(store.list_chunk_keys())
    return report


def rebalance(store: ChunkStore) -> Dict[str, int]:
    """Move every chunk of every shard ring in the composition to its ring
    home — run after editing a ``fabric://shard(...)`` spec (the ring is
    derived from the shard list, so adding/removing/reordering shards
    reassigns ~1/N of the keys).  Reads already self-heal strays one at a
    time; rebalance does the whole fleet in one pass."""
    moved = checked = 0

    def walk(s: ChunkStore) -> None:
        nonlocal moved, checked
        if isinstance(s, ShardedStore):
            rep = ScrubReport()
            _scrub_sharded(s, True, rep)
            moved += rep.repaired
            checked += len(s.list_chunk_keys())
            for child in s.shards:
                walk(child)
        elif isinstance(s, ReplicatedStore):
            for child in s.replicas:
                walk(child)
        elif isinstance(s, TieredStore):
            walk(s.cold)
        elif isinstance(s, (CompressedStore, FaultInjectedStore,
                            NamespacedStore)):
            walk(s.inner)

    walk(store)
    return {"chunks_checked": checked, "chunks_moved": moved}
