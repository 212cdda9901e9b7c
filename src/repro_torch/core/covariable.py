"""Co-variables and LeafRecords — Definitions 1–2 adapted to array states.

A *co-variable* is a maximal set of names whose leaves share an underlying
buffer (weight tying, tensor or numpy views, duplicated references) — for
tensors, one storage.  It is the minimum
unit that can be stored/loaded without silently breaking shared references —
restoring a tied ``embed``/``lm_head`` pair as two independent arrays unties
the model (DESIGN.md §2).

A :class:`LeafRecord` is the VarGraph analogue for one name:
  - structure: dtype/shape (+ view spec relative to the alias base)
  - identity:  alias key (which base buffer the leaf points into: the
               storage address of a tensor, ``id()`` of a numpy base)
  - content:   per-chunk detection hashes of the *base* buffer

Update detection (Def 2) compares records before/after a command:
  node change  = base content hash diff
  edge change  = alias key / view-spec diff (split & merge)
  structure    = dtype/shape diff
"""
from __future__ import annotations

import pickle
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core.serialize import (OpaqueLeaf, alias_key, base_of,
                                        global_image,
                                        dtype_name, is_array_leaf,
                                        leaf_nbytes, tensor_to_bytes,
                                        view_spec)

CovKey = Tuple[str, ...]


def cov_key(names: Sequence[str]) -> CovKey:
    return tuple(sorted(names))


@dataclass
class LeafRecord:
    name: str
    kind: str                        # "array" | "prng" | "object" | "opaque"
    dtype: str = ""
    shape: Tuple[int, ...] = ()
    nbytes: int = 0
    alias_id: int = 0                # alias key of the base buffer
                                     # (session-local; serialize.alias_key)
    view: Optional[dict] = None      # strided-view spec relative to base
    base_hashes: Optional[np.ndarray] = None  # uint64 [n_chunks] of base
    obj_digest: Optional[bytes] = None        # for small "object" leaves

    def content_equal(self, other: "LeafRecord") -> bool:
        """Value-level equality (ignores alias identity)."""
        if self.kind != other.kind:
            return False
        if self.kind == "opaque":
            return False                      # conservative: updated on access
        if (self.dtype, self.shape, self.view) != \
                (other.dtype, other.shape, other.view):
            return False
        if self.kind == "object":
            return self.obj_digest == other.obj_digest
        if self.base_hashes is None or other.base_hashes is None:
            return False
        return (self.base_hashes.shape == other.base_hashes.shape
                and bool(np.array_equal(self.base_hashes, other.base_hashes)))


class RecordBuilder:
    """Builds LeafRecords with a per-call base-hash cache so aliased members
    hash their shared base exactly once."""

    def __init__(self, chunk_bytes: int = hashing.DEFAULT_CHUNK_BYTES,
                 hasher=None):
        self.chunk_bytes = chunk_bytes
        self.hasher = hasher or hashing.chunk_hashes_np
        self.hash_calls = 0
        self.hashed_bytes = 0
        # fused-path handoff (DESIGN.md §15): alias key of the base ->
        # DeltaPack built during detection; the checkpoint writer reads the
        # dirty chunks from the pack's compacted device rows instead of
        # re-slicing the tensor.  Cleared at the start of every
        # detect_delta — storage addresses are only stable while the bases
        # live in the namespace.
        self.packs: Dict[int, Any] = {}

    def _hash_base(self, base: Any, cache: Dict[int, np.ndarray],
                   prev_hashes: Optional[np.ndarray] = None) -> np.ndarray:
        key = alias_key(base)
        if key in cache:
            return cache[key]
        base = global_image(base)          # a DTensor hashes its global image
        if self.hasher is hashing.chunk_hashes_np \
                and isinstance(base, torch.Tensor):
            from repro_torch.core import delta as delta_mod
            # fused path: one pass yields hashes AND the compacted dirty
            # chunks (the writer consumes the pack; detection moves 12
            # bytes/chunk to the host instead of the buffer)
            pack = delta_mod.device_delta_pack(base, prev_hashes,
                                               self.chunk_bytes)
            if pack is not None:
                self.packs[key] = pack
                self.hash_calls += 1
                self.hashed_bytes += pack.nbytes
                cache[key] = pack.hashes
                return pack.hashes
            # no previous hashes to diff against: hash where the tensor
            # lies (the chunk_hash kernel on a card), so detection does not
            # move the buffer to the host; None -> host path below
            h = hashing.chunk_hashes_device(base, self.chunk_bytes)
            if h is not None:
                self.hash_calls += 1
                self.hashed_bytes += leaf_nbytes(base)
                cache[key] = h
                return h
        if isinstance(base, torch.Tensor):
            raw = tensor_to_bytes(base)
            h = self.hasher(raw, self.chunk_bytes)
            nbytes = len(raw)
        else:
            arr = np.asarray(base)
            if not arr.flags["C_CONTIGUOUS"]:
                arr = np.ascontiguousarray(arr)
            h = self.hasher(arr.reshape(-1).view(np.uint8) if arr.ndim else
                            arr.tobytes(), self.chunk_bytes)
            nbytes = arr.nbytes
        self.hash_calls += 1
        self.hashed_bytes += nbytes
        cache[key] = h
        return h

    def build(self, name: str, leaf: Any,
              cache: Optional[Dict[int, np.ndarray]] = None,
              prev: Optional[LeafRecord] = None) -> LeafRecord:
        cache = cache if cache is not None else {}
        if isinstance(leaf, OpaqueLeaf):
            return LeafRecord(name=name, kind="opaque", alias_id=id(leaf))
        if is_array_leaf(leaf):
            base = base_of(leaf)
            # previous commit's hashes of this name (the name, not the
            # storage, keys this — a cell may rebind a name to a new
            # tensor) seed the fused hash+diff+compact pass
            prev_hashes = prev.base_hashes \
                if prev is not None and prev.kind == "array" else None
            return LeafRecord(
                name=name, kind="array", dtype=dtype_name(leaf.dtype),
                shape=tuple(leaf.shape), nbytes=leaf_nbytes(leaf),
                alias_id=alias_key(base), view=view_spec(leaf, base),
                base_hashes=self._hash_base(base, cache, prev_hashes))
        # small python object
        try:
            blob = pickle.dumps(leaf)
            import hashlib
            dig = hashlib.blake2b(blob, digest_size=16).digest()
            return LeafRecord(name=name, kind="object",
                              dtype=type(leaf).__name__, nbytes=len(blob),
                              alias_id=id(leaf), obj_digest=dig)
        except Exception:  # noqa: BLE001 — unpicklable object == opaque
            return LeafRecord(name=name, kind="opaque", alias_id=id(leaf))


def group_covariables(records: Dict[str, LeafRecord]) -> Dict[CovKey, List[str]]:
    """Connected components under shared base buffers (Def 1)."""
    by_alias: Dict[int, List[str]] = {}
    for name, rec in records.items():
        by_alias.setdefault(rec.alias_id, []).append(name)
    return {cov_key(names): sorted(names) for names in by_alias.values()}


@dataclass
class StateDelta:
    """Result of delta detection for one command execution (Def 2)."""
    updated: Dict[CovKey, List[LeafRecord]] = field(default_factory=dict)
    deleted: List[CovKey] = field(default_factory=list)
    unchanged_accessed: List[CovKey] = field(default_factory=list)
    candidates: List[CovKey] = field(default_factory=list)  # pre-state covs accessed
    checked: int = 0                 # co-variables actually inspected
    skipped: int = 0                 # pruned by Lemma 1


def detect_delta(prev_records: Dict[str, LeafRecord],
                 prev_covs: Dict[CovKey, List[str]],
                 ns, accessed: Set[str],
                 builder: RecordBuilder) -> Tuple[StateDelta, Dict[str, LeafRecord]]:
    """Compute the state delta at co-variable granularity.

    Only co-variables intersecting ``accessed`` (plus created names) are
    inspected — Lemma 1.  Returns (delta, new full record map).
    """
    cur_names = set(ns.names())
    prev_names = set(prev_records)
    created = cur_names - prev_names
    removed = prev_names - cur_names

    # candidate co-variables: any member accessed / removed
    touched = set(accessed) | created | removed
    candidates: List[CovKey] = []
    candidate_names: Set[str] = set(created)
    for key, members in prev_covs.items():
        if any(m in touched for m in members):
            candidates.append(key)
            candidate_names.update(members)
    delta = StateDelta(skipped=len(prev_covs) - len(candidates),
                       candidates=list(candidates))

    # rebuild records for candidate names only
    new_records: Dict[str, LeafRecord] = {}
    hash_cache: Dict[int, np.ndarray] = {}
    builder.packs.clear()           # packs are one-commit artifacts
    for name in sorted(candidate_names):
        if name in cur_names:
            new_records[name] = builder.build(name, ns[name], hash_cache,
                                              prev=prev_records.get(name))

    new_groups = group_covariables(new_records)
    delta.checked = len(new_groups)

    # full record map: unchanged names keep their old record
    full = {n: r for n, r in prev_records.items()
            if n not in candidate_names and n in cur_names}
    full.update(new_records)

    old_candidate_keys = set(candidates)
    for key, members in new_groups.items():
        if key in old_candidate_keys:
            same = all(
                m in prev_records
                and new_records[m].content_equal(prev_records[m])
                for m in members)
            if same:
                delta.unchanged_accessed.append(key)
                continue
        delta.updated[key] = [new_records[m] for m in members]

    # deletions: candidate covs whose exact membership no longer exists
    for key in candidates:
        if key not in new_groups:
            delta.deleted.append(key)
    return delta, full
