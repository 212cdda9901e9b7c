"""Fallback recomputation — the Data Restorer (§5.3).

A versioned co-variable (X, t) that was never stored (unserializable) or
fails to load (missing/corrupt chunks) is reconstructed by
  1. loading the versioned co-variables the commit *accessed* (its recorded
     dependencies) into a temporary namespace — recursively restoring any of
     *those* that are themselves missing (dynamic & recursive fallback), and
  2. re-running the recorded command on that namespace.

Determinism comes from the substrate: commands draw randomness from RNG-key
leaves *inside* the namespace and data from versioned iterator state, so a
replay sees bit-identical inputs (the paper's caveat about non-deterministic
cells — §5.3 Remark — is discharged by construction here; cf. DESIGN.md §2).

Replayed namespaces are memoized per checkout so a commit shared by several
co-variables (or a chain of det-replay commits) runs once.  The memo is
byte-bounded ($KISHU_RESTORE_MEMO_BYTES, default 256 MiB): deep checkouts
evict the least-recently-used replayed namespace instead of holding every
intermediate state alive.  A memoized version missing some requested names
(co-variable regrouping between commits) is topped up from the commit's own
state index instead of re-restoring every dependency and re-running the
command — a deterministic replay cannot produce names it didn't produce the
first time.

A replay of ``__attach__`` is checked against the commit.  An attach
re-inserts the objects the caller handed in, and unlike the JAX package's
arrays, tensors and numpy arrays can have been changed in place since.  So
every array value of the requested co-variable is hashed again at the
commit's chunk size (the ``chunk_hash`` kernel on a card, the plain hash on
the CPU) and compared with the manifest's detection hashes (or, where a
manifest has none, its chunk keys); a difference raises
:class:`RestoreError` naming the co-variable and the first differing
chunk.  A value that is not an array cannot be checked this way and is
restored as before.
"""
from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core.chunkstore import chunk_keys
from repro_torch.core.covariable import CovKey
from repro_torch.core.graph import CheckpointGraph, parse_key
from repro_torch.core.namespace import Namespace, TrackedNamespace
from repro_torch.core.serialize import (base_of, dtype_name, leaf_to_bytes,
                                        tensor_to_bytes)

DEFAULT_MEMO_BYTES = 256 << 20


def resolve_memo_bytes(n: Optional[int] = None) -> int:
    """Effective replay-memo capacity: explicit arg >
    $KISHU_RESTORE_MEMO_BYTES > 256 MiB.  ``0`` keeps only the most
    recently replayed namespace (the minimum needed for correctness of
    multi-cov extraction from one commit)."""
    if n is None:
        env = os.environ.get("KISHU_RESTORE_MEMO_BYTES", "").strip()
        try:
            n = int(env) if env else DEFAULT_MEMO_BYTES
        except ValueError:
            n = DEFAULT_MEMO_BYTES
    return max(0, int(n))


class RestoreError(Exception):
    pass


def _value_nbytes(val: Any) -> int:
    """Rough per-value footprint for the memo bound (arrays dominate)."""
    n = getattr(val, "nbytes", None)
    if isinstance(n, (int, np.integer)):
        return int(n)
    return 64


def _ns_nbytes(ns: Namespace) -> int:
    return sum(_value_nbytes(ns[name]) for name in ns.names())


def _base_hashes(base: Any, chunk_bytes: int) -> np.ndarray:
    """Detection hashes of an array base, as ``RecordBuilder`` takes them:
    where a tensor lies (the kernel on a card), else on the host."""
    if isinstance(base, torch.Tensor):
        h = hashing.chunk_hashes_device(base, chunk_bytes)
        if h is not None:
            return h
        return hashing.chunk_hashes_np(tensor_to_bytes(base), chunk_bytes)
    arr = np.ascontiguousarray(base)
    return hashing.chunk_hashes_np(
        arr.reshape(-1).view(np.uint8) if arr.ndim else arr.tobytes(),
        chunk_bytes)


def check_against_manifest(key: CovKey, version: str, manifest: Optional[dict],
                           values: Dict[str, Any]) -> None:
    """Raise :class:`RestoreError` unless the array base of ``values``
    (the co-variable ``key`` as a replay produced it) holds the bytes the
    commit's manifest recorded: its dtype, shape and size, then its
    detection hashes at the commit's chunk size, or its chunk keys where
    the manifest has no hashes.  Values that are not arrays, and manifests
    of unserializable co-variables, pass unchecked."""
    if not manifest or manifest.get("unserializable") \
            or not manifest.get("members"):
        return
    val = values.get(manifest["members"][0]["name"])
    if not isinstance(val, (np.ndarray, torch.Tensor)):
        return
    base = base_of(val)
    doc = manifest["base"]
    meta = doc.get("meta", {})
    got_meta = (dtype_name(base.dtype), list(base.shape))
    if got_meta != (meta.get("dtype"), meta.get("shape")) \
            or base.nbytes != doc["nbytes"]:
        raise RestoreError(
            f"replayed {key} @ {version} is {got_meta}, {base.nbytes} "
            f"bytes; the commit recorded {meta.get('dtype')} "
            f"{meta.get('shape')}, {doc['nbytes']} bytes")
    chunks = doc.get("chunks", [])
    want = doc.get("det_hashes") or []
    if want:
        # a single chunk hashes alike at any chunk size that covers it
        cb = int(chunks[0]["n"]) if len(chunks) > 1 \
            else 1 << max(2, (max(base.nbytes, 1) - 1).bit_length())
        got = hashing.hashes_hex(_base_hashes(base, cb))
    else:
        blob, _ = leaf_to_bytes(base)
        view, lo, bufs = memoryview(blob), 0, []
        for c in chunks:
            bufs.append(view[lo:lo + int(c["n"])])
            lo += int(c["n"])
        got, want = chunk_keys(bufs), [c["key"] for c in chunks]
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            raise RestoreError(
                f"replayed {key} @ {version} differs from the commit at "
                f"chunk {i} of {len(want)}: a value handed to the attach "
                f"was changed in place since")
    if len(got) != len(want):
        raise RestoreError(f"replayed {key} @ {version} has {len(got)} "
                           f"chunks; the commit recorded {len(want)}")


def _replay_copy(val: Any) -> Any:
    """Defensive copy when a memoized replay value feeds another replay's
    namespace: the consuming command may mutate it in place, and the memo
    must keep serving the recorded version's bytes.  numpy arrays and torch
    tensors copy (both are mutable); opaque objects pass through (the
    substrate's determinism contract covers them)."""
    if isinstance(val, np.ndarray):
        return val.copy()
    if isinstance(val, torch.Tensor):
        return val.clone()
    return val


class DataRestorer:
    def __init__(self, graph: CheckpointGraph, loader,
                 registry: Dict[str, Callable], *, max_depth: int = 64,
                 memo_bytes: Optional[int] = None):
        self.graph = graph
        self.loader = loader            # StateLoader (for dependency loads)
        self.registry = registry
        self.max_depth = max_depth
        self.replays = 0
        self.memo_bytes = resolve_memo_bytes(memo_bytes)
        # per-checkout replay memo: version -> replayed namespace (LRU over
        # approximate bytes). Restoring several co-variables of the same
        # commit (or a chain of det-replay commits) re-runs each command
        # once, not once per co-variable — the ARIES-style redo-caching the
        # paper defers to future work (§7.5.2).
        self._memo: "OrderedDict[str, Namespace]" = OrderedDict()
        self._memo_sizes: Dict[str, int] = {}
        # co-variables already counted into stats.covs_recomputed this
        # checkout: the counter means "co-variables restored via replay",
        # exactly once per (version, cov) regardless of recursion shape
        self._counted: Set[Tuple[str, CovKey]] = set()

    def clear_memo(self) -> None:
        self._memo.clear()
        self._memo_sizes.clear()
        self._counted.clear()

    # ------------------------------------------------------------------
    # memo bookkeeping
    # ------------------------------------------------------------------
    def _memo_put(self, version: str, temp: Namespace) -> None:
        self._memo.pop(version, None)
        self._memo[version] = temp
        self._memo_sizes[version] = _ns_nbytes(temp)
        total = sum(self._memo_sizes.values())
        while total > self.memo_bytes and len(self._memo) > 1:
            old, _ = self._memo.popitem(last=False)
            total -= self._memo_sizes.pop(old, 0)

    def _count(self, key: CovKey, version: str, stats) -> None:
        if stats is None:
            return
        mark = (version, key)
        if mark not in self._counted:
            self._counted.add(mark)
            stats.covs_recomputed += 1

    # ------------------------------------------------------------------
    # recomputation
    # ------------------------------------------------------------------
    def recompute(self, key: CovKey, version: str, stats=None,
                  _depth: int = 0) -> Dict[str, Any]:
        if _depth > self.max_depth:
            raise RestoreError(f"recursion limit restoring {key} @ {version}")
        node = self.graph.nodes[version]
        cmd = node.command
        if cmd["name"] == "__init__":
            raise RestoreError(f"cannot recompute {key}: created at root")
        fn = self.registry.get(cmd["name"])
        if fn is None:
            raise RestoreError(f"command {cmd['name']!r} not registered")

        temp = self._memo.get(version)
        if temp is not None:
            self._memo.move_to_end(version)
            missing = [n for n in key if n not in temp]
            if missing:
                # partial hit: the replay ran but this request names values
                # it didn't produce (co-variable regrouping). Re-running is
                # futile — deterministic replay yields the same namespace —
                # so top up only the missing names from the commit's state
                # index.  RestoreError below if the index lacks them too.
                self._top_up(node, temp, missing, stats, _depth)
                missing = [n for n in key if n not in temp]
            if not missing:
                return self._extract(key, version, cmd, temp, stats)
            raise RestoreError(
                f"replay of {cmd['name']} did not produce {missing}")

        # 1. restore dependencies (recursively if needed).  Dependencies
        #    that are loadable arrive through the parallel chunk engine in
        #    one prefetched pass (use_fallback=False: recursion depth is
        #    bookkept here, not inside the loader); only the unavailable
        #    remainder recurses into replay.
        temp = Namespace()
        dep_items = [(parse_key(s), v) for s, v in node.accessed.items()]
        prefetched = self.loader.load_covs(dep_items, stats,
                                           use_fallback=False)
        for dep_key, dep_version in dep_items:
            values = prefetched.get(dep_key)
            if values is None:
                values = self.recompute(dep_key, dep_version, stats,
                                        _depth + 1)
                # replay-produced values alias the child memo's namespace;
                # copy before this command can mutate them in place
                values = {n: _replay_copy(v) for n, v in values.items()}
            for name, val in values.items():
                temp[name] = val

        # 2. re-run the recorded command
        tns = TrackedNamespace(temp)
        fn(tns, **cmd.get("args", {}))
        self.replays += 1
        node.stats["replays"] = int(node.stats.get("replays", 0) or 0) + 1
        self._memo_put(version, temp)

        # 3. extract the requested co-variable (membership may be verified
        #    against the recomputed aliasing)
        missing = [n for n in key if n not in temp]
        if missing:
            raise RestoreError(
                f"replay of {cmd['name']} did not produce {missing}")
        return self._extract(key, version, cmd, temp, stats)

    def _extract(self, key: CovKey, version: str, cmd: dict,
                 temp: Namespace, stats) -> Dict[str, Any]:
        """The requested co-variable out of a replayed namespace; a replayed
        ``__attach__`` is first checked against the commit."""
        values = {n: temp[n] for n in key}
        if cmd["name"] == "__attach__":
            check_against_manifest(key, version,
                                   self.graph.manifest_of(key, version),
                                   values)
        self._count(key, version, stats)
        return values

    def _top_up(self, node, temp: Namespace, missing: List[str], stats,
                _depth: int) -> None:
        """Load the co-variables owning ``missing`` names (at the commit's
        own state index) into a memoized namespace."""
        wanted: Dict[Tuple[CovKey, str], None] = {}
        for ks, ver in node.state_index.items():
            cov = parse_key(ks)
            if any(n in missing for n in cov):
                wanted[(cov, ver)] = None
        items = list(wanted)
        got = self.loader.load_covs(items, stats, use_fallback=False)
        for cov, ver in items:
            values = got.get(cov)
            if values is None:
                try:
                    values = self.recompute(cov, ver, stats, _depth + 1)
                except RestoreError:
                    continue            # caller reports what's still missing
                values = {n: _replay_copy(v) for n, v in values.items()}
            for name, val in values.items():
                if name not in temp:
                    temp[name] = val
