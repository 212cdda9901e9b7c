"""Baselines from the paper's evaluation (§7.1), reimplemented on the same
storage substrate for apples-to-apples benchmarks:

- :class:`DumpSession`     — application-level whole-state serialization
  (dill.dump_session / ForkIt analogue): one blob per commit, checkout loads
  the entire blob.
- :class:`PageIncremental` — CRIU-Incremental analogue: the state is
  serialized to one contiguous "memory image"; commits store only 4 KiB pages
  that differ *positionally* from the parent commit's image.  Fragmentation
  and offset shifts dirty many pages (the paper's §2.3 criticism), and
  checkout must piece the full image back together (no incremental restore).
- :class:`DetReplay`       — Kishu+Det-replay (§7.1): commands annotated
  deterministic skip checkpointing entirely; checkout replays them, which can
  be catastrophically slow for expensive cells (§7.5.2).

Each baseline restores device-array leaves (torch tensors) onto an explicit
``device``: the card unless the caller names the CPU, as a session does.
Blobs and pages hold the same bytes the JAX package's baselines write.
"""
from __future__ import annotations

import io
import pickle
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set, Tuple, Union

import torch

from repro_torch.core.chunkstore import ChunkStore, chunk_key
from repro_torch.core.namespace import Namespace
from repro_torch.core.serialize import (SerializationError, leaf_from_bytes,
                                        leaf_to_bytes)
from repro_torch.core.session import KishuSession, resolve_device


@dataclass
class BaselineStats:
    ckpt_s: float = 0.0
    bytes_written: int = 0
    checkout_s: float = 0.0
    bytes_loaded: int = 0
    failed: bool = False
    fail_reason: str = ""


def _state_blob(ns: Namespace) -> bytes:
    """Serialize the whole namespace into one deterministic byte image."""
    out = io.BytesIO()
    index = []
    for name in ns.names():
        data, meta = leaf_to_bytes(ns[name])       # raises for opaque leaves
        index.append((name, meta, len(data)))
        out.write(data)
    blob = out.getvalue()
    header = pickle.dumps(index)
    return len(header).to_bytes(8, "little") + header + blob


def _state_from_blob(blob: bytes, device: torch.device) -> Dict[str, Any]:
    hlen = int.from_bytes(blob[:8], "little")
    index = pickle.loads(blob[8:8 + hlen])
    off = 8 + hlen
    view = memoryview(blob)
    out = {}
    for name, meta, n in index:
        out[name] = leaf_from_bytes(view[off:off + n], meta, device=device)
        off += n
    return out


class DumpSession:
    """Whole-state dump per commit (dill.dump_session analogue)."""

    def __init__(self, store: ChunkStore, *,
                 device: Union[str, torch.device, None] = None):
        self.store = store
        self.device = resolve_device(device)
        self.commits: List[str] = []
        self.stats: List[BaselineStats] = []

    def checkpoint(self, ns: Namespace, tag: str) -> BaselineStats:
        st = BaselineStats()
        t0 = time.perf_counter()
        try:
            blob = _state_blob(ns)
        except SerializationError as e:
            st.failed, st.fail_reason = True, str(e)
            self.stats.append(st)
            return st
        key = f"dump/{tag}"
        self.store.put_chunk(chunk_key(key.encode()) , blob)
        self.store.put_meta(key, {"chunk": chunk_key(key.encode()),
                                  "nbytes": len(blob)})
        st.bytes_written = len(blob)
        st.ckpt_s = time.perf_counter() - t0
        self.commits.append(tag)
        self.stats.append(st)
        return st

    def checkout(self, ns: Namespace, tag: str) -> BaselineStats:
        st = BaselineStats()
        t0 = time.perf_counter()
        meta = self.store.get_meta(f"dump/{tag}")
        blob = self.store.get_chunk(meta["chunk"])
        st.bytes_loaded = len(blob)
        values = _state_from_blob(blob, self.device)
        for name in list(ns.names()):
            del ns[name]
        for name, v in values.items():
            ns[name] = v
        st.checkout_s = time.perf_counter() - t0
        return st


PAGE = 4096


class PageIncremental:
    """CRIU-Incremental analogue: positional 4 KiB dirty-page deltas."""

    def __init__(self, store: ChunkStore, *,
                 device: Union[str, torch.device, None] = None):
        self.store = store
        self.device = resolve_device(device)
        self._images: Dict[str, Tuple[str, List[Optional[str]]]] = {}
        # tag -> (parent_tag, per-page chunk key or None==inherit)
        self._sizes: Dict[str, int] = {}
        self.stats: List[BaselineStats] = []

    def _pages(self, blob: bytes) -> List[bytes]:
        return [blob[i:i + PAGE] for i in range(0, len(blob), PAGE)]

    def _resolve(self, tag: str) -> List[str]:
        """Full per-page chunk-key list for a commit (piecing together)."""
        chain = []
        t: Optional[str] = tag
        while t is not None:
            parent, pages = self._images[t]
            chain.append(pages)
            t = parent
        n = max(len(p) for p in chain)
        out: List[Optional[str]] = [None] * n
        for pages in chain:                       # newest first
            for i, k in enumerate(pages):
                if out[i] is None and k is not None:
                    out[i] = k
        return [k for k in out if k is not None]

    def checkpoint(self, ns: Namespace, tag: str,
                   parent: Optional[str]) -> BaselineStats:
        st = BaselineStats()
        t0 = time.perf_counter()
        try:
            blob = _state_blob(ns)
        except SerializationError as e:
            st.failed, st.fail_reason = True, str(e)
            self.stats.append(st)
            return st
        pages = self._pages(blob)
        prev_keys: List[Optional[str]] = []
        if parent is not None:
            full = self._resolve(parent)
            prev_keys = list(full)
        entry: List[Optional[str]] = []
        for i, page in enumerate(pages):
            k = chunk_key(page)
            if i < len(prev_keys) and prev_keys[i] == k:
                entry.append(None)                 # clean page: inherit
            else:
                if not self.store.has_chunk(k):
                    self.store.put_chunk(k, page)
                    st.bytes_written += len(page)
                entry.append(k)
        # store full keys for truncation correctness
        if parent is not None and len(pages) < len(prev_keys):
            pass                                   # shorter image: ignore tail
        self._images[tag] = (parent, entry)
        self._sizes[tag] = len(blob)
        st.ckpt_s = time.perf_counter() - t0
        self.stats.append(st)
        return st

    def checkout(self, ns: Namespace, tag: str) -> BaselineStats:
        """Non-incremental restore: reassemble the whole image."""
        st = BaselineStats()
        t0 = time.perf_counter()
        keys = self._resolve(tag)
        blob = b"".join(self.store.get_chunk(k) for k in keys)
        blob = blob[:self._sizes[tag]]
        st.bytes_loaded = len(blob)
        values = _state_from_blob(blob, self.device)
        for name in list(ns.names()):
            del ns[name]
        for name, v in values.items():
            ns[name] = v
        st.checkout_s = time.perf_counter() - t0
        return st


class DetReplaySession(KishuSession):
    """Kishu+Det-replay: commands registered with ``deterministic=True`` skip
    delta checkpointing; their co-variables restore via fallback replay.
    ``device`` (a keyword) goes to :class:`KishuSession` as it is."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.deterministic: Set[str] = set()

    def register(self, name: str, fn: Callable,
                 deterministic: bool = False) -> None:
        super().register(name, fn)
        if deterministic:
            self.deterministic.add(name)

    def run(self, command: str, _message: str = "", **args) -> str:
        name = command
        if name not in self.deterministic:
            return super().run(name, _message=_message, **args)
        # Execute + track + detect, but store NO chunk data: the commit
        # records the delta membership with unserializable-style manifests,
        # forcing checkout to replay this command.
        saved_writer_write = self.writer.write_delta

        def _skip_write(delta, ns, prev_of, packs=None):
            from repro_torch.core.checkpoint import WriteStats
            from repro_torch.core.graph import key_str as ks
            manifests = {}
            for key, records in delta.updated.items():
                members = [{"name": r.name, "kind": r.kind, "dtype": r.dtype,
                            "shape": list(r.shape), "view": r.view,
                            "nbytes": r.nbytes} for r in records]
                manifests[ks(key)] = {"members": members,
                                      "unserializable": True,
                                      "det_skipped": True}
            return manifests, WriteStats()

        self.writer.write_delta = _skip_write
        try:
            return super().run(name, _message=_message, **args)
        finally:
            self.writer.write_delta = saved_writer_write
