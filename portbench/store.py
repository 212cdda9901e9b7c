"""A store wrapper that counts the bytes handed to every write method of
the Kishu store interface: chunk puts (raw and stored form, one or many)
and metadata documents (their JSON text).  The session's writer puts only
chunks the store lacks, so the count is what the store takes in.  Every
other operation passes through untouched."""
from __future__ import annotations

import json


def _doc_bytes(doc) -> int:
    return len(json.dumps(doc).encode())


class CountingStore:
    """Wraps a ``ChunkStore``; ``written`` counts chunk and metadata
    bytes since construction or the last :meth:`reset`."""

    def __init__(self, inner):
        self.inner = inner
        self.written = 0

    def reset(self) -> None:
        self.written = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def put_chunk(self, key, data):
        wrote = self.inner.put_chunk(key, data)
        self.written += len(data) if wrote else 0
        return wrote

    def put_chunk_stored(self, key, data):
        wrote = self.inner.put_chunk_stored(key, data)
        self.written += len(data) if wrote else 0
        return wrote

    def put_chunks(self, pairs):
        pairs = list(pairs)
        self.written += sum(len(d) for _, d in pairs)
        return self.inner.put_chunks(pairs)

    def put_chunks_stored(self, pairs):
        pairs = list(pairs)
        self.written += sum(len(d) for _, d in pairs)
        return self.inner.put_chunks_stored(pairs)

    def put_meta(self, name, doc):
        self.written += _doc_bytes(doc)
        return self.inner.put_meta(name, doc)

    def put_meta_batch(self, docs):
        self.written += sum(_doc_bytes(d) for d in docs.values())
        return self.inner.put_meta_batch(docs)
