"""Chunk store keys computed where the bytes lie (``kernels/chunk_key``).

The plain version (numpy ``uint64``, vectorised over chunks) is held
against ``hashlib.blake2b(..., digest_size=16)``, which defines
``chunkstore.chunk_key``; the CUDA kernel is held against both in
``test_torch_cuda.py``.  The kernel cannot compile here, so its source's
constants and message schedule are read and compared with the plain
version's.  A staging ring whose key steps finish late, as a card's
launches may, is emulated on the CPU, so the ring's bookkeeping of the
digests — segments waiting for them, gaps in ``want``, the ragged last
chunk, bases parked until a commit's end — is checked without a card.
"""
import hashlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (KishuSession, MemoryStore,  # noqa: E402
                              staging)
from repro_torch.core.checkpoint import (WriteStats,  # noqa: E402
                                         build_manifest)
from repro_torch.core.chunkstore import chunk_key  # noqa: E402
from repro_torch.core.covariable import RecordBuilder  # noqa: E402
from repro_torch.core.namespace import Namespace  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels.chunk_key import ops  # noqa: E402

KIB, MIB = 1 << 10, 1 << 20
LENGTHS = [1, 3, 127, 128, 129, 255, 256, 16 * KIB, MIB - 4, MIB, MIB + 1]
CHUNKS = [16 * KIB, MIB]


def _gappy(n_chunks):
    """Every chunk but each third from the second, the last always."""
    return [i % 3 != 1 or i == n_chunks - 1 for i in range(n_chunks)]


@pytest.mark.parametrize("chunk_bytes", CHUNKS)
@pytest.mark.parametrize("length", LENGTHS)
def test_plain_digests_equal_hashlib(length, chunk_bytes):
    data = np.random.default_rng(length).integers(0, 256, length,
                                                  dtype=np.uint8).tobytes()
    n_chunks = -(-length // chunk_bytes)
    chunks = [data[i * chunk_bytes:(i + 1) * chunk_bytes]
              for i in range(n_chunks)]
    want = _gappy(n_chunks)
    got = ops.chunk_key_digests(torch.frombuffer(bytearray(data),
                                                 dtype=torch.uint8),
                                chunk_bytes, want)
    expect = [hashlib.blake2b(c, digest_size=16).digest()
              for c, w in zip(chunks, want) if w]
    assert got.dtype == np.uint8 and got.shape == (len(expect), 16)
    assert [row.tobytes() for row in got] == expect
    assert ops.hex_keys(got) == [chunk_key(c)
                                 for c, w in zip(chunks, want) if w]


def test_kernel_source_holds_the_plain_versions_constants():
    """The CUDA source's IV, parameter word, rotations and the 12 rounds'
    message schedule are the plain version's (RFC 7693)."""
    src = (_lib.CSRC / "chunk_key.cu").read_text()
    iv = [int(v, 16) for v in
          re.findall(r"kIV\d = (0x[0-9A-F]+)ULL;", src)]
    assert iv == [int(v) for v in ops.IV]
    assert "kParam0 = 0x01010000ULL | 16ULL" in src
    assert ops.PARAM0 == 0x01010000 | ops.DIGEST_BYTES
    rounds = [tuple(int(x) for x in m.split(","))
              for m in re.findall(r"^  KISHU_ROUND\(([\d, ]+)\);$", src,
                                  flags=re.M)]
    assert rounds == [ops.SIGMA[r % 10] for r in range(ops.ROUNDS)]
    assert re.findall(r"rotr64<(\d+)>\(", src)[:4] == ["32", "24", "16",
                                                       "63"]
    # the G functions' state words: the columns, then the diagonals
    gs = re.findall(r"KISHU_G\((v\d+), (v\d+), (v\d+), (v\d+), m\[s(\d+)\], "
                    r"m\[s(\d+)\]\)", src)
    rows = [tuple(int(v[1:]) for v in g[:4]) for g in gs]
    assert rows == [(k, 4 + k, 8 + k, 12 + k) for k in range(4)] + [
        tuple(int(i) for i in ops.DIAGONALS[[k, 4 + k, 8 + k, 12 + k]])
        for k in range(4)]
    assert [(int(g[4]), int(g[5])) for g in gs] == [(2 * k, 2 * k + 1)
                                                    for k in range(8)]


def test_wrapper_on_a_host_tensor():
    """Every chunk without a mask, the plain version's bytes; a mask of
    the wrong length and the CUDA entry on a host tensor raise."""
    data = np.random.default_rng(9).integers(0, 256, 4100, dtype=np.uint8)
    u8 = torch.from_numpy(data)
    got = ops.chunk_key_digests(u8, 1024)
    assert ops.hex_keys(got) == [chunk_key(data[i:i + 1024].tobytes())
                                 for i in range(0, 4100, 1024)]
    assert ops.chunk_key_digests(u8, 1024, [False] * 5).shape == (0, 16)
    with pytest.raises(ValueError, match="want has 3 entries"):
        ops.chunk_key_digests(u8, 1024, [True] * 3)
    with pytest.raises(ValueError, match="CUDA uint8"):
        ops.chunk_key_cuda(u8, 1024, torch.zeros(4, dtype=torch.int64))


class _Late:
    """A key step's event that reads as unfinished the first ``late``
    times it is asked, as a card's launch may."""

    def __init__(self, late):
        self.late, self.asked, self.waited = late, 0, False

    def query(self):
        self.asked += 1
        return self.waited or self.asked > self.late

    def synchronize(self):
        self.waited = True


class _CardKeyedRing(staging.StagingRing):
    """A CPU ring whose key steps finish late, as a card's launches may:
    filled segments wait for the digests, and within ``deferred`` a base
    whose digests are not there is parked while the next one streams."""

    def __init__(self, late=2):
        super().__init__("cpu")
        self.late = late
        self.events = []

    def _key(self, u8, chunk_bytes, idx):
        _, digests, stream = super()._key(u8, chunk_bytes, idx)
        self.events.append(_Late(self.late))
        return self.events[-1], digests, stream


CHUNK = 1024


@pytest.mark.parametrize("nbytes", [512, 4096, 5128, 41000])
def test_card_keyed_ring_lands_the_blob_paths_chunks(nbytes, monkeypatch):
    """Through a ring whose key steps finish late (each base then lands
    before ``stream`` returns): the manifest and the stored chunks equal
    the blob path's, first with every chunk fresh, then with
    every third chunk changed (the rest referenced, so ``want`` has gaps
    across the ring's segments and slots), and ``chunks_keyed_dev``
    counts the chunks the key step keyed."""
    monkeypatch.setattr(staging, "SEG_BYTES", 4 * CHUNK)
    raw = np.random.default_rng(nbytes).integers(0, 256, nbytes,
                                                 dtype=np.uint8)
    n_chunks = -(-nbytes // CHUNK)
    edited = raw.copy()
    edited[::3 * CHUNK] ^= 0xFF
    out = []
    for ring in (None, _CardKeyedRing()):
        store, prev, per = MemoryStore(), None, []
        for arr in (raw, edited):
            t = torch.from_numpy(arr.copy())
            rec = RecordBuilder(CHUNK).build("x", t, {})
            stats = WriteStats()
            prev = build_manifest(store, ("x",), [rec], Namespace({"x": t}),
                                  CHUNK, prev, stats, store.put_chunk,
                                  delta_ranges=False, ring=ring)
            per.append((prev, stats.chunks_keyed_dev, stats.chunks_reused))
        out.append((per, store.chunks))
    (blob, blob_chunks), (keyed, keyed_chunks) = out
    assert [m for m, _, _ in keyed] == [m for m, _, _ in blob]
    assert keyed_chunks == blob_chunks
    fresh = n_chunks - keyed[1][2]
    assert [k for _, k, _ in keyed] == [n_chunks, fresh]
    assert [k for _, k, _ in blob] == [0, 0]
    assert 0 < fresh < n_chunks or n_chunks == 1
    for c in keyed[1][0]["base"]["chunks"]:
        assert c["key"] == chunk_key(keyed_chunks[c["key"]])


def _bases(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8))
            for n in sizes]


def test_deferred_bases_land_in_order_when_it_closes(monkeypatch):
    """Within ``deferred``, bases whose key steps have not finished are
    parked: nothing lands while the next ones stream, and on leaving each
    lands, oldest first, with the key of its bytes; every key step was
    waited for.  Outside it, such a base lands before ``stream``
    returns."""
    monkeypatch.setattr(staging, "SEG_BYTES", 4 * CHUNK)
    bases = _bases([2 * CHUNK, 9 * CHUNK + 5, 300, 17 * CHUNK])
    wants = [[True] * -(-t.numel() // CHUNK) for t in bases]
    wants[3][5] = wants[3][6] = False
    ring = _CardKeyedRing(late=10 ** 9)
    got = []
    with ring.deferred():
        for k, (t, want) in enumerate(zip(bases, wants)):
            assert ring.stream(t, CHUNK, want,
                               lambda b, k=k: got.extend((k, *c) for c in b)
                               ) == sum(want)
            assert got == []
    expect = [(k, i, t[i * CHUNK:(i + 1) * CHUNK].numpy().tobytes())
              for k, (t, want) in enumerate(zip(bases, wants))
              for i in range(len(want)) if want[i]]
    assert [(k, i, bytes(out)) for k, i, out, _ in got] == expect
    assert [ck for *_, ck in got] == [chunk_key(b) for _, _, b in expect]
    assert all(e.waited for e in ring.events) and not ring._bases
    got.clear()
    ring.stream(bases[1], CHUNK, wants[1],
                lambda b: got.extend((1, *c) for c in b))
    assert len(got) == sum(wants[1]) and ring.events[-1].waited


def test_a_failed_deferred_landing_drops_the_parked_bases(monkeypatch):
    """A landing that raises when ``deferred`` closes propagates after
    every key step was waited for; nothing stays parked, and the ring
    then streams and lands the next base."""
    monkeypatch.setattr(staging, "SEG_BYTES", 4 * CHUNK)
    bases = _bases([6 * CHUNK, 3 * CHUNK, 5 * CHUNK], seed=1)
    ring = _CardKeyedRing(late=10 ** 9)
    landed = []

    def land(batch):
        landed.extend(batch)
        if len(landed) > 7:
            raise OSError("injected landing failure")

    with pytest.raises(OSError, match="injected"):
        with ring.deferred():
            for t in bases:
                ring.stream(t, CHUNK, [True] * -(-t.numel() // CHUNK), land)
    assert all(e.waited for e in ring.events) and not ring._bases
    landed.clear()
    with ring.deferred():
        ring.stream(bases[2], CHUNK, [True] * 5, landed.extend)
    assert [ck for _, _, ck in landed] == [
        chunk_key(bases[2][i * CHUNK:(i + 1) * CHUNK].numpy().tobytes())
        for i in range(5)]


def test_a_commit_parks_its_bases_until_serialize_ends(monkeypatch):
    """A session whose writer's ring keys late: every base of a commit is
    parked until the end of ``serialize``, and the stored chunks and the
    write counts equal those of the blob path.  The parked bases' wait
    for their keys is a ``chunk_keys`` span in a ``write_whole`` span in
    ``serialize``, beside the bases' own ``write_whole`` spans."""
    monkeypatch.setattr(staging, "SEG_BYTES", 4 * CHUNK)
    sizes = [2 * CHUNK, 2 * CHUNK, 700, 11 * CHUNK + 3]
    out = []
    for ring in (None, _CardKeyedRing(late=10 ** 9)):
        sess = KishuSession(MemoryStore(), chunk_bytes=CHUNK, device="cpu",
                            trace=True)
        if ring is not None:
            sess.writer.ring = ring

        def init(ns):
            for k, t in enumerate(_bases(sizes, seed=5)):
                ns[f"v{k}"] = t.clone()

        sess.register("init", init)
        sess.init_state({})
        sess.run("init")
        w = sess.last_run.write
        out.append((sess.store.chunks, w.chunks_written, w.chunks_keyed_dev,
                    list(sess.obs.tracer.spans)))
        sess.close()
    (c0, n0, k0, _), (c1, n1, k1, spans) = out
    assert c1 == c0 and n1 == n0 == sum(-(-n // CHUNK) for n in sizes)
    assert (k0, k1) == (0, n1)
    ser = max((s for s in spans if s.name == "serialize"),
              key=lambda s: s.t0_s)                  # the cell's commit
    whole = [s for s in spans
             if s.name == "write_whole" and s.parent_id == ser.span_id]
    assert len(whole) == len(sizes) + 1
    tail = max(whole, key=lambda s: s.t0_s)      # the parked bases' landing
    waits = [s for s in spans
             if s.name == "chunk_keys" and s.parent_id == tail.span_id]
    assert len(waits) == len(sizes)
    assert all(e.waited for e in ring.events)
