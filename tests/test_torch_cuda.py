"""The port's CUDA kernels on the card, held bit for bit against their plain
torch versions — and a CUDA session against a CPU session.

Needs an NVIDIA card (sm_90a) and nvcc; every test skips without them.  On
the card: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
The card's machine has no JAX, so this file holds the port against itself;
the plain versions are held against the JAX package in
``test_torch_kernels_plain.py``.
"""
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _tensor(dtype, n, dev, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    if dtype == torch.uint8:
        t = torch.randint(0, 256, (n,), generator=g, dtype=torch.uint8)
    elif dtype == torch.int32:
        t = torch.randint(-2**31, 2**31 - 1, (n,), generator=g,
                          dtype=torch.int32)
    else:
        t = torch.randn(n, generator=g).to(dtype)
    return t.to(dev)


CASES = [(torch.float32, 300_001), (torch.bfloat16, 77_777),
         (torch.uint8, 1_000_003), (torch.int32, 5), (torch.float16, 4096)]


@pytest.mark.parametrize("dtype,n", CASES)
@pytest.mark.parametrize("cb", [4096, 1 << 20])
@pytest.mark.parametrize("offset", [0, 1])
def test_chunk_hash_kernel_matches_plain(dev, dtype, n, cb, offset):
    from repro_torch.core.hashing import chunk_hashes_plain
    from repro_torch.kernels.chunk_hash.ops import chunk_hash_cuda
    t = _tensor(dtype, n + offset, dev)[offset:]     # unaligned base too
    u8 = t.view(torch.uint8)
    got = chunk_hash_cuda(u8, cb).to(torch.int64) & 0xFFFFFFFF
    want = chunk_hashes_plain(u8, cb)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,n", CASES)
@pytest.mark.parametrize("cb", [4096, 65536])
def test_delta_pack_kernel_matches_plain(dev, dtype, n, cb):
    from repro_torch.core.hashing import chunk_hashes_plain
    from repro_torch.kernels.delta_codec.ops import i32_bits
    from repro_torch.kernels.delta_pack.ops import (delta_pack_cuda,
                                                    delta_pack_plain)
    t0 = _tensor(dtype, n, dev)
    prev = chunk_hashes_plain(t0.view(torch.uint8), cb)
    t1 = t0.clone()
    t1[:: max(1, n // 7)] = t1[1]                       # a few dirty chunks
    u8 = t1.view(torch.uint8)
    h, d, pos, count, buf = delta_pack_cuda(u8, i32_bits(prev), cb)
    ph, pd, ppos, pcount, pbuf = delta_pack_plain(u8, prev, cb)
    assert count == pcount
    assert torch.equal(h.to(torch.int64) & 0xFFFFFFFF, ph)
    assert torch.equal(d.to(torch.int64), pd)
    assert torch.equal(pos.to(torch.int64), ppos)
    assert torch.equal(buf, i32_bits(pbuf))


def _codec_case(name):
    """(uint32 values as int64 [R, W], gw) for one case of the codec's
    card matrix."""
    g = torch.Generator(device="cpu").manual_seed(len(name))
    full = 0xFFFFFFFF

    def mixed(r, w):
        x = torch.randint(0, 1 << 10, (r, w), generator=g, dtype=torch.int64)
        x[:, : w // 3] = 0
        x[0, w // 2:] = full
        return x

    if name.startswith("gw"):                 # gw 32, 64, 256: 5 groups
        gw = int(name[2:])
        return (mixed(5, gw) if gw < 1024 else mixed(3, 4096)), gw
    if name == "ragged_tile":                 # 13 groups: no multiple of 8
        return mixed(13, 64), 64
    if name == "many_tiles":                  # 2**17 + 5 groups of 32 words
        return mixed(1, ((1 << 17) + 5) * 32), 32
    if name == "all_zero":
        return torch.zeros((3, 4096), dtype=torch.int64), 1024
    if name == "all_ones":
        return torch.full((3, 4096), full, dtype=torch.int64), 1024
    if name == "all_stored":                  # random words: every plane
        return torch.randint(0, 1 << 32, (4, 4096), generator=g,
                             dtype=torch.int64), 1024
    # Phase 1's rows: 1 MiB rows of AdamW moments, zeroed, half zeroed, kept
    m = torch.empty((3, 1 << 18)).normal_(0, 1e-3, generator=g)
    m[0] = 0
    m[1, : 1 << 17] = 0
    return m.view(torch.int32).to(torch.int64) & full, 1024


CODEC_CASES = ["gw32", "gw64", "gw256", "gw1024", "ragged_tile",
               "many_tiles", "all_zero", "all_ones", "all_stored",
               "zeroed_moments"]


@pytest.mark.parametrize("case", CODEC_CASES)
def test_codec_kernel_matches_plain(dev, case):
    from repro_torch.kernels.delta_codec.ops import (codec_encode_cuda,
                                                     codec_encode_plain,
                                                     i32_bits)
    x, gw = _codec_case(case)
    x = x.to(dev)
    ng = x.numel() // gw
    m, n, p = codec_encode_cuda(i32_bits(x), gw)
    pm, pn, pp = codec_encode_plain(x, gw)
    assert n == pn
    assert m.device.type == "cpu" and m.shape == (ng, 2)
    assert torch.equal(m.to(torch.int64) & 0xFFFFFFFF, pm.cpu())
    assert p.shape == (n, gw // 32)
    assert torch.equal(p, i32_bits(pp))
    if case in ("all_zero", "all_ones"):
        assert n == 0
    if case == "all_stored":
        assert n == ng * 32                   # the worst-case buffer, full


def _codec_raw_call(rows, gw, out, planes, status):
    from repro_torch.kernels import _lib
    ng = rows.numel() // gw
    _lib.call("kishu_codec_encode", rows.data_ptr(), ng, gw, out.data_ptr(),
              out[2 * ng:].data_ptr(), planes.data_ptr(), status.data_ptr(),
              status.numel(), _lib.stream_of(rows))


def _codec_buffers(rows, gw):
    from repro_torch.kernels.delta_codec.ops import TILE_GROUPS
    ng = rows.numel() // gw
    return (torch.empty((2 * ng + 1,), dtype=torch.int32, device=rows.device),
            torch.empty((ng * 32, gw // 32), dtype=torch.int32,
                        device=rows.device),
            torch.zeros((-(-ng // TILE_GROUPS) + 1,), dtype=torch.int64,
                        device=rows.device))


@pytest.mark.parametrize("case", ["zeroed_moments", "all_stored",
                                  "many_tiles"])
def test_codec_kernel_is_deterministic(dev, case):
    """50 calls on one stream, and 50 replays of a CUDA graph of the C
    entry (its memset and its launch), give the same masks, count and
    planes: the look-back order never shows in the output."""
    from repro_torch.kernels.delta_codec.ops import codec_encode_cuda, i32_bits
    x, gw = _codec_case(case)
    rows = i32_bits(x.to(dev))
    m0, n0, p0 = codec_encode_cuda(rows, gw)
    for _ in range(50):
        m, n, p = codec_encode_cuda(rows, gw)
        assert n == n0 and torch.equal(m, m0) and torch.equal(p, p0)
    out, planes, status = _codec_buffers(rows, gw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _codec_raw_call(rows, gw, out, planes, status)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _codec_raw_call(rows, gw, out, planes, status)
    ng = m0.shape[0]
    for _ in range(50):
        out.fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        host = out.cpu()
        assert int(host[2 * ng]) == n0
        assert torch.equal(host[:2 * ng].view(ng, 2), m0)
        assert torch.equal(planes[:n0], p0)


def test_codec_launch_failure_raises(dev, monkeypatch):
    """A group size the kernel does not take, a C entry that refuses its
    arguments and a failing launch all raise; encode_rows never falls back
    to the plain version for a CUDA tensor."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.delta_codec import ops
    x, gw = _codec_case("gw1024")
    rows = ops.i32_bits(x.to(dev))
    for bad in (48, 2048, 16):
        with pytest.raises(ValueError):
            ops.codec_encode_cuda(rows, bad)
    out, planes, status = _codec_buffers(rows, gw)
    roomy = torch.empty((1 << 10,), dtype=torch.int64, device=dev)
    with pytest.raises(RuntimeError, match="kishu_codec_encode"):
        _codec_raw_call(rows, 48, out, planes, roomy)        # refused gw
    with pytest.raises(RuntimeError, match="kishu_codec_encode"):
        _codec_raw_call(rows, gw, out, planes, status[:1])   # no room
    real = _lib.call

    def failing(fn, *args):
        if fn == "kishu_codec_encode":
            raise RuntimeError(f"{fn}: injected CUDA error")
        return real(fn, *args)

    def fallback(*args):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(_lib, "call", failing)
    monkeypatch.setattr(ops, "codec_encode_plain", fallback)
    before = _lib.launches()["delta_codec"]
    with pytest.raises(RuntimeError, match="injected CUDA error"):
        ops.encode_rows(rows)
    assert _lib.launches()["delta_codec"] == before


@pytest.mark.parametrize("cb", [128, 4096, 1 << 20])
def test_read_chunks_encoded_card_equals_cpu(dev, cb):
    """The same tensor, packed against the same hashes on the card and on
    the CPU, yields the same (index, logical, frame) triples: the kernel's
    stream builds the same frames as the plain version's."""
    import numpy as np
    from repro_torch.core.hashing import chunk_hashes_np
    from repro_torch.kernels.delta_pack.ops import delta_pack
    rng = np.random.default_rng(cb)
    a0 = rng.integers(0, 1 << 10, 5 * cb // 4 - 3).astype(np.int32)
    a1 = a0.copy()
    a1[:: max(1, cb // 8)] += 1                 # every chunk dirty
    a1[-1] += 1
    prev = chunk_hashes_np(a0.view(np.uint8), cb)
    got = {}
    for where in ("cpu", dev):
        pack = delta_pack(torch.from_numpy(a1).to(where), prev, cb)
        got[str(where)] = list(pack.read_chunks_encoded())
        assert pack.codec_chunks_encoded > 0
    assert got["cpu"] == got[str(dev)]
    assert [ci for ci, _, _ in got["cpu"]] == list(range(5))


@pytest.mark.parametrize("dtype,n", CASES)
@pytest.mark.parametrize("cb", [4096, 65536])
def test_scatter_kernel_matches_plain(dev, dtype, n, cb):
    from repro_torch.kernels.patch_scatter.ops import (patch_scatter_cuda,
                                                       patch_scatter_plain)
    t = _tensor(dtype, n, dev)
    u8 = t.view(torch.uint8)
    n_chunks = -(-u8.numel() // cb)
    idx = sorted({0, n_chunks - 1, n_chunks // 2})
    g = torch.Generator(device="cpu").manual_seed(n)
    rows = torch.randint(-2**31, 2**31 - 1, (len(idx), cb // 4),
                         generator=g, dtype=torch.int32).to(dev)
    a, b = u8.clone(), u8.clone()
    patch_scatter_cuda(a, cb, torch.tensor(idx, dtype=torch.int32,
                                           device=dev), rows)
    patch_scatter_plain(b, cb, idx, rows)
    assert torch.equal(a, b)
    # nothing past the tensor's bytes: a guard tail stays untouched
    big = torch.zeros(u8.numel() + 64, dtype=torch.uint8, device=dev)
    patch_scatter_cuda(big[: u8.numel()], cb,
                       torch.tensor(idx, dtype=torch.int32, device=dev),
                       rows)
    assert int(big[u8.numel():].sum()) == 0


def test_scatter_failure_raises_from_checkout(dev, monkeypatch):
    """A failing scatter launch surfaces from ``checkout``; the session
    never reloads the co-variable on the host path instead."""
    from repro_torch.core import KishuSession, MemoryStore
    from repro_torch.kernels import _lib

    s = KishuSession(MemoryStore(), chunk_bytes=4096, cache_bytes=0)

    def init(ns):
        ns["base"] = torch.arange(6000, dtype=torch.float32, device=dev)

    def bump(ns):
        ns["base"][::1997] = -1.0          # 4 of 6 chunks

    s.register("init", init)
    s.register("bump", bump)
    s.init_state({})
    c0 = s.run("init")
    s.run("bump")
    real = _lib.call

    def failing(fn, *args):
        if fn == "kishu_patch_scatter":
            raise RuntimeError(f"{fn}: injected CUDA error")
        return real(fn, *args)

    monkeypatch.setattr(_lib, "call", failing)
    with pytest.raises(RuntimeError, match="injected CUDA error"):
        s.checkout(c0)
    s.close()


def test_cuda_session_matches_cpu_session(dev):
    """The same cells on a CUDA session (kernels) and a CPU session (plain
    versions) write identical stores and restore identical states."""
    from repro_torch.core import KishuSession, MemoryStore
    from repro_torch.core.delta import exact_dirty_indices
    from repro_torch.kernels import _lib

    def cells(device):
        def init(ns):
            g = torch.Generator(device="cpu").manual_seed(0)
            ns["w"] = torch.randn(300_000, generator=g).to(device)
            ns["m"] = torch.randn(200_001, generator=g).to(device) \
                .to(torch.bfloat16)
            ns["u"] = torch.randint(0, 256, (77_777,), generator=g,
                                    dtype=torch.uint8).to(device)

        def step(ns, k):
            ns["w"][16384 * k: 16384 * (k + 1)] = 0.0     # one whole chunk
            ns["m"][::50_000] = float(k)
            ns["u"][5:9] = k
        return init, step

    out = {}
    for device in ("cpu", "cuda"):
        store = MemoryStore()
        s = KishuSession(store, chunk_bytes=1 << 16, cache_bytes=0,
                         device=device)
        init, step = cells(device)
        s.register("init", init)
        s.register("step", step)
        _lib.reset_launches()
        s.init_state({})
        c0 = s.run("init")
        cids = [s.run("step", k=k) for k in (1, 2, 3)]
        last = {n: s.ns[n].clone() for n in s.ns.names()}
        s.checkout(c0)
        back = {n: s.ns[n].cpu().clone() for n in s.ns.names()}
        s.checkout(cids[-1])
        if device == "cuda":
            # the restored tensors verified exactly on the card (block_diff)
            for n in s.ns.names():
                assert exact_dirty_indices(s.ns[n], last[n], 1 << 16) == [], n
            # every kernel of the commit -> checkout loop launched
            # (flash_attention belongs to the serving path)
            assert all(v > 0 for k, v in _lib.launches().items()
                       if k != "flash_attention"), _lib.launches()
        out[device] = (dict(store.chunks), back,
                       {n: s.ns[n].cpu() for n in s.ns.names()})
        s.close()
    assert out["cpu"][0] == out["cuda"][0]
    for i in (1, 2):
        for n in out["cpu"][i]:
            assert torch.equal(out["cpu"][i][n], out["cuda"][i][n]), n


def test_full_commit_streams_through_the_pinned_ring(dev):
    """A CUDA base several ring-lengths long, written whole, streams
    through the writer's pinned ring: its manifest and stored chunks equal
    those of the same values committed as a CPU tensor.  Its last write is
    queued on the current stream behind a long sleep, and the tensor is
    overwritten there straight after the commit returns: the side stream's
    copies waited for the write, and the stored chunks hold the committed
    values."""
    from repro_torch.core import KishuSession, MemoryStore, staging
    from repro_torch.core.checkpoint import WriteStats, build_manifest
    from repro_torch.core.covariable import RecordBuilder
    from repro_torch.core.namespace import Namespace

    cb = 1 << 20
    n = (6 * staging.SEG_BYTES + 3 * cb) // 4 + 123       # float32, > ring
    vals = torch.randn(n, generator=torch.Generator().manual_seed(7))
    want_store = MemoryStore()
    want = build_manifest(want_store, ("x",),
                          [RecordBuilder(cb).build("x", vals, {})],
                          Namespace({"x": vals}), cb, None, WriteStats(),
                          want_store.put_chunk)

    src = vals.to(dev)
    rec = RecordBuilder(cb).build("x", src, {})
    x = torch.zeros(n, device=dev)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    x.copy_(src)
    store, stats, ring = MemoryStore(), WriteStats(), staging.StagingRing()
    got = build_manifest(store, ("x",), [rec], Namespace({"x": x}), cb,
                         None, stats, store.put_chunk, ring=ring)
    x.fill_(-1.0)
    torch.cuda.synchronize()
    assert got == want and store.chunks == want_store.chunks
    assert (stats.covs_streamed, stats.bytes_streamed) == (1, 4 * n)
    assert ring._host.is_pinned()

    sess = KishuSession(MemoryStore(), chunk_bytes=cb, cache_bytes=0)

    def init(ns):
        ns["x"] = src.clone()

    sess.register("init", init)
    sess.init_state({})
    sess.run("init")
    sess.ns["x"].fill_(-1.0)
    torch.cuda.synchronize()
    assert sess.last_run.write.covs_streamed == 1
    assert sess.obs.registry.counter_total("kishu_bytes_streamed_total") \
        == 4 * n
    for k, v in want_store.chunks.items():
        assert sess.store.get_chunk(k) == v
    sess.close()


KEY_LENGTHS = [1, 3, 127, 128, 129, 255, 256, 1 << 14, (1 << 20) - 4,
               1 << 20, (1 << 20) + 1]


def _gappy(n_chunks):
    """Every chunk but each third from the second, the last always."""
    return [i % 3 != 1 or i == n_chunks - 1 for i in range(n_chunks)]


@pytest.mark.parametrize("offset", [0, 1])
def test_chunk_key_kernel_equals_hashlib(dev, offset):
    """The kernel's digests are hashlib's BLAKE2b-128, byte for byte: every
    length of the CPU test at 16 KiB and 1 MiB chunks (and at 3000, which
    is no multiple of 16), on an aligned and an unaligned base, with a mask
    with gaps; and 1,000 chunks of 4 KiB (32 blocks of chains) under a
    random mask.  One launch a call."""
    import hashlib

    import numpy as np

    from repro_torch.kernels import _lib
    from repro_torch.kernels.chunk_key.ops import chunk_key_digests
    rng = np.random.default_rng(offset)
    cases = [(n, cb, None) for n in KEY_LENGTHS
             for cb in (1 << 14, 1 << 20, 3000)]
    cases.append((1000 * 4096 - 7, 4096, rng.random(1000) < 0.6))
    for n, cb, mask in cases:
        raw = rng.integers(0, 256, n + offset, dtype=np.uint8)
        u8 = torch.from_numpy(raw).to(dev)[offset:]
        data = raw[offset:].tobytes()
        n_chunks = -(-n // cb)
        want = _gappy(n_chunks) if mask is None else list(mask)
        before = _lib.launches()["chunk_key"]
        got = chunk_key_digests(u8, cb, want)
        assert _lib.launches()["chunk_key"] == before + (any(want))
        expect = [hashlib.blake2b(data[i * cb:(i + 1) * cb],
                                  digest_size=16).digest()
                  for i in range(n_chunks) if want[i]]
        assert [row.tobytes() for row in got] == expect, (n, cb)


def test_streamed_commit_is_keyed_on_the_card(dev):
    """A bf16 base of 612 chunks of 1 MiB (the last ragged), written whole,
    streams through the pinned ring with its keys from one launch: every
    manifest key is ``chunk_key`` of the bytes the store holds, and the
    manifest and the chunks equal the blob path's.  Then every fifth
    chunk changes and a whole write against the first manifest keys only
    those (``want`` with gaps across the ring's segments).  In a session,
    the registry counts the chunks the card keyed."""
    from repro_torch.core import KishuSession, MemoryStore, staging
    from repro_torch.core.checkpoint import WriteStats, build_manifest
    from repro_torch.core.chunkstore import chunk_key
    from repro_torch.core.covariable import RecordBuilder
    from repro_torch.core.namespace import Namespace
    from repro_torch.kernels import _lib

    cb = 1 << 20
    n = (612 * cb - 1000) // 2
    vals = torch.randn(n, generator=torch.Generator().manual_seed(3)) \
        .to(torch.bfloat16)
    edited = vals.clone()
    edited[::5 * cb // 2] += 1.0
    ring = staging.StagingRing()
    prev = {"cpu": None, "cuda": None}
    for step, src in enumerate((vals, edited)):
        out = {}
        for where in ("cpu", "cuda"):
            x = src.to(where)
            store, stats = MemoryStore(), WriteStats()
            before = _lib.launches()["chunk_key"]
            man = build_manifest(store, ("x",),
                                 [RecordBuilder(cb).build("x", x, {})],
                                 Namespace({"x": x}), cb, prev[where],
                                 stats, store.put_chunk, delta_ranges=False,
                                 ring=ring if where == "cuda" else None)
            out[where] = (man, store.chunks, stats,
                          _lib.launches()["chunk_key"] - before)
            prev[where] = man
        (m0, c0, s0, l0), (m1, c1, s1, l1) = out["cpu"], out["cuda"]
        assert m1 == m0 and c1 == c0
        fresh = 612 if step == 0 else 123
        assert (s1.chunks_keyed_dev, l1) == (fresh, 1)
        assert (s0.chunks_keyed_dev, l0) == (0, 0)
        assert s1.chunks_written + s1.chunks_dedup == fresh
        for c in m1["base"]["chunks"]:
            if c["key"] in c1:
                assert c["key"] == chunk_key(c1[c["key"]])

    sess = KishuSession(MemoryStore(), chunk_bytes=cb, cache_bytes=0)
    x = vals.to(dev)

    def init(ns):
        ns["x"] = x.clone()

    sess.register("init", init)
    sess.init_state({})
    sess.run("init")
    assert sess.last_run.write.chunks_keyed_dev == 612
    assert sess.obs.registry.counter_total(
        "kishu_chunks_keyed_on_device_total") == 612
    sess.close()


def test_a_commits_small_bases_are_keyed_side_by_side(dev):
    """A commit of nine 2-chunk CUDA leaves and one of 40 chunks: each
    small base is parked while the next streams, so their launches take
    key streams of their own; the stored chunks equal those of the same
    values committed as CPU tensors, and the leaves, overwritten on the
    current stream straight after the commit, were keyed as committed."""
    from repro_torch.core import KishuSession, MemoryStore

    cb = 1 << 20
    g = torch.Generator().manual_seed(11)
    vals = [torch.randint(0, 256, (n,), dtype=torch.uint8, generator=g)
            for n in [2 * cb - 17] * 9 + [40 * cb]]
    stores = []
    for where in ("cpu", dev):
        sess = KishuSession(MemoryStore(), chunk_bytes=cb, cache_bytes=0,
                            device="cpu" if where == "cpu" else "cuda")
        xs = [v.to(where) for v in vals]

        def init(ns, xs=xs):
            for k, x in enumerate(xs):
                ns[f"v{k}"] = x.clone()

        sess.register("init", init)
        sess.init_state({})
        sess.run("init")
        for k in range(len(vals)):
            sess.ns[f"v{k}"].fill_(7)
        torch.cuda.synchronize()
        stores.append((sess.store.chunks, sess.last_run.write))
        ring = sess.writer.ring
        sess.close()
    (c0, w0), (c1, w1) = stores
    assert c1 == c0 and w1.chunks_keyed_dev == 9 * 2 + 40
    assert w1.covs_streamed == 10 and w0.covs_streamed == 0
    assert sum(len(p) for p in ring._key_streams.values()) >= 2


# ---------------------------------------------------------------------------
# block_diff and the trainer on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,n", CASES)
@pytest.mark.parametrize("cb", [4096, 1 << 20, 3000, 4098, 3 << 20])
@pytest.mark.parametrize("offset", [0, 1])
def test_block_diff_kernel_matches_plain(dev, dtype, n, cb, offset):
    from repro_torch.kernels.block_diff.ops import (block_diff_cuda,
                                                    block_diff_plain)
    a = _tensor(dtype, n, dev).view(torch.uint8)[offset:]   # unaligned too
    nb = a.numel()
    for flips in ([], [0], [nb - 1], [7, nb // 2, nb - 2]):
        b = a.clone()
        for pos in flips:
            b[pos] ^= 0x10
        got = block_diff_cuda(a, b, cb)
        want = block_diff_plain(a, b, cb)
        assert got.dtype == torch.int32 and torch.equal(got, want), flips
        assert int(got.sum()) == len({p // cb for p in flips})


def test_block_diff_guard_and_ragged_tail(dev):
    """Bytes past the compared length differ in the two buffers and are
    never read; a flip in the ragged last chunk's true bytes is found."""
    from repro_torch.kernels.block_diff.ops import block_diff_cuda
    n, cb = 3 * 4096 + 5, 4096
    big_a = torch.zeros(n + 64, dtype=torch.uint8, device=dev)
    big_b = big_a.clone()
    big_b[n:] = 0xFF
    assert block_diff_cuda(big_a[:n], big_b[:n], cb).tolist() == [0] * 4
    big_b[n - 1] = 1
    assert block_diff_cuda(big_a[:n], big_b[:n], cb).tolist() == [0, 0, 0, 1]


def test_block_diff_launch_failure_raises(dev, monkeypatch):
    """exact_dirty_indices never falls back to a host compare, whatever the
    chunk size: it launches the kernel, and a failing launch raises."""
    from repro_torch.core.delta import exact_dirty_indices
    from repro_torch.kernels import _lib
    a = torch.zeros(10_000, device=dev)
    b = a.clone()
    b[-1] = 1
    for cb in (4096, 3000):
        before = _lib.launches()["block_diff"]
        assert exact_dirty_indices(a, b, cb) == [(40_000 - 1) // cb]
        assert _lib.launches()["block_diff"] == before + 1
    real = _lib.call

    def failing(fn, *args):
        if fn == "kishu_block_diff":
            raise RuntimeError(f"{fn}: injected CUDA error")
        return real(fn, *args)

    monkeypatch.setattr(_lib, "call", failing)
    for cb in (4096, 3000):
        with pytest.raises(RuntimeError, match="injected CUDA error"):
            exact_dirty_indices(a, a.clone(), cb)


def test_trainer_session_checkouts_verify_on_the_card(dev):
    """A reduced qwen3 trainer on the card: every checkout and a resume
    restore bit-identical, as block_diff shows; the LR-only commit changes
    no tensor."""
    from repro_torch.core import MemoryStore
    from repro_torch.core.delta import exact_dirty_indices
    from repro_torch.kernels import _lib
    from repro_torch.models.config import get_config
    from repro_torch.models.testing import reduced
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import ManagedTrainingSession, resume

    cfg = reduced(get_config("qwen3-1.7b"), n_layers=2)
    store = MemoryStore()
    kw = dict(global_batch=2, seq_len=16, chunk_bytes=4096)

    def snap(s):
        return {n: s.ns[n].clone() for n in s.ns.names()
                if isinstance(s.ns[n], torch.Tensor)}

    def same(s, want):
        for n, t in want.items():
            assert s.ns[n].is_cuda
            assert exact_dirty_indices(s.ns[n], t, 4096) == [], n

    s = ManagedTrainingSession(cfg, AdamWConfig(lr=1e-3), store, **kw)
    _lib.reset_launches()
    s.attach(seed=0)
    c1 = s.train(2)
    s1 = snap(s)
    s.set_lr(5e-4)
    same(s, s1)
    c3 = s.train(2)
    s3 = snap(s)
    s.evaluate(1)
    s.checkout(c1)
    same(s, s1)
    s.checkout(c3)
    same(s, s3)
    assert s.ns["state/params/embed"] is s.ns["state/params/lm_head"]
    s.close()
    r = resume(cfg, AdamWConfig(lr=1e-3), store, **kw)
    assert r.kishu.head == c3
    same(r, s3)
    r.close()
    counts = _lib.launches()
    assert counts["block_diff"] > 0 and counts["chunk_hash"] > 0 \
        and counts["delta_pack"] > 0, counts


# ---------------------------------------------------------------------------
# flash attention and the serving path on the card
# ---------------------------------------------------------------------------

# kernel against plain on the card: float32 within atol 1e-5 / rtol 1e-4
# (summation order); bf16 within atol 1e-5 / rtol 2**-7, one bf16 unit in
# the last place: both compute the same float32 value up to summation
# order, and its one rounding to bf16 may land on neighbouring values
FLASH_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-4),
             torch.bfloat16: dict(atol=1e-5, rtol=2 ** -7)}


def _qkv(b, s, hq, hkv, hd, dtype, dev, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn((b, s, h, hd), generator=g).to(dtype).to(dev)
            for h in (hq, hkv, hkv)]


def _flash_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(),
                               **FLASH_TOL[want.dtype])


def _flash_routes():
    from repro_torch.kernels import _lib
    return _lib.route_launches()["flash_attention"]


def _route_of(dtype):
    """The route contiguous operands of ``dtype`` take."""
    return "tc" if dtype == torch.bfloat16 else "fma"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n_rep", [1, 3])
@pytest.mark.parametrize("s", [1, 64, 130])
def test_flash_kernel_matches_plain(dev, dtype, hd, causal, n_rep, s):
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    q, k, v = _qkv(2, s, 2 * n_rep, 2, hd, dtype, dev, seed=hd + s)
    before, routes = _lib.launches()["flash_attention"], _flash_routes()
    got = flash_attention(q, k, v, causal=causal)
    assert _lib.launches()["flash_attention"] == before + 1
    route = _route_of(dtype)
    assert _flash_routes()[route] == routes[route] + 1
    _flash_close(got, flash_attention_plain(q, k, v, causal=causal))
    if causal:
        assert torch.equal(got[:, 0, :], v[:, 0].repeat_interleave(n_rep, 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_head_dim_256_and_long_ragged(dev, dtype):
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    for shape in ((1, 100, 4, 2, 256), (1, 1037, 6, 2, 64)):
        q, k, v = _qkv(*shape, dtype, dev, seed=shape[1])
        routes = _flash_routes()
        _flash_close(flash_attention_cuda(q, k, v),
                     flash_attention_plain(q, k, v))
        route = _route_of(dtype)
        assert _flash_routes()[route] == routes[route] + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_takes_a_softmax_scale(dev, dtype):
    """Granite's attention scale (1/128 at head dim 128, not 1/sqrt(128))
    reaches the kernel on both routes, as the plain version applies it."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    q, k, v = _qkv(2, 77, 8, 2, 128, dtype, dev, seed=128)
    routes = _flash_routes()
    got = flash_attention(q, k, v, softmax_scale=1 / 128)
    _flash_close(got, flash_attention_plain(q, k, v, softmax_scale=1 / 128))
    assert _flash_routes()[_route_of(dtype)] == routes[_route_of(dtype)] + 1
    assert not torch.allclose(got.float(), flash_attention_plain(q, k, v)
                              .float(), atol=1e-2)


def test_flash_kernel_reads_strided_inputs_in_place(dev):
    """q, k and v sliced out of one fused projection, a head-major layout
    seen through a transpose, and a dim stride of 2: read through their
    strides, never copied."""
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    b, s, hq, hkv, hd = 2, 77, 6, 2, 32
    g = torch.Generator(device="cpu").manual_seed(5)
    fused = torch.randn((b, s, hq + 2 * hkv, hd), generator=g).to(dev)
    q, k, v = fused.split([hq, hkv, hkv], dim=2)
    assert not q.is_contiguous()
    _flash_close(flash_attention_cuda(q, k, v),
                 flash_attention_plain(q.contiguous(), k.contiguous(),
                                       v.contiguous()))
    heads_first = torch.randn((b, hq, s, hd), generator=g).to(dev)
    qt = heads_first.transpose(1, 2)
    wide = torch.randn((b, s, hkv, 2 * hd), generator=g).to(dev)
    kt = wide[..., ::2]
    _flash_close(flash_attention_cuda(qt, kt, v, causal=False),
                 flash_attention_plain(qt.contiguous(), kt.contiguous(),
                                       v.contiguous(), causal=False))


def test_flash_kernel_reads_strided_bf16(dev):
    """bf16 q, k and v sliced out of one fused projection and a head-major
    layout seen through a transpose go to the tensor-core route, read in
    place through TMA; a dim stride of 2 goes to the fma route."""
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain,
                                                     flash_route)
    b, s, hq, hkv, hd = 2, 77, 6, 2, 32
    g = torch.Generator(device="cpu").manual_seed(6)
    bf = torch.bfloat16
    fused = torch.randn((b, s, hq + 2 * hkv, hd), generator=g).to(bf).to(dev)
    q, k, v = fused.split([hq, hkv, hkv], dim=2)
    heads_first = torch.randn((b, hq, s, hd), generator=g).to(bf).to(dev)
    qt = heads_first.transpose(1, 2)
    wide = torch.randn((b, s, hkv, 2 * hd), generator=g).to(bf).to(dev)
    kt = wide[..., ::2]
    for qq, kk, vv, route in ((q, k, v, "tc"), (qt, k, v, "tc"),
                              (qt, kt, v, "fma")):
        assert flash_route(qq, kk, vv) == route
        routes = _flash_routes()
        for causal in (True, False):
            _flash_close(flash_attention_cuda(qq, kk, vv, causal=causal),
                         flash_attention_plain(qq.contiguous(),
                                               kk.contiguous(),
                                               vv.contiguous(),
                                               causal=causal))
        assert _flash_routes()[route] == routes[route] + 2
    with pytest.raises(ValueError, match="route"):
        flash_attention_cuda(qt, kt, v, route="tc")


def test_flash_kernel_writes_no_row_past_s(dev):
    """The ragged last tile's rows past S are never written: the output is
    a slice of a larger guarded buffer, through the C entry point."""
    import numpy as np
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import flash_attention_plain
    b, s, hq, hkv, hd = 2, 70, 4, 2, 64
    q, k, v = _qkv(b, s, hq, hkv, hd, torch.float32, dev, seed=9)
    big = torch.full((b, s + 64, hq, hd), 7.0, device=dev)
    out = big[:, :s]
    _lib.call("kishu_flash_attention", q.data_ptr(), k.data_ptr(),
              v.data_ptr(), out.data_ptr(), b, s, hq, hkv, hd, 0, 1,
              float(1 / np.sqrt(hd)), *q.stride(), *k.stride(), *v.stride(),
              *out.stride(), _lib.stream_of(q))
    torch.cuda.synchronize()
    assert bool((big[:, s:] == 7.0).all())
    _flash_close(out, flash_attention_plain(q, k, v))


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_tc_kernel_writes_no_row_past_s(dev, hd):
    """The tensor-core entry point into a guarded buffer: rows past S and
    columns past the output's own are never written."""
    import numpy as np
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import flash_attention_plain
    b, s, hq, hkv = 2, 70, 4, 2
    q, k, v = _qkv(b, s, hq, hkv, hd, torch.bfloat16, dev, seed=hd)
    big = torch.full((b, s + 64, hq, hd + 8), 7.0, device=dev,
                     dtype=torch.bfloat16)
    out = big[:, :s, :, :hd]
    _lib.call("kishu_flash_attention_tc", q.data_ptr(), k.data_ptr(),
              v.data_ptr(), out.data_ptr(), b, s, hq, hkv, hd, 1,
              float(1 / np.sqrt(hd)), *q.stride()[:3], *k.stride()[:3],
              *v.stride()[:3], *out.stride()[:3], _lib.stream_of(q))
    torch.cuda.synchronize()
    assert bool((big[:, s:] == 7.0).all())
    assert bool((big[..., hd:] == 7.0).all())
    _flash_close(out, flash_attention_plain(q, k, v))


def test_flash_launch_failure_raises(dev, monkeypatch):
    """A failing launch surfaces from ``flash_attention`` and from the
    prefill; nothing falls back to the plain version."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import flash_attention, ops
    from repro_torch.models import lm
    from repro_torch.models.config import get_config
    from repro_torch.models.testing import reduced
    from repro_torch.train.step import make_prefill_step
    real = _lib.call

    def failing(fn, *args):
        if fn == "kishu_flash_attention":
            raise RuntimeError(f"{fn}: injected CUDA error")
        return real(fn, *args)

    def no_plain(*args, **kw):
        raise AssertionError("the card's path reached the plain version")

    monkeypatch.setattr(_lib, "call", failing)
    monkeypatch.setattr(ops, "flash_attention_plain", no_plain)
    q, k, v = _qkv(1, 8, 2, 1, 16, torch.float32, dev)
    with pytest.raises(RuntimeError, match="injected CUDA error"):
        flash_attention(q, k, v)
    # the tensor-core entry point fails: no retry on the fma route
    routes = _flash_routes()

    def failing_tc(fn, *args):
        if fn == "kishu_flash_attention_tc":
            raise RuntimeError(f"{fn}: injected CUDA error")
        return real(fn, *args)

    monkeypatch.setattr(_lib, "call", failing_tc)
    qb, kb, vb = _qkv(1, 8, 2, 1, 64, torch.bfloat16, dev)
    with pytest.raises(RuntimeError, match="injected CUDA error"):
        flash_attention(qb, kb, vb)
    assert _flash_routes() == routes
    monkeypatch.setattr(_lib, "call", failing)
    cfg = reduced(get_config("smollm-360m"), n_layers=2)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    toks = torch.zeros((1, 5), dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="injected CUDA error"):
        make_prefill_step(cfg)(params, {"tokens": toks})
    with pytest.raises(ValueError):
        flash_attention(q, k.cpu(), v)


def test_flash_refuses_what_the_kernel_does_not_take(dev):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q, k, v = _qkv(1, 8, 2, 1, 16, torch.float16, dev)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention_cuda(q, k, v)
    q, k, v = _qkv(1, 8, 2, 1, 264, torch.float32, dev)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(q, k, v)
    q, k, v = _qkv(1, 8, 2, 1, 16, torch.float32, dev)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention_cuda(q.requires_grad_(True), k, v)


def test_prefill_on_the_card_launches_once_per_layer(dev):
    """The card's prefill goes through the kernel once per layer and
    agrees with the CPU prefill (plain version) and with the card's own
    decode loop (float32, the JAX consistency bound 2e-3)."""
    from repro_torch.interop import to_numpy, to_torch
    from repro_torch.kernels import _lib
    from repro_torch.models import lm
    from repro_torch.models.config import get_config
    from repro_torch.models.testing import reduced
    from repro_torch.train.step import make_decode_step, make_prefill_step
    cfg = reduced(get_config("qwen3-1.7b"), n_layers=3)
    cpu_params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    params = to_torch(to_numpy(cpu_params), dev)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=g,
                         dtype=torch.int32)
    _lib.reset_launches()
    full = make_prefill_step(cfg)(params, {"tokens": toks.to(dev)})
    assert _lib.launches()["flash_attention"] == cfg.n_layers
    assert _flash_routes() == {"tc": 0, "fma": cfg.n_layers}   # float32
    want = make_prefill_step(cfg)(cpu_params, {"tokens": toks})
    torch.testing.assert_close(full.cpu(), want, atol=1e-4, rtol=1e-4)
    caches = lm.init_caches(cfg, 2, 9, device=dev)
    outs = []
    with torch.no_grad():
        for t in range(9):
            lg, caches = lm.decode_step(cfg, params, caches,
                                        {"tokens": toks[:, t:t + 1].to(dev),
                                         "index": t})
            outs.append(lg[:, 0])
    assert float((full - torch.stack(outs, 1)).abs().max()) < 2e-3
    nxt, _ = make_decode_step(cfg)(params, lm.init_caches(cfg, 2, 3),
                                   {"tokens": toks[:, :1].to(dev),
                                    "index": 0})
    assert nxt.is_cuda and nxt.dtype == torch.int32
    assert _lib.launches()["flash_attention"] == cfg.n_layers


def test_serve_flow_checkouts_verify_on_the_card(dev):
    """The examples/serve_batched.py flow on the card, reduced: every
    rollback to the prefix restores the caches exactly (block_diff), the
    repeated flavor regenerates the same tokens and caches, flavors
    differ."""
    from repro_torch.core import KishuSession, MemoryStore
    from repro_torch.core.delta import exact_dirty_indices
    from repro_torch.kernels import _lib
    from repro_torch.models import lm
    from repro_torch.models.config import get_config
    from repro_torch.models.testing import reduced
    from repro_torch.train.step import make_decode_step, make_prefill_step
    cfg = reduced(get_config("smollm-360m")).replace(dtype="bfloat16")
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    prefill_step, decode = make_prefill_step(cfg), make_decode_step(cfg)
    b, prefix, gen, cb = 3, 12, 6, 1 << 12
    prompts = torch.randint(0, cfg.vocab_size, (b, prefix),
                            generator=torch.Generator().manual_seed(7),
                            dtype=torch.int32).to(dev)

    def do_prefill(ns):
        ns["prefill_last_logits"] = prefill_step(
            params, {"tokens": prompts})[:, -1].clone()
        caches = lm.init_caches(cfg, b, prefix + gen)
        tok = prompts[:, :1]
        for t in range(prefix):
            tok, caches = decode(params, caches, {"tokens": tok, "index": t})
            if t + 1 < prefix:
                tok = prompts[:, t + 1:t + 2]
        ns.set_tree("caches", caches)
        ns["last_tok"] = tok
        ns["pos"] = prefix

    def generate(ns, n, flavor):
        caches = ns.get_tree("caches")
        tok, pos, outs = ns["last_tok"], ns["pos"], []
        for t in range(n):
            tok, caches = decode(params, caches,
                                 {"tokens": (tok + flavor) % cfg.vocab_size,
                                  "index": pos + t})
            outs.append(tok)
        ns.set_tree("caches", caches)
        ns["last_tok"] = tok
        ns["pos"] = pos + n
        ns["generated"] = torch.cat(outs, 1)

    def cache_snap(ns):
        return {n: ns[n].clone() for n in ns.names()
                if n.startswith("caches/")}

    def verify(ns, snap):
        for n, t in snap.items():
            assert ns[n].is_cuda
            assert exact_dirty_indices(ns[n], t, cb) == [], n

    sess = KishuSession(MemoryStore(), chunk_bytes=cb)
    sess.register("prefill", do_prefill)
    sess.register("generate", generate)
    sess.init_state({})
    _lib.reset_launches()
    c0 = sess.run("prefill")
    assert _lib.launches()["flash_attention"] == cfg.n_layers
    assert _flash_routes() == {"tc": cfg.n_layers, "fma": 0}   # bf16
    s0 = cache_snap(sess.ns)
    tokens, caches = {}, {}
    for flavor in (1, 2, 3, 1):
        sess.checkout(c0)
        verify(sess.ns, s0)
        sess.run("generate", n=gen, flavor=flavor)
        if flavor in tokens:
            assert torch.equal(sess.ns["generated"], tokens[flavor])
            verify(sess.ns, caches[flavor])
        else:
            tokens[flavor] = sess.ns["generated"].clone()
            caches[flavor] = cache_snap(sess.ns)
    assert not torch.equal(tokens[1], tokens[2])
    sess.close()
    counts = _lib.launches()
    assert counts["chunk_hash"] > 0 and counts["delta_pack"] > 0 \
        and counts["block_diff"] > 0, counts


# ---------------------------------------------------------------------------
# the graphed decode step, train replay, pinned loads
# ---------------------------------------------------------------------------

def _serve_setup(dev, dtype="bfloat16"):
    from repro_torch.models import lm
    from repro_torch.models.config import get_config
    from repro_torch.models.testing import reduced
    cfg = reduced(get_config("smollm-360m")).replace(dtype=dtype)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    return cfg, params


def _leaves_equal(a, b):
    from repro_torch.optim.adamw import tree_leaves
    return all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_graphed_decode_step_equals_eager_bit_for_bit(dev, dtype):
    """72 steps (8 teacher-forced, 64 greedy) through the CUDA graph and
    through the eager step: the same tokens, logits and cache bytes at
    every step, from one capture."""
    from repro_torch.models import lm
    from repro_torch.train.step import (make_decode_step,
                                        GraphedDecodeStep)
    cfg, params = _serve_setup(dev, dtype)
    b, prompt, steps = 3, 8, 72
    toks = torch.randint(0, cfg.vocab_size, (b, prompt),
                         generator=torch.Generator().manual_seed(5),
                         dtype=torch.int32).to(dev)
    eager, graphed = make_decode_step(cfg), GraphedDecodeStep(cfg)
    ce = lm.init_caches(cfg, b, steps + 1)
    cg = lm.init_caches(cfg, b, steps + 1)
    tok = toks[:, :1]
    for t in range(steps):
        with torch.no_grad():
            want, _ = lm.decode_step(cfg, params, ce,
                                     {"tokens": tok, "index": t})
        want_tok = want[..., :cfg.vocab_size].argmax(-1).to(torch.int32)
        lg, nxt, cg2 = graphed.with_logits(params, cg,
                                           {"tokens": tok, "index": t})
        assert cg2 is cg and nxt.is_cuda and lg.is_cuda
        assert torch.equal(lg, want), t
        assert torch.equal(nxt, want_tok), t
        assert _leaves_equal(cg, ce), t
        tok = toks[:, t + 1:t + 2] if t + 1 < prompt else nxt
    assert graphed.captures == 1 and graphed.capture_s > 0
    # the plain call, replayed from the same graph, and the eager step
    n_e, _ = eager(params, ce, {"tokens": tok, "index": steps})
    n_g, _ = graphed(params, cg, {"tokens": tok, "index": steps})
    assert torch.equal(n_g, n_e) and _leaves_equal(cg, ce)
    assert graphed.captures == 1


def test_graphed_decode_recaptures_after_a_full_load(dev):
    """A checkout that loads a cache leaf in full (K, every chunk of
    which the generation wrote) builds a new tensor: the graph captures
    again, and its generation equals the eager step's from the same
    checkout.  The one-chunk ``index`` leaf, all of whose bytes differ
    too, is patched in place: it keeps its storage."""
    from repro_torch.core import KishuSession, MemoryStore
    from repro_torch.models import lm
    from repro_torch.train.step import (make_decode_step,
                                        GraphedDecodeStep)
    cfg, params = _serve_setup(dev)
    graphed, eager = GraphedDecodeStep(cfg), make_decode_step(cfg)
    b, prefix, gen = 2, 6, 5
    prompts = torch.randint(0, cfg.vocab_size, (b, prefix),
                            generator=torch.Generator().manual_seed(3),
                            dtype=torch.int32).to(dev)

    def prefill(ns):
        caches = lm.init_caches(cfg, b, prefix + 2 * gen)
        tok = prompts[:, :1]
        for t in range(prefix):
            tok, caches = graphed(params, caches, {"tokens": tok,
                                                   "index": t})
            if t + 1 < prefix:
                tok = prompts[:, t + 1:t + 2]
        ns.set_tree("caches", caches)
        ns["last_tok"] = tok
        ns["pos"] = prefix

    def generate_with(step):
        def generate(ns, n):
            caches = ns.get_tree("caches")
            tok, pos, outs = ns["last_tok"], ns["pos"], []
            for t in range(n):
                tok, caches = step(params, caches, {"tokens": tok,
                                                    "index": pos + t})
                outs.append(tok)
            ns.set_tree("caches", caches)
            ns["last_tok"], ns["pos"] = tok, pos + n
            ns["generated"] = torch.cat(outs, 1)
        return generate

    sess = KishuSession(MemoryStore(), chunk_bytes=1 << 12)
    sess.register("prefill", prefill)
    sess.register("generate", generate_with(graphed))
    sess.register("generate_eager", generate_with(eager))
    sess.init_state({})
    c0 = sess.run("prefill")
    sess.run("generate", n=gen)
    assert graphed.captures == 1
    first = sess.ns["generated"].clone()
    name = "caches/stages/stage_0/sub_0/attn/k"
    index = "caches/stages/stage_0/sub_0/attn/index"
    before = sess.ns[name].data_ptr()
    before_index = sess.ns[index].data_ptr()
    st = sess.checkout(c0)
    assert st.covs_loaded > 0 and sess.ns[name].data_ptr() != before
    assert sess.ns[index].data_ptr() == before_index
    sess.run("generate", n=gen)
    assert graphed.captures == 2
    assert torch.equal(sess.ns["generated"], first)
    graphed_caches = {n: sess.ns[n].clone() for n in sess.ns.names()
                      if n.startswith("caches/")}
    sess.checkout(c0)
    sess.run("generate_eager", n=gen)
    assert torch.equal(sess.ns["generated"], first)
    for n, t in graphed_caches.items():
        assert torch.equal(sess.ns[n], t), n
    sess.close()


def test_graphed_decode_capture_span_inside_exec(dev):
    """In a traced session a recapture (after a checkout that loads a
    cache leaf in full) records one ``capture`` span inside the cell's
    ``exec`` span, and ``capture_s`` grows by about its length."""
    from repro_torch.core import KishuSession, MemoryStore
    from repro_torch.models import lm
    from repro_torch.train.step import GraphedDecodeStep
    cfg, params = _serve_setup(dev)
    step = GraphedDecodeStep(cfg)
    b, prefix, gen = 2, 6, 5        # as the recapture test above

    def fill(ns):
        caches = lm.init_caches(cfg, b, prefix + 2 * gen)
        tok = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        for t in range(prefix):
            tok, caches = step(params, caches, {"tokens": tok, "index": t})
        ns.set_tree("caches", caches)
        ns["last_tok"] = tok

    def generate(ns):
        caches, tok = ns.get_tree("caches"), ns["last_tok"]
        for t in range(gen):
            tok, caches = step(params, caches, {"tokens": tok,
                                                "index": prefix + t})
        ns.set_tree("caches", caches)
        ns["last_tok"] = tok

    sess = KishuSession(MemoryStore(), chunk_bytes=1 << 12, trace=True)
    sess.register("fill", fill)
    sess.register("generate", generate)
    sess.init_state({})
    c0 = sess.run("fill")
    sess.run("generate")
    st = sess.checkout(c0)
    assert st.covs_loaded > 0
    tracer = sess.obs.tracer
    tracer.clear()
    captures, capture_s = step.captures, step.capture_s
    sess.run("generate")
    assert step.captures == captures + 1
    spans = list(tracer.spans)
    by_id = {r.span_id: r for r in spans}
    (cap,) = [r for r in spans if r.name == "capture"]
    ex = by_id[cap.parent_id]
    assert ex.name == "exec"
    assert ex.t0_s <= cap.t0_s and cap.t0_s + cap.dur_s <= ex.t0_s + ex.dur_s
    assert 0 < cap.dur_s <= step.capture_s - capture_s
    sess.close()


def test_graphed_decode_failures_raise(dev, monkeypatch):
    """A failed capture or replay raises; the eager step never runs in the
    graph's place, so the live caches stay as they were."""
    from repro_torch.models import lm
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.step import GraphedDecodeStep
    cfg, params = _serve_setup(dev)
    caches = lm.init_caches(cfg, 2, 4)
    snap = [t.clone() for t in tree_leaves(caches)]
    batch = {"tokens": torch.zeros((2, 1), dtype=torch.int32, device=dev),
             "index": 0}

    class FailingGraph:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            raise RuntimeError("injected capture failure")

        def __exit__(self, *exc):
            return False

    step = GraphedDecodeStep(cfg)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "graph", FailingGraph)
        with pytest.raises(RuntimeError, match="injected capture failure"):
            step(params, caches, batch)
    assert step.captures == 0

    def failing_replay(self):
        raise RuntimeError("injected replay failure")
    with monkeypatch.context() as m:
        m.setattr(torch.cuda.CUDAGraph, "replay", failing_replay)
        with pytest.raises(RuntimeError, match="injected replay failure"):
            step(params, caches, batch)
    assert step.captures == 1
    for t, want in zip(tree_leaves(caches), snap):   # nothing ran eagerly
        assert torch.equal(t, want)
    nxt, _ = step(params, caches, batch)             # the graph, unpatched
    assert nxt.is_cuda and step.captures == 1


NEW_FAMILIES = ["mamba2-780m", "phi3.5-moe-42b-a6.6b",
                "jamba-1.5-large-398b"]


def _family_setup(dev, arch, dtype="bfloat16"):
    from repro_torch.models import lm
    from repro_torch.models.config import get_config
    from repro_torch.models.testing import reduced
    cfg = reduced(get_config(arch)).replace(dtype=dtype)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    return cfg, params


@pytest.mark.parametrize("arch", NEW_FAMILIES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_graphed_decode_equals_eager_ssm_moe(dev, arch, dtype):
    """SSM, MoE and hybrid decode through the CUDA graph and the eager
    step, 40 steps: the same tokens, logits and cache bytes at every step
    from one capture, and every cache leaf keeps its storage (SSM state and
    conv written in place)."""
    from repro_torch.models import lm
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.step import GraphedDecodeStep
    cfg, params = _family_setup(dev, arch, dtype)
    b, prompt, steps = 3, 8, 40
    toks = torch.randint(0, cfg.vocab_size, (b, prompt),
                         generator=torch.Generator().manual_seed(6),
                         dtype=torch.int32).to(dev)
    graphed = GraphedDecodeStep(cfg)
    ce = lm.init_caches(cfg, b, steps + 1)
    cg = lm.init_caches(cfg, b, steps + 1)
    ptrs = [t.data_ptr() for t in tree_leaves(cg)]
    tok = toks[:, :1]
    for t in range(steps):
        with torch.no_grad():
            want, _ = lm.decode_step(cfg, params, ce,
                                     {"tokens": tok, "index": t})
        lg, nxt, _ = graphed.with_logits(params, cg,
                                         {"tokens": tok, "index": t})
        assert torch.equal(lg, want), t
        assert torch.equal(
            nxt, want[..., :cfg.vocab_size].argmax(-1).to(torch.int32)), t
        assert _leaves_equal(cg, ce), t
        tok = toks[:, t + 1:t + 2] if t + 1 < prompt else nxt
    assert graphed.captures == 1
    assert [t.data_ptr() for t in tree_leaves(cg)] == ptrs
    if cfg.ssm is not None:
        states = [t for t in tree_leaves(cg) if t.dtype == torch.float32
                  and t.ndim == 5]
        assert states and all(bool(t.abs().sum() > 0) for t in states)


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_decode_step_makes_no_host_sync(dev, arch):
    """After a warm-up step, decode steps of the SSM, MoE and hybrid
    models run with CUDA sync debugging set to raise: the MoE dispatch
    (sort, counts by scatter_add_) and the in-place SSM update read
    nothing back to the host."""
    from repro_torch.models import lm
    cfg, params = _family_setup(dev, arch)
    caches = lm.init_caches(cfg, 2, 8)
    tok = torch.ones((2, 1), dtype=torch.int32, device=dev)
    index = torch.zeros((), dtype=torch.int32, device=dev)
    with torch.no_grad():
        lm.decode_step(cfg, params, caches, {"tokens": tok, "index": index})
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                index.add_(1)
                logits, _ = lm.decode_step(cfg, params, caches,
                                           {"tokens": tok, "index": index})
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(logits).all())


def test_moe_layer_captures_and_drops_as_eager(dev):
    """The MoE layer alone, with drops forced (capacity factor 0.25),
    captured in a CUDA graph: its replay equals the eager call bit for
    bit, and its routing and drops are the CPU's."""
    from repro_torch.models import moe
    cfg, params = _family_setup(dev, "phi3.5-moe-42b-a6.6b", "float32")
    import dataclasses
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=0.25))
    p = {k: v[0] for k, v in
         params["stages"]["stage_0"]["sub_0"]["moe"].items()}
    x = torch.randn((4, 16, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    routes, cpu_routes = [], []
    want = moe.moe_forward(p, cfg, x, routes)
    moe.moe_forward({k: v.cpu() for k, v in p.items()}, cfg, x.cpu(),
                    cpu_routes)
    (experts, kept), (cpu_experts, cpu_kept) = routes[0], cpu_routes[0]
    assert torch.equal(experts.cpu(), cpu_experts)
    assert torch.equal(kept.cpu(), cpu_kept) and not bool(cpu_kept.all())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        moe.moe_forward(p, cfg, x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = moe.moe_forward(p, cfg, x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


# ---------------------------------------------------------------------------
# MLA + MTP, enc-dec, M-RoPE from embeddings (reduced configs)
# ---------------------------------------------------------------------------

def _enc_out(cfg, params, b, dev, seed=3):
    from repro_torch.models import lm
    frames = torch.randn((b, 7, cfg.d_model), device=dev,
                         generator=torch.Generator(device=dev)
                         .manual_seed(seed))
    with torch.no_grad():
        return lm.encode(cfg, params, {"enc_embeds": frames})


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "whisper-large-v3"])
def test_mla_and_enc_dec_decode_graphed_equals_eager(dev, arch):
    """MLA decode (the compressed cache written in place at ``index``) and
    enc-dec decode (cross-attention over ``enc_out``) through the CUDA
    graph and the eager step, 24 steps: the same tokens, logits and cache
    bytes from one capture, every leaf in its storage, ``enc_out`` never
    written; then eager steps with CUDA sync debugging set to raise."""
    from repro_torch.models import lm
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.step import GraphedDecodeStep
    cfg, params = _family_setup(dev, arch)
    b, prompt, steps = 3, 6, 24
    toks = torch.randint(0, cfg.vocab_size, (b, prompt),
                         generator=torch.Generator().manual_seed(6),
                         dtype=torch.int32).to(dev)
    graphed = GraphedDecodeStep(cfg)
    ce = lm.init_caches(cfg, b, steps + 4, enc_seq=7)
    cg = lm.init_caches(cfg, b, steps + 4, enc_seq=7)
    if cfg.enc_dec:
        ce["enc_out"] = _enc_out(cfg, params, b, dev)
        cg["enc_out"] = ce["enc_out"].clone()
        enc = ce["enc_out"].clone()
    ptrs = [t.data_ptr() for t in tree_leaves(cg)]
    tok = toks[:, :1]
    for t in range(steps):
        with torch.no_grad():
            want, _ = lm.decode_step(cfg, params, ce,
                                     {"tokens": tok, "index": t})
        lg, nxt, _ = graphed.with_logits(params, cg,
                                         {"tokens": tok, "index": t})
        assert torch.equal(lg, want), t
        assert _leaves_equal(cg, ce), t
        tok = toks[:, t + 1:t + 2] if t + 1 < prompt else nxt
    assert graphed.captures == 1
    assert [t.data_ptr() for t in tree_leaves(cg)] == ptrs
    if cfg.enc_dec:
        assert torch.equal(cg["enc_out"], enc)
    else:
        c_kv = cg["stages"]["stage_0"]["sub_0"]["attn"]["c_kv"]
        assert bool(c_kv[:, :, :steps].abs().sum(-1).gt(0).all())
        assert not bool(c_kv[:, :, steps:].any())
    index = torch.full((), steps, dtype=torch.int32, device=dev)
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                logits, _ = lm.decode_step(cfg, params, ce,
                                           {"tokens": tok, "index": index})
                index.add_(1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(logits).all())


def test_mla_prefill_takes_the_flash_kernel_with_padded_v(dev):
    """Reduced deepseek's prefill launches flash once per MLA layer (v
    padded to the qk head dim, bf16: the tc route) and its logits agree
    with the decode loop's within the bf16 tolerance of the other
    prefill/decode card checks."""
    from repro_torch.kernels import _lib
    from repro_torch.models import lm
    from repro_torch.train.step import make_decode_step, make_prefill_step
    cfg, params = _family_setup(dev, "deepseek-v3-671b", "float32")
    toks = torch.randint(0, cfg.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32).to(dev)
    _lib.reset_launches()
    full = make_prefill_step(cfg)(params, {"tokens": toks})
    assert _lib.launches()["flash_attention"] == cfg.n_layers
    caches = lm.init_caches(cfg, 2, 9)
    outs = []
    with torch.no_grad():
        for t in range(9):
            lg, _ = lm.decode_step(cfg, params, caches,
                                   {"tokens": toks[:, t:t + 1], "index": t})
            outs.append(lg[:, 0])
    assert float((full - torch.stack(outs, 1)).abs().max()) < 2e-3
    bf_cfg, bf_params = _family_setup(dev, "deepseek-v3-671b")
    before = _flash_routes()["tc"]
    make_prefill_step(bf_cfg)(bf_params, {"tokens": toks})
    assert _flash_routes()["tc"] == before + bf_cfg.n_layers


def test_mtp_train_step_on_the_card_matches_the_cpu(dev):
    """Reduced deepseek (MLA, MoE, the MTP block), float32: two train
    steps from one initial state on the card and on the CPU give the same
    losses (the t+2 term in the total) and parameters, within the float32
    tolerance of the CPU tests against the JAX package."""
    from repro_torch.models.config import get_config
    from repro_torch.models.testing import reduced
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves, tree_map
    from repro_torch.train.step import init_train_state, make_train_step
    cfg = reduced(get_config("deepseek-v3-671b"), n_layers=2)
    opt = AdamWConfig(lr=1e-3, eps=1e-6)
    cpu = init_train_state(cfg, 0, opt, "cpu")
    card = tree_map(lambda t: t.to(dev), cpu)
    g = torch.Generator().manual_seed(4)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (4, 16),
                                        generator=g, dtype=torch.int32),
                "labels": torch.randint(0, cfg.vocab_size, (4, 16),
                                        generator=g, dtype=torch.int32)}
               for _ in range(2)]
    for mb in (1, 2):
        f_cpu = make_train_step(cfg, opt, microbatches=mb)
        f_card = make_train_step(cfg, opt, microbatches=mb)
        for batch in batches:
            _, m_cpu = f_cpu(cpu, batch)
            _, m_card = f_card(card, {k: v.to(dev) for k, v in
                                      batch.items()})
            for key in ("loss", "total_loss", "moe_aux", "grad_norm"):
                assert abs(float(m_card[key]) - float(m_cpu[key])) <= \
                    1e-4 * abs(float(m_cpu[key])) + 1e-7, key
            assert float(m_cpu["total_loss"]) > float(m_cpu["loss"])
    for a, b in zip(tree_leaves(cpu["params"]), tree_leaves(card["params"])):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=2e-5)


def test_vlm_decode_from_embeds_graphed_equals_eager(dev):
    """Reduced qwen2-vl decodes from precomputed embeddings with M-RoPE
    through the CUDA graph (a static [B,1,d] embedding buffer) and the
    eager step: the same tokens, logits and caches, one capture."""
    from repro_torch.models import lm
    from repro_torch.train.step import GraphedDecodeStep
    cfg, params = _family_setup(dev, "qwen2-vl-72b")
    b, steps = 3, 20
    emb = torch.randn((b, steps, cfg.d_model), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(5)
                      ).to(torch.bfloat16)
    graphed = GraphedDecodeStep(cfg)
    ce = lm.init_caches(cfg, b, steps)
    cg = lm.init_caches(cfg, b, steps)
    for t in range(steps):
        batch = {"embeds": emb[:, t:t + 1], "index": t}
        with torch.no_grad():
            want, _ = lm.decode_step(cfg, params, ce, batch)
        lg, nxt, _ = graphed.with_logits(params, cg, batch)
        assert torch.equal(lg, want), t
        assert torch.equal(
            nxt, want[..., :cfg.vocab_size].argmax(-1).to(torch.int32)), t
        assert _leaves_equal(cg, ce), t
    assert graphed.captures == 1
    # the same token ids as embeddings give the token path's logits
    toks = torch.randint(0, cfg.vocab_size, (b, 1), device=dev,
                         dtype=torch.int32)
    c1, c2 = lm.init_caches(cfg, b, 2), lm.init_caches(cfg, b, 2)
    with torch.no_grad():
        a, _ = lm.decode_step(cfg, params, c1, {"tokens": toks, "index": 0})
        e, _ = lm.decode_step(cfg, params, c2, {
            "embeds": params["embed"][toks[:, 0].long()][:, None],
            "index": 0})
    assert torch.equal(a, e)


def test_enc_dec_rollback_loads_no_enc_out_on_the_card(dev):
    """Reduced whisper served under Kishu on the card: each rollback to
    the prefix restores the KV caches exactly (block_diff), keeps the
    session's ``enc_out`` tensor, and asks the store for none of its
    chunks."""
    from repro_torch.core import KishuSession, MemoryStore
    from repro_torch.core.chunkstore import chunk_key
    from repro_torch.core.delta import exact_dirty_indices
    from repro_torch.models import lm
    from repro_torch.train.step import GraphedDecodeStep
    cfg, params = _family_setup(dev, "whisper-large-v3")
    b, prefix, gen, cb = 3, 8, 5, 1 << 12
    store = MemoryStore()
    gets = []
    for name in ("get_chunk", "get_chunks"):
        real = getattr(store, name)

        def spy(keys, *a, _real=real, **kw):
            gets.extend([keys] if isinstance(keys, str) else list(keys))
            return _real(keys, *a, **kw)
        setattr(store, name, spy)
    decode = GraphedDecodeStep(cfg)
    toks = torch.randint(0, cfg.vocab_size, (b, prefix),
                         generator=torch.Generator().manual_seed(7),
                         dtype=torch.int32).to(dev)

    def prefill(ns):
        caches = lm.init_caches(cfg, b, prefix + gen, enc_seq=7)
        caches["enc_out"] = _enc_out(cfg, params, b, dev)
        for t in range(prefix):
            decode(params, caches, {"tokens": toks[:, t:t + 1], "index": t})
        ns.set_tree("caches", caches)

    def generate(ns, flavor):
        caches = ns.get_tree("caches")
        tok = (toks[:, -1:] + flavor) % cfg.vocab_size
        for t in range(gen):
            tok, _ = decode(params, caches, {"tokens": tok,
                                             "index": prefix + t})

    sess = KishuSession(store, chunk_bytes=cb, cache_bytes=0)
    sess.register("prefill", prefill)
    sess.register("generate", generate)
    sess.init_state({})
    c0 = sess.run("prefill")
    snap = {n: sess.ns[n].clone() for n in sess.ns.names()
            if n.startswith("caches/")}
    enc_out = sess.ns["caches/enc_out"]
    raw = enc_out.cpu().reshape(-1).view(torch.uint8).numpy().tobytes()
    enc_keys = {chunk_key(raw[i:i + cb]) for i in range(0, len(raw), cb)}
    for flavor in (1, 2):
        sess.run("generate", flavor=flavor)
        gets.clear()
        sess.checkout(c0)
        assert gets and not enc_keys & set(gets)
        assert sess.ns["caches/enc_out"] is enc_out
        for n, t in snap.items():
            assert sess.ns[n].is_cuda
            assert exact_dirty_indices(sess.ns[n], t, cb) == [], n
    sess.close()


def test_train_phase_replays_exactly_on_the_card(dev):
    """A train phase run again from its parent commit reproduces the
    committed state bit for bit (block_diff), as Kishu's fallback
    recomputation assumes; both commits are recorded replay-safe."""
    from repro_torch.core import MemoryStore
    from repro_torch.core.delta import exact_dirty_indices
    from repro_torch.models.config import get_config
    from repro_torch.models.testing import reduced
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import ManagedTrainingSession

    cfg = reduced(get_config("qwen3-1.7b"), n_layers=2)
    s = ManagedTrainingSession(cfg, AdamWConfig(lr=1e-3), MemoryStore(),
                               global_batch=4, seq_len=32, chunk_bytes=4096)
    c0 = s.attach(seed=0)
    c1 = s.train(3)
    want = {n: s.ns[n].clone() for n in s.ns.names()
            if isinstance(s.ns[n], torch.Tensor)}
    loss = s.ns["metrics/last_loss"]
    for _ in range(2):
        s.checkout(c0)
        c = s.train(3)
        assert s.ns["metrics/last_loss"] == loss
        for n, t in want.items():
            assert exact_dirty_indices(s.ns[n], t, 4096) == [], n
        assert s.kishu.graph.nodes[c].stats["replay_safe"] is True
    assert s.kishu.graph.nodes[c1].stats["replay_safe"] is True
    s.close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "uint8",
                                   "bool", "float16"])
def test_tensor_from_bytes_through_pinned_memory(dev, dtype):
    """A load stages its parts in pinned memory and copies them to the card
    asynchronously: the same bytes, dtype and shape as on the CPU."""
    import numpy as np
    from repro_torch.core import serialize as ser
    shape = (37, 129)
    item = torch.empty((), dtype=ser.torch_dtype(dtype)).element_size()
    n = 37 * 129 * item
    raw = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    if dtype == "bool":
        raw &= 1
    data = raw.tobytes()
    parts = [data[:1000], data[1000:1000], data[1000:]]
    want = ser.tensor_from_bytes(data, dtype, shape, "cpu")
    for given_ in (data, raw, parts):
        got = ser.tensor_from_bytes(given_, dtype, shape, dev)
        assert got.is_cuda and got.dtype == want.dtype
        assert tuple(got.shape) == shape and got._base is None
        assert ser.tensor_to_bytes(got) == data \
            == ser.tensor_to_bytes(want)           # bytes: random floats


# ---------------------------------------------------------------------------
# the checkout planner, the fabric, kishud and the baselines on the card
# ---------------------------------------------------------------------------

def _planner_cells(dev):
    def init(ns):
        g = torch.Generator(device="cpu").manual_seed(5)
        ns["w"] = torch.randn(400_000, generator=g).to(dev)
        ns["e"] = torch.randn(300_000, generator=g).to(dev) \
            .to(torch.bfloat16)
        ns["seed"] = torch.arange(4, dtype=torch.float32, device=dev)

    def step(ns, k=1.0):
        ns["w"] = ns["w"] * 0.5 + k

    def derive(ns, scale=1.0):
        ns["big"] = torch.arange(100_000, dtype=torch.float32,
                                 device=ns["seed"].device) \
            * ns["seed"].sum() * scale

    def touch(ns, v=1.0):
        ns["e"][::4096] = v

    return {"init": init, "step": step, "derive": derive, "touch": touch}


def _planner_run(dev, store, mode):
    from repro_torch.core import KishuSession
    s = KishuSession(store, chunk_bytes=1 << 16, cache_bytes=0,
                     plan_mode=mode, device=dev)
    for name, fn in _planner_cells(dev).items():
        s.register(name, fn)
    s.init_state({})
    cids = [s.run("init")]
    for k in (1.0, 2.0):
        cids += [s.run("step", k=k), s.run("derive", scale=k),
                 s.run("touch", v=k)]
    return s, cids


def _exact(ns, snap, cb=1 << 16):
    from repro_torch.core.delta import exact_dirty_indices
    assert sorted(ns.names()) == sorted(snap)
    for n, t in snap.items():
        assert ns[n].is_cuda and ns[n].dtype == t.dtype
        assert exact_dirty_indices(ns[n], t, cb) == [], n


@pytest.mark.parametrize("mode", ["off", "fetch", "replay", "auto"])
def test_planner_modes_on_a_cuda_session(dev, mode):
    """Every planner mode restores the same state bit for bit (block_diff)
    and the stores hold the same chunk keys; forced replay recomputes on
    the card exactly what it planned."""
    from repro_torch.core import MemoryStore
    base, cids = _planner_run(dev, MemoryStore(), "off")
    snaps = {}
    for c in cids:
        base.checkout(c)
        snaps[c] = {n: base.ns[n].clone() for n in base.ns.names()}
    s, cids2 = _planner_run(dev, MemoryStore(), mode)
    assert cids2 == cids
    for c in (cids[1], cids[-1], cids[2], cids[0], cids[4]):
        st = s.checkout(c)
        _exact(s.ns, snaps[c])
        if mode == "replay":
            assert st.covs_recomputed == st.covs_planned_replay
        if mode == "fetch":
            assert st.covs_recomputed == 0
        assert not s.restorer._memo       # replayed tensors let go
    assert set(s.store.list_chunk_keys()) \
        == set(base.store.list_chunk_keys())
    base.close()
    s.close()


def test_mixed_plan_stream_order_on_the_card(dev):
    """A mixed plan (a fetch lane on the helper thread, a replay lane here)
    checked out under a side stream, 20 times: the helper thread issues on
    the caller's stream, and every checkout is exact."""
    from repro_torch.core import MemoryStore
    s, cids = _planner_run(dev, MemoryStore(), "replay")
    s.register("fill", lambda ns, v=1.0: ns.__setitem__(
        "x", torch.full((2_000_000,), v, device=dev)), replay_safe=False)
    s.run("fill", v=1.0)
    c1 = s.run("step", k=3.0)
    want = {n: s.ns[n].clone() for n in s.ns.names()}
    s.run("fill", v=7.0)
    c2 = s.run("step", k=4.0)
    want2 = {n: s.ns[n].clone() for n in s.ns.names()}
    lanes = []
    load_covs = s.loader.load_covs

    def recording(items, stats=None, **kw):
        import threading
        lanes.append((threading.current_thread().name,
                      torch.cuda.current_stream(dev)))
        return load_covs(items, stats, **kw)
    s.loader.load_covs = recording
    side = torch.cuda.Stream(dev)
    for _ in range(20):
        with torch.cuda.stream(side):
            lanes.clear()
            st = s.checkout(c1)
            assert st.covs_planned_fetch >= 1 and st.covs_planned_replay >= 1
            assert any(name == "kishu-fetch-lane" for name, _ in lanes)
            assert all(x == side for _, x in lanes)
            _exact(s.ns, want)
            s.checkout(c2)
            _exact(s.ns, want2)
    s.close()


def test_exec_s_counts_the_cells_device_time(dev):
    """A cell that only launches kernels returns before they finish; its
    exec_s still covers their device time (CUDA events)."""
    from repro_torch.core import KishuSession, MemoryStore
    s = KishuSession(MemoryStore(), cache_bytes=0, device=dev)
    events = {}

    def spin(ns, n=40):
        a = ns["a"]
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            a = a @ a
            a = a / a.abs().amax().clamp_min(1.0)
        e1.record()
        events["ev"] = (e0, e1)
        ns["a"] = a
    s.register("spin", spin)
    s.init_state({"a": torch.randn(4096, 4096, device=dev)})
    s.run("spin")
    e0, e1 = events["ev"]
    e1.synchronize()
    device_s = e0.elapsed_time(e1) / 1e3
    assert device_s > 0.01
    assert s.last_run.exec_s >= device_s
    doc = s.graph.nodes[s.head].stats
    assert doc["exec_s"] == s.last_run.exec_s
    s.close()


def test_kishud_two_tenants_on_the_card(dev):
    from repro_torch.core import MemoryStore
    from repro_torch.launch.kishud import Kishud
    d = Kishud(MemoryStore(), workers=2, lease_ttl_s=30.0,
               chunk_bytes=1 << 16)
    assert d.device.type == "cuda"
    ts = {t: d.session(t) for t in ("alice", "bob")}
    cids = {}
    for i, (t, s) in enumerate(ts.items()):
        s.register("set", lambda ns, v: ns["w"].fill_(v))
        s.init_state({"w": torch.zeros(1_000_000, device=dev)})
        cids[t] = [s.run("set", v=float(i + 1)), s.run("set", v=9.0)]
    for i, (t, s) in enumerate(ts.items()):
        assert s.session.chunk_cache is d.cache and s.session.device == dev
        s.checkout(cids[t][0])
        assert s.ns["w"].is_cuda and torch.all(s.ns["w"] == float(i + 1))
    assert d.cache.hits > 0
    assert d.status()["n_sessions"] == 2
    d.close()


def test_baselines_round_trip_a_cuda_state(dev):
    from repro_torch.core import MemoryStore, Namespace
    from repro_torch.core.baselines import (DetReplaySession, DumpSession,
                                            PageIncremental)
    g = torch.Generator(device="cpu").manual_seed(11)
    want = {"w": torch.randn(70_001, generator=g).to(dev),
            "h": torch.randn(5_000, generator=g).to(torch.bfloat16).to(dev),
            "u": torch.randint(0, 256, (9_999,), generator=g,
                               dtype=torch.uint8).to(dev)}
    for cls in (DumpSession, PageIncremental):
        b = cls(MemoryStore())
        assert b.device.type == "cuda"
        ns = Namespace()
        for k, v in want.items():
            ns[k] = v.clone()
        args = {"parent": None} if cls is PageIncremental else {}
        b.checkpoint(ns, "t1", **args)
        ns["w"].mul_(2)
        ns["u"] = torch.zeros(3, dtype=torch.uint8, device=dev)
        b.checkout(ns, "t1")
        for k, v in want.items():
            assert ns[k].is_cuda and torch.equal(ns[k], v), (cls, k)
    s = DetReplaySession(MemoryStore(), chunk_bytes=1 << 16)
    s.register("double", lambda ns: ns["w"].mul_(2), deterministic=True)
    s.init_state({"w": want["w"].clone()})
    c1 = s.run("double")
    s.run("double")
    st = s.checkout(c1)
    assert st.covs_recomputed >= 1 and s.ns["w"].is_cuda
    assert torch.equal(s.ns["w"], want["w"] * 2)
    s.close()


def test_fabric_checkout_after_replica_wipe_on_the_card(dev, tmp_path):
    import os
    import shutil
    from repro_torch.core import KishuSession, open_store, scrub
    uri = (f"fabric://rep(shard(dir://{tmp_path}/s0,dir://{tmp_path}/s1),"
           f"dir://{tmp_path}/r)")
    s = KishuSession(open_store(uri), chunk_bytes=1 << 16, cache_bytes=0,
                     plan_mode="auto", device=dev)
    cells = _planner_cells(dev)
    for name, fn in cells.items():
        s.register(name, fn)
    s.init_state({})
    c0 = s.run("init")
    want = {n: s.ns[n].clone() for n in s.ns.names()}
    c1 = s.run("touch", v=3.0)
    want1 = {n: s.ns[n].clone() for n in s.ns.names()}
    shutil.rmtree(tmp_path / "r" / "chunks")
    os.makedirs(tmp_path / "r" / "chunks")
    s.checkout(c0)
    _exact(s.ns, want)
    assert scrub(open_store(uri), repair=True).remaining == 0
    for sub in ("s1",):
        shutil.rmtree(tmp_path / sub / "chunks")
        os.makedirs(tmp_path / sub / "chunks")
    s.checkout(c1)
    _exact(s.ns, want1)
    s.close()
    assert scrub(open_store(uri), repair=True).remaining == 0
    assert scrub(open_store(uri)).problems == 0


@pytest.mark.parametrize("changed", ["none", "small", "w", "emb"])
def test_replayed_attach_is_checked_on_the_card(dev, tmp_path, changed):
    """CUDA tensors attached — one smaller than a chunk, two spanning
    several — then changed (in place for ``changed``, by rebinding for the
    others) and every chunk lost.  The fallback replays the attach and the
    chunk_hash kernel holds the replayed bytes against the commit: an
    unchanged attach restores exactly, one changed in place raises."""
    import os
    import shutil
    from repro_torch.core import KishuSession, open_store
    from repro_torch.core.restore import RestoreError, check_against_manifest
    from repro_torch.kernels import _lib
    g = torch.Generator(device="cpu").manual_seed(5)
    vals = {"small": torch.randn(37, generator=g).to(dev),      # 148 B
            "w": torch.randn(300_001, generator=g).to(dev),     # 293 chunks
            "emb": torch.randn(64, 1000, generator=g)
            .to(torch.bfloat16).to(dev)}                        # 32 chunks
    want = {n: v.clone() for n, v in vals.items()}
    s = KishuSession(open_store(f"dir://{tmp_path}/cas"), chunk_bytes=4096,
                     cache_bytes=0, device=dev, plan_mode="fetch")

    def bump(ns):
        for n in vals:
            if n == changed:
                ns[n].add_(1.0)
            else:
                ns[n] = ns[n] + 1.0
    s.register("bump", bump)
    c0 = s.init_state(dict(vals))
    s.run("bump")
    n_chunks = {n: len(s.graph.manifest_of((n,), c0)["base"]["chunks"])
                for n in vals}
    assert n_chunks == {"small": 1, "w": 293, "emb": 32}
    shutil.rmtree(tmp_path / "cas" / "chunks")
    os.makedirs(tmp_path / "cas" / "chunks")
    if changed == "none":
        assert s.checkout(c0).covs_recomputed == 3
        for n in vals:
            assert s.ns[n].is_cuda and torch.equal(s.ns[n], want[n]), n
        for n in vals:                       # the kernel hashes the check
            before = _lib.launches()["chunk_hash"]
            check_against_manifest((n,), c0, s.graph.manifest_of((n,), c0),
                                   {n: want[n]})
            assert _lib.launches()["chunk_hash"] == before + 1, n
    else:
        with pytest.raises(RestoreError,
                           match=rf"\('{changed}',\) @ .* differs from the "
                                 rf"commit at chunk 0 of "
                                 rf"{n_chunks[changed]}"):
            s.checkout(c0)
    s.close()


# ---------------------------------------------------------------------------
# bf16 products with float32 accumulation (einsum_f32's card route)
# ---------------------------------------------------------------------------

def _route_equations():
    from test_torch_einsum_route import TWO_OPERAND, _operands
    return TWO_OPERAND, _operands


def test_einsum_f32_makes_no_float32_copy_of_its_weight(dev):
    """A 64 MiB bf16 weight through ``bsd,df->bsf``: the peak above the
    operands stays under half the weight's float32 copy (128 MiB); the
    upcast path, for contrast, allocates that copy."""
    from repro_torch.models import layers
    w = torch.randn(4096, 8192, device=dev).to(torch.bfloat16)
    x = torch.randn(1, 8, 4096, device=dev).to(torch.bfloat16)
    copy = w.numel() * 4
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y = layers.einsum_f32("bsd,df->bsf", x, w)
    torch.cuda.synchronize()
    assert y.dtype == torch.float32
    assert torch.cuda.max_memory_allocated() - base < copy // 2
    torch.cuda.reset_peak_memory_stats()
    up = torch.einsum("bsd,df->bsf", x.float(), w.float())
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base >= copy
    del up


@pytest.mark.parametrize("reduced_precision", [False, True])
def test_einsum_f32_route_matches_the_upcast_path(dev, reduced_precision):
    """Every two-operand equation of the port, bf16 and f16 operands: the
    cuBLAS route's float32 result against the upcast einsum's, within
    float32 summation-order error (2**-16 of the sum of |products|),
    whether or not bf16 reduced-precision reductions are allowed — the
    flag must not reach a float32-output product."""
    from repro_torch.models import layers
    eqs, operands = _route_equations()
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        reduced_precision
    try:
        for eq in eqs:
            for dtype in (torch.bfloat16, torch.float16):
                a, b = [o.to(dev) for o in operands(eq, 7, dtype)]
                a = a * 16                       # longer contractions too
                got = layers.einsum_f32(eq, a, b)
                want = torch.einsum(eq, a.float(), b.float())
                scale = torch.einsum(eq, a.float().abs(), b.float().abs())
                assert got.dtype == torch.float32
                assert bool((got - want).abs().le(
                    scale * 2.0 ** -16 + 1e-30).all()), (eq, dtype)
            a = torch.randn(64, 4096, device=dev).to(torch.bfloat16)
            b = torch.randn(4096, 512, device=dev).to(torch.bfloat16)
            got = layers.einsum_f32("td,de->te", a, b)
            want = a.float() @ b.float()
            assert float((got - want).abs().max()) < 1e-3
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flag


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-780m",
                                  "phi3.5-moe-42b-a6.6b",
                                  "deepseek-v3-671b", "whisper-large-v3"])
def test_every_call_site_takes_the_route_and_keeps_its_dtype(
        dev, arch, monkeypatch):
    """A bf16 forward and decode step of each family: every two-operand
    ``einsum_f32`` call with bf16 operands takes the cuBLAS route, every
    call returns float32 (each call site then casts as the JAX package
    does), and the logits are float32 and close to the upcast path's."""
    from repro_torch.models import layers, lm, mamba
    from repro_torch.models import moe as moe_lib
    cfg, params = _family_setup(dev, arch)
    seen = []
    real = layers.einsum_f32

    def spy(eq, *ops):
        out = real(eq, *ops)
        seen.append((eq, [o.dtype for o in ops], layers._half_on_card(ops),
                     out.dtype))
        return out
    for mod in (layers, mamba, moe_lib):
        monkeypatch.setattr(mod, "einsum_f32", spy)
    b, s = 2, 8
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=g).to(dev)}
    if cfg.enc_dec:
        batch["enc_embeds"] = torch.randn(b, s, cfg.d_model, generator=g) \
            .to(dev, torch.bfloat16)
    with torch.no_grad():
        logits = lm.forward(cfg, params, batch, training=True)
    assert logits.dtype == torch.float32
    two = [x for x in seen if len(x[1]) == 2]
    assert two and all(x[3] == torch.float32 for x in seen)
    for eq, dts, routed, _ in two:
        half = dts[0] == dts[1] == torch.bfloat16
        assert routed == half, (eq, dts)
    monkeypatch.setattr(layers, "_half_on_card", lambda ops: False)
    with torch.no_grad():
        up = lm.forward(cfg, params, batch, training=True)
    tol = 0.05 * float(up.abs().max())
    assert float((logits - up).abs().max()) <= tol


def test_backward_through_a_bf16_dense_layer_matches_the_upcast(
        dev, monkeypatch):
    """Backward through the route's autograd function against the upcast
    path's.  One bf16 dense product: the backward splits the float32
    cotangent exactly into three bf16 parts, so each gradient element is
    within one bf16 rounding step (2**-7 relative, plus 2**-16 of the
    largest where a sum cancels) and fewer than 1% differ at all.  A bf16
    SwiGLU MLP (three products in a chain, each gradient rounded to bf16
    on the way): within 2**-6 of the largest."""
    from repro_torch.models import layers
    gen = torch.Generator(device=dev).manual_seed(0)
    x0 = torch.randn(4, 16, 256, device=dev, generator=gen) \
        .to(torch.bfloat16)
    w0 = (torch.randn(256, 512, device=dev, generator=gen) / 16) \
        .to(torch.bfloat16)
    p0 = layers.mlp_init(gen, 256, 512, torch.bfloat16)
    dense, mlp = [], []
    for routed in (True, False):
        if not routed:
            monkeypatch.setattr(layers, "_half_on_card", lambda ops: False)
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        y = layers.einsum_f32("bsd,df->bsf", x, w)
        (y.square().sum() * 0.5).backward()
        assert x.grad.dtype == w.grad.dtype == torch.bfloat16
        dense.append((x.grad.float(), w.grad.float()))
        p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        x = x0.clone().requires_grad_(True)
        layers.mlp_forward(p, x).float().square().mean().backward()
        mlp.append([x.grad.float()] + [p[k].grad.float() for k in p])
    for got, want in zip(*dense):
        d = (got - want).abs()
        tol = 2.0 ** -7 * want.abs() + 2.0 ** -16 * want.abs().max()
        assert bool(d.le(tol).all())
        assert float(d.gt(0).float().mean()) < 0.01
    for got, want in zip(*mlp):
        tol = 2.0 ** -6 * float(want.abs().max())
        assert float((got - want).abs().max()) <= tol


def test_dtensor_einsum_runs_the_route_on_local_shards(dev, tmp_path):
    """bf16 DTensor operands on a one-rank NCCL (1, 1) mesh: the product
    runs on the local shards through the cuBLAS route, with no float32
    copy of the 64 MiB weight, and equals the plain route, forward and
    backward, bit for bit."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import init_file_group, make_local_mesh
    from repro_torch.models import layers
    init_file_group("nccl", 0, 1, str(tmp_path / "pg"))
    try:
        mesh = make_local_mesh(model=1)
        w0 = torch.randn(4096, 8192, device=dev).to(torch.bfloat16)
        x0 = torch.randn(2, 8, 4096, device=dev).to(torch.bfloat16)
        w = distribute_tensor(w0, mesh, [Replicate(), Shard(1)])
        x = distribute_tensor(x0, mesh, [Shard(0), Replicate()])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y = layers.einsum_f32("bsd,df->bsf", x, w)
        torch.cuda.synchronize()
        assert y.dtype == torch.float32
        assert torch.cuda.max_memory_allocated() - base < w0.numel() * 2
        assert torch.equal(y.full_tensor(),
                           layers.einsum_f32("bsd,df->bsf", x0, w0))
        got, want = [], []
        for a, b, out in ((x, w, got), (x0, w0, want)):
            a = a.detach().requires_grad_(True)
            b = b.detach().requires_grad_(True)
            yy = layers.einsum_f32("bsd,df->bsf", a, b)
            (yy.square().sum() * 0.5).backward()
            out += [a.grad, b.grad]
        assert all(torch.equal(g.full_tensor(), h)
                   for g, h in zip(got, want))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# decode at a full cache, and on sharded caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pieces", [1, 2, 4])
def test_split_attention_over_cut_caches_matches_attention_core(
        dev, dtype, pieces):
    """``layers.split_attention`` over a cache cut into 1, 2 and 4 pieces
    along the sequence, its reductions over a list of the pieces' tensors,
    against ``attention_core`` on the whole cache: float32 atol/rtol
    1e-5; bf16 within one bf16 rounding of the output (rtol 2**-7, atol
    2**-8 of the largest), as the two differ only in how the softmax sums
    its exponentials."""
    import functools
    from repro_torch.models import layers
    g = torch.Generator(device="cpu").manual_seed(pieces)
    b, s, hq, hkv, hd, index = 3, 64, 8, 2, 64, 41
    q = torch.randn(b, 1, hq, hd, generator=g).to(dtype).to(dev)
    k = torch.randn(b, s, hkv, hd, generator=g).to(dtype).to(dev)
    v = torch.randn(b, s, hkv, hd, generator=g).to(dtype).to(dev)
    idx = torch.tensor(index, dtype=torch.int32, device=dev)
    want = layers.attention_core(q, k, v, causal=True, q_offset=idx)
    n = s // pieces
    got = layers.split_attention(
        q, list(k.split(n, dim=1)), list(v.split(n, dim=1)),
        list(range(0, s, n)), q_offset=idx,
        reduce_max=lambda xs: functools.reduce(torch.maximum, xs),
        reduce_sum=lambda xs: functools.reduce(torch.add, xs))
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        d = (got.float() - want.float()).abs()
        tol = 2.0 ** -7 * want.float().abs() \
            + 2.0 ** -8 * float(want.float().abs().max())
        assert bool(d.le(tol).all()), float(d.max())


def test_graphed_decode_at_a_full_cache(dev):
    """Decode past a full cache (index S .. S+2 on S slots): the graph
    replays with no device assert, equals the eager step bit for bit,
    and gives the CPU port's logits and caches (the JAX clamp: the new
    row lands in slot S-1), float32."""
    from repro_torch.models import lm
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train.step import GraphedDecodeStep
    cfg, params = _serve_setup(dev, "float32")
    b, s, steps = 2, 4, 7
    toks = torch.randint(0, cfg.vocab_size, (b, steps),
                         generator=torch.Generator().manual_seed(3),
                         dtype=torch.int32)
    graphed = GraphedDecodeStep(cfg)
    cg = lm.init_caches(cfg, b, s, device=dev)
    ce = lm.init_caches(cfg, b, s, device=dev)
    p_cpu = tree_map(lambda t: t.cpu(), params)
    cc = lm.init_caches(cfg, b, s, device="cpu")
    for t in range(steps):
        tok = toks[:, t:t + 1]
        lg, _, _ = graphed.with_logits(params, cg, {"tokens": tok.to(dev),
                                                    "index": t})
        with torch.no_grad():
            le, _ = lm.decode_step(cfg, params, ce, {"tokens": tok.to(dev),
                                                     "index": t})
            lc, _ = lm.decode_step(cfg, p_cpu, cc, {"tokens": tok,
                                                    "index": t})
        torch.cuda.synchronize()
        assert torch.equal(lg, le), t
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
    assert graphed.captures == 1 and _leaves_equal(cg, ce)
    for g, w in zip(_flat_leaves(cg), _flat_leaves(cc)):
        torch.testing.assert_close(g.cpu(), w, atol=1e-5, rtol=1e-4)


def _flat_leaves(tree):
    from repro_torch.optim.adamw import tree_leaves
    return tree_leaves(tree) if isinstance(tree, dict) else [tree]


def _sharded_smollm(dev, tmp_path, dtype="float32"):
    """A one-rank NCCL group, a (1, 1) mesh, reduced smollm params under
    ShardingRules: (cfg, plain params, DTensor params, rules, mesh)."""
    from repro_torch.launch.mesh import init_file_group, make_local_mesh
    from repro_torch.sharding.rules import ShardingRules, distribute_tree
    init_file_group("nccl", 0, 1, str(tmp_path / "pg"))
    mesh = make_local_mesh(model=1)
    cfg, params = _serve_setup(dev, dtype)
    rules = ShardingRules(cfg, mesh)
    dparams = distribute_tree(params, mesh, rules.param_shardings(params))
    return cfg, params, dparams, rules, mesh


def test_graphed_sharded_decode_equals_the_eager_sharded_step(dev,
                                                               tmp_path):
    """The sharded step captured: DTensor params under ShardingRules and
    caches under ``shard_caches`` on a one-rank NCCL (1, 1) mesh, seven
    teacher-forced steps on 4-slot caches (the last three past a full
    cache) through the graph and through the eager sharded step on caches
    of their own: the same logits, tokens and cache bytes at every step,
    bit for bit (the same kernels in the same order, the collectives among
    them), from one capture; the caches keep their local storage and the
    outputs are DTensors on the eager step's placements."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.models import lm
    from repro_torch.sharding.rules import shard_caches
    from repro_torch.train.step import GraphedDecodeStep, _greedy_step
    cfg, params, dparams, rules, mesh = _sharded_smollm(dev, tmp_path)
    try:
        b, s, steps = 2, 4, 7
        toks = torch.randint(0, cfg.vocab_size, (b, steps), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(5), dtype=torch.int32)
        tok_pl = list(rules.batch_spec({"t": toks[:, :1]})["t"])
        cg = shard_caches(lm.init_caches(cfg, b, s, device=dev), rules, b)
        ce = shard_caches(lm.init_caches(cfg, b, s, device=dev), rules, b)
        ptrs = [t.to_local().data_ptr() for t in _flat_leaves(cg)]
        graphed = GraphedDecodeStep(cfg)
        for t in range(steps):
            tok = distribute_tensor(toks[:, t:t + 1], mesh, tok_pl)
            lg, nxt, _ = graphed.with_logits(dparams, cg, {"tokens": tok,
                                                           "index": t})
            le, ne = _greedy_step(cfg, dparams, ce, {"tokens": tok,
                                                     "index": t})
            torch.cuda.synchronize()
            assert isinstance(lg, DTensor) and isinstance(nxt, DTensor)
            assert lg.placements == le.placements
            assert nxt.placements == ne.placements
            assert torch.equal(lg.to_local(), le.to_local()), t
            assert torch.equal(nxt.to_local(), ne.to_local()), t
            assert all(torch.equal(x.to_local(), y.to_local()) for x, y
                       in zip(_flat_leaves(cg), _flat_leaves(ce))), t
        assert graphed.captures == 1 and graphed.capture_s > 0
        assert [t.to_local().data_ptr() for t in _flat_leaves(cg)] == ptrs
    finally:
        dist.destroy_process_group()


def test_graphed_sharded_decode_after_a_patch_rollback_does_not_recapture(
        dev, tmp_path):
    """A KishuSession over the one-rank NCCL group holds DTensor caches;
    the graphed sharded step fills a prefix and generates; a checkout back
    to the prefix patches every cache leaf in place (K and V by chunk, the
    one-chunk ``index`` whole), so the next generation replays the same
    graph — one capture in all — and gives the same tokens and the same
    cache bytes as the first."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.core import KishuSession, MemoryStore
    from repro_torch.models import lm
    from repro_torch.sharding.rules import shard_caches
    from repro_torch.train.step import GraphedDecodeStep
    cfg, params, dparams, rules, mesh = _sharded_smollm(dev, tmp_path)
    try:
        b, prefix, gen, slots = 2, 6, 4, 64
        prompts = torch.randint(0, cfg.vocab_size, (b, prefix), device=dev,
                                generator=torch.Generator(device=dev)
                                .manual_seed(6), dtype=torch.int32)
        tok_pl = list(rules.batch_spec({"t": prompts[:, :1]})["t"])
        graphed = GraphedDecodeStep(cfg)

        def step(caches, tok, index):
            nxt, _ = graphed(dparams, caches, {
                "tokens": distribute_tensor(tok, mesh, tok_pl),
                "index": index})
            return nxt.full_tensor()

        def prefill(ns):
            caches = shard_caches(lm.init_caches(cfg, b, slots, device=dev),
                                  rules, b)
            for t in range(prefix):
                tok = step(caches, prompts[:, t:t + 1], t)
            ns.set_tree("caches", caches)
            ns["last_tok"], ns["pos"] = tok, prefix

        def generate(ns):
            caches = ns.get_tree("caches")
            tok, pos, outs = ns["last_tok"], ns["pos"], []
            for t in range(gen):
                tok = step(caches, tok, pos + t)
                outs.append(tok)
            ns["last_tok"], ns["pos"] = tok, pos + gen
            ns["generated"] = torch.cat(outs, 1)

        sess = KishuSession(MemoryStore(), chunk_bytes=1 << 10, device=dev,
                            group=dist.group.WORLD)
        sess.register("prefill", prefill)
        sess.register("generate", generate)
        sess.init_state({})
        c0 = sess.run("prefill")
        names = sorted(n for n in sess.ns.names() if n.startswith("caches/"))
        ptrs = {n: sess.ns[n].to_local().data_ptr() for n in names}
        sess.run("generate")
        first = sess.ns["generated"].clone()
        after = {n: sess.ns[n].to_local().clone() for n in names}
        assert graphed.captures == 1
        st = sess.checkout(c0)
        assert st.covs_patched >= len(names)
        assert all(isinstance(sess.ns[n], DTensor) for n in names)
        assert {n: sess.ns[n].to_local().data_ptr() for n in names} == ptrs
        sess.run("generate")
        assert graphed.captures == 1
        assert torch.equal(sess.ns["generated"], first)
        for n in names:
            assert torch.equal(sess.ns[n].to_local(), after[n]), n
        sess.close()
    finally:
        dist.destroy_process_group()


def test_sharded_moe_train_step_on_one_nccl_rank_matches_the_plain_step(
        dev, tmp_path):
    """Two train steps of a float32 reduced phi3.5-moe with params and
    moments under ShardingRules on a one-rank NCCL (1, 1) mesh, inside the
    MoE weight-gather context, against the plain step from the same
    state: loss within 1e-5, every parameter within 2e-2 and each leaf's
    change within 2e-5 of the plain change (the backward crosses the
    dispatch's gather and un-gather and the aux loss's)."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.core.namespace import flatten_tree
    from repro_torch.launch.mesh import init_file_group, make_local_mesh
    from repro_torch.models.config import get_config
    from repro_torch.models.testing import reduced
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import context as shctx
    from repro_torch.sharding.rules import ShardingRules, shard_train_state
    from repro_torch.train import step as tstep
    init_file_group("nccl", 0, 1, str(tmp_path / "pg"))
    try:
        mesh = make_local_mesh(model=1)
        cfg = reduced(get_config("phi3.5-moe-42b-a6.6b"), n_layers=2)
        opt = AdamWConfig(lr=1e-3, eps=1e-6)
        rules = ShardingRules(cfg, mesh)
        plain = tstep.init_train_state(cfg, 0, opt, device=dev)
        state = shard_train_state(tstep.init_train_state(cfg, 0, opt,
                                                         device=dev), rules)
        b, s = 4, 16
        hidden = (mesh, rules.hidden_spec(b, s))
        sharded_fn = tstep.make_train_step(cfg, opt, hidden_sharding=hidden)
        plain_fn = tstep.make_train_step(cfg, opt)
        g = torch.Generator(device=dev).manual_seed(12)
        for _ in range(2):
            bt = {k: torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                                   generator=g, dtype=torch.int32)
                  for k in ("tokens", "labels")}
            pl = rules.batch_spec(bt)
            before = {k: v.float().clone() for k, v in
                      flatten_tree(plain["params"]).items()}
            before_s = {k: v.full_tensor().float().clone() for k, v in
                        flatten_tree(state["params"]).items()}
            with shctx.moe_weight_gather(rules):
                state, m = sharded_fn(state, {
                    k: distribute_tensor(v, mesh, list(pl[k]))
                    for k, v in bt.items()})
            plain, pm = plain_fn(plain, bt)
            assert abs(float(m["loss"].full_tensor()) - float(pm["loss"])) \
                < 1e-5
            got = flatten_tree(state["params"])
            for k, want in flatten_tree(plain["params"]).items():
                x = got[k].full_tensor().float()
                torch.testing.assert_close(x, want.float(), atol=2e-2,
                                           rtol=2e-2)
                torch.testing.assert_close(x - before_s[k],
                                           want.float() - before[k],
                                           atol=2e-5, rtol=0)
    finally:
        dist.destroy_process_group()


def test_sharded_decode_on_one_nccl_rank_matches_the_plain_step(dev,
                                                                tmp_path):
    """Params under ShardingRules and caches under ``shard_caches`` on a
    one-rank NCCL (1, 1) mesh: seven teacher-forced steps on 4-slot
    caches (the last three past a full cache) against the plain eager
    step, float32 (logits atol/rtol 1e-4, caches 1e-5 / 1e-4); each step
    issues its three reductions per attention layer (``CommDebugMode``),
    so it cannot pass on the plain path; the caches stay DTensors on the
    card, written in place."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.models import lm
    from repro_torch.sharding.rules import shard_caches
    from repro_torch.train.step import make_decode_step, spmd
    cfg, params, dparams, rules, mesh = _sharded_smollm(dev, tmp_path)
    try:
        b, s, steps = 2, 4, 7
        toks = torch.randint(0, cfg.vocab_size, (b, steps), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(4), dtype=torch.int32)
        plain = lm.init_caches(cfg, b, s, device=dev)
        sharded = shard_caches(lm.init_caches(cfg, b, s, device=dev), rules, b)
        ptrs = [t.to_local().data_ptr() for t in _flat_leaves(sharded)]
        tok_pl = list(rules.batch_spec({"t": toks[:, :1]})["t"])
        for t in range(steps):
            tok = toks[:, t:t + 1]
            comm = CommDebugMode()
            with torch.no_grad(), spmd(dparams), comm:
                got, _ = lm.decode_step(cfg, dparams, sharded, {
                    "tokens": distribute_tensor(tok, mesh, tok_pl),
                    "index": t})
            with torch.no_grad():
                want, _ = lm.decode_step(cfg, params, plain,
                                         {"tokens": tok, "index": t})
            n = sum(v for k, v in comm.get_comm_counts().items()
                    if str(k).endswith("all_reduce"))
            assert n >= 3 * cfg.n_layers, (t, n)
            torch.testing.assert_close(got.full_tensor(), want, atol=1e-4,
                                       rtol=1e-4)
        leaves = _flat_leaves(sharded)
        assert all(isinstance(x, DTensor) and x.to_local().is_cuda
                   for x in leaves)
        assert [x.to_local().data_ptr() for x in leaves] == ptrs
        for g, w in zip(leaves, _flat_leaves(plain)):
            torch.testing.assert_close(g.full_tensor(), w, atol=1e-5,
                                       rtol=1e-4)
        nxt, _ = make_decode_step(cfg)(dparams, sharded, {
            "tokens": distribute_tensor(toks[:, -1:], mesh, tok_pl),
            "index": steps})
        assert isinstance(nxt, DTensor) and nxt.shape == (b, 1)
    finally:
        dist.destroy_process_group()
