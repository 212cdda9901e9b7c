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


@pytest.mark.parametrize("rows,w", [(1, 32), (3, 1024), (5, 4096),
                                    (2, 262144)])
def test_codec_kernel_matches_plain(dev, rows, w):
    from repro_torch.kernels.delta_codec.ops import (codec_encode_cuda,
                                                     codec_encode_plain,
                                                     i32_bits)
    g = torch.Generator(device="cpu").manual_seed(rows * w)
    x = torch.randint(0, 1 << 10, (rows, w), generator=g, dtype=torch.int64)
    x[:, : w // 3] = 0
    x[0, w // 2:] = 0xFFFFFFFF
    x = x.to(dev)
    gw = min(1024, w)
    m, n, p = codec_encode_cuda(i32_bits(x), gw)
    pm, pn, pp = codec_encode_plain(x, gw)
    assert n == pn
    assert torch.equal(m.to(torch.int64) & 0xFFFFFFFF, pm)
    assert torch.equal(p, i32_bits(pp))


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
            assert all(v > 0 for v in _lib.launches().values()), \
                _lib.launches()
        out[device] = (dict(store.chunks), back,
                       {n: s.ns[n].cpu() for n in s.ns.names()})
        s.close()
    assert out["cpu"][0] == out["cuda"][0]
    for i in (1, 2):
        for n in out["cpu"][i]:
            assert torch.equal(out["cpu"][i][n], out["cuda"][i][n]), n


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
