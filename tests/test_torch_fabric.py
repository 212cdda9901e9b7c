"""The port's storage fabric: hash ring, sharded scatter-gather,
replicated read-repair, tiered promotion/demotion, fabric:// topologies,
fleet ops (topology / scrub / rebalance), session-level fault tolerance on
``device="cpu"`` sessions over torch tensors, and the fabric's CLI verbs.

With jax present, the port is held against the JAX package: both rings
place every key on the same shard, the same cells write the same chunk
files to each shard of a ``fabric://shard(...)`` store, and each package
checks out, scrubs and verifies the other's fabric.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.core import (FaultInjectedStore, KishuSession, MemoryStore,
                        ReplicatedStore, ShardedStore, TieredStore,
                        open_store, rebalance, scrub)
from repro_torch.core.chunkstore import DirectoryStore, chunk_key
from repro_torch.core.fabric import HashRing, parse_size, parse_topology
from repro_torch.core.serialize import ChunkMissingError
from repro_torch.launch.kishu_cli import main as cli


def _pairs(n, tag="chunk"):
    out = []
    for i in range(n):
        d = f"{tag}-{i}".encode() * 7
        out.append((chunk_key(d), d))
    return out


# ---------------------------------------------------------------------------
# hash ring
# ---------------------------------------------------------------------------

def test_ring_deterministic_and_covering():
    r1, r2 = HashRing(4), HashRing(4)
    keys = [chunk_key(bytes([i & 255, i >> 8])) for i in range(1000)]
    homes = [r1.shard_for(k) for k in keys]
    assert homes == [r2.shard_for(k) for k in keys]      # deterministic
    counts = [homes.count(s) for s in range(4)]
    assert all(c > 100 for c in counts), counts          # roughly uniform


def test_ring_consistency_on_growth():
    """Adding one shard must move only a minority of keys (the consistent-
    hashing contract rebalance relies on)."""
    keys = [chunk_key(bytes([i & 255, i >> 8])) for i in range(2000)]
    r4, r5 = HashRing(4), HashRing(5)
    moved = sum(r4.shard_for(k) != r5.shard_for(k) for k in keys)
    assert 0 < moved < len(keys) // 2, moved


def test_ring_rejects_empty():
    with pytest.raises(ValueError):
        HashRing(0)


# ---------------------------------------------------------------------------
# sharded store
# ---------------------------------------------------------------------------

def test_sharded_roundtrip_and_placement():
    shards = [MemoryStore() for _ in range(4)]
    ss = ShardedStore(shards)
    pairs = _pairs(100)
    assert ss.put_chunks(pairs) == 100
    assert ss.get_chunks([k for k, _ in pairs]) == dict(pairs)
    assert ss.n_chunks() == 100
    assert sum(s.n_chunks() for s in shards) == 100      # no duplication
    assert all(s.n_chunks() > 0 for s in shards)         # all shards used
    for k, _ in pairs:                                   # ring placement
        assert shards[ss.home(k)].has_chunk(k)


def test_sharded_single_ops_and_missing():
    ss = ShardedStore([MemoryStore(), MemoryStore()])
    k, d = _pairs(1)[0]
    assert ss.put_chunk(k, d) is True
    assert ss.put_chunk(k, d) is False                   # CAS dedup
    assert ss.get_chunk(k) == d
    assert ss.has_chunk(k)
    with pytest.raises(ChunkMissingError):
        ss.get_chunk("f" * 32)
    assert ss.get_chunks(["f" * 32], missing_ok=True) == {}
    with pytest.raises(ChunkMissingError):
        ss.get_chunks([k, "f" * 32])


def test_sharded_stray_read_heals_placement():
    """A chunk sitting on the wrong shard (ring change, manual surgery) is
    served, copied home, and removed from the stray shard."""
    shards = [MemoryStore() for _ in range(3)]
    ss = ShardedStore(shards)
    k, d = _pairs(1, "stray")[0]
    stray = (ss.home(k) + 1) % 3
    shards[stray].put_chunk(k, d)
    assert ss.get_chunk(k) == d
    assert ss.heals == 1
    assert shards[ss.home(k)].has_chunk(k)
    assert not shards[stray].has_chunk(k)
    # batched path heals too
    k2, d2 = _pairs(1, "stray2")[0]
    stray2 = (ss.home(k2) + 1) % 3
    shards[stray2].put_chunk(k2, d2)
    assert ss.get_chunks([k, k2]) == {k: d, k2: d2}
    assert shards[ss.home(k2)].has_chunk(k2)
    assert not shards[stray2].has_chunk(k2)


def test_sharded_meta_mirrored_survives_shard_loss():
    shards = [MemoryStore() for _ in range(3)]
    ss = ShardedStore(shards)
    ss.put_meta("commit/c1", {"a": 1})
    ss.put_meta("HEAD", {"head": "c1"})
    shards[0].meta.clear()                               # lose one shard
    assert ss.get_meta("commit/c1") == {"a": 1}
    assert ss.list_meta("commit/") == ["commit/c1"]


def test_sharded_delete_sweeps_strays():
    shards = [MemoryStore() for _ in range(2)]
    ss = ShardedStore(shards)
    k, d = _pairs(1)[0]
    shards[0].put_chunk(k, d)
    shards[1].put_chunk(k, d)                            # stray copy too
    ss.delete_chunk(k)
    assert not any(s.has_chunk(k) for s in shards)
    pairs = _pairs(20)
    ss.put_chunks(pairs)
    assert ss.delete_chunks([k for k, _ in pairs]) == 20
    assert ss.n_chunks() == 0


# ---------------------------------------------------------------------------
# replicated store
# ---------------------------------------------------------------------------

def test_replicated_writes_land_everywhere():
    reps = [MemoryStore() for _ in range(3)]
    rs = ReplicatedStore(reps)
    pairs = _pairs(25)
    assert rs.put_chunks(pairs) == 25
    assert all(r.n_chunks() == 25 for r in reps)
    assert rs.n_chunks() == 25                           # logical, not 75


def test_replicated_read_repair_on_lost_replica():
    reps = [MemoryStore() for _ in range(2)]
    rs = ReplicatedStore(reps)
    pairs = _pairs(30)
    rs.put_chunks(pairs)
    reps[0].chunks.clear()                               # replica 0 dies
    assert rs.get_chunks([k for k, _ in pairs]) == dict(pairs)
    assert rs.replica_misses == 30
    assert rs.repairs == 30
    assert reps[0].n_chunks() == 30                      # healed in place
    assert scrub(rs).problems == 0


def test_replicated_serves_through_injected_fault():
    """FaultInjectedStore killing one replica: every read still succeeds."""
    healthy = MemoryStore()
    dead = FaultInjectedStore(MemoryStore(), fail_get=lambda k: True)
    rs = ReplicatedStore([dead, healthy])
    pairs = _pairs(10)
    rs.put_chunks(pairs)
    assert rs.get_chunk(pairs[0][0]) == pairs[0][1]
    assert rs.get_chunks([k for k, _ in pairs]) == dict(pairs)


def test_replicated_write_survives_dead_replica():
    """A replica whose writes *raise* (full/read-only disk) must not take
    down checkpointing: the write lands on the live replicas and the dead
    one heals later via read-repair/scrub."""
    class BrokenWrites(MemoryStore):
        def put_chunk(self, key, data):
            raise OSError("disk full")

        def put_chunks(self, pairs):
            raise OSError("disk full")

    healthy = MemoryStore()
    rs = ReplicatedStore([BrokenWrites(), healthy])
    pairs = _pairs(8)
    assert rs.put_chunks(pairs) == 8
    k, d = _pairs(1, "single")[0]
    assert rs.put_chunk(k, d) is True
    assert healthy.n_chunks() == 9
    assert rs.write_errors == 2
    assert rs.get_chunks([k for k, _ in pairs]) == dict(pairs)
    # every replica broken -> the write error surfaces
    rs_dead = ReplicatedStore([BrokenWrites(), BrokenWrites()])
    with pytest.raises(OSError):
        rs_dead.put_chunk(k, d)


def test_repair_and_heal_preserve_stored_compression():
    """Read-repair and stray-healing move chunks in *stored* form: a
    compressed chunk must stay compressed on the healed replica/shard."""
    from repro_torch.core import CompressedStore
    data = b"Z" * 8192                                   # very compressible
    k = chunk_key(data)
    # replicated under an outer codec (the fabric://...?codec= shape)
    reps = [MemoryStore() for _ in range(2)]
    cs = CompressedStore(ReplicatedStore(reps), "zlib")
    cs.put_chunk(k, data)
    stored = reps[1].chunks[k]
    assert len(stored) < len(data)
    reps[0].chunks.clear()
    assert cs.get_chunk(k) == data                       # read-repairs
    assert reps[0].chunks[k] == stored                   # byte-identical copy
    # sharded stray heal
    shards = [MemoryStore() for _ in range(2)]
    ss = ShardedStore(shards)
    stray = (ss.home(k) + 1) % 2
    shards[stray].chunks[k] = stored                     # misplaced, framed
    assert ss.get_chunk(k) == data
    assert shards[ss.home(k)].chunks[k] == stored        # moved, still framed


def test_scrub_counts_logical_chunks_once():
    """chunks_checked reports logical chunks, not per-replica/per-level
    physical copies."""
    nested = ShardedStore([
        ReplicatedStore([MemoryStore(), MemoryStore()]),
        ReplicatedStore([MemoryStore(), MemoryStore()])])
    pairs = _pairs(40)
    nested.put_chunks(pairs)
    assert scrub(nested, deep=True).chunks_checked == 40
    assert scrub(nested).chunks_checked == 40


def test_replicated_lost_everywhere_raises():
    rs = ReplicatedStore([MemoryStore(), MemoryStore()])
    with pytest.raises(ChunkMissingError):
        rs.get_chunk("f" * 32)
    with pytest.raises(ChunkMissingError):
        rs.get_chunks(["f" * 32])
    assert rs.get_chunks(["f" * 32], missing_ok=True) == {}


def test_replicated_scrub_repair_heals_partial_loss():
    reps = [MemoryStore() for _ in range(3)]
    rs = ReplicatedStore(reps)
    pairs = _pairs(12)
    rs.put_chunks(pairs)
    for k, _ in pairs[:5]:
        reps[1].delete_chunk(k)
    rep = scrub(rs)
    assert rep.problems == 5 and rep.remaining == 5
    rep = scrub(rs, repair=True)
    assert rep.repaired == 5 and rep.remaining == 0
    assert scrub(rs).problems == 0
    assert all(r.n_chunks() == 12 for r in reps)


# ---------------------------------------------------------------------------
# tiered store
# ---------------------------------------------------------------------------

def test_tiered_write_through_and_promotion():
    cold = MemoryStore()
    ts = TieredStore(cold, hot_bytes=1 << 20)
    pairs = _pairs(10)
    ts.put_chunks(pairs)
    assert cold.n_chunks() == 10                         # durable on cold
    # hot hit: serve without touching cold
    cold.chunks.clear()
    assert ts.get_chunk(pairs[0][0]) == pairs[0][1]
    assert ts.get_chunks([k for k, _ in pairs]) == dict(pairs)


def test_tiered_promotes_on_read_and_bounds_hot():
    cold = MemoryStore()
    pairs = _pairs(50)
    cold_bytes = sum(len(d) for _, d in pairs)
    hot_cap = cold_bytes // 4
    ts = TieredStore(cold, hot_bytes=hot_cap)
    for k, d in pairs:
        cold.put_chunk(k, d)
    for k, d in pairs:                                   # reads promote
        assert ts.get_chunk(k) == d
    assert 0 < ts.hot.bytes_used <= hot_cap              # bounded demotion
    assert cold.n_chunks() == 50                         # demotion = drop


def test_tiered_delete_clears_both_tiers():
    cold = MemoryStore()
    ts = TieredStore(cold, hot_bytes=1 << 20)
    pairs = _pairs(6)
    ts.put_chunks(pairs)
    assert ts.delete_chunks([k for k, _ in pairs[:4]]) == 4
    assert ts.n_chunks() == 2
    for k, _ in pairs[:4]:
        assert not ts.has_chunk(k)
        with pytest.raises(ChunkMissingError):
            ts.get_chunk(k)


def test_tiered_hot_serves_logical_bytes_under_codec():
    """Hot tier caches decoded bytes: a compressed put must read back
    logical content from the hot tier."""
    from repro_torch.core import CompressedStore
    cold = MemoryStore()
    ts = TieredStore(cold, hot_bytes=1 << 20)
    cs = CompressedStore(ts, "zlib")
    data = b"A" * 4096                                   # very compressible
    k = chunk_key(data)
    cs.put_chunk(k, data)
    assert cold.chunk_bytes_total() < len(data)          # stored compressed
    cold.chunks.clear()                                  # force hot path
    assert cs.get_chunk(k) == data


# ---------------------------------------------------------------------------
# topology specs
# ---------------------------------------------------------------------------

def test_parse_size():
    assert parse_size("4096") == 4096
    assert parse_size("64K") == 64 << 10
    assert parse_size("64M") == 64 << 20
    assert parse_size("1g") == 1 << 30
    with pytest.raises(ValueError):
        parse_size("lots")


def test_parse_topology_shapes(tmp_path):
    ss = parse_topology(f"shard(dir://{tmp_path}/a,dir://{tmp_path}/b)")
    assert isinstance(ss, ShardedStore) and len(ss.shards) == 2
    rs = parse_topology("rep(memory://,memory://,memory://)")
    assert isinstance(rs, ReplicatedStore) and len(rs.replicas) == 3
    ts = parse_topology(f"tier(64K,sqlite://{tmp_path}/c.db)")
    assert isinstance(ts, TieredStore) and ts.hot.max_bytes == 64 << 10
    nested = parse_topology("shard(rep(memory://,memory://),"
                            "rep(memory://,memory://))")
    assert isinstance(nested, ShardedStore)
    assert all(isinstance(c, ReplicatedStore) for c in nested.shards)


def test_parse_topology_errors():
    for bad in ("shard()", "rep()", "tier(64M)",
                "tier(64M,memory://,memory://)", "shard(memory://"):
        with pytest.raises(ValueError):
            parse_topology(bad)


def test_open_store_fabric_with_codec(tmp_path):
    from repro_torch.core import CompressedStore
    st = open_store(f"fabric://shard(dir://{tmp_path}/s0,"
                    f"dir://{tmp_path}/s1)?codec=zlib")
    assert isinstance(st, CompressedStore)
    assert isinstance(st.inner, ShardedStore)
    data = os.urandom(100) + b"\x00" * 4000
    k = chunk_key(data)
    st.put_chunk(k, data)
    assert st.get_chunk(k) == data
    # readable without the codec suffix (frames decode transparently)
    st2 = open_store(f"fabric://shard(dir://{tmp_path}/s0,"
                     f"dir://{tmp_path}/s1)")
    assert st2.get_chunk(k) == data


# ---------------------------------------------------------------------------
# rebalance
# ---------------------------------------------------------------------------

def test_rebalance_after_adding_a_shard(tmp_path):
    pairs = _pairs(120)
    old = ShardedStore([DirectoryStore(str(tmp_path / "s0")),
                        DirectoryStore(str(tmp_path / "s1"))])
    old.put_chunks(pairs)
    # ring change: same dirs plus a fresh shard
    new = ShardedStore([DirectoryStore(str(tmp_path / "s0")),
                        DirectoryStore(str(tmp_path / "s1")),
                        DirectoryStore(str(tmp_path / "s2"))])
    out = rebalance(new)
    assert 0 < out["chunks_moved"] < len(pairs) // 2     # ~1/3 of the keys
    assert scrub(new).misplaced == 0
    assert new.shards[2].n_chunks() == out["chunks_moved"]
    assert new.get_chunks([k for k, _ in pairs]) == dict(pairs)


# ---------------------------------------------------------------------------
# session + CLI end-to-end
# ---------------------------------------------------------------------------

def _x(val, n=1500):
    return torch.full((n,), float(val), dtype=torch.float32)


def _tbytes(t):
    return t.contiguous().view(torch.uint8).numpy().tobytes()


@pytest.fixture
def fabric_session(tmp_path):
    uri = (f"fabric://shard(rep(dir://{tmp_path}/a0,dir://{tmp_path}/a1),"
           f"rep(dir://{tmp_path}/b0,dir://{tmp_path}/b1))")
    s = KishuSession(open_store(uri), chunk_bytes=1 << 10, cache_bytes=0,
                     device="cpu")

    def set_val(ns, name, val):
        ns[name] = _x(val)
    s.register("set_val", set_val)
    s.init_state({})
    c1 = s.run("set_val", name="x", val=1)
    s.run("set_val", name="x", val=2)
    s.close()
    return uri, s, c1, tmp_path


def _wipe_chunks(root):
    shutil.rmtree(os.path.join(root, "chunks"))
    os.makedirs(os.path.join(root, "chunks"))


def test_session_restores_with_one_replica_of_each_pair_down(fabric_session):
    uri, s, c1, tmp_path = fabric_session
    want = _tbytes(_x(1))
    _wipe_chunks(str(tmp_path / "a0"))
    _wipe_chunks(str(tmp_path / "b1"))
    s2 = KishuSession(open_store(uri), chunk_bytes=1 << 10, cache_bytes=0,
                      device="cpu")
    st = s2.checkout(c1)
    assert isinstance(s2.ns["x"], torch.Tensor)
    assert _tbytes(s2.ns["x"]) == want                  # bit-identical
    assert st.covs_recomputed == 0                      # served, not replayed
    s2.close()
    store = open_store(uri)
    scrub(store, repair=True)
    assert scrub(store).problems == 0


def test_session_falls_back_to_recompute_when_lost_everywhere(tmp_path):
    """Chunk lost on ALL replicas -> DataRestorer recomputation still
    restores the state."""
    uri = f"fabric://rep(dir://{tmp_path}/r0,dir://{tmp_path}/r1)"
    s = KishuSession(open_store(uri), chunk_bytes=1 << 10, cache_bytes=0,
                     device="cpu")

    def fill(ns, seed):
        g = torch.Generator().manual_seed(seed)
        ns["x"] = torch.randn(1000, generator=g)
    s.register("fill", fill)
    s.init_state({})
    c1 = s.run("fill", seed=7)
    want = _tbytes(s.ns["x"])
    s.run("fill", seed=8)
    for root in ("r0", "r1"):
        _wipe_chunks(str(tmp_path / root))
    st = s.checkout(c1)
    assert st.covs_recomputed > 0
    assert _tbytes(s.ns["x"]) == want
    s.close()


@pytest.mark.parametrize("mode", ["off", "auto", "fetch", "replay"])
def test_planned_checkout_after_replica_wipe(tmp_path, mode):
    """A replica wiped under a planned checkout: every mode restores the
    same bytes, and the fabric heals what the fetch lane read."""
    uri = (f"fabric://rep(shard(dir://{tmp_path}/s0,dir://{tmp_path}/s1),"
           f"dir://{tmp_path}/r)")
    s = KishuSession(open_store(uri), chunk_bytes=1 << 10, cache_bytes=0,
                     device="cpu", plan_mode=mode)

    def fill(ns, seed):
        g = torch.Generator().manual_seed(seed)
        ns["x"] = torch.randn(4000, generator=g)
        ns["y"] = torch.randn(3000, generator=g)
    s.register("fill", fill)
    s.init_state({})
    c1 = s.run("fill", seed=1)
    want = {n: _tbytes(s.ns[n]) for n in ("x", "y")}
    s.run("fill", seed=2)
    _wipe_chunks(str(tmp_path / "r"))
    st = s.checkout(c1)
    assert {n: _tbytes(s.ns[n]) for n in ("x", "y")} == want
    if mode == "replay":
        assert st.covs_recomputed == st.covs_planned_replay == 2
    elif mode == "fetch":
        assert st.covs_recomputed == 0 and st.bytes_loaded > 0
    s.close()
    store = open_store(uri)
    scrub(store, repair=True)
    assert scrub(store).problems == 0


def test_session_gc_sweeps_all_shards_and_replicas(fabric_session):
    uri, s, c1, tmp_path = fabric_session
    store = open_store(uri)
    junk = _pairs(5, "junk")
    store.put_chunks(junk)                               # orphans
    s3 = KishuSession(open_store(uri), chunk_bytes=1 << 10, device="cpu")
    s3.register("set_val", lambda ns, name, val: None)
    out = s3.gc()
    assert out["chunks_dropped"] == 5
    for k, _ in junk:
        assert not store.has_chunk(k)
    s3.close()


def test_cli_fleet_verbs(fabric_session, capsys):
    uri, s, c1, tmp_path = fabric_session
    assert cli(["--store", uri, "topology"]) == 0
    out = capsys.readouterr().out
    assert "shard(n=2" in out and "rep(k=2)" in out
    assert cli(["--store", uri, "scrub", "--deep"]) == 0
    assert "0 problems" in capsys.readouterr().out
    assert cli(["--store", uri, "rebalance"]) == 0
    assert "moved 0" in capsys.readouterr().out
    _wipe_chunks(str(tmp_path / "a1"))
    assert cli(["--store", uri, "scrub"]) == 2
    assert "replica-missing" in capsys.readouterr().out
    assert cli(["--store", uri, "scrub", "--repair"]) == 0
    assert cli(["--store", uri, "scrub"]) == 0
    assert "0 problems" in capsys.readouterr().out


def test_cli_verify_and_log_on_fabric(fabric_session, capsys):
    uri, s, c1, _ = fabric_session
    assert cli(["--store", uri, "log"]) == 0
    assert "set_val" in capsys.readouterr().out
    assert cli(["--store", uri, "verify", "--deep"]) == 0
    assert "OK" in capsys.readouterr().out


def test_instrument_tree_labels_each_child():
    from repro_torch.obs import MetricsRegistry
    from repro_torch.obs.instrument import InstrumentedStore, instrument_tree
    reg = MetricsRegistry()
    for store, labels in (
            (ShardedStore([MemoryStore(), MemoryStore()]),
             {"shard0:memory", "shard1:memory"}),
            (ReplicatedStore([MemoryStore(), MemoryStore()]),
             {"rep0:memory", "rep1:memory"}),
            (TieredStore(MemoryStore(), hot_bytes=1 << 10),
             {"cold:memory"})):
        top = instrument_tree(store, reg)
        assert isinstance(top, InstrumentedStore) and top.inner is store
        top.put_chunks(_pairs(4, type(store).__name__))
        top.get_chunks([k for k, _ in _pairs(4, type(store).__name__)])
    seen = {h.labels.get("backend")
            for h in reg._histograms.values()}
    assert {"shard0:memory", "shard1:memory", "rep0:memory", "rep1:memory",
            "cold:memory"} <= seen


# ---------------------------------------------------------------------------
# cross-package: the port's fabric against the JAX package's
# ---------------------------------------------------------------------------

def _jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import repro.core as jcore
    return jnp, jcore


@pytest.mark.parametrize("n_shards", [2, 3, 5])
def test_ring_places_every_key_as_the_jax_ring(n_shards):
    _, jcore = _jax()
    from repro.core.fabric import HashRing as JRing
    keys = [chunk_key(bytes([i & 255, i >> 8, 7])) for i in range(3000)]
    t, j = HashRing(n_shards), JRing(n_shards)
    assert [t.shard_for(k) for k in keys] == [j.shard_for(k) for k in keys]


DEVICE_ENV = ("KISHU_DEVICE_DELTA", "KISHU_DEVICE_HASH", "KISHU_DEVICE_CODEC",
              "KISHU_DEVICE_SCATTER")


@pytest.fixture
def device_path(monkeypatch):
    """The JAX package's device path (its kernels' references on the CPU),
    which the port's tensors always take: both then store the same bytes."""
    for k in DEVICE_ENV:
        monkeypatch.setenv(k, "1")


def _files(root):
    """Chunk files under a dir store: relative path -> bytes."""
    out = {}
    base = os.path.join(root, "chunks")
    for dirpath, _, names in os.walk(base):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, base)] = f.read()
    return out


def _cells_state(seed=0):
    rng = np.random.default_rng(seed)
    return {"emb": rng.standard_normal((700, 64)).astype(np.float32),
            "w": rng.standard_normal(3000).astype(np.float32),
            "ids": rng.integers(0, 1000, 5001).astype(np.int32)}


def _drive_jax(jnp, jcore, uri):
    s = jcore.KishuSession(jcore.open_store(uri), chunk_bytes=1 << 12,
                           cache_bytes=0)

    def attach(ns):
        for k, v in _cells_state().items():
            ns[k] = jnp.asarray(v)

    def sparse(ns, v):
        ns["emb"] = ns["emb"].at[jnp.array([3, 300, 650])].set(float(v))
        ns["ids"] = ns["ids"].at[::2500].set(v)
    s.register("attach", attach)
    s.register("sparse", sparse)
    s.init_state({})
    cids = [s.run("attach"), s.run("sparse", v=5), s.run("sparse", v=6)]
    snaps = {}
    for c in cids:
        s.checkout(c)
        snaps[c] = {n: np.asarray(s.ns[n]).tobytes() for n in s.ns.names()}
    s.close()
    return cids, snaps


def _drive_torch(uri):
    s = KishuSession(open_store(uri), chunk_bytes=1 << 12, cache_bytes=0,
                     device="cpu")

    def attach(ns):
        for k, v in _cells_state().items():
            ns[k] = torch.from_numpy(v.copy())

    def sparse(ns, v):
        ns["emb"][[3, 300, 650]] = float(v)
        ns["ids"][::2500] = v
    s.register("attach", attach)
    s.register("sparse", sparse)
    s.init_state({})
    cids = [s.run("attach"), s.run("sparse", v=5), s.run("sparse", v=6)]
    snaps = {}
    for c in cids:
        s.checkout(c)
        snaps[c] = {n: _tbytes(s.ns[n]) for n in s.ns.names()}
    s.close()
    return cids, snaps


def test_same_chunk_files_on_each_shard_as_jax(tmp_path, device_path):
    jnp, jcore = _jax()
    roots = {}
    for pkg in ("jax", "torch"):
        roots[pkg] = [str(tmp_path / pkg / f"s{i}") for i in range(3)]
        uri = "fabric://shard(" + ",".join(f"dir://{r}"
                                           for r in roots[pkg]) + ")"
        if pkg == "jax":
            jc, jsnaps = _drive_jax(jnp, jcore, uri)
        else:
            tc, tsnaps = _drive_torch(uri)
    assert jc == tc and jsnaps == tsnaps
    for rj, rt in zip(roots["jax"], roots["torch"]):
        fj, ft = _files(rj), _files(rt)
        assert fj and sorted(fj) == sorted(ft)
        assert fj == ft                          # and byte for byte


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cross_package_fabric_checkout_scrub_verify(writer, tmp_path,
                                                    capsys, device_path):
    """One package writes a replicated shard ring, a replica is wiped, and
    the other package checks it out exactly, heals it and verifies it."""
    jnp, jcore = _jax()
    from repro.core.fabric import scrub as jscrub
    from repro.launch.kishu_cli import main as jcli
    uri = (f"fabric://rep(shard(dir://{tmp_path}/s0,dir://{tmp_path}/s1),"
           f"dir://{tmp_path}/r)")
    if writer == "jax":
        cids, snaps = _drive_jax(jnp, jcore, uri)
    else:
        cids, snaps = _drive_torch(uri)
    _wipe_chunks(str(tmp_path / "r"))
    if writer == "jax":
        s = KishuSession(open_store(uri), chunk_bytes=1 << 12, cache_bytes=0,
                         device="cpu")
        s.loader.materialize_state(s.tracked, cids[0])
        for c in (cids[2], cids[1]):
            s.checkout(c)
            assert {n: _tbytes(s.ns[n]) for n in s.ns.names()} == snaps[c]
        s.close()
        rep = scrub(open_store(uri), repair=True)
        assert rep.remaining == 0
        assert jscrub(jcore.open_store(uri)).problems == 0
        reader_cli = cli
    else:
        s = jcore.KishuSession(jcore.open_store(uri), chunk_bytes=1 << 12,
                               cache_bytes=0)
        s.loader.materialize_state(s.tracked, cids[0])
        for c in (cids[2], cids[1]):
            s.checkout(c)
            assert {n: np.asarray(s.ns[n]).tobytes()
                    for n in s.ns.names()} == snaps[c]
        s.close()
        rep = jscrub(jcore.open_store(uri), repair=True)
        assert rep.remaining == 0
        assert scrub(open_store(uri)).problems == 0
        reader_cli = jcli
    capsys.readouterr()
    for verb in (["verify", "--deep"], ["topology"], ["scrub", "--deep"]):
        assert reader_cli(["--store", uri] + verb) == 0
        rout = capsys.readouterr().out
        other = jcli if reader_cli is cli else cli
        assert other(["--store", uri] + verb) == 0
        assert capsys.readouterr().out == rout
