"""Elastic restore in the port: byte-range chunk selection, shard-local
loads, mesh-independent manifests (the four cases of
``tests/test_resharding.py``), ``host_shard_ranges`` on DTensor
placements, and restores across packages: a global array committed by the
JAX package lands on the port's 2-rank ``Shard(0)`` placements byte for
byte, and a DTensor the port committed on 2 ranks reads back whole in the
JAX package.

Multi-rank cases run as gloo processes (``launch.mesh.run_local_ranks``),
each call with its own timeout.
"""
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.core import KishuSession, MemoryStore, open_store
from repro_torch.launch.mesh import run_local_ranks
from repro_torch.sharding.resharding import (chunks_for_range,
                                             elastic_restore_leaf,
                                             host_shard_ranges,
                                             load_byte_range)

RANK_TIMEOUT = 90.0


@pytest.fixture
def committed():
    s = KishuSession(MemoryStore(), chunk_bytes=1 << 10, device="cpu")

    def put(ns):
        ns["w"] = torch.arange(2000, dtype=torch.float32)  # 8000 B, 8 chunks
    s.register("put", put)
    s.init_state({})
    cid = s.run("put")
    man = s.graph.manifest_of(("w",), cid)
    return s, man


def test_chunks_for_range(committed):
    _, man = committed
    assert chunks_for_range(man, 0, 1024) == [0]
    assert chunks_for_range(man, 1023, 1025) == [0, 1]
    assert chunks_for_range(man, 4096, 8000) == [4, 5, 6, 7]


def test_load_byte_range_matches_full(committed):
    s, man = committed
    full = np.arange(2000, dtype=np.float32).tobytes()
    for lo, hi in [(0, 8000), (0, 1024), (512, 2048), (7000, 8000),
                   (1, 2), (4095, 4097)]:
        got = load_byte_range(s.store, man, lo, hi)
        assert got == full[lo:hi], (lo, hi)


def test_shard_local_reads_touch_only_needed_chunks(committed):
    s, man = committed
    keep = set(c["key"] for i, c in enumerate(man["base"]["chunks"])
               if i in (2, 3))
    for c in man["base"]["chunks"]:
        if c["key"] not in keep:
            s.store.delete_chunk(c["key"])
    got = load_byte_range(s.store, man, 2048, 4096)
    want = np.arange(2000, dtype=np.float32).tobytes()[2048:4096]
    assert got == want


def test_elastic_restore_leaf(committed):
    s, man = committed
    leaf = elastic_restore_leaf(s.store, man, device="cpu")
    assert torch.equal(leaf, torch.arange(2000, dtype=torch.float32))


@pytest.mark.parametrize("mesh_shape,placements,want", [
    ((4,), [Shard(0)], [(0, 2000), (2000, 4000), (4000, 6000),
                        (6000, 8000)]),
    ((2, 2), [Shard(0), Replicate()], [(0, 4000), (0, 4000),
                                       (4000, 8000), (4000, 8000)]),
    ((2, 2), [Shard(0), Shard(0)], [(0, 2000), (2000, 4000),
                                    (4000, 6000), (6000, 8000)]),
    ((3,), [Shard(0)], [(0, 2720), (2720, 5440), (5440, 8000)]),
    ((2,), [Shard(1)], [(0, 8000), (0, 8000)]),
])
def test_host_shard_ranges(mesh_shape, placements, want):
    """Ranges of a [100, 20] float32 tensor (row 80 B): DTensor's own
    local-shape rule, uneven last shard included; other placements fall
    back to the full range."""
    got = host_shard_ranges((100, 20), "float32", mesh_shape, placements)
    assert [got[r] for r in range(len(want))] == [[w] for w in want]


# ---------------------------------------------------------------------------
# across packages, on 2 gloo ranks
# ---------------------------------------------------------------------------

def _restore_rank(rank, world, uri, manifest):
    """This rank's shard of ``manifest`` on a 2-rank Shard(0) layout, and
    the chunk keys it read."""
    from repro_torch.launch.mesh import make_local_mesh
    store = open_store(uri)
    read = []
    get = store.get_chunks

    def counting(keys, **kw):
        read.extend(keys)
        return get(keys, **kw)
    store.get_chunks = counting
    mesh = make_local_mesh(model=1)
    x = elastic_restore_leaf(store, manifest, mesh, [Shard(0), Replicate()],
                             device="cpu")
    local = x.to_local()
    return (local.reshape(-1).view(torch.uint8).numpy().tobytes(),
            tuple(x.shape), read)


def _commit_rank(rank, world, uri, values):
    """Commit ``values`` as a 2-rank Shard(0) DTensor co-variable; rank 0
    returns the manifest."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(model=1)
    s = KishuSession(open_store(uri), chunk_bytes=1 << 10, device="cpu",
                     group=dist.group.WORLD)
    w = distribute_tensor(torch.from_numpy(values), mesh,
                          [Shard(0), Replicate()])
    cid = s.init_state({"w": w})
    man = s.graph.manifest_of(("w",), cid)
    s.close()
    return man


def test_jax_commit_restores_onto_port_shards(tmp_path):
    import jax.numpy as jnp
    import repro.core as jcore
    uri = f"dir://{tmp_path}/cas"
    vals = np.random.default_rng(0).standard_normal((250, 7)) \
        .astype(np.float32)
    js = jcore.KishuSession(jcore.open_store(uri), chunk_bytes=1 << 10)
    cid = js.init_state({"w": jnp.asarray(vals)})
    man = js.graph.manifest_of(("w",), cid)
    js.close()
    out = run_local_ranks(_restore_rank, 2, uri, man,
                          timeout=RANK_TIMEOUT)
    raw = vals.tobytes()
    ranges = host_shard_ranges(vals.shape, "float32", (2,), [Shard(0)])
    for rank, (local, shape, read) in enumerate(out):
        (lo, hi), = ranges[rank]
        assert shape == vals.shape
        assert local == raw[lo:hi]
        want = [man["base"]["chunks"][i]["key"]
                for i in chunks_for_range(man, lo, hi)]
        assert read == want, rank             # its chunks and no other


def test_port_dtensor_commit_restores_in_jax(tmp_path):
    from repro.sharding.resharding import \
        elastic_restore_leaf as jax_restore
    import repro.core as jcore
    uri = f"dir://{tmp_path}/cas"
    vals = np.random.default_rng(1).standard_normal((301, 5)) \
        .astype(np.float32)
    man = run_local_ranks(_commit_rank, 2, uri, vals,
                          timeout=RANK_TIMEOUT)[0]
    got = jax_restore(jcore.open_store(uri), man)
    assert np.asarray(got).tobytes() == vals.tobytes()
    # the manifest is the one a plain single-device commit writes
    s = KishuSession(MemoryStore(), chunk_bytes=1 << 10, device="cpu")
    plain = s.graph.manifest_of(
        ("w",), s.init_state({"w": torch.from_numpy(vals.copy())}))
    assert [c["key"] for c in man["base"]["chunks"]] == \
        [c["key"] for c in plain["base"]["chunks"]]
    assert man["base"]["det_hashes"] == plain["base"]["det_hashes"]
    assert man["base"]["meta"] == plain["base"]["meta"]
