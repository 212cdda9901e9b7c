"""DTensor co-variables in the port's session, on 2 and 4 gloo ranks.

Every rank runs the same ``KishuSession`` over one ``dir://`` store
(``group=WORLD``): rank 0 writes and publishes, the others follow.  A
DTensor leaf commits its global bytes, so its chunk keys, detection
hashes, manifest and stored bytes must equal a single-device commit of
the same values; a sparse delta commit and patch checkouts back and forth
restore exactly; and each rank's chunk reads during a checkout stay
inside its own ``host_shard_ranges``.
"""
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.core import KishuSession, MemoryStore, open_store
from repro_torch.core.graph import key_str
from repro_torch.launch.mesh import run_local_ranks
from repro_torch.sharding.resharding import chunks_for_range, \
    host_shard_ranges

CB = 1 << 10
RANK_TIMEOUT = 120.0
ROWS = (40, 47)                  # the sparse cell's rows of "w"


def _values():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((600, 24)).astype(np.float32),
            "emb": rng.standard_normal((256, 40)).astype(np.float32),
            "b": rng.standard_normal(100).astype(np.float32)}


def _layouts(world):
    """(mesh shape, placements of w, placements of emb)."""
    if world == 2:
        return (2, 1), [Shard(0), Replicate()], [Shard(0), Replicate()]
    return (2, 2), [Shard(0), Shard(0)], [Replicate(), Shard(0)]


def _bump_delta(shape):
    d = torch.zeros(shape)
    d[ROWS[0]:ROWS[1]] = 1.0
    return d


def _record(s, cid):
    """Chunk keys, detection hashes, meta, members and stored bytes of
    each co-variable at ``cid``."""
    out = {}
    for n in ("w", "emb", "b"):
        ver = s.graph.nodes[cid].state_index[key_str((n,))]
        man = s.graph.manifest_of((n,), ver)
        keys = [c["key"] for c in man["base"]["chunks"]]
        out[n] = {"keys": keys, "det": man["base"]["det_hashes"],
                  "meta": man["base"]["meta"],
                  "members": man["members"],
                  "bytes": [s.store.get_chunk(k) for k in keys]}
    return out


def _rank(rank, world, uri):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    mshape, pw, pe = _layouts(world)
    mesh = init_device_mesh("cpu", mshape, mesh_dim_names=("data", "model"))
    vals = _values()
    store = open_store(uri)
    s = KishuSession(store, chunk_bytes=CB, device="cpu",
                     group=dist.group.WORLD, cache_bytes=0)

    def bump(ns):
        x = ns["w"]
        x.add_(distribute_tensor(_bump_delta(x.shape), x.device_mesh,
                                 x.placements))
    s.register("bump", bump)
    c0 = s.init_state({
        "w": distribute_tensor(torch.from_numpy(vals["w"]), mesh, pw),
        "emb": distribute_tensor(torch.from_numpy(vals["emb"]), mesh, pe),
        "b": torch.from_numpy(vals["b"].copy())})
    c1 = s.run("bump")
    rec = {"c0": _record(s, c0), "c1": _record(s, c1)}

    read = []
    get = s.store.get_chunks

    def counting(keys, **kw):
        read.extend(keys)
        return get(keys, **kw)
    s.store.get_chunks = counting
    outs = []
    for cid in (c0, c1, c0):
        read.clear()
        st = s.checkout(cid)
        w = s.ns["w"]
        outs.append({"w": w.full_tensor().numpy().tobytes(),
                     "emb": s.ns["emb"].full_tensor().numpy().tobytes(),
                     "dtensor": type(w).__name__,
                     "placements": tuple(map(str, w.placements)),
                     "patched": st.covs_patched, "read": list(read)})
    # a full load of the DTensor co-variable: rebind, then check out
    s.tracked["w"] = distribute_tensor(torch.zeros(600, 24), mesh, pw)
    s.run("bump")
    read.clear()
    st = s.checkout(c1)
    outs.append({"w": s.ns["w"].full_tensor().numpy().tobytes(),
                 "placements": tuple(map(str, s.ns["w"].placements)),
                 "patched": st.covs_patched, "read": list(read)})
    s.close()
    return rec, outs


def _single_device():
    vals = _values()
    s = KishuSession(MemoryStore(), chunk_bytes=CB, device="cpu")

    def bump(ns):
        ns["w"].add_(_bump_delta(ns["w"].shape))
    s.register("bump", bump)
    c0 = s.init_state({n: torch.from_numpy(v.copy())
                       for n, v in vals.items()})
    c1 = s.run("bump")
    return {"c0": _record(s, c0), "c1": _record(s, c1)}


@pytest.mark.parametrize("world", [2, 4])
def test_dtensor_commit_equals_single_device(tmp_path, world):
    uri = f"dir://{tmp_path}/cas"
    out = run_local_ranks(_rank, world, uri, timeout=RANK_TIMEOUT)
    want = _single_device()
    vals = _values()
    w1 = vals["w"].copy()
    w1[ROWS[0]:ROWS[1]] += 1.0
    for rank, (rec, outs) in enumerate(out):
        assert rec == want, rank      # keys, hashes, metas, stored bytes
        c0, c1, back, full = outs
        for o, w in ((c0, vals["w"]), (c1, w1), (back, vals["w"]),
                     (full, w1)):
            assert o["w"] == w.tobytes(), rank
        assert c0["emb"] == vals["emb"].tobytes()
        assert c0["dtensor"] == "DTensor"
        # the delta was one chunk range: patched in place, every rank
        assert c0["patched"] >= 1 and c1["patched"] >= 1, rank
        # each rank read only chunks of its own range of "w"
        mshape, pw, _ = _layouts(world)
        (lo, hi), = host_shard_ranges((600, 24), "float32", mshape,
                                      pw)[rank]
        sizes = {"base": {"chunks": [{"n": len(b)} for b in
                                     want["c0"]["w"]["bytes"]]}}
        k0, k1 = want["c0"]["w"]["keys"], want["c1"]["w"]["keys"]
        mine = {k for i in chunks_for_range(sizes, lo, hi)
                for k in (k0[i], k1[i])}
        for o in (c0, c1, back, full):
            w_reads = {k for k in o["read"] if k in set(k0) | set(k1)}
            assert w_reads <= mine, rank
        assert full["read"] and set(full["read"]) <= mine
        assert full["placements"] == tuple(map(str, pw))
