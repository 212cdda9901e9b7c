"""The port's cost-based checkout planner, held against the JAX package.

The reference suite (``test_planner.py``) runs here on the port, on
``device="cpu"`` sessions whose cells hold torch tensors: mode resolution,
the store cost model, pricing, planner-on parity with the fixed ladder on
memory / dir / sqlite / fabric stores in every mode, the single count of
``covs_recomputed`` and the bounded replay memo.  The port's own additions
are checked too: a mixed plan runs both lanes, a replay that fails is
demoted to the fetch lane and counted, and the replay memo lets its
tensors go after the checkout.  Cross-package checks (with jax present):
the same cells through both packages in each mode write the same chunks
and restore the same bytes, and ``kishu plan`` prints the same lines from
both CLIs on one store.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (DetReplaySession, KishuSession, MemoryStore,
                              PricedPlan, StoreCostModel, format_plan,
                              open_store, resolve_plan_mode)
from repro_torch.core.chunkstore import ChunkCache
from repro_torch.core.planner import INF
from repro_torch.core.restore import resolve_memo_bytes
from repro_torch.launch.kishu_cli import main as cli
from repro_torch.obs.metrics import MetricsRegistry

KINDS = ["memory", "dir", "sqlite", "fabric"]
MODES = ["auto", "fetch", "replay"]


def make_store(kind, tmp_path, pkg=None):
    open_ = pkg.open_store if pkg is not None else open_store
    if kind == "memory":
        return open_("memory://")
    tmp_path.mkdir(parents=True, exist_ok=True)
    if kind == "dir":
        return open_(f"dir://{tmp_path}/cas")
    if kind == "sqlite":
        return open_(f"sqlite://{tmp_path}/cas.db")
    return open_(f"fabric://shard(dir://{tmp_path}/s0,dir://{tmp_path}/s1)")


def _step(ns, k=1.0):
    ns["w"] = ns["w"] + k


def _derive(ns, scale=1.0):
    ns["big"] = (torch.arange(512, dtype=torch.float32)
                 * ns["seed"].sum() * scale)


def build_session(store, **kw):
    kw.setdefault("chunk_bytes", 256)
    kw.setdefault("device", "cpu")
    s = KishuSession(store, **kw)
    s.register("step", _step)
    s.register("derive", _derive)
    return s


def run_workload(s):
    cids = [s.init_state({"w": torch.zeros(256),
                          "seed": torch.arange(4, dtype=torch.float32)})]
    for k in range(1, 4):
        cids.append(s.run("step", k=float(k)))
        cids.append(s.run("derive", scale=float(k)))
    return cids


def _bytes(v):
    if isinstance(v, torch.Tensor):
        return v.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(v)).tobytes()


def _snapshot(ns):
    return {n: _bytes(ns[n]) for n in ns.names()}


def _manifest_keys(graph, commit):
    node = graph.nodes[commit]
    out = set()
    for ks, ver in node.state_index.items():
        man = graph.nodes[ver].manifests.get(ks) or {}
        if not man.get("unserializable"):
            out |= {c["key"] for c in man["base"]["chunks"]}
    return out


# ---------------------------------------------------------------------------
# mode resolution
# ---------------------------------------------------------------------------

def test_resolve_plan_mode_arg_env_default(monkeypatch):
    monkeypatch.delenv("KISHU_PLANNER", raising=False)
    assert resolve_plan_mode(None) == "off"
    monkeypatch.setenv("KISHU_PLANNER", "auto")
    assert resolve_plan_mode(None) == "auto"
    assert resolve_plan_mode("off") == "off"       # arg wins over env
    monkeypatch.setenv("KISHU_PLANNER", "1")
    assert resolve_plan_mode(None) == "auto"
    assert resolve_plan_mode("forced-replay") == "replay"
    assert resolve_plan_mode("forced-fetch") == "fetch"
    with pytest.raises(ValueError):
        resolve_plan_mode("bogus")


def test_session_reads_planner_env(monkeypatch):
    monkeypatch.setenv("KISHU_PLANNER", "replay")
    s = build_session(MemoryStore())
    assert s.plan_mode == "replay" and s.loader.planner is s.planner
    s.close()
    monkeypatch.setenv("KISHU_PLANNER", "off")
    s = build_session(MemoryStore())
    assert s.plan_mode == "off" and s.loader.planner is None
    s.close()


# ---------------------------------------------------------------------------
# store cost model
# ---------------------------------------------------------------------------

def test_cost_model_cold_defaults():
    m = StoreCostModel(None)
    lat, bw, n = m.snapshot()
    assert n == 0 and lat > 0 and bw > 0
    assert m.fetch_seconds(0, 0) == 0.0
    assert m.fetch_seconds(1 << 20, 4) > 0


def test_cost_model_reads_store_metrics():
    reg = MetricsRegistry()
    h = reg.histogram("kishu_store_op_seconds", op="get_chunks",
                      backend="memory")
    for _ in range(10):
        h.observe(0.01)                  # 10 ops x 10ms
    reg.counter("kishu_store_bytes_total", dir="get",
                backend="memory").inc(1_000_000)
    m = StoreCostModel(reg)
    lat, bw, n = m.snapshot()
    assert n == 10
    assert lat == pytest.approx(0.01)
    assert bw == pytest.approx(1_000_000 / 0.1)
    assert m.fetch_seconds(1_000_000, 3) == pytest.approx(0.11, rel=0.05)


# ---------------------------------------------------------------------------
# pricing
# ---------------------------------------------------------------------------

def test_plan_prices_and_formats():
    s = build_session(MemoryStore(), plan_mode="auto", cache_bytes=0)
    cids = run_workload(s)
    p = s.plan(cids[2])
    assert isinstance(p, PricedPlan)
    assert p.target == cids[2] and p.mode == "auto"
    assert p.covs, "diverged covs must be priced"
    for c in p.covs:
        assert c.path in ("fetch", "replay", "patch")
        assert c.fetch_s < INF           # everything serializable here
    text = "\n".join(format_plan(p))
    assert cids[2] in text and "store model" in text
    s.close()


def test_cache_resident_bytes_price_zero():
    s = build_session(MemoryStore(), plan_mode="auto")   # default cache on
    cids = run_workload(s)
    p = s.plan(cids[-2])
    fetchable = [c for c in p.covs if c.path != "replay"]
    assert fetchable and all(c.est_bytes == 0 for c in fetchable)
    s.close()


def test_replay_shared_ancestor_priced_once():
    """Two co-variables produced by the same commit charge its exec once."""
    s = KishuSession(MemoryStore(), plan_mode="auto", cache_bytes=0,
                     chunk_bytes=256, device="cpu")

    def pair(ns, k=1.0):
        ns["a"] = torch.full((64,), k)
        ns["b"] = torch.full((64,), -k)
    s.register("pair", pair)
    s.init_state({"seed": torch.arange(4, dtype=torch.float32)})
    c1 = s.run("pair", k=1.0)
    s.run("pair", k=2.0)
    charged = set()
    cost_a, closure_a, _ = s.planner._replay_price(c1, charged)
    assert cost_a < INF and closure_a
    charged |= closure_a
    cost_b, closure_b, _ = s.planner._replay_price(c1, charged)
    assert cost_b == 0.0 and not closure_b
    s.close()


def test_unregistered_and_unsafe_commands_never_replay():
    s = build_session(MemoryStore(), plan_mode="replay", cache_bytes=0)
    s.register("sideeffect", lambda ns, v=1.0: ns.__setitem__(
        "x", torch.full((8,), v)), replay_safe=False)
    run_workload(s)
    cx = s.run("sideeffect", v=1.0)
    s.run("sideeffect", v=2.0)
    p = s.plan(cx)
    x_plan = [c for c in p.covs if "x" in c.key]
    assert x_plan and x_plan[0].path != "replay"
    assert x_plan[0].replay_s == INF
    assert s.graph.nodes[cx].stats["replay_safe"] is False
    s.close()


def test_forced_replay_routes_replayable_covs():
    s = build_session(MemoryStore(), plan_mode="replay", cache_bytes=0)
    cids = run_workload(s)
    st = s.checkout(cids[-3])
    assert st.covs_planned_replay > 0
    assert st.covs_recomputed == st.covs_planned_replay
    s.close()


# ---------------------------------------------------------------------------
# parity: planner on == planner off, bit for bit, on every backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", MODES)
def test_planner_parity(kind, mode, tmp_path):
    base = build_session(make_store(kind, tmp_path / "off"), plan_mode="off",
                         cache_bytes=0)
    plnd = build_session(make_store(kind, tmp_path / mode), plan_mode=mode,
                         cache_bytes=0)
    cids_a = run_workload(base)
    cids_b = run_workload(plnd)
    assert cids_a == cids_b
    for target in (cids_a[2], cids_a[-1], cids_a[1]):
        base.checkout(target)
        plnd.checkout(target)
        assert _snapshot(base.ns) == _snapshot(plnd.ns)
        for name in base.ns.names():
            a, b = base.ns[name], plnd.ns[name]
            assert a.dtype == b.dtype and a.shape == b.shape
        na, nb = base.graph.nodes[target], plnd.graph.nodes[target]
        assert na.state_index == nb.state_index
        assert _manifest_keys(base.graph, target) \
            == _manifest_keys(plnd.graph, target)
        # each plan equals its execution
        st = plnd.last_checkout
        if mode == "fetch":
            assert st.covs_planned_replay == 0 and st.covs_recomputed == 0
        elif mode == "replay":
            assert st.covs_recomputed == st.covs_planned_replay
    assert set(base.store.list_chunk_keys()) \
        == set(plnd.store.list_chunk_keys())
    base.close()
    plnd.close()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", MODES)
def test_planner_parity_matches_jax(kind, mode, tmp_path):
    """The same cells in the same planner mode through both packages: the
    same commits, chunk keys, manifests and restored bytes; in the forced
    modes also the same lanes."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import repro.core as jcore

    def jstep(ns, k=1.0):
        ns["w"] = ns["w"] + jnp.float32(k)

    def jderive(ns, scale=1.0):
        ns["big"] = (jnp.arange(512, dtype=jnp.float32)
                     * ns["seed"].sum() * jnp.float32(scale))

    js = jcore.KishuSession(make_store(kind, tmp_path / "jax", jcore),
                            plan_mode=mode, cache_bytes=0, chunk_bytes=256)
    js.register("step", jstep)
    js.register("derive", jderive)
    jc = [js.init_state({"w": jnp.zeros(256, jnp.float32),
                         "seed": jnp.arange(4, dtype=jnp.float32)})]
    for k in range(1, 4):
        jc.append(js.run("step", k=float(k)))
        jc.append(js.run("derive", scale=float(k)))
    ts = build_session(make_store(kind, tmp_path / "torch"), plan_mode=mode,
                       cache_bytes=0)
    tc = run_workload(ts)
    assert jc == tc
    for target in (tc[2], tc[-1], tc[1]):
        jst, tst = js.checkout(target), ts.checkout(target)
        assert _snapshot(js.ns) == _snapshot(ts.ns)
        assert js.graph.nodes[target].manifests \
            == ts.graph.nodes[target].manifests
        if mode != "auto":
            assert (jst.covs_planned_fetch, jst.covs_planned_patch,
                    jst.covs_planned_replay, jst.covs_recomputed) \
                == (tst.covs_planned_fetch, tst.covs_planned_patch,
                    tst.covs_planned_replay, tst.covs_recomputed)
    assert set(js.store.list_chunk_keys()) == set(ts.store.list_chunk_keys())
    js.close()
    ts.close()


def test_plan_matches_executed_paths():
    s = build_session(MemoryStore(), plan_mode="auto", cache_bytes=0)
    cids = run_workload(s)
    target = cids[-3]
    p = s.plan(target)
    st = s.checkout(target)
    n = p.counts()
    assert st.covs_planned_fetch == n["fetch"]
    assert st.covs_planned_patch == n["patch"]
    assert st.covs_planned_replay == n["replay"]
    assert st.plan_est_s == pytest.approx(p.est_total_s, rel=0.5, abs=1.0)
    s.close()


def test_mixed_plan_runs_both_lanes():
    """Forced replay with one unsafe command: its co-variable takes the
    fetch lane (on the helper thread) while the other replays here."""
    s = build_session(MemoryStore(), plan_mode="replay", cache_bytes=0)
    s.register("fill", lambda ns, v=1.0: ns.__setitem__(
        "x", torch.full((300,), v)), replay_safe=False)
    s.init_state({"w": torch.zeros(256)})
    s.run("fill", v=1.0)
    c1 = s.run("step", k=2.0)
    want = _snapshot(s.ns)
    s.run("fill", v=5.0)
    s.run("step", k=1.0)
    st = s.checkout(c1)
    assert st.covs_planned_fetch == 1 and st.covs_planned_replay == 1
    assert st.covs_recomputed == 1 and st.covs_loaded == 2
    assert st.bytes_loaded > 0           # the fetch lane's bytes merged back
    assert _snapshot(s.ns) == want
    s.close()


def test_failed_replay_demotes_to_fetch_and_is_counted():
    s = build_session(MemoryStore(), plan_mode="replay", cache_bytes=0)
    cids = run_workload(s)
    s.checkout(cids[3])
    want = _snapshot(s.ns)
    s.checkout(cids[-1])

    def broken(ns, k=1.0):
        raise RuntimeError("replay went wrong")
    s.register("step", broken)
    st = s.checkout(cids[3])
    assert st.covs_planned_replay > 0
    assert st.kernel_fallbacks >= 1      # note_kernel_fallback("plan_replay")
    assert _snapshot(s.ns) == want
    s.close()


@pytest.mark.parametrize("mode", ["auto", "replay"])
def test_attach_is_never_planned_for_replay(mode):
    """An attach re-inserts the caller's tensors, which a later cell here
    changes in place: a planned replay of the attach would restore today's
    values.  The planner prices it at infinity, so the checkout fetches."""
    s = KishuSession(MemoryStore(), chunk_bytes=256, cache_bytes=0,
                     device="cpu", plan_mode=mode)
    s.register("bump", lambda ns: ns["w"].add_(1.0))
    c0 = s.init_state({"w": torch.arange(1024, dtype=torch.float32)})
    s.run("bump")
    s.run("bump")
    p = s.plan(c0)
    assert p.covs and all(c.replay_s == INF and c.path != "replay"
                          for c in p.covs)
    st = s.checkout(c0)
    assert st.covs_recomputed == 0 and st.covs_planned_replay == 0
    assert torch.equal(s.ns["w"], torch.arange(1024, dtype=torch.float32))
    s.close()


def test_det_replay_prices_fetch_at_infinity():
    s = DetReplaySession(MemoryStore(), plan_mode="auto", cache_bytes=0,
                         chunk_bytes=256, device="cpu")
    s.register("det", lambda ns, k=1.0: ns.__setitem__(
        "w", ns["w"] * k), deterministic=True)
    s.init_state({"w": torch.arange(128, dtype=torch.float32)})
    c1 = s.run("det", k=2.0)
    s.run("det", k=3.0)
    p = s.plan(c1)
    w_plan = [c for c in p.covs if "w" in c.key]
    assert w_plan and w_plan[0].fetch_s == INF
    assert w_plan[0].path == "replay"
    st = s.checkout(c1)
    assert torch.equal(s.ns["w"], torch.arange(128, dtype=torch.float32) * 2)
    assert st.covs_recomputed >= 1
    s.close()


def test_covs_recomputed_three_deep_chain():
    store = MemoryStore()
    s = KishuSession(store, chunk_bytes=256, cache_bytes=0, device="cpu")

    def mk(ns, name, dep):
        ns[name] = ns[dep] + 1
    s.register("mk", mk)
    c0 = s.init_state({"root": torch.zeros(64)})
    s.run("mk", name="a", dep="root")
    s.run("mk", name="b", dep="a")
    c3 = s.run("mk", name="c", dep="b")
    store.delete_chunks(list(store.list_chunk_keys()))
    st = s.checkout(c0)
    assert st.covs_recomputed == 0
    st = s.checkout(c3)
    assert st.covs_recomputed == 4
    assert torch.equal(s.ns["c"], torch.full((64,), 3.0))
    s.close()


# ---------------------------------------------------------------------------
# replay memo: bound, partial-hit top-up, release after the checkout
# ---------------------------------------------------------------------------

def test_resolve_memo_bytes(monkeypatch):
    assert resolve_memo_bytes(123) == 123
    monkeypatch.setenv("KISHU_RESTORE_MEMO_BYTES", "4096")
    assert resolve_memo_bytes() == 4096
    monkeypatch.setenv("KISHU_RESTORE_MEMO_BYTES", "junk")
    assert resolve_memo_bytes() == 256 << 20
    monkeypatch.delenv("KISHU_RESTORE_MEMO_BYTES")
    assert resolve_memo_bytes() == 256 << 20


def test_memo_bounded_eviction(monkeypatch):
    monkeypatch.setenv("KISHU_RESTORE_MEMO_BYTES", "1024")
    s = KishuSession(MemoryStore(), chunk_bytes=256, cache_bytes=0,
                     device="cpu")
    assert s.restorer.memo_bytes == 1024
    peak = [0]
    put = s.restorer._memo_put

    def counted_put(version, temp):
        put(version, temp)
        peak[0] = max(peak[0], len(s.restorer._memo))
    s.restorer._memo_put = counted_put

    class Opaque:
        def __init__(self, v):
            self.v = v

    def grow(ns, k=0):
        ns[f"o{k}"] = Opaque(k)
        ns["carry"] = torch.full((256,), float(k))   # 1 KiB per namespace
    s.register("grow", grow)
    s.init_state({"carry": torch.zeros(256)})
    last = None
    for k in range(6):
        last = s.run("grow", k=k)
    s.checkout(s.graph.path_from_root(last)[0])
    s.checkout(last)                     # replays the opaque chain
    assert s.restorer.replays >= 6
    # tensor bytes count toward the bound: at most ~1 KiB of namespaces
    # (plus the floor of one entry) were ever held, not all six
    assert 0 < peak[0] <= 2
    s.close()


def test_memo_counts_tensor_bytes_and_is_released_after_checkout():
    from repro_torch.core.restore import _ns_nbytes
    from repro_torch.core.namespace import Namespace
    ns = Namespace()
    ns["t"] = torch.zeros(1000, dtype=torch.float32)
    ns["h"] = torch.zeros(10, dtype=torch.bfloat16)
    assert _ns_nbytes(ns) == 4000 + 20
    s = build_session(MemoryStore(), plan_mode="replay", cache_bytes=0)
    cids = run_workload(s)
    st = s.checkout(cids[3])
    assert st.covs_recomputed > 0
    assert not s.restorer._memo and not s.restorer._memo_sizes
    s.close()


def test_memo_partial_hit_tops_up_without_rerun():
    s = KishuSession(MemoryStore(), chunk_bytes=256, cache_bytes=0,
                     device="cpu")
    runs = {"n": 0}

    def two(ns, k=1.0):
        runs["n"] += 1
        ns["p"] = torch.full((16,), k)
        ns["q"] = torch.full((16,), -k)
    s.register("two", two)
    s.init_state({"seed": torch.zeros(4)})
    c1 = s.run("two", k=5.0)
    before = runs["n"]
    s.restorer.recompute(("p",), c1, None)
    assert runs["n"] == before + 1
    del s.restorer._memo[c1]["q"]
    got = s.restorer.recompute(("q",), c1, None)
    assert torch.equal(got["q"], torch.full((16,), -5.0))
    assert runs["n"] == before + 1
    s.close()


def test_replay_count_in_log():
    s = build_session(MemoryStore(), plan_mode="replay", cache_bytes=0)
    cids = run_workload(s)
    s.checkout(cids[1])
    entries = {e["commit"]: e for e in s.log()}
    assert all("exec_s" in e and "replays" in e for e in entries.values())
    assert sum(e["replays"] for e in entries.values()) == s.restorer.replays
    assert any(e["replays"] > 0 for e in entries.values())
    s.close()


def test_cache_contains_no_side_effects():
    c = ChunkCache(1 << 16)
    c.put("k1", b"x" * 100)
    h0, m0 = c.hits, c.misses
    assert c.contains("k1") and not c.contains("nope")
    assert (c.hits, c.misses) == (h0, m0)
    assert ChunkCache(0).contains("k1") is False


def test_cli_plan_prices_without_a_session(tmp_path, capsys):
    uri = f"dir://{tmp_path}/cas"
    s = build_session(open_store(uri))
    cids = run_workload(s)
    s.close()
    for mode in MODES:
        assert cli(["--store", uri, "plan", cids[2], "--mode", mode]) == 0
        out = capsys.readouterr().out
        assert f"mode={mode}" in out and "covs:" in out
    assert cli(["--store", uri, "plan", "c99999"]) == 1
    assert cli(["--store", uri, "plan", cids[1], "--from", "c99999"]) == 1


# ---------------------------------------------------------------------------
# cross-package: `kishu plan` prints the same lines from both CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dir", "fabric"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cli_plan_lines_match_jax(kind, writer, tmp_path, capsys):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import repro.core as jcore
    from repro.launch.kishu_cli import main as jcli

    uri = f"dir://{tmp_path}/cas" if kind == "dir" else \
        f"fabric://shard(dir://{tmp_path}/s0,dir://{tmp_path}/s1)"
    if writer == "jax":
        s = jcore.KishuSession(jcore.open_store(uri), chunk_bytes=256)
        s.register("step", lambda ns, k=1.0: ns.__setitem__(
            "w", ns["w"] + jnp.float32(k)))
        cids = [s.init_state({"w": jnp.zeros(256, jnp.float32)})]
    else:
        s = build_session(open_store(uri))
        cids = [s.init_state({"w": torch.zeros(256)})]
    for k in (1.0, 2.0, 3.0):
        cids.append(s.run("step", k=k))
    s.close()
    for target, extra in ((cids[1], []), (cids[2], ["--from", cids[0]]),
                          (cids[3], ["--mode", "replay"])):
        for mode in ("auto", "fetch") if not extra else (None,):
            args = ["--store", uri, "plan", target] + extra \
                + (["--mode", mode] if mode else [])
            assert jcli(args) == 0
            jout = capsys.readouterr().out
            assert cli(args) == 0
            tout = capsys.readouterr().out
            assert jout == tout and "store model" in tout


def test_plan_lines_differ_from_jax_only_for_an_attach_target(tmp_path,
                                                              capsys):
    """The one intended difference: the JAX package may replay an
    ``__attach__`` (its arrays are immutable), the port never does (its
    tensors are not), so a plan whose target is an attach commit prices
    replay at infinity here.  The head lines and every other row agree."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import repro.core as jcore
    from repro.launch.kishu_cli import main as jcli
    uri = f"dir://{tmp_path}/cas"
    s = jcore.KishuSession(jcore.open_store(uri), chunk_bytes=256)
    s.register("step", lambda ns, k=1.0: ns.__setitem__(
        "w", ns["w"] + jnp.float32(k)))
    c0 = s.init_state({"w": jnp.zeros(256, jnp.float32)})
    s.run("step", k=1.0)
    s.close()
    args = ["--store", uri, "plan", c0, "--mode", "replay"]
    assert jcli(args) == 0
    jout = capsys.readouterr().out.splitlines()
    assert cli(args) == 0
    tout = capsys.readouterr().out.splitlines()
    assert len(jout) == len(tout) == 5
    assert jout[1:3] == tout[1:3]
    assert jout[3].startswith("replay") and "w @ " + c0 in jout[3]
    assert tout[3].startswith("fetch") and "w @ " + c0 in tout[3]
    assert tout[4].startswith("covs: 1 fetch, 0 patch, 0 replay")



# ---------------------------------------------------------------------------
# the restorer's check of a replayed __attach__
# ---------------------------------------------------------------------------

def _attach_lost_everywhere(tmp_path, kind, change):
    """An attach of ``w`` and ``emb``, two cells that change them (in place
    for ``change="in_place"``, by rebinding each name to a new tensor for
    ``"rebound"``), then every chunk file lost on every replica.  Returns
    (session, attach commit, the attached values as they were)."""
    import os
    import shutil
    uri = f"fabric://rep(dir://{tmp_path}/r0,dir://{tmp_path}/r1)" \
        if kind == "fabric" else f"dir://{tmp_path}/cas"
    s = KishuSession(open_store(uri), chunk_bytes=256, cache_bytes=0,
                     device="cpu", plan_mode="fetch")
    w = torch.arange(1024, dtype=torch.float32)
    emb = torch.linspace(-1, 1, 4096).reshape(64, 64).clone()
    want = {"w": w.clone(), "emb": emb.clone()}
    if change == "in_place":
        s.register("bump", lambda ns: ns["w"].add_(1.0))
        s.register("touch", lambda ns: ns["emb"].mul_(2.0))
    else:
        s.register("bump", lambda ns: ns.__setitem__("w", ns["w"] + 1.0))
        s.register("touch", lambda ns: ns.__setitem__("emb",
                                                      ns["emb"] * 2.0))
    c0 = s.init_state({"w": w, "emb": emb})
    s.run("bump")
    s.run("touch")
    for root in ("r0", "r1") if kind == "fabric" else ("cas",):
        shutil.rmtree(os.path.join(tmp_path, root, "chunks"))
        os.makedirs(os.path.join(tmp_path, root, "chunks"))
    return s, c0, want


@pytest.mark.parametrize("kind", ["dir", "fabric"])
def test_replayed_attach_of_a_tensor_changed_in_place_raises(tmp_path, kind):
    """Before, the fallback replayed the attach with the caller's tensors,
    which the cells had changed in place, and restored today's values as
    the attach's without an error.  Now the replayed bytes are held
    against the commit's detection hashes, and the checkout raises."""
    from repro_torch.core.restore import RestoreError
    s, c0, _ = _attach_lost_everywhere(tmp_path, kind, "in_place")
    with pytest.raises(RestoreError, match=r"differs from the commit at "
                                           r"chunk 0 of \d+"):
        s.checkout(c0)
    s.close()


@pytest.mark.parametrize("kind", ["dir", "fabric"])
def test_replayed_attach_unchanged_restores_exactly(tmp_path, kind):
    """The cells rebind ``w`` and ``emb`` to new tensors, so the attached
    ones are unchanged: with every chunk lost, both replay, pass the check
    and come back exactly.  The check passes a value that is not an array
    and refuses the changed bytes, chunk by chunk."""
    from repro_torch.core.graph import key_str
    from repro_torch.core.restore import (RestoreError,
                                          check_against_manifest)
    s, c0, want = _attach_lost_everywhere(tmp_path, kind, "rebound")
    st = s.checkout(c0)
    assert st.covs_recomputed == 2
    assert torch.equal(s.ns["w"], want["w"])
    assert torch.equal(s.ns["emb"], want["emb"])
    man = s.graph.manifest_of(("emb",), c0)
    assert man is s.graph.nodes[c0].manifests[key_str(("emb",))]
    check_against_manifest(("emb",), c0, man, {"emb": want["emb"]})
    check_against_manifest(("emb",), c0, man, {"emb": "not an array"})
    late = want["emb"].clone()
    late[40, 3] += 1                 # byte 10252: chunk 40 of 256-byte ones
    with pytest.raises(RestoreError, match="chunk 40 of 64"):
        check_against_manifest(("emb",), c0, man, {"emb": late})
    with pytest.raises(RestoreError, match=r"\[64, 32\]"):
        check_against_manifest(("emb",), c0, man,
                               {"emb": want["emb"][:, :32].contiguous()})
    # a manifest without detection hashes is held by its chunk keys
    keyed = {**man, "base": {**man["base"], "det_hashes": []}}
    check_against_manifest(("emb",), c0, keyed, {"emb": want["emb"]})
    with pytest.raises(RestoreError, match="chunk 40 of 64"):
        check_against_manifest(("emb",), c0, keyed, {"emb": late})
    s.close()


@pytest.mark.parametrize("change", ["in_place", "rebound"])
def test_replayed_attach_of_a_one_chunk_tensor(tmp_path, change):
    """A tensor smaller than one chunk (52 bytes at 256-byte chunks) is
    hashed again at the next power of two, 64: one chunk hashes alike at
    any chunk size that covers it.  Changed in place, its replay raises;
    unchanged, it comes back exactly."""
    import os
    import shutil
    from repro_torch.core import hashing
    from repro_torch.core.restore import RestoreError
    b = torch.linspace(-3, 3, 13)
    assert hashing.chunk_hashes_np(b.numpy(), 64).tolist() == \
        hashing.chunk_hashes_np(b.numpy(), 256).tolist()
    want = b.clone()
    s = KishuSession(open_store(f"dir://{tmp_path}/cas"), chunk_bytes=256,
                     cache_bytes=0, device="cpu", plan_mode="fetch")
    if change == "in_place":
        s.register("bump", lambda ns: ns["b"].add_(1.0))
    else:
        s.register("bump", lambda ns: ns.__setitem__("b", ns["b"] + 1.0))
    c0 = s.init_state({"b": b})
    s.run("bump")
    assert len(s.graph.manifest_of(("b",), c0)["base"]["chunks"]) == 1
    shutil.rmtree(os.path.join(tmp_path, "cas", "chunks"))
    os.makedirs(os.path.join(tmp_path, "cas", "chunks"))
    if change == "in_place":
        with pytest.raises(RestoreError, match="differs from the commit at "
                                               "chunk 0 of 1"):
            s.checkout(c0)
    else:
        assert s.checkout(c0).covs_recomputed == 1
        assert torch.equal(s.ns["b"], want)
    s.close()
