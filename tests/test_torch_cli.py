"""The port's kishu CLI (``python -m repro_torch.launch.kishu_cli``) and
kishud daemon, over stores written by ``device="cpu"`` sessions.

The reference suites' CLI cases (``test_cli.py``) and the kishud and
lease/tenant cases of ``test_multi_session.py`` run here on the port.
With jax present, both CLIs print the same lines on one store, and each
package's ``fsck`` / ``recover`` runs on a store the other crashed in.
"""
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import KishuSession, open_store
from repro_torch.core.chunkstore import (FaultInjectingStore, InjectedCrash,
                                         MemoryStore, NamespacedStore,
                                         SQLiteStore)
from repro_torch.launch.kishu_cli import main as cli
from repro_torch.launch.kishud import (BACKGROUND, INTERACTIVE,
                                       AdmissionQueue, Kishud, KishudServer,
                                       control)

ROOT = Path(__file__).resolve().parents[1]


def set_val(ns, name, val):
    ns[name] = torch.full((500,), float(val))


@pytest.fixture
def store_uri(tmp_path):
    uri = f"dir://{tmp_path}/cas"
    s = KishuSession(open_store(uri), chunk_bytes=1 << 10, device="cpu")
    s.register("set_val", set_val)
    s.init_state({})
    s.run("set_val", name="x", val=1)
    root = s.head
    s.run("set_val", name="y", val=2)
    s.checkout(root)
    s.run("set_val", name="y", val=3)
    s.close()
    return uri, s


def test_log_show_diff_stats(store_uri, capsys):
    uri, s = store_uri
    assert cli(["--store", uri, "log"]) == 0
    out = capsys.readouterr().out
    assert "set_val" in out and "*" in out
    head = s.graph.head
    assert cli(["--store", uri, "show", head]) == 0
    assert "upd y" in capsys.readouterr().out
    nodes = sorted(s.graph.nodes)
    assert cli(["--store", uri, "diff", nodes[-2], nodes[-1]]) == 0
    assert "diverged" in capsys.readouterr().out
    assert cli(["--store", uri, "stats"]) == 0
    assert "chunks" in capsys.readouterr().out


def test_verify_detects_missing_chunk(store_uri, capsys):
    uri, s = store_uri
    assert cli(["--store", uri, "verify", "--deep"]) == 0
    assert "OK" in capsys.readouterr().out
    store = open_store(uri)
    man = next(m for n in s.graph.nodes.values()
               for m in n.manifests.values() if not m.get("unserializable"))
    store.delete_chunk(man["base"]["chunks"][0]["key"])
    assert cli(["--store", uri, "verify"]) == 2
    assert "MISSING" in capsys.readouterr().out


def test_gc_dry_run_and_real(store_uri, capsys):
    uri, s = store_uri
    store = open_store(uri)
    store.put_chunk("deadbeef" * 4, b"junk")
    assert cli(["--store", uri, "gc", "--dry-run"]) == 0
    assert "would drop 1" in capsys.readouterr().out
    assert cli(["--store", uri, "gc"]) == 0
    assert "dropped 1" in capsys.readouterr().out
    assert not store.has_chunk("deadbeef" * 4)


def test_bad_commit_errors(store_uri):
    uri, _ = store_uri
    assert cli(["--store", uri, "show", "c99999"]) == 1
    assert cli(["--store", uri, "diff", "c99999", "c00000"]) == 1


def _build_history(uri):
    s = KishuSession(open_store(uri), chunk_bytes=1 << 10, device="cpu")
    s.register("set_val", set_val)
    s.init_state({})
    s.run("set_val", name="x", val=1)
    s.run("set_val", name="y", val=2)
    s.close()
    return s


@pytest.fixture(params=["sqlite_codec", "fabric", "fabric_codec"])
def any_store_uri(request, tmp_path):
    uri = {
        "sqlite_codec": f"sqlite://{tmp_path}/cas.db?codec=zlib",
        "fabric": f"fabric://shard(dir://{tmp_path}/s0,dir://{tmp_path}/s1)",
        "fabric_codec": (f"fabric://rep(dir://{tmp_path}/r0,"
                         f"dir://{tmp_path}/r1)?codec=zlib"),
    }[request.param]
    return uri, _build_history(uri)


def test_every_subcommand_accepts_uri(any_store_uri, capsys):
    uri, s = any_store_uri
    nodes = sorted(s.graph.nodes)
    assert cli(["--store", uri, "log"]) == 0
    assert "set_val" in capsys.readouterr().out
    assert cli(["--store", uri, "show", s.graph.head]) == 0
    assert "upd y" in capsys.readouterr().out
    assert cli(["--store", uri, "diff", nodes[-2], nodes[-1]]) == 0
    assert "diverged" in capsys.readouterr().out
    assert cli(["--store", uri, "stats"]) == 0
    assert "chunks" in capsys.readouterr().out
    assert cli(["--store", uri, "verify", "--deep"]) == 0
    assert "OK" in capsys.readouterr().out
    assert cli(["--store", uri, "gc", "--dry-run"]) == 0
    assert "would drop 0" in capsys.readouterr().out
    assert cli(["--store", uri, "plan", nodes[1]]) == 0
    assert "store model" in capsys.readouterr().out
    assert cli(["--store", uri, "topology"]) == 0
    assert cli(["--store", uri, "scrub"]) == 0
    assert cli(["--store", uri, "fsck"]) == 0
    assert "fsck: OK" in capsys.readouterr().out


def test_trace_without_spans_exits_nonzero(tmp_path, capsys):
    uri = f"dir://{tmp_path}/cas"
    _build_history(uri)
    assert cli(["--store", uri, "trace"]) == 1
    assert "no persisted spans" in capsys.readouterr().err


def test_trace_merges_persisted_spans(tmp_path, capsys):
    uri = f"dir://{tmp_path}/cas"
    s = KishuSession(open_store(uri), chunk_bytes=1 << 10, device="cpu",
                     trace=True)
    s.register("set_val", set_val)
    s.init_state({})
    s.run("set_val", name="x", val=1)
    s.close()
    out = tmp_path / "trace.json"
    assert cli(["--store", uri, "trace", "--out", str(out)]) == 0
    import json
    events = json.loads(out.read_text())["traceEvents"]
    assert any(e.get("name") == "exec" for e in events)


def test_stats_metrics_on_every_uri(any_store_uri, capsys):
    import re
    uri, _ = any_store_uri
    assert cli(["--store", uri, "stats", "--metrics"]) == 0
    out = capsys.readouterr().out
    line = re.compile(r"^(# (TYPE|HELP) .*|"
                      r"[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [-+0-9.e]+)$")
    for ln in out.splitlines():
        if ln:
            assert line.match(ln), f"bad exposition line: {ln!r}"
    m = re.search(r"^kishu_graph_commits (\d+)$", out, re.M)
    assert m and int(m.group(1)) >= 2


def test_cli_runs_as_a_module(store_uri):
    uri, _ = store_uri
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.kishu_cli", "--store",
         uri, "log"], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "set_val" in out.stdout
    assert "jax" not in out.stderr


# ---------------------------------------------------------------------------
# leases and tenants (the CLI verbs of test_multi_session.py)
# ---------------------------------------------------------------------------

def test_cli_lease_and_tenants_verbs(tmp_path, capsys):
    uri = f"dir://{tmp_path}/cas"
    store = open_store(uri)
    a = KishuSession(store, chunk_bytes=1 << 9, tenant="alice",
                     lease_ttl_s=60.0, device="cpu")
    a.init_state({"a": torch.arange(64, dtype=torch.float32)})
    b = KishuSession(store, chunk_bytes=1 << 9, tenant="bob", device="cpu")
    b.init_state({"a": torch.arange(64, dtype=torch.float32)})
    b.close()
    assert cli(["--store", uri, "tenants"]) == 0
    out = capsys.readouterr().out
    assert "alice" in out and "bob" in out
    assert cli(["--store", f"{uri}?tenant=alice", "lease"]) == 0
    assert a.lease.owner in capsys.readouterr().out
    assert cli(["--store", f"{uri}?tenant=alice", "lease",
                "--release", "writer"]) == 0
    capsys.readouterr()
    assert NamespacedStore(store, "alice").get_meta("lease/writer") is None
    assert cli(["--store", f"{uri}?tenant=alice", "lease",
                "--release", "writer"]) == 1
    assert cli(["--store", f"{uri}?tenant=bob", "lease"]) == 0
    assert "no leases held" in capsys.readouterr().out
    a.close()


# ---------------------------------------------------------------------------
# kishud: admission queue, daemon, control socket
# ---------------------------------------------------------------------------

def test_admission_queue_interactive_before_background():
    q = AdmissionQueue(workers=1)
    order = []
    gate = threading.Event()
    blocker = q.submit(gate.wait)
    jb = q.submit(lambda: order.append("bg"), BACKGROUND)
    ji = q.submit(lambda: order.append("int"), INTERACTIVE)
    gate.set()
    ji.done.wait(5)
    jb.done.wait(5)
    blocker.done.wait(5)
    assert order == ["int", "bg"]
    stats = q.stats()
    assert stats["served_interactive"] == 2
    assert stats["served_background"] == 1
    q.close()


def test_admission_queue_delivers_exceptions():
    q = AdmissionQueue(workers=1)
    with pytest.raises(ZeroDivisionError):
        q.run(lambda: 1 // 0)
    assert q.run(lambda: 41 + 1) == 42
    q.close()


def test_kishud_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Kishud(MemoryStore())


def test_kishud_multiplexes_tenants_with_shared_cache():
    d = Kishud(MemoryStore(), workers=2, lease_ttl_s=30.0,
               chunk_bytes=1 << 9, device="cpu")
    a = d.session("alice")
    b = d.session("bob")
    for s in (a, b):
        s.register("set_val", set_val)
        s.init_state({"a": torch.arange(64, dtype=torch.float32)})
    ca = a.run("set_val", name="x", val=1)
    cb = b.run("set_val", name="x", val=2)
    a.checkout(ca)
    b.checkout(cb)
    assert torch.all(a.ns["x"] == 1.0) and torch.all(b.ns["x"] == 2.0)
    assert a.session.device == b.session.device == torch.device("cpu")
    assert a.session.chunk_cache is b.session.chunk_cache is d.cache
    st = d.status()
    assert st["n_sessions"] == 2 and st["tenants"] == ["alice", "bob"]
    assert st["queue"]["served_interactive"] >= 6
    rows = {r["tenant"]: r for r in d.tenants()}
    assert rows["alice"]["lease_owner"] != rows["bob"]["lease_owner"]
    assert rows["alice"]["n_commits"] == rows["bob"]["n_commits"] == 3
    assert "kishud_sessions 2" in d.metrics_text()
    assert d.scrub().problems == 0 and d.rebalance()["chunks_moved"] == 0
    d.close()


def test_kishud_session_survives_daemon_restart(tmp_path):
    uri = f"dir://{tmp_path}/cas"
    d = Kishud(uri, workers=1, lease_ttl_s=0.2, chunk_bytes=1 << 9,
               device="cpu")
    s = d.session("nb")
    s.register("set_val", set_val)
    s.init_state({"a": torch.arange(64, dtype=torch.float32)})
    cid = s.run("set_val", name="x", val=4)
    d.queue.close()
    del d, s
    d2 = Kishud(uri, workers=1, lease_ttl_s=0.2, chunk_bytes=1 << 9,
                device="cpu")
    t0 = time.monotonic()
    s2 = d2.session("nb", lease_wait_s=10.0)
    assert time.monotonic() - t0 >= 0.2
    s2.register("set_val", set_val)
    assert s2.head == cid
    s2.session.loader.materialize_state(s2.session.tracked, cid)
    assert torch.all(s2.ns["x"] == 4.0)
    d2.close()


def test_kishud_socket_control(tmp_path):
    d = Kishud(MemoryStore(), workers=1, lease_ttl_s=30.0,
               chunk_bytes=1 << 9, device="cpu")
    sock = str(tmp_path / "kd.sock")
    srv = KishudServer(d, sock)
    try:
        assert control(sock, "ping")["pong"] is True
        s = d.session("alice")
        s.register("set_val", set_val)
        s.init_state({"a": torch.arange(64, dtype=torch.float32)})
        st = control(sock, "status")
        assert st["ok"] and st["tenants"] == ["alice"]
        tn = control(sock, "tenants")
        assert tn["tenants"][0]["tenant"] == "alice"
        assert tn["leases"][0]["owner"] is not None
        assert "kishud_uptime_seconds" in control(sock, "metrics")["metrics"]
        assert control(sock, "frobnicate")["ok"] is False
        assert control(sock, "stop")["stopping"] is True
        assert srv.wait(5)
    finally:
        srv.close()
        d.close()


def test_cli_kishud_start_status_stop(tmp_path, capsys):
    """``kishud start`` (in the foreground, on a thread here) serves the
    store until ``kishud stop``; ``status`` and ``metrics`` reach it."""
    uri = f"dir://{tmp_path}/cas"
    sock = str(tmp_path / "kd.sock")
    assert cli(["--store", uri, "kishud", "status", "--socket", sock]) == 1
    assert "no daemon" in capsys.readouterr().err
    rc = []
    th = threading.Thread(target=lambda: rc.append(cli(
        ["--store", uri, "kishud", "start", "--socket", sock, "--workers",
         "1", "--device", "cpu"])))
    th.start()
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                if control(sock, "ping").get("ok"):
                    break
            except OSError:
                time.sleep(0.05)
        assert cli(["--store", uri, "kishud", "status", "--socket",
                    sock]) == 0
        assert "n_sessions" in capsys.readouterr().out
        assert cli(["--store", uri, "kishud", "metrics", "--socket",
                    sock]) == 0
        assert "kishud_sessions" in capsys.readouterr().out
    finally:
        cli(["--store", uri, "kishud", "stop", "--socket", sock])
        th.join(30)
    assert rc == [0] and not th.is_alive()
    assert "kishud: stopped" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# cross-package: one store, both CLIs
# ---------------------------------------------------------------------------

VERBS = (["log"], ["stats"], ["verify", "--deep"], ["fsck"], ["gc",
         "--dry-run"], ["topology"], ["tenants"])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_both_clis_print_the_same_lines(writer, tmp_path, capsys):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import repro.core as jcore
    from repro.launch.kishu_cli import main as jcli
    uri = f"fabric://shard(dir://{tmp_path}/s0,dir://{tmp_path}/s1)"
    if writer == "jax":
        s = jcore.KishuSession(jcore.open_store(uri), chunk_bytes=1 << 10)
        s.register("set_val", lambda ns, name, val: ns.__setitem__(
            name, jnp.full((500,), float(val), jnp.float32)))
        s.init_state({})
        s.run("set_val", name="x", val=1)
        s.run("set_val", name="y", val=2)
        s.close()
        nodes = sorted(s.graph.nodes)
    else:
        nodes = sorted(_build_history(uri).graph.nodes)
    for verb in VERBS + (["show", nodes[-1]], ["diff", nodes[1], nodes[-1]]):
        assert jcli(["--store", uri] + verb) == 0
        jout = capsys.readouterr().out
        assert cli(["--store", uri] + verb) == 0
        tout = capsys.readouterr().out
        if verb == ["log"]:             # exec= is a timing
            jout, tout = ([ln.split(" exec=")[0] for ln in o.splitlines()]
                          for o in (jout, tout))
        assert jout == tout, verb


def _crash_mid_publish(make_session, set_cell, inner, arr):
    """Run attach + three cells through a FaultInjectingStore that kills
    the writer just before its last commit doc lands (the journal is in
    publish state)."""
    probe = FaultInjectingStore(MemoryStore())
    s = make_session(probe)
    s.register("set_val", set_cell)
    s.init_state({"a": arr})
    for name, val in (("x", 1), ("y", 2), ("x", 3)):
        s.run("set_val", name=name, val=val)
    s.close()
    k = max(i for i, op in enumerate(probe.op_log)
            if op.startswith("put_meta:commit/"))
    try:
        s = make_session(FaultInjectingStore(inner, crash_after=k))
        s.register("set_val", set_cell)
        s.init_state({"a": arr})
        for name, val in (("x", 1), ("y", 2), ("x", 3)):
            s.run("set_val", name=name, val=val)
        s.close()
    except Exception as e:  # noqa: BLE001 — the injected kill, maybe wrapped
        if not isinstance(e, InjectedCrash) \
                and not isinstance(e.__cause__, InjectedCrash):
            raise
    else:
        raise AssertionError("the kill point never fired")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_fsck_and_recover_across_packages(writer, tmp_path, capsys):
    """One package crashes mid-publish; the other's fsck sees the unsealed
    journal (both print the same report), its recover rolls it forward,
    and both then find the store clean and read the same head state."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import repro.core as jcore
    from repro.launch.kishu_cli import main as jcli
    path = tmp_path / "cas.db"
    uri = f"sqlite://{path}"
    inner = SQLiteStore(str(path))
    if writer == "jax":
        _crash_mid_publish(
            lambda st: jcore.KishuSession(st, chunk_bytes=1 << 9),
            lambda ns, name, val: ns.__setitem__(
                name, jnp.full((400,), float(val), jnp.float32)),
            inner, jnp.arange(64, dtype=jnp.float32))
        reader, other = cli, jcli
    else:
        _crash_mid_publish(
            lambda st: KishuSession(st, chunk_bytes=1 << 9, device="cpu"),
            lambda ns, name, val: ns.__setitem__(
                name, torch.full((400,), float(val))),
            inner, torch.arange(64, dtype=torch.float32))
        reader, other = jcli, cli
    capsys.readouterr()
    assert other(["--store", uri, "fsck"]) == 2
    oout = capsys.readouterr().out
    assert reader(["--store", uri, "fsck"]) == 2
    rout = capsys.readouterr().out
    assert rout == oout and "unsealed" in rout
    assert reader(["--store", uri, "recover"]) == 0
    assert "1 txns replayed" in capsys.readouterr().out
    for c in (reader, other):
        assert c(["--store", uri, "fsck"]) == 0
        assert "fsck: OK" in capsys.readouterr().out
    assert reader(["--store", uri, "recover"]) == 0
    assert "0 txns replayed" in capsys.readouterr().out
    t = KishuSession(open_store(uri), chunk_bytes=1 << 9, device="cpu")
    t.loader.materialize_state(t.tracked, t.graph.head)
    j = jcore.KishuSession(jcore.open_store(uri), chunk_bytes=1 << 9)
    j.loader.materialize_state(j.tracked, j.graph.head)
    assert t.graph.head == j.graph.head
    assert sorted(t.ns.names()) == sorted(j.ns.names())
    for n in t.ns.names():
        assert t.ns[n].numpy().tobytes() == np.asarray(j.ns[n]).tobytes()
    t.close()
    j.close()
