"""The port's transactional commit engine: crash injection, recovery,
fsck, group commit (DESIGN.md §13), on ``device="cpu"`` sessions whose
cells hold torch tensors.

The core suite sweeps a simulated process kill over EVERY write operation of
a small multi-commit workload — on the memory and directory backends and
on fabric topologies (shard ring, replica set) — and proves
that after ``txn.recover`` (run implicitly by the session/graph open):

  * the store is fsck-clean: no unsealed journals, no torn HEAD, no
    missing parents or chunks, no dangling chunks;
  * the recovered state is *bit-identical* to some prefix of the committed
    workload (commit atomicity: a kill can lose the in-flight cell, never
    tear or corrupt state).
"""
import json

import pytest
import torch

from repro_torch.core import txn
from repro_torch.core.chunkstore import (DirectoryStore, FaultInjectingStore,
                                   InjectedCrash, MemoryStore, SQLiteStore)
from repro_torch.core.fabric import ReplicatedStore, ShardedStore
from repro_torch.core.session import KishuSession
from repro_torch.launch.kishu_cli import main as cli

BACKENDS = ["memory", "dir", "shard", "rep"]


def make_inner(kind, tmp_path, tag):
    if kind == "memory":
        return MemoryStore()
    if kind == "dir":
        return DirectoryStore(str(tmp_path / f"d{tag}"))
    if kind == "sqlite":
        return SQLiteStore(str(tmp_path / f"s{tag}.db"))
    if kind == "shard":
        return ShardedStore([MemoryStore(), MemoryStore()])
    if kind == "rep":
        return ReplicatedStore([MemoryStore(), MemoryStore()])
    raise AssertionError(kind)


def set_val(ns, name, val):
    ns[name] = torch.full((400,), float(val))


def arange(n):
    return torch.arange(n, dtype=torch.float32)


def build_session(store, **kw):
    s = KishuSession(store, chunk_bytes=1 << 9, device="cpu", **kw)
    s.register("set_val", set_val)
    return s


def snapshot(ns):
    return {name: ns[name].contiguous().view(torch.uint8).numpy().tobytes()
            for name in ns.names()}


def run_workload(s, states=None):
    """Three cells after attach; record the live state after each commit."""
    def record():
        if states is not None:
            states.append(snapshot(s.ns))
    s.init_state({"a": arange(64)})
    record()
    s.run("set_val", name="x", val=1)
    record()
    s.run("set_val", name="y", val=2)
    record()
    s.run("set_val", name="x", val=3)
    record()


def crash_run(store, **session_kw):
    """Build a session and drive the workload, absorbing the injected kill
    wherever it lands (including session construction — init_root commits).
    A kill inside the publish surfaces wrapped in TxnError (the engine
    poisons itself on publish failure) — still the simulated process
    death.  Returns True if the workload survived to completion."""
    from repro_torch.core.txn import TxnError
    try:
        s = build_session(store, **session_kw)
        run_workload(s)
        s.close()
        return True
    except InjectedCrash:
        return False
    except TxnError as e:
        if isinstance(e.__cause__, InjectedCrash):
            return False
        raise


def probe_ops(store_factory, **session_kw):
    """Run the workload uncrashed over a counting wrapper; returns the
    wrapper (total op count + per-op labels)."""
    probe = FaultInjectingStore(store_factory())
    assert crash_run(probe, **session_kw)
    return probe


@pytest.fixture(scope="module")
def reference_states():
    """Bit-exact session states after each commit of the workload, plus the
    empty pre-attach state — the only legal recovery targets."""
    s = build_session(MemoryStore())
    states = [{}]
    run_workload(s, states)
    s.close()
    return states


def reopen_state(inner):
    """Reboot: fresh session over the bare store (open runs txn.recover),
    then materialize HEAD exactly as elastic crash-recovery would."""
    s = KishuSession(inner, chunk_bytes=1 << 9, device="cpu")
    if s.graph.head is not None and s.graph.nodes[s.graph.head].state_index:
        s.loader.materialize_state(s.tracked, s.graph.head)
    state = snapshot(s.ns)
    s.close()
    return state


def assert_recovers_clean(inner, k, reference_states):
    # pre-recovery invariant (the _persist ordering): even before any
    # recovery runs, HEAD must never name a commit whose doc is missing
    head_doc = inner.get_meta("HEAD")
    if head_doc and head_doc.get("head") is not None:
        doc = inner.get_meta(f"commit/{head_doc['head']}")
        assert doc is not None and doc.get("deleted") is not True, \
            f"torn HEAD at kill point {k}"
    state = reopen_state(inner)       # session open replays/rolls back
    assert state in reference_states, \
        f"kill at op {k}: recovered state matches no committed prefix"
    rep = txn.fsck(inner)
    assert rep.problems == 0, (k, rep.details)


@pytest.mark.parametrize("kind", BACKENDS)
def test_crash_sweep_recovers_bit_identical(kind, tmp_path,
                                            reference_states):
    total = probe_ops(lambda: make_inner(kind, tmp_path, "probe")).ops
    assert total > 10, "sweep would not cover the pipeline"
    for k in range(total):
        inner = make_inner(kind, tmp_path, k)
        survived = crash_run(FaultInjectingStore(inner, crash_after=k))
        assert not survived      # every k < total is a real kill point
        assert_recovers_clean(inner, k, reference_states)


def test_kill_between_commit_doc_and_head(tmp_path, reference_states):
    """On a backend whose multi-meta publish
    decomposes to per-doc puts, kill exactly between the commit doc and
    the HEAD put — HEAD must keep naming the previous durable commit and
    recovery must roll the journaled publish forward."""
    probe = probe_ops(MemoryStore)
    doc_puts = [i for i, op in enumerate(probe.op_log)
                if op.startswith("put_meta:commit/")
                and probe.op_log[i + 1].startswith("put_meta:HEAD")]
    assert doc_puts, "publish pattern not found in op trace"
    for k in (i + 1 for i in doc_puts):     # commit doc landed, HEAD next
        inner = MemoryStore()
        assert not crash_run(FaultInjectingStore(inner, crash_after=k))
        assert_recovers_clean(inner, k, reference_states)


def test_group_commit_batches_publishes():
    store = MemoryStore()
    s = build_session(store, group_commit_n=3)  # init_root queued (1 of 3)
    s.init_state({"a": arange(64)})   # attach (2 of 3)
    # group not full: nothing published yet — the in-memory graph is
    # deliberately ahead of the durable one
    assert s.engine.pending_commits() == 2
    assert store.get_meta(f"commit/{s.head}") is None
    s.run("set_val", name="x", val=1)           # 3 of 3 -> published
    assert s.engine.pending_commits() == 0
    assert store.get_meta(f"commit/{s.head}") is not None
    assert store.get_meta("HEAD")["head"] == s.head
    s.run("set_val", name="y", val=2)           # queued again
    s.close()                                   # flush publishes the tail
    assert store.get_meta("HEAD")["head"] == s.head
    assert s.engine.stats.publishes == 2
    assert txn.fsck(store).problems == 0


def test_group_commit_crash_loses_at_most_group(tmp_path, reference_states):
    """A kill mid-group recovers to SOME committed prefix (possibly a few
    cells back — classic group-commit semantics), never torn state."""
    total = probe_ops(MemoryStore, group_commit_n=2).ops
    for k in range(total):
        inner = MemoryStore()
        crash_run(FaultInjectingStore(inner, crash_after=k),
                  group_commit_n=2)
        assert_recovers_clean(inner, k, reference_states)


def test_async_write_and_async_publish_roundtrip(tmp_path, reference_states):
    store = SQLiteStore(str(tmp_path / "async.db"))
    s = build_session(store, async_write=True, async_publish=True,
                      group_commit_n=2)
    states = []
    run_workload(s, states)
    s.close()
    assert txn.fsck(store).problems == 0
    assert reopen_state(store) == states[-1] == reference_states[-1]


def test_checkout_flushes_pending_publishes():
    store = MemoryStore()
    s = build_session(store, group_commit_n=8, async_publish=True)
    s.init_state({"a": arange(64)})
    c1 = s.run("set_val", name="x", val=1)
    s.run("set_val", name="x", val=2)
    s.checkout(c1)                  # time travel forces the queue out
    assert torch.all(s.ns["x"] == 1.0)
    assert store.get_meta(f"commit/{c1}") is not None
    s.close()
    assert txn.fsck(store).problems == 0


def test_recover_rolls_forward_and_is_idempotent(tmp_path):
    probe = probe_ops(lambda: SQLiteStore(str(tmp_path / "probe.db")))
    # kill right before a commit-doc put: the journal is in publish state,
    # so recovery must roll FORWARD (replay the publish)
    k = max(i for i, op in enumerate(probe.op_log)
            if op.startswith("put_meta:commit/"))
    inner = SQLiteStore(str(tmp_path / "idem.db"))
    assert not crash_run(FaultInjectingStore(inner, crash_after=k))
    first = txn.recover(inner)
    assert first["replayed"] == 1
    assert first["commits_published"] >= 1
    second = txn.recover(inner)
    assert second == {"replayed": 0, "rolled_back": 0,
                      "commits_published": 0, "chunks_dropped": 0}
    assert txn.fsck(inner).problems == 0


def test_recover_rolls_back_open_txn(tmp_path):
    probe = probe_ops(MemoryStore)
    # kill right before the first chunk put of the last cell: journal is
    # open with chunk keys; recovery must roll BACK and drop the orphans
    k = max(i for i, op in enumerate(probe.op_log)
            if op.startswith("put_chunk:"))
    inner = MemoryStore()
    assert not crash_run(FaultInjectingStore(inner, crash_after=k + 1))
    out = txn.recover(inner)
    assert out["rolled_back"] >= 1
    assert out["chunks_dropped"] >= 1
    assert txn.fsck(inner).problems == 0


class _FailingPutStore(MemoryStore):
    """Chunk puts raise (disk full / dead backend) while ``fail`` is on;
    everything else works — the async drain records the errors and the
    publish fence must surface them."""

    def __init__(self):
        super().__init__()
        self.fail = False

    def put_chunk(self, key, data):
        if self.fail:
            raise IOError("injected: chunk device full")
        return super().put_chunk(key, data)


def test_failed_async_chunk_write_never_publishes_torn_state():
    """A chunk that never lands (async writer fault) must abort its
    transaction: the fence failure rolls the group back, the engine
    poisons itself, and no later commit can publish metadata naming the
    missing chunks — the reopened store is fsck-clean at the last good
    prefix."""
    from repro_torch.core.txn import TxnError

    store = _FailingPutStore()
    s = build_session(store, async_write=True)
    s.init_state({"a": arange(64)})   # lands durably
    attach_state = snapshot(s.ns)
    store.fail = True
    with pytest.raises(TxnError):
        s.run("set_val", name="x", val=1)      # fence fails -> abort
    with pytest.raises(TxnError):
        s.run("set_val", name="y", val=2)      # engine is poisoned
    store.fail = False
    rep = txn.fsck(store)
    assert rep.problems == 0, rep.details      # nothing torn, no orphans
    assert reopen_state(store) == attach_state


def test_fsck_detects_problems():
    store = MemoryStore()
    s = build_session(store)
    run_workload(s)
    s.close()
    assert txn.fsck(store).clean
    # dangling chunk
    store.put_chunk("deadbeef" * 4, b"junk")
    rep = txn.fsck(store)
    assert rep.dangling_chunks == 1 and not rep.clean
    store.delete_chunk("deadbeef" * 4)
    # missing chunk
    victim = next(iter(s.graph.live_chunk_keys()))
    data = store.get_chunk(victim)
    store.delete_chunk(victim)
    assert txn.fsck(store).missing_chunks >= 1
    store.put_chunk(victim, data)
    # torn HEAD
    good_head = store.get_meta("HEAD")
    store.put_meta("HEAD", {"head": "c99999", "seq": 99})
    assert txn.fsck(store).torn_head == 1
    store.put_meta("HEAD", good_head)
    # unsealed journal
    store.put_meta("txn/zzz", {"status": "open", "chunks": []})
    assert txn.fsck(store).unsealed_txns == 1
    store.delete_meta("txn/zzz")
    assert txn.fsck(store).clean


def test_gc_purges_tombstones(tmp_path):
    store = SQLiteStore(str(tmp_path / "gc.db"))
    s = build_session(store)
    s.init_state({"a": arange(64)})
    root = s.run("set_val", name="x", val=1)
    s.run("set_val", name="y", val=2)
    branch_tip = s.head
    s.checkout(root)
    s.run("set_val", name="y", val=9)
    doomed = s.delete_branch(branch_tip)
    assert doomed
    # tombstones present until gc purges them
    tombs = [n for n in store.list_meta("commit/")
             if (store.get_meta(n) or {}).get("deleted") is True]
    assert len(tombs) == len(doomed)
    out = s.gc()
    assert out["tombstones_purged"] == len(doomed)
    assert not [n for n in store.list_meta("commit/")
                if (store.get_meta(n) or {}).get("deleted") is True]
    # the graph reloads identically without the tombstones
    s2 = KishuSession(store, chunk_bytes=1 << 9, device="cpu")
    assert sorted(s2.graph.nodes) == sorted(s.graph.nodes)
    s2.close()
    s.close()
    assert txn.fsck(store).problems == 0


def test_total_meta_bytes_cached():
    store = MemoryStore()
    s = build_session(store)
    run_workload(s)

    def recompute(graph):
        return sum(len(json.dumps(n.to_doc()))
                   for n in graph.nodes.values())

    assert s.graph.total_meta_bytes() == recompute(s.graph)
    branch_root = s.head
    s.run("set_val", name="z", val=7)
    tip = s.head
    s.checkout(branch_root)
    s.run("set_val", name="z", val=8)
    s.delete_branch(tip)
    assert s.graph.total_meta_bytes() == recompute(s.graph)
    s.close()
    # a reloaded graph agrees
    s2 = KishuSession(store, chunk_bytes=1 << 9, device="cpu")
    assert s2.graph.total_meta_bytes() == recompute(s2.graph)
    s2.close()


def test_cli_fsck_and_recover(tmp_path, capsys):
    probe = probe_ops(lambda: SQLiteStore(str(tmp_path / "probe.db")))
    k = max(i for i, op in enumerate(probe.op_log)
            if op.startswith("put_meta:commit/"))
    uri = f"sqlite://{tmp_path}/cli.db"
    inner = SQLiteStore(str(tmp_path / "cli.db"))
    assert not crash_run(FaultInjectingStore(inner, crash_after=k))
    # fsck sees the raw crashed state (no implicit recovery)
    assert cli(["--store", uri, "fsck"]) == 2
    assert "unsealed" in capsys.readouterr().out
    assert cli(["--store", uri, "recover"]) == 0
    assert "replayed" in capsys.readouterr().out
    assert cli(["--store", uri, "fsck"]) == 0
    assert "OK" in capsys.readouterr().out


def test_cli_gc_reports_tombstones(tmp_path, capsys):
    uri = f"dir://{tmp_path}/cas"
    s = build_session(DirectoryStore(str(tmp_path / "cas")))
    s.init_state({"a": arange(64)})
    root = s.run("set_val", name="x", val=1)
    s.run("set_val", name="y", val=2)
    tip = s.head
    s.checkout(root)
    s.run("set_val", name="y", val=3)
    doomed = s.delete_branch(tip)
    s.close()
    assert cli(["--store", uri, "gc"]) == 0
    out = capsys.readouterr().out
    assert f"{len(doomed)} tombstones" in out
    assert cli(["--store", uri, "fsck"]) == 0


# ---------------------------------------------------------------------------
# multi-session safety (DESIGN.md §14): two writers, one store
# ---------------------------------------------------------------------------

LEASE_TTL = 0.15
A_WORKLOAD = [("ax", 1), ("ay", 2), ("az", 9)]
B_WORKLOAD = [("bx", 5), ("by", 6)]


def test_txn_ids_never_collide_across_engines(monkeypatch):
    """Journal IDs were time(ms)+counter, so two
    engines opened in the same millisecond journaled to the SAME
    ``txn/<id>`` doc and corrupted each other's WAL.  Freeze the clock and
    prove the per-engine nonce keeps the names distinct anyway."""
    monkeypatch.setattr(txn.time, "time", lambda: 1_700_000_000.0)
    store = MemoryStore()
    engines = [txn.TxnEngine(store) for _ in range(4)]
    names = set()
    for e in engines:
        e._ensure_open()
        names.add(e._open_name)
    assert len(names) == len(engines), sorted(names)


def test_stale_writer_publish_refused_and_reopen_continues():
    """The ``_seq`` race: a writer that loaded HEAD
    before another writer advanced it must not publish ``c{seq}`` over the
    newer commit.  The publish guard compares the durable seq, refuses,
    and the store keeps the newer writer's commit; reopening resumes from
    the durable state."""
    from repro_torch.core.txn import TxnError

    store = MemoryStore()
    a = build_session(store)
    a.init_state({"a": arange(64)})
    b = build_session(store)            # loads the same HEAD seq as a...
    cb = b.run("set_val", name="x", val=7)     # ...then advances it
    with pytest.raises(TxnError):
        a.run("set_val", name="x", val=9)      # stale seq: refused
    assert store.get_meta("HEAD")["head"] == cb
    b.close()
    assert txn.fsck(store).problems == 0, txn.fsck(store).details
    a2 = KishuSession(store, chunk_bytes=1 << 9, device="cpu")
    assert a2.graph.head == cb
    a2.close()


ATTACH = {"alice": "a", "bob": "b"}
WORKLOADS = {"alice": A_WORKLOAD, "bob": B_WORKLOAD}


@pytest.fixture(scope="module")
def two_writer_refs():
    """Bit-exact reference states for each writer's solo workload — tenant
    namespaces don't change values, so one clean run per writer suffices."""
    def solo(attach_name, workload):
        s = build_session(MemoryStore())
        states = [{}]
        s.init_state({attach_name: arange(32)})
        states.append(snapshot(s.ns))
        for name, val in workload:
            s.run("set_val", name=name, val=val)
            states.append(snapshot(s.ns))
        s.close()
        return states
    return {t: solo(ATTACH[t], WORKLOADS[t]) for t in ("alice", "bob")}


def _run_two_writers(inner, fault_store, victim="bob"):
    """Two tenant writers interleave commits on one shared store.  The
    *victim* commits (leased) through ``fault_store`` — typically a fault
    injector — and its injected death is absorbed wherever it lands; the
    *survivor* commits on the bare store and always finishes.  Returns
    (victim survived, survivor's final live state)."""
    from repro_torch.core.txn import TxnError

    survivor = "alice" if victim == "bob" else "bob"
    s_surv = build_session(inner, tenant=survivor)
    s_surv.init_state(
        {ATTACH[survivor]: arange(32)})
    alive = [True]
    box = [None]

    def v(fn):
        if not alive[0]:
            return
        try:
            fn()
        except InjectedCrash:
            alive[0] = False
        except TxnError as e:
            if isinstance(e.__cause__, InjectedCrash):
                alive[0] = False
            else:
                raise

    def open_victim():
        box[0] = build_session(fault_store, tenant=victim,
                               lease_ttl_s=LEASE_TTL)

    v(open_victim)
    v(lambda: box[0].init_state(
        {ATTACH[victim]: arange(32)}))
    w_surv, w_vic = WORKLOADS[survivor], WORKLOADS[victim]
    for i in range(max(len(w_surv), len(w_vic))):
        if i < len(w_surv):
            name, val = w_surv[i]
            s_surv.run("set_val", name=name, val=val)
        if i < len(w_vic):
            name, val = w_vic[i]
            v(lambda name=name, val=val:
              box[0].run("set_val", name=name, val=val))
    surv_final = snapshot(s_surv.ns)
    s_surv.close()
    if alive[0]:
        v(lambda: box[0].close())
    return alive[0], surv_final


def _assert_two_writer_recovers(inner, k, refs, victim="bob"):
    """After the victim's death at op ``k``: its lease is stolen only
    after a full observed TTL, it recovers to a committed prefix, the
    survivor's gc reaps nothing the victim references, and every
    namespace fscks clean."""
    import time as _t

    survivor = "alice" if victim == "bob" else "bob"
    had_lease = inner.get_meta(
        f"tenant/{victim}/lease/writer") is not None
    t0 = _t.monotonic()
    sv = KishuSession(inner, tenant=victim, chunk_bytes=1 << 9,
                      lease_ttl_s=LEASE_TTL, lease_wait_s=30.0, device="cpu")
    waited = _t.monotonic() - t0
    if had_lease:
        assert waited >= LEASE_TTL, \
            f"kill at op {k}: dead writer's lease stolen in {waited:.3f}s"
    if sv.graph.head is not None \
            and sv.graph.nodes[sv.graph.head].state_index:
        sv.loader.materialize_state(sv.tracked, sv.graph.head)
    vic_state = snapshot(sv.ns)
    assert vic_state in refs[victim], \
        f"kill at op {k}: {victim} recovered to no committed prefix"
    sv.close()

    ss = KishuSession(inner, tenant=survivor, chunk_bytes=1 << 9,
                      device="cpu")
    ss.gc()                # must not reap anything the victim references
    ss.close()
    sv2 = KishuSession(inner, tenant=victim, chunk_bytes=1 << 9,
                       device="cpu")
    if sv2.graph.head is not None \
            and sv2.graph.nodes[sv2.graph.head].state_index:
        sv2.loader.materialize_state(sv2.tracked, sv2.graph.head)
    assert snapshot(sv2.ns) == vic_state, \
        f"kill at op {k}: {survivor}'s gc corrupted {victim}'s state"
    sv2.close()
    for tid, rep in txn.fsck_all(inner).items():
        assert rep.problems == 0, (k, tid, rep.details)


@pytest.mark.parametrize("kind", ["memory", "dir", "shard"])
def test_two_writer_crash_sweep(kind, tmp_path, two_writer_refs):
    """Two tenant sessions interleave commits on one shared store
    (memory / dir / fabric shard ring); a simulated
    kill at EVERY one of the leased writer's store ops leaves the other
    writer bit-identical, the victim recoverable to a committed prefix
    behind a TTL-guarded lease steal, and cross-writer gc reaping
    nothing."""
    refs = two_writer_refs
    inner = make_inner(kind, tmp_path, "probe2w")
    probe = FaultInjectingStore(inner)
    survived, surv_final = _run_two_writers(inner, probe)
    assert survived and surv_final == refs["alice"][-1]
    total = probe.ops
    assert total > 10, "sweep would not cover the victim's pipeline"
    kills = 0
    for k in range(total):
        inner = make_inner(kind, tmp_path, f"2w{k}")
        survived, surv_final = _run_two_writers(
            inner, FaultInjectingStore(inner, crash_after=k))
        assert surv_final == refs["alice"][-1], \
            f"kill at bob op {k} disturbed writer alice"
        if survived:
            # lease renew writes are timing-dependent with a tiny TTL, so
            # the crash run can finish in fewer ops than the probe did —
            # a clean finish must still leave every namespace fsck-clean
            for tid, rep in txn.fsck_all(inner).items():
                assert rep.problems == 0, (k, tid, rep.details)
            continue
        kills += 1
        _assert_two_writer_recovers(inner, k, refs)
    assert kills >= total // 2, \
        f"only {kills}/{total} kill points actually fired"


@pytest.mark.parametrize("kind", ["dir", "shard"])
def test_kill_of_either_writer(kind, tmp_path, two_writer_refs):
    """The sweep above always kills the second writer; either may die.
    Swap the roles — the FIRST writer (alice) dies at
    each mid-publish op and at its last chunk put — and assert the same
    recovery story with bob as the survivor."""
    refs = two_writer_refs
    inner = make_inner(kind, tmp_path, "probeA")
    probe = FaultInjectingStore(inner)
    survived, surv_final = _run_two_writers(inner, probe, victim="alice")
    assert survived and surv_final == refs["bob"][-1]
    kill_points = [i for i, op in enumerate(probe.op_log)
                   if op.startswith("put_meta:tenant/alice/commit/")]
    kill_points.append(max(i for i, op in enumerate(probe.op_log)
                           if op.startswith("put_chunk:")))
    assert kill_points, "no mid-publish ops found in alice's trace"
    kills = 0
    for k in kill_points:
        inner = make_inner(kind, tmp_path, f"2wA{k}")
        survived, surv_final = _run_two_writers(
            inner, FaultInjectingStore(inner, crash_after=k),
            victim="alice")
        assert surv_final == refs["bob"][-1], \
            f"kill at alice op {k} disturbed writer bob"
        if survived:
            continue             # renew-timing drift: op k fell past the end
        kills += 1
        _assert_two_writer_recovers(inner, k, refs, victim="alice")
    assert kills >= 1, "no kill point actually fired"
