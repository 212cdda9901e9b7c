"""kishu CLI — inspect and maintain a checkpoint store from the shell.

    python -m repro_torch.launch.kishu_cli --store dir:///ckpt log
    python -m repro_torch.launch.kishu_cli --store ... show c00042
    python -m repro_torch.launch.kishu_cli --store ... diff c00012 c00042
    python -m repro_torch.launch.kishu_cli --store ... plan c00042 \
        [--from c00012]
    python -m repro_torch.launch.kishu_cli --store ... stats
    python -m repro_torch.launch.kishu_cli --store ... verify [--commit cXXXXX]
    python -m repro_torch.launch.kishu_cli --store ... gc
    python -m repro_torch.launch.kishu_cli --store ... fsck
    python -m repro_torch.launch.kishu_cli --store ... recover
    python -m repro_torch.launch.kishu_cli --store ... lease [--release NAME]
    python -m repro_torch.launch.kishu_cli --store ... tenants
    python -m repro_torch.launch.kishu_cli --store ... kishud \
        start|stop|status --socket /tmp/kishud.sock [--detach] [--device cpu]
    python -m repro_torch.launch.kishu_cli --store fabric://... topology
    python -m repro_torch.launch.kishu_cli --store fabric://... scrub \
        [--repair]
    python -m repro_torch.launch.kishu_cli --store fabric://... rebalance

Every subcommand shares ``open_store``, so any store URI works anywhere —
including ``?codec=`` suffixes and ``fabric://`` compositions.

``verify`` checks that every chunk referenced by a state's manifests is
present (``--deep``: fetched in bulk through the parallel engine and
content-address-checked) — the operator's answer to "can I still restore
this run?" after storage incidents (missing chunks are reported per
co-variable; they will restore via fallback recomputation as long as the
command registry is available).  The fleet verbs ``topology`` / ``scrub`` /
``rebalance`` operate on the storage fabric itself: print the composition
tree, find-and-heal replica-missing / misplaced / corrupt chunks, and move
chunks to their ring homes after a topology edit.

``fsck`` / ``recover`` are the transaction-engine verbs (DESIGN.md §13):
``fsck`` audits the *raw, un-recovered* store — unsealed commit journals,
torn HEAD, missing parents/chunks, dangling chunks — and ``recover``
replays or rolls back unsealed transactions exactly as a session open
does implicitly.  The other subcommands never touch the journal: a CLI
process doesn't own the store the way a session does, and recovering
under a live session would roll back its in-flight transaction.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

from repro_torch.core import fabric, parallel, txn
from repro_torch.core.chunkstore import (NamespacedStore, chunk_key,
                                         open_store, tenant_ids)
from repro_torch.core.graph import REFS_DOC, CheckpointGraph, parse_key
from repro_torch.core.lease import LEASE_PREFIX, lease_status


def cmd_log(graph: CheckpointGraph, args) -> int:
    for e in graph.log(limit=args.limit):
        mark = "*" if e["head"] else " "
        exec_s = f"{e['exec_s']:7.3f}s" if e.get("exec_s") is not None \
            else "      -"
        print(f"{mark} {e['commit']}  <- {e['parent'] or '-':8s} "
              f"{e['command'] or '':14s} upd={e['updated']:3d} "
              f"del={e['deleted']:2d} exec={exec_s}  {e['message']}")
    return 0


def cmd_plan(store, graph: CheckpointGraph, args) -> int:
    """``kishu plan <commit>``: price a checkout (fetch vs replay per
    co-variable) without executing it.  The CLI has no live namespace, so
    chunk-patch candidates don't apply, and no command registry, so
    replayability relies on the per-commit ``replay_safe`` flag."""
    from repro_torch.core.checkout import StateLoader
    from repro_torch.core.planner import CheckoutPlanner, format_plan
    if args.commit not in graph.nodes:
        print(f"no such commit: {args.commit}", file=sys.stderr)
        return 1
    cur = args.from_ or graph.head
    if cur not in graph.nodes:
        print(f"no such commit: {cur}", file=sys.stderr)
        return 1
    loader = StateLoader(graph, store)
    planner = CheckoutPlanner(graph, loader, mode=args.mode)
    priced = planner.price_checkout(cur, args.commit)
    for line in format_plan(priced):
        print(line)
    return 0


def cmd_show(graph: CheckpointGraph, args) -> int:
    node = graph.nodes.get(args.commit)
    if node is None:
        print(f"no such commit: {args.commit}", file=sys.stderr)
        return 1
    print(f"commit  {node.commit_id} (parent {node.parent}, "
          f"depth {node.depth})")
    print(f"command {node.command}")
    print(f"message {node.message!r}")
    print(f"state   {len(node.state_index)} co-variables")
    moved = node.stats.get("bytes_serialized")
    logical = node.stats.get("bytes_logical")
    if moved is not None and logical:
        print(f"delta   {moved:,d} B moved of {logical:,d} B logical "
              f"({moved / logical:.1%})")
    for ks, man in sorted(node.manifests.items()):
        names = "+".join(parse_key(ks))
        if man.get("unserializable"):
            print(f"  upd {names:42s} UNSERIALIZABLE (fallback recompute)")
        else:
            b = man["base"]
            print(f"  upd {names:42s} {b['nbytes']:>12,d} B "
                  f"{len(b['chunks'])} chunks")
    for ks in node.deleted:
        print(f"  del {'+'.join(parse_key(ks))}")
    return 0


def cmd_diff(graph: CheckpointGraph, args) -> int:
    for c in (args.a, args.b):
        if c not in graph.nodes:
            print(f"no such commit: {c}", file=sys.stderr)
            return 1
    plan = graph.diff(args.a, args.b)
    print(f"{args.a} -> {args.b}: {plan.n_diverged} diverged, "
          f"{len(plan.to_delete)} only-in-{args.a}, "
          f"{len(plan.identical)} identical")
    for key, ver in sorted(plan.to_load.items()):
        print(f"  ~ {'+'.join(key):42s} @ {ver}")
    for key in plan.to_delete:
        print(f"  - {'+'.join(key)}")
    return 0


def cmd_stats_metrics(store, args) -> int:
    """``stats --metrics``: Prometheus text exposition — live store gauges
    (re-read through an InstrumentedStore, so the graph load itself is
    timed) merged with every persisted session snapshot (``obs/trace/*``,
    written by traced sessions on close)."""
    from repro_torch.obs import (TRACE_META_PREFIX, InstrumentedStore,
                                 MetricsRegistry, render)
    reg = MetricsRegistry()
    store = InstrumentedStore(store, reg)
    graph = CheckpointGraph(store, recover=False)
    reg.gauge("kishu_graph_commits").set(len(graph.nodes))
    reg.gauge("kishu_graph_meta_bytes").set(graph.total_meta_bytes())
    reg.gauge("kishu_store_chunks").set(store.n_chunks())
    reg.gauge("kishu_store_chunk_bytes").set(store.chunk_bytes_total())
    moved = sum(n.stats.get("bytes_serialized", 0)
                for n in graph.nodes.values())
    logical = sum(n.stats.get("bytes_logical", 0)
                  for n in graph.nodes.values())
    reg.gauge("kishu_ckpt_bytes_moved").set(moved)
    reg.gauge("kishu_ckpt_bytes_logical").set(logical)
    regs = [reg]
    for name in sorted(store.list_meta(TRACE_META_PREFIX)):
        doc = store.get_meta(name) or {}
        snap = doc.get("metrics")
        if snap:
            sreg = MetricsRegistry.from_doc(snap)
            sreg.const_labels.setdefault(
                "sid", str(doc.get("sid", name.rsplit("/", 1)[-1])))
            regs.append(sreg)
    sys.stdout.write(render(regs))
    return 0


def cmd_trace(store, args) -> int:
    """``kishu trace``: merge persisted span dumps into one Chrome
    trace-event JSON (Perfetto / chrome://tracing loadable); one pid per
    recorded session."""
    import json

    from repro_torch.obs import (TRACE_META_PREFIX, chrome_trace,
                                 spans_from_doc)
    names = sorted(store.list_meta(TRACE_META_PREFIX))
    events, n_sessions = [], 0
    for name in names:
        doc = store.get_meta(name) or {}
        spans = spans_from_doc(doc.get("spans", []))
        if not spans:
            continue
        n_sessions += 1
        events.extend(chrome_trace(spans, pid=n_sessions)["traceEvents"])
    if not events:
        print("trace: no persisted spans — run a session with "
              "KISHU_TRACE=1 (or trace=True) and close it first",
              file=sys.stderr)
        return 1
    text = json.dumps({"traceEvents": events, "displayTimeUnit": "ms"},
                      indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"trace: {len(events)} events from {n_sessions} session(s) "
              f"-> {args.out}", file=sys.stderr)
    else:
        print(text)
    return 0


def cmd_stats(store, graph: CheckpointGraph, args) -> int:
    print(f"commits      {len(graph.nodes)}")
    print(f"head         {graph.head}")
    print(f"chunks       {store.n_chunks()}")
    print(f"chunk bytes  {store.chunk_bytes_total():,d}")
    print(f"graph bytes  {graph.total_meta_bytes():,d}")
    # delta-pipeline accounting: bytes actually moved at checkpoint time
    # vs the logical size of everything those checkpoints covered
    moved = sum(n.stats.get("bytes_serialized", 0)
                for n in graph.nodes.values())
    logical = sum(n.stats.get("bytes_logical", 0)
                  for n in graph.nodes.values())
    print(f"ckpt moved   {moved:,d}")
    print(f"ckpt logical {logical:,d}")
    if logical:
        print(f"delta ratio  {moved / logical:.1%}")
    # device-codec accounting: PCIe traffic on the write path (device→host
    # after on-device compression) and how often the codec engaged
    d2h = sum(n.stats.get("bytes_dev2host", 0) for n in graph.nodes.values())
    enc = sum(n.stats.get("chunks_encoded", 0) for n in graph.nodes.values())
    skip = sum(n.stats.get("chunks_codec_skipped", 0)
               for n in graph.nodes.values())
    if d2h or enc or skip:
        print(f"dev->host    {d2h:,d}")
        print(f"dev encoded  {enc}")
        print(f"codec skips  {skip}")
    return 0


def cmd_verify(store, graph: CheckpointGraph, args) -> int:
    commits = [args.commit] if args.commit else sorted(graph.nodes)
    # plan every referenced chunk up front, then resolve presence (and, with
    # --deep, content) in bulk: batched metadata / scatter-gather fetches
    # through the parallel engine instead of one store round-trip per chunk
    refs = []                     # (cid, names, chunk_key, logical_n)
    for cid in commits:
        node = graph.nodes.get(cid)
        if node is None:
            print(f"no such commit: {cid}", file=sys.stderr)
            return 1
        for ks, man in node.manifests.items():
            if man.get("unserializable"):
                continue
            names = "+".join(parse_key(ks))
            for c in man["base"]["chunks"]:
                refs.append((cid, names, c["key"], int(c["n"])))
    uniq = list(dict.fromkeys(r[2] for r in refs))
    if args.deep:
        # streamed in slabs: bulk scatter-gather fetches without ever
        # holding more than a window of chunks in memory (a deep verify
        # of a multi-GB CAS must not materialize the whole store)
        want_n = {r[2]: r[3] for r in refs}
        present, corrupt = set(), set()
        for got in parallel.prefetch_map(
                lambda slab: store.get_chunks(slab, missing_ok=True),
                parallel.iter_slabs(
                    uniq, max(getattr(store, "min_slab", 1), 32))):
            for k, d in got.items():
                present.add(k)
                if chunk_key(d) != k or len(d) != want_n[k]:
                    corrupt.add(k)
    else:
        # chunk_sizes is metadata-only and backend-batched (one SQL pass,
        # pooled stats, sharded scatter) — presence without moving data
        present = set(store.chunk_sizes(uniq))
        corrupt = set()
    bad = 0
    for cid, names, key, _ in refs:
        if key not in present:
            print(f"MISSING {cid} {names} chunk {key}")
            bad += 1
        elif key in corrupt:
            print(f"CORRUPT {cid} {names} chunk {key}")
            bad += 1
    print(f"verify: {'OK' if bad == 0 else f'{bad} problems'} "
          f"({len(commits)} commits)")
    return 0 if bad == 0 else 2


def cmd_gc(store, graph: CheckpointGraph, args) -> int:
    # session-less GC: the mark set is shared with KishuSession.gc(); chunk
    # enumeration and the delete sweep are backend-native batched ops
    # (works on sqlite:// stores and whole fabrics alike).  Chunks are
    # shared across tenant namespaces, so the mark set unions every
    # namespace's references and any unsealed journal's chunks.
    live = graph.live_chunk_keys() | txn.global_live_chunks(store)
    dead = [k for k in store.list_chunk_keys() if k not in live]
    if not args.dry_run:
        store.delete_chunks(dead)
    # delete_branch tombstones are dead weight once the graph has loaded
    # without them — purge, or every future _load re-reads them forever
    # (same helper as KishuSession.gc, so the two sweeps cannot disagree)
    purged = txn.purge_tombstones(store, graph.nodes, dry_run=args.dry_run)
    verb = "would drop" if args.dry_run else "dropped"
    print(f"gc: {verb} {len(dead)} chunks ({len(live)} live), "
          f"{purged} tombstones")
    return 0


def cmd_fsck(store, args) -> int:
    rep = txn.fsck(store)
    for line in rep.details[:args.limit]:
        print(f"  {line}")
    if len(rep.details) > args.limit:
        print(f"  ... {len(rep.details) - args.limit} more")
    print(f"fsck: {'OK' if rep.clean else f'{rep.problems} problems'} "
          f"({rep.commits} commits, {rep.unsealed_txns} unsealed txns, "
          f"{rep.torn_head} torn HEAD, {rep.missing_parents} missing "
          f"parents, {rep.missing_chunks} missing chunks, "
          f"{rep.dangling_chunks} dangling chunks, {rep.tombstones} "
          f"tombstones)")
    if rep.unsealed_txns:
        print("hint: `recover` replays or rolls back unsealed txns")
    if rep.dangling_chunks and not rep.unsealed_txns:
        # expected between delete_branch and gc; gc is the reclaimer
        print("hint: dangling chunks are unreferenced data — `gc` "
              "reclaims them")
    return 0 if rep.clean else 2


def cmd_recover(store, args) -> int:
    out = txn.recover(store)
    print(f"recover: {out['replayed']} txns replayed "
          f"({out['commits_published']} commits published), "
          f"{out['rolled_back']} rolled back, "
          f"{out['chunks_dropped']} orphan chunks dropped")
    return 0


def cmd_lease(store, args) -> int:
    """Show writer leases (this namespace); ``--release NAME`` drops one —
    an operator override for a provably dead holder.  Session code never
    needs it: contenders steal automatically after an observed TTL."""
    if args.release:
        name = LEASE_PREFIX + args.release
        if store.get_meta(name) is None:
            print(f"no such lease: {args.release}", file=sys.stderr)
            return 1
        store.delete_meta(name)
        print(f"lease {args.release} released")
        return 0
    leases = lease_status(store)
    if not leases:
        print("no leases held")
        return 0
    for rec in leases:
        print(f"{rec['name']:8s} owner={rec['owner']} "
              f"token={rec['token']} ttl={rec['ttl_s']}s "
              f"age~{rec['age_hint_s']}s pid={rec['pid']} "
              f"host={rec['host']}")
    return 0


def cmd_tenants(store, args) -> int:
    """Per-tenant usage on a shared store: commits, referenced bytes (from
    each namespace's refcount ledger), and the namespace's writer lease."""
    rows = [("", store)] + [(tid, NamespacedStore(store, tid))
                            for tid in tenant_ids(store)]
    print(f"{'tenant':16s} {'commits':>7s} {'ref_bytes':>12s} "
          f"{'head':8s} lease")
    for tid, view in rows:
        n_commits = sum(1 for name in view.list_meta("commit/")
                        if not (view.get_meta(name) or {}).get("deleted"))
        if tid == "" and n_commits == 0:
            continue                     # bare root namespace: skip noise
        refs = (view.get_meta(REFS_DOC) or {}).get("counts", {})
        ref_bytes = sum(cn[1] for cn in refs.values() if cn[0] > 0)
        head = (view.get_meta("HEAD") or {}).get("head") or "-"
        leases = lease_status(view)
        owner = leases[0]["owner"] if leases else "-"
        print(f"{tid or '<root>':16s} {n_commits:7d} {ref_bytes:12,d} "
              f"{head:8s} {owner}")
    return 0


def cmd_kishud(store_uri: str, args) -> int:
    from repro_torch.launch import kishud as kishud_mod
    device = ["--device", args.device] if args.device else []
    if args.action == "start":
        if args.detach:
            import subprocess
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.kishud",
                 "--store", store_uri, "--socket", args.socket,
                 "--workers", str(args.workers),
                 "--lease-ttl", str(args.lease_ttl)] + device,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                start_new_session=True)
            # wait for the control socket to answer before declaring success
            import time as _time
            for _ in range(100):
                try:
                    if kishud_mod.control(args.socket, "ping").get("ok"):
                        print(f"kishud: started (pid {proc.pid}, "
                              f"socket {args.socket})")
                        return 0
                except OSError:
                    _time.sleep(0.05)
            print("kishud: did not come up", file=sys.stderr)
            return 1
        return kishud_mod.main(["--store", store_uri,
                                "--socket", args.socket,
                                "--workers", str(args.workers),
                                "--lease-ttl", str(args.lease_ttl)]
                               + device)
    try:
        resp = kishud_mod.control(args.socket, args.action)
    except OSError as e:
        print(f"kishud: no daemon on {args.socket} ({e})", file=sys.stderr)
        return 1
    if args.action == "metrics" and resp.get("ok"):
        sys.stdout.write(resp.get("metrics", ""))
        return 0
    print(resp if args.action != "status"
          else "\n".join(f"{k:18s} {v}" for k, v in resp.items()))
    return 0 if resp.get("ok") else 1


def cmd_topology(store, args) -> int:
    print("\n".join(fabric.topology_lines(store)))
    return 0


def cmd_scrub(store, args) -> int:
    rep = fabric.scrub(store, repair=args.repair, deep=args.deep)
    for line in rep.details[:args.limit]:
        print(f"  {line}")
    if len(rep.details) > args.limit:
        print(f"  ... {len(rep.details) - args.limit} more")
    print(f"scrub: {rep.problems} problems "
          f"({rep.replica_missing} replica-missing, {rep.misplaced} "
          f"misplaced, {rep.corrupt} corrupt) across {rep.chunks_checked} "
          f"chunks; {rep.repaired} repaired, {rep.remaining} remaining")
    return 0 if rep.remaining == 0 else 2


def cmd_rebalance(store, args) -> int:
    out = fabric.rebalance(store)
    print(f"rebalance: moved {out['chunks_moved']} of "
          f"{out['chunks_checked']} chunks to their ring homes")
    return 0


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="kishu")
    ap.add_argument("--store", required=True,
                    help="memory:// | dir:///path | sqlite:///db")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("log")
    p.add_argument("--limit", type=int, default=0)
    p = sub.add_parser("show")
    p.add_argument("commit")
    p = sub.add_parser("diff")
    p.add_argument("a")
    p.add_argument("b")
    p = sub.add_parser("plan")
    p.add_argument("commit")
    p.add_argument("--from", dest="from_", metavar="COMMIT",
                   help="plan from this commit instead of HEAD")
    p.add_argument("--mode", default="auto",
                   choices=["auto", "fetch", "replay"])
    p = sub.add_parser("stats")
    p.add_argument("--metrics", action="store_true",
                   help="Prometheus text exposition instead of the "
                        "human-readable summary")
    p = sub.add_parser("trace")
    p.add_argument("--out", help="write Chrome trace JSON here instead of "
                                 "stdout (load in Perfetto)")
    p = sub.add_parser("verify")
    p.add_argument("--commit")
    p.add_argument("--deep", action="store_true")
    p = sub.add_parser("gc")
    p.add_argument("--dry-run", action="store_true")
    p = sub.add_parser("fsck")
    p.add_argument("--limit", type=int, default=20,
                   help="max per-problem detail lines to print")
    sub.add_parser("recover")
    p = sub.add_parser("lease")
    p.add_argument("--release", metavar="NAME",
                   help="force-drop a lease (operator override)")
    sub.add_parser("tenants")
    p = sub.add_parser("kishud")
    p.add_argument("action", choices=["start", "stop", "status", "ping",
                                      "metrics"])
    p.add_argument("--socket", default="/tmp/kishud.sock")
    p.add_argument("--detach", action="store_true",
                   help="start: run the daemon in its own process")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--lease-ttl", type=float, default=10.0)
    p.add_argument("--device", default=None,
                   help="start: where the tenants' tensors live "
                        "(default cuda)")
    sub.add_parser("topology")
    p = sub.add_parser("scrub")
    p.add_argument("--repair", action="store_true")
    p.add_argument("--deep", action="store_true")
    p.add_argument("--limit", type=int, default=20,
                   help="max per-chunk problem lines to print")
    sub.add_parser("rebalance")
    args = ap.parse_args(argv)

    # kishud verbs talk to the daemon (or spawn it) — the daemon owns the
    # store; opening it here too would be a second uncoordinated opener
    if args.cmd == "kishud":
        return cmd_kishud(args.store, args)
    store = open_store(args.store)
    # store-level verbs run BEFORE any graph construction: fsck must see
    # the raw, un-recovered state, and recover applies it explicitly
    if args.cmd == "fsck":
        return cmd_fsck(store, args)
    if args.cmd == "recover":
        return cmd_recover(store, args)
    if args.cmd == "lease":
        return cmd_lease(store, args)
    if args.cmd == "tenants":
        return cmd_tenants(store, args)
    # observability verbs: trace reads persisted span dumps (no graph);
    # stats --metrics builds its own instrumented graph view
    if args.cmd == "trace":
        return cmd_trace(store, args)
    if args.cmd == "stats" and args.metrics:
        return cmd_stats_metrics(store, args)
    # fleet verbs operate on the store itself — no graph required
    if args.cmd == "topology":
        return cmd_topology(store, args)
    if args.cmd == "scrub":
        return cmd_scrub(store, args)
    if args.cmd == "rebalance":
        return cmd_rebalance(store, args)
    # CLI graph verbs are read-only on the commit journal: recovery here
    # could roll back a LIVE session's in-flight transaction (this process
    # doesn't own the store the way a session does).  Recovery stays
    # explicit (`recover`) or implicit on session open.
    graph = CheckpointGraph(store, recover=False)
    if args.cmd == "log":
        return cmd_log(graph, args)
    if args.cmd == "show":
        return cmd_show(graph, args)
    if args.cmd == "diff":
        return cmd_diff(graph, args)
    if args.cmd == "plan":
        return cmd_plan(store, graph, args)
    if args.cmd == "stats":
        return cmd_stats(store, graph, args)
    if args.cmd == "verify":
        return cmd_verify(store, graph, args)
    if args.cmd == "gc":
        return cmd_gc(store, graph, args)
    return 1


if __name__ == "__main__":
    sys.exit(main())
