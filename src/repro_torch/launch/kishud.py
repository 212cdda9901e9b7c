"""kishud — a multi-tenant checkpoint daemon over one shared fabric
(DESIGN.md §14).

One long-running process multiplexes N notebook sessions over a single
content-addressed store:

  * each tenant gets its own ``tenant/<id>/`` metadata namespace (graph,
    branches, txn journal) and its own writer lease, while chunks are
    shared and deduped store-wide;
  * one :class:`~repro_torch.core.chunkstore.ChunkCache` is shared across every
    session — a tenant checking out data another tenant just wrote is
    served from memory;
  * every storage operation passes through an **admission queue** with two
    classes: *interactive* work (cell commits, checkouts — a human is
    waiting) always runs before *background* work (gc, scrub, rebalance),
    so fleet maintenance can never queue ahead of a notebook user.

The tenants' sessions keep their tensors on the daemon's ``device``: the
card unless the caller names the CPU (``device="cpu"``, ``--device cpu``).

Run it embedded::

    d = Kishud("dir:///ckpt", workers=4)           # device="cuda"
    alice = d.session("alice")
    alice.register("train", train)
    alice.run("train", steps=10)

or as a daemon with a unix-socket control plane::

    python -m repro_torch.launch.kishud --store dir:///ckpt \
        --socket /tmp/kishud.sock
    python -m repro_torch.launch.kishu_cli --store ... kishud status \
        --socket ...

The control protocol is JSON-lines over a unix socket: one request object
per line (``{"cmd": "ping" | "status" | "tenants" | "metrics" |
"stop"}``), one
response object per line.
"""
from __future__ import annotations

import argparse
import heapq
import json
import os
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from repro_torch.core import fabric
from repro_torch.core.chunkstore import (ChunkCache, ChunkStore,
                                         namespace_views, open_store)
from repro_torch.core.lease import lease_status
from repro_torch.core.session import KishuSession, resolve_device

INTERACTIVE = 0          # a human is waiting: cell run, checkout
BACKGROUND = 1           # fleet hygiene: gc, scrub, rebalance


class _Job:
    __slots__ = ("fn", "priority", "enq_mono", "done", "result", "error")

    def __init__(self, fn: Callable[[], Any], priority: int):
        self.fn = fn
        self.priority = priority
        self.enq_mono = time.monotonic()
        self.done = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None


class AdmissionQueue:
    """Two-class priority admission: a pool of workers drains a heap
    ordered by ``(priority, arrival)``, so *every* queued interactive job
    is admitted before *any* queued background job, and jobs within a
    class run in arrival order.  A long-running background job already on
    a worker is never preempted — admission control, not scheduling — but
    with ``workers > 1`` an interactive job still finds a free worker
    unless every one is busy."""

    def __init__(self, workers: int = 2):
        self._heap: List[tuple] = []     # (priority, seqno, job)
        self._seq = 0
        self._cv = threading.Condition()
        self._closing = False
        self.served = [0, 0]             # per class
        self.wait_s = [0.0, 0.0]         # queue time per class
        self._workers = [threading.Thread(target=self._drain, daemon=True)
                         for _ in range(max(1, workers))]
        for w in self._workers:
            w.start()

    def _drain(self) -> None:
        while True:
            with self._cv:
                self._cv.wait_for(lambda: self._heap or self._closing)
                if not self._heap:
                    return               # closing, drained
                _, _, job = heapq.heappop(self._heap)
                self.wait_s[job.priority] += time.monotonic() - job.enq_mono
                self.served[job.priority] += 1
            try:
                job.result = job.fn()
            except BaseException as e:  # noqa: BLE001 — delivered to caller
                job.error = e
            finally:
                job.done.set()

    def submit(self, fn: Callable[[], Any],
               priority: int = INTERACTIVE) -> _Job:
        job = _Job(fn, priority)
        with self._cv:
            if self._closing:
                raise RuntimeError("admission queue closed")
            heapq.heappush(self._heap, (priority, self._seq, job))
            self._seq += 1
            self._cv.notify()
        return job

    def run(self, fn: Callable[[], Any],
            priority: int = INTERACTIVE) -> Any:
        """Submit and wait; re-raises the job's exception in the caller."""
        job = self.submit(fn, priority)
        job.done.wait()
        if job.error is not None:
            raise job.error
        return job.result

    def stats(self) -> dict:
        with self._cv:
            depth = [0, 0]
            for prio, _, _ in self._heap:
                depth[prio] += 1
        return {"queued_interactive": depth[INTERACTIVE],
                "queued_background": depth[BACKGROUND],
                "served_interactive": self.served[INTERACTIVE],
                "served_background": self.served[BACKGROUND],
                "wait_s_interactive": round(self.wait_s[INTERACTIVE], 6),
                "wait_s_background": round(self.wait_s[BACKGROUND], 6)}

    def close(self) -> None:
        with self._cv:
            self._closing = True
            self._cv.notify_all()
        for w in self._workers:
            w.join(timeout=5)


class TenantSession:
    """A tenant's handle on the daemon: the same surface as ``KishuSession``
    (register / init_state / run / checkout / gc / ...), with every storage
    operation admitted through the daemon's queue — run and checkout as
    *interactive*, gc as *background* — and serialized per tenant (one
    session object is not thread-safe; two tenants still run in parallel
    on different workers)."""

    def __init__(self, daemon: "Kishud", session: KishuSession):
        self._daemon = daemon
        self.session = session
        self._lock = threading.Lock()

    def _admit(self, priority: int, fn: Callable[[], Any]) -> Any:
        def locked():
            with self._lock:
                return fn()
        return self._daemon.queue.run(locked, priority)

    # ---- interactive: a human is waiting ----
    def run(self, command: str, _message: str = "", **args) -> str:
        return self._admit(INTERACTIVE,
                           lambda: self.session.run(command, _message,
                                                    **args))

    def checkout(self, commit_id: str):
        return self._admit(INTERACTIVE,
                           lambda: self.session.checkout(commit_id))

    def init_state(self, tree, message: str = "attach") -> str:
        return self._admit(INTERACTIVE,
                           lambda: self.session.init_state(tree, message))

    # ---- background: fleet hygiene ----
    def gc(self) -> dict:
        return self._admit(BACKGROUND, self.session.gc)

    def delete_branch(self, tip: str):
        return self._admit(BACKGROUND,
                           lambda: self.session.delete_branch(tip))

    # ---- local (no storage round-trips worth queueing) ----
    def register(self, name: str, fn: Callable) -> None:
        self.session.register(name, fn)

    def log(self, limit: int = 0):
        return self.session.log(limit)

    def storage_stats(self) -> dict:
        return self.session.storage_stats()

    @property
    def ns(self):
        return self.session.ns

    @property
    def head(self) -> str:
        return self.session.head

    @property
    def tenant(self) -> Optional[str]:
        return self.session.tenant

    def close(self) -> None:
        self._daemon._forget(self)
        with self._lock:
            self.session.close()


class Kishud:
    """The daemon: one shared store + cache + admission queue, N tenant
    sessions.  Sessions opened through :meth:`session` hold their
    namespace's writer lease (default ttl 10 s) — a kishud crash leaves
    leases to expire, so a restarted daemon (or a direct session) can take
    over after observing a quiet TTL.  Every tenant session runs on
    ``device``."""

    def __init__(self, store, *, workers: int = 4,
                 cache_bytes: Optional[int] = None,
                 lease_ttl_s: Optional[float] = 10.0,
                 device: Union[str, torch.device, None] = None,
                 **session_kw):
        self.device = resolve_device(device)
        self.store: ChunkStore = (open_store(store) if isinstance(store, str)
                                  else store)
        self.cache = ChunkCache(cache_bytes)
        self.queue = AdmissionQueue(workers)
        self.lease_ttl_s = lease_ttl_s
        self.session_kw = session_kw
        self.started_mono = time.monotonic()
        self._sessions: Dict[int, TenantSession] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    # sessions
    # ------------------------------------------------------------------
    def session(self, tenant: str, *, lease_wait_s: float = 0.0,
                **kw) -> TenantSession:
        """Open (and lease) a tenant session multiplexed over the shared
        store.  ``lease_wait_s`` bounds how long to wait for a previous
        holder's lease to be observed expired (pass ≥ the TTL to take over
        from a crashed predecessor)."""
        merged = {**self.session_kw, **kw}
        sess = KishuSession(self.store, tenant=tenant,
                            lease_ttl_s=self.lease_ttl_s,
                            lease_wait_s=lease_wait_s,
                            chunk_cache=self.cache, device=self.device,
                            **merged)
        ts = TenantSession(self, sess)
        with self._lock:
            self._sessions[id(ts)] = ts
        return ts

    def _forget(self, ts: TenantSession) -> None:
        with self._lock:
            self._sessions.pop(id(ts), None)

    # ------------------------------------------------------------------
    # fleet hygiene (background class)
    # ------------------------------------------------------------------
    def scrub(self, *, repair: bool = False) -> Any:
        return self.queue.run(
            lambda: fabric.scrub(self.store, repair=repair), BACKGROUND)

    def rebalance(self) -> dict:
        return self.queue.run(
            lambda: fabric.rebalance(self.store), BACKGROUND)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def status(self) -> dict:
        with self._lock:
            live = list(self._sessions.values())
        return {"pid": os.getpid(),
                "uptime_s": round(time.monotonic() - self.started_mono, 3),
                "n_sessions": len(live),
                "tenants": sorted({ts.tenant for ts in live
                                   if ts.tenant is not None}),
                "cache_bytes": self.cache.bytes_used,
                "cache_hits": self.cache.hits,
                "cache_misses": self.cache.misses,
                "queue": self.queue.stats(),
                "store_chunks": self.store.n_chunks(),
                "store_bytes": self.store.chunk_bytes_total()}

    def metrics_text(self) -> str:
        """One Prometheus exposition covering the daemon (uptime, shared
        cache, admission queue, store totals) and every live tenant
        session's registry (store-op histograms, pipeline counters) —
        sessions carry a ``tenant`` const-label, so one scrape
        disambiguates the whole fleet."""
        from repro_torch.obs import MetricsRegistry, render

        reg = MetricsRegistry()
        st = self.status()
        reg.gauge("kishud_uptime_seconds").set(st["uptime_s"])
        reg.gauge("kishud_sessions").set(st["n_sessions"])
        reg.gauge("kishud_cache_bytes").set(st["cache_bytes"])
        reg.gauge("kishud_cache_hits_total").set(st["cache_hits"])
        reg.gauge("kishud_cache_misses_total").set(st["cache_misses"])
        reg.gauge("kishud_store_chunks").set(st["store_chunks"])
        reg.gauge("kishud_store_bytes").set(st["store_bytes"])
        for k, v in st["queue"].items():
            reg.gauge(f"kishud_queue_{k}").set(float(v))
        with self._lock:
            live = list(self._sessions.values())
        return render([reg] + [ts.session.obs.registry for ts in live])

    def tenants(self) -> List[dict]:
        """Per-tenant usage as seen by the live sessions, plus every lease
        visible on the store (sessions opened elsewhere included)."""
        with self._lock:
            live = list(self._sessions.values())
        out = []
        for ts in live:
            st = ts.storage_stats()
            out.append({"tenant": st["tenant"], "head": ts.head,
                        "n_commits": st["n_commits"],
                        "ref_bytes": st["tenant_ref_bytes"],
                        "quota_bytes": st["quota_bytes"],
                        "lease_owner": st.get("lease_owner")})
        return out

    def close(self) -> None:
        with self._lock:
            live = list(self._sessions.values())
            self._sessions.clear()
        for ts in live:
            with ts._lock:
                ts.session.close()
        self.queue.close()


# ---------------------------------------------------------------------------
# unix-socket control plane
# ---------------------------------------------------------------------------

class KishudServer:
    """JSON-lines control server for a :class:`Kishud` on a unix socket.
    One request per line; ``stop`` answers then shuts the daemon down."""

    def __init__(self, daemon: Kishud, socket_path: str):
        self.daemon = daemon
        self.socket_path = socket_path
        self.stopped = threading.Event()
        try:
            os.unlink(socket_path)
        except FileNotFoundError:
            pass
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(socket_path)
        self._sock.listen(8)
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _handle(self, req: dict) -> dict:
        cmd = req.get("cmd")
        if cmd == "ping":
            return {"ok": True, "pong": True, "pid": os.getpid()}
        if cmd == "status":
            return {"ok": True, **self.daemon.status()}
        if cmd == "tenants":
            leases = [dict(doc, tenant=tid)
                      for tid, view in namespace_views(self.daemon.store)
                      for doc in lease_status(view)]
            return {"ok": True, "tenants": self.daemon.tenants(),
                    "leases": leases}
        if cmd == "metrics":
            return {"ok": True, "metrics": self.daemon.metrics_text()}
        if cmd == "stop":
            self.stopped.set()
            return {"ok": True, "stopping": True}
        return {"ok": False, "error": f"unknown cmd {cmd!r}"}

    def _serve(self) -> None:
        while not self.stopped.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return                   # socket closed by close()
            with conn:
                buf = b""
                while not buf.endswith(b"\n"):
                    part = conn.recv(4096)
                    if not part:
                        break
                    buf += part
                if not buf.strip():
                    continue
                try:
                    resp = self._handle(json.loads(buf))
                except Exception as e:  # noqa: BLE001 — malformed request
                    resp = {"ok": False, "error": str(e)}
                try:
                    conn.sendall(json.dumps(resp).encode() + b"\n")
                except OSError:
                    pass

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.stopped.wait(timeout)

    def close(self) -> None:
        self.stopped.set()
        try:
            self._sock.close()
        finally:
            try:
                os.unlink(self.socket_path)
            except FileNotFoundError:
                pass
        self._thread.join(timeout=5)


def control(socket_path: str, cmd: str, *,
            timeout: float = 5.0) -> dict:
    """Send one control command to a running kishud; returns its response.
    Raises ``ConnectionError``/``FileNotFoundError`` if no daemon answers."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(socket_path)
        s.sendall(json.dumps({"cmd": cmd}).encode() + b"\n")
        buf = b""
        while not buf.endswith(b"\n"):
            part = s.recv(4096)
            if not part:
                break
            buf += part
    return json.loads(buf) if buf.strip() else {"ok": False,
                                                "error": "empty response"}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="kishud")
    ap.add_argument("--store", required=True,
                    help="shared store URI (any open_store form)")
    ap.add_argument("--socket", required=True,
                    help="unix socket path for the control plane")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--cache-bytes", type=int, default=None)
    ap.add_argument("--lease-ttl", type=float, default=10.0)
    ap.add_argument("--device", default=None,
                    help="where the tenants' tensors live (default cuda)")
    args = ap.parse_args(argv)

    daemon = Kishud(args.store, workers=args.workers,
                    cache_bytes=args.cache_bytes,
                    lease_ttl_s=args.lease_ttl, device=args.device)
    server = KishudServer(daemon, args.socket)
    print(f"kishud: serving {args.store} on {args.socket} "
          f"(pid {os.getpid()})", flush=True)
    try:
        server.wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
        daemon.close()
    print("kishud: stopped", flush=True)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
