"""Session leases — single-writer enforcement per checkpoint namespace
(DESIGN.md §14).

Two ``KishuSession``s opened on one store can tear a branch: both load the
same HEAD seq, both publish ``c{seq}``, and the second publish silently
orphans the first writer's commit.  A *lease* is the writer-side fix: one
meta document (``lease/<name>``) naming the current writer, acquired before
a session opens its graph (so crash recovery runs under the lease too) and
checked before every metadata publish.

**Clock discipline.**  Stores are shared across hosts, so the lease doc
never carries a wall-clock deadline that another host would have to trust
(an NTP step would instantly expire — or immortalize — the lease).
Expiry is *observed*, not declared: a contender may steal only after the
same ``(owner, token, ts)`` document has been continuously visible for the
doc's full ``ttl_s`` on the contender's **own monotonic clock**.  The
holder symmetrically trusts only its own monotonic clock: a successful
acquire/renew buys ``ttl_s`` of local validity, and once that horizon
passes the holder refuses to publish (``LeaseLost``) — which is always
*before* any contender can have finished observing a full quiet TTL,
because observation can only start at (or after) the holder's last write.

**Fencing.**  Every acquisition (first grant or steal) increments the
doc's ``token``.  A deposed writer discovers the steal at its next renew
(owner/token mismatch) or local expiry, and its transaction engine
poisons itself instead of publishing over the thief's commits; the
Checkpoint Graph's HEAD-seq compare-and-fail (txn.check_publish_guard)
backstops even the races a last-writer-wins meta store cannot exclude.

The store needs nothing beyond ``put_meta``/``get_meta``/``delete_meta``
— acquisition is write-then-read-back (the reader that sees its own doc
won the write race).  That is weaker than a CAS, so the lease is a
*practical* mutual exclusion (window: two writers racing the same
read-back), with the seq guard kept as defense in depth.
"""
from __future__ import annotations

import os
import socket
import threading
import time
import uuid
from typing import Dict, List, Optional

from repro_torch.core.chunkstore import ChunkStore

LEASE_PREFIX = "lease/"
DEFAULT_TTL_S = 30.0


class LeaseError(RuntimeError):
    """Base class for lease failures."""


class LeaseHeld(LeaseError):
    """Acquisition failed: another writer holds an unexpired lease."""


class LeaseLost(LeaseError):
    """The local writer can no longer prove it holds the lease (stolen by
    another writer, or its local validity horizon passed without a renew);
    publishing now could tear the branch, so the caller must stop."""


def default_owner_id() -> str:
    """Host + pid + nonce: unique across hosts, processes, and multiple
    sessions inside one process (the kishud case)."""
    return (f"{socket.gethostname()}-{os.getpid()}-"
            f"{uuid.uuid4().hex[:8]}")


class Lease:
    """A writer lease over one checkpoint namespace.

        lease = Lease(store, ttl_s=10.0).acquire()
        ...                      # publish freely; call ensure() before each
        lease.ensure()           # cheap: I/O only when a renew is due
        lease.release()

    Thread-safe: the async publish worker calls ``ensure`` from its own
    thread while the session thread may be releasing.
    """

    #: fraction of the TTL after which ``ensure`` proactively renews —
    #: leaves at least half the TTL of slack for the renew round-trip
    RENEW_FRAC = 0.5

    def __init__(self, store: ChunkStore, name: str = "writer", *,
                 owner: Optional[str] = None, ttl_s: float = DEFAULT_TTL_S,
                 obs=None):
        self.store = store
        self.name = name
        self.doc_name = LEASE_PREFIX + name
        self.owner = owner or default_owner_id()
        self.ttl_s = float(ttl_s)
        self.token = 0
        self.obs = obs                # optional SessionObs for event counts
        self._held = False
        self._horizon = 0.0           # local-monotonic validity deadline
        self._observed = None         # (doc fingerprint, first-seen mono)
        self._lock = threading.RLock()

    def _event(self, event: str) -> None:
        if self.obs is not None:
            self.obs.registry.counter("kishu_lease_events_total",
                                      event=event).inc()

    # ------------------------------------------------------------------
    # acquisition
    # ------------------------------------------------------------------
    @property
    def held(self) -> bool:
        with self._lock:
            return self._held and time.monotonic() < self._horizon

    def _fingerprint(self, doc: dict):
        return (doc.get("owner"), doc.get("token"), doc.get("ts"))

    def _expired(self, doc: dict) -> bool:
        """True once the same doc has been continuously observed for its
        full TTL on *our* monotonic clock.  The first sighting only starts
        the observation window — never trust the doc's wall-clock ``ts``."""
        fp = self._fingerprint(doc)
        now = time.monotonic()
        if self._observed is None or self._observed[0] != fp:
            self._observed = (fp, now)
            return False
        return now - self._observed[1] >= float(doc.get("ttl_s", self.ttl_s))

    def _try_acquire(self, steal: bool) -> bool:
        cur = self.store.get_meta(self.doc_name)
        takeover = None
        if cur is not None and cur.get("owner") != self.owner:
            if steal:
                takeover = "steal"
            elif self._expired(cur):
                takeover = "expired_takeover"
            else:
                return False
        token = int((cur or {}).get("token", 0)) + 1
        t0 = time.monotonic()
        self.store.put_meta(self.doc_name, self._doc(token))
        back = self.store.get_meta(self.doc_name)
        if back is None or back.get("owner") != self.owner \
                or back.get("token") != token:
            return False              # lost the write race to another writer
        with self._lock:
            self.token = token
            self._held = True
            self._horizon = t0 + self.ttl_s
        self._event(takeover or "acquire")
        return True

    def _doc(self, token: int) -> dict:
        return {"owner": self.owner, "token": token, "ttl_s": self.ttl_s,
                "ts": time.time(), "pid": os.getpid(),
                "host": socket.gethostname()}

    def acquire(self, *, wait_s: float = 0.0, steal: bool = False,
                poll_s: float = 0.05) -> "Lease":
        """Take the lease.  Free (or our own) docs grant immediately; a
        foreign doc grants only after *observed* expiry — so with
        ``wait_s`` covering the TTL, a contender blocks until the holder
        dies, and with ``wait_s=0`` a held lease raises :class:`LeaseHeld`
        at once.  ``steal=True`` skips the observation (operator override:
        the caller asserts the holder is dead)."""
        deadline = time.monotonic() + max(0.0, wait_s)
        while True:
            if self._try_acquire(steal):
                return self
            if time.monotonic() >= deadline:
                cur = self.store.get_meta(self.doc_name) or {}
                self._event("held")
                raise LeaseHeld(
                    f"lease {self.doc_name!r} held by "
                    f"{cur.get('owner', '?')} (token {cur.get('token')}); "
                    f"not observed idle for ttl={cur.get('ttl_s')}s")
            time.sleep(min(poll_s, max(1e-3,
                                       deadline - time.monotonic())))

    # ------------------------------------------------------------------
    # holder-side maintenance
    # ------------------------------------------------------------------
    def renew(self) -> None:
        """Refresh the doc and extend the local validity horizon.  Raises
        :class:`LeaseLost` if another writer has taken over (owner or
        token mismatch) — the fencing check a deposed writer cannot miss."""
        with self._lock:
            if not self._held:
                raise LeaseLost(f"lease {self.doc_name!r} not held")
            cur = self.store.get_meta(self.doc_name)
            if cur is None or cur.get("owner") != self.owner \
                    or cur.get("token") != self.token:
                self._held = False
                self._event("lost")
                raise LeaseLost(
                    f"lease {self.doc_name!r} taken over by "
                    f"{(cur or {}).get('owner', '?')} "
                    f"(token {(cur or {}).get('token')})")
            t0 = time.monotonic()
            self.store.put_meta(self.doc_name, self._doc(self.token))
            self._horizon = t0 + self.ttl_s

    def ensure(self) -> None:
        """Pre-publish check: free while well inside the TTL, renews
        (2 meta round-trips) once past ``RENEW_FRAC`` of it, and raises
        :class:`LeaseLost` past the local horizon — at which point a
        contender may legitimately have stolen the lease, so publishing
        would risk tearing the branch."""
        with self._lock:
            if not self._held:
                raise LeaseLost(f"lease {self.doc_name!r} not held")
            now = time.monotonic()
            if now >= self._horizon:
                self._held = False
                self._event("lost")
                raise LeaseLost(
                    f"lease {self.doc_name!r} expired locally "
                    f"(no renew within ttl={self.ttl_s}s)")
            if now >= self._horizon - self.ttl_s * self.RENEW_FRAC:
                self.renew()

    def release(self) -> None:
        """Drop the lease doc iff still ours — releasing a stolen lease
        must not delete the thief's grant.  Idempotent."""
        with self._lock:
            if not self._held:
                return
            self._held = False
            try:
                cur = self.store.get_meta(self.doc_name)
                if cur is not None and cur.get("owner") == self.owner \
                        and cur.get("token") == self.token:
                    self.store.delete_meta(self.doc_name)
            except Exception:  # noqa: BLE001 — backend down: TTL reclaims
                pass


# ---------------------------------------------------------------------------
# introspection (CLI `lease` / `tenants`, kishud status)
# ---------------------------------------------------------------------------

def lease_status(store: ChunkStore) -> List[Dict]:
    """All lease docs visible in the store's namespace, with the doc's own
    wall-clock age as a *hint* (expiry itself is observation-based)."""
    out = []
    for name in store.list_meta(LEASE_PREFIX):
        doc = store.get_meta(name) or {}
        age = max(0.0, time.time() - float(doc.get("ts", 0.0)))
        out.append({"name": name[len(LEASE_PREFIX):],
                    "owner": doc.get("owner"), "token": doc.get("token"),
                    "ttl_s": doc.get("ttl_s"), "age_hint_s": round(age, 3),
                    "pid": doc.get("pid"), "host": doc.get("host")})
    return out
