"""Cost-based checkout planner — restore vs recompute vs hybrid (DESIGN.md §18).

Checkout assumed fetching chunks is always the cheapest path back to a
state; on a remote/slow fabric a co-variable is often cheaper to *replay*
from its recorded command (Fine-Grained Lineage) or to *patch* from a
nearer base (code+data space versioning).  The planner prices three paths
per diverged co-variable and hands ``StateLoader.checkout`` a mixed plan:

fetch   manifest bytes / an online per-backend bandwidth+latency model fed
        by the ``kishu_store_op_seconds`` / ``kishu_store_bytes_total``
        metrics the InstrumentedStore already records; chunks resident in
        the shared ChunkCache are priced at zero.
replay  measured cell cost (per-commit ``exec_s``) summed over the
        recursive dependency closure the DataRestorer would walk —
        memo-aware: a command shared by several co-variables (or already
        charged to another co-variable's replay in this plan) is priced
        once, mirroring the restorer's per-checkout replay memo.
patch   dirty-chunk bytes against the live base (``plan_patches``); chunks
        shared with *any* cache-resident commit are free through the CAS
        cache credit, which generalizes patching beyond HEAD without a
        separate execution path.

Unserializable manifests (det-replay skips, opaque leaves) price fetch at
infinity, so DetReplay commits always plan replay; commands that are
unregistered, marked replay-unsafe at commit time, rooted at
``__init__``, or the ``__attach__`` of a state handed in from outside price
replay at infinity, so planner-on can never attempt a replay planner-off
would not survive.  (An attach re-inserts the caller's tensors, and cells
may have changed those in place since: replaying it would restore today's
values, not the attached ones.)  Infinite-everywhere co-variables
stay on the fetch lane where the existing fallback ladder (and its error
reporting) is unchanged — the planner re-routes work, never re-defines
failure.
"""
from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.covariable import CovKey
from repro_torch.core.graph import CheckpointGraph, CheckoutPlan, parse_key

INF = math.inf

PLAN_MODES = ("off", "auto", "fetch", "replay")
_MODE_ALIASES = {
    "": "off", "0": "off", "none": "off", "false": "off",
    "1": "auto", "on": "auto", "true": "auto",
    "forced-fetch": "fetch", "forced-replay": "replay",
}

# Conservative priors for a cold cost model (first checkout of a session,
# or `kishu plan` against a store never read from): local-disk-ish store,
# expensive-unless-measured cells.
DEFAULT_BANDWIDTH_BPS = 500e6
DEFAULT_LATENCY_S = 5e-4
DEFAULT_EXEC_S = 60.0           # commit docs predating exec_s persistence
REPLAY_EPS_S = 1e-4             # per-command overhead; ties break to fetch


def resolve_plan_mode(mode: Optional[str] = None) -> str:
    """Effective planner mode: explicit arg > $KISHU_PLANNER > off."""
    if mode is None:
        mode = os.environ.get("KISHU_PLANNER", "")
    mode = str(mode).strip().lower()
    mode = _MODE_ALIASES.get(mode, mode)
    if mode not in PLAN_MODES:
        raise ValueError(
            f"plan_mode {mode!r}: expected one of {'/'.join(PLAN_MODES)}")
    return mode


class StoreCostModel:
    """Online per-backend fetch estimator over the obs registry.

    Effective bandwidth = get bytes / get seconds across every backend
    label, so per-chunk stalls a slow transport serializes (latency-bound
    fabrics) are *inside* the rate — the model never needs to know whether
    a store is round-trip- or bandwidth-bound.  Latency is the mean
    observed get-op time, charged once per fetch (checkout issues one
    pipelined bulk fetch per lane)."""

    GET_OPS = ("get_chunk", "get_chunks")

    def __init__(self, registry=None, *,
                 default_bandwidth_Bps: float = DEFAULT_BANDWIDTH_BPS,
                 default_latency_s: float = DEFAULT_LATENCY_S):
        self.registry = registry
        self.default_bandwidth_Bps = default_bandwidth_Bps
        self.default_latency_s = default_latency_s

    def snapshot(self) -> Tuple[float, float, int]:
        """(latency_s, bandwidth_Bps, observed get ops)."""
        total_s = 0.0
        ops = 0
        nbytes = 0.0
        if self.registry is not None:
            for h in list(getattr(self.registry, "_histograms", {}).values()):
                if h.name == "kishu_store_op_seconds" \
                        and h.labels.get("op") in self.GET_OPS:
                    total_s += h.sum
                    ops += h.count
            for c in list(getattr(self.registry, "_counters", {}).values()):
                if c.name == "kishu_store_bytes_total" \
                        and c.labels.get("dir") == "get":
                    nbytes += c.value
        lat = total_s / ops if ops else self.default_latency_s
        bw = nbytes / total_s if nbytes > 0 and total_s > 0 \
            else self.default_bandwidth_Bps
        return lat, bw, ops

    def fetch_seconds(self, nbytes: int, nchunks: int) -> float:
        if nchunks <= 0:
            return 0.0
        lat, bw, _ = self.snapshot()
        return lat + nbytes / max(bw, 1.0)


@dataclass
class CovPlan:
    """One co-variable's priced paths and the chosen one."""
    key: CovKey
    version: str
    path: str                   # fetch | replay | patch
    est_s: float                # cost of the chosen path
    est_bytes: int              # bytes the chosen path moves from the store
    why: str
    fetch_s: float = INF
    replay_s: float = INF
    patch_s: float = INF

    @property
    def name(self) -> str:
        return "+".join(self.key)


@dataclass
class PricedPlan:
    cur: str
    target: str
    mode: str
    covs: List[CovPlan] = field(default_factory=list)
    identical: int = 0
    deleted: int = 0
    est_fetch_s: float = 0.0    # fetch+patch lane (store reads)
    est_replay_s: float = 0.0   # replay lane (compute)
    est_total_s: float = 0.0    # lanes overlap: max, not sum
    latency_s: float = 0.0      # cost-model snapshot the plan was priced at
    bandwidth_Bps: float = 0.0
    samples: int = 0

    def counts(self) -> Dict[str, int]:
        out = {"fetch": 0, "replay": 0, "patch": 0}
        for c in self.covs:
            out[c.path] += 1
        return out

    def path_of(self, key: CovKey) -> Optional[str]:
        for c in self.covs:
            if c.key == key:
                return c.path
        return None


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024 or unit == "GB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}GB"


def _fmt_s(s: float) -> str:
    return "inf" if s == INF else f"{s:.3f}s"


def format_plan(p: PricedPlan) -> List[str]:
    """Human-oriented rendering shared by ``kishu plan`` and tests."""
    n = p.counts()
    lines = [
        f"plan {p.cur} -> {p.target}  mode={p.mode}  "
        f"est {_fmt_s(p.est_total_s)} "
        f"(fetch lane {_fmt_s(p.est_fetch_s)} | "
        f"replay lane {_fmt_s(p.est_replay_s)})",
        f"store model: latency {p.latency_s * 1e3:.2f}ms/op, "
        f"bandwidth {p.bandwidth_Bps / 1e6:.0f}MB/s "
        f"({p.samples} get op(s) observed)",
        f"{'PATH':<7} {'EST':>9} {'BYTES':>9}  CO-VARIABLE @ VERSION",
    ]
    for c in p.covs:
        lines.append(
            f"{c.path:<7} {_fmt_s(c.est_s):>9} {_fmt_bytes(c.est_bytes):>9}"
            f"  {c.name} @ {c.version}  -- {c.why}")
    lines.append(
        f"covs: {n['fetch']} fetch, {n['patch']} patch, {n['replay']} replay"
        f"; {p.identical} identical, {p.deleted} deleted")
    return lines


class CheckoutPlanner:
    """Prices fetch/replay/patch per diverged co-variable and partitions
    the checkout into the lanes ``StateLoader`` executes concurrently."""

    def __init__(self, graph: CheckpointGraph, loader, *,
                 commands: Optional[Dict[str, Callable]] = None,
                 unsafe: Optional[Set[str]] = None,
                 mode: Optional[str] = None,
                 cache=None,
                 obs=None,
                 max_depth: int = 64,
                 default_exec_s: float = DEFAULT_EXEC_S,
                 cost: Optional[StoreCostModel] = None):
        self.graph = graph
        self.loader = loader
        self.commands = commands        # None: assume registered (CLI plan)
        self.unsafe = unsafe if unsafe is not None else set()
        self.mode = resolve_plan_mode(mode)
        self.cache = cache              # shared ChunkCache (may be None)
        self.obs = obs
        self.max_depth = max_depth
        self.default_exec_s = default_exec_s
        self.cost = cost or StoreCostModel(
            obs.registry if obs is not None else None)

    @property
    def engaged(self) -> bool:
        return self.mode != "off"

    # ------------------------------------------------------------------
    # per-path pricing
    # ------------------------------------------------------------------
    def _cached(self, chunk_key: str) -> bool:
        return self.cache is not None and self.cache.contains(chunk_key)

    def _fetch_price(self, key: CovKey, version: str
                     ) -> Tuple[float, int, str]:
        """(seconds, cold bytes, why) for a full manifest fetch."""
        man = self.graph.manifest_of(key, version)
        if man is None:
            return INF, 0, "no manifest"
        if man.get("unserializable"):
            why = "det-skipped" if man.get("det_skipped") else "unserializable"
            return INF, 0, why
        chunks = man["base"]["chunks"]
        cold_b = cold_n = 0
        for c in chunks:
            if not self._cached(c["key"]):
                cold_b += int(c["n"])
                cold_n += 1
        why = f"{cold_n}/{len(chunks)} chunks cold" if cold_n \
            else "all chunks cache-resident"
        return self.cost.fetch_seconds(cold_b, cold_n), cold_b, why

    def _patch_price(self, patch) -> Tuple[float, int, str]:
        """(seconds, cold dirty bytes, why) for a live-base chunk patch."""
        chunks = patch.manifest["base"]["chunks"]
        cold_b = cold_n = 0
        for i in patch.dirty:
            c = chunks[i]
            if not self._cached(c["key"]):
                cold_b += int(c["n"])
                cold_n += 1
        why = f"{len(patch.dirty)}/{len(chunks)} chunks dirty ({cold_n} cold)"
        return self.cost.fetch_seconds(cold_b, cold_n), cold_b, why

    def _exec_cost(self, node) -> float:
        s = node.stats.get("exec_s")
        return REPLAY_EPS_S + (float(s) if s is not None
                               else self.default_exec_s)

    def _replayable(self, node) -> bool:
        name = node.command.get("name")
        if name in ("__init__", "__attach__"):
            return False                # root or attached state: nothing
                                        # to re-run that gives its values
        if node.stats.get("replay_safe") is False or name in self.unsafe:
            return False
        if self.commands is not None and name not in self.commands:
            return False
        return True

    def _replay_price(self, version: str, charged: Set[str]
                      ) -> Tuple[float, Set[str], int]:
        """(seconds, commands that would newly run, commands total) to
        replay ``version``'s command with its dependency closure restored.

        Mirrors the DataRestorer exactly: dependencies load from the store
        when they can (priced as fetches, cache credit included) and only
        recurse into replay when fetch is impossible.  ``charged`` holds
        versions already committed to this plan's replay lane — the
        restorer's per-checkout memo replays each at most once, so a
        shared ancestor prices (and counts) once across co-variables."""
        local: Dict[str, Tuple[float, Set[str]]] = {}
        shared: Set[str] = set()

        def walk(ver: str, depth: int) -> Tuple[float, Set[str]]:
            if ver in charged:
                shared.add(ver)         # memo hit at execution time
                return 0.0, set()
            hit = local.get(ver)
            if hit is not None:
                return hit
            if depth > self.max_depth:
                return INF, set()
            node = self.graph.nodes.get(ver)
            if node is None or not self._replayable(node):
                return INF, set()
            local[ver] = (0.0, set())   # cycle guard (graph is a DAG)
            cost = self._exec_cost(node)
            used = {ver}
            for ks, dep_ver in sorted(node.accessed.items()):
                dep_fetch, _, _ = self._fetch_price(parse_key(ks), dep_ver)
                if dep_fetch < INF:
                    cost += dep_fetch   # restorer prefetches loadable deps
                else:
                    dep_cost, dep_used = walk(dep_ver, depth + 1)
                    cost += dep_cost
                    used |= dep_used
            local[ver] = (cost, used)
            return cost, used

        cost, used = walk(version, 0)
        return cost, used, len(used) + len(shared)

    # ------------------------------------------------------------------
    # plan assembly
    # ------------------------------------------------------------------
    def price_checkout(self, cur: str, target: str, *,
                       records=None, ns=None) -> PricedPlan:
        """Diff + patch-candidate scan + pricing, without executing.

        ``records``/``ns`` enable live-base patch candidates (a session
        passes its own; the CLI prices fetch-vs-replay only)."""
        plan = self.graph.diff(cur, target)
        if records is not None and ns is not None:
            patches, full_items = self.loader.plan_patches(plan, records, ns)
        else:
            patches, full_items = [], sorted(plan.to_load.items())
        return self.price(cur, target, plan, patches, full_items)

    def price(self, cur: str, target: str, plan: CheckoutPlan,
              patches: Sequence[Any],
              full_items: Sequence[Tuple[CovKey, str]]) -> PricedPlan:
        t0 = time.perf_counter()
        lat, bw, samples = self.cost.snapshot()
        out = PricedPlan(cur=cur, target=target, mode=self.mode,
                         identical=len(plan.identical),
                         deleted=len(plan.to_delete),
                         latency_s=lat, bandwidth_Bps=bw, samples=samples)
        charged: Set[str] = set()       # versions on the replay lane so far
        rows: List[Tuple[CovKey, str, Optional[Any]]] = \
            [(p.key, p.version, p) for p in patches] + \
            [(k, v, None) for k, v in full_items]
        for key, version, patch in sorted(rows, key=lambda r: r[0]):
            fetch_s, fetch_b, fetch_why = self._fetch_price(key, version)
            patch_s, patch_b, patch_why = (INF, 0, "")
            if patch is not None:
                patch_s, patch_b, patch_why = self._patch_price(patch)
            replay_s, closure, n_cmds = self._replay_price(version, charged)
            replay_why = (f"{len(closure)} cmd(s) to run"
                          + (f", {n_cmds - len(closure)} memo-shared"
                             if n_cmds > len(closure) else ""))
            path, est_s, est_b, why = self._choose(
                patch, fetch_s, fetch_b, fetch_why,
                patch_s, patch_b, patch_why, replay_s, replay_why)
            if path == "replay":
                charged |= closure      # shared ancestors price once
            out.covs.append(CovPlan(
                key=key, version=version, path=path, est_s=est_s,
                est_bytes=est_b, why=why, fetch_s=fetch_s,
                replay_s=replay_s, patch_s=patch_s))
        for c in out.covs:
            if c.path == "replay":
                out.est_replay_s += c.est_s
            elif c.est_s < INF:
                out.est_fetch_s += c.est_s
        out.est_total_s = max(out.est_fetch_s, out.est_replay_s)
        if self.obs is not None:
            reg = self.obs.registry
            for path, n in out.counts().items():
                if n:
                    reg.counter("kishu_plan_covs_total", path=path).inc(n)
            reg.histogram("kishu_plan_price_seconds").observe(
                time.perf_counter() - t0)
        return out

    def _choose(self, patch, fetch_s, fetch_b, fetch_why,
                patch_s, patch_b, patch_why, replay_s, replay_why):
        """Pick the path for one co-variable under the planner mode."""
        data_path = ("patch", patch_s, patch_b, patch_why) if patch is not None \
            else ("fetch", fetch_s, fetch_b, fetch_why)
        if self.mode == "fetch":
            return data_path
        if self.mode == "replay":
            if replay_s < INF:
                return "replay", replay_s, 0, replay_why + " (forced)"
            return data_path
        # auto: strictly cheaper replay wins; ties and infinities keep the
        # data path so planner-on never changes the failure ladder
        if replay_s < data_path[1]:
            return "replay", replay_s, 0, \
                replay_why + f" vs {data_path[0]} {_fmt_s(data_path[1])}"
        return data_path

    def partition(self, priced: PricedPlan, patches: Sequence[Any],
                  full_items: Sequence[Tuple[CovKey, str]]
                  ) -> Tuple[List[Any], List[Tuple[CovKey, str]],
                             List[Tuple[CovKey, str]]]:
        """Split the priced plan into execution lanes:
        (patches to apply, covs to fetch, covs to replay)."""
        path = {c.key: c.path for c in priced.covs}
        keep_patches = [p for p in patches
                        if path.get(p.key, "patch") != "replay"]
        demoted = [(p.key, p.version) for p in patches
                   if path.get(p.key) == "replay"]
        fetch_items = [(k, v) for k, v in full_items
                       if path.get(k, "fetch") != "replay"]
        replay_items = sorted(demoted + [
            (k, v) for k, v in full_items if path.get(k) == "replay"])
        return keep_patches, fetch_items, replay_items
