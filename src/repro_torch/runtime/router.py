"""Multi-tenant serving plane: the router front door + admission shards.

Host code, the JAX package's (``src/repro/runtime/router.py``) line for
line: the same ring lookups, DRR order and accounting.

The single-loop ``Orchestrator`` serves ONE stream of requests against ONE
domain's tables — a hard ceiling for many-tenant traffic.  This module
splits the serving plane in two:

* :class:`AdmissionShard` — today's micro-batching admission loop
  (``Orchestrator``), parameterized by tenant: per-tenant bounded priority
  queues and deficit-round-robin (DRR) bucket formation replace the single
  shared queue.  Everything downstream of bucket formation (fused
  ``select_batch``, one fleet fan-out, ticket lifecycle, streaming) is
  inherited unchanged.
* :class:`TenantRouter` — the front door.  It owns N shards over ONE shared
  ``ReplicaFleet``-backed server, consistent-hashes tenants onto shards,
  resolves SLO classes, enforces per-tenant token-bucket quotas, and folds
  per-shard/per-tenant accounting into ``EcoLLMServer.system_state()``.

Tenancy contract
================

**Hashing.**  Tenant -> shard placement uses a consistent hash ring
(blake2b, ``VNODES`` virtual nodes per shard).  Placement is deterministic
in (tenant, n_shards) — stable across processes and runs, independent of
registration order — and changing the shard count moves only ~1/n_shards of
tenants (ring property), so resharding does not reshuffle the world.  All
of one tenant's traffic lands on one shard: its queue bound and DRR weight
apply globally to the tenant, and per-tenant ordering follows shard
ordering.

**SLO classes.**  A named :class:`SLOClass` bundles the scheduling contract
of a service tier: the default ``SLO`` stamped on requests that carry none,
an admission ``priority`` (higher drains first within a tenant's queue), an
optional admission ``deadline_s`` (time a ticket may wait in queue before
being shed with reason ``"deadline"``), and a class ``weight`` multiplier.
Three presets exist — ``deadline`` (interactive, tight SLO, high priority,
4x weight), ``standard``, and ``batch`` (no deadline, 0.25x weight).  A
request's class is its explicit ``Request.slo_class`` if set, else its
tenant's configured class.

**Quota semantics.**  Each tenant has a token bucket (``rate_qps`` refill,
``burst`` cap; both default to unlimited).  ``TenantRouter.submit`` takes
one token per request BEFORE the shard sees it; an empty bucket sheds the
request immediately with the typed ``Overloaded(reason="quota")`` — quota
sheds never consume shard queue capacity.  Inside the shard, the per-tenant
queue bound (``max_queue`` PER TENANT, not shared) is the second isolation
wall: a bursting tenant can only fill — and overflow, with
``reason="queue_full"`` — its OWN queue.

**Fairness guarantees.**  Bucket formation is deficit round-robin over the
tenants with backlog: each round credits a tenant's deficit counter with
its effective weight (``TenantSpec.weight * SLOClass.weight``) and drains
up to that many tickets (highest priority first, FIFO within priority).
Over any backlogged interval, tenants' served counts converge to the ratio
of their weights (regression-tested at 10:1); a tenant with no backlog
costs nothing and banks no credit (deficits reset when its queue empties —
an idle tenant cannot hoard capacity).  Combined with per-tenant queues and
quotas: one tenant's burst can delay another's tickets by at most the
in-flight bucket, never shed them, and never starve a weighted share.

**Per-tenant counters.**  The router counts ``offered`` per tenant; each
shard counts ``admitted`` / ``served`` / ``failed`` / ``shed`` (by reason)
/ ``violations`` (served outside the request's SLO) per tenant, updated
under the same lock as the aggregate counters they refine, so
``offered == admitted + shed`` and ``admitted == served + failed +
pending`` hold exactly at quiescence.  ``TenantRouter.stats()`` merges
shard views (a tenant lives on exactly one shard); ``system_state()``
exposes the same via the server.

Single-tenant compatibility: requests that never name a tenant carry
``DEFAULT_TENANT`` and may bypass the router entirely — the plain
``Orchestrator`` path is untouched and bit-for-bit identical to the
pre-multi-tenant serving plane.
"""
from __future__ import annotations

import asyncio
import bisect
import hashlib
import heapq
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Iterable, Optional

from repro_torch.core.slo import SLO
from repro_torch.runtime.orchestrator import Orchestrator, Ticket

if TYPE_CHECKING:
    from repro_torch.runtime.server import EcoLLMServer, Request

__all__ = ["SLOClass", "TenantSpec", "TokenBucket", "HashRing",
           "AdmissionShard", "TenantRouter", "DEFAULT_SLO_CLASSES"]


@dataclass(frozen=True)
class SLOClass:
    """A named service tier: default SLO + admission scheduling contract."""
    name: str
    slo: SLO = field(default_factory=SLO)
    priority: int = 1
    deadline_s: Optional[float] = None  # max time in admission queue
    weight: float = 1.0  # DRR weight multiplier for tenants of this class


DEFAULT_SLO_CLASSES: dict[str, SLOClass] = {
    "deadline": SLOClass("deadline", slo=SLO(max_latency_s=2.0),
                         priority=2, deadline_s=5.0, weight=4.0),
    "standard": SLOClass("standard", priority=1, deadline_s=None, weight=1.0),
    "batch": SLOClass("batch", priority=0, deadline_s=None, weight=0.25),
}


@dataclass(frozen=True)
class TenantSpec:
    """Per-tenant serving contract (module docstring: tenancy contract)."""
    name: str
    slo_class: str = "standard"
    weight: float = 1.0          # DRR share, multiplied by the class weight
    rate_qps: float = float("inf")   # token-bucket refill; inf = no quota
    burst: float = float("inf")      # token-bucket capacity
    domain: Optional[str] = None     # DomainData shard; None = server default


class TokenBucket:
    """Classic token bucket; ``take()`` is called from the submit path only
    (single event-loop thread), so no lock is needed."""

    def __init__(self, rate_qps: float, burst: float):
        self.rate = float(rate_qps)
        self.burst = float(burst)
        self.tokens = self.burst
        self._last = time.perf_counter()

    def take(self, n: float = 1.0) -> bool:
        if self.rate == float("inf") or self.burst == float("inf"):
            return True
        now = time.perf_counter()
        self.tokens = min(self.burst, self.tokens + (now - self._last) * self.rate)
        self._last = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


def _stable_hash64(key: str) -> int:
    """Deterministic 64-bit hash (blake2b) — stable across processes, unlike
    built-in ``hash`` under PYTHONHASHSEED."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big")


class HashRing:
    """Consistent hash ring mapping tenant ids onto shard indices."""

    VNODES = 64

    def __init__(self, n_shards: int, vnodes: int = VNODES):
        if n_shards < 1:
            raise ValueError("need >= 1 shard")
        self.n_shards = n_shards
        points = []
        for shard in range(n_shards):
            for v in range(vnodes):
                points.append((_stable_hash64(f"shard-{shard}#vn{v}"), shard))
        points.sort()
        self._hashes = [h for h, _ in points]
        self._shards = [s for _, s in points]

    def lookup(self, key: str) -> int:
        i = bisect.bisect_right(self._hashes, _stable_hash64(key))
        return self._shards[i % len(self._shards)]


def _tenant_counters() -> dict:
    return {"admitted": 0, "served": 0, "failed": 0, "shed": 0,
            "violations": 0, "shed_reasons": {}}


class AdmissionShard(Orchestrator):
    """One admission shard: the micro-batching loop with per-tenant bounded
    queues and deficit-round-robin bucket formation (module docstring).

    ``max_queue`` bounds each TENANT's queue, not the shard: a bursting
    tenant overflows only itself.  Bucket formation credits each backlogged
    tenant ``weight`` tickets per DRR round and drains them highest-priority
    first, so served counts converge to the weight ratio under backlog.
    Dispatch, streaming, and ticket lifecycle are inherited unchanged.
    """

    def __init__(self, server: "EcoLLMServer", *, shard_id: int,
                 tenant_weights: Optional[dict[str, float]] = None,
                 default_weight: float = 1.0, **kwargs):
        super().__init__(server, shard_id=shard_id, **kwargs)
        self._weights = dict(tenant_weights or {})
        self._default_weight = default_weight
        # tenant -> heap of (-priority, seq, ticket); rotation keeps
        # first-seen order, deficits carry fractional credit between rounds
        self._tq: dict[str, list] = {}
        self._rotation: list[str] = []
        self._rot_i = 0  # persistent DRR pointer: rotation resumes, not restarts
        self._deficit: dict[str, float] = {}
        self._arrival = asyncio.Event()
        self._stop_requested = False
        self.tenant_stats: dict[str, dict] = {}

    # -- per-tenant accounting (hooks run under self._stats_lock) -----------

    def _tstats(self, tenant: str) -> dict:
        s = self.tenant_stats.get(tenant)
        if s is None:
            s = self.tenant_stats[tenant] = _tenant_counters()
        return s

    def _note_shed(self, ticket: Ticket, reason: str) -> None:
        s = self._tstats(ticket.request.tenant)
        s["shed"] += 1
        s["shed_reasons"][reason] = s["shed_reasons"].get(reason, 0) + 1
        # base hook feeds the adaptation observer (ring append only)
        super()._note_shed(ticket, reason)

    def _note_settled(self, ticket: Ticket, resp, err) -> None:
        s = self._tstats(ticket.request.tenant)
        if err is not None:
            s["failed"] += 1
        else:
            s["served"] += 1
            if resp is not None and not resp.slo_ok:
                s["violations"] += 1
        super()._note_settled(ticket, resp, err)

    # -- admission ------------------------------------------------------------

    def _weight(self, tenant: str) -> float:
        return max(self._weights.get(tenant, self._default_weight), 1e-9)

    def _pending(self) -> int:
        return sum(len(q) for q in self._tq.values())

    def _queue_depth(self) -> int:
        return self._pending()

    async def submit(self, request: "Request", *, priority: int = 0,
                     deadline_s: Optional[float] = None) -> Ticket:
        """Per-tenant bounded admission (``Orchestrator.submit`` contract,
        with the queue bound applied to ``request.tenant``'s own queue)."""
        loop = asyncio.get_running_loop()
        ticket = Ticket(request, priority, deadline_s, loop.create_future())
        if self._closed:
            self._shed(ticket, "shutdown")
            return ticket
        tenant = request.tenant
        q = self._tq.get(tenant)
        if q is None:
            q = self._tq[tenant] = []
            self._rotation.append(tenant)
            self._deficit[tenant] = 0.0
        if len(q) >= self.max_queue:
            # evict this tenant's own lapsed-deadline squatters first
            self._purge_tenant_lapsed(tenant)
        if len(q) >= self.max_queue:
            self._shed(ticket, "queue_full")
            return ticket
        heapq.heappush(q, (-float(priority), next(self._seq), ticket))
        ticket.mark("admitted")
        if deadline_s is not None:
            ticket.deadline_at = ticket.events[-1][1] + deadline_s
        with self._stats_lock:
            self.admitted += 1
            self._tstats(tenant)["admitted"] += 1
        self._arrival.set()
        # same yield-once contract as the base submit (see its comment)
        await asyncio.sleep(0)
        return ticket

    def _purge_tenant_lapsed(self, tenant: str) -> int:
        now = time.perf_counter()
        q = self._tq.get(tenant, [])
        dead = [e for e in q
                if e[2].deadline_at is not None and now > e[2].deadline_at]
        if not dead:
            return 0
        q[:] = [e for e in q if not (
            e[2].deadline_at is not None and now > e[2].deadline_at)]
        heapq.heapify(q)
        for e in dead:
            self._shed(e[2], "deadline")
        return len(dead)

    def _drr_take(self, n: int) -> list[Ticket]:
        """Drain up to ``n`` tickets by deficit round-robin over backlogged
        tenants.  Each full rotation credits every backlogged tenant its
        weight; a tenant drains up to ``floor(deficit)`` tickets per visit
        (highest priority first).  Deficits of drained-empty tenants reset
        so idle tenants cannot bank credit.  The formed bucket is ordered by
        admission priority (FIFO within a priority): the fleet fan-out
        preserves bucket order into the per-replica FIFO queues, so a
        deadline-class ticket's job is enqueued — and served — ahead of the
        same bucket's batch-class jobs.

        The rotation pointer persists across buckets: a bucket that fills
        mid-rotation resumes at the NEXT tenant, so a heavy-weight tenant
        whose quantum alone fills ``max_batch`` cannot monopolise every
        bucket — the light tenants' turns come first next bucket, and
        served counts still track the weight ratio over the interval."""
        picked: list[tuple] = []  # (-priority, seq, ticket) heap entries
        # bounded visits: each full rotation adds >= min-weight to some
        # backlogged tenant, so progress is guaranteed; the cap is a
        # belt-and-braces guard against pathological float weights
        for _ in range(1_000_000):
            if (len(picked) >= n or not self._rotation
                    or not any(self._tq.values())):
                break
            tenant = self._rotation[self._rot_i % len(self._rotation)]
            self._rot_i = (self._rot_i + 1) % len(self._rotation)
            q = self._tq.get(tenant)
            if not q:
                continue
            self._deficit[tenant] += self._weight(tenant)
            take = min(len(q), int(self._deficit[tenant]),
                       n - len(picked))
            for _ in range(take):
                picked.append(heapq.heappop(q))
            self._deficit[tenant] -= take
        for tenant, q in self._tq.items():
            if not q:
                self._deficit[tenant] = 0.0
        picked.sort()  # (-priority, admission seq): deadline class first
        return [e[2] for e in picked]

    # -- lifecycle -------------------------------------------------------------

    async def start(self) -> "AdmissionShard":
        if self._task is not None and not self._task.done():
            return self
        self._loop = asyncio.get_running_loop()
        if self._queue_loop is not self._loop:
            # cross-loop session: the Event is bound to the old loop, and
            # tickets' futures can no longer be awaited — same contract as
            # the base class's queue rebind
            self._arrival = asyncio.Event()
            for q in self._tq.values():
                keep = []
                for entry in q:
                    if entry[2]._future.get_loop() is not self._loop:
                        try:
                            self._shed(entry[2], "stale_loop")
                        except RuntimeError:
                            pass
                    else:
                        keep.append(entry)
                q[:] = keep
                heapq.heapify(q)
        self._queue_loop = self._loop
        self._closed = False
        self._stop_requested = False
        if self._pending():
            self._arrival.set()
        self._task = self._loop.create_task(self._admission_loop())
        return self

    async def stop(self) -> None:
        """Stop the admission loop after draining every admitted ticket;
        subsequent submits shed with reason ``shutdown``."""
        task, self._task = self._task, None
        self._closed = True
        if task is None:
            return
        if not task.done():
            self._stop_requested = True
            self._arrival.set()
        await task

    def reconfigure(self, **kwargs) -> "AdmissionShard":
        mq = kwargs.get("max_queue")
        if self._task is not None and not self._task.done():
            raise RuntimeError("cannot reconfigure a running admission loop")
        if mq is not None and mq != self.max_queue:
            # per-tenant carry-over: keep each tenant's best (highest
            # priority, earliest) mq tickets, shed the rest — mirrors the
            # base class's carry-over contract per queue
            for q in self._tq.values():
                if len(q) > mq:
                    keep = heapq.nsmallest(mq, q)
                    kept_ids = {id(e) for e in keep}
                    drop = [e for e in q if id(e) not in kept_ids]
                    q[:] = keep
                    heapq.heapify(q)
                    for e in drop:
                        self._shed(e[2], "queue_full")
        return super().reconfigure(**kwargs)

    async def _admission_loop(self) -> None:
        """DRR bucket formation over the per-tenant queues; dispatch is the
        inherited one-selection-one-fan-out pipeline."""
        while True:
            while not self._pending():
                if self._stop_requested:
                    return
                self._arrival.clear()
                if self._pending():  # raced with a submit on this loop
                    continue
                await self._arrival.wait()
            # coalescing window: wait up to max_wait for the bucket to fill
            t0 = time.perf_counter()
            while self._pending() < self.max_batch and not self._stop_requested:
                remaining = self.max_wait_s - (time.perf_counter() - t0)
                if remaining <= 0:
                    break
                self._arrival.clear()
                try:
                    await asyncio.wait_for(self._arrival.wait(), remaining)
                except asyncio.TimeoutError:
                    break
            bucket = self._drr_take(self.max_batch)
            now = time.perf_counter()
            live = []
            for t in bucket:
                if t.deadline_at is not None and now > t.deadline_at:
                    self._shed(t, "deadline")
                else:
                    live.append(t)
            if live:
                try:
                    await self._dispatch(live)
                except Exception as e:  # noqa: BLE001 — fail the bucket,
                    # keep admitting (base-class rationale)
                    for t in live:
                        self._fail(t, e)

    def stats(self) -> dict:
        out = super().stats()
        with self._stats_lock:
            out["tenants"] = {
                t: {**s, "shed_reasons": dict(s["shed_reasons"])}
                for t, s in self.tenant_stats.items()}
        return out


class TenantRouter:
    """Front door over N admission shards sharing one server/fleet
    (module docstring: tenancy contract)."""

    def __init__(self, server: "EcoLLMServer",
                 tenants: Iterable[TenantSpec] = (), *, n_shards: int = 2,
                 max_batch: int = 32, max_wait_ms: float = 2.0,
                 max_queue: int = 256, hedge: bool = True,
                 stream: bool = True,
                 slo_classes: Optional[dict[str, SLOClass]] = None):
        self.server = server
        self.classes = dict(DEFAULT_SLO_CLASSES)
        if slo_classes:
            self.classes.update(slo_classes)
        self.tenants: dict[str, TenantSpec] = {}
        self.ring = HashRing(n_shards)
        weights = self._effective_weights(tenants)
        self.shards = [
            AdmissionShard(server, shard_id=i, tenant_weights=weights,
                           max_batch=max_batch, max_wait_ms=max_wait_ms,
                           max_queue=max_queue, hedge=hedge, stream=stream)
            for i in range(n_shards)]
        self._buckets: dict[str, TokenBucket] = {}
        self.offered: dict[str, int] = {}
        for spec in self.tenants.values():
            self._buckets[spec.name] = TokenBucket(spec.rate_qps, spec.burst)
        server._router = self
        # the adaptation plane hangs PER ADMISSION SHARD: if the server
        # already enabled one, every shard observes its own outcomes (and a
        # later enable_adaptation() attaches through shard_list())
        if getattr(server, "_adaptation", None) is not None:
            for sh in self.shards:
                sh.attach_adaptation(server._adaptation)

    def shard_list(self) -> list[AdmissionShard]:
        return list(self.shards)

    def _effective_weights(self, tenants: Iterable[TenantSpec]) -> dict:
        weights = {}
        for spec in tenants:
            if spec.slo_class not in self.classes:
                raise ValueError(f"unknown SLO class {spec.slo_class!r}")
            self.tenants[spec.name] = spec
            weights[spec.name] = (spec.weight
                                  * self.classes[spec.slo_class].weight)
        return weights

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def spec(self, tenant: str) -> TenantSpec:
        s = self.tenants.get(tenant)
        return s if s is not None else TenantSpec(tenant)

    def shard_index(self, tenant: str) -> int:
        return self.ring.lookup(tenant)

    def shard_for(self, tenant: str) -> AdmissionShard:
        return self.shards[self.ring.lookup(tenant)]

    # -- lifecycle ------------------------------------------------------------

    async def start(self) -> "TenantRouter":
        for s in self.shards:
            await s.start()
        return self

    async def stop(self) -> None:
        for s in self.shards:
            await s.stop()

    async def __aenter__(self) -> "TenantRouter":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- admission ------------------------------------------------------------

    async def submit(self, request: "Request", *,
                     priority: Optional[int] = None,
                     deadline_s: Optional[float] = None) -> Ticket:
        """Route one request: resolve tenant spec + SLO class, charge the
        quota bucket, stamp class defaults, and admit on the tenant's shard.
        Always returns a Ticket — quota/queue rejections come back already
        settled with a typed ``Overloaded``."""
        spec = self.spec(request.tenant)
        cls = self.classes[request.slo_class or spec.slo_class]
        if request.slo_class is None:
            request.slo_class = cls.name
        if request.domain is None and spec.domain is not None:
            request.domain = spec.domain
        if request.slo == SLO():  # no explicit SLO: the class default rules
            request.slo = cls.slo
        self.offered[request.tenant] = self.offered.get(request.tenant, 0) + 1
        shard = self.shard_for(request.tenant)
        bucket = self._buckets.get(request.tenant)
        if bucket is not None and not bucket.take():
            loop = asyncio.get_running_loop()
            ticket = Ticket(request, priority or 0, deadline_s,
                            loop.create_future())
            shard._shed(ticket, "quota")
            return ticket
        return await shard.submit(
            request,
            priority=cls.priority if priority is None else priority,
            deadline_s=cls.deadline_s if deadline_s is None else deadline_s)

    # -- telemetry ------------------------------------------------------------

    def stats(self) -> dict:
        """Merged per-shard + per-tenant counters (a tenant lives on exactly
        one shard, so merging is disjoint-union)."""
        shard_stats = [s.stats() for s in self.shards]
        tenants: dict[str, dict] = {}
        for st in shard_stats:
            for name, c in st["tenants"].items():
                tenants[name] = {**c, "shed_reasons": dict(c["shed_reasons"])}
        for name, off in self.offered.items():
            t = tenants.setdefault(name, _tenant_counters())
            t["offered"] = off
        for name, t in tenants.items():
            t.setdefault("offered", 0)
            t["shard"] = self.shard_index(name)
        out = {
            "n_shards": self.n_shards,
            "tenants": tenants,
            "shards": [{k: st[k] for k in
                        ("shard_id", "admitted", "shed", "deadline_shed",
                         "batches", "dispatched", "completed", "failed",
                         "queue_depth")}
                       for st in shard_stats],
        }
        # per-shard adaptation telemetry (drift monitors, ring fill, sweep
        # counts) when an AdaptationPlane is attached
        for row, sh in zip(out["shards"], self.shards):
            adapt = sh.adaptation_state()
            if adapt is not None:
                row["adaptation"] = adapt
        return out
