"""ECO-LLM Runtime server (paper §4): OpenAI-compatible-ish request handling.

Request -> embed -> RPS decision (SLO-aware path selection) -> execute the
chosen resolution path on the fleet -> response with full decision telemetry
(build id, selected path, selection overhead, SLO verdict).  Mirrors the
paper's server extensions: build identifiers, SLO specification parameters,
system state reporting.

The serving surface is the asyncio ``Orchestrator``
(``repro_torch.runtime.orchestrator``): ``submit()`` with per-request SLO /
priority / deadline, micro-batched admission over the fused selector, and
bounded-queue load shedding.  ``handle`` / ``handle_batch`` remain as
synchronous compatibility shims routed through the same dispatch pipeline.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.domains import DomainData
from repro_torch.core.pipeline import PipelineExecutor
from repro_torch.core.rps import RuntimePathSelector
from repro_torch.core.slo import SLO, SLOTracker
from repro_torch.core.text import embed_text
from repro_torch.runtime.fleet import Replica, ReplicaFleet
from repro_torch.runtime.orchestrator import Orchestrator


#: tenant id used when a caller never names one — the single-tenant
#: compatibility path; requests carrying it traverse exactly the
#: pre-multi-tenant code.
DEFAULT_TENANT = "default"


@dataclass
class Request:
    prompt: str
    slo: SLO = field(default_factory=SLO)
    build_id: str = "default"
    qid: Optional[int] = None  # known query id (benchmark mode)
    # -- multi-tenant identity (PR 8); defaults preserve the single-tenant
    # path bit-for-bit.  ``tenant`` names the quota/fairness principal;
    # ``slo_class`` the named service class (resolved by the TenantRouter —
    # None means "use the tenant's configured class"); ``domain`` the
    # DomainData shard serving this request (None -> the server's default).
    tenant: str = DEFAULT_TENANT
    slo_class: Optional[str] = None
    domain: Optional[str] = None


@dataclass
class Response:
    """Serving result + decision telemetry.

    Overhead contract: every response carries BOTH selection-overhead
    figures, whether it was served alone or in a batch — a single request is
    simply a bucket of one.  ``selection_overhead_s`` is the amortized
    per-query share of the selection pass (``Decision.overhead_s``);
    ``meta["batch_overhead_s"]`` is the full wall-clock of the pass that
    produced the decision (``Decision.batch_overhead_s``) and equals
    ``selection_overhead_s`` when the bucket had one request.
    """

    text: str
    accuracy: float  # judge score (benchmark mode; NaN in open serving)
    latency_s: float
    cost_usd: float
    path_key: str
    selection_overhead_s: float
    slo_ok: bool
    replica: int
    meta: dict = field(default_factory=dict)
    tenant: str = DEFAULT_TENANT


class EcoLLMServer:
    """Binds trained RPS instances to domain executors behind one elastic
    fleet.  Constructed single-domain (``self.domain``/``self.rps``/
    ``self.executor`` keep their pre-multi-tenant meaning: the DEFAULT
    domain); ``add_domain`` composes further ``DomainData``s, after which
    selection for mixed traffic runs through the domain-sharded fused
    program (``sharded_selector``) while a single-domain server still
    traverses exactly the original path."""

    EMBED_CACHE_MAX = 1024
    DEFAULT_DOMAIN = "default"

    def __init__(self, domain: DomainData, rps: RuntimePathSelector,
                 executor: PipelineExecutor, n_replicas: int = 2, seed: int = 0,
                 max_workers: Optional[int] = None):
        self.domain = domain
        self.rps = rps
        self.executor = executor
        self.tracker = SLOTracker()
        # domain shards: name -> (DomainData, selector, executor).  The
        # default entry aliases the attributes above.
        self._domains: "OrderedDict[str, tuple]" = OrderedDict(
            [(self.DEFAULT_DOMAIN, (domain, rps, executor))])
        self._domain_aliases: dict[str, str] = {}
        self._sharded = None  # DomainShardedSelector, built on demand
        self._domains_lock = threading.Lock()
        # per-tenant SLO trackers (non-default tenants only, so the
        # single-tenant hot path never touches this dict) + the router that
        # fronts this server, if any — both folded into system_state()
        self._tenant_trackers: dict[str, SLOTracker] = {}
        self._router = None
        # LRU memo for open-world prompt embeddings (same pattern as the
        # executor's retrieval memoization); guarded for concurrent handles
        self._embed_lock = threading.Lock()
        # prompt -> [embedding, resolved query index | None]: the index memo
        # rides in the same entry so an LRU hit skips the nearest-neighbor
        # GEMV too, not just the embedding recompute
        self._embed_cache: OrderedDict[str, list] = OrderedDict()
        self.embed_cache_hits = 0
        self.embed_cache_misses = 0

        def make_replica(rid: int) -> Replica:
            return Replica(rid=rid, execute=self._execute,
                           execute_stream=self._execute_stream)

        self.fleet = ReplicaFleet(make_replica, n=n_replicas, seed=seed,
                                  max_workers=max_workers)
        self._orchestrator: Optional[Orchestrator] = None
        self._orch_lock = threading.Lock()
        self._adaptation = None  # AdaptationPlane, enable_adaptation()

    def orchestrator(self, **kwargs) -> Orchestrator:
        """The async serving front-end bound to this server, created lazily
        (the ``handle``/``handle_batch`` shims create it with defaults, but
        their synchronous path is admission-policy-free).  Admission kwargs
        (``max_batch``, ``max_wait_ms``, ``max_queue``, ``hedge``)
        reconfigure the instance — allowed any time its admission loop is
        not running, so a warmup ``handle()`` never pins the policy."""
        with self._orch_lock:
            if self._orchestrator is None:
                self._orchestrator = Orchestrator(self, **kwargs)
                if self._adaptation is not None:
                    self._orchestrator.attach_adaptation(self._adaptation)
            elif kwargs:
                self._orchestrator.reconfigure(**kwargs)
            return self._orchestrator

    # -- online adaptation ----------------------------------------------------

    def enable_adaptation(self, *, config=None, start: bool = True, **knobs):
        """Attach an online ``AdaptationPlane`` (``runtime/adaptation.py``)
        to every admission seam of this server: the lazily-built default
        orchestrator and, when a ``TenantRouter`` fronts the server, each of
        its admission shards (the router attaches shards of a later
        ``attach_router`` call too).  ``knobs`` are ``AdaptConfig`` fields;
        ``start=False`` skips the background fold thread (deterministic
        tests drive ``plane.pump()`` by hand).  Idempotent."""
        from repro_torch.runtime.adaptation import (AdaptationPlane,
                                                    AdaptConfig)

        if self._adaptation is not None:
            return self._adaptation
        cfg = config if config is not None else AdaptConfig(**knobs)
        plane = AdaptationPlane(self, config=cfg)
        self._adaptation = plane
        with self._orch_lock:
            if self._orchestrator is not None:
                self._orchestrator.attach_adaptation(plane)
        if self._router is not None:
            for sh in self._router.shard_list():
                sh.attach_adaptation(plane)
        if start:
            plane.start()
        return plane

    @property
    def adaptation(self):
        return self._adaptation

    def notify_table_swap(self, domain: Optional[str] = None) -> None:
        """Called after a per-domain ``swap_table``: restack the
        domain-sharded fused selector (if built) so multi-domain selection
        serves the new snapshot.  The single-domain selector needs nothing —
        its swap already published atomically."""
        with self._domains_lock:
            sharded = self._sharded
        if sharded is not None:
            sharded.refresh_tables()

    # -- domain composition ---------------------------------------------------

    def add_domain(self, name: str, domain: DomainData,
                   rps: RuntimePathSelector,
                   executor: PipelineExecutor) -> None:
        """Compose another domain shard into this server.  Selection tables
        join the domain-sharded fused program (built lazily on next use);
        the domain's executor serves jobs routed to it by name."""
        if name == self.DEFAULT_DOMAIN:
            raise ValueError(f"{name!r} is reserved for the seed domain")
        with self._domains_lock:
            if name in self._domains:
                raise ValueError(f"domain {name!r} already registered")
            self._domains[name] = (domain, rps, executor)
            self._sharded = None  # force rebuild with the new shard

    def alias_default_domain(self, name: str) -> None:
        """Let the seed domain (registered as ``default``) also answer to
        its real name, so multi-domain callers can address every shard
        uniformly by domain name."""
        with self._domains_lock:
            if name in self._domains:
                raise ValueError(f"domain {name!r} already registered")
            self._domain_aliases[name] = self.DEFAULT_DOMAIN

    def canonical_domain(self, name: Optional[str]) -> str:
        """Registered shard key for a request's domain field."""
        if name is None:
            return self.DEFAULT_DOMAIN
        return self._domain_aliases.get(name, name)

    def domain_names(self) -> list[str]:
        with self._domains_lock:
            return list(self._domains)

    def is_multi_domain(self) -> bool:
        return len(self._domains) > 1

    def domain_entry(self, name: Optional[str]):
        """(DomainData, selector, executor) for ``name`` (None -> default)."""
        return self._domains[self.canonical_domain(name)]

    def sharded_selector(self):
        """The domain-sharded fused selector over every registered domain
        (``core.rps.DomainShardedSelector``), built once per composition."""
        from repro_torch.core.rps import DomainShardedSelector
        with self._domains_lock:
            if self._sharded is None:
                self._sharded = DomainShardedSelector(
                    {n: sel for n, (_, sel, _) in self._domains.items()})
            return self._sharded

    def _execute(self, job):
        query, path = job[0], job[1]
        dom = job[2] if len(job) > 2 else self.DEFAULT_DOMAIN
        return self._domains[self.canonical_domain(dom)][2].run(query, path)

    def _execute_stream(self, job, emit):
        """Streaming replica entry point: same final result as ``_execute``
        (bit-for-bit — ``run_stream``'s contract), chunks through ``emit``."""
        query, path = job[0], job[1]
        dom = job[2] if len(job) > 2 else self.DEFAULT_DOMAIN
        return self._domains[self.canonical_domain(dom)][2].run_stream(
            query, path, emit)

    def _embed_entry(self, prompt: str) -> list:
        """The mutable ``[embedding, {domain: resolved-index}]`` cache entry
        for ``prompt`` — LRU semantics and hit/miss accounting live here.
        The nearest-neighbor memo is keyed per domain: the same prompt
        resolves against each domain shard's own query set."""
        with self._embed_lock:
            ent = self._embed_cache.get(prompt)
            if ent is not None:
                self._embed_cache.move_to_end(prompt)
                self.embed_cache_hits += 1
                return ent
        ent = [embed_text(prompt), {}]
        with self._embed_lock:
            self.embed_cache_misses += 1
            ent = self._embed_cache.setdefault(prompt, ent)
            self._embed_cache.move_to_end(prompt)
            while len(self._embed_cache) > self.EMBED_CACHE_MAX:
                self._embed_cache.popitem(last=False)
        return ent

    def _embed_prompt(self, prompt: str) -> np.ndarray:
        return self._embed_entry(prompt)[0]

    def _resolve_query(self, req: Request):
        dom_name = self.canonical_domain(req.domain)
        dom = self._domains[dom_name][0]
        if req.qid is not None:
            return dom.queries[req.qid], dom.query_embeddings[req.qid]
        # open-world query: embed the raw prompt (memoized for repeats);
        # judge against the closest known query's metadata (OOD path).  The
        # nearest-neighbor index is memoized in the cache entry per domain,
        # so a repeat prompt skips the full `query_embeddings @ emb` GEMV,
        # not just the embedding recompute
        ent = self._embed_entry(req.prompt)
        qidx = ent[1].get(dom_name)
        if qidx is None:
            sims = dom.query_embeddings @ ent[0]
            qidx = int(np.argmax(sims))
            # benign race: argmax is deterministic in (prompt, domain), so a
            # racing writer stores the same value
            ent[1][dom_name] = qidx
        return dom.queries[qidx], ent[0]

    def _tenant_tracker(self, tenant: str) -> SLOTracker:
        with self._embed_lock:  # reuse: cheap, never contended with embeds
            tr = self._tenant_trackers.get(tenant)
            if tr is None:
                tr = self._tenant_trackers[tenant] = SLOTracker()
            return tr

    def _respond(self, req: Request, query, decision, result, meta) -> Response:
        acc, lat, cost = result
        self.tracker.record(req.slo, lat, cost)
        if req.tenant != DEFAULT_TENANT:
            # per-tenant violation accounting; the default single-tenant
            # path skips it entirely (no extra lock on the hot path)
            self._tenant_tracker(req.tenant).record(req.slo, lat, cost)
        return Response(
            tenant=req.tenant,
            text=f"[{decision.path.model.impl}] resolved {query.qtype} query",
            accuracy=acc,
            latency_s=lat,
            cost_usd=cost,
            path_key=decision.path.key,
            selection_overhead_s=decision.overhead_s,
            slo_ok=req.slo.ok(lat, cost),
            replica=meta["replica"],
            meta={"set_id": decision.set_id, "fallback": decision.used_fallback,
                  "attempts": meta["attempts"],
                  "batch_overhead_s": decision.batch_overhead_s,
                  "table_version": decision.table_version,
                  "hedges": meta.get("hedges", 0),
                  "requeues": meta.get("requeues", 0)},
        )

    def handle(self, req: Request) -> Response:
        """Compatibility shim (pre-orchestrator API): dispatches ``req`` as
        a bucket of one through the orchestrator's synchronous path — one
        ``select_batch`` pass of size 1, then the blocking fleet fan-out.
        New code should ``await Orchestrator.submit`` instead."""
        return self.orchestrator().dispatch_sync([req])[0]

    def handle_batch(self, reqs: list[Request]) -> list[Response]:
        """Compatibility shim (pre-orchestrator API): dispatches ``reqs`` as
        one explicit bucket through the orchestrator — one vectorized RPS
        pass, one fleet fan-out.  New code should ``await
        Orchestrator.submit`` per request and let micro-batched admission
        coalesce them."""
        if not reqs:
            return []
        return self.orchestrator().dispatch_sync(reqs)

    def system_state(self) -> dict:
        # fleet counters/gauges come from one snapshot (single lock
        # acquisition) so they are mutually consistent — field-by-field
        # reads could interleave with completions and tear the invariant
        # `counters == sum(per-request meta)`
        fleet = self.fleet.snapshot()
        with self._embed_lock:
            embed = {"hits": self.embed_cache_hits,
                     "misses": self.embed_cache_misses}
        with self._orch_lock:
            orch = self._orchestrator
        # fromkeys instead of a literal dict: can't drift from the key set
        # this method consumes below when Orchestrator.stats() grows
        admission = (orch.stats() if orch is not None else dict.fromkeys(
            ("queue_depth", "shed", "deadline_shed", "admitted", "batches"),
            0))
        state = {
            "replicas": fleet["replicas"],
            "hedges": fleet["hedges"],
            "failovers": fleet["failovers"],
            "requeues": fleet["requeues"],
            "cancelled": fleet["cancelled"],
            "queue_depth": fleet["queue_depth"],
            "in_flight": fleet["in_flight"],
            # per-shard dispatch attribution over the ONE shared fleet
            "dispatched_by_shard": fleet.get("dispatched_by_tag", {}),
            "admission_queue_depth": admission["queue_depth"],
            "shed": admission["shed"],
            "deadline_shed": admission["deadline_shed"],
            "admitted": admission["admitted"],
            "dispatch_batches": admission["batches"],
            "slo_violation_rate": self.tracker.violation_rate,
            "slo_latency_violation_rate": self.tracker.latency_violation_rate,
            "slo_cost_violation_rate": self.tracker.cost_violation_rate,
            "requests": self.tracker.total,
            "rps_engine": "kernel" if self.rps.use_kernel else "numpy",
            # times the fused embed->retrieve->score->argmax program was
            # (re)traced — bounded by distinct admission shape buckets.  On
            # a multi-domain server the domain-sharded program's traces are
            # folded in (one program serves every domain)
            "fused_traces": self.rps.kernel_trace_count
            + (self._sharded.kernel_trace_count
               if self._sharded is not None else 0),
            "embed_cache": embed,
        }
        with self._embed_lock:
            tenant_trackers = dict(self._tenant_trackers)
        if tenant_trackers:
            state["tenants"] = {
                name: {"requests": tr.total,
                       "violations": tr.violated_queries,
                       "violation_rate": tr.violation_rate}
                for name, tr in tenant_trackers.items()}
        if self._router is not None:
            # per-tenant offered/admitted/served/shed counters + per-shard
            # admission stats, folded from the router fronting this server
            state["router"] = self._router.stats()
        with self._domains_lock:
            state["table_versions"] = {
                n: sel.table_version
                for n, (_, sel, _) in self._domains.items()}
        if self._adaptation is not None:
            # online-adaptation telemetry: per-shard observed/dropped rings,
            # drift-monitor levels, sweep/swap counts
            state["adaptation"] = self._adaptation.state()
        return state
