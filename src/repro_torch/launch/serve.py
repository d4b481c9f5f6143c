"""Serving driver: domain adaptation (emulate -> train runtime) + serve.

  PYTHONPATH=src python -m repro_torch.launch.serve --domain automotive \
      --queries 120 --budget 5 --max-latency 4 --max-cost 0.01 --use-kernel

Runs the full ECO-LLM lifecycle: build domain corpus, explore paths with SBA,
CCA + DSQE training, then serve the held-out queries and report accuracy /
latency / cost / SLO attainment.  The DSQE encoder and the selection tables
live on ``--device`` (default ``cuda``: there is no CPU fallback; pass
``--device cpu`` to run the plain torch versions).  Serving modes:

  * default        per-query ``handle`` loop (compatibility shim)
  * ``--batch``    one ``handle_batch`` bucket (one fused selection pass)
  * ``--async``    open-loop async driver: every query is ``submit()``ed to
                   the ``Orchestrator`` (Poisson arrivals with ``--rate``,
                   back-to-back otherwise) and micro-batched admission
                   coalesces the selection passes
  * ``--repl``     interactive open-world REPL over the orchestrator: type a
                   prompt, watch the response stream chunk-by-chunk (``async
                   for chunk in ticket``), then the timeline + SLO verdict

``--split`` extends the path space with CE-CoLLM split-inference choices
(edge drafts chunks behind a confidence gate, cloud verifies low-confidence
spans) so the selector can route draft/verify paths per query/SLO.

``--placements`` extends the path space with pipelined layer-placement
choices (``runtime/placement.py``): each (catalog model, device chain) pair
whose roofline-searched plan fits memory becomes a selectable resolution
path, and the startup banner prints every plan's stage split + predicted
latency.  Composes with ``--split``.

``--adapt`` attaches the online adaptation plane (``runtime/adaptation.py``):
served outcomes feed per-shard drift monitors and a tripped monitor
hot-swaps targeted re-explored table rows into the selector mid-run.

Multi-tenant mode (``--tenants N``, requires ``--async``): N tenants with a
Zipf(``--zipf``) popularity profile submit through the sharded
``TenantRouter`` (``--shards`` admission shards, ``--slo-class`` service
tier) instead of the bare orchestrator, and the summary breaks served/shed
out per tenant.
"""
from __future__ import annotations

import argparse
import asyncio
import random
import sys

import numpy as np

from repro_torch.core.cca import critical_component_analysis
from repro_torch.core.domains import build_domain, train_test_split
from repro_torch.core.dsqe import train_dsqe
from repro_torch.core.emulator import Emulator
from repro_torch.core.paths import PathSpace, with_placements, with_split_models
from repro_torch.core.rps import RuntimePathSelector
from repro_torch.core.slo import SLO
from repro_torch.runtime.orchestrator import Overloaded
from repro_torch.runtime.router import TenantRouter, TenantSpec
from repro_torch.runtime.server import EcoLLMServer, Request


def _spec(split: bool, placements: bool) -> dict | None:
    """Compose the opt-in path-space extensions (None = DEFAULT_SPEC)."""
    spec = with_split_models() if split else None
    if placements:
        spec = with_placements(spec)
    return spec


def build_server(domain_name: str, *, n_queries: int = 120, budget: float = 5.0,
                 lam: int = 0, seed: int = 0, n_replicas: int = 2,
                 use_kernel: bool = False, split: bool = False,
                 placements: bool = False, device="cuda"):
    dom, rps, execu, test_idx = _build_domain_shard(
        domain_name, n_queries=n_queries, budget=budget, lam=lam, seed=seed,
        split=split, placements=placements, use_kernel=use_kernel,
        device=device)
    server = EcoLLMServer(dom, rps, execu, n_replicas=n_replicas, seed=seed)
    return server, test_idx


def _build_domain_shard(domain_name: str, *, n_queries: int, budget: float,
                        lam: int, seed: int, split: bool = False,
                        placements: bool = False, use_kernel: bool = False,
                        device="cuda"):
    """One domain's (DomainData, selector, executor, test_idx) — the
    adaptation pipeline of ``build_server`` without the server."""
    dom = build_domain(domain_name, n_queries=n_queries, seed=seed)
    space = PathSpace(spec=_spec(split, placements))
    train_idx, test_idx = train_test_split(dom, 0.3)
    emu = Emulator(dom, space, seed=seed)
    table = emu.explore(train_idx, budget=budget, lam=lam)
    cca = critical_component_analysis(table, lam=lam)
    emb_train = dom.query_embeddings[train_idx]
    dsqe = train_dsqe(emb_train, cca.set_ids, len(cca.set_vocab), seed=seed,
                      device=device)
    rps = RuntimePathSelector(space, dsqe, cca, table, emb_train, lam=lam,
                              use_kernel=use_kernel)
    return dom, rps, emu.exec, test_idx


def build_multi_server(domain_names: list[str], *, n_queries: int = 120,
                       budget: float = 5.0, lam: int = 0, seed: int = 0,
                       n_replicas: int = 2, use_kernel: bool = False,
                       split: bool = False, placements: bool = False,
                       device="cuda"):
    """A multi-domain ``EcoLLMServer``: the first domain seeds the server
    (it is the ``default`` shard), the rest join via ``add_domain`` and are
    addressable by name (``Request.domain`` / ``TenantSpec.domain``).
    Returns (server, {domain_name: test_idx}) — the first domain under BOTH
    its own name and ``None``-maps-to-default semantics.  Mixed-domain
    buckets select through the domain-sharded pass; ``use_kernel`` sets
    each domain's own selector's engine."""
    if not domain_names:
        raise ValueError("need >= 1 domain")
    test_by_domain: dict[str, np.ndarray] = {}
    dom, rps, execu, test_idx = _build_domain_shard(
        domain_names[0], n_queries=n_queries, budget=budget, lam=lam,
        seed=seed, split=split, placements=placements,
        use_kernel=use_kernel, device=device)
    server = EcoLLMServer(dom, rps, execu, n_replicas=n_replicas, seed=seed)
    server.alias_default_domain(domain_names[0])
    test_by_domain[domain_names[0]] = test_idx
    for i, name in enumerate(domain_names[1:], start=1):
        dom, rps, execu, test_idx = _build_domain_shard(
            name, n_queries=n_queries, budget=budget, lam=lam,
            seed=seed + i, split=split, placements=placements,
            use_kernel=use_kernel, device=device)
        server.add_domain(name, dom, rps, execu)
        test_by_domain[name] = test_idx
    return server, test_by_domain


def zipf_shares(n: int, alpha: float = 1.1) -> np.ndarray:
    """Zipf popularity profile: share of tenant at rank i ∝ 1/(i+1)^alpha."""
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** alpha
    return w / w.sum()


async def drive_async(server: EcoLLMServer, reqs: list[Request], *,
                      max_batch: int = 32, max_wait_ms: float = 2.0,
                      rate_qps: float = 0.0, seed: int = 0):
    """Open-loop driver: submit every request through the orchestrator and
    gather (responses, shed_count, admission stats).  The admission queue is
    sized to the workload: this is a closed request list, so overflow shed
    would only reflect the driver outpacing dispatch, not real overload."""
    orch = server.orchestrator(max_batch=max_batch, max_wait_ms=max_wait_ms,
                               max_queue=max(256, len(reqs)))
    await orch.start()
    rng = random.Random(seed)
    tickets = []
    for req in reqs:
        if rate_qps > 0:
            await asyncio.sleep(rng.expovariate(rate_qps))
        tickets.append(await orch.submit(req))
    results = await asyncio.gather(*(t.wait() for t in tickets))
    await orch.stop()
    served = [r for r in results if not isinstance(r, Overloaded)]
    stats = orch.stats()
    # streamed first-chunk latency relative to dispatch, aggregated over the
    # tickets that streamed (all of them, when the orchestrator streams)
    ttfc = [t.event("first_chunk") - t.event("dispatched") for t in tickets
            if t.event("first_chunk") is not None
            and t.event("dispatched") is not None]
    stats["ttfc_mean_s"] = float(np.mean(ttfc)) if ttfc else float("nan")
    stats["streamed"] = len(ttfc)
    return served, len(results) - len(served), stats


async def drive_router_async(server: EcoLLMServer, reqs: list[Request],
                             tenants: list[TenantSpec], *, n_shards: int = 2,
                             max_batch: int = 32, max_wait_ms: float = 2.0,
                             max_queue: int = 256, rate_qps: float = 0.0,
                             seed: int = 0):
    """Multi-tenant open-loop driver: every request (pre-stamped with its
    tenant) goes through the ``TenantRouter`` front door — consistent-hash
    shard placement, SLO-class defaults, quota, and DRR fairness — instead
    of a bare orchestrator.  Returns (responses, shed, router stats)."""
    router = TenantRouter(server, tenants, n_shards=n_shards,
                          max_batch=max_batch, max_wait_ms=max_wait_ms,
                          max_queue=max_queue)
    await router.start()
    rng = random.Random(seed)
    tickets = []
    for req in reqs:
        if rate_qps > 0:
            await asyncio.sleep(rng.expovariate(rate_qps))
        tickets.append(await router.submit(req))
    results = await asyncio.gather(*(t.wait() for t in tickets))
    await router.stop()
    served = [r for r in results if not isinstance(r, Overloaded)]
    return served, len(results) - len(served), router.stats()


async def repl(server: EcoLLMServer, slo: SLO) -> None:
    """Interactive open-world serving: one orchestrator, one prompt a line."""
    orch = server.orchestrator()
    await orch.start()
    loop = asyncio.get_running_loop()
    print("eco-llm> type a prompt (blank line to exit)")
    while True:
        sys.stdout.write("eco-llm> ")
        sys.stdout.flush()
        line = await loop.run_in_executor(None, sys.stdin.readline)
        if not line or not line.strip():
            break
        ticket = await orch.submit(Request(prompt=line.strip(), slo=slo))
        # stream the response as it is generated: drafted/verified spans for
        # split paths, decode spans for whole-model paths
        async for chunk in ticket:
            print(f"  .. [{chunk.source}#{chunk.index}] {chunk.tokens} tok "
                  f"conf={chunk.confidence:.2f} t+{chunk.latency_s:.2f}s")
        resp = await ticket
        if isinstance(resp, Overloaded):
            print(f"  shed ({resp.reason}); retry later")
            continue
        t0 = ticket.events[0][1]
        timeline = " -> ".join(f"{n}+{(ts - t0) * 1e3:.1f}ms"
                               for n, ts in ticket.events)
        print(f"  {resp.text}")
        print(f"  path={resp.path_key}")
        print(f"  latency={resp.latency_s:.2f}s cost=${resp.cost_usd:.4f} "
              f"slo_ok={resp.slo_ok}  [{timeline}]")
    await orch.stop()
    print("system state:", server.system_state())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--domain", default="automotive")
    ap.add_argument("--queries", type=int, default=120)
    ap.add_argument("--budget", type=float, default=5.0)
    ap.add_argument("--latency-first", action="store_true")
    ap.add_argument("--max-latency", type=float, default=float("inf"))
    ap.add_argument("--max-cost", type=float, default=float("inf"))
    ap.add_argument("--device", default="cuda",
                    help="torch device for the encoder and selection tables")
    ap.add_argument("--use-kernel", action="store_true",
                    help="route batch selection through the fused device "
                         "pass (the retrieval_topk kernel on the card)")
    ap.add_argument("--split", action="store_true",
                    help="extend the path space with CE-CoLLM split "
                         "edge-draft/cloud-verify model configurations")
    ap.add_argument("--placements", action="store_true",
                    help="extend the path space with pipelined layer-"
                         "placement configurations (roofline-searched "
                         "stage splits across device chains)")
    ap.add_argument("--batch", action="store_true",
                    help="serve via the handle_batch shim (one selection pass)")
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="drive the held-out queries through the async "
                         "orchestrator (micro-batched admission)")
    ap.add_argument("--repl", action="store_true",
                    help="interactive open-world REPL over the orchestrator")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate for --async (q/s; 0 = "
                         "back-to-back)")
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--tenants", type=int, default=0,
                    help="multi-tenant mode (requires --async): N tenants "
                         "with Zipf traffic shares routed through the "
                         "sharded TenantRouter")
    ap.add_argument("--shards", type=int, default=2,
                    help="admission shards for --tenants")
    ap.add_argument("--slo-class", default="standard",
                    choices=("deadline", "standard", "batch"),
                    help="service tier for the generated tenants")
    ap.add_argument("--zipf", type=float, default=1.1,
                    help="Zipf exponent for the tenant popularity profile")
    ap.add_argument("--adapt", action="store_true",
                    help="enable the online adaptation plane (drift-aware "
                         "continual table updates; requires --async or "
                         "--repl — the sync shims bypass the outcome hooks)")
    ap.add_argument("--adapt-decay", type=float, default=0.05,
                    help="EWMA step for online per-path statistics")
    ap.add_argument("--adapt-viol-threshold", type=float, default=0.35,
                    help="SLO-violation rate that counts as drift")
    ap.add_argument("--adapt-interval-ms", type=float, default=50.0,
                    help="background fold/pump period")
    ap.add_argument("--adapt-sweep-queries", type=int, default=16,
                    help="query cap per targeted re-exploration sweep")
    args = ap.parse_args(argv)
    if args.tenants and not args.use_async:
        ap.error("--tenants requires --async")
    if args.adapt and not (args.use_async or args.repl):
        ap.error("--adapt requires --async or --repl")

    server, test_idx = build_server(args.domain, n_queries=args.queries,
                                    budget=args.budget, lam=int(args.latency_first),
                                    use_kernel=args.use_kernel, split=args.split,
                                    placements=args.placements,
                                    device=args.device)
    slo = SLO(max_latency_s=args.max_latency, max_cost_usd=args.max_cost)
    if args.placements:
        from repro_torch.core.paths import (DEFAULT_PLACEMENT_CHAINS,
                                            DEFAULT_PLACEMENT_MODELS)
        from repro_torch.runtime.placement import get_plan

        print("placement plans (memory-infeasible ones are pruned from the "
              "path space):")
        for m in DEFAULT_PLACEMENT_MODELS:
            for c in DEFAULT_PLACEMENT_CHAINS:
                print(f"  {get_plan(m, c).describe()}")
    if args.adapt:
        server.enable_adaptation(
            decay=args.adapt_decay,
            viol_threshold=args.adapt_viol_threshold,
            fold_interval_s=args.adapt_interval_ms / 1e3,
            max_sweep_queries=args.adapt_sweep_queries)
    if args.repl:
        try:
            asyncio.run(repl(server, slo))
        finally:
            # stop the plane's pump thread before the interpreter exits:
            # left running, it can call into CUDA during finalization
            if args.adapt:
                server.adaptation.close()
        return
    reqs = [Request(prompt="", qid=qid, slo=slo) for qid in test_idx]
    shed = 0
    if args.tenants:
        # Zipf traffic: tenant at popularity rank i sends share_i of the
        # held-out queries, all through the sharded router front door
        shares = zipf_shares(args.tenants, args.zipf)
        tenants = [TenantSpec(f"tenant{i:02d}", slo_class=args.slo_class)
                   for i in range(args.tenants)]
        rng = np.random.default_rng(0)
        for req in reqs:
            req.tenant = tenants[int(rng.choice(args.tenants, p=shares))].name
        responses, shed, rstats = asyncio.run(drive_router_async(
            server, reqs, tenants, n_shards=args.shards,
            max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
            max_queue=max(256, len(reqs)), rate_qps=args.rate))
        print(f"router: {args.shards} shards, {args.tenants} tenants "
              f"(zipf {args.zipf}), shed {shed}")
        for name, t in sorted(rstats["tenants"].items()):
            print(f"  {name}: offered {t['offered']} served {t['served']} "
                  f"shed {t['shed']} (shard {t['shard']})")
    elif args.use_async:
        responses, shed, stats = asyncio.run(drive_async(
            server, reqs, max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms, rate_qps=args.rate))
        print(f"admission: {stats['batches']} buckets, mean size "
              f"{stats['dispatched'] / max(stats['batches'], 1):.1f}, "
              f"shed {shed}, streamed {stats['streamed']} "
              f"(TTFC {stats['ttfc_mean_s'] * 1e3:.1f} ms after dispatch)")
    elif args.batch:
        responses = server.handle_batch(reqs)
    else:
        responses = [server.handle(r) for r in reqs]
    accs, lats, costs, ovh = [], [], [], []
    for resp in responses:
        accs.append(resp.accuracy)
        lats.append(resp.latency_s)
        costs.append(resp.cost_usd)
        ovh.append(resp.selection_overhead_s)
    print(f"{args.domain}: served {len(responses)}/{len(test_idx)} queries")
    print(f"  accuracy      {np.mean(accs)*100:.1f}%")
    print(f"  TTFT          {np.mean(lats):.2f}s (p95 {np.percentile(lats, 95):.2f}s)")
    print(f"  cost          ${np.mean(costs)*1000:.2f} /1k queries")
    print(f"  selection     {np.mean(ovh)*1e3:.1f} ms")
    if args.adapt:
        plane = server.adaptation
        plane.pump()  # fold the tail of the run before reporting
        plane.close()
        a = plane.state()
        print(f"  adaptation    {a['swaps']} table swap(s), "
              f"{a['sweeps']} targeted sweep(s), "
              f"{a['pending_sweeps']} pending; "
              f"table v{server.rps.table_version}")
    print(f"  system state  {server.system_state()}")


if __name__ == "__main__":
    main()
