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

``--split`` extends the path space with CE-CoLLM split-inference choices.
``--placements``, ``--adapt``, ``--tenants`` and ``--repl`` need modules
that are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import asyncio
import random

import numpy as np

from repro_torch.core.cca import critical_component_analysis
from repro_torch.core.domains import build_domain, train_test_split
from repro_torch.core.dsqe import train_dsqe
from repro_torch.core.emulator import Emulator
from repro_torch.core.paths import PathSpace, with_placements, with_split_models
from repro_torch.core.rps import RuntimePathSelector
from repro_torch.core.slo import SLO
from repro_torch.runtime.orchestrator import Overloaded
from repro_torch.runtime.server import EcoLLMServer, Request

# flags of the JAX package's serve entry point whose modules are not ported yet
_UNPORTED_FLAGS = {
    "placements": "runtime.placement (ROADMAP.md queue 1: serving runtime — "
                  "adaptation, router, placement)",
    "adapt": "runtime.adaptation (ROADMAP.md queue 1: serving runtime — "
             "adaptation, router, placement)",
    "tenants": "runtime.router (ROADMAP.md queue 1: serving runtime — "
               "adaptation, router, placement)",
    "repl": "the interactive REPL (ROADMAP.md queue 1: launch/serve.py's "
            "unported flags)",
}


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
                    help="not ported: pipelined layer-placement paths")
    ap.add_argument("--batch", action="store_true",
                    help="serve via the handle_batch shim (one selection pass)")
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="drive the held-out queries through the async "
                         "orchestrator (micro-batched admission)")
    ap.add_argument("--repl", action="store_true",
                    help="not ported: interactive REPL")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate for --async (q/s; 0 = "
                         "back-to-back)")
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--tenants", type=int, default=0,
                    help="not ported: multi-tenant router mode")
    ap.add_argument("--adapt", action="store_true",
                    help="not ported: online adaptation plane")
    args = ap.parse_args(argv)
    for flag, what in _UNPORTED_FLAGS.items():
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag} needs {what}, not ported yet")

    server, test_idx = build_server(args.domain, n_queries=args.queries,
                                    budget=args.budget, lam=int(args.latency_first),
                                    use_kernel=args.use_kernel, split=args.split,
                                    device=args.device)
    slo = SLO(max_latency_s=args.max_latency, max_cost_usd=args.max_cost)
    reqs = [Request(prompt="", qid=qid, slo=slo) for qid in test_idx]
    if args.use_async:
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
    print(f"  system state  {server.system_state()}")


if __name__ == "__main__":
    main()
