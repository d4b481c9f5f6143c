"""Port multi-tenant serving plane (``repro_torch.runtime.router``,
``repro_torch.launch.serve.build_multi_server``) on the CPU.

The first part carries over ``tests/test_router.py`` case for case on the
port: consistent hashing with bounded reshard movement, per-domain sharded
selection parity (fused == staged == each domain's numpy selector, bucket
counts bounded by shape buckets), DRR fairness at 10:1, the quota and queue
isolation walls, and the per-tenant accounting identities.  The second part
holds the port against the JAX package on the same inputs: ring lookups,
DRR take order, and sharded decisions (fallback rows included) of
``build_multi_server(["automotive", "smarthome"], n_queries=24,
budget=2.0)`` with the JAX server's trained encoders carried across.  All
of it is exact.
"""
import asyncio

import numpy as np
import pytest
import torch

from repro.core.slo import SLO as JaxSLO
from repro.launch.serve import build_multi_server as jax_build_multi_server
from repro.runtime.router import AdmissionShard as JaxAdmissionShard
from repro.runtime.router import HashRing as JaxHashRing
from repro.runtime.server import Request as JaxRequest
from repro_torch.core.dsqe import DSQE
from repro_torch.core.rps import RuntimePathSelector, bucket_batch
from repro_torch.core.slo import SLO
from repro_torch.launch.serve import build_multi_server
from repro_torch.runtime.orchestrator import Overloaded
from repro_torch.runtime.router import (AdmissionShard, HashRing, TenantRouter,
                                        TenantSpec)
from repro_torch.runtime.server import DEFAULT_TENANT, EcoLLMServer, Request

# several xdist workers share the CPU cores: torch's default of one thread
# per core in every worker oversubscribes them and stalls every test
torch.set_num_threads(1)

DOMAINS = ["automotive", "smarthome"]


@pytest.fixture(scope="module")
def multi():
    """One 2-domain port server shared by every test; tiny build sizes."""
    return build_multi_server(DOMAINS, n_queries=24, budget=2.0, seed=0,
                              device="cpu")


@pytest.fixture(scope="module")
def jax_multi():
    return jax_build_multi_server(DOMAINS, n_queries=24, budget=2.0, seed=0)


def _same_shard_pair(n_shards: int) -> tuple[str, str]:
    """Two tenant names the ring co-locates (deterministic probe)."""
    ring = HashRing(n_shards)
    a = "tenantA"
    for i in range(10_000):
        b = f"tenantB{i:04d}"
        if ring.lookup(b) == ring.lookup(a):
            return a, b
    raise AssertionError("ring never collided")


# -- consistent hashing ------------------------------------------------------

def test_hash_ring_deterministic_and_bounded_reshard():
    """Placement depends only on (tenant, n_shards); growing the ring moves
    a bounded minority of tenants (consistent-hash property), and every
    tenant that moves lands on the NEW shard."""
    keys = [f"tenant-{i}" for i in range(1000)]
    r4a, r4b, r5 = HashRing(4), HashRing(4), HashRing(5)
    assert [r4a.lookup(k) for k in keys] == [r4b.lookup(k) for k in keys]
    moved = [k for k in keys if r4a.lookup(k) != r5.lookup(k)]
    # ideal movement is 1/5 of keys; vnode variance gives it slack
    assert 0 < len(moved) < 450
    assert all(r5.lookup(k) == 4 for k in moved)


def test_router_places_all_of_a_tenants_traffic_on_one_shard(multi):
    server, tests = multi
    router = TenantRouter(server, [TenantSpec("acme")], n_shards=4)
    idx = router.shard_index("acme")
    assert router.shard_for("acme") is router.shards[idx]
    assert all(router.shard_index("acme") == idx for _ in range(10))


# -- per-domain sharded selection --------------------------------------------

def _keyed(d):
    return (d.path.key, d.set_id, d.used_fallback)


def test_sharded_selection_parity_including_fallback(multi):
    """Fused sharded program == staged pipeline == each domain's own numpy
    selector, decision-for-decision, feasible and infeasible-SLO rows."""
    server, tests = multi
    sh = server.sharded_selector()
    for name, idx in tests.items():
        dom, rps, _ = server.domain_entry(name)
        canon = server.canonical_domain(name)
        embs = dom.query_embeddings[idx]
        for slos in ([SLO()] * len(idx),
                     [SLO(max_latency_s=1e-9, max_cost_usd=1e-12)] * len(idx)):
            base = rps.select_batch(embs, slos)
            fused = sh.select_batch(embs, slos, canon)
            staged = sh.select_batch_staged(embs, slos, canon)
            assert [_keyed(d) for d in base] \
                == [_keyed(d) for d in fused] \
                == [_keyed(d) for d in staged]


def test_sharded_traces_bounded_by_shape_buckets_not_domains(multi):
    """All domains share every bucket: the domain id is a scalar carried in
    the pass, so the bucket count tracks distinct batch-shape buckets
    only (``kernel_trace_count``, the JAX package's jit traces)."""
    server, tests = multi
    sh = server.sharded_selector()
    t0 = sh.kernel_trace_count
    sizes_by_dom = {name: [3, 5, 7] for name in tests}  # one bucket (8)
    buckets = set()
    for name, sizes in sizes_by_dom.items():
        dom = server.domain_entry(name)[0]
        canon = server.canonical_domain(name)
        base = dom.query_embeddings[tests[name]]
        for B in sizes:
            embs = np.tile(base, (B // len(base) + 1, 1))[:B]
            sh.select_batch(embs, [SLO()] * B, canon)
            buckets.add(bucket_batch(B))
    new = sh.kernel_trace_count - t0
    assert new <= len(buckets), \
        f"{new} new buckets for {len(buckets)} shape buckets"


# -- DRR fairness ------------------------------------------------------------

def _preloaded_shard(server, weights, backlog, max_queue=512):
    """An un-started shard with each tenant's queue pre-filled."""
    shard = AdmissionShard(server, shard_id=0, tenant_weights=weights,
                           max_queue=max_queue)

    async def fill():
        for tenant, n in backlog.items():
            for _ in range(n):
                await shard.submit(Request(prompt="", qid=0, tenant=tenant))

    asyncio.run(fill())
    return shard


def test_drr_converges_to_10_to_1_weight_ratio(multi):
    server, _ = multi
    shard = _preloaded_shard(server, {"heavy": 10.0, "light": 1.0},
                             {"heavy": 200, "light": 40})
    served = {"heavy": 0, "light": 0}
    # while BOTH tenants stay backlogged, the served ratio is the weights'
    while shard._tq["light"] and shard._tq["heavy"]:
        for t in shard._drr_take(22):  # >= weight sum: one full rotation
            served[t.request.tenant] += 1
    assert served["light"] > 0
    ratio = served["heavy"] / served["light"]
    assert ratio == pytest.approx(10.0, rel=0.15), served


def test_drr_small_buckets_do_not_starve_light_tenants(multi):
    """A heavy tenant whose quantum alone fills max_batch must not
    monopolise every bucket: the rotation pointer persists across buckets,
    so the light tenant is drained within the first two buckets."""
    server, _ = multi
    shard = _preloaded_shard(server, {"heavy": 10.0, "light": 1.0},
                             {"heavy": 100, "light": 5})
    first = [t.request.tenant for t in shard._drr_take(10)]
    second = [t.request.tenant for t in shard._drr_take(10)]
    assert "light" in first + second, (first, second)


def test_drr_bucket_ordered_by_priority(multi):
    """The formed bucket heads its highest-priority (deadline-class)
    tickets, FIFO within a priority — the fleet fan-out preserves this
    order into the per-replica queues."""
    server, _ = multi
    shard = AdmissionShard(server, shard_id=0, max_queue=64)

    async def fill():
        for prio in (0, 2, 0, 2, 1, 0):
            await shard.submit(Request(prompt="", qid=0, tenant="t"),
                               priority=prio)

    asyncio.run(fill())
    prios = [t.priority for t in shard._drr_take(6)]
    assert prios == sorted(prios, reverse=True)


def test_drr_idle_tenant_banks_no_credit(multi):
    server, _ = multi
    shard = _preloaded_shard(server, {"a": 5.0, "b": 1.0},
                             {"a": 10, "b": 10})
    while any(shard._tq.values()):
        shard._drr_take(8)
    assert all(d == 0.0 for d in shard._deficit.values())


# -- isolation walls ---------------------------------------------------------

def test_quota_sheds_before_the_shard_with_typed_reason(multi):
    server, tests = multi
    qid = int(tests[DOMAINS[0]][0])
    router = TenantRouter(
        server, [TenantSpec("metered", rate_qps=1e-9, burst=2.0,
                            domain=DOMAINS[0])], n_shards=2)

    async def flood():
        return [await router.submit(Request(prompt="", qid=qid,
                                            tenant="metered"))
                for _ in range(10)]

    tickets = asyncio.run(flood())
    shed = [t for t in tickets if t.shed]
    assert len(shed) == 8  # burst of 2 admitted, the rest refused at the door
    results = [t._future.result() for t in shed]
    assert all(isinstance(r, Overloaded) and r.reason == "quota"
               for r in results)
    st = router.stats()["tenants"]["metered"]
    assert st["offered"] == 10 and st["admitted"] == 2 and st["shed"] == 8
    assert st["shed_reasons"] == {"quota": 8}


def test_saturating_tenant_sheds_only_itself(multi):
    """One tenant floods past its own queue bound on the SAME shard as a
    deadline-class tenant; only the flooder sheds (queue_full), the
    deadline tenant's under-quota traffic all serves."""
    server, tests = multi
    victim, flooder = _same_shard_pair(n_shards=2)
    specs = [TenantSpec(victim, slo_class="deadline", domain=DOMAINS[0]),
             TenantSpec(flooder, slo_class="standard", domain=DOMAINS[1])]
    router = TenantRouter(server, specs, n_shards=2, max_batch=8,
                          max_wait_ms=1.0, max_queue=8, hedge=False)
    vic_q = [int(q) for q in tests[DOMAINS[0]][:6]]
    flood_q = [int(tests[DOMAINS[1]][i % len(tests[DOMAINS[1]])])
               for i in range(40)]

    async def main():
        # pre-start floods land in the shard queues un-drained, so the
        # flooder overflows its own bound while the victim's queue is free
        flood = [await router.submit(Request(prompt="", qid=q,
                                             tenant=flooder))
                 for q in flood_q]
        vic = [await router.submit(Request(prompt="", qid=q, tenant=victim))
               for q in vic_q]
        async with router:
            await asyncio.gather(*(t.wait() for t in flood + vic))
        return flood, vic

    flood, vic = asyncio.run(main())
    assert not any(t.shed for t in vic), "victim traffic was shed"
    stats = router.stats()["tenants"]
    vs, fs = stats[victim], stats[flooder]
    assert vs["shed"] == 0 and vs["served"] == len(vic_q)
    assert fs["shed"] == len(flood_q) - 8  # its own max_queue bound
    assert fs["shed_reasons"] == {"queue_full": len(flood_q) - 8}
    for st in (vs, fs):
        assert st["offered"] == st["admitted"] + st["shed"]
        assert st["admitted"] == st["served"] + st["failed"]


# -- router front door -------------------------------------------------------

def test_slo_class_defaults_stamped_on_requests(multi):
    server, tests = multi
    router = TenantRouter(
        server, [TenantSpec("pager", slo_class="deadline",
                            domain=DOMAINS[0])], n_shards=1)
    req = Request(prompt="", qid=int(tests[DOMAINS[0]][0]), tenant="pager")

    async def submit():
        return await router.submit(req)

    t = asyncio.run(submit())
    assert req.slo_class == "deadline"
    assert req.domain == DOMAINS[0]
    assert req.slo == router.classes["deadline"].slo
    assert t.priority == router.classes["deadline"].priority
    assert t.deadline_s == router.classes["deadline"].deadline_s


def test_unknown_slo_class_rejected(multi):
    server, _ = multi
    with pytest.raises(ValueError, match="unknown SLO class"):
        TenantRouter(server, [TenantSpec("x", slo_class="platinum")])


def test_default_tenant_flows_through_router(multi):
    """Requests that never name a tenant ride DEFAULT_TENANT with standard
    class defaults — no spec required."""
    server, tests = multi
    router = TenantRouter(server, [], n_shards=2, max_batch=4,
                          max_wait_ms=1.0, hedge=False)
    qids = [int(q) for q in tests[DOMAINS[0]][:4]]

    async def main():
        async with router:
            ts = [await router.submit(Request(prompt="", qid=q))
                  for q in qids]
            return await asyncio.gather(*(t.wait() for t in ts))

    resps = asyncio.run(main())
    assert all(not isinstance(r, Overloaded) for r in resps)
    st = router.stats()["tenants"][DEFAULT_TENANT]
    assert st["offered"] == st["served"] == len(qids)


def test_system_state_reports_router_and_shard_attribution(multi):
    server, tests = multi
    router = TenantRouter(server, [TenantSpec("acme", domain=DOMAINS[1])],
                          n_shards=2, max_batch=4, max_wait_ms=1.0,
                          hedge=False)
    qids = [int(q) for q in tests[DOMAINS[1]][:5]]
    shard_tag = f"shard{router.shard_index('acme')}"
    # the fleet is shared module-wide: earlier tests' tagged dispatches
    # persist, so attribute by delta
    before = server.system_state()["dispatched_by_shard"].get(shard_tag, 0)

    async def main():
        async with router:
            ts = [await router.submit(Request(prompt="", qid=q,
                                              tenant="acme"))
                  for q in qids]
            await asyncio.gather(*(t.wait() for t in ts))

    asyncio.run(main())
    state = server.system_state()
    rt = state["router"]
    assert rt["n_shards"] == 2
    assert rt["tenants"]["acme"]["served"] == len(qids)
    assert rt["tenants"]["acme"]["shard"] == router.shard_index("acme")
    assert state["dispatched_by_shard"][shard_tag] - before == len(qids)


def test_shard_reconfigure_carries_best_per_tenant(multi):
    """Shrinking max_queue keeps each tenant's best (highest-priority,
    earliest) tickets and sheds ONLY that tenant's overflow."""
    server, _ = multi
    shard = AdmissionShard(server, shard_id=0, max_queue=8)

    async def fill():
        out = {"a": [], "b": []}
        for tenant in ("a", "b"):
            for i in range(8):
                out[tenant].append(await shard.submit(
                    Request(prompt="", qid=0, tenant=tenant),
                    priority=i % 2))
        return out

    tickets = asyncio.run(fill())
    shard.reconfigure(max_queue=4)
    for tenant in ("a", "b"):
        kept = [e[2] for e in shard._tq[tenant]]
        assert len(kept) == 4
        assert all(t.priority == 1 for t in kept)  # best survive
        shed = [t for t in tickets[tenant] if t.shed]
        assert len(shed) == 4
        assert all(t.priority == 0 for t in shed)
    st = shard.stats()["tenants"]
    assert st["a"]["shed"] == st["b"]["shed"] == 4


# -- the port against the JAX package ----------------------------------------

@pytest.mark.parametrize("n_shards", range(1, 9))
def test_hash_ring_lookups_equal_jax(n_shards):
    keys = [f"tenant-{i}" for i in range(1000)]
    ring, jring = HashRing(n_shards), JaxHashRing(n_shards)
    assert ring._hashes == jring._hashes and ring._shards == jring._shards
    assert [ring.lookup(k) for k in keys] == [jring.lookup(k) for k in keys]


DRR_CASES = {
    "10_to_1": ({"heavy": 10.0, "light": 1.0}, {"heavy": 60, "light": 12},
                10),
    "fractional": ({"a": 0.25, "b": 1.0, "c": 4.0},
                   {"a": 9, "b": 14, "c": 30}, 7),
    "unweighted": ({}, {"x": 5, "y": 11, "z": 3}, 4),
}


@pytest.mark.parametrize("case", sorted(DRR_CASES))
def test_drr_take_order_equals_jax(case, multi, jax_multi):
    """The same per-tenant queues (priorities cycling 0..2) drain in the
    same ticket order, bucket by bucket, with the same deficits."""
    weights, backlog, n = DRR_CASES[case]

    def drain(server, shard_cls, request_cls):
        shard = shard_cls(server, shard_id=0, tenant_weights=weights,
                          max_queue=512)

        async def fill():
            i = 0
            for tenant, count in backlog.items():
                for _ in range(count):
                    await shard.submit(request_cls(prompt="", qid=i,
                                                   tenant=tenant),
                                       priority=i % 3)
                    i += 1

        asyncio.run(fill())
        order = []
        while any(shard._tq.values()):
            order.append([(t.request.tenant, t.request.qid, t.priority)
                          for t in shard._drr_take(n)])
            order.append(dict(shard._deficit))
        return order

    got = drain(multi[0], AdmissionShard, Request)
    want = drain(jax_multi[0], JaxAdmissionShard, JaxRequest)
    assert got == want


PARITY_SLOS = ({}, {"max_latency_s": 2.0, "max_cost_usd": 0.004},
               {"max_latency_s": 1e-9, "max_cost_usd": 1e-12})


@pytest.fixture(scope="module")
def carried(multi, jax_multi):
    """The port's ``build_multi_server`` domains with each JAX domain's
    trained encoder carried across (the two packages train on different
    random streams).  ``build_multi_server`` builds the same held-out
    split, tables and CCA labels as the JAX package's."""
    server, tests = multi
    jserver, jtests = jax_multi
    assert list(tests) == list(jtests)
    out = None
    for name in DOMAINS:
        np.testing.assert_array_equal(tests[name], jtests[name])
        dom, sel, ex = server.domain_entry(name)
        jsel = jserver.domain_entry(name)[1]
        assert sel.table.bit_equal(jsel.table)
        np.testing.assert_array_equal(sel.cca.set_ids, jsel.cca.set_ids)
        rps = RuntimePathSelector(
            sel.space, DSQE.from_numpy(jsel.dsqe.params, jsel.dsqe.n_sets,
                                       device="cpu"),
            sel.cca, sel.table, sel._train_embeddings, lam=sel.lam)
        if out is None:
            out = EcoLLMServer(dom, rps, ex, n_replicas=1)
            out.alias_default_domain(name)
        else:
            out.add_domain(name, dom, rps, ex)
    yield out
    out.fleet.close()


def test_single_select_equals_jax_per_domain(multi, jax_multi, carried):
    """Each domain's own selector, one query at a time (the numpy engine),
    decides as the JAX domain's does on every held-out query and SLO."""
    server, tests = multi
    jserver = jax_multi[0]
    for name in DOMAINS:
        sel = carried.domain_entry(name)[1]
        jsel = jserver.domain_entry(name)[1]
        embs = server.domain_entry(name)[0].query_embeddings[tests[name]]
        for args in PARITY_SLOS:
            for e in embs:
                got = sel.select(e, SLO(**args))
                want = jsel.select(e, JaxSLO(**args))
                assert (_keyed(got), got.expected_latency_s) == \
                    (_keyed(want), want.expected_latency_s)


def test_sharded_decisions_equal_jax(multi, jax_multi, carried):
    """With the encoders carried across, the port's sharded pass decides
    every row of ``build_multi_server(["automotive", "smarthome"])`` as the
    JAX sharded pass does, feasible and fallback rows alike."""
    server, tests = multi
    jserver = jax_multi[0]
    sh, jsh = carried.sharded_selector(), jserver.sharded_selector()
    rows = 0
    for name in DOMAINS:
        canon = carried.canonical_domain(name)
        embs = server.domain_entry(name)[0].query_embeddings[tests[name]]
        for args in PARITY_SLOS:
            got = sh.select_batch(embs, [SLO(**args)] * len(embs), canon)
            want = jsh.select_batch(embs, [JaxSLO(**args)] * len(embs),
                                    jserver.canonical_domain(name))
            assert [(_keyed(d), d.expected_latency_s, d.expected_cost_usd)
                    for d in got] == \
                [(_keyed(d), d.expected_latency_s, d.expected_cost_usd)
                 for d in want]
            rows += sum(d.used_fallback for d in got)
    assert rows > 0  # the impossible SLO rows took the fallback
