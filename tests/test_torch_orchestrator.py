"""Async serving front-end of the port (``repro_torch.runtime.orchestrator``),
case by case with ``tests/test_orchestrator.py``, and against the JAX
package.

Each case runs the reference case's scenario on the port's server and
holds it to the reference case's assertions.  Both servers are built on
one DSQE, trained by the JAX package and carried across
(``tests/carried_server.py``); where the reference case pins an outcome
(a served response, a shed reason, a pass's batch size, an admission
counter), the same scenario runs on the JAX server too and the port's
outcome must equal it.  Deadline flushes, tight submit loops and
event-loop rebinding depend on the clock and the loop: those cases hold
the reference case's own assertions only.
"""
import asyncio
import contextlib
import time
from types import SimpleNamespace

import pytest
import torch

from carried_server import carried_servers
from repro.core.slo import SLO as JaxSLO
from repro.runtime.orchestrator import Orchestrator as JaxOrchestrator
from repro.runtime.orchestrator import Overloaded as JaxOverloaded
from repro.runtime.server import Request as JaxRequest
from repro.runtime.server import Response as JaxResponse
from repro_torch.core.slo import SLO
from repro_torch.runtime.orchestrator import Orchestrator, Overloaded
from repro_torch.runtime.server import Request, Response

torch.set_num_threads(1)

PORT = SimpleNamespace(SLO=SLO, Request=Request, Response=Response,
                       Orchestrator=Orchestrator, Overloaded=Overloaded)
JAX = SimpleNamespace(SLO=JaxSLO, Request=JaxRequest, Response=JaxResponse,
                      Orchestrator=JaxOrchestrator, Overloaded=JaxOverloaded)
MIXED_SLOS = [
    {},
    {"max_latency_s": 2.0, "max_cost_usd": 0.004},
    {"max_latency_s": 1e-6, "max_cost_usd": 0.0},  # impossible -> fallback
    {"max_latency_s": 4.0, "max_cost_usd": 0.008},
]


@pytest.fixture(scope="module")
def served():
    jserver, server, test_idx = carried_servers()
    yield server, test_idx, jserver
    server.fleet.close()
    jserver.fleet.close()


@contextlib.contextmanager
def counting_selector(server):
    """Wrap `select_batch` to record the batch size of every pass."""
    calls = []
    orig = server.rps.select_batch

    def counting(embs, slos):
        calls.append(len(embs))
        return orig(embs, slos)

    server.rps.select_batch = counting
    try:
        yield calls
    finally:
        server.rps.select_batch = orig


def _reqs(ns, test_idx, n, slos=None):
    slos = slos or [MIXED_SLOS[i % len(MIXED_SLOS)] for i in range(n)]
    return [ns.Request(prompt="", qid=q, slo=ns.SLO(**s))
            for q, s in zip(test_idx[:n], slos)]


def _key(r):
    """A served response's outcome, or a shed one's reason."""
    if hasattr(r, "path_key"):
        return (r.path_key, r.accuracy, r.latency_s, r.cost_usd, r.slo_ok,
                r.meta["set_id"], r.meta["fallback"])
    return ("shed", r.reason, r.queue_depth, r.max_queue)


def _both(scenario, served):
    """``scenario(ns, server, test_idx)`` on the port's server and on the
    JAX package's."""
    server, test_idx, jserver = served
    return scenario(PORT, server, test_idx), scenario(JAX, jserver, test_idx)


def _mixed(ns, server, test_idx):
    reqs = _reqs(ns, test_idx, 8)

    async def main():
        async with ns.Orchestrator(server, max_batch=8, max_wait_ms=20) as orch:
            tickets = [await orch.submit(r) for r in reqs]
            resps = await asyncio.gather(*(t.wait() for t in tickets))
        return reqs, tickets, resps

    return asyncio.run(main())


def test_submit_awaitable_mixed_slos_and_events(served):
    """Awaitable submit serves mixed per-request SLOs (fallback rows
    included) and every ticket carries the full lifecycle timeline with
    monotone timestamps and both selection-overhead figures."""
    (reqs, tickets, resps), (_, _, jresps) = _both(_mixed, served)
    assert all(isinstance(r, Response) for r in resps)
    assert {r.meta["fallback"] for r in resps} == {True, False}
    for req, resp in zip(reqs, resps):
        assert resp.slo_ok == req.slo.ok(resp.latency_s, resp.cost_usd)
        assert resp.meta["batch_overhead_s"] >= resp.selection_overhead_s > 0
    for t in tickets:
        names = [n for n, _ in t.events]
        assert names == ["admitted", "selected", "dispatched", "first_chunk",
                         "completed"]
        stamps = [ts for _, ts in t.events]
        assert stamps == sorted(stamps)
    assert [_key(r) for r in resps] == [_key(r) for r in jresps]


def _coalesce(ns, server, test_idx):
    reqs = _reqs(ns, test_idx, 6)

    async def main():
        async with ns.Orchestrator(server, max_batch=16, max_wait_ms=50) as orch:
            tickets = [await orch.submit(r) for r in reqs]
            resps = await asyncio.gather(*(t.wait() for t in tickets))
            stats = orch.stats()
        return resps, stats

    with counting_selector(server) as calls:
        resps, stats = asyncio.run(main())
    return calls, resps, stats


def test_microbatch_coalescing_one_select_pass(served):
    """N concurrent submits inside one admission window coalesce into ONE
    fused select_batch call (and one fleet fan-out)."""
    (calls, resps, stats), (jcalls, jresps, jstats) = _both(_coalesce, served)
    assert calls == [6]  # one pass for the whole bucket
    assert stats["batches"] == 1 and stats["dispatched"] == 6
    assert all(isinstance(r, Response) for r in resps)
    assert calls == jcalls
    assert (stats["batches"], stats["dispatched"]) == \
        (jstats["batches"], jstats["dispatched"])
    assert [_key(r) for r in resps] == [_key(r) for r in jresps]


def _backpressure(ns, server, test_idx):
    reqs = _reqs(ns, test_idx, 6, slos=[{}] * 6)

    async def main():
        orch = ns.Orchestrator(server, max_batch=8, max_wait_ms=1, max_queue=4)
        # not started: the queue can only fill
        tickets = [await orch.submit(r) for r in reqs]
        shed = [t for t in tickets if t.done()]
        await orch.start()
        results = await asyncio.gather(*(t.wait() for t in tickets))
        await orch.stop()
        return tickets, shed, results, orch.stats()

    return asyncio.run(main())


def test_backpressure_sheds_with_typed_overloaded(served):
    """The admission queue is bounded: overflow comes back immediately as a
    typed Overloaded result (reason=queue_full), admitted tickets still
    complete once the loop starts."""
    (tickets, shed, results, stats), (_, _, jresults, jstats) = _both(
        _backpressure, served)
    assert len(shed) == 2 and all(t.shed for t in shed)
    for t in shed:
        r = t._future.result()
        assert isinstance(r, Overloaded) and r.reason == "queue_full"
        assert r.max_queue == 4
        assert [n for n, _ in t.events] == ["shed"]
    served_ok = [r for r in results if isinstance(r, Response)]
    assert len(served_ok) == 4  # everything admitted was served
    assert stats["shed"] == 2 and stats["admitted"] == 4
    assert stats["completed"] == 4 and stats["queue_depth"] == 0
    assert [_key(r) for r in results] == [_key(r) for r in jresults]
    for k in ("shed", "admitted", "completed", "queue_depth"):
        assert stats[k] == jstats[k], k


def test_tight_submit_loop_interleaves_with_dispatch(served):
    """submit() yields to the admission loop once per admission, so a tight
    submit loop drains concurrently with dispatch: more requests than
    max_queue get served.  What accumulates past the bound during a
    dispatch is still shed, typed."""
    server, test_idx, _ = served
    n, max_queue = 300, 64

    async def main():
        async with Orchestrator(server, max_batch=32, max_wait_ms=1,
                                max_queue=max_queue) as orch:
            tickets = []
            for i in range(n):  # no manual sleep(0) pacing
                tickets.append(await orch.submit(Request(
                    prompt="", qid=test_idx[i % len(test_idx)], slo=SLO())))
            return await asyncio.gather(*(t.wait() for t in tickets))

    results = asyncio.run(main())
    served_n = sum(isinstance(r, Response) for r in results)
    shed_n = sum(isinstance(r, Overloaded) for r in results)
    assert served_n + shed_n == n  # nothing lost or hung
    assert served_n > max_queue  # admission drained during the tight loop
    assert all(r.reason == "queue_full" for r in results
               if isinstance(r, Overloaded))


def test_deadline_flush_at_max_wait(served):
    """A partial bucket (fewer than max_batch submissions) is flushed once
    max_wait_ms elapses — it must not wait for the bucket to fill."""
    server, test_idx, _ = served
    reqs = _reqs(PORT, test_idx, 2, slos=[{}] * 2)

    async def main():
        async with Orchestrator(server, max_batch=64, max_wait_ms=40) as orch:
            t0 = time.perf_counter()
            tickets = [await orch.submit(r) for r in reqs]
            resps = await asyncio.gather(*(t.wait() for t in tickets))
            elapsed = time.perf_counter() - t0
        return resps, elapsed

    with counting_selector(server) as calls:
        resps, elapsed = asyncio.run(main())
    assert calls == [2]  # still coalesced, still one pass
    assert all(isinstance(r, Response) for r in resps)
    assert 0.03 <= elapsed < 5.0  # held ~max_wait_ms, then flushed


def test_per_request_deadline_sheds_before_dispatch(served):
    """A ticket whose admission deadline lapses before its bucket dispatches
    is shed with reason=deadline, not silently served late."""
    server, test_idx, _ = served

    async def main():
        orch = Orchestrator(server, max_batch=8, max_wait_ms=1)
        t = await orch.submit(Request(prompt="", qid=test_idx[0], slo=SLO()),
                              deadline_s=0.0)
        await asyncio.sleep(0.02)  # deadline lapses while loop is not running
        await orch.start()
        result = await t
        await orch.stop()
        return t, result, orch.stats()

    t, result, stats = asyncio.run(main())
    assert isinstance(result, Overloaded) and result.reason == "deadline"
    assert t.shed and stats["deadline_shed"] == 1
    assert [n for n, _ in t.events] == ["admitted", "shed"]


def _priority(ns, server, test_idx):
    async def main():
        orch = ns.Orchestrator(server, max_batch=1, max_wait_ms=0)
        lo = await orch.submit(ns.Request(prompt="", qid=test_idx[0],
                                          slo=ns.SLO()), priority=0)
        hi = await orch.submit(ns.Request(prompt="", qid=test_idx[1],
                                          slo=ns.SLO()), priority=5)
        await orch.start()
        resps = await asyncio.gather(lo.wait(), hi.wait())
        await orch.stop()
        return lo, hi, resps

    return asyncio.run(main())


def test_priority_orders_admission_under_backlog(served):
    """With a backlog (loop not yet running) higher-priority tickets are
    dispatched first regardless of submission order."""
    (lo, hi, resps), (_, _, jresps) = _both(_priority, served)
    assert hi.event("selected") < lo.event("selected")
    assert [_key(r) for r in resps] == [_key(r) for r in jresps]


def test_dispatch_failure_fails_tickets_but_loop_survives(served):
    """An exception inside a bucket's dispatch fails THOSE tickets (awaiting
    re-raises) — it must not kill the admission loop and hang later ones."""
    server, test_idx, jserver = served

    async def main():
        orch = Orchestrator(server, max_batch=4, max_wait_ms=5)
        boom = RuntimeError("selector exploded")
        orig = server.rps.select_batch

        def failing(embs, slos):
            raise boom

        await orch.start()
        server.rps.select_batch = failing
        try:
            bad = await orch.submit(
                Request(prompt="", qid=test_idx[0], slo=SLO()))
            with pytest.raises(RuntimeError, match="selector exploded"):
                await bad
        finally:
            server.rps.select_batch = orig
        assert [n for n, _ in bad.events][-1] == "failed"
        good = await orch.submit(
            Request(prompt="", qid=test_idx[1], slo=SLO()))
        resp = await good
        await orch.stop()
        return resp

    resp = asyncio.run(main())
    assert isinstance(resp, Response)
    assert _key(resp) == _key(jserver.handle(
        JaxRequest(prompt="", qid=test_idx[1], slo=JaxSLO())))


def test_shim_then_reconfigure_admission_policy(served):
    """A warmup handle() (which lazily creates the shared orchestrator) must
    not pin the admission policy: kwargs reconfigure an idle instance."""
    server, test_idx, _ = served
    server.handle(Request(prompt="", qid=test_idx[0], slo=SLO()))
    orch = server.orchestrator(max_batch=64, max_wait_ms=7.0)
    assert orch is server.orchestrator()
    assert orch.max_batch == 64 and orch.max_wait_s == pytest.approx(0.007)

    async def main():
        await orch.start()
        with pytest.raises(RuntimeError, match="running admission loop"):
            orch.reconfigure(max_batch=8)
        t = await orch.submit(Request(prompt="", qid=test_idx[0], slo=SLO()))
        resp = await t
        await orch.stop()
        return resp

    assert isinstance(asyncio.run(main()), Response)
    orch.reconfigure(max_batch=16)  # stopped again: allowed
    assert orch.max_batch == 16


def _after_stop(ns, server, test_idx):
    async def main(start_first):
        orch = ns.Orchestrator(server)
        if start_first:
            await orch.start()
        await orch.stop()
        t = await orch.submit(ns.Request(prompt="", qid=test_idx[0],
                                         slo=ns.SLO()))
        return await asyncio.wait_for(t.wait(), timeout=10)

    return [asyncio.run(main(s)) for s in (True, False)]


def test_submit_after_stop_is_shed(served):
    """Submits after stop() shed with reason 'shutdown' — including when
    stop() ran before start() ever did (cleanup-path regression)."""
    results, jresults = _both(_after_stop, served)
    for result in results:
        assert isinstance(result, Overloaded) and result.reason == "shutdown"
    assert [_key(r) for r in results] == [_key(r) for r in jresults]


def _pre_redesign(ns, server, test_idx):
    reqs = _reqs(ns, test_idx, 8)
    ref = []
    for req in reqs:
        query, emb = server._resolve_query(req)
        d = server.rps.select(emb, req.slo)
        acc, lat, cost = server.executor.run(query, d.path)
        ref.append((d.path.key, acc, lat, cost, req.slo.ok(lat, cost),
                    d.set_id, d.used_fallback))
    return reqs, ref


def test_shim_parity_with_pre_redesign_path(served):
    """handle/handle_batch through the orchestrator return bit-for-bit the
    same Response fields as the pre-redesign path: per-query `select` (the
    old handle body) + deterministic executor run — which is the JAX
    package's, row for row."""
    (reqs, ref), (_, jref) = _both(_pre_redesign, served)
    assert ref == jref
    server = served[0]
    for responses in (server.handle_batch(reqs),
                      [server.handle(r) for r in reqs]):
        for r, (key, acc, lat, cost, ok, set_id, fb) in zip(responses, ref):
            assert r.path_key == key
            assert r.accuracy == acc
            assert r.latency_s == lat
            assert r.cost_usd == cost
            assert r.slo_ok == ok
            assert r.meta["set_id"] == set_id
            assert r.meta["fallback"] == fb
            assert "batch_overhead_s" in r.meta  # singles are a batch of 1


def test_concurrent_stop_leaves_no_stale_sentinel(served):
    """Racing stop() calls enqueue exactly one stop sentinel; a later
    start() must serve normally instead of exiting on a leftover sentinel
    and hanging every subsequent ticket (regression)."""
    server, test_idx, _ = served

    async def main():
        orch = Orchestrator(server, max_batch=4, max_wait_ms=1)
        await orch.start()
        await asyncio.gather(orch.stop(), orch.stop())
        await orch.start()
        t = await orch.submit(Request(prompt="", qid=test_idx[0], slo=SLO()))
        resp = await asyncio.wait_for(t.wait(), timeout=10)
        await orch.stop()
        return resp

    assert isinstance(asyncio.run(main()), Response)


def test_orchestrator_survives_successive_event_loops(served):
    """The server-singleton orchestrator is reused across asyncio.run
    sessions: the admission queue must rebind to the new loop instead of
    killing the admission task and hanging every ticket (regression)."""
    server, test_idx, _ = served
    orch = server.orchestrator()

    async def session(qid):
        await orch.start()
        t = await orch.submit(Request(prompt="", qid=qid, slo=SLO()))
        resp = await asyncio.wait_for(t.wait(), timeout=10)
        await orch.stop()
        return resp

    first = asyncio.run(session(test_idx[0]))
    second = asyncio.run(session(test_idx[1]))  # fresh loop, same orchestrator
    assert isinstance(first, Response) and isinstance(second, Response)


def test_stale_loop_tickets_shed_on_rebind(served):
    """A ticket submitted in a session that ended before the loop ever
    started cannot be awaited by anyone anymore; the next session's start()
    sheds it (stale_loop) instead of dispatching into a dead future."""
    server, test_idx, _ = served
    orch = Orchestrator(server, max_batch=4, max_wait_ms=1)

    async def session_a():
        return await orch.submit(
            Request(prompt="", qid=test_idx[0], slo=SLO()))

    stale = asyncio.run(session_a())  # loop A closes with the ticket queued

    async def session_b():
        await orch.start()
        t = await orch.submit(Request(prompt="", qid=test_idx[1], slo=SLO()))
        resp = await asyncio.wait_for(t.wait(), timeout=10)
        await orch.stop()
        return resp

    resp = asyncio.run(session_b())
    assert isinstance(resp, Response)  # the new session serves normally
    assert [n for n, _ in stale.events][-1] == "shed"
    assert orch.stats()["shed"] >= 1


def _sync_failure(ns, server, test_idx):
    orch = server.orchestrator()
    before = orch.stats()
    orig = server.rps.select_batch

    def failing(embs, slos):
        raise RuntimeError("selector exploded")

    server.rps.select_batch = failing
    try:
        with pytest.raises(RuntimeError, match="selector exploded"):
            server.handle(ns.Request(prompt="", qid=test_idx[0], slo=ns.SLO()))
    finally:
        server.rps.select_batch = orig
    after = orch.stats()
    return before, after


def test_dispatch_sync_failure_keeps_counter_invariant(served):
    """A shim dispatch that raises still satisfies
    completed + failed == dispatched, matching the async path's accounting;
    the counters move by what the JAX package's move by."""
    (before, after), (jbefore, jafter) = _both(_sync_failure, served)
    assert after["failed"] == before["failed"] + 1
    assert (after["completed"] + after["failed"]
            == after["dispatched"] >= before["dispatched"] + 1)
    moved = {k: after[k] - before[k] for k in ("failed", "completed",
                                               "dispatched", "admitted")}
    assert moved == {k: jafter[k] - jbefore[k] for k in moved}


def test_system_state_reports_admission_counters(served):
    server, test_idx, jserver = served
    server.handle(Request(prompt="", qid=test_idx[0], slo=SLO()))
    state = server.system_state()
    for key in ("admission_queue_depth", "shed", "deadline_shed",
                "admitted", "dispatch_batches"):
        assert isinstance(state[key], int)
    assert state["admitted"] >= 1 and state["dispatch_batches"] >= 1
    assert state["requests"] == server.tracker.total
    jserver.handle(JaxRequest(prompt="", qid=test_idx[0], slo=JaxSLO()))
    jstate = jserver.system_state()
    assert set(state) == set(jstate)


def _carry_over(ns, server, test_idx):
    orch = ns.Orchestrator(server, max_batch=8, max_wait_ms=1.0, max_queue=8,
                           hedge=False)

    async def main():
        # priorities 3,2,1,0,3,2,1,0 — the four prio>=2 tickets are "best"
        tickets = [await orch.submit(
            ns.Request(prompt="", qid=test_idx[i % len(test_idx)],
                       slo=ns.SLO()), priority=3 - (i % 4)) for i in range(8)]
        orch.reconfigure(max_queue=4)  # loop not yet running: allowed
        shed = [t for t in tickets if t.shed]
        carried = [t for t in tickets if not t.done()]
        async with orch:
            resps = await asyncio.gather(*(t.wait() for t in carried))
        return shed, carried, resps

    shed, carried, resps = asyncio.run(main())
    return shed, carried, resps, orch.stats()


def test_reconfigure_overfull_carry_over_sheds_worst(served):
    """Directed carry-over contract: shrinking ``max_queue`` below the
    enqueued backlog keeps the BEST tickets (highest priority, FIFO within
    priority), sheds exactly the overflow with ``queue_full``, loses
    nothing, and the carried tickets still serve after start()."""
    (shed, carried, resps, st), (jshed, jcarried, jresps, jst) = _both(
        _carry_over, served)
    assert len(shed) == 4 and len(carried) == 4  # none lost
    assert sorted(t.priority for t in carried) == [2, 2, 3, 3]
    assert sorted(t.priority for t in shed) == [0, 0, 1, 1]
    assert all(t._future.result().reason == "queue_full" for t in shed)
    assert all(isinstance(r, Response) for r in resps)  # survivors served
    assert st["admitted"] == 8 and st["shed"] == 4 and st["completed"] == 4
    assert [t.priority for t in carried] == [t.priority for t in jcarried]
    assert [_key(t._future.result()) for t in shed] == \
        [_key(t._future.result()) for t in jshed]
    assert [_key(r) for r in resps] == [_key(r) for r in jresps]
    for k in ("admitted", "shed", "completed"):
        assert st[k] == jst[k], k
