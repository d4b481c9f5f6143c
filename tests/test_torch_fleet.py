"""Concurrent fleet dispatcher of the port (``repro_torch.runtime.fleet``),
case by case with ``tests/test_fleet_concurrency.py``, and against the JAX
package.

Each case runs the reference case's assertions on the port.  Where the
result is deterministic, it must also equal the JAX package's on the same
seed: the sequential dispatcher's (``max_workers=1``) results, meta and
``(hedge_count, failover_count, replica sequence)``, order-preserving
outputs, snapshot keys, error text, rolling-p95 values, and the served
path on a DSQE carried from the JAX package.  Hedging, eviction and
straggling depend on threads and clocks: those cases hold the reference
case's own assertions only.
"""
import random
import threading
import time

import pytest
import torch

from carried_server import carried_servers
from repro.runtime.fleet import Replica as JaxReplica
from repro.runtime.fleet import ReplicaFleet as JaxReplicaFleet
from repro.runtime.fleet import ReplicaStats as JaxReplicaStats
from repro.runtime.server import Request as JaxRequest
from repro_torch.runtime.fleet import Replica, ReplicaFleet

torch.set_num_threads(1)


def _ok_replica(rid):
    return Replica(rid=rid, execute=lambda job: ("ok", job))


def _jax_ok_replica(rid):
    return JaxReplica(rid=rid, execute=lambda job: ("ok", job))


def test_concurrent_failures_never_evict_last_replica():
    """Two failing replicas + concurrent submits: eviction is atomic, so the
    fleet can never be drained to zero live replicas by failures."""
    def make(rid):
        def execute(job):
            return "ok"
        return Replica(rid=rid, execute=execute, fail_rate=1.0)

    fleet = ReplicaFleet(make, n=2, seed=0)
    errors = []

    def hammer():
        for _ in range(4):
            try:
                fleet.submit("job")
            except RuntimeError as e:
                errors.append(e)

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
        assert not t.is_alive()
    assert len(fleet.live()) >= 1  # last replica survived the failure storm
    assert errors  # and the requests did surface their failures
    fleet.close()


def test_inflight_requeued_on_heartbeat_eviction():
    """The module docstring's promise: an evicted replica's outstanding
    requests go back on the queue and complete elsewhere."""
    release = threading.Event()

    def make(rid):
        if rid == 0:
            def execute(job):
                release.wait(5.0)  # stalls until the test lets go
                return ("stalled", job)
        else:
            def execute(job):
                return ("fast", job)
        return Replica(rid=rid, execute=execute)

    fleet = ReplicaFleet(make, n=1, seed=0)  # only the stalling replica
    result = {}

    def submit():
        result["out"] = fleet.submit("job", hedge=False)

    t = threading.Thread(target=submit)
    t.start()
    deadline = time.time() + 5.0
    while fleet.in_flight() == 0 and time.time() < deadline:
        time.sleep(0.002)
    assert fleet.in_flight() == 1  # stuck on replica 0

    fleet.scale_to(2)  # replica 1 joins; replica 0 then misses its beats
    for _ in range(fleet.max_missed):
        fleet.heartbeat(responding={1})
    t.join(5.0)
    assert not t.is_alive()
    out, meta = result["out"]
    assert out == ("fast", "job") and meta["replica"] == 1
    assert meta["requeues"] == 1 and fleet.requeue_count == 1
    assert not fleet.replicas[0].healthy
    release.set()  # let the stalled thread finish; its result is discarded
    fleet.close()


def test_hedge_fires_real_duplicate_and_loser_is_cancelled():
    """A straggling primary gets a real duplicate on the backup after the
    rolling-p95 deadline; the fast backup wins every time."""
    def make(rid):
        return Replica(rid=rid, execute=lambda job: ("ok", rid),
                       straggle_rate=1.0 if rid == 0 else 0.0,
                       straggle_s=1.0)  # 50ms real stall in Replica.call

    fleet = ReplicaFleet(make, n=2, seed=2)
    # warm the backup's rolling wall-clock p95 so the hedge deadline is armed
    fleet.replicas[0].straggle_rate = 0.0
    for _ in range(24):
        fleet.submit("warm")
    fleet.replicas[0].straggle_rate = 1.0

    h0, c0 = fleet.hedge_count, fleet.cancelled_count
    metas = [fleet.submit("job")[1] for _ in range(12)]
    hedged = [m for m in metas if m["hedges"]]
    assert fleet.hedge_count - h0 == sum(m["hedges"] for m in metas)
    assert hedged, "no hedge fired against a 100% straggling replica"
    # the fast backup won every hedged request (loser discarded on arrival)
    assert all(m["replica"] == 1 for m in hedged)
    deadline = time.time() + 5.0
    while fleet.in_flight() > 0 and time.time() < deadline:
        time.sleep(0.005)  # let straggling losers land and be discarded
    assert fleet.cancelled_count > c0
    fleet.close()


def _sequential_run(fleet_cls, make):
    fleet = fleet_cls(make, n=3, seed=7, max_workers=1)
    outs = fleet.submit_many(list(range(20)))
    state = (fleet.hedge_count, fleet.failover_count,
             [m["replica"] for _, m in outs])
    fleet.close()
    return [o for o, _ in outs], state


def test_sequential_mode_is_deterministic():
    """max_workers=1 reproduces the pre-threaded dispatcher bit-for-bit:
    same RNG draw order, same results, same counters — and the JAX
    package's, replica for replica."""
    outs1, state1 = _sequential_run(ReplicaFleet, _ok_replica)
    outs2, state2 = _sequential_run(ReplicaFleet, _ok_replica)
    assert outs1 == outs2 and state1 == state2
    assert outs1 == [("ok", j) for j in range(20)]
    assert (outs1, state1) == _sequential_run(JaxReplicaFleet, _jax_ok_replica)


def test_submit_many_preserves_order_and_telemetry():
    fleet = ReplicaFleet(_ok_replica, n=4, seed=0)
    outs = fleet.submit_many(list(range(40)))
    assert [o for o, _ in outs] == [("ok", j) for j in range(40)]
    jfleet = JaxReplicaFleet(_jax_ok_replica, n=4, seed=0)
    jouts = jfleet.submit_many(list(range(40)))
    assert [o for o, _ in outs] == [o for o, _ in jouts]
    for (_, meta), (_, jmeta) in zip(outs, jouts):
        assert {"replica", "latency_s", "attempts", "hedges", "requeues"} \
            <= set(meta)
        assert set(meta) == set(jmeta)
    assert fleet.queue_depth() == 0 and fleet.in_flight() == 0
    fleet.close()
    jfleet.close()


@pytest.mark.slow
def test_submit_many_stress_no_request_lost_or_double_counted():
    """Sustained concurrent batches under fault injection + elastic churn:
    every request completes exactly once, in order, and the fleet counters
    match the per-request metadata exactly."""
    def make(rid):
        def execute(job):
            time.sleep(0.001)
            return ("ok", job)
        return Replica(
            rid=rid, execute=execute,
            fail_rate=0.25 if rid % 4 == 0 else 0.0,
            straggle_rate=0.2 if rid % 4 == 1 else 0.0, straggle_s=0.2)

    fleet = ReplicaFleet(make, n=4, seed=5)
    rng = random.Random(5)
    stop = threading.Event()

    def churn():
        while not stop.is_set():
            live = {r.rid for r in fleet.live()}
            if len(live) > 2 and rng.random() < 0.5:
                victim = rng.choice(sorted(live))
                for _ in range(fleet.max_missed):
                    fleet.heartbeat(responding=live - {victim})
            else:
                fleet.scale_to(4)
            time.sleep(0.01)

    churner = threading.Thread(target=churn)
    churner.start()
    try:
        total = 0
        for batch in range(6):
            reqs = [(batch, i) for i in range(50)]
            outs = fleet.submit_many(reqs)
            payloads = [o[1] for o, _ in outs]
            assert payloads == reqs  # exactly once, in order, none lost
            total += len(outs)
            assert sum(m["hedges"] for _, m in outs) <= fleet.hedge_count
        assert total == 300
    finally:
        stop.set()
        churner.join(30.0)
    assert not churner.is_alive()
    assert fleet.queue_depth() == 0
    # dead rids' dispatcher state is GC'd once drained (whitebox): only the
    # registry keeps tombstones, so churn can't grow the hot-path dicts
    live_rids = {r.rid for r in fleet.live()}
    deadline = time.time() + 5.0
    while time.time() < deadline and set(fleet._queues) - live_rids:
        time.sleep(0.005)
        live_rids = {r.rid for r in fleet.live()}
    assert set(fleet._queues) == live_rids
    assert len(fleet.replicas) > len(live_rids)  # tombstones do remain
    fleet.close()


def test_submit_many_async_matches_blocking_results():
    """The non-blocking fan-out delivers the same (result, meta) surface as
    `submit_many`, pushes completion through callbacks, and leaves the fleet
    drained."""
    fleet = ReplicaFleet(_ok_replica, n=3, seed=0)
    fired = []
    futures = fleet.submit_many_async(list(range(24)))
    for j, fut in enumerate(futures):
        fut.add_done_callback(lambda f, j=j: fired.append(j))
    outs = [fut.result(timeout=5.0) for fut in futures]
    assert [o for o, _ in outs] == [("ok", j) for j in range(24)]
    for _, meta in outs:
        assert {"replica", "latency_s", "attempts", "hedges", "requeues"} \
            <= set(meta)
    deadline = time.time() + 5.0
    while len(fired) < 24 and time.time() < deadline:
        time.sleep(0.002)
    assert sorted(fired) == list(range(24))  # every callback fired once
    assert fleet.queue_depth() == 0 and fleet.in_flight() == 0
    fleet.close()


def test_submit_many_async_callback_after_completion_fires_immediately():
    fleet = ReplicaFleet(_ok_replica, n=2, seed=0)
    (fut,) = fleet.submit_many_async(["job"])
    fut.result(timeout=5.0)  # flight settled
    fired = []
    fut.add_done_callback(lambda f: fired.append(f.result(0)))
    assert fired == [(("ok", "job"), fut.result(0)[1])]
    fleet.close()


def _norm(outs):  # latency_s is measured wall-clock, not deterministic
    return [(o, {k: v for k, v in m.items() if k != "latency_s"})
            for o, m in outs]


def test_submit_many_async_sequential_mode_is_deterministic():
    """max_workers=1: the async surface runs the same sequential dispatcher
    — futures come back already complete with identical results, meta, and
    counters as the blocking call on a twin fleet, and as the JAX
    package's async surface."""
    sync_fleet = ReplicaFleet(_ok_replica, n=3, seed=7, max_workers=1)
    sync_outs = sync_fleet.submit_many(list(range(20)))
    async_fleet = ReplicaFleet(_ok_replica, n=3, seed=7, max_workers=1)
    futures = async_fleet.submit_many_async(list(range(20)))
    assert all(fut.done() for fut in futures)  # completed inline
    async_outs = [fut.result(0) for fut in futures]
    assert _norm(async_outs) == _norm(sync_outs)
    assert (async_fleet.hedge_count, async_fleet.failover_count) \
        == (sync_fleet.hedge_count, sync_fleet.failover_count)
    jfleet = JaxReplicaFleet(_jax_ok_replica, n=3, seed=7, max_workers=1)
    jouts = [f.result(0) for f in jfleet.submit_many_async(list(range(20)))]
    assert _norm(async_outs) == _norm(jouts)
    assert (async_fleet.hedge_count, async_fleet.failover_count) \
        == (jfleet.hedge_count, jfleet.failover_count)
    for f in (sync_fleet, async_fleet, jfleet):
        f.close()


def test_submit_many_async_surfaces_failures_via_future():
    """Both dispatcher modes surface an execution failure through the future
    with the SAME error shape: one 'failed after retries' wrapper around the
    original exception, never a double wrap — the JAX package's text."""
    def execute(job):
        raise ValueError("always fails")

    for max_workers in (None, 1):  # threaded and sequential modes
        texts = []
        for fleet_cls, replica_cls in ((ReplicaFleet, Replica),
                                       (JaxReplicaFleet, JaxReplica)):
            fleet = fleet_cls(lambda rid, cls=replica_cls: cls(
                rid=rid, execute=execute, fail_rate=0.0), n=2, seed=0,
                max_workers=max_workers)
            (fut,) = fleet.submit_many_async(["job"], hedge=False)
            with pytest.raises(RuntimeError,
                               match="failed after retries") as ei:
                fut.result(timeout=5.0)
            texts.append(str(ei.value))
            fleet.close()
        assert texts[0].count("failed after retries") == 1
        assert "always fails" in texts[0]
        assert texts[0] == texts[1]


def test_snapshot_is_consistent_and_matches_fields_at_quiescence():
    fleet = ReplicaFleet(_ok_replica, n=3, seed=1)
    fleet.submit_many(list(range(30)))
    snap = fleet.snapshot()
    assert snap == {
        "replicas": len(fleet.live()),
        "hedges": fleet.hedge_count,
        "failovers": fleet.failover_count,
        "requeues": fleet.requeue_count,
        "cancelled": fleet.cancelled_count,
        "queue_depth": fleet.queue_depth(),
        "in_flight": fleet.in_flight(),
        "dispatched_by_tag": dict(fleet.dispatched_by_tag),
    }
    assert snap["queue_depth"] == 0 and snap["in_flight"] == 0
    jfleet = JaxReplicaFleet(_jax_ok_replica, n=3, seed=1)
    jfleet.submit_many(list(range(30)))
    assert list(snap) == list(jfleet.snapshot())
    fleet.close()
    jfleet.close()


def test_server_embed_memo_hits_on_repeated_prompt(monkeypatch):
    """`EcoLLMServer._resolve_query` memoizes open-world prompt embeddings;
    the served paths are the JAX server's on the carried DSQE."""
    from repro_torch.runtime import server as server_mod
    from repro_torch.runtime.server import Request

    jserver, server, _ = carried_servers("smarthome", n_queries=20,
                                         budget=2.0, seed=0)
    calls = {"n": 0}
    real_embed = server_mod.embed_text

    def counting_embed(text):
        calls["n"] += 1
        return real_embed(text)

    monkeypatch.setattr(server_mod, "embed_text", counting_embed)
    r1 = server.handle(Request(prompt="how do I reset the thermostat?"))
    r2 = server.handle(Request(prompt="how do I reset the thermostat?"))
    assert calls["n"] == 1  # second handle hit the LRU memo
    assert server.embed_cache_hits == 1 and server.embed_cache_misses == 1
    assert r1.path_key == r2.path_key
    r3 = server.handle(Request(prompt="a different prompt entirely"))
    assert calls["n"] == 2
    want = [jserver.handle(JaxRequest(prompt=p)) for p in (
        "how do I reset the thermostat?", "a different prompt entirely")]
    assert [(r.path_key, r.accuracy, r.latency_s, r.cost_usd)
            for r in (r1, r3)] == [(w.path_key, w.accuracy, w.latency_s,
                                    w.cost_usd) for w in want]
    server.fleet.close()
    jserver.fleet.close()


def test_replica_stats_p95_memoized_per_generation(monkeypatch):
    """Micro-regression for the hedge monitor's hot path: repeated
    ``p95()``/``p95_wall()`` calls sort the window at most once per record
    generation, a new sample invalidates both memos, the memoized value
    equals the direct computation, and below the 8-sample warmup floor the
    per-call default passes straight through (never cached).  Every value
    equals the JAX package's ``ReplicaStats`` on the same samples."""
    from repro_torch.runtime.fleet import ReplicaStats

    stats, jstats = ReplicaStats(), JaxReplicaStats()
    sorts = {"n": 0}
    real_p95 = ReplicaStats._p95

    def counting_p95(xs, default):
        sorts["n"] += 1
        return real_p95(xs, default)

    monkeypatch.setattr(ReplicaStats, "_p95", staticmethod(counting_p95))

    def record(lat, wall):
        stats.record_success(lat, wall)
        jstats.record_success(lat, wall)

    # warmup floor: < 8 samples returns the caller's default, no sort
    for i in range(7):
        record(0.1 * (i + 1), 0.2 * (i + 1))
    assert stats.p95(default=1.23) == 1.23
    assert stats.p95_wall(default=4.56) == 4.56
    assert sorts["n"] == 0

    record(0.8, 1.6)  # 8th sample: memoization kicks in
    lat = [stats.p95() for _ in range(50)]
    wall = [stats.p95_wall() for _ in range(50)]
    assert sorts["n"] == 2  # one sort per window, not per call
    assert len(set(lat)) == len(set(wall)) == 1
    assert lat[0] == real_p95(list(stats.latencies), 0.5)
    assert wall[0] == real_p95(list(stats.wall_latencies), 0.5)
    assert (lat[0], wall[0]) == (jstats.p95(), jstats.p95_wall())

    record(9.9, 19.8)  # invalidates BOTH memos
    new_lat, new_wall = stats.p95(), stats.p95_wall()
    stats.p95(), stats.p95_wall()
    assert sorts["n"] == 4  # exactly one recompute each after invalidation
    assert new_lat == real_p95(list(stats.latencies), 0.5) != lat[0]
    assert new_wall == real_p95(list(stats.wall_latencies), 0.5) != wall[0]
    assert (new_lat, new_wall) == (jstats.p95(), jstats.p95_wall())
