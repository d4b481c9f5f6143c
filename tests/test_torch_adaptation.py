"""Port online adaptation plane (``repro_torch.runtime.adaptation`` with
``RuntimePathSelector.swap_table``) on the CPU.

The first part carries over ``tests/test_adaptation.py`` case for case on
the port: version 0 is the CCA labels verbatim, a swap is build-aside and
atomic (every decision's expected latency matches the version it reports,
and swaps add no bucket to ``kernel_trace_count``), refreshed rows are
relabelled with the CCA rule, the fallback memo and the stage cache hold
their LRU bounds, drift monitors trip with hysteresis and deduplicate
sweeps, and the accounting identities survive the plane's observers.

The second part holds the port against the JAX package.  Both servers are
built on the same seed, the JAX server's trained encoder carried across,
and both planes are fed one sequence of settle and shed records through
their hooks; then both executors' edge device throttles (the drift
scenario: tflops and bandwidth divided by ``SLOWDOWN``) and both planes
pump their sweeps.  Monitor states, queued sweep jobs, the swapped
``EvalTable`` arrays and the decisions after the swap are equal exactly.
The one float that crosses the device projection, the max prototype
similarity of the far-from-prototype signal, is held to 1e-5, the bound
``chip_smoke.py`` holds unit-vector similarities to.
"""
import asyncio
import dataclasses
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core.slo import SLO as JaxSLO
from repro.launch.serve import build_server as jax_build_server
from repro.runtime.adaptation import AdaptConfig as JaxAdaptConfig
from repro.runtime.adaptation import AdaptationPlane as JaxAdaptationPlane
from repro_torch.core.cca import critical_component_analysis, find_best_path
from repro_torch.core.domains import build_domain, train_test_split
from repro_torch.core.dsqe import DSQE
from repro_torch.core.emulator import Emulator, EvalTable, StageCacheLRU
from repro_torch.core.paths import PathSpace
from repro_torch.core.rps import OnlinePathStats, RuntimePathSelector
from repro_torch.core.slo import SLO
from repro_torch.launch.serve import build_server
from repro_torch.runtime.adaptation import (AdaptConfig, AdaptationPlane,
                                            _Ewma, _SweepJob)
from repro_torch.runtime.router import TenantRouter, TenantSpec
from repro_torch.runtime.server import EcoLLMServer, Request

# several xdist workers share the CPU cores: torch's default of one thread
# per core in every worker oversubscribes them and stalls every test
torch.set_num_threads(1)

ATOL = 1e-5  # unit-vector similarities (chip_smoke.py's ATOL)
SLOWDOWN = 4.0  # edge tflops/bandwidth divisor of the drift scenario


@pytest.fixture(scope="module")
def env():
    """One small kernel-backed server shared by the module's tests.  Tests
    that bump the table version run LAST (file order) so the parity tests
    above them see the deploy-time snapshot."""
    return build_server("smarthome", n_queries=24, budget=2.0, seed=0,
                        use_kernel=True, device="cpu")


def _fake_settle(plane, orch, *, qid=0, set_id=0, path_key="pk",
                 slo_ok=False, fallback=False, acc=0.5):
    """Drive the plane's hot-path observer without a running orchestrator
    (the hooks only read ticket.request and the response surface)."""
    ticket = SimpleNamespace(request=SimpleNamespace(
        tenant="t0", domain=None, qid=qid, prompt=""))
    resp = SimpleNamespace(meta={"set_id": set_id, "fallback": fallback},
                           path_key=path_key, latency_s=9.0,
                           cost_usd=1e-3, slo_ok=slo_ok, accuracy=acc)
    plane.observe_settled(orch, ticket, resp, None)


# -- version derivation ------------------------------------------------------

def test_version0_labels_bit_identical_to_cca(env):
    """The deploy-time snapshot IS the pre-versioned selector: version 0,
    CCA's best-path labels verbatim (the kNN vote targets)."""
    server, _ = env
    sel = server.rps
    assert sel.table_version == 0
    assert np.array_equal(sel.train_best_path,
                          np.asarray(sel.cca.best_path))
    assert np.array_equal(
        sel.train_best_acc,
        sel.table.accuracy[np.arange(len(sel.table.query_ids)),
                           sel.train_best_path])


def test_updated_merges_only_evaluated_cells(env):
    """``EvalTable.updated`` overwrites exactly the sub-table's evaluated
    cells and never mutates the receiver (the build-aside half of a swap)."""
    server, _ = env
    t = server.rps.table
    qid = t.query_ids[0]
    P = len(t.paths)
    acc = np.full((1, P), np.nan)
    lat = np.full((1, P), np.nan)
    cost = np.full((1, P), np.nan)
    done = np.zeros((1, P), bool)
    acc[0, 1], lat[0, 1], cost[0, 1], done[0, 1] = 0.77, 0.11, 1e-4, True
    sub = EvalTable(query_ids=[qid], paths=list(t.paths), accuracy=acc,
                    latency=lat, cost=cost, evaluated=done)
    before = t.accuracy.copy()
    merged = t.updated(sub)
    assert np.array_equal(t.accuracy, before, equal_nan=True)  # untouched
    assert merged.accuracy[0, 1] == 0.77 and merged.latency[0, 1] == 0.11
    assert merged.evaluated[0, 1]
    other = np.ones((len(t.query_ids), P), bool)
    other[0, 1] = False
    assert np.array_equal(merged.accuracy[other], t.accuracy[other],
                          equal_nan=True)


def test_swap_relabels_refreshed_rows_keeps_the_rest(env):
    """A version > 0 re-derives per-row best-path labels with the SAME
    lexicographic rule — re-exploration that discovers a better path moves
    the kNN vote; rows the sweep never touched keep their labels."""
    server, _ = env
    sel = server.rps
    t = sel.table
    prev_labels = np.array(sel.train_best_path)
    v0 = sel.table_version
    # a sub-table that makes path 1 the clear winner for row 0
    qid = t.query_ids[0]
    P = len(t.paths)
    acc = np.full((1, P), np.nan)
    lat = np.full((1, P), np.nan)
    cost = np.full((1, P), np.nan)
    done = np.zeros((1, P), bool)
    acc[0, 1], lat[0, 1], cost[0, 1], done[0, 1] = 1.0, 1e-3, 1e-6, True
    sub = EvalTable(query_ids=[qid], paths=list(t.paths), accuracy=acc,
                    latency=lat, cost=cost, evaluated=done)
    new = t.updated(sub)
    try:
        ver = sel.swap_table(new)
        assert ver == v0 + 1 and sel.table_version == ver
        assert sel.train_best_path[0] == find_best_path(
            new.accuracy[0], new.latency[0], new.cost[0], sel.lam) == 1
        assert sel.train_best_acc[0] == 1.0
        assert np.array_equal(sel.train_best_path[1:], prev_labels[1:])
    finally:
        sel.swap_table(t)  # restore the deploy-time cells for later tests


def test_swap_rejects_shape_mismatch(env):
    """Shapes are part of the pass's contract: a table with different
    (Q, P) can never be swapped under a live fused pass."""
    server, _ = env
    sel = server.rps
    t = sel.table
    bad = EvalTable(query_ids=list(t.query_ids[:-1]), paths=list(t.paths),
                    accuracy=t.accuracy[:-1], latency=t.latency[:-1],
                    cost=t.cost[:-1], evaluated=t.evaluated[:-1])
    with pytest.raises(ValueError, match="frozen"):
        sel.swap_table(bad)


# -- fallback memo LRU bound -------------------------------------------------

def test_fallback_memo_lru_cap_and_bit_identical_decisions(env):
    """The OOD-fallback memo holds its LRU cap under an adversarial stream
    of distinct (set_id, SLO) keys, and memoized decisions stay
    bit-identical to the uncached computation (eviction only costs time)."""
    server, tests = env
    sel = server.rps
    dom = server.domain_entry(None)[0]
    emb = dom.query_embeddings[int(tests[0])]
    hard = SLO(max_latency_s=1e-9, max_cost_usd=1e-12)  # nothing feasible
    cold = sel.select(emb, hard)
    assert cold.used_fallback
    warm = sel.select(emb, hard)  # memo hit
    assert (warm.path.key, warm.set_id, warm.used_fallback) == \
        (cold.path.key, cold.set_id, cold.used_fallback)
    old_cap = sel.fallback_memo_cap
    try:
        sel.fallback_memo_cap = 4
        for i in range(32):  # distinct SLOs -> distinct memo keys
            d = sel.select(emb, SLO(max_latency_s=1e-9 + i * 1e-12,
                                    max_cost_usd=1e-12))
            assert d.used_fallback
            assert len(sel._fallback_memo) <= 4
        evicted = sel.select(emb, hard)  # key was evicted: recompute
        assert (evicted.path.key, evicted.set_id) == \
            (cold.path.key, cold.set_id)
    finally:
        sel.fallback_memo_cap = old_cap


# -- emulator stage-cache LRU bound ------------------------------------------

def test_stage_cache_lru_parity_and_stats(env):
    """A bounded stage cache changes cost, never results: explored cells
    are bit-identical to the unbounded emulator's, the cache never exceeds
    its bound, and ``Emulator.stats()`` exposes hit/miss/eviction
    counters.  The default stays unbounded (deploy-time parity)."""
    server, _ = env
    dom, sel, ex = server.domain_entry(None)
    qids = sel.table.query_ids[:3]
    unbounded = Emulator(dom, sel.space, executor=ex)
    bounded = Emulator(dom, sel.space, executor=ex, stage_cache_max=2)
    tu = unbounded.explore_targeted(list(qids))
    tb = bounded.explore_targeted(list(qids))
    assert np.array_equal(tu.accuracy, tb.accuracy, equal_nan=True)
    assert np.array_equal(tu.latency, tb.latency, equal_nan=True)
    assert np.array_equal(tu.cost, tb.cost, equal_nan=True)
    assert np.array_equal(tu.evaluated, tb.evaluated)

    su, sb = unbounded.stats(), bounded.stats()
    assert not su["bounded"] and su["evictions"] == 0
    assert sb["bounded"] and len(bounded._stage_cache) <= 2
    assert sb["evictions"] > 0  # 3 rows of prefixes cannot fit in 2 slots
    assert sb["misses"] > 0 and sb["hits"] >= 0

    lru = StageCacheLRU(2)
    lru["a"], lru["b"], lru["c"] = 1, 2, 3
    assert "a" not in lru and len(lru) == 2 and lru.evictions == 1
    assert lru.get("b") == 2  # touch
    lru["d"] = 4
    assert "c" not in lru and "b" in lru  # LRU order respects the touch


# -- online statistics -------------------------------------------------------

def test_ewma_decayed_count_and_blend_semantics():
    """The decayed count saturates at 1/decay (old evidence ages out), and
    the convex blend only moves cells with online evidence: w == 0 or
    non-finite observations keep the emulated estimate bit-for-bit."""
    e = _Ewma()
    for _ in range(1000):
        e.update(2.0, 0.1)
    assert abs(e.n - 10.0) < 1e-6 and abs(e.mean - 2.0) < 1e-9

    base = np.array([1.0, 2.0, 3.0, 4.0])
    obs = np.array([9.0, np.nan, 9.0, 9.0])
    stats = OnlinePathStats(latency_s=obs, cost_usd=obs, accuracy=obs,
                            weight=np.array([0.5, 0.5, 0.0, 0.5]))
    valid = np.array([True, True, True, False])
    out = stats.blend(base, obs, valid)
    assert out[0] == 0.5 * 1.0 + 0.5 * 9.0  # blended
    assert out[1] == 2.0   # NaN observation ignored
    assert out[2] == 3.0   # zero weight: emulated kept bit-for-bit
    assert out[3] == 4.0   # invalid (never-evaluated) cannot be promoted


def test_recalibrate_latency_rescales_unswept_columns(env):
    """The sweep doubles as an environment probe: a consistent latency
    shift on the swept rows rescales the UNSWEPT cells of that path
    column; stable columns and accuracy are untouched."""
    old = np.array([[1.0, 2.0],
                    [1.0, 2.0],
                    [4.0, 8.0]])
    t = SimpleNamespace(latency=np.array([[3.0, 2.0],
                                          [1.0, 2.0],
                                          [4.0, np.nan]]))
    # swept row 0: col 0 ratio 3.0 (shifted), col 1 ratio 1.0 (stable)
    n = AdaptationPlane._recalibrate_latency(old, t, [0])
    assert n == 1
    assert np.allclose(t.latency[:, 0], [3.0, 3.0, 12.0])  # unswept x3
    assert t.latency[1, 1] == 2.0 and np.isnan(t.latency[2, 1])


# -- drift monitors ----------------------------------------------------------

def test_drift_monitor_hysteresis_and_sweep_dedupe(env):
    """A monitor needs ``trip_folds`` consecutive hot ACTIVE folds before
    it queues a sweep, and a queued (shard, domain) job deduplicates —
    continued drift while a sweep is pending never floods the queue."""
    server, _ = env
    plane = AdaptationPlane(server, config=AdaptConfig(
        min_obs=3.0, trip_folds=2, clear_folds=1, cooldown_folds=2))
    orch = SimpleNamespace(shard_id=None)
    domain = server.canonical_domain(None)

    def hot_fold():
        for _ in range(6):
            _fake_settle(plane, orch, slo_ok=False)
        return plane.pump(max_sweeps=0)

    r1 = hot_fold()
    assert r1["folded"] == 6 and r1["pending_sweeps"] == 0  # 1 hot fold
    mon = plane._shards["main"].monitors[domain]
    assert mon.hot_streak == 1 and mon.trips == 0

    r2 = hot_fold()  # second consecutive hot fold: trip
    assert r2["pending_sweeps"] == 1
    assert mon.trips == 1 and mon.last_cause == "slo_violations"

    r3 = hot_fold()  # still drifting, job already queued: dedupe
    assert r3["pending_sweeps"] == 1 and mon.trips == 1

    st = plane.state()
    assert st["shards"]["main"]["observed"] == 18
    assert st["shards"]["main"]["domains"][domain]["trips"] == 1


def test_cool_folds_clear_the_hot_streak(env):
    """Hysteresis: healthy folds reset a partial hot streak, so a
    transient blip never accumulates into a trip across quiet periods."""
    server, _ = env
    plane = AdaptationPlane(server, config=AdaptConfig(
        min_obs=3.0, trip_folds=2, clear_folds=1))
    orch = SimpleNamespace(shard_id=None)
    domain = server.canonical_domain(None)
    for _ in range(6):
        _fake_settle(plane, orch, slo_ok=False)
    plane.pump(max_sweeps=0)
    mon = plane._shards["main"].monitors[domain]
    assert mon.hot_streak == 1
    # a healthy fold (the EWMA needs a few to drop below threshold)
    for _ in range(3):
        for _ in range(12):
            _fake_settle(plane, orch, slo_ok=True)
        plane.pump(max_sweeps=0)
    assert mon.hot_streak == 0 and mon.trips == 0
    assert plane.pump(max_sweeps=0)["pending_sweeps"] == 0


# -- accounting under concurrent settle/shed with the plane ------------------

def test_accounting_identities_survive_plane_observers(env):
    """Per-tenant accounting through the public router API with the
    adaptation observers attached and concurrent settle/shed traffic:
    offered == admitted + shed and admitted == served + failed, per tenant
    and summed — the plane's hooks must never eat or double-count an
    outcome."""
    server, tests = env
    plane = server.enable_adaptation(start=False)
    router = TenantRouter(server, [TenantSpec("alice"), TenantSpec("bob")],
                          n_shards=2, max_batch=8, max_wait_ms=1.0,
                          max_queue=8, hedge=False)
    qids = [int(q) for q in tests]

    async def main():
        # pre-start floods overflow bob's queue bound (shed: queue_full)
        # while alice's traffic all serves; the drain is concurrent
        flood = [await router.submit(Request(
            prompt="", qid=qids[i % len(qids)], tenant="bob"))
            for i in range(24)]
        ok = [await router.submit(Request(
            prompt="", qid=qids[i % len(qids)], tenant="alice"))
            for i in range(6)]
        async with router:
            await asyncio.gather(*(t.wait() for t in flood + ok))

    asyncio.run(main())
    stats = router.stats()["tenants"]
    for t in ("alice", "bob"):
        st = stats[t]
        assert st["offered"] == st["admitted"] + st["shed"], st
        assert st["admitted"] == st["served"] + st["failed"], st
    total = {k: sum(stats[t][k] for t in stats)
             for k in ("offered", "admitted", "shed", "served", "failed")}
    assert total["offered"] == 30
    assert total["offered"] == total["admitted"] + total["shed"]
    assert total["admitted"] == total["served"] + total["failed"]
    # every outcome (served and shed) reached the plane's rings
    folded = plane.pump(max_sweeps=0)["folded"]
    assert folded == 30
    assert sum(s["observed"]
               for s in plane.state()["shards"].values()) == 30


# -- the port against the JAX package (fresh servers, before the swaps below)

def _port_server_with(dsqe_params, n_sets):
    """The port's ``build_server("smarthome", n_queries=24, budget=2.0,
    use_kernel=True)`` with a given (carried) DSQE in place of training."""
    dom = build_domain("smarthome", n_queries=24, seed=0)
    space = PathSpace()
    train_idx, test_idx = train_test_split(dom, 0.3)
    emu = Emulator(dom, space, seed=0)
    table = emu.explore(train_idx, budget=2.0, lam=0)
    cca = critical_component_analysis(table, lam=0)
    dsqe = DSQE.from_numpy(dsqe_params, n_sets, device="cpu")
    rps = RuntimePathSelector(space, dsqe, cca, table,
                              dom.query_embeddings[train_idx], lam=0,
                              use_kernel=True)
    return EcoLLMServer(dom, rps, emu.exec, n_replicas=1, seed=0), test_idx


def _records(sel, test_idx, rng):
    """One deterministic sequence of outcomes over three folds: folds 1-2
    run hot (mostly SLO violations) on the default orchestrator, a second
    shard stays healthy, and a few requests shed or carry prompt text in
    place of a query id."""
    paths = [p.key for p in sel.table.paths]
    n_sets = len(sel.cca.set_vocab)
    folds = []
    for fold, p_ok in enumerate((0.15, 0.2, 0.3)):
        recs = []
        for i in range(14):
            shard = None if i % 4 else 0
            kind = "shed" if i % 9 == 8 else "settled"
            qid = int(test_idx[rng.integers(len(test_idx))])
            prompt = ""
            if i % 7 == 3:
                qid, prompt = None, f"thermostat schedule {fold} {i}"
            recs.append(dict(
                shard=shard, kind=kind, qid=qid, prompt=prompt,
                set_id=int(rng.integers(n_sets)),
                path_key=paths[int(rng.integers(len(paths)))],
                slo_ok=bool(rng.random() < (0.9 if shard == 0 else p_ok)),
                fallback=bool(rng.random() < 0.2),
                acc=float(rng.random()) if i % 5 else float("nan"),
                latency=float(rng.uniform(0.2, 6.0)),
                cost=float(rng.uniform(0.0, 2e-3))))
        folds.append(recs)
    return folds


def _feed(plane, recs):
    orchs = {None: SimpleNamespace(shard_id=None),
             0: SimpleNamespace(shard_id=0)}
    for r in recs:
        ticket = SimpleNamespace(request=SimpleNamespace(
            tenant="t0", domain=None, qid=r["qid"], prompt=r["prompt"]))
        if r["kind"] == "shed":
            plane.observe_shed(orchs[r["shard"]], ticket, "queue_full")
            continue
        resp = SimpleNamespace(
            meta={"set_id": r["set_id"], "fallback": r["fallback"]},
            path_key=r["path_key"], latency_s=r["latency"],
            cost_usd=r["cost"], slo_ok=r["slo_ok"], accuracy=r["acc"])
        plane.observe_settled(orchs[r["shard"]], ticket, resp, None)


def _ewma(e):
    return (e.mean, e.n)


def _plane_snapshot(plane):
    """Everything the plane's statistics and drift monitors hold."""
    out = {}
    for key, st in plane._shards.items():
        out[key] = {
            "folds": st.folds, "observed": st.observed, "cursor": st.cursor,
            "cells": {k: tuple(_ewma(getattr(c, f))
                               for f in ("lat", "cost", "acc", "slo_hit"))
                      for k, c in st.cells.items()},
            "set_viol": {k: _ewma(v) for k, v in st.set_viol.items()},
            "monitors": {
                d: (_ewma(m.viol), _ewma(m.fallback), _ewma(m.ood),
                    m.hot_streak, m.cool_streak, m.active_folds,
                    m.last_sweep_fold, m.trips, m.last_cause)
                for d, m in st.monitors.items()},
        }
    jobs = [(j.shard_key, j.domain, tuple(sorted(j.stale_sets)), j.cause)
            for j in plane._sweep_q]
    return out, jobs


def _degrade(server):
    dev = server.executor.device
    server.executor.device = dataclasses.replace(
        dev, tflops=dev.tflops / SLOWDOWN, mem_gbps=dev.mem_gbps / SLOWDOWN)


def _keyed(d):
    return (d.path.key, d.set_id, d.used_fallback, d.expected_latency_s,
            d.expected_cost_usd, d.table_version)


def _decisions(sel, embs, slos):
    return [_keyed(d) for d in sel.select_batch(embs, slos)]


SLO_ARGS = [{}, {"max_latency_s": 2.0, "max_cost_usd": 0.004},
            {"max_latency_s": 1e-6, "max_cost_usd": 0.0},
            {"max_latency_s": 4.0, "max_cost_usd": 0.008}]


@pytest.fixture(scope="module")
def drift_pair():
    """The JAX and the port plane through the same records, folds and
    drifted sweep; snapshots of both after every step."""
    jserver, jtest = jax_build_server("smarthome", n_queries=24, budget=2.0,
                                      seed=0, use_kernel=True)
    jsel = jserver.rps
    server, test = _port_server_with(jsel.dsqe.params, jsel.dsqe.n_sets)
    np.testing.assert_array_equal(test, jtest)
    knobs = dict(min_obs=3.0, trip_folds=2, clear_folds=1, cooldown_folds=2,
                 decay=0.15, blend_prior=4.0, max_sweep_queries=4)
    planes = (AdaptationPlane(server, config=AdaptConfig(**knobs)),
              JaxAdaptationPlane(jserver, config=JaxAdaptConfig(**knobs)))
    folds = _records(server.rps, test, np.random.default_rng(7))
    steps = []
    for recs in folds:
        for p in planes:
            _feed(p, recs)
        pumped = [p.pump(max_sweeps=0) for p in planes]
        steps.append((pumped, [_plane_snapshot(p) for p in planes]))
    sims = [p._max_proto_sims(p.server.canonical_domain(None),
                              [SimpleNamespace(qid=int(q), prompt="")
                               for q in test])
            for p in planes]
    for s in (server, jserver):
        _degrade(s)
    swaps = [p.pump() for p in planes]
    embs = server.domain.query_embeddings[test]
    slos = [SLO(**SLO_ARGS[i % 4]) for i in range(len(test))]
    jslos = [JaxSLO(**SLO_ARGS[i % 4]) for i in range(len(test))]
    after = (_decisions(server.rps, embs, slos),
             _decisions(jsel, embs, jslos))
    single = ([_keyed(server.rps.select(e, s)) for e, s in zip(embs, slos)],
              [_keyed(jsel.select(e, s)) for e, s in zip(embs, jslos)])
    yield dict(servers=(server, jserver), planes=planes, steps=steps,
               sims=sims, swaps=swaps, after=after, single=single)
    server.fleet.close()


def test_proto_sims_match_jax(drift_pair):
    got, want = drift_pair["sims"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_monitor_states_equal_jax_every_fold(drift_pair):
    for pumped, (got, want) in drift_pair["steps"]:
        assert pumped[0] == pumped[1]
        assert got[0] == want[0]


def test_sweep_jobs_equal_jax(drift_pair):
    queued = [got[1] for _, (got, want) in drift_pair["steps"]]
    assert queued == [want[1] for _, (got, want) in drift_pair["steps"]]
    assert any(queued), "the hot folds never queued a sweep"


def test_swapped_table_bit_equal_jax(drift_pair):
    (sw, jsw), planes = drift_pair["swaps"], drift_pair["planes"]
    assert sw == jsw and len(sw["swaps"]) == 1
    assert sw["swaps"][0]["recalibrated_paths"] > 0  # the throttle showed
    sel, jsel = (s.rps for s in drift_pair["servers"])
    assert sel.table_version == jsel.table_version == 1
    t, jt = sel.table, jsel.table
    assert list(t.query_ids) == list(jt.query_ids)
    for f in ("accuracy", "latency", "cost", "evaluated"):
        assert np.array_equal(getattr(t, f), getattr(jt, f), equal_nan=True), f
    for f in ("path_latency", "path_cost", "path_mean_acc", "path_evaluated",
              "train_best_path", "train_best_acc"):
        assert np.array_equal(getattr(sel, f), getattr(jsel, f),
                              equal_nan=True), f
    assert planes[0].state() == planes[1].state()


def test_decisions_after_swap_equal_jax(drift_pair):
    got, want = drift_pair["after"]
    assert got == want
    assert {row[-1] for row in got} == {1}


def test_single_select_after_swap_equals_jax(drift_pair):
    """The one-query ``select`` (the numpy engine's own path) reads the
    swapped version too, and decides every row as JAX's does."""
    got, want = drift_pair["single"]
    assert got == want
    assert {row[-1] for row in got} == {1}


# -- the closed loop + swap atomicity (these bump the table version) ---------

def test_pump_runs_targeted_sweep_and_swaps(env):
    """End-to-end pump: a queued sweep job re-explores only the stale
    cluster's rows against the live executor and atomically swaps the
    merged table into the selector."""
    server, _ = env
    sel = server.rps
    v0 = sel.table_version
    plane = AdaptationPlane(server, config=AdaptConfig(max_sweep_queries=2))
    domain = server.canonical_domain(None)
    sid = int(np.asarray(sel.cca.set_ids)[0])
    assert plane._enqueue_sweep(
        _SweepJob("main", domain, frozenset({sid}), "slo_violations"))
    out = plane.pump()
    assert len(out["swaps"]) == 1
    ev = out["swaps"][0]
    assert ev["domain"] == domain and ev["version"] == v0 + 1
    assert 0 < ev["queries_swept"] <= 2
    assert sel.table_version == v0 + 1
    assert plane.swaps == 1 and plane.swap_log[-1] == ev
    # swept rows are now fully evaluated (the sweep is exhaustive)
    rows = np.where(np.asarray(sel.cca.set_ids) == sid)[0][:2]
    assert sel.table.evaluated[rows].all()


def test_swap_under_load_atomic_and_never_retraces(env):
    """Concurrent readers race repeated table swaps.  Every decision's
    expected latency must match the exact version it reports (a torn read
    — scores from one version, epilogue from another — would pair a path
    with another version's latency), and swaps add no bucket to
    ``kernel_trace_count``."""
    server, tests = env
    sel = server.rps
    dom = server.domain_entry(None)[0]
    embs = np.asarray(dom.query_embeddings[[int(q) for q in tests[:8]]])
    slos = [SLO(max_latency_s=1e9)] * len(embs)
    sel.select_batch(embs, slos)  # run the bucket once
    traces0 = sel.kernel_trace_count

    base = sel.table
    v_base = sel.table_version
    n_swaps = 24
    factor = {v_base + k: 1.0 + 0.03 * k for k in range(n_swaps + 1)}
    with np.errstate(invalid="ignore"):
        base_pathlat = np.nanmean(base.latency, axis=0)

    stop = threading.Event()
    decisions, errors = [], []

    def reader():
        try:
            while not stop.is_set():
                decisions.extend(sel.select_batch(embs, slos))
        except Exception as e:  # pragma: no cover - the failure mode
            errors.append(e)

    threads = [threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        for k in range(1, n_swaps + 1):
            scaled = EvalTable(
                query_ids=list(base.query_ids), paths=list(base.paths),
                accuracy=base.accuracy, latency=base.latency * factor[v_base + k],
                cost=base.cost, evaluated=base.evaluated)
            assert sel.swap_table(scaled) == v_base + k
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)

    assert not errors
    assert len(decisions) >= len(embs)
    versions = {d.table_version for d in decisions}
    assert versions <= set(factor)
    pkey = {p.key: j for j, p in enumerate(base.paths)}
    for d in decisions:
        want = base_pathlat[pkey[d.path.key]] * factor[d.table_version]
        assert abs(d.expected_latency_s - want) < 1e-9 * max(1.0, want)
    # swaps reuse the fused pass: same bucket, no new count
    assert sel.kernel_trace_count == traces0
