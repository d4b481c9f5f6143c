"""Batched == scalar execution engine parity on the port
(``repro_torch.core.pipeline`` / ``emulator`` / ``rps``), case by case with
``tests/test_batch_parity.py``, and against the JAX package.

Each case runs the reference case's assertions on the port, then holds the
port's results against the JAX package's on the same domain and seeds:
``EvalTable`` arrays and prefix-cache statistics bit-equal (the engines are
host numpy code in both), decisions equal on a DSQE trained once by the
JAX package and carried across (``DSQE.from_numpy``; the port's own
``train_dsqe`` draws from another generator, ``tests/carried_server.py``).
"""
import numpy as np
import pytest
import torch

from carried_server import carried_servers
from repro.core.cca import critical_component_analysis as jax_cca
from repro.core.domains import build_domain as jax_build_domain
from repro.core.domains import train_test_split as jax_split
from repro.core.dsqe import train_dsqe as jax_train_dsqe
from repro.core.emulator import Emulator as JaxEmulator
from repro.core.paths import PathSpace as JaxPathSpace
from repro.core.rps import RuntimePathSelector as JaxSelector
from repro.core.slo import SLO as JaxSLO
from repro.runtime.server import Request as JaxRequest
from repro_torch.core.cca import critical_component_analysis
from repro_torch.core.domains import build_domain, train_test_split
from repro_torch.core.dsqe import DSQE
from repro_torch.core.emulator import Emulator
from repro_torch.core.paths import PathSpace
from repro_torch.core.rps import RuntimePathSelector
from repro_torch.core.slo import SLO
from repro_torch.runtime.server import Request

torch.set_num_threads(1)

SLO_ARGS = [{}, {"max_latency_s": 2.0, "max_cost_usd": 0.004},
            {"max_latency_s": 1e-6, "max_cost_usd": 0.0}]


@pytest.fixture(scope="module")
def domain():
    return build_domain("agriculture", n_queries=40, seed=3)


@pytest.fixture(scope="module")
def jdomain():
    return jax_build_domain("agriculture", n_queries=40, seed=3)


@pytest.fixture(scope="module")
def space():
    return PathSpace()


@pytest.fixture(scope="module")
def jax_tables(jdomain):
    """The JAX package's batched table per (budget, lam), built once."""
    memo = {}

    def get(budget, lam):
        if (budget, lam) not in memo:
            memo[budget, lam] = JaxEmulator(jdomain, JaxPathSpace(), seed=3
                                            ).explore(list(range(24)),
                                                      budget=budget, lam=lam,
                                                      batched=True)
        return memo[budget, lam]
    return get


def _tables(domain, space, budget, lam, seed=3):
    qs = list(range(24))
    scalar = Emulator(domain, space, seed=seed).explore(
        qs, budget=budget, lam=lam, batched=False)
    batched = Emulator(domain, space, seed=seed).explore(
        qs, budget=budget, lam=lam, batched=True)
    return scalar, batched


@pytest.mark.parametrize("budget,lam", [(None, 0), (3.0, 0), (3.0, 1)])
def test_explore_parity_exact(domain, space, jax_tables, budget, lam):
    ts, tb = _tables(domain, space, budget, lam)
    # bit-for-bit: same cells evaluated, same metrics, same judge noise
    assert np.array_equal(ts.evaluated, tb.evaluated)
    assert np.array_equal(ts.accuracy, tb.accuracy, equal_nan=True)
    assert np.array_equal(ts.latency, tb.latency, equal_nan=True)
    assert np.array_equal(ts.cost, tb.cost, equal_nan=True)
    want = jax_tables(budget, lam)
    assert tb.query_ids == want.query_ids
    assert [p.key for p in tb.paths] == [p.key for p in want.paths]
    for f in ("evaluated", "accuracy", "latency", "cost"):
        a, b = getattr(tb, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), f


@pytest.mark.parametrize("budget,lam", [(None, 0), (3.0, 0), (3.0, 1)])
def test_cache_stats_parity(domain, space, jax_tables, budget, lam):
    ts, tb = _tables(domain, space, budget, lam)
    assert ts.cache_stats == tb.cache_stats
    assert tb.cache_stats["hit_rate"] > 0.3  # paper §3.2.4 savings preserved
    assert tb.cache_stats == jax_tables(budget, lam).cache_stats


def test_run_block_matches_scalar_run(domain, jdomain, space):
    emu = Emulator(domain, space, seed=3)
    q = domain.queries[5]
    acc, lat, cost = emu.batched.run_block(q)
    for j, path in enumerate(space.paths):
        a, l, c = emu.exec.run(q, path)
        assert a == acc[j] and l == lat[j] and c == cost[j]
    jemu = JaxEmulator(jdomain, JaxPathSpace(), seed=3)
    for got, want in zip((acc, lat, cost),
                         jemu.batched.run_block(jdomain.queries[5])):
        assert np.array_equal(got, want)


def test_run_block_degenerate_blocks(domain, jdomain, space):
    """Duplicate path ids must not trip the full-sweep fast path; empty
    blocks return empty arrays instead of crashing."""
    emu = Emulator(domain, space, seed=3)
    jemu = JaxEmulator(jdomain, JaxPathSpace(), seed=3)
    q = domain.queries[0]
    dup = np.zeros(len(space.paths), np.int64)  # size P but all path 0
    a, l, c = emu.batched.run_block(q, dup)
    a0, l0, c0 = emu.exec.run(q, space.paths[0])
    assert np.all(a == a0) and np.all(l == l0) and np.all(c == c0)
    for got, want in zip((a, l, c),
                         jemu.batched.run_block(jdomain.queries[0], dup)):
        assert np.array_equal(got, want)
    a, l, c = emu.batched.run_block(q, np.array([], np.int64))
    assert a.size == 0 and l.size == 0 and c.size == 0
    wa, _, _ = jemu.batched.run_block(jdomain.queries[0],
                                      np.array([], np.int64))
    assert a.dtype == wa.dtype


@pytest.fixture(scope="module")
def selectors(domain, jdomain, space):
    """The port's selector and the JAX package's, on the JAX-trained DSQE
    (120 steps, seed 3, as the reference case trains it)."""
    train_idx, test_idx = train_test_split(domain, 0.3)
    jtrain, jtest = jax_split(jdomain, 0.3)
    assert np.array_equal(test_idx, jtest)
    table = Emulator(domain, space, seed=3).explore(train_idx, budget=3.0,
                                                    lam=0)
    jtable = JaxEmulator(jdomain, JaxPathSpace(), seed=3).explore(
        jtrain, budget=3.0, lam=0)
    cca, jcca = critical_component_analysis(table, lam=0), jax_cca(jtable, lam=0)
    assert cca.set_ids.tolist() == jcca.set_ids.tolist()
    emb = domain.query_embeddings[train_idx]
    jdsqe = jax_train_dsqe(jdomain.query_embeddings[jtrain], jcca.set_ids,
                           len(jcca.set_vocab), steps=120, seed=3)
    dsqe = DSQE.from_numpy(jdsqe.params, jdsqe.n_sets, device="cpu")
    rps = RuntimePathSelector(space, dsqe, cca, table, emb, lam=0)
    jrps = JaxSelector(JaxPathSpace(), jdsqe, jcca, jtable,
                       jdomain.query_embeddings[jtrain], lam=0)
    return rps, jrps, test_idx


def _decision(d):
    return (d.path.key, d.set_id, d.used_fallback, d.expected_latency_s,
            d.expected_cost_usd)


def test_select_batch_matches_select(domain, selectors):
    # Decisions are compared exactly: deterministic on a fixed platform.
    rps, jrps, test_idx = selectors
    slos = [SLO(**a) for a in SLO_ARGS]
    embs = domain.query_embeddings[test_idx]
    for slo, a in zip(slos, SLO_ARGS):
        singles = [rps.select(domain.query_embeddings[q], slo) for q in test_idx]
        batch = rps.select_batch(embs, slo)
        for s, b in zip(singles, batch):
            assert s.path.key == b.path.key
            assert s.set_id == b.set_id
            assert s.used_fallback == b.used_fallback
            assert s.expected_latency_s == b.expected_latency_s
            assert s.expected_cost_usd == b.expected_cost_usd
        assert [_decision(b) for b in batch] == \
            [_decision(w) for w in jrps.select_batch(embs, JaxSLO(**a))]
    # mixed per-query SLOs in one batch, where some queries fall back (the
    # impossible SLO) and others don't — both branches must be exercised
    mixed = [slos[i % len(slos)] for i in range(len(test_idx))]
    singles = [rps.select(domain.query_embeddings[q], s)
               for q, s in zip(test_idx, mixed)]
    batch = rps.select_batch(embs, mixed)
    fallbacks = {b.used_fallback for b in batch}
    assert fallbacks == {True, False}
    for s, b in zip(singles, batch):
        assert (s.path.key, s.used_fallback) == (b.path.key, b.used_fallback)
    jmixed = [JaxSLO(**SLO_ARGS[i % len(slos)]) for i in range(len(test_idx))]
    assert [_decision(b) for b in batch] == \
        [_decision(w) for w in jrps.select_batch(embs, jmixed)]


def test_decision_overhead_reports_both_amortized_and_batch(domain, selectors):
    """`overhead_s` is the per-query (amortized) figure that
    `Response.selection_overhead_s` carries; `batch_overhead_s` is the full
    selection-pass wall-clock (== overhead_s for single `select`).  The
    times are the host's; the decisions beside them are the JAX
    package's."""
    rps, jrps, test_idx = selectors
    single = rps.select(domain.query_embeddings[test_idx[0]], SLO())
    assert single.batch_overhead_s == single.overhead_s > 0.0
    assert _decision(single) == _decision(
        jrps.select(domain.query_embeddings[test_idx[0]], JaxSLO()))

    B = len(test_idx)
    batch = rps.select_batch(domain.query_embeddings[test_idx], SLO())
    totals = {d.batch_overhead_s for d in batch}
    assert len(totals) == 1  # one selection pass, one wall-clock
    total = totals.pop()
    for d in batch:
        assert d.overhead_s == pytest.approx(total / B)
        assert d.overhead_s < d.batch_overhead_s


def test_handle_batch_matches_handle():
    jserver, server, test_idx = carried_servers()
    slo = dict(max_latency_s=8.0, max_cost_usd=0.02)
    reqs = [Request(prompt="", qid=q, slo=SLO(**slo)) for q in test_idx[:8]]
    batch = server.handle_batch(reqs)
    singles = [server.handle(r) for r in reqs]
    for s, b in zip(singles, batch):
        assert s.path_key == b.path_key
        assert s.accuracy == b.accuracy
        assert s.latency_s == b.latency_s
        assert s.cost_usd == b.cost_usd
        assert s.slo_ok == b.slo_ok
    want = jserver.handle_batch([JaxRequest(prompt="", qid=q, slo=JaxSLO(**slo))
                                 for q in test_idx[:8]])
    key = lambda r: (r.path_key, r.accuracy, r.latency_s, r.cost_usd,
                     r.slo_ok, r.meta["set_id"], r.meta["fallback"])
    assert [key(b) for b in batch] == [key(w) for w in want]
    server.fleet.close()
    jserver.fleet.close()


# -- the exact_match gate of benchmarks/batch_speedup.py --------------------


def test_batch_benchmark_exact_match_at_smoke_size():
    """The benchmark's smoke workloads (smarthome exhaustive and at budget
    3; 8 queries, seed 0): the scalar and the batched explore bit-for-bit
    (its ``exact_match``), and the batched table equal to the JAX
    package's."""
    dom = build_domain("smarthome", n_queries=8, seed=0)
    jdom = jax_build_domain("smarthome", n_queries=8, seed=0)
    for budget in (None, 3.0):
        ts, tb = (Emulator(dom, PathSpace(), seed=0).explore(
            list(range(8)), budget=budget, batched=b) for b in (False, True))
        assert ts.bit_equal(tb)
        want = JaxEmulator(jdom, JaxPathSpace(), seed=0).explore(
            list(range(8)), budget=budget, batched=True)
        assert tb.bit_equal(want)
