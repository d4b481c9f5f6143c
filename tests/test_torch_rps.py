"""Port runtime path selection (``repro_torch.core.rps``) against the JAX
package: the host modules it stands on are bit-for-bit copies, and with the
JAX-trained DSQE params carried across, the port's selector makes the same
decision as the reference on every row, for both engines.

Decisions compare exactly: (path key, set id, used_fallback, expected
latency, expected cost).  Floats feeding them differ only in the last ulps
(fp32 matmuls blocked differently by XLA and torch on the CPU).
"""
import numpy as np
import pytest
import torch

from repro.core.cca import critical_component_analysis as jax_cca
from repro.core.domains import build_domain as jax_build_domain
from repro.core.domains import train_test_split as jax_split
from repro.core.dsqe import train_dsqe as jax_train
from repro.core.emulator import Emulator as JaxEmulator
from repro.core.paths import PathSpace as JaxPathSpace
from repro.core.rps import DomainShardedSelector as JaxSharded
from repro.core.rps import OnlinePathStats as JaxOnline
from repro.core.rps import RuntimePathSelector as JaxSelector
from repro.core.slo import SLO as JaxSLO
from repro_torch.core.cca import critical_component_analysis
from repro_torch.core.domains import build_domain, train_test_split
from repro_torch.core.dsqe import DSQE
from repro_torch.core.emulator import Emulator
from repro_torch.core.paths import PathSpace
from repro_torch.core.rps import (DomainShardedSelector, OnlinePathStats,
                                  RuntimePathSelector, _f32_ceil, _f32_floor,
                                  bucket_batch, build_static_policy)
from repro_torch.core.slo import SLO

SLO_ARGS = [
    {},  # unconstrained
    {"max_latency_s": 2.0, "max_cost_usd": 0.004},
    {"max_latency_s": 1e-6, "max_cost_usd": 0.0},  # impossible -> fallback
    {"max_latency_s": 4.0, "max_cost_usd": 0.008},
]

# several xdist workers share the CPU cores: torch's default of one thread
# per core in every worker oversubscribes them and stalls every test
torch.set_num_threads(1)


def _build(mods, name, seed, n_queries=40, budget=3.0):
    build, split, emulator, space_cls, cca_fn = mods
    dom = build(name, n_queries=n_queries, seed=seed)
    space = space_cls()
    train_idx, test_idx = split(dom, 0.3)
    table = emulator(dom, space, seed=seed).explore(train_idx, budget=budget,
                                                    lam=0)
    cca = cca_fn(table, lam=0)
    return dom, space, table, cca, dom.query_embeddings[train_idx], test_idx


JAX_MODS = (jax_build_domain, jax_split, JaxEmulator, JaxPathSpace, jax_cca)
PORT_MODS = (build_domain, train_test_split, Emulator, PathSpace,
             critical_component_analysis)


@pytest.fixture(scope="module")
def rig():
    """(JAX side, port side) for ("agriculture", n_queries=40, seed=3,
    budget=3.0), the port's DSQE carried from the JAX-trained one."""
    j = _build(JAX_MODS, "agriculture", 3)
    p = _build(PORT_MODS, "agriculture", 3)
    jdsqe = jax_train(j[4], j[3].set_ids, len(j[3].set_vocab), steps=120,
                      seed=3)
    pdsqe = DSQE.from_numpy(jdsqe.params, jdsqe.n_sets, device="cpu")
    return j + (jdsqe,), p + (pdsqe,)


def _selectors(rig, **kw):
    (jdom, jspace, jtab, jcca, jemb, _, jdsqe), \
        (pdom, pspace, ptab, pcca, pemb, _, pdsqe) = rig
    return (JaxSelector(jspace, jdsqe, jcca, jtab, jemb, lam=0, **kw),
            RuntimePathSelector(pspace, pdsqe, pcca, ptab, pemb, lam=0, **kw))


def _slos(n, cls):
    return [cls(**SLO_ARGS[i % len(SLO_ARGS)]) for i in range(n)]


def _key(d):
    return (d.path.key, d.set_id, d.used_fallback, d.expected_latency_s,
            d.expected_cost_usd)


def test_offline_plane_is_bit_equal(rig):
    """build_domain embeddings, EvalTable arrays and CCA labels."""
    (jdom, _, jtab, jcca, *_), (pdom, _, ptab, pcca, *_) = rig
    np.testing.assert_array_equal(pdom.query_embeddings, jdom.query_embeddings)
    np.testing.assert_array_equal(pdom.chunk_embeddings, jdom.chunk_embeddings)
    assert [p.key for p in ptab.paths] == [p.key for p in jtab.paths]
    assert len(ptab.paths) == 210
    for field in ("accuracy", "latency", "cost", "evaluated"):
        np.testing.assert_array_equal(getattr(ptab, field),
                                      getattr(jtab, field), err_msg=field)
    np.testing.assert_array_equal(ptab.query_ids, jtab.query_ids)
    np.testing.assert_array_equal(pcca.set_ids, jcca.set_ids)
    np.testing.assert_array_equal(pcca.best_path, jcca.best_path)
    assert [tuple(s) for s in pcca.set_vocab] == [tuple(s) for s in jcca.set_vocab]


@pytest.mark.parametrize("use_kernel", [False, True])
def test_decision_parity_mixed_slos(rig, use_kernel):
    """Every row of the mixed-SLO batch (fallback rows included) decides
    the same path, set id and fallback flag in both packages."""
    jsel, psel = _selectors(rig, use_kernel=use_kernel)
    jdom, pdom = rig[0][0], rig[1][0]
    test_idx = rig[0][5]
    np.testing.assert_array_equal(rig[1][5], test_idx)
    jd = jsel.select_batch(jdom.query_embeddings[test_idx],
                           _slos(len(test_idx), JaxSLO))
    pd = psel.select_batch(pdom.query_embeddings[test_idx],
                           _slos(len(test_idx), SLO))
    assert {d.used_fallback for d in pd} == {True, False}
    assert [_key(d) for d in pd] == [_key(d) for d in jd]
    np.testing.assert_allclose(psel.train_emb_proj, jsel.train_emb_proj,
                               atol=1e-5)


def test_engines_and_single_select_agree(rig):
    """Inside the port: fused == staged == numpy batch == per-query select."""
    _, pnp = _selectors(rig)
    _, pk = _selectors(rig, use_kernel=True)
    pdom, test_idx = rig[1][0], rig[1][5]
    embs = pdom.query_embeddings[test_idx]
    slos = _slos(len(test_idx), SLO)
    want = [_key(d) for d in pnp.select_batch(embs, slos)]
    assert [_key(d) for d in pk.select_batch(embs, slos)] == want
    assert [_key(d) for d in pk.select_batch_staged(embs, slos)] == want
    assert [_key(pnp.select(e, s)) for e, s in zip(embs, slos)] == want


def test_single_select_parity(rig):
    """Per-query ``select`` (one row through the DSQE) decides as the JAX
    package's on every held-out query and SLO."""
    jsel, psel = _selectors(rig)
    jdom, pdom, test_idx = rig[0][0], rig[1][0], rig[1][5]
    for e, je, s, js in zip(pdom.query_embeddings[test_idx],
                            jdom.query_embeddings[test_idx],
                            _slos(len(test_idx), SLO),
                            _slos(len(test_idx), JaxSLO)):
        assert _key(psel.select(e, s)) == _key(jsel.select(je, js))


def test_one_bucket_count_per_bucket(rig):
    """kernel_trace_count counts distinct power-of-two buckets, not batch
    sizes, and pad rows never leak into decisions."""
    _, pnp = _selectors(rig)
    _, pk = _selectors(rig, use_kernel=True)
    pdom, test_idx = rig[1][0], rig[1][5]
    embs = pdom.query_embeddings[test_idx]
    for B, count in ((5, 1), (7, 1), (9, 2), (12, 2), (3, 2)):
        got = pk.select_batch(embs[:B], _slos(B, SLO))
        assert pk.kernel_trace_count == count
        assert len(got) == B
        assert [_key(d) for d in got] == \
            [_key(d) for d in pnp.select_batch(embs[:B], _slos(B, SLO))]
    assert [bucket_batch(b) for b in (1, 8, 9, 16, 17)] == [8, 8, 16, 16, 32]


def test_directed_rounding_and_static_policy(rig):
    x = np.array([0.1, 1.0, np.inf, 0.0, 1e-40])
    assert (_f32_ceil(x).astype(np.float64) >= x).all()
    assert (_f32_floor(x).astype(np.float64) <= x).all()
    from repro.core.rps import build_static_policy as jax_static
    for lam in (0, 1):
        assert build_static_policy(rig[1][2], lam) == jax_static(rig[0][2], lam)


def test_swap_table_and_sharded_selector_parity(rig):
    """One swap_table (with online statistics blended in) and a two-domain
    DomainShardedSelector decide as the JAX package does."""
    (jdom, jspace, jtab, jcca, jemb, jtest, jdsqe), \
        (pdom, pspace, ptab, pcca, pemb, ptest, pdsqe) = rig
    jsel, psel = _selectors(rig, use_kernel=True)
    rng = np.random.default_rng(0)
    P = len(jtab.paths)
    stats = dict(latency_s=rng.uniform(0.1, 3.0, P),
                 cost_usd=rng.uniform(0.0, 0.01, P),
                 accuracy=rng.uniform(0.3, 1.0, P),
                 weight=rng.uniform(0.0, 1.0, P))
    assert psel.swap_table(ptab, online=OnlinePathStats(**stats)) == \
        jsel.swap_table(jtab, online=JaxOnline(**stats)) == 1
    embs = pdom.query_embeddings[ptest]
    assert [_key(d) for d in psel.select_batch(embs, _slos(len(ptest), SLO))] \
        == [_key(d) for d in jsel.select_batch(embs, _slos(len(ptest), JaxSLO))]
    assert psel.kernel_trace_count == 1  # the swap added no bucket

    j2 = _build(JAX_MODS, "automotive", 4, n_queries=30)
    p2 = _build(PORT_MODS, "automotive", 4, n_queries=30)
    jdsqe2 = jax_train(j2[4], j2[3].set_ids, len(j2[3].set_vocab), steps=60,
                       seed=4)
    pdsqe2 = DSQE.from_numpy(jdsqe2.params, jdsqe2.n_sets, device="cpu")
    jsh = JaxSharded({"agri": jsel, "auto": JaxSelector(
        j2[1], jdsqe2, j2[3], j2[2], j2[4], lam=0)})
    psh = DomainShardedSelector({"agri": psel, "auto": RuntimePathSelector(
        p2[1], pdsqe2, p2[3], p2[2], p2[4], lam=0)})
    for name, dom, test in (("agri", pdom, ptest), ("auto", p2[0], p2[5])):
        embs = dom.query_embeddings[test]
        want = [_key(d) for d in jsh.select_batch(embs, _slos(len(test), JaxSLO),
                                                  name)]
        assert [_key(d) for d in psh.select_batch(
            embs, _slos(len(test), SLO), name)] == want
        assert [_key(d) for d in psh.select_batch_staged(
            embs, _slos(len(test), SLO), name)] == want
    assert psh.refresh_tables() == 1


def test_selector_keeps_tables_on_the_encoder_device(rig):
    """Every tensor of the fused pass's state lives on the DSQE's device."""
    from repro_torch.optim.optimizers import tree_leaves

    _, psel = _selectors(rig, use_kernel=True)
    state, _ = psel._ensure_kernel()
    leaves = tree_leaves([list(st) if isinstance(st, tuple) else st
                          for st in state if st is not None])
    assert len(leaves) == 5 + 1 + 7  # dsqe params, corpus, score tables
    assert {t.device for t in leaves} == {psel.dsqe.device}
