"""Cross-query batched retrieval of the port (``repro_torch.core.retrieval``)
against the JAX package, case by case with ``tests/test_retrieval_batch.py``.

Each case runs the reference case's assertions on the port, then holds the
port's results against the JAX package's on the same numpy arrays: ids and
score bit patterns equal (the store is host numpy code in both), IVF lists
equal, emulator tables and prefix-cache statistics bit-equal.  The device
path (``use_kernel=True``) runs the port's plain ``retrieval_topk`` here,
on a store whose device is the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.domains import build_domain as jax_build_domain
from repro.core.emulator import Emulator as JaxEmulator
from repro.core.paths import PathSpace as JaxPathSpace
from repro.core.retrieval import VectorStore as JaxVectorStore
from repro.core.retrieval import _order_keys as jax_order_keys
from repro.kernels.retrieval_topk.ref import retrieval_topk_ref as jax_topk_ref
from repro_torch.core.domains import build_domain
from repro_torch.core.emulator import Emulator
from repro_torch.core.paths import PathSpace
from repro_torch.core.retrieval import SearchResult, VectorStore, _order_keys
from repro_torch.kernels.retrieval_topk.ops import retrieval_topk

torch.set_num_threads(1)


def _corpus(n=512, d=64, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    return emb / np.linalg.norm(emb, axis=1, keepdims=True)


def _queries(b, d=64, seed=1):
    return np.random.default_rng(seed).standard_normal((b, d)).astype(np.float32)


def _stores(emb, **kw):
    """The port's store (device: the CPU) and the JAX package's, on one
    array; their IVF lists must be equal."""
    store, jstore = VectorStore(emb, device="cpu", **kw), JaxVectorStore(emb, **kw)
    assert (store.ivf is None) == (jstore.ivf is None)
    if store.ivf is not None:
        assert np.array_equal(store.ivf["centroids"], jstore.ivf["centroids"])
        assert all(np.array_equal(a, b) for a, b in
                   zip(store.ivf["lists"], jstore.ivf["lists"], strict=True))
    return store, jstore


def _assert_rows_equal(scalar: SearchResult, batched: SearchResult):
    assert np.array_equal(scalar.ids, batched.ids)
    # scores must share the exact bit pattern, not just be close
    assert np.array_equal(
        scalar.scores.view(np.uint32), batched.scores.view(np.uint32))


def _assert_all_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.ids.dtype == w.ids.dtype
        _assert_rows_equal(g, w)


# -- bitwise parity ---------------------------------------------------------


@pytest.mark.parametrize("n_clusters,nprobe", [(0, 4), (16, 1), (16, 3), (16, 16)])
@pytest.mark.parametrize("k", [1, 5, 64])
def test_search_batch_bitwise_parity(n_clusters, nprobe, k):
    store, jstore = _stores(_corpus(), n_clusters=n_clusters, seed=0)
    Q = _queries(37)
    batch = store.search_batch(Q, k, nprobe=nprobe)
    assert len(batch) == len(Q)
    for q, b in zip(Q, batch):
        _assert_rows_equal(store.search(q, k, nprobe=nprobe), b)
        assert len(set(b.ids.tolist())) == len(b.ids)  # never duplicates
    _assert_all_equal(batch, jstore.search_batch(Q, k, nprobe=nprobe))


def test_search_batch_parity_on_domain_embeddings():
    """Real corpus embeddings at emulator scale, every top_k in the space."""
    dom = build_domain("agriculture", n_queries=12, seed=2)
    jdom = jax_build_domain("agriculture", n_queries=12, seed=2)
    assert np.array_equal(dom.chunk_embeddings, jdom.chunk_embeddings)
    store, jstore = _stores(dom.chunk_embeddings)
    Q = dom.query_embeddings[:12].astype(np.float32)
    assert np.array_equal(Q, jdom.query_embeddings[:12])
    for k in (2, 8, 16):
        batch = store.search_batch(Q, k)
        for q, b in zip(Q, batch):
            _assert_rows_equal(store.search(q, k), b)
        _assert_all_equal(batch, jstore.search_batch(Q, k))


def test_exact_tie_breaks_by_lowest_id():
    emb = _corpus()
    emb[40] = emb[3]
    emb[200] = emb[3]  # three identical chunks
    store, jstore = _stores(emb)
    r = store.search(emb[3], 3)
    assert list(r.ids) == [3, 40, 200]
    _assert_rows_equal(r, jstore.search(emb[3], 3))
    Q = np.stack([emb[3], emb[3]])
    rb = store.search_batch(Q, 3)
    for b in rb:
        assert list(b.ids) == [3, 40, 200]
    _assert_all_equal(rb, jstore.search_batch(Q, 3))


def test_boundary_tie_group_wider_than_prefilter_band():
    """A tie group spanning past the 2k candidate band must still resolve
    to the lowest ids (the band widens to the full row)."""
    emb = np.zeros((64, 8), np.float32)
    emb[:, 0] = 1.0  # every chunk identical -> all scores tie
    q = np.zeros(8, np.float32)
    q[0] = 1.0
    store, jstore = _stores(emb)
    r = store.search(q, 5)
    assert list(r.ids) == [0, 1, 2, 3, 4]
    Q = np.stack([q, q, q])
    rb = store.search_batch(Q, 5)
    for b in rb:
        assert list(b.ids) == [0, 1, 2, 3, 4]
    _assert_all_equal(rb, jstore.search_batch(Q, 5))


def test_order_keys_monotone_across_signs():
    scores = np.array([-2.0, -0.5, 0.0, 0.5, 2.0], np.float32)
    ids = np.zeros(5, np.int64)
    keys = _order_keys(scores, ids)
    assert list(np.argsort(keys)) == [0, 1, 2, 3, 4]
    # same score, different id: lower id -> bigger key
    k2 = _order_keys(np.array([1.0, 1.0], np.float32), np.array([3, 7]))
    assert k2[0] > k2[1]
    assert np.array_equal(keys, jax_order_keys(scores, ids))
    assert np.array_equal(k2, jax_order_keys(np.array([1.0, 1.0], np.float32),
                                             np.array([3, 7])))
    # every sign, zero, extreme and subnormal pattern, and ids to the edge
    rng = np.random.default_rng(0)
    s = np.concatenate([rng.standard_normal(200).astype(np.float32),
                        np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45,
                                  3.4e38, -3.4e38], np.float32)])
    i = rng.integers(0, (1 << 21) - 1, s.size)
    assert np.array_equal(_order_keys(s, i), jax_order_keys(s, i))


def test_signed_zero_scores_tie_by_lowest_id():
    """+0.0 == -0.0 numerically, so mixed-sign zero scores must still
    tie-break by lowest chunk id, not by sign bit."""
    k = _order_keys(np.array([0.0, -0.0], np.float32), np.array([5, 2]))
    assert k[1] > k[0]  # id 2 outranks id 5 despite the -0.0 bit pattern
    assert np.array_equal(k, jax_order_keys(np.array([0.0, -0.0], np.float32),
                                            np.array([5, 2])))
    emb = np.zeros((8, 4), np.float32)
    emb[:, 0] = [-1.0, 1.0, -1.0, 1.0, -1.0, 1.0, -1.0, 1.0]
    q = np.zeros(4, np.float32)
    q[1] = 1.0  # orthogonal: every dot is an exact +/-0.0
    store, jstore = _stores(emb)
    r = store.search(q, 4)
    assert list(r.ids) == [0, 1, 2, 3]
    [b] = store.search_batch(q[None], 4)
    _assert_rows_equal(r, b)
    _assert_rows_equal(r, jstore.search(q, 4))


# -- explicit edge-case semantics ------------------------------------------


def test_k_exceeding_corpus_clamps_to_n():
    store, jstore = _stores(_corpus(n=10))
    r = store.search(_queries(1)[0], 50)
    assert r.ids.size == 10 and len(set(r.ids.tolist())) == 10
    [b] = store.search_batch(_queries(1), 50)
    _assert_rows_equal(r, b)
    _assert_rows_equal(r, jstore.search(_queries(1)[0], 50))


def test_nonpositive_k_returns_empty():
    store, jstore = _stores(_corpus(n=10))
    for k in (0, -3):
        r = store.search(_queries(1)[0], k)
        assert r.ids.size == 0 and r.scores.size == 0
        w = jstore.search(_queries(1)[0], k)
        assert (r.ids.dtype, r.scores.dtype) == (w.ids.dtype, w.scores.dtype)


def test_empty_probe_union_falls_back_to_full_scan():
    emb = _corpus()
    ivf, jivf = _stores(emb, n_clusters=8, seed=0)
    ivf.ivf["lists"] = [np.empty(0, np.int64)] * 8  # every list empty
    jivf.ivf["lists"] = [np.empty(0, np.int64)] * 8
    flat = VectorStore(emb, device="cpu")
    Q = _queries(5)
    batch = ivf.search_batch(Q, 7)
    for q, b in zip(Q, batch):
        _assert_rows_equal(flat.search(q, 7), b)
        _assert_rows_equal(ivf.search(q, 7), b)
    _assert_all_equal(batch, jivf.search_batch(Q, 7))


def test_nonpositive_nprobe_falls_back_to_full_scan():
    emb = _corpus()
    ivf, jivf = _stores(emb, n_clusters=8, seed=0)
    flat = VectorStore(emb, device="cpu")
    q = _queries(1)[0]
    r = ivf.search(q, 6, nprobe=0)
    _assert_rows_equal(flat.search(q, 6), r)
    _assert_rows_equal(jivf.search(q, 6, nprobe=0), r)


def test_ivf_returns_fewer_than_k_when_lists_are_small():
    emb = _corpus(n=64)
    ivf, jivf = _stores(emb, n_clusters=8, seed=0)
    for s in (ivf, jivf):
        s.ivf["lists"] = [np.arange(c * 8, c * 8 + 2) for c in range(8)]
    [b] = ivf.search_batch(_queries(1), 20, nprobe=2)
    assert 0 < b.ids.size <= 4  # two probed lists x 2 members
    _assert_rows_equal(ivf.search(_queries(1)[0], 20, nprobe=2), b)
    _assert_all_equal([b], jivf.search_batch(_queries(1), 20, nprobe=2))


def test_duplicate_candidate_ids_across_probed_lists():
    emb = _corpus()
    ivf, jivf = _stores(emb, n_clusters=8, seed=0)
    for s in (ivf, jivf):
        for c in range(8):  # same ids injected into EVERY list
            s.ivf["lists"][c] = np.concatenate(
                [s.ivf["lists"][c], np.array([5, 9, 5])])
    Q = _queries(9)
    batch = ivf.search_batch(Q, 6, nprobe=3)
    for q, b in zip(Q, batch):
        assert len(set(b.ids.tolist())) == len(b.ids)
        _assert_rows_equal(ivf.search(q, 6, nprobe=3), b)
    _assert_all_equal(batch, jivf.search_batch(Q, 6, nprobe=3))


def test_oversized_corpus_rejected():
    emb = np.zeros((1 << 21, 4), np.float32)
    with pytest.raises(ValueError, match="composite-key id space") as got:
        VectorStore(emb, device="cpu")
    with pytest.raises(ValueError) as want:
        JaxVectorStore(emb)
    assert str(got.value) == str(want.value)
    VectorStore(emb[:-1], device="cpu")  # the largest corpus it admits


# -- cross-query prefetch through the emulator ------------------------------


@pytest.fixture(scope="module")
def domains():
    dom = build_domain("smarthome", n_queries=16, seed=5)
    jdom = jax_build_domain("smarthome", n_queries=16, seed=5)
    return dom, jdom


@pytest.mark.parametrize("budget", [None, 3.0])
def test_explore_prefetch_bitwise_and_stat_parity(domains, budget):
    dom, jdom = domains
    space = PathSpace()
    qs = list(range(12))
    t_off = Emulator(dom, space, seed=5).explore(
        qs, budget=budget, batched=True, prefetch=False)
    t_on = Emulator(dom, space, seed=5).explore(
        qs, budget=budget, batched=True, prefetch=True)
    t_scalar = Emulator(dom, space, seed=5).explore(
        qs, budget=budget, batched=False)
    assert t_off.bit_equal(t_on)
    assert t_scalar.bit_equal(t_on)
    want = JaxEmulator(jdom, JaxPathSpace(), seed=5).explore(
        qs, budget=budget, batched=True, prefetch=True)
    assert [p.key for p in t_on.paths] == [p.key for p in want.paths]
    assert t_on.bit_equal(want)


def test_prefetch_resolves_stage_searches_in_batched_passes(domains):
    """After prefetch, the sweep's retrieval-stage searches all hit the
    memo: `VectorStore.search` runs only for corrective-rag re-searches;
    the port makes exactly the JAX package's calls."""
    def count(emu):
        calls = {"search": 0, "batch": 0}
        store = emu.exec.store
        orig_search, orig_batch = store.search, store.search_batch

        def counting_search(*a, **kw):
            calls["search"] += 1
            return orig_search(*a, **kw)

        def counting_batch(*a, **kw):
            calls["batch"] += 1
            return orig_batch(*a, **kw)

        store.search, store.search_batch = counting_search, counting_batch
        try:
            emu.explore(list(range(8)), budget=None, batched=True)
        finally:
            store.search, store.search_batch = orig_search, orig_batch
        return calls

    dom, jdom = domains
    emu = Emulator(dom, PathSpace(), seed=5)
    calls = count(emu)
    assert calls["batch"] >= 1  # cross-query passes actually happened
    s2_keys = {key for key in emu.exec._search_cache
               if key[3] in (2, 8)}  # the space's top_k values
    assert calls["search"] < len(s2_keys), \
        f"{calls['search']} scalar searches for {len(s2_keys)} stage configs"
    jemu = JaxEmulator(jdom, JaxPathSpace(), seed=5)
    assert calls == count(jemu)
    assert set(emu.exec._search_cache) == set(jemu.exec._search_cache)


def test_prefetch_retrieval_counts_and_idempotence(domains):
    dom, jdom = domains
    got = []
    for d, emu_cls, space_cls in ((dom, Emulator, PathSpace),
                                  (jdom, JaxEmulator, JaxPathSpace)):
        space = space_cls()
        emu = emu_cls(d, space, seed=5)
        qs = [d.queries[i] for i in range(6)]
        js = np.arange(len(space.paths))
        stats = emu.batched.prefetch_retrieval([(q, js) for q in qs])
        again = emu.batched.prefetch_retrieval([(q, js) for q in qs])
        got.append((stats, again))
    (stats, again), want = got
    assert stats["searches"] > 0 and stats["passes"] >= 1
    assert again == {"searches": 0, "passes": 0}  # memo already warm
    assert (stats, again) == want


# -- device path ------------------------------------------------------------


def test_kernel_interpret_matches_ref():
    """The reference case runs the Pallas kernel in interpret mode, which
    needs a TPU compiler parameter this JAX lacks; its twin holds the
    port's plain ``retrieval_topk`` (what a CPU tensor takes) against
    JAX's ``retrieval_topk_ref`` on the same inputs, tie included."""
    emb = _corpus(n=300, d=200, seed=3)
    emb[50] = emb[3]  # exact tie
    Q = _queries(17, d=200, seed=4)
    Q[0] = emb[3]
    v1, i1 = retrieval_topk(torch.from_numpy(Q), torch.from_numpy(emb), k=6)
    v2, i2 = jax_topk_ref(jnp.asarray(Q), jnp.asarray(emb), k=6)
    assert i1.dtype == torch.int32 and v1.dtype == torch.float32
    assert np.array_equal(i1.numpy(), np.asarray(i2))
    np.testing.assert_allclose(v1.numpy(), np.asarray(v2), atol=1e-5)
    assert list(i1.numpy()[0][:2]) == [3, 50]  # lowest-id tie-break


def test_device_path_decision_parity():
    """`use_kernel=True` must agree with the host path on ids wherever
    scores are separated beyond float32 noise; exactly-representable
    integer embeddings make the sums exact, so ties must agree too, and
    both equal the JAX package's device path."""
    rng = np.random.default_rng(6)
    emb = rng.integers(-3, 4, (128, 32)).astype(np.float32)
    emb[64] = emb[10]  # exact tie with exact arithmetic
    Q = rng.integers(-3, 4, (21, 32)).astype(np.float32)
    Q[0] = emb[10]
    store, jstore = _stores(emb)
    host = store.search_batch(Q, 7)
    dev = store.search_batch(Q, 7, use_kernel=True)
    for h, d in zip(host, dev):
        assert np.array_equal(h.ids, d.ids)
        assert np.array_equal(h.scores, d.scores)  # exact sums -> exact parity
    assert {10, 64}.issubset(set(dev[0].ids[:2].tolist()))
    _assert_all_equal(host, jstore.search_batch(Q, 7))
    jdev = jstore.search_batch(Q, 7, use_kernel=True)
    for d, w in zip(dev, jdev):
        assert np.array_equal(d.ids, w.ids)
        assert np.array_equal(d.scores, w.scores)


def test_device_path_k_clamp():
    store, jstore = _stores(_corpus(n=20))
    [b] = store.search_batch(_queries(1), 50, use_kernel=True)
    assert b.ids.size == 20
    [w] = jstore.search_batch(_queries(1), 50, use_kernel=True)
    assert np.array_equal(b.ids, w.ids)


# -- the correctness gates of benchmarks/retrieval_batch_speedup.py ---------


def test_retrieval_benchmark_gates_at_smoke_size():
    """The benchmark's smoke run (n 256, d 512, 32 queries, k 8; smarthome,
    6 queries) through its four correctness gates on the port: flat and
    IVF ``search_batch`` bit-equal to ``search``, the device path's ids
    equal to the host's, and exhaustive ``explore`` bit-for-bit with
    retrieval prefetch on and off.  Its speed floors are left out."""
    n, d, batch, k, seed = 256, 512, 32, 8, 0
    emb = _corpus(n, d, seed)
    Q = np.random.default_rng(seed + 1).standard_normal((batch, d)).astype(
        np.float32)
    flat, jflat = _stores(emb)
    ivf, jivf = _stores(emb, n_clusters=max(4, n // 128), seed=seed)
    for store, jstore in ((flat, jflat), (ivf, jivf)):
        got = store.search_batch(Q, k)
        for q, b in zip(Q, got):
            _assert_rows_equal(store.search(q, k), b)
        _assert_all_equal(got, jstore.search_batch(Q, k))
    host = flat.search_batch(Q, k)
    dev = flat.search_batch(Q, k, use_kernel=True)
    assert all(np.array_equal(h.ids, w.ids) for h, w in zip(host, dev))
    dom = build_domain("smarthome", n_queries=6, seed=seed)
    tables = [Emulator(dom, PathSpace(), seed=seed).explore(
        list(range(6)), budget=None, batched=True, prefetch=p)
        for p in (False, True)]
    assert tables[0].bit_equal(tables[1])
    jdom = jax_build_domain("smarthome", n_queries=6, seed=seed)
    want = JaxEmulator(jdom, JaxPathSpace(), seed=seed).explore(
        list(range(6)), budget=None, batched=True, prefetch=True)
    assert tables[1].bit_equal(want)
