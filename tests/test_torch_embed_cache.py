"""Open-world prompt embedding LRU of the port
(``repro_torch.runtime.server.EcoLLMServer._embed_prompt``), case by case
with ``tests/test_embed_cache.py``, and against the JAX package.

Each case runs the reference case's assertions on the port; the JAX
package's server goes through the same calls beside it, and the cache's
contents, counters, embeddings (bit for bit) and resolved queries must be
equal.  The threaded case compares what threads cannot reorder: the
embeddings, the resolved queries and the cache's final contents.
"""
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro.core.text import embed_text as jax_embed_text
from repro.runtime.server import EcoLLMServer as JaxServer
from repro.runtime.server import Request as JaxRequest
from repro_torch.core.text import embed_text
from repro_torch.runtime.server import EcoLLMServer, Request


class _MiniDomain:
    """Just enough DomainData surface for `_resolve_query`."""

    def __init__(self, n=4, d=512, seed=0):
        rng = np.random.default_rng(seed)
        embs = rng.normal(size=(n, d)).astype(np.float32)
        self.query_embeddings = embs / np.linalg.norm(embs, axis=1,
                                                      keepdims=True)
        self.queries = [f"known-query-{i}" for i in range(n)]


def _servers(**kw):
    # rps/executor are never touched by the embed-cache paths under test
    return tuple(cls(_MiniDomain(), rps=None, executor=None, n_replicas=1,
                     max_workers=1, **kw) for cls in (EcoLLMServer, JaxServer))


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def test_lru_eviction_order_and_counters():
    srv, jsrv = _servers()
    trace = []
    for s in (srv, jsrv):
        s.EMBED_CACHE_MAX = 2  # instance override shadows the class attr
        steps = []
        for prompt in ("alpha", "beta", "alpha", "gamma", "beta"):
            emb = s._embed_prompt(prompt)
            steps.append((list(s._embed_cache), s.embed_cache_hits,
                          s.embed_cache_misses, _bits(emb).tolist()))
        trace.append(steps)

    # the reference case's checkpoints, on the port
    assert trace[0][3][:3] == (["alpha", "gamma"], 1, 3)
    assert set(srv._embed_cache) == {"gamma", "beta"}
    assert srv.embed_cache_misses == 4
    assert len(srv._embed_cache) <= srv.EMBED_CACHE_MAX
    # every step (LRU order, counters, embedding bits) as the JAX server's
    assert trace[0] == trace[1]


def test_embed_values_stable_across_hits():
    srv, jsrv = _servers()
    prompt = "how do I reset the thermostat?"
    first = srv._embed_prompt(prompt)
    again = srv._embed_prompt(prompt)
    assert again is first  # the cached object itself, not a recompute
    np.testing.assert_array_equal(first, embed_text(prompt))
    assert first.dtype == np.float32
    assert np.array_equal(_bits(first), _bits(jsrv._embed_prompt(prompt)))
    assert np.array_equal(_bits(first), _bits(jax_embed_text(prompt)))


def test_concurrent_resolve_query_exact_accounting():
    """Hammer `_resolve_query` from many threads over a small prompt set:
    every call increments exactly one counter (hits + misses == calls), the
    cache stays within its bound, and resolution is correct throughout —
    the same embeddings and resolved queries as the JAX server's."""
    srv, jsrv = _servers()
    prompts = [f"prompt number {i} with some words" for i in range(10)]
    n_threads, per_thread = 8, 50
    expected = {p: embed_text(p) for p in prompts}
    expected_qid = {
        p: int(np.argmax(srv.domain.query_embeddings @ expected[p]))
        for p in prompts}
    for p in prompts:
        query, emb = jsrv._resolve_query(JaxRequest(prompt=p))
        assert np.array_equal(_bits(emb), _bits(expected[p]))
        assert query == srv.domain.queries[expected_qid[p]]
    start = threading.Barrier(n_threads)
    failures = []

    def worker(tid):
        start.wait()
        rng = np.random.default_rng(tid)
        for _ in range(per_thread):
            p = prompts[int(rng.integers(len(prompts)))]
            query, emb = srv._resolve_query(Request(prompt=p))
            if not np.array_equal(emb, expected[p]):
                failures.append(f"bad embedding for {p!r}")
            if query != srv.domain.queries[expected_qid[p]]:
                failures.append(f"bad OOD resolution for {p!r}")

    with ThreadPoolExecutor(n_threads) as pool:
        list(pool.map(worker, range(n_threads)))

    assert not failures
    total = n_threads * per_thread
    assert srv.embed_cache_hits + srv.embed_cache_misses == total
    # every distinct prompt misses at least once; concurrent first touches
    # may each count a miss (setdefault keeps one winner), never a loss
    assert len(prompts) <= srv.embed_cache_misses <= total
    assert len(srv._embed_cache) == len(prompts) <= srv.EMBED_CACHE_MAX
    assert set(srv._embed_cache) == set(jsrv._embed_cache)
