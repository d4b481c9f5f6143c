"""Port selection ops (``repro_torch.kernels``) against the JAX package's refs.

The same numpy inputs go through the JAX function and its port.  The JAX
side is ``retrieval_topk_ref`` / ``dsqe_score_ref`` / ``dsqe_score_from_topk``:
the Pallas ``interpret=True`` path needs ``pltpu.TPUCompilerParams``, which
the installed jax lacks.  On the CPU the port's wrappers take their plain
torch versions; ``tests/test_torch_cuda.py`` holds the CUDA kernels
against those plain versions on the card.

Tolerances: ids must be equal (inputs are continuous random, so no float
near-ties); values within 1e-5 absolute (unit-scale fp32 dot products
summed in another order); dsqe scores within 1e-5 (|score| <= knn, vote sums
over the same <= knn terms in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dsqe_score.ref import dsqe_score_from_topk as jax_from_topk
from repro.kernels.dsqe_score.ref import dsqe_score_ref as jax_dsqe_ref
from repro.kernels.retrieval_topk.ref import retrieval_topk_ref as jax_topk_ref
from repro_torch.kernels.common import NEG_INF, resolve_device, use_kernel
from repro_torch.kernels.dsqe_score.ops import dsqe_score
from repro_torch.kernels.dsqe_score.ref import dsqe_score_from_topk, dsqe_score_ref
from repro_torch.kernels.retrieval_topk.ops import retrieval_topk
from repro_torch.kernels.retrieval_topk.ref import retrieval_topk_ref

# several xdist workers share the CPU cores: torch's default of one thread
# per core in every worker oversubscribes them and stalls every test
torch.set_num_threads(1)

ATOL = 1e-5


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("Bq,n,d,k", [(1, 13, 64, 6), (5, 600, 64, 16),
                                      (8, 84, 256, 16), (3, 40, 512, 50)])
def test_retrieval_topk_matches_jax_ref(Bq, n, d, k):
    rng = np.random.default_rng(n + d)
    q = _unit(rng.normal(size=(Bq, d))).astype(np.float32)
    corpus = _unit(rng.normal(size=(n, d))).astype(np.float32)
    vals, ids = retrieval_topk(_t(q), _t(corpus), k=k)
    jv, ji = jax_topk_ref(jnp.asarray(q), jnp.asarray(corpus), k=min(k, n))
    assert vals.dtype == torch.float32 and ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), atol=ATOL)


def test_retrieval_topk_clamps_k_and_admits_lowest_id_on_ties():
    """k > n clamps to n; exactly tied rows (duplicates) come out in
    ascending id order, matching the JAX ref's stable top_k."""
    rng = np.random.default_rng(0)
    base = rng.normal(size=(4, 32)).astype(np.float32)
    corpus = np.concatenate([base, base, base[:1]])  # rows i, i+4, 8 tie
    q = rng.normal(size=(3, 32)).astype(np.float32)
    vals, ids = retrieval_topk(_t(q), _t(corpus), k=20)
    assert ids.shape == (3, 9)
    _, ji = jax_topk_ref(jnp.asarray(q), jnp.asarray(corpus), k=9)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    for row_v, row_i in zip(vals.numpy(), ids.numpy()):
        for a in range(8):
            if row_v[a] == row_v[a + 1]:
                assert row_i[a] < row_i[a + 1]


@pytest.mark.parametrize("n", [13, 600])
def test_retrieval_all_negative_rows_pick_real_rows(n):
    """The pad-fill hazard of tests/test_kernels.py: every similarity is
    negative; no zero row may appear and every id is a real corpus row."""
    rng = np.random.default_rng(n)
    corpus = np.abs(rng.normal(size=(n, 64))).astype(np.float32)
    q = -np.abs(rng.normal(size=(5, 64))).astype(np.float32)
    vals, ids = retrieval_topk(_t(q), _t(corpus), k=6)
    assert int(ids.max()) < n
    assert float(vals.max()) < 0.0
    _, ji = jax_topk_ref(jnp.asarray(q), jnp.asarray(corpus), k=6)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))


def _dsqe_inputs(Bq, d, K, N, P, seed):
    rng = np.random.default_rng(seed)
    q = _unit(rng.normal(size=(Bq, d))).astype(np.float32)
    protos = _unit(rng.normal(size=(K, d))).astype(np.float32)
    train = _unit(rng.normal(size=(N, d))).astype(np.float32)
    pathw = np.zeros((N, P), np.float32)
    pathw[np.arange(N), rng.integers(0, P, N)] = rng.uniform(0.3, 1.0, N)
    contains = (rng.uniform(size=(K, P)) < 0.6).astype(np.float32)
    lat = rng.uniform(0.1, 5.0, P).astype(np.float32)
    cost = rng.uniform(0.0, 0.01, P).astype(np.float32)
    prior = (rng.uniform(size=P) * 1e-3).astype(np.float32)
    valid = (rng.uniform(size=P) < 0.9).astype(np.float32)
    slo = np.stack([rng.uniform(0.0, 6.0, Bq),
                    rng.uniform(0.0, 0.012, Bq)], axis=1).astype(np.float32)
    return q, protos, train, pathw, contains, lat, cost, prior, valid, slo


def _assert_scores_match(scores, set_id, js, jid):
    js = np.asarray(js)
    np.testing.assert_array_equal(set_id.numpy(), np.asarray(jid))
    masked = js < NEG_INF / 2
    np.testing.assert_array_equal(scores.numpy() < NEG_INF / 2, masked)
    assert (scores.numpy()[masked] == np.float32(NEG_INF)).all()
    np.testing.assert_allclose(scores.numpy()[~masked], js[~masked], atol=ATOL)


@pytest.mark.parametrize("Bq,d,K,N,P,knn", [
    (1, 128, 3, 20, 64, 8), (5, 64, 7, 50, 210, 16), (9, 256, 23, 105, 210, 16),
    (9, 64, 5, 700, 130, 16)])
def test_dsqe_score_matches_jax_ref(Bq, d, K, N, P, knn):
    args = _dsqe_inputs(Bq, d, K, N, P, seed=Bq * N)
    scores, set_id = dsqe_score(*map(_t, args), knn=knn)
    js, jid = jax_dsqe_ref(*map(jnp.asarray, args), knn=knn)
    assert scores.dtype == torch.float32 and set_id.dtype == torch.int32
    _assert_scores_match(scores, set_id, js, jid)


def test_dsqe_score_from_topk_matches_jax():
    """The score stage's function on a shared top-k, with and without a
    prototype validity mask (the sharded path)."""
    args = _dsqe_inputs(6, 32, 5, 40, 30, seed=7)
    q, protos, train = args[:3]
    vals, ids = retrieval_topk_ref(_t(q), _t(train), k=8)
    proto_valid = np.array([1, 1, 0, 1, 0], np.float32)
    for pv in (None, proto_valid):
        kw = {} if pv is None else {"proto_valid": pv}
        scores, set_id = dsqe_score_from_topk(
            _t(q), vals, ids, *map(_t, args[1:2] + args[3:]),
            **{k: _t(v) for k, v in kw.items()})
        js, jid = jax_from_topk(
            jnp.asarray(q), jnp.asarray(vals.numpy()), jnp.asarray(ids.numpy()),
            *map(jnp.asarray, args[1:2] + args[3:]),
            **{k: jnp.asarray(v) for k, v in kw.items()})
        _assert_scores_match(scores, set_id, js, jid)


def test_prototype_tie_resolves_to_first_argmax_set():
    """tests/test_select_kernel.py's tie case: exactly tied prototypes pick
    the lowest index, not the union of tied critical sets."""
    d, K, N, P = 8, 3, 4, 6
    q = np.zeros((1, d), np.float32)
    q[0, 0] = 1.0
    protos = np.zeros((K, d), np.float32)
    protos[0, 0] = protos[1, 0] = 1.0
    protos[2, 1] = 1.0
    train = np.tile(q, (N, 1))
    pathw = np.zeros((N, P), np.float32)
    pathw[:, 0] = 0.5
    contains = np.zeros((K, P), np.float32)
    contains[0, :3] = 1.0
    contains[1, :] = 1.0
    args = (q, protos, train, pathw, contains, np.ones(P, np.float32),
            np.full(P, 1e-3, np.float32), np.zeros(P, np.float32),
            np.ones(P, np.float32), np.array([[10.0, 1.0]], np.float32))
    scores, set_id = dsqe_score(*map(_t, args), knn=2)
    js, jid = jax_dsqe_ref(*map(jnp.asarray, args), knn=2)
    assert int(set_id[0]) == int(jid[0]) == 0
    assert (scores[0, :3] > -1e29).all() and (scores[0, 3:] < -1e29).all()
    _assert_scores_match(scores, set_id, js, jid)


def test_float_tie_at_knn_boundary_admits_lowest_row():
    """Train rows 0 and 1 tie exactly and k=1 admits row 0 only, in the
    port and the JAX ref, deterministically."""
    d, K, P = 8, 2, 4
    q = np.zeros((1, d), np.float32)
    q[0, 0] = 1.0
    train = np.zeros((3, d), np.float32)
    train[0, 0] = train[1, 0] = 0.9
    train[2, 0] = 0.1
    pathw = np.zeros((3, P), np.float32)
    pathw[0, 1] = pathw[1, 2] = pathw[2, 3] = 1.0
    args = (q, np.eye(K, d, dtype=np.float32), train, pathw,
            np.ones((K, P), np.float32), np.ones(P, np.float32),
            np.full(P, 1e-3, np.float32), np.zeros(P, np.float32),
            np.ones(P, np.float32), np.array([[10.0, 1.0]], np.float32))
    runs = [dsqe_score(*map(_t, args), knn=1)[0].numpy()[0] for _ in range(2)]
    js, _ = jax_dsqe_ref(*map(jnp.asarray, args), knn=1)
    for r in runs:
        assert int(np.argmax(r)) == 1 and r[2] == 0.0
    np.testing.assert_array_equal(runs[0], runs[1])
    np.testing.assert_allclose(runs[0], np.asarray(js)[0], atol=1e-6)


def test_dsqe_all_negative_prototypes_keep_a_real_set():
    """The pad-prototype hazard of tests/test_kernels.py: all prototype
    similarities are negative; set_id stays a real prototype and matches
    the JAX ref."""
    rng = np.random.default_rng(3)
    K, P, N = 7, 130, 30
    q = _unit(np.abs(rng.normal(size=(5, 128)))).astype(np.float32)
    protos = _unit(-np.abs(rng.normal(size=(K, 128)))).astype(np.float32)
    train = _unit(rng.normal(size=(N, 128))).astype(np.float32)
    pw = rng.uniform(size=(N, P)).astype(np.float32)
    args = (q, protos, train, pw, np.ones((K, P), np.float32),
            np.ones(P, np.float32), np.ones(P, np.float32),
            np.zeros(P, np.float32), np.ones(P, np.float32),
            np.array([9.0, 9.0], np.float32))
    scores, set_id = dsqe_score(*map(_t, args), knn=4)
    js, jid = jax_dsqe_ref(*map(jnp.asarray, args), knn=4)
    assert int(set_id.max()) < K
    _assert_scores_match(scores, set_id, js, jid)


def test_cpu_tensors_take_the_plain_version():
    """The dispatch rule: CPU tensors never count a kernel launch."""
    before = (retrieval_topk.launches, dsqe_score.launches)
    args = _dsqe_inputs(2, 16, 3, 10, 5, seed=1)
    retrieval_topk(_t(args[0]), _t(args[2]), k=3)
    dsqe_score(*map(_t, args), knn=3)
    assert (retrieval_topk.launches, dsqe_score.launches) == before
    assert use_kernel(_t(args[0])) is False


def test_cuda_device_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")


def test_vector_store_kernel_path_matches_jax_and_host():
    """``VectorStore.search_batch(use_kernel=True)`` goes through the port's
    retrieve stage: ids equal the JAX package's device path and the host
    exact path, scores within 1e-5."""
    from repro.core.retrieval import VectorStore as JaxStore
    from repro_torch.core.retrieval import VectorStore

    rng = np.random.default_rng(4)
    emb = _unit(rng.normal(size=(300, 64))).astype(np.float32)
    q = _unit(rng.normal(size=(7, 64))).astype(np.float32)
    store = VectorStore(emb, device="cpu")
    got = store.search_batch(q, 10, use_kernel=True)
    want = JaxStore(emb).search_batch(q, 10, use_kernel=True)
    host = store.search_batch(q, 10)
    for g, w, h in zip(got, want, host):
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_array_equal(g.ids, h.ids)
        np.testing.assert_allclose(g.scores, w.scores, atol=ATOL)
