"""The repro_torch CUDA kernels on the card, against their plain versions.

Marked ``cuda``: they skip without a GPU.  This file imports no JAX, so it
runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: ids equal (continuous random inputs, no near-ties at these
sizes) and values within 1e-5 (unit-vector fp32 dot products summed in
another order than cuBLAS); dsqe scores within 1e-5 (sums of <= knn such
terms), masked entries exactly NEG_INF in both.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.common import NEG_INF, resolve_device
from repro_torch.kernels.dsqe_score.ops import dsqe_score
from repro_torch.kernels.dsqe_score.ref import dsqe_score_ref
from repro_torch.kernels.retrieval_topk.ops import retrieval_topk
from repro_torch.kernels.retrieval_topk.ref import retrieval_topk_ref

ATOL = 1e-5


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return resolve_device("cuda")


def _unit(rng, shape, dev):
    x = rng.normal(size=shape)
    x = x / np.linalg.norm(x, axis=-1, keepdims=True)
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _assert_topk(vals, ids, rv, ri):
    np.testing.assert_array_equal(ids.cpu().numpy(), ri.cpu().numpy())
    np.testing.assert_allclose(vals.cpu().numpy(), rv.cpu().numpy(), atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("Bq,n,d,k", [
    (5, 600, 64, 16), (37, 5000, 256, 16), (16, 3000, 512, 50),
    (3, 40, 100, 64), (1, 7, 3, 1), (9, 33, 256, 32), (6, 70, 1000, 33)])
def test_retrieval_topk_kernel_matches_plain(Bq, n, d, k):
    dev = _cuda()
    rng = np.random.default_rng(n + d)
    q, c = _unit(rng, (Bq, d), dev), _unit(rng, (n, d), dev)
    before = retrieval_topk.launches
    vals, ids = retrieval_topk(q, c, k=k)
    torch.cuda.synchronize()
    assert retrieval_topk.launches == before + 1
    assert vals.dtype == torch.float32 and ids.dtype == torch.int32
    _assert_topk(vals, ids, *retrieval_topk_ref(q, c, k=min(k, n)))


@pytest.mark.cuda
def test_retrieval_topk_kernel_ties_and_negative_rows():
    """Duplicated rows tie exactly in the kernel's own arithmetic and come
    out lowest id first across tile boundaries; all-negative similarities
    still pick real rows."""
    dev = _cuda()
    rng = np.random.default_rng(0)
    base = _unit(rng, (50, 64), dev)
    c = torch.cat([base, base, base])  # row i ties with i+50, i+100
    q = _unit(rng, (11, 64), dev)
    vals, ids = retrieval_topk(q, c, k=12)
    torch.cuda.synchronize()
    for row_v, row_i in zip(vals.cpu().numpy(), ids.cpu().numpy()):
        assert (np.diff(row_v) <= 0).all()
        for a in range(11):
            if row_v[a] == row_v[a + 1]:
                assert row_i[a] < row_i[a + 1]
        assert ((row_i >= 0) & (row_i < 150)).all()
    c_pos = torch.abs(_unit(rng, (600, 64), dev))
    q_neg = -torch.abs(_unit(rng, (5, 64), dev))
    vals, ids = retrieval_topk(q_neg, c_pos, k=6)
    assert int(ids.max()) < 600 and float(vals.max()) < 0.0
    _assert_topk(vals, ids, *retrieval_topk_ref(q_neg, c_pos, k=6))


def _dsqe_args(rng, dev, Bq, d, K, N, P):
    pathw = np.zeros((N, P), np.float32)
    pathw[np.arange(N), rng.integers(0, P, N)] = rng.uniform(0.3, 1.0, N)
    as_t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    slo = np.stack([rng.uniform(0.0, 6.0, Bq), rng.uniform(0.0, 0.012, Bq)], 1)
    return (_unit(rng, (Bq, d), dev), _unit(rng, (K, d), dev),
            _unit(rng, (N, d), dev), as_t(pathw),
            as_t(rng.uniform(size=(K, P)) < 0.6), as_t(rng.uniform(0.1, 5, P)),
            as_t(rng.uniform(0, 0.01, P)), as_t(rng.uniform(size=P) * 1e-3),
            as_t(rng.uniform(size=P) < 0.9), as_t(slo))


def _assert_dsqe(scores, set_id, rs, rid):
    assert torch.equal(set_id, rid)
    masked = rs < NEG_INF / 2
    assert torch.equal(scores < NEG_INF / 2, masked)
    assert (scores[masked] == NEG_INF).all()
    np.testing.assert_allclose(scores[~masked].cpu().numpy(),
                               rs[~masked].cpu().numpy(), atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("Bq,d,K,N,P,knn", [
    (37, 256, 23, 1000, 210, 16), (5, 64, 7, 50, 210, 16),
    (1, 128, 3, 20, 64, 8), (9, 256, 40, 700, 130, 64)])
def test_dsqe_score_kernel_matches_plain(Bq, d, K, N, P, knn):
    dev = _cuda()
    args = _dsqe_args(np.random.default_rng(N), dev, Bq, d, K, N, P)
    before = dsqe_score.launches
    scores, set_id = dsqe_score(*args, knn=knn)
    torch.cuda.synchronize()
    assert dsqe_score.launches == before + 1
    _assert_dsqe(scores, set_id, *dsqe_score_ref(*args, knn=knn))


@pytest.mark.cuda
def test_dsqe_score_kernel_ties():
    """Tied prototypes resolve to the first; tied train rows at the kNN
    boundary admit the lowest row (tests/test_select_kernel.py's cases)."""
    dev = _cuda()
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    d, P = 8, 6
    q = np.zeros((1, d))
    q[0, 0] = 1.0
    protos = np.zeros((3, d))
    protos[0, 0] = protos[1, 0] = 1.0
    protos[2, 1] = 1.0
    pathw = np.zeros((4, P))
    pathw[:, 0] = 0.5
    contains = np.zeros((3, P))
    contains[0, :3] = 1.0
    contains[1, :] = 1.0
    args = tuple(map(t, (q, protos, np.tile(q, (4, 1)), pathw, contains,
                         np.ones(P), np.full(P, 1e-3), np.zeros(P),
                         np.ones(P), [[10.0, 1.0]])))
    scores, set_id = dsqe_score(*args, knn=2)
    assert int(set_id[0]) == 0
    assert (scores[0, :3] > -1e29).all() and (scores[0, 3:] < -1e29).all()

    train = np.zeros((3, d))
    train[0, 0] = train[1, 0] = 0.9
    train[2, 0] = 0.1
    pathw = np.zeros((3, 4))
    pathw[0, 1] = pathw[1, 2] = pathw[2, 3] = 1.0
    args = tuple(map(t, (q, np.eye(2, d), train, pathw, np.ones((2, 4)),
                         np.ones(4), np.full(4, 1e-3), np.zeros(4), np.ones(4),
                         [[10.0, 1.0]])))
    scores, _ = dsqe_score(*args, knn=1)
    row = scores[0].cpu().numpy()
    assert int(np.argmax(row)) == 1 and row[2] == 0.0


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_they_cannot_take():
    dev = _cuda()
    q = torch.zeros((2, 8), device=dev)
    c = torch.zeros((100, 8), device=dev)
    with pytest.raises(ValueError, match="k <= 64"):
        retrieval_topk(q, c, k=65)
    with pytest.raises(TypeError, match="float32"):
        retrieval_topk(q.double(), c.double(), k=4)
    with pytest.raises(ValueError, match="contiguous"):
        retrieval_topk(q, torch.zeros((8, 100), device=dev).T, k=4)
    with pytest.raises(ValueError, match="shared memory"):
        retrieval_topk(torch.zeros((2, 4096), device=dev),
                       torch.zeros((10, 4096), device=dev), k=4)
    with pytest.raises(ValueError, match="mixed"):
        retrieval_topk(q, c.cpu(), k=4)


@pytest.mark.cuda
def test_kernels_launch_across_widths_in_any_order():
    """The shared-memory limit is set once per device and width, so a
    narrow width after a wide one must not lower it for the wide one
    (d = 640 needs more than the 48 KB a launch gets unasked)."""
    dev = _cuda()
    rng = np.random.default_rng(7)
    for d in (640, 64, 640, 300, 900, 64):
        q, c = _unit(rng, (6, d), dev), _unit(rng, (90, d), dev)
        _assert_topk(*retrieval_topk(q, c, k=8),
                     *retrieval_topk_ref(q, c, k=8))
        args = _dsqe_args(rng, dev, 6, d, 5, 90, 40)
        _assert_dsqe(*dsqe_score(*args, knn=8), *dsqe_score_ref(*args, knn=8))


@pytest.mark.cuda
def test_selector_on_the_card_decides_like_its_numpy_engine():
    """A served selector on the card: the fused pass (retrieval_topk kernel)
    decides every row as the numpy engine does, under mixed SLOs."""
    _cuda()
    from repro_torch.core.slo import SLO
    from repro_torch.launch.serve import build_server
    from repro_torch.runtime.server import Request

    server, test = build_server("agriculture", n_queries=40, budget=3.0,
                                seed=3, use_kernel=True, device="cuda")
    slo_args = [{}, {"max_latency_s": 2.0, "max_cost_usd": 0.004},
                {"max_latency_s": 1e-6, "max_cost_usd": 0.0}]
    slos = [SLO(**slo_args[i % 3]) for i in range(len(test))]
    embs = server.domain.query_embeddings[test]
    before = retrieval_topk.launches
    fused = server.rps.select_batch(embs, slos)
    assert retrieval_topk.launches == before + 1
    server.rps.use_kernel = False
    ref = server.rps.select_batch(embs, slos)
    assert [(d.path.key, d.set_id, d.used_fallback) for d in fused] == \
        [(d.path.key, d.set_id, d.used_fallback) for d in ref]
    server.rps.use_kernel = True
    resp = server.handle_batch([Request(prompt="", qid=int(q), slo=s)
                                for q, s in zip(test, slos)])
    assert len(resp) == len(test)
    server.fleet.close()
