"""The repro_torch CUDA kernels on the card, against their plain versions.

Marked ``cuda``: they skip without a GPU.  This file imports no JAX, so it
runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: ids equal (continuous random inputs, no near-ties at these
sizes; or entries that are multiples of 1/8, whose dot products are exact
in fp32, held against the plain version in float64) and values within 1e-5
(unit-vector fp32 dot products summed in another order than cuBLAS); dsqe
scores within 1e-5 (sums of <= knn such terms), masked entries exactly
NEG_INF in both.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.common import NEG_INF, resolve_device, sm_count
from repro_torch.kernels.dsqe_score.ops import dsqe_score
from repro_torch.kernels.dsqe_score.ref import dsqe_score_ref
from repro_torch.kernels.retrieval_topk import kernel as topk_kernel
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
    (3, 40, 100, 64), (1, 7, 3, 1), (9, 33, 256, 32), (6, 70, 1000, 33),
    (3, 700, 64, 65), (5, 300, 100, 128), (4, 90, 33, 90),  # select route
    (3, 500, 4095, 16), (2, 300, 4095, 100)])               # d = 4095
def test_retrieval_topk_kernel_matches_plain(Bq, n, d, k):
    dev = _cuda()
    rng = np.random.default_rng(n + d)
    q, c = _unit(rng, (Bq, d), dev), _unit(rng, (n, d), dev)
    variant = topk_kernel.route(min(k, n))
    before = retrieval_topk.launches, _topk_variant_counts()
    vals, ids = retrieval_topk(q, c, k=k)
    torch.cuda.synchronize()
    assert retrieval_topk.launches == before[0] + 1
    assert _topk_variant_counts()[variant] == before[1][variant] + 1
    assert vals.dtype == torch.float32 and ids.dtype == torch.int32
    _assert_topk(vals, ids, *retrieval_topk_ref(q, c, k=min(k, n)))


def _topk_variant_counts():
    return {v: getattr(retrieval_topk, f"launches_{v}")
            for v in topk_kernel.ROUTES}


@pytest.mark.cuda
@pytest.mark.parametrize("Bq,n,d,k", [
    (300, 20000, 64, 64),   # five query tiles, many splits and a merge
    (37, 5003, 100, 16),    # ragged B and n, d not a multiple of 32
    (65, 3 * 128 + 1, 36, 50),  # one row past the last whole tile
    (256, 16384, 256, 16),  # the deployment selection shape
    (64, 84, 256, 16),      # the served selection shape: one split
    (1, 129, 4, 1),
    (130, 40000, 32, 64),
    (37, 5003, 257, 16),    # odd d: rows copied 4 bytes at a time
    (9, 1000, 3, 8),
])
def test_retrieval_topk_tiled_kernel_matches_plain(Bq, n, d, k):
    """The tiled variant, with the corpus split as ``grid`` cuts it for
    this card (64- or 16-row query tiles, one split or many and a merge):
    each case asserts the tiled counter moved."""
    dev = _cuda()
    rng = np.random.default_rng(Bq + n + d)
    q, c = _unit(rng, (Bq, d), dev), _unit(rng, (n, d), dev)
    g = topk_kernel.grid(Bq, n, sm_count(q.device))
    assert (g.n_splits == 1) == (n <= 128)  # a split is whole 128-row tiles
    before = _topk_variant_counts()
    vals, ids = retrieval_topk(q, c, k=k)
    torch.cuda.synchronize()
    assert _topk_variant_counts() == {"tiled": before["tiled"] + 1,
                                      "select": before["select"]}
    _assert_topk(vals, ids, *retrieval_topk_ref(q, c, k=min(k, n)))


@pytest.mark.cuda
def test_retrieval_topk_tiled_kernel_takes_unaligned_rows():
    """Views whose base is not 16-byte aligned (d a multiple of 4) take the
    4-byte copies; the result equals the plain version's."""
    dev = _cuda()
    rng = np.random.default_rng(5)
    qb, cb = _unit(rng, (9, 64), dev), _unit(rng, (701, 64), dev)
    q, c = qb.reshape(-1)[1:1 + 8 * 64].reshape(8, 64), cb[1:]
    c = c.reshape(-1)[3:3 + 600 * 64].reshape(600, 64)
    assert q.data_ptr() % 16 and c.data_ptr() % 16
    assert not topk_kernel.vec4(q, c)
    for k in (16, 100):
        _assert_topk(*retrieval_topk(q, c, k=k),
                     *retrieval_topk_ref(q, c, k=k))


def _exact_inputs(rng, B, n, d, repeat=1):
    """Entries that are multiples of 1/8, so every dot product is exact in
    fp32 whatever the order of the sum, and exact ties are everywhere; the
    corpus is n / repeat rows repeated ``repeat`` times."""
    base = rng.integers(-3, 4, size=(n // repeat, d)) / 8.0
    c = np.tile(base, (repeat, 1))
    q = rng.integers(-3, 4, size=(B, d)) / 8.0
    return q, c


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 16, 50, 64, 65, 100, 300])
def test_retrieval_topk_tiled_kernel_ties_across_splits(k):
    """Exact ties on both sides of every split boundary and at the k-th
    place: the corpus is 128 rows repeated 40 times (every row ties with
    the rows 128 apart, which lie in other splits of 128 rows at B = 256),
    and entries are multiples of 1/8 at d = 32.  Ids must equal the plain
    version's in float64 (lowest id first on ties), values within 1e-5; k
    above 64 takes the select route."""
    dev = _cuda()
    rng = np.random.default_rng(k)
    qn, cn = _exact_inputs(rng, 256, 128 * 40, 32, repeat=40)
    c = torch.as_tensor(cn, dtype=torch.float32, device=dev)
    q = torch.as_tensor(qn, dtype=torch.float32, device=dev)
    assert topk_kernel.grid(256, c.shape[0], sm_count(q.device)).n_splits > 1
    variant = topk_kernel.route(k)
    before = _topk_variant_counts()
    vals, ids = retrieval_topk(q, c, k=k)
    torch.cuda.synchronize()
    assert _topk_variant_counts()[variant] == before[variant] + 1
    rv, ri = retrieval_topk_ref(q.double().cpu(), c.double().cpu(), k=k)
    np.testing.assert_array_equal(ids.cpu().numpy(), ri.numpy())
    np.testing.assert_allclose(vals.cpu().numpy(), rv.numpy(), atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,d,k", [
    (3, 700, 32, 65), (5, 300, 33, 128), (4, 90, 7, 90), (37, 5003, 100, 100),
    (2, 20000, 32, 9000),   # 16384 sort keys: sorted through global scratch
    (1, 17000, 5, 17000),   # k = n, odd d, spilled sort
    (300, 70000, 32, 100),  # two chunks of B
])
def test_retrieval_topk_select_route_matches_plain(B, n, d, k):
    """The select route on exact-arithmetic inputs full of ties (radix
    select on the k-th key, the lowest ids among those equal to it, the
    sort in shared memory or through a global scratch, B in chunks): ids
    equal the plain version's in float64."""
    dev = _cuda()
    rng = np.random.default_rng(n + k)
    qn, cn = _exact_inputs(rng, B, n, d)
    q = torch.as_tensor(qn, dtype=torch.float32, device=dev)
    c = torch.as_tensor(cn, dtype=torch.float32, device=dev)
    before = _topk_variant_counts()
    vals, ids = retrieval_topk(q, c, k=k)
    torch.cuda.synchronize()
    assert _topk_variant_counts()["select"] == before["select"] + 1
    rv, ri = retrieval_topk_ref(torch.as_tensor(qn), torch.as_tensor(cn), k=k)
    np.testing.assert_array_equal(ids.cpu().numpy(), ri.numpy())
    np.testing.assert_allclose(vals.cpu().numpy(), rv.numpy(), atol=ATOL)


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
    for k in (12, 120):
        vals, ids = retrieval_topk(q, c, k=k)
        torch.cuda.synchronize()
        for row_v, row_i in zip(vals.cpu().numpy(), ids.cpu().numpy()):
            assert (np.diff(row_v) <= 0).all()
            for a in range(k - 1):
                if row_v[a] == row_v[a + 1]:
                    assert row_i[a] < row_i[a + 1]
            assert ((row_i >= 0) & (row_i < 150)).all()
    c_pos = torch.abs(_unit(rng, (600, 64), dev))
    q_neg = -torch.abs(_unit(rng, (5, 64), dev))
    for k in (6, 70):
        vals, ids = retrieval_topk(q_neg, c_pos, k=k)
        assert int(ids.max()) < 600 and float(vals.max()) < 0.0
        _assert_topk(vals, ids, *retrieval_topk_ref(q_neg, c_pos, k=k))


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
    assert torch.equal(set_id.cpu(), rid.cpu())
    masked = rs < NEG_INF / 2
    assert torch.equal((scores < NEG_INF / 2).cpu(), masked.cpu())
    assert (scores[masked.to(scores.device)] == NEG_INF).all()
    np.testing.assert_allclose(scores.cpu()[~masked.cpu()].numpy(),
                               rs.cpu()[~masked.cpu()].numpy(), atol=ATOL)


def _dsqe_counts():
    return {v: getattr(dsqe_score, f"launches_{v}")
            for v in topk_kernel.ROUTES}


@pytest.mark.cuda
@pytest.mark.parametrize("Bq,d,K,N,P,knn", [
    (37, 256, 23, 1000, 210, 16), (5, 64, 7, 50, 210, 16),
    (1, 128, 3, 20, 64, 8), (9, 256, 40, 700, 130, 64),
    (300, 256, 32, 20000, 210, 16),   # many splits and the merge's epilogue
    (9, 256, 40, 700, 130, 100), (37, 100, 23, 1000, 211, 65),  # select
    (5, 64, 7, 300, 210, 300),        # knn = N
    (3, 257, 5, 500, 33, 20)])        # odd d
def test_dsqe_score_kernel_matches_plain(Bq, d, K, N, P, knn):
    dev = _cuda()
    args = _dsqe_args(np.random.default_rng(N), dev, Bq, d, K, N, P)
    variant = topk_kernel.route(min(knn, N))
    before = dsqe_score.launches, _dsqe_counts()
    scores, set_id = dsqe_score(*args, knn=knn)
    torch.cuda.synchronize()
    assert dsqe_score.launches == before[0] + 1
    assert _dsqe_counts()[variant] == before[1][variant] + 1
    _assert_dsqe(scores, set_id, *dsqe_score_ref(*args, knn=knn))


@pytest.mark.cuda
@pytest.mark.parametrize("knn", [1, 16, 64, 65, 100])
@pytest.mark.parametrize("B,K,N,P", [(256, 32, 128 * 40, 210),
                                     (7, 5, 128 * 3 + 17, 33)])
def test_dsqe_score_kernel_ties_across_splits(B, K, N, P, knn):
    """Exact-arithmetic inputs (multiples of 1/8 at d = 32): train rows
    repeat every 128 rows, so exact ties straddle every split boundary and
    sit at the knn-th place; every second prototype repeats the one before
    it, so the argmax ties on the first of equal prototypes.  Set ids and
    masks must equal the plain version's in float64, scores within 1e-5."""
    dev = _cuda()
    rng = np.random.default_rng(B + knn)
    qn, tn = _exact_inputs(rng, B, N - N % 128, 32, repeat=(N // 128))
    tn = np.concatenate([tn, tn[:N % 128]])
    protos = rng.integers(-3, 4, size=(K, 32)) / 8.0
    protos[1::2] = protos[:K // 2 * 2:2]
    pathw = np.zeros((N, P))
    pathw[np.arange(N), rng.integers(0, P, N)] = rng.integers(1, 9, N) / 8.0
    tables = (qn, protos, tn, pathw, rng.uniform(size=(K, P)) < 0.6,
              rng.uniform(0.1, 5, P), rng.uniform(0, 0.01, P),
              rng.uniform(size=P) * 1e-3, rng.uniform(size=P) < 0.9,
              np.stack([rng.uniform(0, 6, B), rng.uniform(0, 0.012, B)], 1))
    args = tuple(torch.as_tensor(np.asarray(t, np.float32), device=dev)
                 for t in tables)
    before = _dsqe_counts()
    scores, set_id = dsqe_score(*args, knn=knn)
    torch.cuda.synchronize()
    variant = topk_kernel.route(knn)
    assert _dsqe_counts()[variant] == before[variant] + 1
    ref64 = tuple(torch.as_tensor(np.asarray(t, np.float32).astype(np.float64))
                  for t in tables)
    rs, rid = dsqe_score_ref(*ref64, knn=knn)
    _assert_dsqe(scores, set_id, rs.float(), rid)


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
    with pytest.raises(TypeError, match="float32"):
        retrieval_topk(q.double(), c.double(), k=4)
    with pytest.raises(ValueError, match="contiguous"):
        retrieval_topk(q, torch.zeros((8, 100), device=dev).T, k=4)
    with pytest.raises(ValueError, match="mixed"):
        retrieval_topk(q, c.cpu(), k=4)
    # the variants reached only by name keep their own limits
    with pytest.raises(ValueError, match="k <= 64"):
        topk_kernel.launch(q, c, 65, "tiled")
    with pytest.raises(ValueError, match="shared memory"):  # row variant
        topk_kernel.launch(torch.zeros((2, 4095), device=dev),
                           torch.zeros((10, 4095), device=dev), 4, "row")


@pytest.mark.cuda
def test_kernel_wrappers_answer_what_the_reference_takes():
    """The inputs the first port refused (k > 64; an odd d whose warp-kernel
    tile does not fit shared memory) are answered and equal the plain
    version, and the smallest such input returns (1, 65)."""
    dev = _cuda()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q = torch.randn((1, 4), generator=gen, device=dev)
    c = torch.randn((65, 4), generator=gen, device=dev)
    vals, ids = retrieval_topk(q, c, k=65)
    assert vals.shape == ids.shape == (1, 65)
    _assert_topk(vals, ids, *retrieval_topk_ref(q, c, k=65))
    rng = np.random.default_rng(1)
    q, c = _unit(rng, (2, 4095), dev), _unit(rng, (10, 4095), dev)
    _assert_topk(*retrieval_topk(q, c, k=4), *retrieval_topk_ref(q, c, k=4))
    args = _dsqe_args(rng, dev, 3, 4095, 4, 80, 20)
    _assert_dsqe(*dsqe_score(*args, knn=70), *dsqe_score_ref(*args, knn=70))


@pytest.mark.cuda
def test_kernels_launch_across_widths_in_any_order():
    """The row variants' shared-memory limit is set once per device and
    width, so a narrow width after a wide one must not lower it for the
    wide one (d = 640 needs more than the 48 KB a launch gets unasked).
    The row variants are reached by name; the routes take the same widths
    beside them."""
    from repro_torch.kernels.dsqe_score import kernel as dsqe_kernel

    dev = _cuda()
    rng = np.random.default_rng(7)
    for d in (640, 64, 640, 300, 900, 64):
        for width in (d + 1, d):
            q, c = _unit(rng, (6, width), dev), _unit(rng, (90, width), dev)
            want = retrieval_topk_ref(q, c, k=8)
            _assert_topk(*topk_kernel.launch(q, c, 8, "row"), *want)
            _assert_topk(*retrieval_topk(q, c, k=8), *want)
        args = _dsqe_args(rng, dev, 6, d + 1, 5, 90, 40)
        want = dsqe_score_ref(*args, knn=8)
        _assert_dsqe(*dsqe_kernel.launch(*args, 8, "row"), *want)
        _assert_dsqe(*dsqe_score(*args, knn=8), *want)


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


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 100])
def test_store_device_path_equals_the_host_path_on_integers(k):
    """``VectorStore.search_batch(use_kernel=True)`` on the card against the
    host path: integer rows in [-3, 3] make every fp32 dot product exact,
    so ids and scores must be equal, planted duplicate rows included (the
    lowest ids win).  One launch per call on the route's counter; a second
    call reuses the resident corpus."""
    _cuda()
    from repro_torch.core.retrieval import VectorStore

    rng = np.random.default_rng(k)
    emb = rng.integers(-3, 4, (5000, 256)).astype(np.float32)
    dup = np.sort(rng.choice(4999, 150, replace=False))
    dup[-1] = 4999  # in the last, ragged tile
    emb[dup] = emb[dup[0]]
    Q = rng.integers(-3, 4, (21, 256)).astype(np.float32)
    Q[0] = emb[dup[0]]
    store = VectorStore(emb, device="cuda")
    host = store.search_batch(Q, k)
    variant = topk_kernel.route(k)
    for call in range(2):
        before = retrieval_topk.launches, _topk_variant_counts()
        dev = store.search_batch(Q, k, use_kernel=True)
        assert retrieval_topk.launches == before[0] + 1
        assert _topk_variant_counts() == {
            v: n + (v == variant) for v, n in before[1].items()}
        if call == 0:
            resident = store._dev_emb
        assert store._dev_emb is resident
        for h, d in zip(host, dev):
            assert np.array_equal(h.ids, d.ids)
            assert np.array_equal(h.scores, d.scores)
        assert list(dev[0].ids) == list(dup[:k])


# -- attention kernels ------------------------------------------------------
#
# fp32: within 1e-5 of the plain version (the same fp32 softmax, summed in
# another order).  bf16: the same bf16 inputs feed both sides, and each
# element must lie within 2^-7 |ref| + 2^-8 (P|v|) of the plain version.  The
# first term covers the rounding of both outputs to bf16 (one bf16 ulp is at
# most 2^-7 of the value); the second the rounding of each weight p to bf16
# before the P.V product (at most 2^-9 of p, in the kernel as in the TPU
# kernels, and in the plain decode version too), summed with the weights
# over |v|: P|v| is the plain version run on |v|.
_F32_ATOL = 1e-5


def _randn(rng, shape, dtype, dev):
    return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                           device=dev).to(dtype)


def _assert_attn(out, ref, ref_abs_v, dtype):
    """``ref`` is the plain version on (q, k, v), ``ref_abs_v`` on
    (q, k, |v|)."""
    got, want = out.float().cpu().numpy(), ref.float().cpu().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=_F32_ATOL, rtol=_F32_ATOL)
        return
    limit = 2.0 ** -7 * np.abs(want) + 2.0 ** -8 * ref_abs_v.float().cpu().numpy()
    over = ~(np.abs(got - want) <= limit)  # NaN fails too
    assert not over.any(), f"{int(over.sum())} elements exceed the bf16 limit"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,H,Kv,hd,causal,window,chunk", [
    (2, 100, 100, 4, 4, 16, True, 0, 0),      # ragged Sq, G = 1
    (1, 257, 257, 16, 8, 128, True, 0, 0),    # the served widths, G = 2
    (2, 130, 130, 8, 2, 64, True, 48, 0),     # sliding window, G = 4
    (1, 200, 200, 4, 1, 32, True, 0, 64),     # chunked, MQA
    (2, 33, 190, 4, 2, 256, False, 0, 0),     # non-causal, Sq != Skv, hd 256
    (1, 64, 64, 2, 2, 48, True, 0, 0),        # hd 48: not a power of two
    # SeamlessM4T-medium's served shapes at batch 1 (16 heads of 64, 4096
    # encoder frames): cross-attention of one decode row and of the
    # 128-token decoder prefix, and the bidirectional encoder
    (1, 1, 4096, 16, 16, 64, False, 0, 0),
    (1, 128, 4096, 16, 16, 64, False, 0, 0),
    (1, 4096, 4096, 16, 16, 64, False, 0, 0),
])
def test_flash_attention_kernel_matches_plain(B, Sq, Skv, H, Kv, hd, causal,
                                              window, chunk, dtype):
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    dev = _cuda()
    rng = np.random.default_rng(Sq + hd)
    q = _randn(rng, (B, Sq, H, hd), dtype, dev)
    k = _randn(rng, (B, Skv, Kv, hd), dtype, dev)
    v = _randn(rng, (B, Skv, Kv, hd), dtype, dev)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window,
                          chunk_attn=chunk)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    masks = dict(causal=causal, window=window, chunk_attn=chunk)
    _assert_attn(out, flash_attention_ref(q, k, v, **masks),
                 flash_attention_ref(q, k, v.abs(), **masks), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,H,Kv,hd,causal,window,chunk", [
    (1, 100, 300, 4, 2, 64, False, 0, 0),    # Sq != Skv, ragged on 128 keys
    (1, 100, 250, 4, 2, 128, True, 0, 0),    # causal with Sq < Skv
    (1, 257, 257, 40, 8, 128, True, 0, 100),  # GQA G = 5, chunked, ragged
    (2, 191, 191, 10, 2, 128, True, 0, 0),   # G = 5, 128-row tile ragged
    (2, 129, 129, 10, 1, 256, True, 64, 0),  # MQA G = 10, window, 64 keys
    (1, 65, 200, 4, 4, 256, False, 0, 0),    # hd 256, ragged on 64 keys
    (1, 300, 300, 8, 1, 64, True, 33, 0),    # MQA, a window off the tiles
    (2, 64, 64, 2, 2, 192, True, 0, 0),      # hd 192: three 64-wide boxes
])
def test_flash_attention_tensor_core_kernel_matches_plain(
        B, Sq, Skv, H, Kv, hd, causal, window, chunk):
    """bf16 runs the wgmma kernel (128 query rows, 128-key tiles up to
    hd 128 and 64-key tiles above), at ragged edges and every mask."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    dev = _cuda()
    rng = np.random.default_rng(Sq * Skv + hd)
    dt = torch.bfloat16
    q = _randn(rng, (B, Sq, H, hd), dt, dev)
    k = _randn(rng, (B, Skv, Kv, hd), dt, dev)
    v = _randn(rng, (B, Skv, Kv, hd), dt, dev)
    masks = dict(causal=causal, window=window, chunk_attn=chunk)
    before = flash_attention.launches_tc, flash_attention.launches_ffma
    out = flash_attention(q, k, v, **masks)
    torch.cuda.synchronize()
    assert (flash_attention.launches_tc, flash_attention.launches_ffma) == \
        (before[0] + 1, before[1])
    assert out.dtype == dt and out.shape == q.shape
    _assert_attn(out, flash_attention_ref(q, k, v, **masks),
                 flash_attention_ref(q, k, v.abs(), **masks), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Kv,hd,W,ring,chunk,clen", [
    (2, 8, 4, 128, 512, False, 0, 300),
    (8, 16, 8, 128, 1174, False, 0, 1099),  # the served decode shape
    (1, 4, 1, 128, 256, True, 0, 700),      # MQA ring wrap
    (2, 8, 8, 64, 256, True, 128, 900),     # chunked attention ring
    (1, 1, 1, 16, 5, False, 0, 3),          # the split draft's shape
    (3, 4, 2, 16, 100, True, 0, 60),        # ring not yet wrapped
    (2, 32, 8, 256, 70, False, 0, 70),      # full cache, hd 256, G = 4
    (2, 10, 1, 256, 2048, True, 0, 3222),   # RecurrentGemma-2B: G = 10, ring
    (8, 16, 16, 64, 278, False, 0, 203),    # SeamlessM4T-medium decoder
    (4, 56, 8, 128, 1174, False, 0, 1099),  # LLaVA-NeXT-34B: G = 7
])
def test_decode_attention_kernel_matches_plain(B, H, Kv, hd, W, ring, chunk,
                                               clen, dtype):
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    dev = _cuda()
    rng = np.random.default_rng(W + clen)
    q = _randn(rng, (B, 1, H, hd), dtype, dev)
    kc = _randn(rng, (B, W, Kv, hd), dtype, dev)
    vc = _randn(rng, (B, W, Kv, hd), dtype, dev)
    ref = decode_attention_ref(q, kc, vc, clen, ring=ring, chunk_attn=chunk)
    ref_abs_v = decode_attention_ref(q, kc, vc.abs(), clen, ring=ring,
                                     chunk_attn=chunk)
    variant = "tc" if dtype == torch.bfloat16 else "ffma"
    before = decode_attention.launches, _decode_variant_counts()
    for cache_len in (clen, torch.tensor(clen, dtype=torch.int32, device=dev)):
        out = decode_attention(q, kc, vc, cache_len, ring=ring,
                               chunk_attn=chunk)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == q.shape
        _assert_attn(out, ref, ref_abs_v, dtype)
    assert decode_attention.launches == before[0] + 2
    assert _decode_variant_counts()[variant] == before[1][variant] + 2
    if dtype == torch.bfloat16:  # the FFMA variant, by its explicit route
        _assert_attn(_decode_launch(q, kc, vc, clen, "ffma", ring=ring,
                                    chunk_attn=chunk), ref, ref_abs_v, dtype)


def _decode_variant_counts():
    from repro_torch.kernels.decode_attention.ops import decode_attention

    return {"tc": decode_attention.launches_tc,
            "ffma": decode_attention.launches_ffma}


def _decode_launch(q, kc, vc, clen, variant, *, ring=False, chunk_attn=0):
    """One variant through ``kernel.launch`` (no counter moves)."""
    from repro_torch.kernels.common import KERNEL_DTYPES
    from repro_torch.kernels.decode_attention import kernel

    cl = torch.full((1,), clen, dtype=torch.int32, device=q.device)
    out = kernel.launch(q, kc, vc, cl, KERNEL_DTYPES[q.dtype], variant,
                        ring=ring, chunk_attn=chunk_attn)
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 112, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 4, 5, 7, 8, 10, 16])
def test_decode_attention_tensor_core_kernel_matches_plain(G, hd):
    """The tensor-core variant at every G and head_dim of the catalog
    (and G = 16, the padded row count), dense, ring and chunked ring, with
    cache_len at the edges of a 64-slot tile, the whole cache and a wrapped
    ring; W = 200 leaves a ragged last tile."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    dev = _cuda()
    B, Kv, W = 2, 2, 200
    rng = np.random.default_rng(G * 1000 + hd)
    q = _randn(rng, (B, 1, G * Kv, hd), torch.bfloat16, dev)
    kc = _randn(rng, (B, W, Kv, hd), torch.bfloat16, dev)
    vc = _randn(rng, (B, W, Kv, hd), torch.bfloat16, dev)
    cases = [(False, 0, n) for n in (1, 63, 64, 65, W)]
    cases += [(True, chunk, n) for chunk in (0, 48)
              for n in (1, 63, 64, 65, W, 2 * W + 37)]
    before = _decode_variant_counts()
    for ring, chunk, clen in cases:
        masks = dict(ring=ring, chunk_attn=chunk)
        out = decode_attention(q, kc, vc, clen, **masks)
        torch.cuda.synchronize()
        _assert_attn(out, decode_attention_ref(q, kc, vc, clen, **masks),
                     decode_attention_ref(q, kc, vc.abs(), clen, **masks),
                     torch.bfloat16)
    assert _decode_variant_counts() == {"tc": before["tc"] + len(cases),
                                        "ffma": before["ffma"]}


@pytest.mark.cuda
def test_decode_attention_kernel_reads_no_slot_past_cache_len():
    """A dense cache's slots at or past cache_len hold NaN: neither variant
    may read them (a NaN times a zero weight would still be NaN).  The op
    takes the tensor-core variant; the FFMA one runs by its explicit route,
    and at W = 4096 the tensor-core one splits the cache and combines."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    dev = _cuda()
    rng = np.random.default_rng(11)
    for W, clen in ((600, 377), (4096, 1500)):
        q = _randn(rng, (2, 1, 8, 128), torch.bfloat16, dev)
        kc = _randn(rng, (2, W, 4, 128), torch.bfloat16, dev)
        vc = _randn(rng, (2, W, 4, 128), torch.bfloat16, dev)
        clean_k, clean_v = kc.clone(), vc.clone()
        kc[:, clen:] = float("nan")
        vc[:, clen:] = float("nan")
        ref = decode_attention_ref(q, clean_k, clean_v, clen)
        ref_abs_v = decode_attention_ref(q, clean_k, clean_v.abs(), clen)
        before = _decode_variant_counts()
        out = decode_attention(q, kc, vc, clen)
        torch.cuda.synchronize()
        assert _decode_variant_counts()["tc"] == before["tc"] + 1
        for got in (out, _decode_launch(q, kc, vc, clen, "ffma")):
            assert torch.isfinite(got).all()
            _assert_attn(got, ref, ref_abs_v, torch.bfloat16)


@pytest.mark.cuda
def test_decode_attention_routes_follow_dtype_and_groups():
    """fp32, and bf16 with more than 16 query heads per KV head, go to the
    FFMA kernel; bf16 with G <= 16 to the tensor cores.  The shared memory
    the tensor-core kernel asks for is what ``tc_smem_bytes`` (and so the
    split rule) assumes."""
    from repro_torch.kernels.build import kernel_library
    from repro_torch.kernels.decode_attention import kernel
    from repro_torch.kernels.decode_attention.ops import decode_attention

    dev = _cuda()
    rng = np.random.default_rng(12)
    for dtype, H, want in ((torch.float32, 8, "ffma"),
                           (torch.bfloat16, 20, "ffma"),
                           (torch.bfloat16, 16, "tc")):
        q = _randn(rng, (1, 1, H, 64), dtype, dev)
        kc = _randn(rng, (1, 90, 1, 64), dtype, dev)
        before = _decode_variant_counts()
        decode_attention(q, kc, kc, 50)
        torch.cuda.synchronize()
        moved = {v: n - before[v] for v, n in _decode_variant_counts().items()}
        assert moved == {"tc": int(want == "tc"), "ffma": int(want == "ffma")}
    lib = kernel_library().lib
    for hd in (16, 64, 112, 128, 192, 256):
        assert lib.decode_attention_tc_smem_bytes(hd) == \
            kernel.tc_smem_bytes(hd)


@pytest.mark.cuda
def test_attention_kernels_refuse_what_they_cannot_take():
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention

    dev = _cuda()
    q = torch.zeros((1, 8, 2, 40), device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 32), device=dev)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="Kv"):
        flash_attention(q, torch.zeros((1, 8, 3, 32), device=dev),
                        torch.zeros((1, 8, 3, 32), device=dev))
    with pytest.raises(ValueError, match="cache_len"):
        decode_attention(q[:, :1], q, q, torch.tensor(3))


@pytest.mark.cuda
def test_model_prefill_then_decode_on_the_card():
    """A reduced dense model in fp32 on the card (both attention kernels):
    logits agree with the same model on the CPU (plain versions) within
    rel 1e-4, and decode after prefill agrees with the full forward."""
    _model_on_the_card("internlm2-1.8b")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "kimi-k2-1t-a32b",
                                  "recurrentgemma-2b"])
def test_moe_and_hybrid_models_on_the_card(arch):
    """The reduced MoE models (moe_gmm) and the hybrid model (rglru_scan
    and both attention kernels) as the dense test above.  The hybrid's local
    attention ring (window 64) does not wrap at 40 tokens; the attention
    kernel tests cover a wrapped ring."""
    from repro_torch.kernels.moe_gmm.ops import moe_gmm
    from repro_torch.kernels.rglru_scan.ops import rglru_scan_op

    before = moe_gmm.launches, rglru_scan_op.launches
    _model_on_the_card(arch)
    launched = moe_gmm.launches - before[0], rglru_scan_op.launches - before[1]
    assert launched[0 if arch != "recurrentgemma-2b" else 1] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-125m", "seamless-m4t-medium",
                                  "llava-next-34b"])
def test_xlstm_encdec_and_vlm_models_on_the_card(arch):
    """The reduced xLSTM (no kernel), encoder-decoder (non-causal flash in
    the encoder and the cross-attention, one row at decode) and VLM (patch
    embeddings in the first 8 slots) models as the dense test above."""
    from repro_torch.kernels.flash_attention.ops import flash_attention

    before = flash_attention.launches
    _model_on_the_card(arch)
    assert (flash_attention.launches > before) == (arch != "xlstm-125m")


def _model_on_the_card(arch):
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    dev = _cuda()
    cfg = get_config(arch).reduced()
    gen = torch.Generator()
    gen.manual_seed(0)
    params = lm.init_params(gen, cfg)
    params_dev = lm.params_from_numpy(lm.params_to_numpy(params), cfg,
                                      device="cuda")
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 40)))
    frames = 24 if cfg.num_encoder_layers else cfg.frontend_len
    fe = torch.as_tensor(rng.standard_normal((2, frames, cfg.d_model)),
                         dtype=torch.float32)
    rel = lambda a, b: float((a.cpu() - b.cpu()).abs().max()
                             / b.cpu().abs().max())
    got = {}
    for p, d in ((params, "cpu"), (params_dev, dev)):
        t = toks.to(d)
        pre, dec = {}, {}
        if cfg.num_encoder_layers:  # stub audio frames, encoded once
            pre["encoder_out"] = dec["encoder_out"] = lm.encode(
                p, cfg, fe.to(d))
        elif cfg.frontend:  # patch embeddings in the first slots
            pre["frontend"] = fe.to(d)
        logits, cache = lm.prefill(p, cfg, t[:, :-1], capacity=48, **pre)
        step, _ = lm.decode_step(p, cfg, t[:, -1:], cache,
                                 torch.tensor(40, dtype=torch.int32, device=d),
                                 capacity=48, **dec)
        hidden, _, _ = lm.forward(p, cfg, t, **pre)
        got[str(d)] = (logits, step, lm.logits_of(p, cfg, hidden))
    for a, b in zip(got[str(dev)], got["cpu"]):
        assert rel(a, b) < 1e-4
    assert rel(got[str(dev)][1], got[str(dev)][2]) < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_block_in_bf16_tracks_fp32_on_the_card(kind):
    """One xlstm-125m block at its served widths (d 768, 4 heads): a prefill
    of 256 tokens then 4 decode steps, in bf16 and in fp32 on the same
    bf16-rounded weights and inputs, on the card.  The block's update (y -
    x) in bf16 is within rel 2e-2 (the served prefill -> decode bound) of
    the fp32 one: a few bf16 roundings (2^-8 each) of the block's
    activations.  The fp32 run equals the same block on the CPU within rel
    1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import blocks
    from repro_torch.optim.optimizers import tree_map

    dev = _cuda()
    cfg = get_config("xlstm-125m")
    init = blocks.init_mlstm_block if kind == "mlstm" else \
        blocks.init_slstm_block
    gen = torch.Generator()
    gen.manual_seed(3)
    p16 = init(gen, cfg, "cpu")
    B, S, T = 2, 256, 4
    x = torch.randn((B, S + T, cfg.d_model), generator=gen).bfloat16()
    runs = {}
    for name, c, d, p, xx in (
            ("bf16", cfg, dev, p16, x),
            ("fp32", cfg.with_overrides(dtype="float32"), dev,
             tree_map(lambda t: t.float(), p16), x.float()),
            ("cpu", cfg.with_overrides(dtype="float32"), "cpu",
             tree_map(lambda t: t.float(), p16), x.float())):
        p = tree_map(lambda t: t.to(d), p)
        xx = xx.to(d)
        cache = blocks.init_block_cache(kind, c, B, S + T, d)
        pos = torch.arange(S + T, device=d)[None].expand(B, S + T)
        ctx = blocks.BlockCtx(mode="prefill", positions=pos[:, :S],
                              capacity=S + T)
        ys = [blocks.apply_block(kind, p, xx[:, :S], ctx, c, cache)[0]]
        for t in range(S, S + T):
            ctx = blocks.BlockCtx(mode="decode", positions=pos[:, t:t + 1],
                                  cache_len=t + 1, capacity=S + T)
            ys.append(blocks.apply_block(kind, p, xx[:, t:t + 1], ctx, c,
                                         cache)[0])
        runs[name] = (torch.cat(ys, 1).float() - xx.float()).cpu()
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    assert rel(runs["bf16"], runs["fp32"]) < 2e-2
    assert rel(runs["fp32"], runs["cpu"]) < 1e-4


# -- moe_gmm and rglru_scan ---------------------------------------------------
#
# moe_gmm fp32: max |out - ref| <= 1e-5 of max |ref| (tests/test_kernels.py's
# bound: fp32 sums of the same products in another order).  bf16, element by
# element: |out - ref| <= 2^-7 |ref| + 1e-5 (|x| . |w|).  Both sides round an
# fp32 sum of the same products to bf16, each rounding at most 2^-8 of the
# value; the sums themselves differ by far less than 1e-5 of the sum of the
# products' magnitudes.  rglru_scan: bit-equal to rglru_scan_ref (the same
# fp32 recurrence in the same order; both round the product and the sum
# apart).


def _gmm_case(rng, E, C, D, F, dtype, dev):
    x = _randn(rng, (E, C, D), torch.float32, dev) / np.sqrt(D)
    return x.to(dtype), _randn(rng, (E, D, F), dtype, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,D,F", [
    (4, 64, 256, 512),     # one 64-row tile
    (8, 24, 100, 96),      # ragged D and F, 32-row tile
    (16, 8, 512, 1024),    # decode: C = 8, one warp per block
    (3, 80, 320, 200),     # C not a multiple of the 64-row tile
    (2, 13, 64, 130),      # 16-row tile, one column past a 128 tile
    (5, 1, 33, 7),         # a single row, less than one tile everywhere
    (16, 640, 1024, 512),  # the served prefill rows per expert, narrowed
])
def test_moe_gmm_kernel_matches_plain(E, C, D, F, dtype):
    from repro_torch.kernels.moe_gmm.ops import moe_gmm
    from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref

    dev = _cuda()
    x, w = _gmm_case(np.random.default_rng(E * C + D), E, C, D, F, dtype, dev)
    before = moe_gmm.launches
    out = moe_gmm(x, w)
    torch.cuda.synchronize()
    assert moe_gmm.launches == before + 1
    assert out.dtype == dtype and out.shape == (E, C, F)
    ref = moe_gmm_ref(x, w).float()
    diff = (out.float() - ref).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-5 * float(ref.abs().max())
        return
    mag = moe_gmm_ref(x.abs().float(), w.abs().float())
    assert bool((diff <= 2.0 ** -7 * ref.abs() + 1e-5 * mag).all())


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,D,F", [
    (1, 1, 520, 136),      # one row; D, F multiples of 8 but not of 64
    (16, 8, 520, 136),     # decode rows: one 64-row tile, rows >= 8 zeros
    (1, 63, 64, 64),       # one row short of the 64-row tile
    (16, 64, 128, 256),    # exactly one 64-row tile, two 128-column tiles
    (1, 65, 520, 136),     # one row past it: the 128-row prefill tile
    (16, 129, 256, 264),   # one row past the 128-row tile, F ragged on 256
    (16, 640, 520, 136),   # the served prefill rows per expert
    (2, 640, 1024, 2048),  # several D stages round the 4-stage ring
])
def test_moe_gmm_tensor_core_kernel_matches_plain(E, C, D, F):
    """bf16 with D, F multiples of 8 runs the wgmma kernel, at the edges of
    its tiles (64 or 128 rows, 128 or 256 columns, 64-deep stages)."""
    from repro_torch.kernels.moe_gmm.ops import moe_gmm
    from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref

    dev = _cuda()
    x, w = _gmm_case(np.random.default_rng(E * C + D + F), E, C, D, F,
                     torch.bfloat16, dev)
    before = moe_gmm.launches_tc, moe_gmm.launches_ffma
    out = moe_gmm(x, w)
    torch.cuda.synchronize()
    assert (moe_gmm.launches_tc, moe_gmm.launches_ffma) == \
        (before[0] + 1, before[1])
    assert out.dtype == torch.bfloat16 and out.shape == (E, C, F)
    ref = moe_gmm_ref(x, w).float()
    mag = moe_gmm_ref(x.abs().float(), w.abs().float())
    diff = (out.float() - ref).abs()
    assert bool((diff <= 2.0 ** -7 * ref.abs() + 1e-5 * mag).all())


@pytest.mark.cuda
def test_kernel_routes_follow_dtype_and_shape():
    """fp32, and bf16 with a width TMA cannot stride (F = 130), go to the
    FFMA kernels; bf16 attention goes to the tensor cores."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.moe_gmm.ops import moe_gmm

    dev = _cuda()
    rng = np.random.default_rng(5)
    for dtype, F in ((torch.float32, 136), (torch.bfloat16, 130)):
        x, w = _gmm_case(rng, 2, 13, 64, F, dtype, dev)
        before = moe_gmm.launches_tc, moe_gmm.launches_ffma
        moe_gmm(x, w)
        assert (moe_gmm.launches_tc, moe_gmm.launches_ffma) == \
            (before[0], before[1] + 1)
    for dtype, variant in ((torch.float32, "ffma"), (torch.bfloat16, "tc")):
        q = _randn(rng, (1, 40, 2, 64), dtype, dev)
        before = flash_attention.launches_tc, flash_attention.launches_ffma
        flash_attention(q, q, q)
        torch.cuda.synchronize()
        moved = (flash_attention.launches_tc - before[0],
                 flash_attention.launches_ffma - before[1])
        assert moved == ((1, 0) if variant == "tc" else (0, 1))


# (B, S, R) of the scan kernels' card tests: ring tiles hold 32 steps
_SCAN_SHAPES = [
    (2, 256, 128), (1, 512, 100), (3, 100, 256),  # tests/test_kernels.py
    (2, 17, 33),       # S shorter than a tile, R ragged (cp.async)
    (2, 20, 64),       # S shorter than a tile on the TMA route
    (3, 1001, 1000),   # S not a multiple of the tile, the last block ragged
    (1, 1, 8),         # one step
    (4, 3072, 2560),   # the served RecurrentGemma-2B prefill
    (1, 4096, 2560),   # RecurrentGemma-2B's train microbatch
]


def _scan_inputs(rng, B, S, R, dtype, dev):
    a = torch.as_tensor(rng.uniform(0.7, 0.999, (B, S, R)),
                        dtype=torch.float32, device=dev).to(dtype)
    return (a, _randn(rng, (B, S, R), dtype, dev),
            _randn(rng, (B, R), torch.float32, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,R", _SCAN_SHAPES)
def test_rglru_scan_kernel_matches_plain(B, S, R, dtype):
    from repro_torch.kernels.rglru_scan.ops import rglru_scan_op
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    dev = _cuda()
    rng = np.random.default_rng(S + R)
    a, x, h0 = _scan_inputs(rng, B, S, R, dtype, dev)
    before = rglru_scan_op.launches
    out = rglru_scan_op(a, x, h0)
    torch.cuda.synchronize()
    assert rglru_scan_op.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (B, S, R)
    assert torch.equal(out, rglru_scan_ref(a, x, h0))


def _scan_route_counts(op):
    return {k: getattr(op, k) for k in (
        "launches_tma", "launches_cp_async", "launches_bwd_tma",
        "launches_bwd_cp_async")}


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,R", _SCAN_SHAPES)
def test_rglru_scan_takes_the_planned_route(B, S, R, dtype, misaligned):
    """Forward and backward land on the route ``scan_plan`` names (the
    counter of the route the C launcher reports moves by 1, no other), the
    C side's plan equals the Python one, and two calls are bit-equal to the
    plain loops.
    ``misaligned``: a and x start 4 bytes past a 16-byte boundary, which
    TMA cannot take."""
    from repro_torch.kernels.common import KERNEL_DTYPES
    from repro_torch.kernels.rglru_scan import kernel
    from repro_torch.kernels.rglru_scan.ops import rglru_scan_op
    from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_ref,
                                                    rglru_scan_ref)

    dev = _cuda()
    rng = np.random.default_rng(S + R + 2)
    a, x, h0 = _scan_inputs(rng, B, S, R, dtype, dev)
    if misaligned:
        shift = 4 // a.element_size()
        a, x = (torch.empty(a.numel() + shift, dtype=dtype, device=dev)[
            shift:].view(B, S, R).copy_(t) for t in (a, x))
    dh = _randn(rng, (B, S, R), torch.float32, dev)
    code = KERNEL_DTYPES[dtype]
    for backward in (False, True):
        plan = kernel.scan_plan(B, S, R, dtype, backward, not misaligned)
        assert kernel.library_plan(S, R, code, backward, not misaligned) == \
            tuple(plan[:5])
        if misaligned:
            assert plan.route == "cp_async"
    leaves = [t.clone().requires_grad_(True) for t in (a, x, h0)]
    if misaligned:
        leaves[:2] = [t.detach().requires_grad_(True) for t in (a, x)]
    before = _scan_route_counts(rglru_scan_op)
    h = rglru_scan_op(*leaves)
    got = torch.autograd.grad(h, leaves, dh)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in
             _scan_route_counts(rglru_scan_op).items()}
    fwd = kernel.scan_plan(B, S, R, dtype, False, not misaligned).route
    bwd = kernel.plan_for(a, h, dh, backward=True).route
    assert moved == {k: int(k in (f"launches_{fwd}", f"launches_bwd_{bwd}"))
                     for k in moved}
    h = h.detach()
    assert torch.equal(h, rglru_scan_ref(a, x, h0))
    ref = rglru_scan_bwd_ref(a, h0, h, dh)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert torch.equal(kernel.launch(a, x, h0, code), h)
    assert kernel.last_route() == fwd
    assert all(torch.equal(g, r) for g, r in zip(
        kernel.launch_bwd(a, h0, h, dh, code), ref))
    assert kernel.last_route() == bwd


@pytest.mark.cuda
def test_moe_gmm_and_rglru_scan_refuse_what_they_cannot_take():
    from repro_torch.kernels.moe_gmm.ops import moe_gmm
    from repro_torch.kernels.rglru_scan.ops import rglru_scan_op

    dev = _cuda()
    x = torch.zeros((2, 8, 16), device=dev)
    w = torch.zeros((2, 16, 32), device=dev)
    with pytest.raises(TypeError, match="bfloat16"):
        moe_gmm(x, w.bfloat16())
    with pytest.raises(ValueError, match="do not fit"):
        moe_gmm(x, torch.zeros((2, 15, 32), device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        moe_gmm(x, torch.zeros((2, 32, 16), device=dev).transpose(1, 2))
    with pytest.raises(ValueError, match="mixed"):
        moe_gmm(x, w.cpu())
    a = torch.zeros((2, 5, 16), device=dev)
    with pytest.raises(TypeError, match="bfloat16"):
        rglru_scan_op(a.half(), a.half(), torch.zeros((2, 16), device=dev))
    with pytest.raises(ValueError, match="do not fit"):
        rglru_scan_op(a, a, torch.zeros((2, 15), device=dev))


# -- training: the moe_gmm and rglru_scan backwards --------------------------
# moe_gmm's backward against moe_gmm_bwd_ref: fp32 max |g - ref| <= 1e-5 of
# max |ref| per gradient; bf16 element by element within 2^-7 |ref| + 1e-5 M,
# M the same products over magnitudes (moe_gmm_bwd_ref of |x|, |w|, |dy|):
# the forward's bound, since both sides round an fp32 sum of the same exact
# products.  rglru_scan's backward: bit-equal to rglru_scan_bwd_ref (the same
# fp32 operations in the same order).  Both: two calls bit-equal.


def _gmm_bwd_case(rng, E, C, D, F, dtype, dev):
    x, w = _gmm_case(rng, E, C, D, F, dtype, dev)
    return x, w, _randn(rng, (E, C, F), dtype, dev)


def _assert_gmm_bwd(got, x, w, dy, where):
    from repro_torch.kernels.moe_gmm.ref import moe_gmm_bwd_ref

    ref = moe_gmm_bwd_ref(x, w, dy)
    if x.dtype == torch.bfloat16:
        mag = moe_gmm_bwd_ref(x.abs().float(), w.abs().float(),
                              dy.abs().float())
    for name, g, r, i in zip(("dx", "dw"), got, ref, range(2)):
        assert g.dtype == x.dtype and g.shape == r.shape, (where, name)
        diff = (g.float() - r.float()).abs()
        if x.dtype == torch.float32:
            assert float(diff.max()) <= 1e-5 * float(r.abs().max()), \
                (where, name)
        else:
            lim = 2.0 ** -7 * r.float().abs() + 1e-5 * mag[i]
            assert bool((diff <= lim).all()), (where, name,
                                               float((diff / lim).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,D,F", [
    (4, 64, 256, 512),     # whole tiles
    (16, 8, 520, 136),     # decode-sized C; D, F multiples of 8, not of 64
    (1, 1, 64, 64),        # a single row
    (3, 77, 72, 136),      # ragged C; dw's K = C not a multiple of 64
    (16, 129, 256, 264),   # one row past the 128-row tile, F ragged on 256
    (2, 320, 1024, 2048),  # Scout's train rows per expert, narrowed
    (5, 13, 100, 130),     # D, F TMA cannot stride: FFMA in bf16 too
])
def test_moe_gmm_backward_kernel_matches_plain(E, C, D, F, dtype):
    """Through the autograd Function: dx and dw against their plain version,
    the routed variant counted, two backward calls bit-equal."""
    from repro_torch.kernels.moe_gmm import kernel
    from repro_torch.kernels.moe_gmm.ops import moe_gmm

    dev = _cuda()
    x, w, dy = _gmm_bwd_case(np.random.default_rng(E + C + D + F), E, C, D, F,
                             dtype, dev)
    variant = kernel.route_bwd(dtype, D, F)
    assert variant == ("tc" if dtype == torch.bfloat16 and D % 8 == 0
                       and F % 8 == 0 else "ffma")
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    counter = f"launches_bwd_{variant}"
    before = moe_gmm.launches_bwd, getattr(moe_gmm, counter)
    got = torch.autograd.grad(moe_gmm(xg, wg), (xg, wg), dy)
    torch.cuda.synchronize()
    assert (moe_gmm.launches_bwd, getattr(moe_gmm, counter)) == \
        (before[0] + 1, before[1] + 1)
    _assert_gmm_bwd(got, x, w, dy, (E, C, D, F))
    again = kernel.launch_bwd(x, w, dy, variant)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,D,F,walk", [
    (2, 40, 256, 512, "below"),      # dx 4 tiles, dw 8: fewer than the SMs
    (5, 330, 1536, 768, "above"),    # 180 and 180: one wave and a part
    (11, 64, 768, 1024, "multiple"),  # dw 264 = 2 x 132; dx 66 (C <= 64)
])
def test_moe_gmm_backward_persistent_walk(E, C, D, F, walk):
    """bf16 through the autograd Function at tile counts below one block an
    SM, above it and not a multiple of it, and an exact multiple: every tile
    written once (the plain version's bound everywhere), the tc count moved,
    two calls bit-equal."""
    from repro_torch.kernels.moe_gmm import kernel
    from repro_torch.kernels.moe_gmm.ops import moe_gmm

    dev = _cuda()
    sms = sm_count(dev)
    dx_tiles, dw_tiles = kernel.bwd_tc_tiles(E, C, D, F)
    if walk == "below":
        assert max(dx_tiles, dw_tiles) < sms
    elif walk == "above":
        assert min(dx_tiles, dw_tiles) > sms and dw_tiles % sms
    else:
        assert dw_tiles % sms == 0 and dw_tiles > sms
    x, w, dy = _gmm_bwd_case(np.random.default_rng(C + D), E, C, D, F,
                             torch.bfloat16, dev)
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    before = moe_gmm.launches_bwd_tc
    got = torch.autograd.grad(moe_gmm(xg, wg), (xg, wg), dy)
    torch.cuda.synchronize()
    assert moe_gmm.launches_bwd_tc == before + 1
    _assert_gmm_bwd(got, x, w, dy, (E, C, D, F, walk))
    again = kernel.launch_bwd(x, w, dy, "tc")
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,D,F", [(16, 8, 520, 136), (3, 77, 72, 136),
                                     (2, 320, 1024, 2048)])
def test_moe_gmm_backward_variants_agree_in_bf16(E, C, D, F):
    """The FFMA variant on the tensor-core route's bf16 inputs (its explicit
    route) within the same bf16 bound."""
    from repro_torch.kernels.moe_gmm import kernel

    dev = _cuda()
    x, w, dy = _gmm_bwd_case(np.random.default_rng(C), E, C, D, F,
                             torch.bfloat16, dev)
    _assert_gmm_bwd(kernel.launch_bwd(x, w, dy, "ffma"), x, w, dy, "ffma")
    with pytest.raises(ValueError, match="multiples of 8"):
        kernel.launch_bwd(x.float(), w.float(), dy.float(), "tc")


@pytest.mark.cuda
def test_moe_gmm_backward_of_no_rows_is_zero():
    from repro_torch.kernels.moe_gmm.ops import moe_gmm

    dev = _cuda()
    x = torch.zeros((4, 0, 64), device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    w = torch.randn((4, 64, 32), device=dev).bfloat16().requires_grad_(True)
    before = moe_gmm.launches_bwd
    out = moe_gmm(x, w)
    dx, dw = torch.autograd.grad(out, (x, w), torch.zeros_like(out))
    assert dx.shape == (4, 0, 64) and dw.shape == (4, 64, 32)
    assert not dw.any() and moe_gmm.launches_bwd == before


@pytest.mark.cuda
def test_tensor_core_backward_is_the_first_work_of_autograds_thread():
    """In a fresh process, the first work autograd's device thread does is
    the tensor-core backward's launcher, whose TMA encoder needs a current
    context there (``hopper.cuh: bind_context``)."""
    import os
    import subprocess
    import sys

    _cuda()
    code = (
        "import torch\n"
        "from repro_torch.kernels.moe_gmm.ops import moe_gmm\n"
        "x = torch.randn((2, 64, 128), device='cuda').bfloat16()\n"
        "w = torch.randn((2, 128, 64), device='cuda').bfloat16()\n"
        "x.requires_grad_(True)\n"
        "out = moe_gmm(x, w)\n"
        "dx, = torch.autograd.grad(out, x, torch.ones_like(out))\n"
        "torch.cuda.synchronize()\n"
        "assert moe_gmm.launches_bwd_tc == 1, moe_gmm.launches_bwd_tc\n"
        "ref = torch.ones_like(out).float() @ w.float().transpose(1, 2)\n"
        "assert float((dx.float() - ref).abs().max()) <= "
        "2.0 ** -7 * float(ref.abs().max())\n")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=src)
    done = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,R", [
    (2, 256, 128), (1, 512, 100), (3, 100, 256),
    (2, 17, 33),       # S shorter than a tile, R ragged (cp.async)
    (2, 20, 64),       # S shorter than a tile on the TMA route
    (3, 1001, 1000),   # S not a multiple of the tile, the last block ragged
    (1, 1, 8),         # one step: dh0 = a_0 dh_0
    (1, 4096, 2560),   # RecurrentGemma-2B's train microbatch
])
def test_rglru_scan_backward_kernel_matches_plain(B, S, R, dtype):
    """Through the autograd Function with a non-zero h0: da, dx (a's dtype)
    and dh0 bit-equal to the plain reverse loop, counted; two calls
    bit-equal."""
    from repro_torch.kernels.common import KERNEL_DTYPES
    from repro_torch.kernels.rglru_scan import kernel
    from repro_torch.kernels.rglru_scan.ops import rglru_scan_op
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref

    dev = _cuda()
    rng = np.random.default_rng(S + R + 1)
    a = torch.as_tensor(rng.uniform(0.7, 0.999, (B, S, R)),
                        dtype=torch.float32, device=dev).to(dtype)
    x = _randn(rng, (B, S, R), dtype, dev)
    h0 = _randn(rng, (B, R), torch.float32, dev)
    dh = _randn(rng, (B, S, R), torch.float32, dev)
    leaves = [t.clone().requires_grad_(True) for t in (a, x, h0)]
    before = rglru_scan_op.launches_bwd
    h = rglru_scan_op(*leaves)
    got = torch.autograd.grad(h, leaves, dh)
    torch.cuda.synchronize()
    assert rglru_scan_op.launches_bwd == before + 1
    ref = rglru_scan_bwd_ref(a, h0, h.detach(), dh)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    again = kernel.launch_bwd(a, h0, h.detach(), dh, KERNEL_DTYPES[dtype])
    assert all(torch.equal(g, r) for g, r in zip(got, again))


# -- training: the flash backward and the lse forward --------------------------

_CAUSAL = dict(causal=True, window=0, chunk_attn=0)


def _flash_train_inputs(rng, B, Sq, Skv, H, Kv, hd, dtype, dev):
    q = _randn(rng, (B, Sq, H, hd), dtype, dev)
    k = _randn(rng, (B, Skv, Kv, hd), dtype, dev)
    v = _randn(rng, (B, Skv, Kv, hd), dtype, dev)
    dout = _randn(rng, (B, Sq, H, hd), dtype, dev)
    return q, k, v, dout


def _assert_bwd(got, ref, mag, dtype, where):
    """fp32: within 1e-5 of each gradient's largest magnitude.  bf16:
    element by element |got - ref| <= 2^-7 |ref| + 2^-8 M, M the same
    products over magnitudes (``flash_attention_bwd_ref(...,
    magnitudes=True)``): the two roundings of each output to bf16, plus
    rounding inside the products (chip_smoke.py and PERF.md state the same
    bound)."""
    for name, g, r, m in zip(("dq", "dk", "dv"), got, ref, mag):
        g, r = g.float(), r.float()
        assert torch.isfinite(g).all(), f"{where} {name}: not finite"
        if dtype == torch.float32:
            err = float((g - r).abs().max())
            assert err <= 1e-5 * float(r.abs().max()), (where, name, err)
        else:
            over = ~((g - r).abs() <= 2.0 ** -7 * r.abs() + 2.0 ** -8 * m)
            assert not over.any(), \
                f"{where} {name}: {int(over.sum())} elements over the bf16 limit"


def _flash_bwd_case(dtype, B, Sq, Skv, H, Kv, hd, masks, seed):
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_lse_ref)

    dev = _cuda()
    rng = np.random.default_rng(seed)
    q, k, v, dout = _flash_train_inputs(rng, B, Sq, Skv, H, Kv, hd, dtype, dev)
    variant = kernel.route(dtype, hd)
    out, lse = kernel.launch(q, k, v, variant, with_lse=True, **masks)
    ref_out, ref_lse = flash_attention_lse_ref(q, k, v, **masks)
    torch.cuda.synchronize()
    # the lse twin writes exactly the serving kernel's output
    assert torch.equal(out, kernel.launch(q, k, v, variant, **masks))
    assert float((lse - ref_lse).abs().max()) <= 1e-5
    bwd_variant = kernel.route_bwd(dtype, hd)
    before = (flash_attention.launches_bwd,
              getattr(flash_attention, f"launches_bwd_{bwd_variant}"))
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = flash_attention(qg, kg, vg, **masks)
    got = torch.autograd.grad(o, (qg, kg, vg), dout)
    torch.cuda.synchronize()
    assert (flash_attention.launches_bwd,
            getattr(flash_attention, f"launches_bwd_{bwd_variant}")) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(o.detach(), out)
    ref = flash_attention_bwd_ref(q, k, v, out, lse, dout, **masks)
    mag = flash_attention_bwd_ref(q, k, v, out, lse, dout, **masks,
                                  magnitudes=True)
    where = f"{dtype} {masks} hd {hd} H {H}/{Kv}"
    _assert_bwd(got, ref, mag, dtype, where + f" {bwd_variant}")
    if bwd_variant == "tc":  # the FFMA variant takes bf16 too
        _assert_bwd(kernel.launch_bwd(q, k, v, out, lse, dout, "ffma",
                                      **masks), ref, mag, dtype,
                    where + " ffma")
    return q, k, v, out, lse, dout


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 7])
def test_flash_backward_kernel_matches_plain(dtype, hd, G):
    """Causal, ragged S (not a multiple of any variant's tiles), GQA groups
    of 1, 2 and 7 summed in the dK/dV block; bf16 takes the tensor-core
    kernels (at hd 256 the wide pair, whose 12 dK/dV blocks split the group
    into G runs), the FFMA ones checked beside them."""
    _flash_bwd_case(dtype, 2, 150, 150, 2 * G, 2, hd, _CAUSAL, seed=hd + G)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Kv,hd,masks", [
    # MQA G 10 at hd 256 with a window, S a multiple of no tile
    (1, 300, 10, 1, 256, dict(causal=True, window=48, chunk_attn=0)),
    (2, 150, 4, 2, 192, _CAUSAL),   # hd 192: the wide pair, padded to 256
    (1, 200, 4, 2, 144, dict(causal=False, window=0, chunk_attn=64)),
])
def test_flash_backward_wide_kernel_matches_plain(B, S, H, Kv, hd, masks):
    """The wide tensor-core pair (hd above 128) in bf16 against the plain
    version, and the FFMA kernels beside it."""
    from repro_torch.kernels.flash_attention import kernel

    assert kernel.route_bwd(torch.bfloat16, hd) == "tc"
    _flash_bwd_case(torch.bfloat16, B, S, S, H, Kv, hd, masks, seed=S + hd)


@pytest.mark.cuda
def test_flash_backward_head_split_is_deterministic():
    """B 1, one KV head of 10, S 2000 (32 dK/dV blocks): the heads split
    into runs whose fp32 partials are summed in a fixed order; the result
    within the bf16 limit, and two calls bit-equal."""
    from repro_torch.kernels.flash_attention import kernel

    dev = _cuda()
    masks = dict(causal=True, window=512, chunk_attn=0)
    assert kernel.bwd_head_splits(1, 2000, 1, 10, 256, sm_count(dev)) > 1
    q, k, v, out, lse, dout = _flash_bwd_case(torch.bfloat16, 1, 2000, 2000,
                                              10, 1, 256, masks, seed=2000)
    first = kernel.launch_bwd(q, k, v, out, lse, dout, "tc", **masks)
    second = kernel.launch_bwd(q, k, v, out, lse, dout, "tc", **masks)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv,masks", [
    (200, 200, dict(causal=True, window=48, chunk_attn=0)),
    (200, 200, dict(causal=True, window=0, chunk_attn=64)),
    (96, 170, dict(causal=False, window=0, chunk_attn=0)),
    (130, 70, dict(causal=True, window=0, chunk_attn=0)),
    (40, 300, dict(causal=True, window=0, chunk_attn=0)),
])
def test_flash_backward_kernel_masks(dtype, Sq, Skv, masks):
    """Window, chunk, non-causal and Sq != Skv (both ways) at hd 128, G 2;
    hd 16 (one accumulator column per thread) non-causal."""
    _flash_bwd_case(dtype, 2, Sq, Skv, 4, 2, 128, masks, seed=Sq + Skv)
    _flash_bwd_case(dtype, 1, Sq, Skv, 4, 2, 16, masks, seed=Sq)


@pytest.mark.cuda
def test_flash_backward_long_ragged_sequence():
    """S 1000: eight 128-key tiles and sixteen 64-query tiles (the wgmma
    pair's), the last of each partial, causal, G 2, hd 128."""
    _flash_bwd_case(torch.bfloat16, 1, 1000, 1000, 4, 2, 128, _CAUSAL,
                    seed=1000)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,variant,hd", [(torch.float32, "ffma", 32),
                                              (torch.bfloat16, "tc", 32),
                                              (torch.bfloat16, "tc", 256)])
def test_flash_backward_rows_that_see_nothing_get_zero_gradients(dtype,
                                                                 variant, hd):
    """chunk 16 with Sq 48 > Skv 24: query rows 32-47 are in a chunk that has
    no key; their output, dq and every contribution are 0, not NaN (hd 256:
    the wide pair)."""
    q, k, v, out, lse, dout = _flash_bwd_case(
        dtype, 1, 48, 24, 2, 1, hd,
        dict(causal=True, window=0, chunk_attn=16), seed=5)
    from repro_torch.kernels.flash_attention import kernel

    dq, dk, dv = kernel.launch_bwd(q, k, v, out, lse, dout, variant,
                                   causal=True, window=0, chunk_attn=16)
    assert (out[:, 32:] == 0).all() and (dq[:, 32:] == 0).all()
    assert (lse[:, :, 32:] == NEG_INF).all()
    for g in (dq, dk, dv):
        assert torch.isfinite(g.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,variant", [
    (torch.float32, "ffma"), (torch.bfloat16, "ffma"), (torch.bfloat16, "tc")])
def test_flash_backward_is_deterministic(dtype, variant):
    """Two calls on the same inputs give bit-equal dq, dk and dv."""
    from repro_torch.kernels.flash_attention import kernel

    dev = _cuda()
    rng = np.random.default_rng(3)
    q, k, v, dout = _flash_train_inputs(rng, 2, 300, 300, 14, 2, 128, dtype,
                                        dev)
    out, lse = kernel.launch(q, k, v, kernel.route(dtype, 128),
                             with_lse=True, **_CAUSAL)
    first = kernel.launch_bwd(q, k, v, out, lse, dout, variant, **_CAUSAL)
    second = kernel.launch_bwd(q, k, v, out, lse, dout, variant, **_CAUSAL)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_backward_routes_follow_dtype_and_width():
    """bf16 takes the tensor-core kernels at every width up to hd 256 (the
    wgmma pair up to 128, the wide pair above), fp32 the FFMA kernels; the
    tensor-core variant refuses fp32."""
    from repro_torch.kernels.flash_attention import kernel

    assert kernel.route_bwd(torch.bfloat16, 128) == "tc"
    assert kernel.route_bwd(torch.bfloat16, 16) == "tc"
    assert kernel.route_bwd(torch.bfloat16, 192) == "tc"
    assert kernel.route_bwd(torch.bfloat16, 256) == "tc"
    assert kernel.route_bwd(torch.float32, 64) == "ffma"
    assert kernel.route_bwd(torch.float32, 256) == "ffma"
    dev = _cuda()
    rng = np.random.default_rng(6)
    q, k, v, dout = _flash_train_inputs(rng, 1, 40, 40, 2, 1, 256,
                                        torch.float32, dev)
    out, lse = kernel.launch(q, k, v, "ffma", with_lse=True, **_CAUSAL)
    with pytest.raises(ValueError, match="256"):
        kernel.launch_bwd(q, k, v, out, lse, dout, "tc", **_CAUSAL)


@pytest.mark.cuda
def test_serving_launches_unchanged_without_grad():
    """No input requiring grad (or grad mode off): the serving kernel, counted
    in ``launches``; an input requiring grad: the lse twin, counted in
    ``launches_lse`` only."""
    from repro_torch.kernels.flash_attention.ops import flash_attention

    dev = _cuda()
    rng = np.random.default_rng(4)
    q, k, v, _ = _flash_train_inputs(rng, 1, 64, 64, 4, 2, 64, torch.bfloat16,
                                     dev)
    counts = lambda: (flash_attention.launches, flash_attention.launches_tc,
                      flash_attention.launches_lse,
                      flash_attention.launches_lse_tc)
    before = counts()
    flash_attention(q, k, v)
    qg = q.clone().requires_grad_(True)
    with torch.no_grad():
        flash_attention(qg, k, v)
    assert counts() == (before[0] + 2, before[1] + 2, before[2], before[3])
    flash_attention(qg, k, v)
    assert counts() == (before[0] + 2, before[1] + 2, before[2] + 1,
                        before[3] + 1)


@pytest.mark.cuda
def test_kernels_without_backward_refuse_grad_on_the_card():
    """The three kernels no train path reaches raise under grad on the
    card (``kernels/common.py: refuse_grad``), and pass without it."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.dsqe_score.ops import dsqe_score
    from repro_torch.kernels.retrieval_topk.ops import retrieval_topk

    dev = _cuda()
    q = torch.zeros((2, 1, 2, 16), device=dev, requires_grad=True)
    kv = torch.zeros((2, 8, 2, 16), device=dev)
    with pytest.raises(RuntimeError, match="no train path reaches it"):
        decode_attention(q, kv, kv, 3)
    with torch.no_grad():
        decode_attention(q, kv, kv, 3)
    u = torch.zeros((4, 16), device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no train path reaches it"):
        retrieval_topk(u, u.detach(), k=2)
    z = lambda *shape: torch.zeros(shape, device=dev)
    with pytest.raises(RuntimeError, match="no train path reaches it"):
        dsqe_score(u, u.detach(), u.detach(), z(4, 3), z(4, 3), z(3), z(3),
                   z(3), z(3), z(4, 2), knn=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "recurrentgemma-2b"])
def test_moe_and_hybrid_archs_train_on_the_card(arch, dtype):
    """Reduced Scout (moe_gmm and the gather backwards of the dispatch) and
    RecurrentGemma (rglru_scan), stacked units under remat: the gradient of
    ``lm.train_loss`` on the card through the backward kernels reaches every
    leaf and every unit of a stacked leaf (all finite, none all zero), with
    exact backward launches by variant; fp32 loss and grads against the same
    on the CPU (plain versions): loss rel 1e-5, each leaf within 1e-4 of its
    max |g|; then two ``build_train_step`` steps in 2 microbatches run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_gmm.ops import moe_gmm
    from repro_torch.kernels.rglru_scan.ops import rglru_scan_op
    from repro_torch.launch.steps import _grads, build_train_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw, constant_schedule
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    dev = _cuda()
    cfg = get_config(arch).reduced().with_overrides(
        scan_layers=True, remat=True, dtype=dtype)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = lm.init_params(gen, cfg)
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 64)))
             for k in ("tokens", "labels")}
    on_card = tree_map(lambda t: t.to(dev), params)
    card_batch = {k: v.to(dev) for k, v in batch.items()}
    counts = lambda: (moe_gmm.launches_bwd_tc, moe_gmm.launches_bwd_ffma,
                      rglru_scan_op.launches_bwd)
    before = counts()
    loss, _, grads = _grads(cfg, on_card, card_batch)
    torch.cuda.synchronize()
    moved = tuple(a - b for a, b in zip(counts(), before))
    if cfg.num_experts:  # three products a layer
        n = 3 * cfg.num_layers
        want = (n, 0, 0) if dtype == "bfloat16" else (0, n, 0)
    else:
        want = (0, 0, cfg.layer_types.count("rglru"))
    assert moved == want
    for path_leaf in tree_leaves(grads["stack"]["units"]):
        for unit in path_leaf:  # every unit of a stacked leaf
            assert bool(torch.isfinite(unit).all()) and bool(unit.any())
    for g in tree_leaves(grads):
        assert bool(torch.isfinite(g).all()) and bool(g.any())
    if dtype == "float32":
        ref_loss, _, ref_grads = _grads(cfg, params, batch)
        assert abs(float(loss) - float(ref_loss)) <= \
            1e-5 * abs(float(ref_loss))
        for g, r in zip(tree_leaves(grads), tree_leaves(ref_grads)):
            assert float((g.cpu() - r).abs().max()) <= \
                1e-4 * float(r.abs().max())
    opt = adamw(constant_schedule(1e-3))
    step_fn = build_train_step(cfg, optimizer=opt, microbatches=2)
    p, state = on_card, opt.init(on_card)
    for i in range(2):
        p, state, _, m = step_fn(p, state, i, card_batch)
        assert np.isfinite(float(m["loss"])) and \
            np.isfinite(float(m["grad_norm"]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_on_the_card_tracks_the_cpu(dtype):
    """Reduced InternLM2 (stacked units, remat): three ``build_train_step``
    steps in 2 microbatches on the card (the lse forward and the backward
    kernel) from the same weights and batches as on the CPU (plain
    versions).  fp32: losses within rel 1e-5 and params within 1e-4 of each
    leaf's max (AdamW keeps only the sign of a near-zero grad); bf16: the
    losses within rel 2e-2 (tests/test_models.py's bf16 bound), and the
    launches by variant exact."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw, constant_schedule
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    dev = _cuda()
    cfg = get_config("internlm2-1.8b").reduced().with_overrides(
        scan_layers=True, remat=True, dtype=dtype)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = lm.init_params(gen, cfg)
    rng = np.random.default_rng(0)
    batches = [{k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 64)))
                for k in ("tokens", "labels")} for _ in range(3)]
    opt = adamw(constant_schedule(1e-3))
    step_fn = build_train_step(cfg, optimizer=opt, microbatches=2)
    runs = {}
    for where in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(where), params)
        state, losses = opt.init(p), []
        lse0 = flash_attention.launches_lse
        bwd0 = (flash_attention.launches_bwd_tc,
                flash_attention.launches_bwd_ffma)
        for i, b in enumerate(batches):
            p, state, _, m = step_fn(p, state, i, {k: v.to(where)
                                                  for k, v in b.items()})
            losses.append(float(m["loss"]))
        if where == "cuda":
            # steps x microbatches x layers, twice under remat
            assert flash_attention.launches_lse == lse0 + 3 * 2 * 2 * 2
            bwd = (flash_attention.launches_bwd_tc - bwd0[0],
                   flash_attention.launches_bwd_ffma - bwd0[1])
            assert bwd == ((12, 0) if dtype == "bfloat16" else (0, 12))
        runs[where] = (losses, p)
    if dtype == "float32":
        np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-5)
        for a, b in zip(tree_leaves(runs["cuda"][1]),
                        tree_leaves(runs["cpu"][1])):
            assert float((a.cpu() - b).abs().max()) <= \
                1e-4 * float(b.abs().max())
    else:
        np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=2e-2)


@pytest.mark.cuda
def test_train_step_on_a_one_rank_mesh_matches_the_plain_step():
    """The (1, 1) ``DeviceMesh`` twin of ``chip_smoke.py``'s ``train_tp``:
    reduced InternLM2 in fp32 (stacked units, remat), one
    ``build_train_step`` step in 2 microbatches with params and AdamW state
    as DTensors placed by ``ShardingPolicy`` over a one-rank ``nccl``
    world, against the plain step on the card from the same weights: loss
    rel 1e-5, params within 1e-4 of each leaf's max, the same flash
    launches (lse twin and backward) on the FFMA variants."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import ShardingPolicy, \
        to_local_tree
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.mesh import init_world, make_host_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw, constant_schedule
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    dev = _cuda()
    cfg = get_config("internlm2-1.8b").reduced().with_overrides(
        scan_layers=True, remat=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = lm.init_params(gen, cfg)
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 64)),
                                device=dev) for k in ("tokens", "labels")}
    opt = adamw(constant_schedule(1e-3))
    counts = lambda: (flash_attention.launches_lse_ffma,
                      flash_attention.launches_bwd_ffma)
    before = counts()
    ref_p, _, _, ref_m = build_train_step(cfg, optimizer=opt,
                                          microbatches=2)(
        tree_map(lambda t: t.clone(), params), opt.init(params), 3, batch)
    torch.cuda.synchronize()
    plain = tuple(a - b for a, b in zip(counts(), before))
    init_world("cuda")
    try:
        policy = ShardingPolicy(make_host_mesh(1, device="cuda"))
        spec = policy.param_pspecs(cfg, params)
        state = policy.distribute(opt.init(params),
                                  policy.opt_pspecs("adamw", spec, params))
        placed = policy.distribute(params, spec)
        before = counts()
        new_p, _, _, m = build_train_step(cfg, optimizer=opt, microbatches=2,
                                          policy=policy)(placed, state, 3,
                                                         batch)
        torch.cuda.synchronize()
        sharded = tuple(a - b for a, b in zip(counts(), before))
        got = to_local_tree(new_p)
    finally:
        dist.destroy_process_group()
    assert plain == sharded == (2 * 2 * 2, 2 * 2)
    assert abs(float(m["loss"]) - float(ref_m["loss"])) <= \
        1e-5 * abs(float(ref_m["loss"]))
    for a, b in zip(tree_leaves(got), tree_leaves(ref_p)):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
