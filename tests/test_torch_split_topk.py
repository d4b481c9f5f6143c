"""The selection kernels' plain rules and models, on the CPU.

* ``kernel.route``: the route of a retrieval or dsqe call, one rule on k
  for every width (the tiled kernel's lists hold up to 64 entries, the
  select route any k); ``kernel.vec4``: whether rows copy 16 bytes at a
  time (d a multiple of 4 and 16-byte aligned bases) or 4.
* ``kernel.grid``: how the tiled kernel cuts the corpus into splits of
  whole 128-row tiles: at least ``WAVES`` blocks per SM where the corpus
  allows, and one split, so no merge, at the served selection shape.
  ``kernel.select_chunk``: the select route's chunks of B keep its scratch
  within 64 MB.
* split-then-merge: a plain model of what the tiled kernel and its merge
  compute (each split's running top-k over its rows in ascending id with
  strict admission, then the lists offered in split order, each in its own
  order, to one more running top-k).
* select: a plain model of the select route (the radix select of the k-th
  order-preserving key in four 8-bit passes, the entries above it and the
  lowest ids among those equal to it, the bitonic sort of 64-bit keys in
  shared memory or in chunks through a global scratch).
* the dsqe epilogue on either model's top-k: the first-argmax prototype
  as the kernel reduces it (warps of grouped prototypes, then the warps'
  bests on (value desc, index asc)), the vote, the prior and the mask.

Each model is held against the JAX package's ``retrieval_topk_ref``
(``jax.lax.top_k``: the lowest id wins an exact tie) or ``dsqe_score_ref``.
Entries are multiples of 1/8 at d = 32, so every score is exact in fp32 in
either framework whatever the order of the sum, and exact ties are
everywhere: duplicated rows on both sides of split boundaries, and at the
k-th place.  Ids and set ids must be equal, values within 1e-6, dsqe scores
within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dsqe_score.ref import dsqe_score_ref as jax_dsqe_ref
from repro.kernels.retrieval_topk.ref import retrieval_topk_ref as jax_ref
from repro_torch.kernels.retrieval_topk import kernel
from repro_torch.kernels.retrieval_topk.ref import retrieval_topk_ref


@pytest.mark.parametrize("k,want", [
    (1, "tiled"), (16, "tiled"), (50, "tiled"), (64, "tiled"),
    (65, "select"), (100, "select"), (128, "select"), (8193, "select"),
    (10 ** 6, "select"),
])
def test_retrieval_route(k, want):
    """Every width takes the route of its k (the first port sent odd d to
    the warp-per-row kernel, which is now reached only by name)."""
    assert kernel.route(k) == want
    assert want in kernel.ROUTES


@pytest.mark.parametrize("d,offset,want", [
    (256, 0, True), (4, 0, True), (100, 0, True), (4096, 0, True),
    (3, 0, False), (1, 0, False), (257, 0, False), (4095, 0, False),
    (6, 0, False), (2049, 0, False),
    (256, 1, False), (256, 4, True), (64, 2, False),  # offset views
])
def test_tiled_copy_width(d, offset, want):
    """Rows copy 16 bytes at a time only where every row and base is
    16-byte aligned: d a multiple of 4 and the tensor's base too."""
    base = torch.zeros(8 * d + offset)
    t = base[offset:].reshape(8, d)
    assert kernel.vec4(t, torch.zeros((5, d))) is want


@pytest.mark.parametrize("B,n,sms,want", [
    (64, 84, 132, (16, 4, 1, 1)),      # served selection: one split, no merge
    (36, 84, 132, (16, 3, 1, 1)),
    (64, 128, 132, (16, 4, 1, 1)),     # exactly one tile
    (64, 129, 132, (16, 4, 1, 2)),
    (256, 16384, 132, (64, 4, 1, 128)),  # deployment: 512 blocks
    (256, 65536, 132, (64, 4, 7, 74)),   # wide: 296 blocks
    (1, 1, 132, (16, 1, 1, 1)),
    (300, 20000, 132, (64, 5, 2, 79)),
    (37, 5003, 132, (16, 3, 1, 40)),
])
def test_retrieval_grid(B, n, sms, want):
    assert kernel.grid(B, n, sms) == want


@pytest.mark.parametrize("B", [1, 37, 64, 256, 1000])
@pytest.mark.parametrize("n", [1, 84, 500, 16384, 65536, 10 ** 6])
def test_retrieval_grid_fills_the_card_with_whole_tiles(B, n):
    """Query tiles cover B; splits are whole tiles and cover n, none empty;
    the grid holds at least WAVES blocks per SM unless the corpus has fewer
    tiles; 16-row query tiles only where 64-row ones leave SMs idle."""
    sms = 132
    g = kernel.grid(B, n, sms)
    n_tiles = -(-n // kernel.CORPUS_TILE)
    assert g.query_tile in kernel.QUERY_TILES
    assert g.q_tiles * g.query_tile >= B > (g.q_tiles - 1) * g.query_tile
    assert (g.n_splits - 1) * g.per_split < n_tiles <= g.n_splits * g.per_split
    assert g.q_tiles * g.n_splits >= min(kernel.WAVES * sms,
                                         g.q_tiles * n_tiles)
    assert (g.query_tile == 64) == (-(-B // 64) * n_tiles >= sms)


def _running_topk(cands, k):
    """A running top-k over (value, id) pairs in offer order, by the rule of
    ``WarpTopK`` (``csrc/topk.cuh``): a candidate enters only when the list
    is short of k or it is strictly above the k-th value, and lands behind
    every held value equal to it."""
    vals, ids = [], []
    for v, i in cands:
        if len(vals) == k and not v > vals[-1]:
            continue
        pos = sum(1 for x in vals if x >= v)
        vals.insert(pos, v)
        ids.insert(pos, i)
        del vals[k:], ids[k:]
    return vals, ids


def split_merge_topk(q, corpus, k, split_rows):
    """Plain model of the tiled kernel and its merge: (vals, ids) as (B, k)
    numpy arrays."""
    scores = (q @ corpus.T).numpy()
    n = corpus.shape[0]
    out_v, out_i = [], []
    for row in scores:
        lists = [_running_topk(((row[j], j) for j in
                                range(lo, min(lo + split_rows, n))), k)
                 for lo in range(0, n, split_rows)]
        v, i = _running_topk((p for lv, li in lists for p in zip(lv, li)), k)
        out_v.append(v)
        out_i.append(i)
    return np.asarray(out_v, np.float32), np.asarray(out_i, np.int32)


def _tied_inputs(seed, B, n, k, split_rows):
    """Exact-arithmetic inputs (multiples of 1/8, d = 32) with rows
    duplicated across every split boundary (the 24 rows before each
    boundary reappear, mirrored, just after it), and for queries 0 and 1
    the row at their k-th place copied over a lower-scoring row of another
    split, after it for query 0 and (where a split lies before it) before it
    for query 1."""
    rng = np.random.default_rng(seed)
    corpus = rng.integers(-3, 4, size=(n, 32)) / 8.0
    for edge in range(split_rows, n, split_rows):
        for j in range(min(24, n - edge)):
            corpus[edge + j] = corpus[edge - 1 - j]
    q = rng.integers(-3, 4, size=(B, 32)) / 8.0
    for row, later in ((0, True), (1, False)):
        scores = corpus @ q[row]
        order = np.argsort(-scores, kind="stable")
        r = order[k - 1]
        below = order[k:][scores[order[k:]] < scores[r]]
        other = below[below // split_rows != r // split_rows]
        # before r where some split lies before it, else after
        side = other[(other > r) == later]
        corpus[(side if len(side) else other)[0]] = corpus[r]
    return q.astype(np.float32), corpus.astype(np.float32)


@pytest.mark.parametrize("split_rows", [128, 256])
@pytest.mark.parametrize("k", [1, 16, 50, 64])
def test_split_then_merge_equals_the_jax_reference(k, split_rows):
    q, corpus = _tied_inputs(k + split_rows, 12, 700, k, split_rows)
    vals, ids = split_merge_topk(torch.from_numpy(q), torch.from_numpy(corpus),
                                 k, split_rows)
    rv, ri = jax_ref(jnp.asarray(q), jnp.asarray(corpus), k=k)
    np.testing.assert_array_equal(ids, np.asarray(ri))
    np.testing.assert_allclose(vals, np.asarray(rv), atol=1e-6, rtol=0)
    # the data does test the rule: exact ties straddle a split boundary
    # inside the top k, and ties sit at the k-th place
    scores = q @ corpus.T
    kth = np.sort(scores, axis=1)[:, ::-1][:, k - 1]
    tied_at_kth = (scores == kth[:, None]).sum(1) > 1
    assert tied_at_kth[:2].all()
    straddle = [len({int(i) // split_rows for i in row[vals_r == v]}) > 1
                for row, vals_r in zip(ids, vals) for v in set(vals_r.tolist())]
    assert any(straddle) or k == 1


@pytest.mark.parametrize("k", [1, 16, 64])
def test_split_then_merge_on_continuous_scores(k):
    """Unit-vector similarities without designed ties: the model and the
    port's plain version agree with JAX's reference."""
    rng = np.random.default_rng(k)
    q = rng.standard_normal((9, 64)).astype(np.float32)
    corpus = rng.standard_normal((600, 64)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    vals, ids = split_merge_topk(torch.from_numpy(q), torch.from_numpy(corpus),
                                 k, 128)
    pv, pi = retrieval_topk_ref(torch.from_numpy(q), torch.from_numpy(corpus),
                                k=k)
    rv, ri = jax_ref(jnp.asarray(q), jnp.asarray(corpus), k=k)
    np.testing.assert_array_equal(ids, np.asarray(ri))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(vals, np.asarray(rv), atol=1e-6, rtol=0)
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), atol=1e-6, rtol=0)


def test_tiled_launch_refuses_what_its_route_does_not_send():
    """Asking the tiled variant (or the row one) for k above its lists'
    64 entries raises before anything is built or launched."""
    q = torch.zeros((2, 6))
    for variant in ("tiled", "row"):
        with pytest.raises(ValueError, match="k <= 64"):
            kernel.launch(q, torch.zeros((100, 6)), 65, variant)
    with pytest.raises(ValueError, match="unknown variant"):
        kernel.launch(q, torch.zeros((100, 6)), 4, "warp")


@pytest.mark.parametrize("B,n,k,want", [
    (256, 65536, 100, 256),   # the wide shape: one 64 MB chunk
    (256, 16384, 100, 256),   # deployment: 16 MB
    (300, 70000, 100, 239),   # two chunks
    (2, 20000, 9000, 2),      # 16384 keys a row spill: 32768 words a row
    (1000, 10 ** 7, 50, 1),   # one row past the bound still runs
    (5, 84, 70, 5),
])
def test_select_chunk(B, n, k, want):
    chunk = kernel.select_chunk(B, n, k)
    assert chunk == want
    words = n + kernel.sort_words(k)
    assert chunk * words <= kernel.SELECT_SCRATCH_WORDS or chunk == 1
    assert kernel.sort_words(k) == (0 if k <= kernel.SORT_CHUNK else
                                    2 * (1 << (k - 1).bit_length()))


# -- the select route, modelled ---------------------------------------------

def _select_keys(scores):
    """``select_key`` of tiled_topk.cuh: the float's bits made to order as
    unsigned (negative: all bits flipped; else the sign bit set), -0 as +0."""
    f = np.where(scores == 0, np.float32(0), scores).astype(np.float32)
    b = f.view(np.uint32)
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)


def _radix_select(keys, k):
    """The k-th largest key and how many entries equal to it the top k
    takes: four passes, each a histogram of the next 8 bits among the
    entries matching the bits found so far, scanned from the top bin."""
    prefix, mask, left = 0, 0, k
    for shift in (24, 16, 8, 0):
        hit = (keys & np.uint32(mask)) == prefix
        hist = np.bincount((keys[hit] >> shift) & 0xFF, minlength=256)
        above = 0
        for digit in range(255, -1, -1):
            if above + hist[digit] >= left:
                break
            above += hist[digit]
        prefix |= digit << shift
        mask |= 0xFF << shift
        left -= above
    return np.uint32(prefix), left


def _sort_step(a, off, size, stride):
    """One compare-exchange step of tiled_topk.cuh's descending bitonic
    sort over a (pairs e, e + stride with e's stride bit clear)."""
    e = np.arange(a.size)
    e = e[(e & stride) == 0]
    x, y = a[e].copy(), a[e + stride].copy()
    desc = ((off + e) & size) == 0
    swap = (x < y) == desc
    a[e[swap]], a[e[swap] + stride] = y[swap], x[swap]


def _sort_desc(buf, chunk):
    """``sort_desc``: all in one buffer when it fits ``chunk`` entries,
    else each chunk sorted, then per stage the strides >= chunk over the
    whole buffer and the rest chunk by chunk (a small ``chunk`` exercises
    the spilled schedule of kSortChunk = 8192)."""
    N = buf.size
    if N <= chunk:
        size = 2
        while size <= N:
            stride = size // 2
            while stride:
                _sort_step(buf, 0, size, stride)
                stride //= 2
            size *= 2
        return

    def in_chunks(sizes, first):
        for c in range(0, N, chunk):
            part = buf[c:c + chunk]  # a view: steps write through
            for size in sizes:
                stride = min(size // 2, first)
                while stride:
                    _sort_step(part, c, size, stride)
                    stride //= 2

    in_chunks([1 << i for i in range(1, chunk.bit_length())], chunk // 2)
    size = 2 * chunk
    while size <= N:
        stride = size // 2
        while stride >= chunk:
            _sort_step(buf, 0, size, stride)
            stride //= 2
        in_chunks([size], chunk // 2)
        size *= 2


def select_model(scores, k, chunk=kernel.SORT_CHUNK):
    """(vals, ids) of one row's top k as the select kernel finds them."""
    keys = _select_keys(scores)
    kth, take_eq = _radix_select(keys, k)
    ids = np.arange(scores.size)
    above = ids[keys > kth]
    rng = np.random.default_rng(k)  # atomics land above-kth entries in
    above = rng.permutation(above)  # any order
    equal = ids[keys == kth][:take_eq]  # ascending id
    survivors = np.concatenate([above, equal])
    assert survivors.size == k
    sort_n = 1 << (k - 1).bit_length()
    buf = np.zeros(sort_n, np.uint64)
    buf[:k] = ((keys[survivors].astype(np.uint64) << np.uint64(32))
               | (~survivors.astype(np.uint32)).astype(np.uint64))
    _sort_desc(buf, chunk)
    out_ids = (~(buf[:k] & np.uint64(0xFFFFFFFF)).astype(np.uint32)).astype(
        np.int32)
    return scores[out_ids], out_ids


def _tied_rows(seed, B, n, k):
    """``_tied_inputs`` with the row at each query's k-th place also
    copied where k = n (no rows below it)."""
    if k < n:
        return _tied_inputs(seed, B, n, k, 128)
    rng = np.random.default_rng(seed)
    corpus = rng.integers(-3, 4, size=(n, 32)) / 8.0
    corpus[n // 2:] = corpus[:n - n // 2]
    q = rng.integers(-3, 4, size=(B, 32)) / 8.0
    return q.astype(np.float32), corpus.astype(np.float32)


@pytest.mark.parametrize("chunk", [kernel.SORT_CHUNK, 16])
@pytest.mark.parametrize("k", [65, 100, 300])
def test_select_route_equals_the_jax_reference(k, chunk):
    """k = 300 = n, and chunk 16, run the spilled sort's schedule."""
    n = 300 if k == 300 else 700
    q, corpus = _tied_rows(k + chunk, 6, n, k)
    scores = q @ corpus.T
    got = [select_model(row, k, chunk) for row in scores]
    vals = np.stack([v for v, _ in got])
    ids = np.stack([i for _, i in got])
    rv, ri = jax_ref(jnp.asarray(q), jnp.asarray(corpus), k=k)
    np.testing.assert_array_equal(ids, np.asarray(ri))
    np.testing.assert_allclose(vals, np.asarray(rv), atol=1e-6, rtol=0)
    # the data does test the rule: ties at the k-th place that the top k
    # cuts (k < n), and negative zeros read as zeros
    kth = np.sort(scores, axis=1)[:, ::-1][:, k - 1]
    if k < n:
        assert ((scores == kth[:, None]).sum(1) > 1).all()


def test_select_keys_order_like_floats():
    x = np.array([-np.inf, -2.5, -1e-30, -0.0, 0.0, 1e-30, 0.5, 3.0, np.inf],
                 np.float32)
    keys = _select_keys(x)
    assert (np.diff(keys.astype(np.int64)) >= 0).all()
    assert keys[3] == keys[4]  # -0 ties with +0
    assert (np.diff(keys.astype(np.int64))[[0, 1, 2, 4, 5, 6, 7]] > 0).all()


# -- the dsqe epilogue on the modelled top-k ---------------------------------

def _first_argmax_as_the_kernel_reduces(psims, n_warps=4, group=4):
    """Warp w scores prototypes in groups of ``group`` (w, w + n_warps, ..
    groups), keeping the first of equal bests; then the warps' bests are
    taken on (value desc, index asc)."""
    best = []
    for w in range(n_warps):
        bv, bi = -np.inf, None
        for p0 in range(group * w, psims.size, group * n_warps):
            for p in range(p0, min(p0 + group, psims.size)):
                if bi is None or psims[p] > bv:
                    bv, bi = psims[p], p
        if bi is not None:
            best.append((bv, bi))
    return min(best, key=lambda t: (-t[0], t[1]))[1]


def dsqe_model(q, protos, train, pathw, contains, lat, cost, prior, valid,
               slo, knn):
    """(scores, set_id) as the two dsqe kernels compute them: the tiled
    route's top-k (split then merge) or the select route's, then the
    epilogue once per query."""
    if kernel.route(knn) == "tiled":
        vals, ids = split_merge_topk(torch.from_numpy(q),
                                     torch.from_numpy(train), knn, 128)
    else:
        got = [select_model(row, knn) for row in q @ train.T]
        vals = np.stack([v for v, _ in got])
        ids = np.stack([i for _, i in got])
    psims = q @ protos.T
    scores = np.empty((q.shape[0], pathw.shape[1]), np.float32)
    set_id = np.empty(q.shape[0], np.int32)
    for b in range(q.shape[0]):
        s = _first_argmax_as_the_kernel_reduces(psims[b])
        vote = np.zeros(pathw.shape[1], np.float32)
        for v, i in zip(vals[b], ids[b]):  # slot order, best first
            vote += np.float32(max(v, 0.0)) * pathw[i]
        feasible = ((contains[s] > 0.5) & (valid > 0.5) & (lat <= slo[b, 0])
                    & (cost <= slo[b, 1]))
        scores[b] = np.where(feasible, vote + prior, np.float32(-1e30))
        set_id[b] = s
    return scores, set_id


@pytest.mark.parametrize("knn", [1, 16, 64, 65, 100, 300])
def test_dsqe_epilogue_on_both_routes_equals_the_jax_reference(knn):
    """Tied train rows across split boundaries and at the knn-th place
    (knn = 300 = N), and duplicated prototypes: set ids are the first of
    the tied argmax in every row whose best prototype has a twin."""
    N = 300 if knn == 300 else 700
    q, train = _tied_rows(knn + 1, 9, N, knn)
    rng = np.random.default_rng(knn)
    K, P = 11, 37
    protos = rng.integers(-3, 4, size=(K, 32)) / 8.0
    protos[1::2] = protos[:K - 1:2]  # prototype 2i + 1 ties with 2i
    protos = protos.astype(np.float32)
    pathw = np.zeros((N, P), np.float32)
    pathw[np.arange(N), rng.integers(0, P, N)] = rng.integers(1, 9, N) / 8.0
    contains = (rng.uniform(size=(K, P)) < 0.6).astype(np.float32)
    lat = rng.uniform(0.1, 5.0, P).astype(np.float32)
    cost = rng.uniform(0.0, 0.01, P).astype(np.float32)
    prior = (rng.uniform(size=P) * 1e-3).astype(np.float32)
    valid = (rng.uniform(size=P) < 0.9).astype(np.float32)
    slo = np.stack([rng.uniform(0, 6, 9), rng.uniform(0, 0.012, 9)],
                   1).astype(np.float32)
    args = (q, protos, train, pathw, contains, lat, cost, prior, valid, slo)
    scores, set_id = dsqe_model(*args, knn)
    js, jid = jax_dsqe_ref(*map(jnp.asarray, args), knn=knn)
    np.testing.assert_array_equal(set_id, np.asarray(jid))
    js = np.asarray(js)
    masked = js < -5e29
    np.testing.assert_array_equal(scores < -5e29, masked)
    assert (scores[masked] == np.float32(-1e30)).all()
    np.testing.assert_allclose(scores[~masked], js[~masked], atol=1e-5)
    # the argmax ties are real: some row's best prototype has its twin
    psims = q @ protos.T
    best = psims.max(1, keepdims=True)
    assert ((psims == best).sum(1) > 1).any()
