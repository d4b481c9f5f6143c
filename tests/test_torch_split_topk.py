"""The tiled retrieval top-k's plain rules, on the CPU.

* ``kernel.route``: the variant of a retrieval call (the tiled kernel
  copies 16-byte pieces of rows, so it takes d a multiple of 4).
* ``kernel.grid``: how the tiled kernel cuts the corpus into splits of
  whole 128-row tiles: at least ``WAVES`` blocks per SM where the corpus
  allows, and one split, so no merge, at the served selection shape.
* split-then-merge: a plain model of what the two kernels compute (each
  split's running top-k over its rows in ascending id with strict
  admission, then the lists offered in split order, each in its own order,
  to one more running top-k), held against the JAX package's
  ``retrieval_topk_ref`` (``jax.lax.top_k``: the lowest id wins an exact
  tie).  Entries are multiples of 1/8 at d = 32, so every score is exact in
  fp32 in either framework whatever the order of the sum, and exact ties
  are everywhere: duplicated rows on both sides of split boundaries, and at
  the k-th place.  Ids must be equal, values within 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.retrieval_topk.ref import retrieval_topk_ref as jax_ref
from repro_torch.kernels.retrieval_topk import kernel
from repro_torch.kernels.retrieval_topk.ref import retrieval_topk_ref


@pytest.mark.parametrize("d,want", [
    (256, "tiled"), (512, "tiled"), (4, "tiled"), (100, "tiled"),
    (1000, "tiled"), (4096, "tiled"),
    (3, "row"), (1, "row"), (257, "row"), (4095, "row"), (6, "row"),
])
def test_retrieval_route(d, want):
    assert kernel.route(d) == want


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
    """Asking the tiled variant for a width its 16-byte copies cannot
    take raises before anything is built or launched."""
    q = torch.zeros((2, 6))
    with pytest.raises(ValueError, match="multiple of 4"):
        kernel.launch(q, torch.zeros((10, 6)), 4, "tiled")
