"""Vector retrieval substrate: exact top-k and an IVF (k-means) index, with
a cross-query batched search path.

The emulator's RAG components run *real* retrieval over the domain corpus
embeddings; retrieval recall (did the context include the ground-truth
chunks?) is a measured quantity, not a modeled one.  Retrieval is the one
stage of the batched emulator that was still resolved one GEMV per query;
``search_batch`` sweeps a whole query block as one ``(Bq, d) @ (d, n)``
matmul so `Emulator.explore(batched=True)` can resolve a block's retrieval
in one pass.

Bitwise-stability contract (pinned by ``tests/test_retrieval_batch.py`` and
the ``benchmarks/retrieval_batch_speedup.py`` parity gate):

* ``search(q, ...)`` is literally ``search_batch(q[None], ...)[0]`` — one
  implementation, so B=1 and B>1 share every code path.
* The *canonical* scores returned for the selected ids are always computed
  by the same gathered GEMV ``emb[cand] @ q`` — a fixed per-row summation
  order over ``d`` that this BLAS keeps independent of the gather set and
  of the batch size (the batched GEMM would not: OpenBLAS switches kernels
  with the row count, so ``Q @ emb.T`` rows are NOT bitwise stable across
  Bq).  The GEMM is only a candidate *prefilter*; every candidate is
  rescored through the canonical GEMV before ranking.
* Ties are broken deterministically by LOWEST chunk id, via a composite
  integer sort key (monotone float32 bit pattern above, inverted id below)
  rather than sort stability — ``np.argpartition``'s arbitrary boundary
  order can never leak into results.
* The prefilter keeps a ``2k`` candidate band and widens to the full row
  whenever the k-th and band-edge scores tie exactly, so a boundary tie
  group larger than the band is still resolved by lowest id.  The only
  documented divergence mode left is a sub-ulp one: the float32 GEMM
  prefilter would have to disagree with the canonical GEMV ordering by
  more than k ranks inside a <=1-ulp score band — the same measure-zero
  caveat class as ``kernels/dsqe_score`` (see tests pinning real-domain
  parity).

Edge-case semantics (explicit, shared by ``search`` and ``search_batch``):

* ``k <= 0`` returns an empty result.
* ``k > n`` clamps to ``n`` (a result can never have more ids than chunks).
* IVF probes may return fewer than ``k`` ids when the probed lists hold
  fewer candidates; an ALL-EMPTY probe union (or ``nprobe <= 0``) falls
  back to an exact full scan for that query instead of returning nothing.

Device path: ``search_batch(..., use_kernel=True)`` routes the exact path
through ``repro_torch.kernels.stages.retrieve_stage``, so it launches the
same ``retrieval_topk`` CUDA kernel as path selection when the store's
``device`` is a GPU (the plain torch version on a CPU device).  One device
corpus is shared by a per-k cache of stage applies, so distinct ``k`` values
reuse the resident embeddings.  Its ids match the host path wherever scores
are separated by more than float32 accumulation noise (the kernel also breaks
ties by lowest index), but its scores are device float32 reductions, NOT the
canonical GEMV bit pattern — so the emulator's bit-for-bit parity path never
uses it; it is opt-in for throughput-bound sweeps and gated at decision level
only.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.kmeans import kmeans

_ID_BITS = 21  # composite keys support corpora up to 2^21 (~2M) chunks
_MAX_ID = np.uint64((1 << _ID_BITS) - 1)


@dataclass
class SearchResult:
    ids: np.ndarray  # (k,)
    scores: np.ndarray  # (k,)


def _order_keys(scores: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """uint64 composite sort keys: bigger key == (higher score, lower id).

    The float32 bit pattern is mapped monotonically into the high bits
    (sign-flip for positives, full complement for negatives) and the
    complemented id fills the low bits, so every key is unique and an
    UNSTABLE partial sort still yields the deterministic lowest-id
    tie-break.
    """
    scores = np.ascontiguousarray(scores, np.float32)
    # canonicalize -0.0 -> +0.0: numerically equal zeros must share a key
    # prefix or the sign bit would outrank the lowest-id contract
    bits = np.where(scores == 0.0, np.float32(0.0), scores).view(np.uint32)
    ordered = np.where(
        bits & np.uint32(0x80000000),
        ~bits,
        bits | np.uint32(0x80000000),
    ).astype(np.uint64)
    return (ordered << np.uint64(_ID_BITS)) | (_MAX_ID - ids.astype(np.uint64))


class VectorStore:
    """Exact dot-product search with an optional IVF coarse quantizer.

    See the module docstring for the bitwise-stability and edge-case
    contracts shared by ``search`` and ``search_batch``.
    """

    def __init__(self, embeddings: np.ndarray, n_clusters: int = 0, seed: int = 0,
                 device: str = "cuda"):
        self.emb = np.ascontiguousarray(embeddings, np.float32)
        self.n = embeddings.shape[0]
        if self.n >= (1 << _ID_BITS):
            raise ValueError(f"corpus of {self.n} chunks exceeds the "
                             f"{1 << _ID_BITS} composite-key id space")
        self.ivf = None
        self.device = device  # where the use_kernel path keeps the corpus
        self._dev_emb = None  # lazy device-resident corpus for use_kernel
        self._stage_cache: dict = {}  # k -> (state, retrieve apply)
        if n_clusters and n_clusters < self.n:
            centroids, assign = kmeans(self.emb, n_clusters, seed=seed)
            self.ivf = {
                "centroids": centroids,
                "lists": [np.where(assign == c)[0] for c in range(n_clusters)],
            }

    # -- canonical per-query ranking ----------------------------------------

    def _rescore_topk(self, query: np.ndarray, cand: np.ndarray, k: int
                      ) -> SearchResult:
        """Canonical ranking of a candidate id set for one query.

        Scores via the fixed-order gathered GEMV ``emb[cand] @ q`` (THE
        canonical reduction — batch-size independent), ranks by the
        composite (score desc, id asc) key.  ``cand`` must be duplicate
        free.
        """
        scores = self.emb[cand] @ query
        k = min(k, cand.size)
        order = np.argsort(_order_keys(scores, cand))[::-1][:k]
        return SearchResult(cand[order], scores[order])

    def _prefilter(self, row_scores: np.ndarray, k: int) -> np.ndarray:
        """Positions of a >=2k candidate band by prefilter score, widened to
        the full row when the k-th and band-edge values tie exactly."""
        w = row_scores.size
        m = min(2 * k, w)
        if m >= w:
            return np.arange(w)
        band = np.argpartition(-row_scores, m - 1)[:m]
        vals = np.sort(row_scores[band])  # ascending: vals[0] == band edge
        if vals[m - k] == vals[0]:  # k-th largest ties the band edge
            return np.arange(w)
        return band

    # -- public search API ---------------------------------------------------

    def search(self, query: np.ndarray, k: int, nprobe: int = 4) -> SearchResult:
        """Single-query top-k == ``search_batch(query[None], ...)[0]``."""
        return self.search_batch(query[None, :], k, nprobe)[0]

    def search_batch(self, queries: np.ndarray, k: int, nprobe: int = 4,
                     use_kernel: bool = False) -> list[SearchResult]:
        """Exact top-k for a whole query block in one matmul pass.

        Returns one ``SearchResult`` per query row, each identical (ids AND
        score bit patterns) to the corresponding ``search`` call — see the
        module docstring for the contract.  ``use_kernel=True`` routes the
        exact path through the ``retrieval_topk`` kernel on ``self.device``
        (decision-level parity only; scores are device float32 reductions,
        and IVF stays on the host).
        """
        queries = np.ascontiguousarray(queries, np.float32)
        Bq = queries.shape[0]
        if k <= 0:
            empty = SearchResult(np.empty(0, np.int64), np.empty(0, np.float32))
            return [SearchResult(empty.ids.copy(), empty.scores.copy())
                    for _ in range(Bq)]
        k = min(k, self.n)
        if self.ivf is None:
            if use_kernel:
                return self._search_batch_kernel(queries, k)
            return self._search_batch_exact(queries, k)
        return self._search_batch_ivf(queries, k, nprobe)

    # -- exact (flat) path ---------------------------------------------------

    def _search_batch_exact(self, queries: np.ndarray, k: int
                            ) -> list[SearchResult]:
        S = queries @ self.emb.T  # (Bq, n) GEMM prefilter
        return [self._rescore_topk(q, self._prefilter(s, k), k)
                for q, s in zip(queries, S)]

    def _search_batch_kernel(self, queries: np.ndarray, k: int
                             ) -> list[SearchResult]:
        import torch

        from repro_torch.kernels.common import resolve_device
        from repro_torch.kernels.stages import retrieve_stage

        if self._dev_emb is None:
            self._dev_emb = torch.as_tensor(
                self.emb, device=resolve_device(self.device))
        ent = self._stage_cache.get(k)
        if ent is None:
            # stage init over the already-device-resident corpus is a no-op
            # copy, so every k shares ONE resident embedding table
            ent = self._stage_cache[k] = retrieve_stage(
                self._dev_emb, k=k, query_key="q",
                out_vals="vals", out_ids="ids").init()
        state, apply = ent
        carry = apply(state, {"q": torch.as_tensor(
            queries, device=self._dev_emb.device)})
        vals = carry["vals"].cpu().numpy()
        ids = carry["ids"].cpu().numpy().astype(np.int64)  # one bulk cast, rows are views
        return [SearchResult(i, v) for i, v in zip(ids, vals)]

    # -- IVF path ------------------------------------------------------------

    def _probe(self, query: np.ndarray, nprobe: int) -> np.ndarray:
        """Probed centroid ids: canonical GEMV scores, lowest-id ties."""
        if nprobe <= 0:
            return np.empty(0, np.int64)
        cscores = self.ivf["centroids"] @ query  # canonical per-query GEMV
        K = cscores.size
        cids = np.arange(K)
        order = np.argsort(_order_keys(cscores, cids))[::-1]
        return cids[order[:min(nprobe, K)]]

    def _search_batch_ivf(self, queries: np.ndarray, k: int, nprobe: int
                          ) -> list[SearchResult]:
        lists = self.ivf["lists"]
        probes = [self._probe(q, nprobe) for q in queries]
        # union of per-query candidate lists, deduplicated; each query then
        # ranks only its own segment of the union
        used = sorted({int(c) for p in probes for c in p})
        segs = {c: np.unique(lists[c]) for c in used}  # unique: defensive dedup
        out: list[SearchResult] = []
        if used:
            union = np.concatenate([segs[c] for c in used])
            offsets = np.cumsum([0] + [segs[c].size for c in used])
            off_of = {c: (offsets[i], offsets[i + 1]) for i, c in enumerate(used)}
            S = queries @ self.emb[union].T if union.size else None  # one GEMM
        for qi, (q, p) in enumerate(zip(queries, probes)):
            spans = [off_of[int(c)] for c in p]
            cand = (np.concatenate([union[a:b] for a, b in spans])
                    if spans else np.empty(0, np.int64))
            cand = np.unique(cand)  # sorted unique corpus ids
            if cand.size == 0:
                # all-empty probe union: exact full-scan fallback (explicit)
                out.append(self._rescore_topk(q, self._prefilter(
                    self.emb @ q, k), k))
                continue
            # per-query segment scores gathered from the shared union GEMM
            pos = np.concatenate([np.arange(a, b) for a, b in spans])
            seg_scores = S[qi, pos]
            seg_ids = union[pos]
            if seg_ids.size != cand.size:  # duplicate ids across segments
                _, first = np.unique(seg_ids, return_index=True)
                pos, seg_ids = pos[first], seg_ids[first]
                seg_scores = S[qi, pos]
            band = self._prefilter(seg_scores, k)
            out.append(self._rescore_topk(q, seg_ids[band], k))
        return out
