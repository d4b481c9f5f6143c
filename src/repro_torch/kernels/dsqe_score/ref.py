"""Plain torch version of the fused path-selection scoring (Algorithm 3).

Mirrors ``src/repro/kernels/dsqe_score/ref.py``: hard top-k kNN voting over
the training queries (Eq. 14), a single first-argmax critical set per query,
the ``1e-3 * path_mean_acc`` tie-break prior, per-query SLO vectors and the
evaluated-path validity mask.  ``dsqe_score_ref`` = the train-similarity
top-k of ``retrieval_topk_ref`` + ``dsqe_score_from_topk``; the selector's
score stage calls the same ``dsqe_score_from_topk`` on the retrieve stage's
top-k.

One deliberate difference from the JAX version: the votes gather the k
neighbours' ``path_weights`` rows instead of contracting a dense (B, k, N)
one-hot with the (N, P) table.  Both sum the same at most k nonzero
products per score (neighbour ids are distinct), only in another order, so
scores agree to a few float32 ulps (|score| <= k; the tests hold them to
1e-5 absolute) and masked entries are exactly ``NEG_INF`` in both.

Tie semantics: the critical set is the FIRST argmax prototype
(``torch.argmax`` returns the first maximal index), and exactly tied train
similarities at the k-boundary admit the lowest-index row.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import NEG_INF
from repro_torch.kernels.retrieval_topk.ref import retrieval_topk_ref

__all__ = ["NEG_INF", "dsqe_score_from_topk", "dsqe_score_ref"]


def dsqe_score_from_topk(z, topk_vals, topk_ids, protos, path_weights,
                         contains, lat, cost, prior, valid, slo, *,
                         proto_valid=None):
    """Masked path scores + critical-set ids from precomputed kNN top-k.

    ``z`` (Bq, d) projected queries; ``topk_vals``/``topk_ids`` (Bq, k) the
    train-similarity top-k (descending, lowest-index ties first); remaining
    tables as in ``dsqe_score_ref``.  ``slo`` must already be (Bq, 2)
    float32.  Returns (scores (Bq, P), set_id (Bq,) int32).

    ``proto_valid`` (K,), optional: per-prototype validity mask for
    domain-sharded tables padded to a common K; masked rows are forced to
    ``NEG_INF`` before the argmax so a zero pad prototype cannot win.
    """
    lat = lat.reshape(1, -1)
    cost = cost.reshape(1, -1)
    prior = prior.reshape(1, -1)
    valid = valid.reshape(1, -1)

    psims = z @ protos.T  # (Bq, K)
    if proto_valid is not None:
        psims = torch.where(proto_valid.reshape(1, -1) > 0.5, psims, NEG_INF)
    set_id = torch.argmax(psims, dim=1)  # first max wins on exact ties

    w = torch.clamp_min(topk_vals, 0.0)  # (Bq, k)
    rows = path_weights[topk_ids.long()]  # (Bq, k, P)
    scores = (w.unsqueeze(2) * rows).sum(dim=1) + prior

    feasible = ((contains[set_id] > 0.5) & (valid > 0.5)
                & (lat <= slo[:, 0:1]) & (cost <= slo[:, 1:2]))
    return torch.where(feasible, scores, NEG_INF), set_id.to(torch.int32)


def broadcast_slo(slo, Bq: int, device) -> torch.Tensor:
    """A (2,) SLO or (Bq, 2) per-query SLOs as a (Bq, 2) float32 tensor."""
    slo = torch.as_tensor(slo, dtype=torch.float32, device=device)
    return slo.reshape(-1, 2).expand(Bq, 2).contiguous()


def dsqe_score_ref(q, protos, train, path_weights, contains, lat, cost,
                   prior, valid, slo, *, knn: int = 16):
    """Masked path scores + critical-set ids for a query batch.

    Shapes: q (Bq,d), protos (K,d), train (N,d), path_weights (N,P) —
    one-hot(P_q) * A(q,P_q) rows — contains (K,P), lat/cost/prior/valid
    (P,) or (1,P), slo (Bq,2) or (2,) broadcast per-query
    [max_latency, max_cost].  Returns (scores (Bq,P), set_id (Bq,)).
    """
    slo = broadcast_slo(slo, q.shape[0], q.device)
    vals, idx = retrieval_topk_ref(q, train, k=min(knn, train.shape[0]))
    return dsqe_score_from_topk(q, vals, idx, protos, path_weights, contains,
                                lat, cost, prior, valid, slo)
