"""Public wrapper for the fused path-selection scoring.

Dispatch (``kernels/common.py``): CPU tensors take the plain version in
``ref.py``; CUDA tensors launch the Hopper kernel (``kernel.py``) or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import check_f32, use_kernel
from repro_torch.kernels.dsqe_score import kernel
from repro_torch.kernels.dsqe_score.ref import broadcast_slo, dsqe_score_ref
from repro_torch.kernels.retrieval_topk.kernel import max_k


def dsqe_score(q, protos, train, path_weights, contains, lat, cost,
               prior, valid, slo, *, knn: int = 16):
    """Batched fused path selection.  Returns (masked scores (Bq, P) float32,
    set_id (Bq,) int32).

    Shapes: q (Bq,d), protos (K,d), train (N,d), path_weights (N,P),
    contains (K,P), lat/cost/prior/valid (P,), slo (Bq,2) per-query
    [max_latency, max_cost] (a single (2,) SLO broadcasts).  ``knn`` is
    clamped to N; the kernel takes 1 <= knn <= 64.  ``dsqe_score.launches``
    counts kernel launches.
    """
    tensors = (q, protos, train, path_weights, contains, lat, cost, prior,
               valid)
    if not use_kernel(*tensors):
        return dsqe_score_ref(q, protos, train, path_weights, contains, lat,
                              cost, prior, valid, slo, knn=knn)
    check_f32("q", q, (None, None))
    Bq, d = q.shape
    K, N, P = protos.shape[0], train.shape[0], path_weights.shape[1]
    lat, cost, prior, valid = (t.reshape(-1) for t in (lat, cost, prior, valid))
    slo = broadcast_slo(slo, Bq, q.device)
    for name, t, shape in (("protos", protos, (K, d)), ("train", train, (N, d)),
                           ("path_weights", path_weights, (N, P)),
                           ("contains", contains, (K, P)), ("lat", lat, (P,)),
                           ("cost", cost, (P,)), ("prior", prior, (P,)),
                           ("valid", valid, (P,)), ("slo", slo, (Bq, 2))):
        check_f32(name, t, shape)
    if K < 1 or P < 1:
        raise ValueError(f"need K >= 1 and P >= 1, got K={K}, P={P}")
    knn = min(knn, N)
    if not 1 <= knn <= max_k():
        raise ValueError(f"dsqe_score kernel takes 1 <= knn <= {max_k()}, "
                         f"got knn={knn}")
    if Bq == 0:
        return (torch.empty((0, P), dtype=torch.float32, device=q.device),
                torch.empty((0,), dtype=torch.int32, device=q.device))
    scores, set_id = kernel.launch(q, protos, train, path_weights, contains,
                                   lat, cost, prior, valid, slo, knn)
    dsqe_score.launches += 1
    return scores, set_id


dsqe_score.launches = 0
