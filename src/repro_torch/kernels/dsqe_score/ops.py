"""Public wrapper for the fused path-selection scoring.

Dispatch (``kernels/common.py``): CPU tensors take the plain version in
``ref.py``; CUDA tensors launch a Hopper kernel (``kernel.py``) or raise.
Which kernel is the retrieval rule on knn (``retrieval_topk.kernel.route``):
knn <= 64 takes the tiled top-k, the rest the select route.  Nothing is
caught: a failed build or launch raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import check_f32, refuse_grad, use_kernel
from repro_torch.kernels.dsqe_score import kernel
from repro_torch.kernels.dsqe_score.ref import broadcast_slo, dsqe_score_ref
from repro_torch.kernels.retrieval_topk.kernel import route


def dsqe_score(q, protos, train, path_weights, contains, lat, cost,
               prior, valid, slo, *, knn: int = 16):
    """Batched fused path selection.  Returns (masked scores (Bq, P) float32,
    set_id (Bq,) int32).

    Shapes: q (Bq,d), protos (K,d), train (N,d), path_weights (N,P),
    contains (K,P), lat/cost/prior/valid (P,), slo (Bq,2) per-query
    [max_latency, max_cost] (a single (2,) SLO broadcasts).  ``knn`` is
    clamped to N.  ``dsqe_score.launches`` counts kernel calls,
    ``dsqe_score.launches_tiled`` and ``dsqe_score.launches_select`` those
    of each route.
    """
    tensors = (q, protos, train, path_weights, contains, lat, cost, prior,
               valid)
    if not use_kernel(*tensors):
        return dsqe_score_ref(q, protos, train, path_weights, contains, lat,
                              cost, prior, valid, slo, knn=knn)
    refuse_grad("dsqe_score", *tensors)
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
    if knn < 1:
        raise ValueError(f"dsqe_score takes 1 <= knn and N >= 1, got "
                         f"knn={knn}, N={N}")
    if Bq == 0:
        return (torch.empty((0, P), dtype=torch.float32, device=q.device),
                torch.empty((0,), dtype=torch.int32, device=q.device))
    variant = route(knn)
    scores, set_id = kernel.launch(q, protos, train, path_weights, contains,
                                   lat, cost, prior, valid, slo, knn, variant)
    dsqe_score.launches += 1
    if variant == "tiled":
        dsqe_score.launches_tiled += 1
    else:
        dsqe_score.launches_select += 1
    return scores, set_id


dsqe_score.launches = 0
dsqe_score.launches_tiled = 0
dsqe_score.launches_select = 0
