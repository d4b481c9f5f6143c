"""Launch of the hand-written Hopper path-selection scoring kernels.

Replace the Pallas TPU kernel ``dsqe_score_kernel``
(``src/repro/kernels/dsqe_score/kernel.py:112``, body ``_dsqe_kernel`` at
:50).  The CUDA source is ``repro_torch/csrc/dsqe_score.cu``: the kNN
similarity and top-k are ``retrieval_topk``'s tiled top-k core
(``csrc/tiled_topk.cuh``) over the train rows, by the same rule on knn
(``retrieval_topk.kernel.route``) and the same grid, and the scoring (the
first-argmax prototype, the vote over the k neighbours' path-weight rows,
the prior, the SLO / containment / validity mask) runs once per query
where its top-k is final: in the merge of the splits' lists (``"tiled"``,
knn <= 64) or in the select block (``"select"``).  Two launches a call.
What bounds it is the fp32 similarity, 2 B N d FLOPs on the CUDA cores;
the scoring adds 2 B K d FLOPs and B knn P gathered weights.  The TPU
kernel multiplies a dense vote vector by the whole (N, P) path-weight
table held in VMEM; this kernel gathers only the k rows a query voted for.
The first port's warp-per-row kernel (``csrc/selection.cu``, ``"row"``:
knn <= 64, d up to about 1600) is reached only by name, for comparison.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import kernel_library
from repro_torch.kernels.common import on_device, raw_stream, sm_count
from repro_torch.kernels.retrieval_topk.kernel import (TILED_MAX_K, VARIANTS,
                                                       grid, prepare,
                                                       select_chunk,
                                                       select_scratch, vec4)


def launch(q, protos, train, path_weights, contains, lat, cost, prior, valid,
           slo, knn: int, variant: str):
    """(scores (B, P) fp32, set_id (B,) int32) through ``variant`` for
    contiguous fp32 CUDA inputs; the caller has validated shapes and
    ``1 <= knn <= N``."""
    B, d = q.shape
    K, N, P = protos.shape[0], train.shape[0], path_weights.shape[1]
    if variant not in VARIANTS:
        raise ValueError(f"dsqe_score: unknown variant {variant!r}")
    if variant in ("tiled", "row") and knn > TILED_MAX_K:
        raise ValueError(f"dsqe_score: the {variant} variant takes knn <= "
                         f"{TILED_MAX_K}, got knn={knn}")
    scores = torch.empty((B, P), dtype=torch.float32, device=q.device)
    set_id = torch.empty((B,), dtype=torch.int32, device=q.device)
    tables = tuple(t.data_ptr() for t in (q, protos, train, path_weights,
                                          contains, lat, cost, prior, valid,
                                          slo))
    out = (scores.data_ptr(), set_id.data_ptr())
    lib = kernel_library().lib
    if variant == "row":
        prepare(d, q.device)
    with on_device(q.device):
        stream = raw_stream(q.device)
        if variant == "row":
            err = lib.dsqe_score_row_launch(*tables, *out, B, K, N, P, d, knn,
                                            stream)
        elif variant == "tiled":
            g = grid(B, N, sm_count(q.device))
            # each split's knn best per query (values, ids); with more than
            # one split, the floors (B,) they share, zeroed
            lists = torch.empty(2 * B * g.n_splits * knn, dtype=torch.int32,
                                device=q.device)
            floors = (torch.zeros(B, dtype=torch.int32, device=q.device)
                      if g.n_splits > 1 else None)
            parts = (lists.data_ptr(), lists[B * g.n_splits * knn:].data_ptr(),
                     floors.data_ptr() if floors is not None else None)
            err = lib.dsqe_score_tiled_launch(*tables, *parts, *out, B, K, N,
                                              P, d, knn, vec4(q, train), *g,
                                              stream)
        else:
            chunk = select_chunk(B, N, knn)
            g = grid(chunk, N, sm_count(q.device))
            _buf, (sims, spill) = select_scratch(chunk, N, knn, q.device)
            err = lib.dsqe_score_select_launch(
                *tables, sims, spill, *out, B, K, N, P, d, knn,
                vec4(q, train), chunk, g.query_tile, g.per_split, g.n_splits,
                stream)
    if err != 0:
        raise RuntimeError(f"dsqe_score {variant} launch failed: CUDA error "
                           f"{err}")
    return scores, set_id
