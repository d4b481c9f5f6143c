"""Launch of the hand-written Hopper path-selection scoring kernel.

Replaces the Pallas TPU kernel ``dsqe_score_kernel``
(``src/repro/kernels/dsqe_score/kernel.py:112``, body ``_dsqe_kernel`` at
:50).  The CUDA source is ``repro_torch/csrc/selection.cu``; its top-k
phase is the same device code as ``retrieval_topk`` (``csrc/topk.cuh``).
The TPU kernel multiplies a dense vote vector by the whole (N, P)
path-weight table held in VMEM, which would not fit an SM's shared memory
at deployment N; this kernel gathers only the k rows a query voted for.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import kernel_library
from repro_torch.kernels.retrieval_topk.kernel import prepare


def launch(q, protos, train, path_weights, contains, lat, cost, prior, valid,
           slo, knn: int):
    """(scores (B, P) fp32, set_id (B,) int32) for contiguous fp32 CUDA
    inputs; the caller has validated shapes and ``1 <= knn <= 64``."""
    B, d = q.shape
    K, N, P = protos.shape[0], train.shape[0], path_weights.shape[1]
    prepare(d, q.device)
    scores = torch.empty((B, P), dtype=torch.float32, device=q.device)
    set_id = torch.empty((B,), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        err = kernel_library().lib.dsqe_score_launch(
            *(t.data_ptr() for t in (q, protos, train, path_weights, contains,
                                     lat, cost, prior, valid, slo, scores,
                                     set_id)),
            B, K, N, P, d, knn, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dsqe_score launch failed: CUDA error {err}")
    return scores, set_id
