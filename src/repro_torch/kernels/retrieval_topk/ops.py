"""Public wrapper for the batched retrieval top-k.

Dispatch (``kernels/common.py``): CPU tensors take the plain version in
``ref.py``; CUDA tensors launch the Hopper kernel (``kernel.py``) or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import check_f32, use_kernel
from repro_torch.kernels.retrieval_topk import kernel
from repro_torch.kernels.retrieval_topk.ref import retrieval_topk_ref


def retrieval_topk(q: torch.Tensor, corpus: torch.Tensor, *, k: int):
    """Batched retrieval top-k.  Returns (scores (Bq, k) float32, ids (Bq, k)
    int32).

    Shapes: q (Bq, d), corpus (n, d); ``k`` is clamped to ``n``.  Scores
    descending per row, exact ties broken by lowest corpus id.  The kernel
    takes 1 <= k <= 64.  ``retrieval_topk.launches`` counts kernel launches.
    """
    k = min(k, corpus.shape[0])
    if not use_kernel(q, corpus):
        return retrieval_topk_ref(q, corpus, k=k)
    check_f32("q", q, (None, None))
    check_f32("corpus", corpus, (None, q.shape[1]))
    if not 1 <= k <= kernel.max_k():
        raise ValueError(f"retrieval_topk kernel takes 1 <= k <= "
                         f"{kernel.max_k()}, got k={k}")
    if q.shape[0] == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=q.device),
                torch.empty((0, k), dtype=torch.int32, device=q.device))
    vals, ids = kernel.launch(q, corpus, k)
    retrieval_topk.launches += 1
    return vals, ids


retrieval_topk.launches = 0
