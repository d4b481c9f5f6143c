"""Public wrapper for the batched retrieval top-k.

Dispatch (``kernels/common.py``): CPU tensors take the plain version in
``ref.py``; CUDA tensors launch a Hopper kernel (``kernel.py``) or raise.
Which kernel is one rule on k (``kernel.route``), for every width d: k <= 64
takes the tiled kernel (split corpus, then a merge), the rest the select
route (similarity block, then a radix select per row).  Nothing is caught:
a failed build or launch raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import check_f32, refuse_grad, use_kernel
from repro_torch.kernels.retrieval_topk import kernel
from repro_torch.kernels.retrieval_topk.ref import retrieval_topk_ref


def retrieval_topk(q: torch.Tensor, corpus: torch.Tensor, *, k: int):
    """Batched retrieval top-k.  Returns (scores (Bq, k) float32, ids (Bq, k)
    int32).

    Shapes: q (Bq, d), corpus (n, d); ``k`` is clamped to ``n``.  Scores
    descending per row, exact ties broken by lowest corpus id.
    ``retrieval_topk.launches`` counts kernel calls,
    ``retrieval_topk.launches_tiled`` and ``retrieval_topk.launches_select``
    those of each route.
    """
    k = min(k, corpus.shape[0])
    if not use_kernel(q, corpus):
        return retrieval_topk_ref(q, corpus, k=k)
    refuse_grad("retrieval_topk", q, corpus)
    check_f32("q", q, (None, None))
    check_f32("corpus", corpus, (None, q.shape[1]))
    if k < 1:
        raise ValueError(f"retrieval_topk takes 1 <= k and n >= 1, got k={k}, "
                         f"n={corpus.shape[0]}")
    if q.shape[0] == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=q.device),
                torch.empty((0, k), dtype=torch.int32, device=q.device))
    variant = kernel.route(k)
    vals, ids = kernel.launch(q, corpus, k, variant)
    retrieval_topk.launches += 1
    if variant == "tiled":
        retrieval_topk.launches_tiled += 1
    else:
        retrieval_topk.launches_select += 1
    return vals, ids


retrieval_topk.launches = 0
retrieval_topk.launches_tiled = 0
retrieval_topk.launches_select = 0
