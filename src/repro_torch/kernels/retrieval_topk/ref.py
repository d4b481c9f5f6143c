"""Plain torch version of the batched retrieval top-k.

The CPU tests use it, and on the card it is what the kernel is held
against; nothing on the card's main path calls it.

Tie semantics: a stable descending sort keeps exactly tied scores in
ascending id order, so a tie admits the LOWEST corpus id (``torch.topk``
promises no order among ties, so it is not used).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import NEG_INF

__all__ = ["NEG_INF", "retrieval_topk_ref"]


def retrieval_topk_ref(q: torch.Tensor, corpus: torch.Tensor, *, k: int):
    """Top-k ids + scores for a query block.

    Shapes: q (Bq, d), corpus (n, d).  Returns (scores (Bq, k) float32,
    ids (Bq, k) int32), scores descending, exact ties lowest-id first.
    """
    scores = q @ corpus.T  # (Bq, n)
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return (vals[:, :k].to(torch.float32).contiguous(),
            idx[:, :k].to(torch.int32).contiguous())
