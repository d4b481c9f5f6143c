"""Plain torch version of the grouped expert matmul.

Mirrors the JAX package's ``moe_gmm_ref``
(``src/repro/kernels/moe_gmm/ref.py:8``) with the kernel's numerics: the
products summed in fp32, the result cast to x's dtype.  The CPU path uses
it, and on the card it is what the kernel is held against.
"""
from __future__ import annotations

import torch


def moe_gmm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, C, D), w (E, D, F) -> (E, C, F) in x's dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def moe_gmm_bwd_ref(x: torch.Tensor, w: torch.Tensor,
                    dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward of ``moe_gmm_ref`` for the upstream gradient dy (E, C,
    F): dx[e] = dy[e] @ w[e]^T (E, C, D) and dw[e] = x[e]^T @ dy[e] (E, D,
    F), summed in fp32 and cast to x's and w's dtypes."""
    dy32 = dy.float()
    dx = torch.einsum("ecf,edf->ecd", dy32, w.float()).to(x.dtype)
    dw = torch.einsum("ecd,ecf->edf", x.float(), dy32).to(w.dtype)
    return dx, dw
