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
