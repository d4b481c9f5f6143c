"""Public wrapper for the grouped expert matmul.

Dispatch (``kernels/common.py``): CPU tensors take the plain version in
``ref.py``; CUDA tensors launch the Hopper kernel (``kernel.py``) or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import KERNEL_DTYPES, use_kernel
from repro_torch.kernels.moe_gmm import kernel
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``out[e] = x[e] @ w[e]`` for every expert e.

    Shapes: x (E, C, D) dispatched tokens, w (E, D, F) expert weights, both
    of one dtype.  Returns (E, C, F) in x's dtype, the products summed in
    fp32.  The kernel takes fp32 or bf16 and any C, D and F: ragged edges
    are masked by bounds, nothing is padded or copied.
    ``moe_gmm.launches`` counts kernel launches.
    """
    if not use_kernel(x, w):
        return moe_gmm_ref(x, w)
    if x.dtype != w.dtype or x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"moe_gmm takes one dtype of float32 or bfloat16, "
                        f"got {x.dtype} and {w.dtype}")
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] or \
            w.shape[1] != x.shape[2]:
        raise ValueError(f"moe_gmm: x {tuple(x.shape)}, w {tuple(w.shape)} "
                         "do not fit (E, C, D), (E, D, F)")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("moe_gmm: x and w must be contiguous")
    E, C, _ = x.shape
    if x.numel() == 0 or w.numel() == 0:
        return torch.zeros((E, C, w.shape[2]), dtype=x.dtype, device=x.device)
    out = kernel.launch(x, w, KERNEL_DTYPES[x.dtype])
    moe_gmm.launches += 1
    return out


moe_gmm.launches = 0
