"""Public wrapper for the grouped expert matmul.

Dispatch (``kernels/common.py``): CPU tensors take the plain version in
``ref.py``; CUDA tensors launch a Hopper kernel (``kernel.py``) or raise.
Which kernel is one rule on dtype and shape (``kernel.route``): bf16 with D
and F multiples of 8 (TMA's 16-byte global strides) runs on the tensor
cores, the rest (fp32, other bf16 shapes) on the first port's fp32 FFMA
kernel.  Nothing is caught: a failed build or launch raises.

On the H100 the op is bound by operations at prefill (~1000 FLOP per byte
at C = 640 rows per expert) and by the bytes of w at decode (C = 8): the
tensor-core variant keeps TMA loads of x and w tiles in flight through an
mbarrier ring while wgmma consumes them, in 128 x 256 tiles at prefill and
as a deep stream of 64 x 128 w tiles at decode (``csrc/moe_gmm.cu``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import KERNEL_DTYPES, refuse_grad, use_kernel
from repro_torch.kernels.moe_gmm import kernel
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``out[e] = x[e] @ w[e]`` for every expert e.

    Shapes: x (E, C, D) dispatched tokens, w (E, D, F) expert weights, both
    of one dtype.  Returns (E, C, F) in x's dtype, the products summed in
    fp32.  The kernels take fp32 or bf16 and any C, D and F: ragged edges
    are masked or read as zeros, nothing is padded or copied.
    ``moe_gmm.launches`` counts kernel launches, ``moe_gmm.launches_tc``
    and ``moe_gmm.launches_ffma`` those of each variant.
    """
    if not use_kernel(x, w):
        return moe_gmm_ref(x, w)
    refuse_grad("moe_gmm", x, w)
    if x.dtype != w.dtype or x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"moe_gmm takes one dtype of float32 or bfloat16, "
                        f"got {x.dtype} and {w.dtype}")
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] or \
            w.shape[1] != x.shape[2]:
        raise ValueError(f"moe_gmm: x {tuple(x.shape)}, w {tuple(w.shape)} "
                         "do not fit (E, C, D), (E, D, F)")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("moe_gmm: x and w must be contiguous")
    E, C, D = x.shape
    F = w.shape[2]
    if x.numel() == 0 or w.numel() == 0:
        return torch.zeros((E, C, F), dtype=x.dtype, device=x.device)
    variant = kernel.route(x.dtype, D, F)
    out = kernel.launch(x, w, variant)
    moe_gmm.launches += 1
    if variant == "tc":
        moe_gmm.launches_tc += 1
    else:
        moe_gmm.launches_ffma += 1
    return out


moe_gmm.launches = 0
moe_gmm.launches_tc = 0
moe_gmm.launches_ffma = 0
