"""Public wrapper for the RG-LRU scan.

Dispatch (``kernels/common.py``): CPU tensors take the plain version in
``ref.py``; CUDA tensors launch the Hopper kernel (``kernel.py``) or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import KERNEL_DTYPES, refuse_grad, use_kernel
from repro_torch.kernels.rglru_scan import kernel
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref


def rglru_scan_op(a: torch.Tensor, x: torch.Tensor,
                  h0: torch.Tensor) -> torch.Tensor:
    """The diagonal recurrence ``h_t = a_t * h_{t-1} + x_t`` over time.

    Shapes: a (decay) and x (input) (B, S, R) of one dtype, h0 (B, R).
    Returns every state, (B, S, R) in fp32; the carry is fp32 throughout.
    The kernel takes a and x in fp32 or bf16 and h0 in any float dtype (it
    reads h0 as fp32).  ``rglru_scan_op.launches`` counts kernel launches.
    """
    if not use_kernel(a, x, h0):
        return rglru_scan_ref(a, x, h0)
    refuse_grad("rglru_scan", a, x, h0)
    if a.dtype != x.dtype or a.dtype not in KERNEL_DTYPES:
        raise TypeError(f"rglru_scan takes a and x of one dtype of float32 "
                        f"or bfloat16, got {a.dtype} and {x.dtype}")
    if a.dim() != 3 or x.shape != a.shape or \
            tuple(h0.shape) != (a.shape[0], a.shape[2]):
        raise ValueError(f"rglru_scan: a {tuple(a.shape)}, x "
                         f"{tuple(x.shape)}, h0 {tuple(h0.shape)} do not fit "
                         "(B, S, R), (B, S, R), (B, R)")
    if not (a.is_contiguous() and x.is_contiguous()):
        raise ValueError("rglru_scan: a and x must be contiguous")
    if a.numel() == 0:
        return torch.empty(a.shape, dtype=torch.float32, device=a.device)
    out = kernel.launch(a, x, h0.float().contiguous(), KERNEL_DTYPES[a.dtype])
    rglru_scan_op.launches += 1
    return out


rglru_scan_op.launches = 0
