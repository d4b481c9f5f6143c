"""Public wrapper for the RG-LRU scan, with its gradient.

Dispatch (``kernels/common.py``): CPU tensors take the plain versions in
``ref.py``; CUDA tensors launch the Hopper kernels (``kernel.py``) or raise;
fake tensors take the kernels' shape route (the same checks and plan, the
outputs' shapes, the work reported, no launch and no count).

Gradients: when grad mode is on and an input requires grad, the call goes
through ``RglruScan``, a ``torch.autograd.Function`` whose forward launches
the serving kernel and saves a, h0 and the fp32 states it returns, and whose
backward launches ``rglru_scan_bwd_kernel`` (``csrc/rglru_scan.cu``; on the
CPU ``rglru_scan_bwd_ref``).  The JAX package differentiates its associative
scan with XLA (``src/repro/models/blocks.py:431-448``).  Otherwise the call
launches exactly the serving kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import KERNEL_DTYPES, SHAPE, use_kernel
from repro_torch.kernels.rglru_scan import kernel
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_ref,
                                                rglru_scan_ref)


def _forward(a: torch.Tensor, x: torch.Tensor,
             h0: torch.Tensor) -> torch.Tensor:
    """The serving path: the plain version on the CPU, else the kernel,
    counted."""
    dispatch = use_kernel(a, x, h0)
    if not dispatch:
        return rglru_scan_ref(a, x, h0)
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
    out = kernel.launch(a, x, h0.float().contiguous(), KERNEL_DTYPES[a.dtype],
                        shape_only=dispatch == SHAPE)
    if dispatch == SHAPE:
        return out
    rglru_scan_op.launches += 1
    if kernel.last_route() == "tma":
        rglru_scan_op.launches_tma += 1
    else:
        rglru_scan_op.launches_cp_async += 1
    return out


class RglruScan(torch.autograd.Function):
    """The scan whose backward is the backward kernel (on the CPU, its plain
    version)."""

    @staticmethod
    def forward(ctx, a, x, h0):
        h = _forward(a, x, h0)
        ctx.save_for_backward(a, h0, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h0, h = ctx.saved_tensors
        dispatch = use_kernel(a, h, dh)
        if not dispatch:
            da, dx, dh0 = rglru_scan_bwd_ref(a, h0, h, dh)
        elif a.numel() == 0:
            da, dx = torch.zeros_like(a), torch.zeros_like(a)
            dh0 = torch.zeros(h0.shape, dtype=torch.float32, device=a.device)
        else:
            dh = dh.float().contiguous()
            da, dx, dh0 = kernel.launch_bwd(
                a, h0.float().contiguous(), h, dh, KERNEL_DTYPES[a.dtype],
                shape_only=dispatch == SHAPE)
            if dispatch != SHAPE:
                rglru_scan_op.launches_bwd += 1
                if kernel.last_route() == "tma":
                    rglru_scan_op.launches_bwd_tma += 1
                else:
                    rglru_scan_op.launches_bwd_cp_async += 1
        return da, dx, dh0.to(h0.dtype)


def rglru_scan_op(a: torch.Tensor, x: torch.Tensor,
                  h0: torch.Tensor) -> torch.Tensor:
    """The diagonal recurrence ``h_t = a_t * h_{t-1} + x_t`` over time.

    Shapes: a (decay) and x (input) (B, S, R) of one dtype, h0 (B, R).
    Returns every state, (B, S, R) in fp32; the carry is fp32 throughout.
    The kernel takes a and x in fp32 or bf16 and h0 in any float dtype (it
    reads h0 as fp32).  ``rglru_scan_op.launches`` counts the forward
    kernel's launches (training's too, again under
    ``torch.utils.checkpoint``), ``launches_bwd`` the backward kernel's;
    ``launches_tma`` / ``launches_cp_async`` and ``launches_bwd_tma`` /
    ``launches_bwd_cp_async`` count them by the producer route the C
    launcher took (``kernel.last_route``).
    """
    if torch.is_grad_enabled() and (a.requires_grad or x.requires_grad
                                    or h0.requires_grad):
        return RglruScan.apply(a, x, h0)
    return _forward(a, x, h0)


rglru_scan_op.launches = 0
rglru_scan_op.launches_bwd = 0
rglru_scan_op.launches_tma = 0
rglru_scan_op.launches_cp_async = 0
rglru_scan_op.launches_bwd_tma = 0
rglru_scan_op.launches_bwd_cp_async = 0
