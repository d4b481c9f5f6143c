"""Public wrapper for the grouped expert matmul, with its gradient.

Dispatch (``kernels/common.py``): CPU tensors take the plain versions in
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

Gradients: when grad mode is on and an input requires grad, the call goes
through ``MoeGmm``, a ``torch.autograd.Function`` whose forward launches the
serving kernel and saves x and w, and whose backward launches the backward
kernels of ``csrc/moe_gmm.cu`` (dx = dy . w^T, dw = x^T . dy; on the CPU
``moe_gmm_bwd_ref``).  The JAX package differentiates its einsums with XLA
(``src/repro/models/blocks.py:331-337``).  Otherwise the call launches
exactly the serving kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import KERNEL_DTYPES, use_kernel
from repro_torch.kernels.moe_gmm import kernel
from repro_torch.kernels.moe_gmm.ref import moe_gmm_bwd_ref, moe_gmm_ref


def _forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The serving path: the plain version on the CPU, else the routed
    kernel, counted."""
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


class MoeGmm(torch.autograd.Function):
    """The grouped matmul whose backward is the backward kernel pair (on the
    CPU, its plain version)."""

    @staticmethod
    def forward(ctx, x, w):
        out = _forward(x, w)
        ctx.save_for_backward(x, w)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        if not use_kernel(x, w, dy):
            return moe_gmm_bwd_ref(x, w, dy)
        E, C, D = x.shape
        F = w.shape[2]
        dy = dy.contiguous()
        if dy.dtype != x.dtype or dy.shape != (E, C, F):
            raise ValueError(f"moe_gmm backward: dy {tuple(dy.shape)} "
                             f"{dy.dtype} does not match the output "
                             f"{(E, C, F)} {x.dtype}")
        if dy.numel() == 0 or x.numel() == 0:  # empty sums: zero gradients
            return torch.zeros_like(x), torch.zeros_like(w)
        variant = kernel.route_bwd(x.dtype, D, F)
        dx, dw = kernel.launch_bwd(x, w, dy, variant)
        moe_gmm.launches_bwd += 1
        if variant == "tc":
            moe_gmm.launches_bwd_tc += 1
        else:
            moe_gmm.launches_bwd_ffma += 1
        return dx, dw


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``out[e] = x[e] @ w[e]`` for every expert e.

    Shapes: x (E, C, D) dispatched tokens, w (E, D, F) expert weights, both
    of one dtype.  Returns (E, C, F) in x's dtype, the products summed in
    fp32.  The kernels take fp32 or bf16 and any C, D and F: ragged edges
    are masked or read as zeros, nothing is padded or copied.

    Counters: ``moe_gmm.launches`` counts the forward kernel's launches
    (training's too: a forward under ``torch.utils.checkpoint`` runs, and
    counts, again in the backward), ``launches_tc`` and ``launches_ffma``
    those of each variant; ``launches_bwd`` the backward's calls (each
    launches the dx and the dw kernel), ``launches_bwd_tc`` /
    ``launches_bwd_ffma`` by variant (``kernel.route_bwd``).
    """
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return MoeGmm.apply(x, w)
    return _forward(x, w)


moe_gmm.launches = 0
moe_gmm.launches_tc = 0
moe_gmm.launches_ffma = 0
moe_gmm.launches_bwd = 0
moe_gmm.launches_bwd_tc = 0
moe_gmm.launches_bwd_ffma = 0
