"""Public wrapper for prefill (flash) attention, with its gradient.

Dispatch (``kernels/common.py``): CPU tensors take the plain versions in
``ref.py``; CUDA tensors launch a Hopper kernel (``kernel.py``) or raise.
Which forward kernel is one rule on dtype and shape (``kernel.route``): bf16
(head dim a multiple of 16, so TMA's 16-byte global strides hold) runs on
the tensor cores, fp32 on the first port's FFMA kernel.  Nothing is caught:
a failed build or launch raises.  Fake tensors take the kernels' shape
route (``kernels/common.py``): the same checks and routes, the outputs'
shapes, the work reported, no launch and no count.

On the H100 causal prefill is bound by operations (4 hd FLOPs per visible
query-key pair): the tensor-core variant runs both products on wgmma from
TMA-fed shared-memory tiles, keeps the online softmax and P in registers,
and lets its two consumer warpgroups take turns on the tensor cores
(``csrc/flash_attention_tc.cu``).

Gradients: when grad mode is on and an input requires grad, the call goes
through ``FlashAttention``, a ``torch.autograd.Function`` whose forward
launches the lse twin of the routed kernel and saves (q, k, v, out, lse),
and whose backward launches ``csrc/flash_attention_bwd.cu`` (on the CPU:
``flash_attention_lse_ref`` and ``flash_attention_bwd_ref``), as the JAX
package's custom VJP (``src/repro/models/layers.py:123-239``).  Otherwise the
call launches exactly the serving kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import (SHAPE, check_attention_inputs,
                                        use_kernel)
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_lse_ref,
                                                     flash_attention_ref)


def _checked(q, k, v):
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    check_attention_inputs(q=q, k=k, v=v)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] or \
            q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit "
                         "(B, Sq, H, hd), (B, Skv, Kv, hd) with Kv | H")
    return q, k, v


def _count(variant: str) -> None:
    flash_attention.launches += 1
    if variant == "tc":
        flash_attention.launches_tc += 1
    else:
        flash_attention.launches_ffma += 1


class FlashAttention(torch.autograd.Function):
    """Prefill attention whose backward is the flash backward kernel (on the
    CPU, its plain version).  ``lse`` is an output that carries no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, chunk_attn: int):
        masks = dict(causal=causal, window=window, chunk_attn=chunk_attn)
        dispatch = use_kernel(q, k, v)
        if dispatch:
            q, k, v = _checked(q, k, v)
            variant = kernel.route(q.dtype, q.shape[3])
            out, lse = kernel.launch(q, k, v, variant, with_lse=True,
                                     shape_only=dispatch == SHAPE, **masks)
            if dispatch != SHAPE:
                flash_attention.launches_lse += 1
                if variant == "tc":
                    flash_attention.launches_lse_tc += 1
                else:
                    flash_attention.launches_lse_ffma += 1
        else:
            out, lse = flash_attention_lse_ref(q, k, v, **masks)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = masks
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dispatch = use_kernel(q, k, v, dout)
        if not dispatch:
            return (*flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                             **ctx.masks), None, None, None)
        dout = dout.contiguous()
        check_attention_inputs(dout=dout)
        if dout.dtype != q.dtype or dout.shape != q.shape:
            raise ValueError(f"flash_attention backward: dout "
                             f"{tuple(dout.shape)} {dout.dtype} does not "
                             f"match q {tuple(q.shape)} {q.dtype}")
        variant = kernel.route_bwd(q.dtype, q.shape[3])
        dq, dk, dv = kernel.launch_bwd(q, k, v, out, lse, dout, variant,
                                       shape_only=dispatch == SHAPE,
                                       **ctx.masks)
        if dispatch == SHAPE:
            return dq, dk, dv, None, None, None
        flash_attention.launches_bwd += 1
        if variant == "tc":
            flash_attention.launches_bwd_tc += 1
        else:
            flash_attention.launches_bwd_ffma += 1
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    chunk_attn: int = 0) -> torch.Tensor:
    """Softmax attention of every query row over the keys it may see.

    Shapes: q (B, Sq, H, hd), k and v (B, Skv, Kv, hd) with H a multiple of
    Kv; query head h reads KV head ``h // (H // Kv)``.  Positions count from
    0 on both sides.  Masks: ``causal`` (t >= u), ``window`` (t - u <
    window), ``chunk_attn`` (same chunk).  Returns (B, Sq, H, hd) in q's
    dtype; a row that sees no key is 0 (and gets zero gradients).  The
    kernels take fp32 or bf16 and head_dim a multiple of 16 up to 256.

    Counters: ``flash_attention.launches`` counts the serving kernels'
    launches, ``launches_tc`` and ``launches_ffma`` those of each variant;
    ``launches_lse`` (with ``launches_lse_tc`` / ``launches_lse_ffma``) the
    training forwards (a forward under ``torch.utils.checkpoint`` runs, and
    counts, again in the backward), ``launches_bwd`` the backward kernel
    (``launches_bwd_tc`` / ``launches_bwd_ffma`` by variant,
    ``kernel.route_bwd``).
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, _ = FlashAttention.apply(q, k, v, causal, window, chunk_attn)
        return out
    dispatch = use_kernel(q, k, v)
    if not dispatch:
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   chunk_attn=chunk_attn)
    q, k, v = _checked(q, k, v)
    if q.numel() == 0:
        return torch.empty_like(q)
    variant = kernel.route(q.dtype, q.shape[3])
    out = kernel.launch(q, k, v, variant, causal=causal, window=window,
                        chunk_attn=chunk_attn, shape_only=dispatch == SHAPE)
    if dispatch != SHAPE:
        _count(variant)
    return out


flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_attention.launches_ffma = 0
flash_attention.launches_lse = 0
flash_attention.launches_lse_tc = 0
flash_attention.launches_lse_ffma = 0
flash_attention.launches_bwd = 0
flash_attention.launches_bwd_tc = 0
flash_attention.launches_bwd_ffma = 0
