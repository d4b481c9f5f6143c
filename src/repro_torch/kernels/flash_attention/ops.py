"""Public wrapper for prefill (flash) attention.

Dispatch (``kernels/common.py``): CPU tensors take the plain version in
``ref.py``; CUDA tensors launch a Hopper kernel (``kernel.py``) or raise.
Which kernel is one rule on dtype and shape (``kernel.route``): bf16 (head
dim a multiple of 16, so TMA's 16-byte global strides hold) runs on the
tensor cores, fp32 on the first port's FFMA kernel.  Nothing is caught: a
failed build or launch raises.

On the H100 causal prefill is bound by operations (4 hd FLOPs per visible
query-key pair): the tensor-core variant runs both products on wgmma from
TMA-fed shared-memory tiles, keeps the online softmax and P in registers,
and lets its two consumer warpgroups take turns on the tensor cores
(``csrc/flash_attention_tc.cu``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import check_attention_inputs, use_kernel
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    chunk_attn: int = 0) -> torch.Tensor:
    """Softmax attention of every query row over the keys it may see.

    Shapes: q (B, Sq, H, hd), k and v (B, Skv, Kv, hd) with H a multiple of
    Kv; query head h reads KV head ``h // (H // Kv)``.  Positions count from
    0 on both sides.  Masks: ``causal`` (t >= u), ``window`` (t - u <
    window), ``chunk_attn`` (same chunk).  Returns (B, Sq, H, hd) in q's
    dtype; a row that sees no key is 0.  The kernels take fp32 or bf16 and
    head_dim a multiple of 16 up to 256.  ``flash_attention.launches``
    counts kernel launches, ``flash_attention.launches_tc`` and
    ``flash_attention.launches_ffma`` those of each variant.
    """
    if not use_kernel(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   chunk_attn=chunk_attn)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    check_attention_inputs(q=q, k=k, v=v)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] or \
            q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit "
                         "(B, Sq, H, hd), (B, Skv, Kv, hd) with Kv | H")
    if q.numel() == 0:
        return torch.empty_like(q)
    variant = kernel.route(q.dtype, q.shape[3])
    out = kernel.launch(q, k, v, variant, causal=causal, window=window,
                        chunk_attn=chunk_attn)
    flash_attention.launches += 1
    if variant == "tc":
        flash_attention.launches_tc += 1
    else:
        flash_attention.launches_ffma += 1
    return out


flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_attention.launches_ffma = 0
