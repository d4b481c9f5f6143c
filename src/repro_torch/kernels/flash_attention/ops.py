"""Public wrapper for prefill (flash) attention.

Dispatch (``kernels/common.py``): CPU tensors take the plain version in
``ref.py``; CUDA tensors launch the Hopper kernel (``kernel.py``) or raise.
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
    dtype; a row that sees no key is 0.  The kernel takes fp32 or bf16 and
    head_dim a multiple of 16 up to 256.  ``flash_attention.launches``
    counts kernel launches.
    """
    if not use_kernel(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   chunk_attn=chunk_attn)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    code = check_attention_inputs(q=q, k=k, v=v)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] or \
            q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit "
                         "(B, Sq, H, hd), (B, Skv, Kv, hd) with Kv | H")
    if q.numel() == 0:
        return torch.empty_like(q)
    out = kernel.launch(q, k, v, code, causal=causal, window=window,
                        chunk_attn=chunk_attn)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
