"""Public wrapper for decode attention.

Dispatch (``kernels/common.py``): CPU tensors take the plain version in
``ref.py``; CUDA tensors launch a Hopper kernel (``kernel.py``) or raise.
Which kernel is one rule on dtype and shape (``kernel.route``).  Nothing is
caught: a failed build or launch raises.  Fake tensors take the kernel's
shape route (``kernels/common.py``): the same checks and route, outputs of
the kernel's shapes, its work reported, no launch and no count.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import (NEG_INF, SHAPE,
                                        check_attention_inputs,
                                        refuse_grad, use_kernel)
from repro_torch.kernels.decode_attention import kernel
from repro_torch.kernels.decode_attention.ref import decode_attention_lse_ref
from repro_torch.perf import spans


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *, ring: bool = False,
                     chunk_attn: int = 0, slot0: int = 0,
                     slots: int | None = None, return_lse: bool = False):
    """One new token per sequence against its KV cache.

    Shapes: q (B, 1, H, hd), caches (B, W, Kv, hd) with H a multiple of Kv;
    query head h reads KV head ``h // (H // Kv)``.  ``cache_len`` counts the
    tokens processed including this one: a Python int, or an int32 tensor
    on the cache's device, which the kernel reads there (no host sync).  A
    dense cache admits slots < cache_len; a ring (``ring=True``) the slots
    whose absolute position is >= 0 and, with ``chunk_attn``, in the query's
    chunk.  Returns (B, 1, H, hd) in q's dtype.  The kernels take fp32 or
    bf16 and head_dim a multiple of 16 up to 256; bf16 with H / Kv <= 16
    runs on the tensor cores, the rest on the FFMA kernel
    (``kernel.route``).  ``decode_attention.launches`` counts kernel calls,
    ``decode_attention.launches_tc`` and ``decode_attention.launches_ffma``
    those of each variant.

    A slice of a cache sharded along its slots: the caches hold global slots
    ``slot0 .. slot0 + W - 1`` of a cache of ``slots`` (default W) slots,
    and the mask reads global slot numbers.  ``return_lse`` (needed for a
    slice) also returns lse (B, H) fp32, the log-sum-exp of the visible
    scaled scores (``NEG_INF`` with out 0 where no slot is visible), through
    the kernels' lse twin, counted in ``decode_attention.launches_lse``
    (``launches_lse_tc`` / ``launches_lse_ffma`` by variant), not in the
    served counters: no one-card path launches it.
    """
    if spans.on:
        spans.begin("decode_attention")
    try:
        W = k_cache.shape[1]
        slots = W if slots is None else slots
        if not return_lse and (slot0, slots) != (0, W):
            raise ValueError("decode_attention: a slice of a cache (slot0, "
                             "slots) needs return_lse")
        dispatch = use_kernel(q, k_cache, v_cache)
        if not dispatch:
            out, lse = decode_attention_lse_ref(
                q, k_cache, v_cache, cache_len, ring=ring,
                chunk_attn=chunk_attn, slot0=slot0, slots=slots)
            return (out, lse) if return_lse else out
        if dispatch != SHAPE:
            refuse_grad("decode_attention", q, k_cache, v_cache)
        q, k_cache, v_cache = (t.contiguous()
                               for t in (q, k_cache, v_cache))
        code = check_attention_inputs(q=q, k_cache=k_cache, v_cache=v_cache)
        if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4 or \
                v_cache.shape != k_cache.shape or \
                k_cache.shape[0] != q.shape[0] or \
                k_cache.shape[3] != q.shape[3] or \
                q.shape[2] % k_cache.shape[2]:
            raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches "
                             f"{tuple(k_cache.shape)}, "
                             f"{tuple(v_cache.shape)} do not fit "
                             "(B, 1, H, hd), (B, W, Kv, hd) with Kv | H")
        if isinstance(cache_len, torch.Tensor):
            if cache_len.device != q.device or cache_len.numel() != 1:
                raise ValueError("decode_attention: cache_len must be one "
                                 f"value on {q.device}, got "
                                 f"{cache_len.numel()} on {cache_len.device}")
            cache_len = cache_len.reshape(1).to(torch.int32)
        else:
            cache_len = torch.full((1,), int(cache_len), dtype=torch.int32,
                                   device=q.device)
        if q.numel() == 0 or W == 0:
            out = torch.zeros_like(q)
            lse = torch.full(q.shape[:1] + q.shape[2:3], NEG_INF,
                             dtype=torch.float32, device=q.device)
            return (out, lse) if return_lse else out
        variant = kernel.route(q.dtype, q.shape[2] // k_cache.shape[2],
                               q.shape[3])
        res = kernel.launch(q, k_cache, v_cache, cache_len, code, variant,
                            ring=ring, chunk_attn=chunk_attn, slot0=slot0,
                            slots=slots, with_lse=return_lse,
                            shape_only=dispatch == SHAPE)
        if dispatch == SHAPE:
            return res
        prefix = "launches_lse" if return_lse else "launches"
        for name in (prefix, f"{prefix}_{variant}"):
            setattr(decode_attention, name,
                    getattr(decode_attention, name) + 1)
        return res
    finally:
        if spans.on:
            spans.end()


decode_attention.launches = 0
decode_attention.launches_tc = 0
decode_attention.launches_ffma = 0
decode_attention.launches_lse = 0
decode_attention.launches_lse_tc = 0
decode_attention.launches_lse_ffma = 0
