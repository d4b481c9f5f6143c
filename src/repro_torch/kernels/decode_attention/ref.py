"""Plain torch version of decode attention.

Mirrors the JAX package's ``decode_attention_ref``
(``src/repro/kernels/decode_attention/ref.py:10``): one new token per
sequence, queries grouped per KV head, fp32 scores and softmax, with the
weights rounded to v's dtype before the P.V product as the TPU kernel and
``layers.decode_attention_xla`` do (``p.astype(v.dtype)``; a no-op in fp32).
The CPU tests use it, and on the card it is what the kernel is held against.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.common import NEG_INF


def slot_visible(W: int, cache_len, *, ring: bool, chunk_attn: int,
                 device) -> torch.Tensor:
    """(W,) bool: may the token at position ``cache_len - 1`` see slot j.

    A dense cache holds position j at slot j.  A ring of width W holds at
    slot j the latest position p with p % W == j, that is
    ``qpos - ((qpos - j) mod W)``; the slot is visible when that is >= 0 and,
    for chunked attention, in the query's chunk.
    """
    slots = torch.arange(W, device=device)
    qpos = cache_len - 1
    if not ring:
        return slots < cache_len
    abs_pos = qpos - torch.remainder(qpos - slots, W)
    valid = abs_pos >= 0
    if chunk_attn:
        valid &= abs_pos >= (qpos // chunk_attn) * chunk_attn
    return valid


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len, *,
                         ring: bool = False,
                         chunk_attn: int = 0) -> torch.Tensor:
    """q (B, 1, H, hd), caches (B, W, Kv, hd), ``cache_len`` the tokens
    processed including this one (int or 0-d tensor) -> (B, 1, H, hd) in
    q's dtype."""
    B, _, H, hd = q.shape
    W, Kv = k_cache.shape[1], k_cache.shape[2]
    qr = q.reshape(B, Kv, H // Kv, hd).float()
    s = torch.einsum("bkgh,bukh->bkgu", qr, k_cache.float()) * (1.0 / math.sqrt(hd))
    valid = slot_visible(W, cache_len, ring=ring, chunk_attn=chunk_attn,
                         device=q.device)
    p = torch.softmax(s.masked_fill(~valid, NEG_INF), dim=-1)
    p = p.to(v_cache.dtype).float()
    o = torch.einsum("bkgu,bukh->bkgh", p, v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)
