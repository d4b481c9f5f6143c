"""Plain torch version of decode attention.

Mirrors the JAX package's ``decode_attention_ref``
(``src/repro/kernels/decode_attention/ref.py:10``): one new token per
sequence, queries grouped per KV head, fp32 scores and softmax, with the
weights rounded to v's dtype before the P.V product as the TPU kernel and
``layers.decode_attention_xla`` do (``p.astype(v.dtype)``; a no-op in fp32).
The CPU tests use it, and on the card it is what the kernel is held against.

A cache may be one slice of a cache sharded along its slots (the sharding
policy's sequence fallback, ``distributed/api.py: local_decode``): the
local slots are the global slots ``slot0 .. slot0 + W - 1`` of a cache of
``slots`` slots, and the visibility rule reads global slot numbers.  The
lse twin (``decode_attention_lse_ref``) also returns the log-sum-exp of
the visible scaled scores, from which the slices' outputs merge exactly.
A slice that sees no slot gives 0 and lse ``NEG_INF``, as the kernels do.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.common import NEG_INF


def slot_visible(W: int, cache_len, *, ring: bool, chunk_attn: int,
                 device, slot0: int = 0, slots: int | None = None
                 ) -> torch.Tensor:
    """(W,) bool: may the token at position ``cache_len - 1`` see local slot
    j, the global slot ``slot0 + j`` of a cache of ``slots`` slots (default
    W: the whole cache).

    A dense cache holds position g at slot g.  A ring of width ``slots``
    holds at slot g the latest position p with p % slots == g, that is
    ``qpos - ((qpos - g) mod slots)``; the slot is visible when that is
    >= 0 and, for chunked attention, in the query's chunk.
    """
    width = W if slots is None else slots
    g = torch.arange(W, device=device) + slot0
    qpos = cache_len - 1
    if not ring:
        return g < cache_len
    abs_pos = qpos - torch.remainder(qpos - g, width)
    valid = abs_pos >= 0
    if chunk_attn:
        valid &= abs_pos >= (qpos // chunk_attn) * chunk_attn
    return valid


def decode_attention_lse_ref(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, cache_len, *,
                             ring: bool = False, chunk_attn: int = 0,
                             slot0: int = 0, slots: int | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B, 1, H, hd), caches (B, W, Kv, hd) (global slots ``slot0 ..
    slot0 + W - 1`` of ``slots``), ``cache_len`` the tokens processed
    including this one (int or 0-d tensor) -> out (B, 1, H, hd) in q's
    dtype and lse (B, H) fp32, log sum exp of the visible scaled scores."""
    B, _, H, hd = q.shape
    W, Kv = k_cache.shape[1], k_cache.shape[2]
    qr = q.reshape(B, Kv, H // Kv, hd).float()
    s = torch.einsum("bkgh,bukh->bkgu", qr, k_cache.float()) * (1.0 / math.sqrt(hd))
    valid = slot_visible(W, cache_len, ring=ring, chunk_attn=chunk_attn,
                         device=q.device, slot0=slot0, slots=slots)
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = p.to(v_cache.dtype).float()
    o = torch.einsum("bkgu,bukh->bkgh", p, v_cache.float())
    seen = valid.any()
    o = torch.where(seen, o, torch.zeros_like(o))
    lse = torch.where(seen, torch.logsumexp(s, dim=-1),
                      torch.full_like(s[..., 0], NEG_INF))
    return o.reshape(B, 1, H, hd).to(q.dtype), lse.reshape(B, H)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len, *,
                         ring: bool = False, chunk_attn: int = 0,
                         slot0: int = 0, slots: int | None = None
                         ) -> torch.Tensor:
    """The output of ``decode_attention_lse_ref``: (B, 1, H, hd) in q's
    dtype."""
    return decode_attention_lse_ref(q, k_cache, v_cache, cache_len,
                                    ring=ring, chunk_attn=chunk_attn,
                                    slot0=slot0, slots=slots)[0]
