"""Plain torch version of prefill (flash) attention.

Mirrors the JAX package's ``attention_ref``
(``src/repro/kernels/flash_attention/ref.py:10``): fp32 scores, masks and
softmax, GQA by repeating each KV head over its ``H // Kv`` query heads.
The CPU tests use it, and on the card it is what the kernel is held
against.  One contract differs from ``attention_ref`` and follows the
kernel: a query row that sees no key at all comes out as 0, where
``attention_ref`` would average v.  The causal path never has such a row.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.common import NEG_INF


def visible(Sq: int, Skv: int, *, causal: bool, window: int, chunk_attn: int,
            device) -> torch.Tensor:
    """(Sq, Skv) bool: may query position t see key position u (both counted
    from 0)."""
    qp = torch.arange(Sq, device=device)[:, None]
    kp = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= qp - kp < window
    if chunk_attn:
        mask &= (qp // chunk_attn) == (kp // chunk_attn)
    return mask


def visible_pairs(Sq: int, Skv: int, *, causal: bool, window: int,
                  chunk_attn: int) -> int:
    """The number of (query, key) pairs that ``visible`` allows, counted row
    by row in closed form (no (Sq, Skv) mask is built): the work a kernel
    that skips masked keys must do, 4 hd FLOPs per pair."""
    total = 0
    for t in range(Sq):
        lo, hi = 0, (min(t, Skv - 1) if causal else Skv - 1)
        if window:
            lo = max(lo, t - window + 1)
        if chunk_attn:
            lo = max(lo, t // chunk_attn * chunk_attn)
            hi = min(hi, (t // chunk_attn + 1) * chunk_attn - 1)
        total += max(0, hi - lo + 1)
    return total


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        chunk_attn: int = 0) -> torch.Tensor:
    """q (B, Sq, H, hd), k and v (B, Skv, Kv, hd) -> (B, Sq, H, hd) in q's
    dtype."""
    B, Sq, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(H // Kv, dim=2)
    vf = v.float().repeat_interleave(H // Kv, dim=2)
    s = torch.einsum("bthd,buhd->bhtu", q.float(), kf) / math.sqrt(hd)
    mask = visible(Sq, Skv, causal=causal, window=window,
                   chunk_attn=chunk_attn, device=q.device)
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    p = p * mask.any(dim=-1, keepdim=True)  # a row that sees nothing -> 0
    return torch.einsum("bhtu,buhd->bthd", p, vf).to(q.dtype)
