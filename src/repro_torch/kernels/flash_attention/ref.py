"""Plain torch version of prefill (flash) attention, forward and backward.

``flash_attention_ref`` mirrors the JAX package's ``attention_ref``
(``src/repro/kernels/flash_attention/ref.py:10``): fp32 scores, masks and
softmax, GQA by repeating each KV head over its ``H // Kv`` query heads.
The CPU tests use it, and on the card it is what the kernel is held
against.  One contract differs from ``attention_ref`` and follows the
kernel: a query row that sees no key at all comes out as 0, where
``attention_ref`` would average v.  The causal path never has such a row.

``flash_attention_lse_ref`` and ``flash_attention_bwd_ref`` are the plain
versions of the training pair: the forward that also returns lse, and the
backward of the JAX package's custom VJP (``_flash_mha_bwd``,
``src/repro/models/layers.py:189``).  Both run in fp32 over chunks of query
rows, as the JAX functions loop over chunks, so that no (B, H, Sq, Skv)
score matrix is held at long sequences; the autograd Function of
``ops.py`` runs them on the CPU.
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


Q_CHUNK = 512  # query rows per chunk of the training pair's plain versions


def _chunk_scores(qc, kf, t0, Skv, causal, window, chunk_attn):
    """Scaled fp32 scores (B, H, c, Skv) of the query rows t0 .. t0 + c - 1
    and their (c, Skv) visibility."""
    B, c, H, hd = qc.shape
    s = torch.einsum("bthd,buhd->bhtu", qc.float(), kf) / math.sqrt(hd)
    mask = visible(t0 + c, Skv, causal=causal, window=window,
                   chunk_attn=chunk_attn, device=qc.device)[t0:]
    return s, mask


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0, chunk_attn: int = 0):
    """(out, lse): ``flash_attention_ref``'s output and lse (B, H, Sq) in
    fp32, the natural log of the sum of exp(scaled score) over the keys a row
    sees (the JAX package's m + log(max(l, 1e-30)), ``layers.py:173-175``);
    -1e30 (``NEG_INF``) for a row that sees no key."""
    B, Sq, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(H // Kv, dim=2)
    vf = v.float().repeat_interleave(H // Kv, dim=2)
    outs, lses = [], []
    for t0 in range(0, Sq, Q_CHUNK):
        s, mask = _chunk_scores(q[:, t0:t0 + Q_CHUNK], kf, t0, Skv, causal,
                                window, chunk_attn)
        s = s.masked_fill(~mask, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m) * mask
        l = p.sum(dim=-1, keepdim=True)
        outs.append(torch.einsum("bhtu,buhd->bthd",
                                 p / torch.clamp_min(l, 1e-30), vf))
        lses.append(torch.where(l > 0, m + torch.log(torch.clamp_min(
            l, 1e-30)), NEG_INF)[..., 0])
    return (torch.cat(outs, dim=1).to(q.dtype),
            torch.cat(lses, dim=2).contiguous())


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            chunk_attn: int = 0, magnitudes: bool = False):
    """(dq, dk, dv) in the inputs' dtype: ``_flash_mha_bwd`` in fp32.

    delta = rowsum(dout * out); P = exp(S scale - lse) on visible pairs and
    exactly 0 elsewhere; dV = P^T dO, dP = dO V^T, dS = P (dP - delta) scale,
    dK = dS^T Q, dQ = dS K; the GQA group of each KV head summed.  With
    ``magnitudes`` it returns, in fp32, the same products taken over
    magnitudes: P^T |dO| for dV, and with |dS| widened to P scale (|dP| +
    |delta|) (the size of dS before its difference cancels), |dS|^T |Q| for
    dK and |dS| |K| for dQ.  A bound on rounding inside the products is a
    multiple of these (chip_smoke.py's bf16 check)."""
    B, Sq, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    G, scale = H // Kv, 1.0 / math.sqrt(hd)
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    kd = kf.abs() if magnitudes else kf  # the dQ product's K
    delta = torch.einsum("bthd,bthd->bht", dout.float(), out.float())
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(vf.shape, dtype=torch.float32, device=q.device)
    for t0 in range(0, Sq, Q_CHUNK):
        qc = q[:, t0:t0 + Q_CHUNK].float()
        doc = dout[:, t0:t0 + Q_CHUNK].float()
        s, mask = _chunk_scores(qc, kf, t0, Skv, causal, window, chunk_attn)
        lse_c = lse[:, :, t0:t0 + Q_CHUNK, None]
        p = torch.where(mask, torch.exp(s - lse_c), 0.0)
        delta_c = delta[:, :, t0:t0 + Q_CHUNK, None]
        if magnitudes:
            qc, doc = qc.abs(), doc.abs()
            dp = torch.einsum("bthd,buhd->bhtu", doc, vf.abs())
            ds = p * (dp + delta_c.abs()) * scale
        else:
            dp = torch.einsum("bthd,buhd->bhtu", doc, vf)
            ds = p * (dp - delta_c) * scale
        dv += torch.einsum("bhtu,bthd->buhd", p, doc)
        dk += torch.einsum("bhtu,bthd->buhd", ds, qc)
        dq[:, t0:t0 + Q_CHUNK] = torch.einsum("bhtu,buhd->bthd", ds, kd)
    dk = dk.reshape(B, Skv, Kv, G, hd).sum(dim=3)
    dv = dv.reshape(B, Skv, Kv, G, hd).sum(dim=3)
    if magnitudes:
        return dq, dk, dv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
