"""Core neural-net layers of the dense model substrate, in PyTorch.

The JAX package's ``models/layers.py`` function for function, on tensors in
its layout: ``init_*`` builds a parameter tree (plain dicts of tensors),
the other functions consume it.  Matmul-heavy ops compute in the config
dtype (bf16 at full width) with fp32 normalisation, rotary and softmax
numerics.  Randomness comes from an explicit ``torch.Generator``; with
``gen=None`` an init only allocates (the ``meta`` device of
``lm.count_params``).

``flash_attention_xla`` and ``decode_attention_xla`` keep their names and
semantics (``layers.py:242`` and ``:277`` in the JAX package), but call the
port's attention ops: on the card they launch the hand-written kernels of
``csrc/``, on the CPU the plain versions.  ``flash_attention_xla`` carries
gradients: its backward is the flash backward kernel, as the JAX function's
custom VJP (``layers.py:123-239``).  ``chunked_cross_entropy`` is the JAX
package's memory-lean LM loss (``layers.py:365``).
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import api
from repro_torch.distributed.api import constrain
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention

Params = dict[str, Any]

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen, in_dim: int, out_shape: tuple[int, ...], dtype,
               device) -> torch.Tensor:
    """Truncated-normal fan-in init (matches common LM inits)."""
    w = torch.empty((in_dim, *out_shape), dtype=torch.float32, device=device)
    if gen is not None:
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(1.0 / math.sqrt(in_dim)).to(dtype)


def embed_init(gen, vocab: int, dim: int, dtype, device) -> torch.Tensor:
    w = torch.empty((vocab, dim), dtype=torch.float32, device=device)
    if gen is not None:
        w.normal_(0.0, 0.02, generator=gen)
    return w.to(dtype)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def init_rmsnorm(dim: int, dtype, device) -> torch.Tensor:
    return torch.zeros((dim,), dtype=dtype, device=device)  # gain is (1 + w)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (hd/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  Rotates
    the two halves of each head (not interleaved pairs), in fp32."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions.float()[..., None] * freqs  # (..., S, hd/2)
    sin = torch.sin(angles)[..., None, :]  # (..., S, 1, hd/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA)
# ---------------------------------------------------------------------------

def init_attention(gen, cfg, device) -> Params:
    d, hd, dt = cfg.d_model, cfg.head_dim, cfg.activation_dtype
    p = {
        "wq": dense_init(gen, d, (cfg.num_heads, hd), dt, device),
        "wk": dense_init(gen, d, (cfg.num_kv_heads, hd), dt, device),
        "wv": dense_init(gen, d, (cfg.num_kv_heads, hd), dt, device),
        "wo": dense_init(gen, cfg.num_heads * hd, (d,), dt,
                         device).reshape(cfg.num_heads, hd, d),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dt, device)
        p["k_norm"] = init_rmsnorm(hd, dt, device)
    return p


def attention_qkv(params: Params, x: torch.Tensor, positions: torch.Tensor,
                  cfg) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = constrain(q, "act_bshd")
    k = constrain(k, "act_bskd")
    return q, k, v


def flash_attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        chunk_attn: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """Prefill attention (GQA aware) through the port's ``flash_attention``.

    q: (B, Sq, H, hd); k, v: (B, Skv, Kv, hd).  Returns (B, Sq, H, hd).
    The JAX function keeps its P.V accumulator in v's dtype; the kernel,
    like the Pallas kernel, keeps it in fp32.  Differentiable: the GQA sum
    of dK and dV over each group happens in the backward kernel.

    On DTensors the op runs on each rank's shard (``api.local_attention``)
    with q, k and v on the placements of the ``attn_bhsd`` rule, the JAX
    function's constraints (``layers.py:143-145``); the kernel's backward
    runs on the same shards, so dq, dk, dv and dout keep those placements
    (``layers.py:198-201, 233-235``).
    """
    del softcap  # reserved (no assigned arch softcaps attention scores)
    if api.is_dtensor(q, k, v):
        return api.local_attention(flash_attention, q, k, v, causal=causal,
                                   window=window, chunk_attn=chunk_attn)
    return flash_attention(q, k, v, causal=causal, window=window,
                           chunk_attn=chunk_attn)


def decode_attention_xla(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len, *,
                         ring: bool = False,
                         chunk_attn: int = 0) -> torch.Tensor:
    """Single-token attention against a (possibly ring-buffered) KV cache,
    through the port's ``decode_attention``.

    q (B, 1, H, hd), caches (B, W, Kv, hd); ``cache_len`` counts the tokens
    processed including this one.  Ring semantics: slot j holds position
    ``qpos - ((qpos - j) mod W)``.  On DTensors it runs on each rank's
    shard (``api.local_decode``).
    """
    if api.is_dtensor(q, k_cache, v_cache):
        return api.local_decode(decode_attention, q, k_cache, v_cache,
                                cache_len, ring=ring, chunk_attn=chunk_attn)
    return decode_attention(q, k_cache, v_cache, cache_len, ring=ring,
                            chunk_attn=chunk_attn)


def attention_out(params: Params, attn: torch.Tensor) -> torch.Tensor:
    out = torch.einsum("bshk,hkd->bsd", attn, params["wo"])
    return constrain(out, "act_btd")


# ---------------------------------------------------------------------------
# GLU feed-forward
# ---------------------------------------------------------------------------

_ACTS = {
    "swiglu": F.silu,
    "geglu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def init_mlp(gen, d_model: int, d_ff: int, activation: str, dtype,
             device) -> Params:
    p = {
        "w_up": dense_init(gen, d_model, (d_ff,), dtype, device),
        "w_down": dense_init(gen, d_ff, (d_model,), dtype, device),
    }
    if activation in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, d_model, (d_ff,), dtype, device)
    return p


def mlp_apply(params: Params, x: torch.Tensor, activation: str) -> torch.Tensor:
    act = _ACTS[activation]
    up = x @ params["w_up"]
    h = act(x @ params["w_gate"]) * up if "w_gate" in params else act(up)
    h = constrain(h, "act_btf")
    return constrain(h @ params["w_down"], "act_btd")


# ---------------------------------------------------------------------------
# logits
# ---------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def _ce_chunk(xc: torch.Tensor, head: torch.Tensor, lc: torch.Tensor,
              w: torch.Tensor, logit_cap: float, valid_vocab: int):
    """Sums of nll * w, lse^2 * w and w over one chunk of positions."""
    logits = softcap((xc @ head).float(), logit_cap)
    vocab_iota = torch.arange(logits.shape[-1], device=logits.device)
    if valid_vocab and valid_vocab < logits.shape[-1]:
        logits = logits.masked_fill(vocab_iota >= valid_vocab, -1e30)
    logits = constrain(logits, "act_btv")
    lse = torch.logsumexp(logits, dim=-1)
    # the gold logit as the JAX package takes it: a masked max over the vocab
    gold = torch.where(vocab_iota == lc[..., None], logits, -1e30).amax(-1)
    return ((lse - gold) * w).sum(), (torch.square(lse) * w).sum(), w.sum()


def chunked_cross_entropy(x: torch.Tensor, head: torch.Tensor,
                          labels: torch.Tensor,
                          mask: torch.Tensor | None = None, *,
                          chunk: int = 512, logit_cap: float = 0.0,
                          z_loss: float = 1e-4,
                          valid_vocab: int = 0) -> tuple[torch.Tensor,
                                                         torch.Tensor]:
    """Memory-lean LM loss: the logits of one S-chunk at a time.

    x (B, S, D) final hidden states, head (D, V), labels (B, S) int, mask
    (B, S) or None.  Returns (mean_nll, mean_z_loss_term), both fp32 0-d.
    Each chunk runs under ``torch.utils.checkpoint``, as the JAX function
    ``jax.checkpoint``s its scan body, so the backward recomputes one
    (B, chunk, V) fp32 logits block at a time instead of keeping all of
    them.  ``valid_vocab``: columns at or past it (vocab padding) are
    excluded from the softmax (-1e30).  The weight sum is floored at 1.
    """
    B, S, _ = x.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"chunked_cross_entropy: S {S} is not a multiple of "
                         f"the chunk {chunk}")
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    tot_nll, tot_z, tot_w = zero, zero, zero
    for c0 in range(0, S, chunk):
        lc = labels[:, c0:c0 + chunk]
        w = torch.ones(lc.shape, dtype=torch.float32, device=x.device) \
            if mask is None else mask[:, c0:c0 + chunk].float()
        nll, zl, ws = checkpoint(_ce_chunk, x[:, c0:c0 + chunk], head, lc, w,
                                 logit_cap, valid_vocab, use_reentrant=False,
                                 context_fn=api.checkpoint_context)
        tot_nll, tot_z, tot_w = tot_nll + nll, tot_z + zl, tot_w + ws
    wsum = torch.clamp_min(tot_w, 1.0)
    return tot_nll / wsum, z_loss * tot_z / wsum


# ---------------------------------------------------------------------------
# KV cache helpers
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, capacity: int, n_kv: int, head_dim: int, dtype,
                  device) -> Params:
    shape = (batch, capacity, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def kv_cache_update(cache: Params, k_new: torch.Tensor, v_new: torch.Tensor,
                    pos) -> Params:
    """Write k/v (B, T, Kv, hd) at slot ``pos`` (an int, or a 0-d tensor on
    the cache's device) IN PLACE and return the same cache; the JAX
    function returns a new one.  A tensor ``pos`` keeps a decode loop free
    of host syncs."""
    idx = torch.arange(k_new.shape[1], device=cache["k"].device) + pos
    if api.is_dtensor(cache["k"]):  # each rank writes its shard
        api.local_index_copy(cache["k"], 1, idx, k_new)
        api.local_index_copy(cache["v"], 1, idx, v_new)
        return cache
    cache["k"].index_copy_(1, idx, k_new.to(cache["k"].dtype))
    cache["v"].index_copy_(1, idx, v_new.to(cache["v"].dtype))
    return cache
