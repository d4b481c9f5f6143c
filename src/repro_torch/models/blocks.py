"""Transformer blocks of the dense model substrate, in PyTorch.

The JAX package's ``models/blocks.py`` for the attention block with a dense
MLP:
    init_attn_block(gen, cfg, device) -> params
    apply_attn_block(params, x, ctx, cfg, cache) -> (y, cache, aux)

where ``ctx`` is a `BlockCtx` describing the execution mode:
  * train/prefill: full sequence, positions [0..S)
  * decode: single-token step against a fixed-capacity cache

KV caches are updated in place; the JAX blocks return new ones.  The MoE
FFN, the recurrent (RG-LRU), mLSTM and sLSTM blocks, cross-attention and the
bidirectional encoder block are not ported yet: each raises
``NotImplementedError`` naming its ROADMAP.md item.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = dict[str, Any]

_ROADMAP = {
    "moe": "the MoE FFN with the moe_gmm kernel (ROADMAP.md queue 1, item 10a)",
    "rglru": "the RG-LRU recurrent block with the rglru_scan kernel "
             "(ROADMAP.md queue 1, item 10b)",
    "mlstm": "the xLSTM mLSTM block (ROADMAP.md queue 1, item 10c)",
    "slstm": "the xLSTM sLSTM block (ROADMAP.md queue 1, item 10c)",
    "encdec": "cross-attention and the encoder stack (ROADMAP.md queue 1, "
              "item 10d)",
    "vlm": "the vision frontend (ROADMAP.md queue 1, item 10e)",
}


def unported(what: str):
    raise NotImplementedError(f"{_ROADMAP[what]} is not ported yet")


@dataclass(frozen=True)
class BlockCtx:
    mode: str  # "train" | "prefill" | "decode"
    positions: torch.Tensor  # (B, S) absolute positions of the current tokens
    cache_len: Any = None  # int or 0-d tensor: valid cache entries *after* this step
    capacity: int = 0  # static cache capacity (decode mode)

    @property
    def decoding(self) -> bool:
        return self.mode == "decode"


# ===========================================================================
# Attention block (dense FFN)
# ===========================================================================

def init_attn_block(gen, cfg: ModelConfig, device,
                    cross: bool = False) -> Params:
    if cross:
        unported("encdec")
    if cfg.num_experts:
        unported("moe")
    dt = cfg.activation_dtype
    p: Params = {
        "ln1": L.init_rmsnorm(cfg.d_model, dt, device),
        "ln2": L.init_rmsnorm(cfg.d_model, dt, device),
        "attn": L.init_attention(gen, cfg, device),
    }
    if cfg.d_ff:
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation, dt,
                              device)
    return p


def attn_cache_capacity(cfg: ModelConfig, capacity: int) -> int:
    """Local/chunked attention only ever needs a window-sized ring buffer."""
    if cfg.attention_type in ("local", "chunked") and cfg.window_size:
        return min(capacity, cfg.window_size)
    return capacity


def init_attn_cache(cfg: ModelConfig, batch: int, capacity: int,
                    device) -> Params:
    cap = attn_cache_capacity(cfg, capacity)
    return L.init_kv_cache(batch, cap, cfg.num_kv_heads, cfg.head_dim,
                           cfg.activation_dtype, device)


def _self_attention(params: Params, x: torch.Tensor, ctx: BlockCtx,
                    cfg: ModelConfig, cache: Optional[Params]):
    """Returns (output, cache).  Decode writes this token's k/v into
    ``cache`` in place.  Prefill fills ``cache`` in place when one is given
    (``lm.apply_stack`` hands each layer its slice of the stack's cache),
    else a new one of capacity ``ctx.capacity``."""
    q, k, v = L.attention_qkv(params, x, ctx.positions, cfg)
    window = cfg.window_size if cfg.attention_type == "local" else 0
    chunk_attn = cfg.window_size if cfg.attention_type == "chunked" else 0
    ring = cfg.attention_type in ("local", "chunked") and bool(cfg.window_size)
    new_cache = None
    if ctx.decoding:
        if cache is None:
            raise ValueError("decode needs a KV cache")
        W = cache["k"].shape[1]
        write_pos = (ctx.cache_len - 1) % W if ring else ctx.cache_len - 1
        new_cache = L.kv_cache_update(cache, k, v, write_pos)
        out = L.decode_attention_xla(q, cache["k"], cache["v"], ctx.cache_len,
                                     ring=ring, chunk_attn=chunk_attn)
    else:
        out = L.flash_attention_xla(q, k, v, causal=True, window=window,
                                    chunk_attn=chunk_attn,
                                    softcap=cfg.logit_softcap)
        if ctx.mode == "prefill":
            S = x.shape[1]
            new_cache = cache if cache is not None else init_attn_cache(
                cfg, x.shape[0], ctx.capacity or S, x.device)
            cap = new_cache["k"].shape[1]
            if cap < S:
                # ring buffer: last `cap` positions land at slots pos % cap
                slots = torch.arange(S - cap, S, device=x.device) % cap
                new_cache["k"][:, slots] = k[:, -cap:].to(new_cache["k"].dtype)
                new_cache["v"][:, slots] = v[:, -cap:].to(new_cache["v"].dtype)
            else:
                L.kv_cache_update(new_cache, k, v, 0)
    return L.attention_out(params, out), new_cache


def apply_attn_block(params: Params, x: torch.Tensor, ctx: BlockCtx,
                     cfg: ModelConfig, cache: Optional[Params] = None,
                     encoder_out: Optional[torch.Tensor] = None):
    if encoder_out is not None or "xattn" in params:
        unported("encdec")
    h, new_cache = _self_attention(params["attn"],
                                   L.rms_norm(x, params["ln1"], cfg.norm_eps),
                                   ctx, cfg, cache)
    x = x + h
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    y = L.rms_norm(x, params["ln2"], cfg.norm_eps)
    if "moe" in params:
        unported("moe")
    h = L.mlp_apply(params["mlp"], y, cfg.activation) if "mlp" in params \
        else torch.zeros_like(x)
    return x + h, new_cache, aux


def init_block(block_type: str, gen, cfg: ModelConfig, device) -> Params:
    if block_type != "attn":
        unported(block_type)
    return init_attn_block(gen, cfg, device)


def init_block_cache(block_type: str, cfg: ModelConfig, batch: int,
                     capacity: int, device):
    if block_type != "attn":
        unported(block_type)
    return init_attn_cache(cfg, batch, capacity, device)
