"""Transformer, MoE and recurrent blocks of the model substrate, in PyTorch.

The JAX package's ``models/blocks.py``: the attention block (dense MLP or
MoE FFN, with cross-attention in an encoder-decoder), the bidirectional
encoder block, and the RG-LRU, mLSTM and sLSTM recurrent blocks:
    init_<type>_block(gen, cfg, device) -> params
    apply_<type>_block(params, x, ctx, cfg, cache) -> (y, cache, aux)

where ``ctx`` is a `BlockCtx` describing the execution mode:
  * train/prefill: full sequence, positions [0..S)
  * decode: single-token step against a fixed-capacity cache

Caches (KV and recurrent state) are updated in place; the JAX blocks return
new ones.  The MoE expert FFN runs its three products through the
``moe_gmm`` op and the RG-LRU prefill its recurrence through the
``rglru_scan`` op, where the JAX package runs einsums and an associative
scan.  The mLSTM and sLSTM blocks have no kernel in the JAX package either:
they stay torch ops, and the sLSTM prefill is a Python loop over the
sequence where the JAX package runs ``lax.scan``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import api
from repro_torch.distributed.api import constrain
from repro_torch.kernels.moe_gmm.ops import moe_gmm
from repro_torch.kernels.rglru_scan.ops import rglru_scan_op
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.perf import spans

Params = dict[str, Any]

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
# Attention block (dense FFN or MoE FFN)
# ===========================================================================

def init_attn_block(gen, cfg: ModelConfig, device,
                    cross: bool = False) -> Params:
    dt = cfg.activation_dtype
    p: Params = {
        "ln1": L.init_rmsnorm(cfg.d_model, dt, device),
        "ln2": L.init_rmsnorm(cfg.d_model, dt, device),
        "attn": L.init_attention(gen, cfg, device),
    }
    if cross:
        p["ln_x"] = L.init_rmsnorm(cfg.d_model, dt, device)
        p["xattn"] = L.init_attention(gen, cfg, device)
    if cfg.num_experts:
        p["moe"] = init_moe(gen, cfg, device)
    elif cfg.d_ff:
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
    """The block's attention half over the residual ``x``: returns (x + the
    attention output, cache).  Decode writes this token's k/v into
    ``cache`` in place.  Prefill fills ``cache`` in place when one is given
    (``lm.apply_stack`` hands each layer its slice of the stack's cache),
    else a new one of capacity ``ctx.capacity``."""
    if spans.on:
        spans.begin("attn_in")
    p = params["attn"]
    q, k, v = L.attention_qkv(p, L.rms_norm(x, params["ln1"], cfg.norm_eps),
                              ctx.positions, cfg)
    if spans.on:
        spans.end()
    window = cfg.window_size if cfg.attention_type == "local" else 0
    chunk_attn = cfg.window_size if cfg.attention_type == "chunked" else 0
    ring = cfg.attention_type in ("local", "chunked") and bool(cfg.window_size)
    new_cache = None
    if ctx.decoding:
        if cache is None:
            raise ValueError("decode needs a KV cache")
        if spans.on:
            spans.begin("kv_write")
        W = cache["k"].shape[1]
        write_pos = (ctx.cache_len - 1) % W if ring else ctx.cache_len - 1
        new_cache = L.kv_cache_update(cache, k, v, write_pos)
        if spans.on:
            spans.end()
            spans.begin("attention")
        out = L.decode_attention_xla(q, cache["k"], cache["v"], ctx.cache_len,
                                     ring=ring, chunk_attn=chunk_attn)
        if spans.on:
            spans.end()
    else:
        if spans.on:
            spans.begin("attention")
        out = L.flash_attention_xla(q, k, v, causal=True, window=window,
                                    chunk_attn=chunk_attn,
                                    softcap=cfg.logit_softcap)
        if spans.on:
            spans.end()
        if ctx.mode == "prefill":
            if spans.on:
                spans.begin("kv_write")
            S = x.shape[1]
            new_cache = cache if cache is not None else init_attn_cache(
                cfg, x.shape[0], ctx.capacity or S, x.device)
            cap = new_cache["k"].shape[1]
            if cap < S:
                # ring buffer: last `cap` positions land at slots pos % cap
                slots = torch.arange(S - cap, S, device=x.device) % cap
                if api.is_dtensor(new_cache["k"]):  # each rank's shard
                    api.local_index_copy(new_cache["k"], 1, slots,
                                         k[:, -cap:])
                    api.local_index_copy(new_cache["v"], 1, slots,
                                         v[:, -cap:])
                else:
                    new_cache["k"][:, slots] = k[:, -cap:].to(
                        new_cache["k"].dtype)
                    new_cache["v"][:, slots] = v[:, -cap:].to(
                        new_cache["v"].dtype)
            else:
                L.kv_cache_update(new_cache, k, v, 0)
            if spans.on:
                spans.end()
    if spans.on:
        spans.begin("attn_out")
    x = x + L.attention_out(p, out)
    if spans.on:
        spans.end()
    return x, new_cache


def apply_attn_block(params: Params, x: torch.Tensor, ctx: BlockCtx,
                     cfg: ModelConfig, cache: Optional[Params] = None,
                     encoder_out: Optional[torch.Tensor] = None):
    x, new_cache = _self_attention(params, x, ctx, cfg, cache)
    if "xattn" in params:
        if encoder_out is None:
            raise ValueError("cross-attention needs encoder_out")
        x = x + _cross_attention(params["xattn"],
                                 L.rms_norm(x, params["ln_x"], cfg.norm_eps),
                                 encoder_out, cfg)
    if spans.on:
        spans.begin("ffn")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    y = L.rms_norm(x, params["ln2"], cfg.norm_eps)
    if "moe" in params:
        h, aux = moe_apply(params["moe"], y, cfg)
    elif "mlp" in params:
        h = L.mlp_apply(params["mlp"], y, cfg.activation)
    else:
        h = torch.zeros_like(x)
    x = x + h
    if spans.on:
        spans.end()
    return x, new_cache, aux


def _cross_attention(params: Params, x: torch.Tensor, enc: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """Full (non-causal) attention from decoder states to encoder output,
    no rotary.  The K/V projections of ``enc`` are recomputed at every call
    (every decode step), as the JAX block does."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", enc, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc, params["wv"])
    out = L.flash_attention_xla(q, k, v, causal=False)
    return L.attention_out(params, out)


def init_bidir_attn_block(gen, cfg: ModelConfig, device) -> Params:
    """Encoder block: bidirectional self-attention + FFN."""
    return init_attn_block(gen, cfg, device)


def apply_bidir_attn_block(params: Params, x: torch.Tensor, ctx: BlockCtx,
                           cfg: ModelConfig):
    q, k, v = L.attention_qkv(params["attn"],
                              L.rms_norm(x, params["ln1"], cfg.norm_eps),
                              ctx.positions, cfg)
    out = L.flash_attention_xla(q, k, v, causal=False)
    x = x + L.attention_out(params["attn"], out)
    h = L.mlp_apply(params["mlp"], L.rms_norm(x, params["ln2"], cfg.norm_eps),
                    cfg.activation)
    return x + h, None, torch.zeros((), dtype=torch.float32, device=x.device)


# ===========================================================================
# Mixture-of-Experts FFN
# ===========================================================================

def moe_capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    ideal = tokens_per_group * cfg.experts_per_token / cfg.num_experts
    cap = int(math.ceil(ideal * cfg.capacity_factor / 8.0)) * 8
    return max(cap, 8)


def _normal_init(gen, shape: tuple[int, ...], scale: float, dtype,
                 device) -> torch.Tensor:
    """Standard normal draws in fp32 times ``scale``, cast to ``dtype``."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    if gen is not None:
        w.normal_(0.0, 1.0, generator=gen)
    return w.mul_(scale).to(dtype)


def init_moe(gen, cfg: ModelConfig, device) -> Params:
    dt = cfg.activation_dtype
    E, D, Fd = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    s_in, s_out = 1.0 / math.sqrt(D), 1.0 / math.sqrt(Fd)
    p: Params = {
        "router": L.dense_init(gen, D, (E,), torch.float32, device),
        "w_gate": _normal_init(gen, (E, D, Fd), s_in, dt, device),
        "w_up": _normal_init(gen, (E, D, Fd), s_in, dt, device),
        "w_down": _normal_init(gen, (E, Fd, D), s_out, dt, device),
    }
    if cfg.num_shared_experts:
        p["shared"] = L.init_mlp(gen, D, Fd * cfg.num_shared_experts,
                                 cfg.activation, dt, device)
    return p


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, an exact tie
    going to the lower index (``torch.topk`` promises no order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _normalized_top_k(probs: torch.Tensor, k: int):
    top_p, top_e = _top_k(probs, k)
    return top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9), top_e


def moe_group_compute(xg: torch.Tensor, probs: torch.Tensor,
                      w_gate: torch.Tensor, w_up: torch.Tensor,
                      w_down: torch.Tensor, *, capacity: int, top_k: int,
                      activation: str, expert_offset: int = 0) -> torch.Tensor:
    """Capacity-based token dispatch -> per-expert matmul -> weighted combine
    for one dispatch group: xg (T, D), probs (T, E) fp32 -> (T, D).

    ``w_*`` may hold only a local slice of experts starting at
    ``expert_offset``; the output then holds only those experts'
    contributions.  Tokens above an expert's capacity are dropped.
    """
    T, D = xg.shape
    E_loc = w_gate.shape[0]
    E = probs.shape[-1]
    C = capacity
    dev = xg.device
    top_p, top_e = _normalized_top_k(probs, top_k)
    flat_e, flat_p = top_e.reshape(-1), top_p.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(top_k)
    order = torch.argsort(flat_e, stable=True)  # token order kept per expert
    se, st, sp = flat_e[order], flat_t[order], flat_p[order]
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(T * top_k, device=dev) - starts[se]
    local_e = se - expert_offset
    valid = (slot < C) & (local_e >= 0) & (local_e < E_loc)
    scatter_pos = torch.where(valid, local_e * C + slot, E_loc * C)
    gather_idx = torch.full((E_loc * C + 1,), T, dtype=torch.long,
                            device=dev).scatter_(0, scatter_pos, st)[:-1]
    combine_w = torch.zeros((E_loc * C + 1,), dtype=torch.float32,
                            device=dev).scatter_(0, scatter_pos, sp)[:-1]
    x_disp = torch.cat([xg, xg.new_zeros((1, D))])[gather_idx]
    x_disp = x_disp.reshape(E_loc, C, D)
    act = L._ACTS[activation]
    h = act(moe_gmm(x_disp, w_gate)) * moe_gmm(x_disp, w_up)
    h = moe_gmm(h, w_down)  # (E_loc, C, D)
    h_flat = h.reshape(E_loc * C, D) * combine_w[:, None].to(h.dtype)
    out = torch.zeros((T + 1, D), dtype=h.dtype, device=dev)
    return out.index_add_(0, gather_idx, h_flat)[:T]


def moe_dispatch_indices(probs: torch.Tensor, *, top_k: int, capacity: int):
    """Dispatch plan of each group.  probs (..., T, E) ->
      gather_idx  (..., E, C)  token id feeding each expert slot (sentinel T
                               = empty)
      combine_w   (..., E, C)  router weight of that slot
      slot_table  (..., T, k)  inverse map: slot id of each assignment
                               (sentinel E*C = dropped by capacity)
    The JAX package vmaps its one-group function over the groups; here the
    leading axes are written out.  Indices are int64."""
    lead, (T, E) = probs.shape[:-2], probs.shape[-2:]
    p = probs.reshape(-1, T, E)
    G, C, n = p.shape[0], capacity, T * top_k
    dev = probs.device
    top_p, top_e = _normalized_top_k(p, top_k)
    flat_e, flat_p = top_e.reshape(G, n), top_p.reshape(G, n)
    flat_t = torch.arange(T, device=dev).repeat_interleave(top_k).expand(G, n)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se, st, sp = (t.gather(1, order) for t in (flat_e, flat_t, flat_p))
    counts = torch.zeros((G, E), dtype=torch.long, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 1) - counts
    slot = torch.arange(n, device=dev) - starts.gather(1, se)
    scatter_pos = torch.where(slot < C, se * C + slot, E * C)
    gather_idx = torch.full((G, E * C + 1), T, dtype=torch.long,
                            device=dev).scatter_(1, scatter_pos, st)[:, :-1]
    combine_w = torch.zeros((G, E * C + 1), dtype=torch.float32,
                            device=dev).scatter_(1, scatter_pos, sp)[:, :-1]
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(n, device=dev).expand(G, n))
    slot_table = scatter_pos.gather(1, inv)
    return (gather_idx.reshape(*lead, E, C), combine_w.reshape(*lead, E, C),
            slot_table.reshape(*lead, T, top_k))


def _batched_take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src (G, N, D), idx (G, M) -> (G, M, D).  Indices are in bounds by
    construction (sentinels point at the zero pad row)."""
    return src[torch.arange(src.shape[0], device=src.device)[:, None], idx]


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((x.shape[0], 1, x.shape[2]))], dim=1)


def _gather_sum_k(src_pad: torch.Tensor,
                  slot_table: torch.Tensor) -> torch.Tensor:
    """out[g, t] = sum_j src_pad[g, slot_table[g, t, j]], one (G, T, D)
    gather at a time over the small top-k axis."""
    out = _batched_take(src_pad, slot_table[:, :, 0])
    for j in range(1, slot_table.shape[2]):
        out = out + _batched_take(src_pad, slot_table[:, :, j])
    return out


class _MoePermute(torch.autograd.Function):
    """Dispatch by gather; its backward is a gather over the inverse map
    (the reference's custom VJP, no scatter)."""

    @staticmethod
    def forward(ctx, x, gather_idx, slot_table):
        ctx.save_for_backward(slot_table)
        return _batched_take(_pad_row(x), gather_idx)

    @staticmethod
    def backward(ctx, g):
        slot_table, = ctx.saved_tensors
        # the sentinel slot E*C reads the zero pad row
        return _gather_sum_k(_pad_row(g), slot_table), None, None


class _MoeUnpermute(torch.autograd.Function):
    """Combine by gather; its backward is a gather too."""

    @staticmethod
    def forward(ctx, hw, gather_idx, slot_table):
        ctx.save_for_backward(gather_idx)
        return _gather_sum_k(_pad_row(hw), slot_table)

    @staticmethod
    def backward(ctx, g):
        gather_idx, = ctx.saved_tensors
        # the sentinel token T reads the zero pad row
        return _batched_take(_pad_row(g), gather_idx), None, None


def moe_permute(x: torch.Tensor, gather_idx: torch.Tensor,
                slot_table: torch.Tensor) -> torch.Tensor:
    """Dispatch tokens to expert slots: x (G, T, D), gather_idx (G, E*C) ->
    (G, E*C, D).  The backward is the JAX package's custom VJP
    (``src/repro/models/blocks.py:292-328``): dx gathers the slots of each
    token over ``slot_table`` and sums them, so the gradient is a gather, not
    autograd's scatter-add of the forward's indexing."""
    return _MoePermute.apply(x, gather_idx, slot_table)


def moe_unpermute(hw: torch.Tensor, gather_idx: torch.Tensor,
                  slot_table: torch.Tensor) -> torch.Tensor:
    """Combine expert-slot outputs back per token: hw (G, E*C, D) ->
    (G, T, D).  The backward is the JAX package's custom VJP: dhw gathers
    each slot's token over ``gather_idx``."""
    return _MoeUnpermute.apply(hw, gather_idx, slot_table)


def _gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``moe_gmm``; on DTensors on each rank's experts
    (``api.local_moe_gmm``)."""
    if api.is_dtensor(x, w):
        return api.local_moe_gmm(moe_gmm, x, w)
    return moe_gmm(x, w)


def moe_expert_ffn(x_disp: torch.Tensor, params: Params,
                   activation: str) -> torch.Tensor:
    """Batched per-expert GLU FFN: x_disp (G, E, C, D) -> (G, E, C, D).

    The groups are merged into each expert's rows, (E, G * C, D), one
    contiguous copy (a view when G is 1), and the three products run as
    ``moe_gmm`` launches."""
    G, E, C, D = x_disp.shape
    xe = x_disp.transpose(0, 1).reshape(E, G * C, D)
    act = L._ACTS[activation]
    h = act(_gmm(xe, params["w_gate"])) * _gmm(xe, params["w_up"])
    if api.is_dtensor(h):  # the JAX package's (G, E, C, F) layout
        h = constrain(h.reshape(E, G, C, -1).transpose(0, 1), "moe_hidden")
        h = h.transpose(0, 1).reshape(E, G * C, -1)
    return _gmm(h, params["w_down"]).reshape(E, G, C, D).transpose(0, 1)


def _per_group(fn, *args, **kw):
    """``fn(*args, **kw)``; on DTensors on each rank's dispatch groups
    (``api.local_groups``): DTensor has no rules for the plan's sorts and
    scatters or the permutes' custom backwards."""
    if api.is_dtensor(*args):
        return api.local_groups(lambda *a: fn(*a, **kw), *args)
    return fn(*args, **kw)


def moe_apply(params: Params, x: torch.Tensor,
              cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based MoE with batched dispatch: x (B, S, D) -> (output,
    load-balance aux loss).

    Dispatch groups are the batch rows when S > 1, or the whole batch at
    decode (S == 1).  The router runs in fp32.
    """
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    probs = torch.softmax(x.float() @ params["router"], dim=-1)

    # Switch-style load-balance auxiliary loss, over all tokens
    top1 = torch.argmax(probs, dim=-1)
    frac_tokens = F.one_hot(top1, E).float().mean(dim=(0, 1))
    mean_prob = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_tokens * mean_prob) * cfg.router_aux_coef

    if S == 1:
        xg, pg = x.reshape(1, B, D), probs.reshape(1, B, E)
    else:
        xg, pg = x, probs
    G, T = xg.shape[0], xg.shape[1]
    cap = moe_capacity(T, cfg)
    idx, cw, slots = _per_group(moe_dispatch_indices, pg, top_k=k,
                                capacity=cap)
    idx = constrain(idx, "moe_idx").reshape(G, E * cap)
    x_disp = _per_group(moe_permute, xg, idx, slots).reshape(G, E, cap, D)
    x_disp = constrain(x_disp, "moe_dispatch")
    h = moe_expert_ffn(x_disp, params, cfg.activation)
    h = constrain(h, "moe_dispatch")
    hw = h.reshape(G, E * cap, D) * cw.reshape(G, E * cap, 1).to(h.dtype)
    out = _per_group(moe_unpermute, hw, idx, slots).reshape(B, S, D)
    if "shared" in params:
        out = out + L.mlp_apply(params["shared"], x, cfg.activation)
    return constrain(out, "act_btd"), aux


# ===========================================================================
# RG-LRU recurrent block (Griffin / RecurrentGemma)
# ===========================================================================

def init_rglru_block(gen, cfg: ModelConfig, device) -> Params:
    dt = cfg.activation_dtype
    D, R = cfg.d_model, cfg.rnn_state_dim
    # Lambda init so that a = sigmoid(lam)^(c*r) sits in [0.9, 0.999]
    u = torch.empty((R,), dtype=torch.float32, device=device)
    if gen is not None:
        u.uniform_(0.9 ** 2, 0.999 ** 2, generator=gen)
    root = u ** (1.0 / 8.0)
    p: Params = {
        "ln1": L.init_rmsnorm(D, dt, device),
        "ln2": L.init_rmsnorm(D, dt, device),
        "w_x": L.dense_init(gen, D, (R,), dt, device),
        "w_gate_in": L.dense_init(gen, D, (R,), dt, device),
        "w_out": L.dense_init(gen, R, (D,), dt, device),
        "conv_w": _normal_init(gen, (cfg.conv1d_width, R), 0.02, dt, device),
        "conv_b": torch.zeros((R,), dtype=dt, device=device),
        "w_a": L.dense_init(gen, R, (R,), torch.float32, device),
        "b_a": torch.zeros((R,), dtype=torch.float32, device=device),
        "w_i": L.dense_init(gen, R, (R,), torch.float32, device),
        "b_i": torch.zeros((R,), dtype=torch.float32, device=device),
        "lam": torch.log(root / (1 - root)),
    }
    if cfg.d_ff:
        p["mlp"] = L.init_mlp(gen, D, cfg.d_ff, cfg.activation, dt, device)
    return p


def init_rglru_cache(cfg: ModelConfig, batch: int, device) -> Params:
    R = cfg.rnn_state_dim
    return {
        "h": torch.zeros((batch, R), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, R),
                            dtype=cfg.activation_dtype, device=device),
    }


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   history: Optional[torch.Tensor]):
    """Depthwise causal conv. x (B, S, R), w (W, R).  Returns (y,
    new_history)."""
    W, S = w.shape[0], x.shape[1]
    if history is None:
        history = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([history, x], dim=1)  # (B, S + W - 1, R)
    y = sum(xp[:, i:i + S] * w[i] for i in range(W)) + b
    new_hist = xp[:, -(W - 1):] if W > 1 else history
    return y, new_hist


def rglru_scan(y: torch.Tensor, a_log: torch.Tensor, gated_in: torch.Tensor,
               h0: Optional[torch.Tensor]) -> torch.Tensor:
    """Diagonal linear recurrence h_t = a_t * h_{t-1} + x_t through the
    ``rglru_scan`` op (the JAX function runs an associative scan; ``y`` is
    unused, as there).

    a_log: (B, S, R) log of decay in (-inf, 0]; gated_in: (B, S, R); h0
    (B, R) or None for zeros.  Returns (B, S, R) fp32.
    """
    del y
    a = torch.exp(a_log)
    if h0 is None:
        h0 = a.new_zeros((a.shape[0], a.shape[2]), dtype=torch.float32)
    if api.is_dtensor(a, gated_in, h0):  # each rank's channels
        return api.local_scan(rglru_scan_op, a, gated_in, h0)
    return rglru_scan_op(a.contiguous(), gated_in.contiguous(), h0)


def _rglru_gates(params: Params, y: torch.Tensor):
    """Returns (log_a, scaled_input) for the recurrence, fp32."""
    y32 = y.float()
    r = torch.sigmoid(y32 @ params["w_a"] + params["b_a"])
    i = torch.sigmoid(y32 @ params["w_i"] + params["b_i"])
    c = 8.0
    log_a = -c * r * F.softplus(params["lam"])  # (..., R), <= 0
    a_sq = torch.exp(2.0 * log_a)
    scaled = torch.sqrt(torch.clamp_min(1.0 - a_sq, 1e-8)) * (i * y32)
    return log_a, scaled


def apply_rglru_block(params: Params, x: torch.Tensor, ctx: BlockCtx,
                      cfg: ModelConfig, cache: Optional[Params] = None):
    """Returns (y, cache, aux).  Decode updates ``cache`` in place; prefill
    fills it in place when one is given, else a new one."""
    xin = L.rms_norm(x, params["ln1"], cfg.norm_eps)
    gate = F.gelu(xin @ params["w_gate_in"], approximate="tanh")
    y = constrain(xin @ params["w_x"], "act_btr")

    if ctx.decoding and cache is None:
        raise ValueError("decode needs a recurrent cache")
    hist = cache["conv"] if ctx.decoding else None
    y, new_hist = _causal_conv1d(y, params["conv_w"], params["conv_b"], hist)

    log_a, scaled = _rglru_gates(params, y)
    new_cache = None
    if ctx.decoding:
        h = torch.exp(log_a[:, 0]) * cache["h"] + scaled[:, 0]
        cache["h"].copy_(h)
        cache["conv"].copy_(new_hist)
        new_cache = cache
        h_seq = h[:, None]
    else:
        h_seq = rglru_scan(y, log_a, scaled, None)
        if ctx.mode == "prefill":
            new_cache = cache if cache is not None else init_rglru_cache(
                cfg, x.shape[0], x.device)
            new_cache["h"].copy_(h_seq[:, -1])
            new_cache["conv"].copy_(new_hist)
    out = (gate.float() * h_seq).to(x.dtype)
    x = x + out @ params["w_out"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "mlp" in params:
        x = x + L.mlp_apply(params["mlp"],
                            L.rms_norm(x, params["ln2"], cfg.norm_eps),
                            cfg.activation)
    return x, new_cache, aux


# ===========================================================================
# mLSTM block (xLSTM): chunkwise-parallel matrix-memory LSTM
# ===========================================================================

def _mlstm_dims(cfg: ModelConfig) -> tuple[int, int]:
    inner = 2 * cfg.d_model  # up-projection factor 2 (xLSTM paper)
    return inner, inner // cfg.num_heads


def init_mlstm_block(gen, cfg: ModelConfig, device) -> Params:
    dt, f32 = cfg.activation_dtype, torch.float32
    D, NH = cfg.d_model, cfg.num_heads
    inner, _ = _mlstm_dims(cfg)
    return {
        "ln1": L.init_rmsnorm(D, dt, device),
        "w_up": L.dense_init(gen, D, (inner,), dt, device),
        "w_gate": L.dense_init(gen, D, (inner,), dt, device),
        "wq": L.dense_init(gen, inner, (inner,), dt, device),
        "wk": L.dense_init(gen, inner, (inner,), dt, device),
        "wv": L.dense_init(gen, inner, (inner,), dt, device),
        "w_i": L.dense_init(gen, inner, (NH,), f32, device),
        "b_i": torch.zeros((NH,), dtype=f32, device=device),
        "w_f": L.dense_init(gen, inner, (NH,), f32, device),
        "b_f": torch.full((NH,), 3.0, dtype=f32, device=device),
        "out_norm": L.init_rmsnorm(inner, dt, device),
        "w_down": L.dense_init(gen, inner, (D,), dt, device),
    }


def init_mlstm_cache(cfg: ModelConfig, batch: int, device) -> Params:
    NH = cfg.num_heads
    _, dh = _mlstm_dims(cfg)
    f32 = torch.float32
    return {
        "C": torch.zeros((batch, NH, dh, dh), dtype=f32, device=device),
        "n": torch.zeros((batch, NH, dh), dtype=f32, device=device),
        "m": torch.full((batch, NH), -1e30, dtype=f32, device=device),
    }


def mlstm_chunkwise(q, k, v, li, lf, state: Params, chunk: int = 256):
    """Chunkwise-parallel stabilized mLSTM.

    q, k, v: (B, S, NH, DH); li / lf: (B, S, NH) log input / log forget
    gate.  ``state``: {"C", "n", "m"} carried across chunks, read only.
    Returns (h, new_state).  S must be a multiple of the chunk (``min(chunk,
    S)``), as in the JAX function: nothing is padded.
    """
    B, S, NH, DH = q.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"mlstm_chunkwise: S = {S} is not a multiple of the "
                         f"chunk {chunk}")
    n_chunks = S // chunk
    scale = 1.0 / math.sqrt(DH)

    def chunks(t):  # (B, S, NH, ...) -> (N, B, NH, L, ...)
        t = t.reshape(B, n_chunks, chunk, NH, *t.shape[3:])
        return t.transpose(2, 3).transpose(0, 1)

    qr, kr, vr, lir, lfr = (chunks(t) for t in (q, k, v, li, lf))
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=q.device).tril()
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    for c in range(n_chunks):
        qc, kc, vc, lic, lfc = qr[c], kr[c], vr[c], lir[c], lfr[c]
        b = torch.cumsum(lfc, dim=-1)  # inclusive logcumsum of forget gates
        # per-position stabilizer
        intra_max = torch.cummax(lic - b, dim=-1).values
        m_t = torch.maximum(m[..., None] + b, b + intra_max)  # (B, NH, L)
        # inter-chunk: read from running memory
        inter_coef = torch.exp(m[..., None] + b - m_t)
        h_inter = torch.einsum("bhld,bhde->bhle", qc, C) * scale
        n_inter = torch.einsum("bhld,bhd->bhl", qc, n) * scale
        # intra-chunk decay D[t, s] = exp(b_t - b_s + li_s - m_t), s <= t
        logD = (b[..., :, None] - b[..., None, :] + lic[..., None, :]
                - m_t[..., None])
        Dmat = torch.where(mask, torch.exp(logD), 0.0)
        scores = torch.einsum("bhld,bhsd->bhls", qc, kc) * scale * Dmat
        h_intra = torch.einsum("bhls,bhsd->bhld", scores.to(vc.dtype), vc)
        n_intra = scores.sum(dim=-1)
        h_num = h_inter * inter_coef[..., None] + h_intra
        denom = torch.maximum((n_inter * inter_coef + n_intra).abs(),
                              torch.exp(-m_t))
        hs.append(h_num / denom[..., None])
        # state update to the end of the chunk
        bL = b[..., -1:]
        g = bL - b + lic  # per-position contribution in log space
        m_new = torch.maximum(m + bL[..., 0], g.max(dim=-1).values)
        state_coef = torch.exp(m + bL[..., 0] - m_new)  # (B, NH)
        w = torch.exp(g - m_new[..., None])  # (B, NH, L)
        C = C * state_coef[..., None, None] + torch.einsum(
            "bhl,bhld,bhle->bhde", w, kc, vc)
        n = n * state_coef[..., None] + torch.einsum("bhl,bhld->bhd", w, kc)
        m = m_new
    h = torch.stack(hs).transpose(0, 1).transpose(2, 3).reshape(B, S, NH, DH)
    return h, {"C": C, "n": n, "m": m}


def mlstm_step(q, k, v, li, lf, state: Params):
    """Single-token recurrent mLSTM step. q/k/v: (B, 1, NH, DH) in the
    activation dtype, ``state`` fp32.  q, k and v are widened to fp32
    first: the JAX function multiplies k by v in their dtype, but its
    serving step runs jitted, where XLA keeps that product in fp32 (excess
    precision) before it meets the fp32 gate.  Returns (h (B, 1, NH * DH)
    fp32, new_state)."""
    B, _, NH, DH = q.shape
    scale = 1.0 / math.sqrt(DH)
    qs, ks, vs = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    lis, lfs = li[:, 0], lf[:, 0]  # (B, NH)
    m_new = torch.maximum(lfs + state["m"], lis)
    f_p = torch.exp(lfs + state["m"] - m_new)
    i_p = torch.exp(lis - m_new)
    C = state["C"] * f_p[..., None, None] + i_p[..., None, None] * (
        ks[..., :, None] * vs[..., None, :])
    n = state["n"] * f_p[..., None] + i_p[..., None] * ks
    h_num = torch.einsum("bhd,bhde->bhe", qs, C) * scale
    denom = torch.maximum(
        (torch.einsum("bhd,bhd->bh", qs, n) * scale).abs(), torch.exp(-m_new))
    h = (h_num / denom[..., None])[:, None]  # (B, 1, NH, DH)
    return h.reshape(B, 1, NH * DH), {"C": C, "n": n, "m": m_new}


def _mlstm_chunks(rows: Params, _whole: Params) -> Params:
    """``mlstm_chunkwise`` on ``rows`` (fp32 q, k, v, li, lf and the
    state): {"h", "state"}, the form ``api.local_rows`` takes."""
    h, state = mlstm_chunkwise(rows["q"], rows["k"], rows["v"], rows["li"],
                               rows["lf"], rows["state"])
    return {"h": h, "state": state}


def _mlstm_decode(rows: Params, _whole: Params) -> Params:
    """``mlstm_step`` on ``rows`` (q, k, v, li, lf and the state):
    {"h", "state"}, the form ``api.local_rows`` takes."""
    h, state = mlstm_step(rows["q"], rows["k"], rows["v"], rows["li"],
                          rows["lf"], rows["state"])
    return {"h": h, "state": state}


def _write_state(cache: Params, state: Params) -> Params:
    """Copy a recurrent state into ``cache`` in place (its entries may be
    views into a stacked cache) and return the cache."""
    for name, t in state.items():
        cache[name].copy_(t)
    return cache


def apply_mlstm_block(params: Params, x: torch.Tensor, ctx: BlockCtx,
                      cfg: ModelConfig, cache: Optional[Params] = None):
    """Returns (y, cache, aux).  Prefill starts from ``cache`` when one is
    given (a fresh one: zeros, m = -1e30) and writes the end state into it
    in place; decode updates it in place.  Under a policy both run on each
    rank's rows (``api.local_rows``)."""
    B = x.shape[0]
    NH = cfg.num_heads
    xin = L.rms_norm(x, params["ln1"], cfg.norm_eps)
    up = xin @ params["w_up"]
    gate = xin @ params["w_gate"]
    q, k, v = (api.split_heads(up @ params[w], NH)
               for w in ("wq", "wk", "wv"))
    up32 = up.float()
    li = up32 @ params["w_i"] + params["b_i"]
    lf = api.local_pointwise(F.logsigmoid,
                             up32 @ params["w_f"] + params["b_f"])

    new_cache = None
    if ctx.decoding:
        if cache is None:
            raise ValueError("decode needs a recurrent cache")
        rows = {"q": q, "k": k, "v": v, "li": li, "lf": lf, "state": cache}
        out = api.local_rows(_mlstm_decode, rows, {})
        h, new_cache = out["h"], _write_state(cache, out["state"])
    else:
        state = cache if cache is not None else init_mlstm_cache(cfg, B,
                                                                 x.device)
        rows = {"q": q.float(), "k": k.float(), "v": v.float(), "li": li,
                "lf": lf, "state": state}
        out = api.local_rows(_mlstm_chunks, rows, {})
        h, end_state = api.merge_heads(out["h"]), out["state"]
        if ctx.mode == "prefill":
            new_cache = end_state if cache is None else _write_state(
                cache, end_state)
    h = L.rms_norm(h.to(x.dtype), params["out_norm"], cfg.norm_eps)
    h = h * F.silu(gate)
    out = h @ params["w_down"]
    return x + out, new_cache, torch.zeros((), dtype=torch.float32,
                                           device=x.device)


# ===========================================================================
# sLSTM block (xLSTM): scalar-memory LSTM with exponential gating
# ===========================================================================

_SLSTM_GATES = ("z", "i", "f", "o")


def init_slstm_block(gen, cfg: ModelConfig, device) -> Params:
    dt, f32 = cfg.activation_dtype, torch.float32
    D, NH = cfg.d_model, cfg.num_heads
    dh = D // NH
    ff = int(math.ceil(4.0 / 3.0 * D / 8.0)) * 8
    p: Params = {"ln1": L.init_rmsnorm(D, dt, device),
                 "ln2": L.init_rmsnorm(D, dt, device)}
    for g in _SLSTM_GATES:
        p[f"w_{g}"] = L.dense_init(gen, D, (D,), dt, device)
        p[f"r_{g}"] = _normal_init(gen, (NH, dh, dh), 1.0 / math.sqrt(dh), dt,
                                   device)
        p[f"b_{g}"] = torch.full((D,), 3.0 if g == "f" else 0.0, dtype=f32,
                                 device=device)
    p["w_out"] = L.dense_init(gen, D, (D,), dt, device)
    p["mlp"] = L.init_mlp(gen, D, ff, "geglu", dt, device)
    return p


def init_slstm_cache(cfg: ModelConfig, batch: int, device) -> Params:
    D, f32 = cfg.d_model, torch.float32
    return {
        "h": torch.zeros((batch, D), dtype=f32, device=device),
        "c": torch.zeros((batch, D), dtype=f32, device=device),
        "n": torch.ones((batch, D), dtype=f32, device=device),
        "m": torch.zeros((batch, D), dtype=f32, device=device),
    }


def _slstm_cell(params: Params, xt: Params, state: Params, NH: int) -> Params:
    """One sLSTM step. xt: dict of per-gate input preactivations (B, D)."""
    B, D = xt["z"].shape
    dh = D // NH
    h_prev = state["h"].reshape(B, NH, dh)

    def rec(g):
        r = params[f"r_{g}"].float()
        return torch.einsum("bhd,hde->bhe", h_prev, r).reshape(B, D)

    z = torch.tanh(xt["z"] + rec("z"))
    o = torch.sigmoid(xt["o"] + rec("o"))
    i_tilde = xt["i"] + rec("i")
    f_tilde = xt["f"] + rec("f")
    lf = api.local_pointwise(F.logsigmoid, f_tilde)
    m_new = torch.maximum(lf + state["m"], i_tilde)
    i_p = torch.exp(i_tilde - m_new)
    f_p = torch.exp(lf + state["m"] - m_new)
    c = f_p * state["c"] + i_p * z
    n = f_p * state["n"] + i_p
    h = o * c / torch.clamp_min(n, 1e-6)
    return {"h": h, "c": c, "n": n, "m": m_new}


def _slstm_scan(rows: Params, cell: Params, NH: int) -> Params:
    """The sLSTM cell over every position of ``rows["pre"]`` (per-gate
    (B, S, D) preactivations) from ``rows["state"]``: {"h": (B, S, D) every
    step's h, "state": the last state}."""
    state, hs = rows["state"], []
    pre = rows["pre"]
    for t in range(pre["z"].shape[1]):
        state = _slstm_cell(cell, {g: pre[g][:, t] for g in pre}, state, NH)
        hs.append(state["h"])
    return {"h": torch.stack(hs, dim=1), "state": state}


def apply_slstm_block(params: Params, x: torch.Tensor, ctx: BlockCtx,
                      cfg: ModelConfig, cache: Optional[Params] = None):
    """Returns (y, cache, aux), the cache handled as in the mLSTM block.
    The cell runs once per position in a Python loop (on each rank's rows
    under a policy, ``api.local_rows``)."""
    B = x.shape[0]
    NH = cfg.num_heads
    xin = L.rms_norm(x, params["ln1"], cfg.norm_eps)
    pre = {g: (xin @ params[f"w_{g}"]).float() + params[f"b_{g}"]
           for g in _SLSTM_GATES}
    # the recurrent weights widened once, not once per step
    cell = {f"r_{g}": params[f"r_{g}"].float() for g in _SLSTM_GATES}
    if ctx.decoding and cache is None:
        raise ValueError("decode needs a recurrent cache")
    new_cache = None
    state = cache if cache is not None else init_slstm_cache(cfg, B, x.device)
    rows = {"pre": pre, "state": state}
    out = api.local_rows(_slstm_scan, rows, cell, NH=NH)
    h_seq, state = out["h"], out["state"]
    if ctx.decoding:
        new_cache = _write_state(cache, state)
    elif ctx.mode == "prefill":
        new_cache = state if cache is None else _write_state(cache, state)
    x = x + h_seq.to(x.dtype) @ params["w_out"]
    x = x + L.mlp_apply(params["mlp"], L.rms_norm(x, params["ln2"],
                                                  cfg.norm_eps), "geglu")
    return x, new_cache, torch.zeros((), dtype=torch.float32, device=x.device)


# ===========================================================================
# registry
# ===========================================================================

_INITS = {"rglru": init_rglru_block, "mlstm": init_mlstm_block,
          "slstm": init_slstm_block}
_APPLIES = {"rglru": apply_rglru_block, "mlstm": apply_mlstm_block,
            "slstm": apply_slstm_block}


def init_block(block_type: str, gen, cfg: ModelConfig, device,
               cross: bool = False) -> Params:
    """``cross`` adds cross-attention to an attention block."""
    if block_type == "attn":
        return init_attn_block(gen, cfg, device, cross=cross)
    return _INITS[block_type](gen, cfg, device)


def init_block_cache(block_type: str, cfg: ModelConfig, batch: int,
                     capacity: int, device):
    if block_type == "attn":
        return init_attn_cache(cfg, batch, capacity, device)
    if block_type == "rglru":
        return init_rglru_cache(cfg, batch, device)
    if block_type == "mlstm":
        return init_mlstm_cache(cfg, batch, device)
    if block_type == "slstm":
        return init_slstm_cache(cfg, batch, device)
    raise ValueError(block_type)


def apply_block(block_type: str, params: Params, x: torch.Tensor,
                ctx: BlockCtx, cfg: ModelConfig, cache: Optional[Params],
                encoder_out: Optional[torch.Tensor] = None):
    """(y, cache, aux) of one block of any type; only attention blocks read
    ``encoder_out``."""
    if block_type == "attn":
        return apply_attn_block(params, x, ctx, cfg, cache=cache,
                                encoder_out=encoder_out)
    return _APPLIES[block_type](params, x, ctx, cfg, cache=cache)
