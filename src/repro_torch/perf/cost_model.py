"""Analytic per-(arch x shape) FLOP/byte model, the JAX package's
(``src/repro/perf/cost_model.py``) unchanged in every number.

Two compute variants are reported:
  * impl_flops   — a blocked implementation that computes masked-out tiles
                   (causal / windowed masks cost full blocks);
  * kernel_flops — attention kernels that skip fully-masked tiles (causal
                   is ~2x cheaper at long S).

The same FLOP model is also exposed PER LAYER (``model_layer_costs``) so the
placement plane (``runtime/placement.py``) can partition a model's layer
stack into contiguous pipeline stages:

  * ``LayerCost`` carries each block's prefill/decode FLOPs per token, its
    resident parameter bytes (every expert, for the memory-fit check), the
    bytes actually *streamed* per decode token (router + routed-k + shared
    experts only, for the bandwidth roof), and its per-sequence cache bytes.
    Per-layer parameter counts are analytic (projection/GLU shapes) and then
    calibrated so blocks + embedding + head sum EXACTLY to
    ``ModelConfig.param_count()`` / ``active_param_count()`` — the port's
    count of the real init on the ``meta`` device.
  * The link model prices inter-stage activation transfers: a
    ``LinkProfile`` is (sustained GB/s, per-hop RTT) and
    ``transfer_time_s`` = rtt + bytes/bandwidth.  ``LAN_LINK`` is an
    edge-cluster hop (10 GbE-class), ``WAN_LINK`` a persistent cloud
    tunnel (no per-call endpoint queuing — that stays ``CLOUD_RTT_S``,
    charged once per request by the placement plane, exactly like
    ``model_call_latency_s`` charges whole cloud models).  Activation
    bytes per boundary token are ``d_model * BYTES[dtype]`` (the residual
    stream is all that crosses a stage cut).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.config import ModelConfig, ShapeSpec

BYTES = {"bfloat16": 2, "float32": 4}


# ---------------------------------------------------------------------------
# inter-device link model (placement plane)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LinkProfile:
    """A point-to-point transport between pipeline stages."""

    name: str
    gbytes_per_s: float  # sustained payload bandwidth
    rtt_s: float  # per-hop latency (serialization + network)


LAN_LINK = LinkProfile("lan", 1.25, 0.002)  # 10 GbE-class edge cluster hop
WAN_LINK = LinkProfile("wan", 0.125, 0.04)  # persistent tunnel to the cloud


def transfer_time_s(link: LinkProfile, nbytes: float) -> float:
    return link.rtt_s + nbytes / (link.gbytes_per_s * 1e9)


def activation_bytes(cfg: ModelConfig, tokens: float) -> float:
    """Residual-stream bytes crossing a stage boundary for ``tokens``."""
    return float(tokens) * cfg.d_model * BYTES[cfg.dtype]


@dataclass
class CellCost:
    impl_flops: float  # global per step
    kernel_flops: float
    hbm_bytes: float  # global per step (weights + activations + caches)
    model_flops: float  # 6*N(_active)*tokens — the "useful" count
    params_bytes: float

    def per_device(self, n: int) -> "CellCost":
        return CellCost(self.impl_flops / n, self.kernel_flops / n,
                        self.hbm_bytes / n, self.model_flops / n,
                        self.params_bytes / n)


def _glu(cfg: ModelConfig, d: int, f: int) -> float:
    k = 3 if cfg.activation in ("swiglu", "geglu") else 2
    return 2.0 * k * d * f


def _attn_proj(cfg: ModelConfig) -> float:
    d, hd, H, K = cfg.d_model, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    return 2.0 * (d * H * hd + 2 * d * K * hd + H * hd * d)


def _attn_span(cfg: ModelConfig, S: int, impl: bool) -> float:
    """Average attended kv length per query token."""
    if cfg.attention_type == "local" and cfg.window_size:
        ideal = min(cfg.window_size, S)
        return float(S if impl else ideal)  # xla impl scans all kv chunks
    if cfg.attention_type == "chunked" and cfg.window_size:
        ideal = min(cfg.window_size, S) / 2
        return float(S if impl else ideal)
    return float(S if impl else S / 2)  # causal ideal = S/2


def _block_flops_per_token(cfg: ModelConfig, lt: str, S: int, impl: bool,
                           decode: bool) -> float:
    d = cfg.d_model
    if lt == "attn":
        H, hd = cfg.num_heads, cfg.head_dim
        span = _decode_span(cfg, S) if decode else _attn_span(cfg, S, impl)
        fl = _attn_proj(cfg) + 2.0 * 2.0 * H * hd * span
        if cfg.num_experts:
            E, k = cfg.num_experts, cfg.experts_per_token
            slots = k * cfg.capacity_factor  # capacity padding included
            fl += 2.0 * d * E  # router
            fl += slots * _glu(cfg, d, cfg.moe_d_ff)
            fl += cfg.num_shared_experts * _glu(cfg, d, cfg.moe_d_ff)
        elif cfg.d_ff:
            fl += _glu(cfg, d, cfg.d_ff)
        if cfg.cross_attention:
            from repro_torch.configs import ENCDEC_DECODE_SRC_LEN

            fl += _attn_proj(cfg) + 2.0 * 2.0 * cfg.num_heads * cfg.head_dim * ENCDEC_DECODE_SRC_LEN
        return fl
    if lt == "rglru":
        R, W = cfg.rnn_state_dim, cfg.conv1d_width
        fl = 2.0 * (2 * d * R + R * d + 2 * R * R) + 2.0 * W * R + 10.0 * R
        if cfg.d_ff:
            fl += _glu(cfg, d, cfg.d_ff)
        return fl
    if lt == "mlstm":
        inner = 2 * d
        dh = inner // cfg.num_heads
        chunk = min(256, S)
        fl = 2.0 * 2 * d * inner + 3 * 2.0 * inner * inner + 2.0 * inner * d
        fl += 2.0 * 2.0 * inner * (dh if decode else chunk)  # memory read/intra
        fl += 4.0 * inner * dh  # state update
        return fl
    if lt == "slstm":
        dh = d // cfg.num_heads
        ff = int(4 / 3 * d)
        return 2.0 * 4 * d * d + 2.0 * 4 * d * dh + 2.0 * d * d + _glu(cfg, d, ff)
    raise KeyError(lt)


def _decode_span(cfg: ModelConfig, S: int) -> float:
    if cfg.attention_type in ("local", "chunked") and cfg.window_size:
        return float(min(cfg.window_size, S))
    return float(S)


def cell_cost(cfg: ModelConfig, shape: ShapeSpec, *, remat: bool = True,
              sequence_parallel: bool = True) -> CellCost:
    B, S = shape.global_batch, shape.seq_len
    P = cfg.param_count()
    P_active = cfg.active_param_count()
    pbytes = P * BYTES[cfg.dtype]
    d = cfg.d_model

    if shape.kind == "decode":
        tokens = B  # one token per sequence per step
        fl_impl = fl_kern = 0.0
        for lt in cfg.layer_types:
            f = _block_flops_per_token(cfg, lt, S, True, True)
            fl_impl += f * tokens
            fl_kern += _block_flops_per_token(cfg, lt, S, False, True) * tokens
        head = 2.0 * d * cfg.vocab_padded * tokens
        fl_impl += head
        fl_kern += head
        # bytes: weights once (MoE: every expert hit by >=1 of B*k draws in
        # expectation -> cap with coverage), caches once, activations small
        import math
        if cfg.num_experts:
            cover = 1.0 - math.exp(-B * cfg.experts_per_token / cfg.num_experts)
            wbytes = (P - (P - P_active)) * BYTES[cfg.dtype] + (P - P_active) * BYTES[cfg.dtype] * cover
        else:
            wbytes = pbytes
        cache = _cache_bytes(cfg, B, S)
        hbm = wbytes + cache + tokens * d * 40.0
        model = 2.0 * P_active * tokens
        return CellCost(fl_impl, fl_kern, hbm, model, pbytes)

    tokens = B * S
    fl_impl = fl_kern = 0.0
    for lt in cfg.layer_types:
        fl_impl += _block_flops_per_token(cfg, lt, S, True, False) * tokens
        fl_kern += _block_flops_per_token(cfg, lt, S, False, False) * tokens
    for _ in range(cfg.num_encoder_layers):
        f = _attn_proj(cfg) + 2.0 * 2.0 * cfg.num_heads * cfg.head_dim * S + _glu(cfg, d, cfg.d_ff)
        fl_impl += f * tokens
        fl_kern += f * tokens

    if shape.kind == "train":
        head = 2.0 * d * cfg.vocab_padded * tokens
        fl_impl = (fl_impl + head) * (4.0 if remat else 3.0)
        fl_kern = (fl_kern + head) * (4.0 if remat else 3.0)
        model = 6.0 * P_active * tokens
        act_bytes = tokens * d * len(cfg.layer_types) * BYTES[cfg.dtype] * (2.0 if sequence_parallel else 2.0)
        hbm = pbytes * 6.0 + act_bytes * 3.0  # w fwd/bwd/opt + act save/reread
        return CellCost(fl_impl, fl_kern, hbm, model, pbytes)

    # prefill
    head = 2.0 * d * cfg.vocab_padded * B  # last position only
    fl_impl += head
    fl_kern += head
    model = 2.0 * P_active * tokens
    hbm = pbytes + _cache_bytes(cfg, B, S) + tokens * d * 30.0
    return CellCost(fl_impl, fl_kern, hbm, model, pbytes)


def _cache_bytes(cfg: ModelConfig, B: int, S: int) -> float:
    from repro_torch.models.blocks import attn_cache_capacity

    total = 0.0
    for lt in cfg.layer_types:
        if lt == "attn":
            W = attn_cache_capacity(cfg, S)
            total += 2.0 * B * W * cfg.num_kv_heads * cfg.head_dim * BYTES[cfg.dtype]
        elif lt == "rglru":
            total += B * cfg.rnn_state_dim * 4.0
        elif lt == "mlstm":
            dh = 2 * cfg.d_model // cfg.num_heads
            total += B * cfg.num_heads * dh * dh * 4.0
        elif lt == "slstm":
            total += 4.0 * B * cfg.d_model * 4.0
    if cfg.cross_attention:
        from repro_torch.configs import ENCDEC_DECODE_SRC_LEN

        total += B * ENCDEC_DECODE_SRC_LEN * cfg.d_model * BYTES[cfg.dtype]
    return total


# ---------------------------------------------------------------------------
# per-layer decomposition (placement plane)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerCost:
    """One transformer block as the placement search sees it.

    FLOPs come from the same ``_block_flops_per_token`` the roofline uses
    (impl variant — the blocked schedule that computes masked tiles);
    parameter bytes are analytic per shape and calibrated so the stack plus
    embedding/head reproduces ``param_count()`` exactly.
    """

    index: int
    kind: str  # "attn" | "rglru" | "mlstm" | "slstm"
    prefill_flops: float  # per prompt token
    decode_flops: float  # per generated token at the reference context
    weight_bytes: float  # resident bytes (MoE: every expert)
    active_weight_bytes: float  # bytes streamed per decode token
    kv_bytes: float  # per-sequence cache bytes at the reference context


def _layer_params(cfg: ModelConfig, lt: str, active: bool) -> float:
    """Analytic parameter count of one block (GLU/projection shapes; the
    per-layer split behind ``model_layer_costs`` — see its calibration)."""
    d = cfg.d_model
    if lt == "attn":
        H, hd, K = cfg.num_heads, cfg.head_dim, cfg.num_kv_heads
        p = float(d * H * hd + 2 * d * K * hd + H * hd * d)
        if cfg.cross_attention:
            p += float(d * H * hd + 2 * d * K * hd + H * hd * d)
        if cfg.num_experts:
            per_expert = _glu(cfg, d, cfg.moe_d_ff) / 2.0
            n = cfg.experts_per_token if active else cfg.num_experts
            p += d * cfg.num_experts  # router
            p += (n + cfg.num_shared_experts) * per_expert
        elif cfg.d_ff:
            p += _glu(cfg, d, cfg.d_ff) / 2.0
        return p
    if lt == "rglru":
        R, W = cfg.rnn_state_dim, cfg.conv1d_width
        p = float(2 * d * R + R * d + 2 * R * R + W * R)
        if cfg.d_ff:
            p += _glu(cfg, d, cfg.d_ff) / 2.0
        return p
    if lt == "mlstm":
        inner = 2 * d
        return float(2 * d * inner + 3 * inner * inner + inner * d)
    if lt == "slstm":
        dh = d // cfg.num_heads
        ff = int(4 / 3 * d)
        return float(4 * d * d + 4 * d * dh + d * d) + _glu(cfg, d, ff) / 2.0
    raise KeyError(lt)


def embed_head_bytes(cfg: ModelConfig) -> tuple[float, float]:
    """(embedding, lm-head) parameter bytes.  Tied heads report 0 extra —
    the matrix already lives with the embedding."""
    eb = float(cfg.vocab_padded) * cfg.d_model * BYTES[cfg.dtype]
    return eb, (0.0 if cfg.tie_embeddings else eb)


def head_flops_per_token(cfg: ModelConfig) -> float:
    return 2.0 * cfg.d_model * cfg.vocab_padded


def _layer_kv_bytes(cfg: ModelConfig, lt: str, S: int) -> float:
    """Per-sequence cache bytes of one block at context S (B=1 slice of
    ``_cache_bytes``)."""
    if lt == "attn":
        from repro_torch.models.blocks import attn_cache_capacity

        W = attn_cache_capacity(cfg, S)
        kv = 2.0 * W * cfg.num_kv_heads * cfg.head_dim * BYTES[cfg.dtype]
        if cfg.cross_attention:
            from repro_torch.configs import ENCDEC_DECODE_SRC_LEN

            kv += ENCDEC_DECODE_SRC_LEN * cfg.d_model * BYTES[cfg.dtype]
        return kv
    if lt == "rglru":
        return cfg.rnn_state_dim * 4.0
    if lt == "mlstm":
        dh = 2 * cfg.d_model // cfg.num_heads
        return cfg.num_heads * dh * dh * 4.0
    if lt == "slstm":
        return 4.0 * cfg.d_model * 4.0
    raise KeyError(lt)


def model_layer_costs(cfg: ModelConfig, S: int) -> list[LayerCost]:
    """Per-block cost profile of the decoder stack at reference context S.

    Parameter-byte calibration: analytic per-block params are scaled by one
    global factor so blocks + embedding + head == ``cfg.param_count()``
    (and the active-params variant == ``active_param_count()``), keeping
    placement's memory-fit and bandwidth roofs consistent with the meta-device
    parameter count.
    """
    types = cfg.layer_types
    dt = BYTES[cfg.dtype]
    raw = [_layer_params(cfg, lt, active=False) for lt in types]
    raw_act = [_layer_params(cfg, lt, active=True) for lt in types]
    eb, hb = embed_head_bytes(cfg)
    io_params = (eb + hb) / dt
    scale = max(cfg.param_count() - io_params, 0.0) / max(sum(raw), 1.0)
    scale_act = max(cfg.active_param_count() - io_params, 0.0) \
        / max(sum(raw_act), 1.0)
    return [
        LayerCost(
            index=i, kind=lt,
            prefill_flops=_block_flops_per_token(cfg, lt, S, True, False),
            decode_flops=_block_flops_per_token(cfg, lt, S, True, True),
            weight_bytes=raw[i] * scale * dt,
            active_weight_bytes=raw_act[i] * scale_act * dt,
            kv_bytes=_layer_kv_bytes(cfg, lt, S),
        )
        for i, lt in enumerate(types)
    ]
