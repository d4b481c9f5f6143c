"""Language model assembly of the model substrate, in PyTorch.

The JAX package's ``models/lm.py`` for every family it builds: dense, MoE,
recurrent (xLSTM) and hybrid (RG-LRU + local attention) stacks with a
repeating block pattern, the encoder-decoder composition (a bidirectional
encoder over stub audio frames, cross-attention in the decoder) and the
vision stub whose patch embeddings replace the first token slots; train /
prefill / decode execution modes with fixed-capacity caches, and the
weight carry from the JAX package's parameter tree.  Parameters are a
plain dict of tensors whose tree is the JAX one (``embed``,
``final_norm``, ``head``, ``stack.units[i].b0.attn.wq``, ...).  With
``cfg.scan_layers`` the units are stacked along a leading layer axis, as
the JAX package stacks them for ``lax.scan``; the port runs a Python loop
over views of that axis.  Caches are updated in place.  ``train_loss`` is the
training objective; with ``cfg.scan_layers and cfg.remat`` a train-mode
stack recomputes each unit in the backward (``torch.utils.checkpoint``), as
the JAX stack ``jax.checkpoint``s its scanned unit.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import api
from repro_torch.distributed.api import constrain
from repro_torch.kernels.common import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import tree_leaves, tree_map

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# layer-stack structure
# ---------------------------------------------------------------------------

def _pattern(cfg: ModelConfig) -> tuple[tuple[str, ...], int, tuple[str, ...]]:
    """Returns (unit_pattern, n_units, remainder_types)."""
    pat = cfg.block_pattern if cfg.block_pattern else ("attn",)
    n_units = cfg.num_layers // len(pat)
    rest = cfg.layer_types[n_units * len(pat):]
    return pat, n_units, rest


def _stack(trees: list):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _unit(units, i: int, stacked: bool):
    """Unit i of a stack: a view into the stacked layer axis, or the i-th
    entry of the per-unit list."""
    return tree_map(lambda t: t[i], units) if stacked else units[i]


def _encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The encoder stack of an encoder-decoder: attention blocks with a
    dense FFN and no cross-attention."""
    return cfg.with_overrides(num_layers=cfg.num_encoder_layers,
                              block_pattern=(), num_experts=0,
                              cross_attention=False)


def _init_unit(gen, pat: tuple[str, ...], cfg: ModelConfig, device,
               cross: bool) -> Params:
    return {f"b{j}": B.init_block(bt, gen, cfg, device, cross=cross)
            for j, bt in enumerate(pat)}


def init_stack(gen, cfg: ModelConfig, device, cross: bool = False) -> Params:
    """The layer stack's parameters.  The stacked layout allocates each
    ``(n_units, ...)`` tensor once and writes every unit into its slot as
    it is drawn, so the stack is never held twice; the generator is drawn
    in the same order for both layouts, so they hold the same values.
    ``cross`` adds cross-attention to the attention blocks."""
    pat, n_units, rest = _pattern(cfg)
    if cfg.scan_layers:
        units = None
        for i in range(n_units):
            unit = _init_unit(gen, pat, cfg, device, cross)
            if units is None:
                units = tree_map(lambda t: t.new_empty((n_units, *t.shape)),
                                 unit)
            tree_map(lambda slot, t: slot[i].copy_(t), units, unit)
            del unit  # free it before the next unit is drawn
    else:
        units = [_init_unit(gen, pat, cfg, device, cross)
                 for _ in range(n_units)]
    p: Params = {"units": units}
    if rest:
        p["rest"] = [B.init_block(bt, gen, cfg, device, cross=cross)
                     for bt in rest]
    return p


def init_stack_cache(cfg: ModelConfig, batch: int, capacity: int,
                     device) -> Params:
    pat, n_units, rest = _pattern(cfg)

    def unit_cache():
        return {f"b{j}": B.init_block_cache(bt, cfg, batch, capacity, device)
                for j, bt in enumerate(pat)}

    if cfg.scan_layers:  # every unit starts from the block's initial state
        units = tree_map(lambda t: t.new_empty((n_units, *t.shape)).copy_(t),
                         unit_cache())
    else:
        units = [unit_cache() for _ in range(n_units)]
    c: Params = {"units": units}
    if rest:
        c["rest"] = [B.init_block_cache(bt, cfg, batch, capacity, device)
                     for bt in rest]
    return c


def apply_stack(params: Params, x: torch.Tensor, ctx: B.BlockCtx,
                cfg: ModelConfig, cache: Optional[Params] = None,
                encoder_out: Optional[torch.Tensor] = None):
    """Run the full layer stack. Returns (x, cache, aux).

    Prefill and decode return the stack's cache: ``cache`` itself, updated
    in place, or, for a prefill given none, a new one of capacity
    ``ctx.capacity`` that each layer fills.
    """
    pat, n_units, rest = _pattern(cfg)
    want_cache = ctx.mode in ("prefill", "decode")
    if want_cache and cache is None:
        capacity = ctx.capacity or x.shape[1]
        if api.is_dtensor(x):  # each rank's shard, by the policy's rules
            cache = api.place_cache(
                init_stack_cache(cfg, x.shape[0], capacity, "meta"),
                init_stack_cache(cfg, 1, 1, x.device))
        else:
            cache = init_stack_cache(cfg, x.shape[0], capacity, x.device)
    remat = cfg.scan_layers and cfg.remat and ctx.mode == "train" and \
        torch.is_grad_enabled()

    def run_unit(x, unit_params, unit_cache):
        # under a policy: the unit's weights gathered over the data axes
        # (inside the remat unit, so that the backward gathers them again)
        unit_params = api.fsdp_gather(unit_params)
        aux_u = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, bt in enumerate(pat):
            c_j = None if unit_cache is None else unit_cache[f"b{j}"]
            x, _, aux = B.apply_block(bt, unit_params[f"b{j}"], x, ctx, cfg,
                                      c_j, encoder_out)
            aux_u = aux_u + aux
        return x, aux_u

    # training takes the stacked leaves apart once (``unbind``): a backward
    # pass then stacks each leaf's gradient once, where one view per unit
    # would add a zero-filled full-size gradient per unit
    units = params["units"]
    split = cfg.scan_layers and ctx.mode == "train"
    if split:
        units = tree_map(lambda t: t.unbind(0), units)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_units):
        unit_params = tree_map(lambda parts: parts[i], units) if split \
            else _unit(units, i, cfg.scan_layers)
        unit_cache = _unit(cache["units"], i, cfg.scan_layers) \
            if want_cache else None
        if remat:  # the backward recomputes the unit from x
            x, aux = checkpoint(run_unit, x, unit_params, None,
                                use_reentrant=False,
                                context_fn=api.checkpoint_context)
        else:
            x, aux = run_unit(x, unit_params, unit_cache)
        aux_total = aux_total + aux
    for i, bt in enumerate(rest):
        c_i = cache["rest"][i] if want_cache else None
        x, _, aux = B.apply_block(bt, api.fsdp_gather(params["rest"][i]), x,
                                  ctx, cfg, c_i, encoder_out)
        aux_total = aux_total + aux
    return x, (cache if want_cache else None), aux_total


# ---------------------------------------------------------------------------
# full LM (dense / moe / ssm / hybrid / vlm / encoder-decoder)
# ---------------------------------------------------------------------------

def init_params(gen: Optional[torch.Generator], cfg: ModelConfig,
                device=None) -> Params:
    """Random weights from ``gen`` on its device (or on ``device``).  With
    ``gen=None`` the tensors are only allocated: ``count_params`` uses that
    on the ``meta`` device."""
    device = device if device is not None else gen.device
    dt, D = cfg.activation_dtype, cfg.d_model
    p: Params = {
        "embed": L.embed_init(gen, cfg.vocab_padded, D, dt, device),
        "final_norm": L.init_rmsnorm(D, dt, device),
    }
    if cfg.num_encoder_layers:
        p["encoder"] = {
            "stack": init_stack(gen, _encoder_config(cfg), device),
            "final_norm": L.init_rmsnorm(D, dt, device),
        }
        p["stack"] = init_stack(gen, cfg, device, cross=True)
    else:
        p["stack"] = init_stack(gen, cfg, device)
    if cfg.frontend:
        p["frontend_norm"] = L.init_rmsnorm(D, dt, device)
        p["frontend_proj"] = L.dense_init(gen, D, (D,), dt, device)
    if not cfg.tie_embeddings:
        p["head"] = L.dense_init(gen, cfg.d_model, (cfg.vocab_padded,), dt,
                                 device)
    return p


def _lm_head(params: Params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["head"]


def _embed_tokens(params: Params, cfg: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    if api.is_dtensor(params["embed"], tokens):  # each rank's batch rows
        x = api.local_embed(params["embed"], tokens)
    else:
        x = params["embed"][tokens]
    if cfg.name.startswith("gemma") or cfg.name.startswith("recurrentgemma"):
        # the scale rounded to the activation dtype, as the JAX package has it
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    return constrain(x, "act_btd")


def _merge_frontend(params: Params, cfg: ModelConfig, x: torch.Tensor,
                    frontend: Optional[torch.Tensor]) -> torch.Tensor:
    """VLM: precomputed patch embeddings (B, P, D), projected and normed,
    replace the first P token slots."""
    if frontend is None or not cfg.frontend:
        return x
    f = frontend.to(x.dtype) @ api.fsdp_gather(params["frontend_proj"])
    f = L.rms_norm(f, params["frontend_norm"], cfg.norm_eps)
    P = f.shape[1]
    if x.shape[1] == P:
        return f
    return torch.cat([f, x[:, P:]], dim=1)


def encode(params: Params, cfg: ModelConfig,
           frontend: torch.Tensor) -> torch.Tensor:
    """Encoder pass (enc-dec archs). ``frontend``: (B, T_src, D) stub
    frames, projected and normed, then bidirectional blocks at positions
    [0..T_src)."""
    enc_cfg = _encoder_config(cfg)
    f = frontend.to(cfg.activation_dtype) @ api.fsdp_gather(
        params["frontend_proj"])
    x = L.rms_norm(f, params["frontend_norm"], cfg.norm_eps)
    S = x.shape[1]
    ctx = B.BlockCtx(mode="train",
                     positions=torch.arange(S, device=x.device)[None])
    units = params["encoder"]["stack"]["units"]
    for i in range(_pattern(enc_cfg)[1]):
        unit = api.fsdp_gather(_unit(units, i, enc_cfg.scan_layers))
        x, _, _ = B.apply_bidir_attn_block(unit["b0"], x, ctx, enc_cfg)
    return L.rms_norm(x, params["encoder"]["final_norm"], cfg.norm_eps)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            mode: str = "train", frontend: Optional[torch.Tensor] = None,
            cache: Optional[Params] = None, cache_len=None, capacity: int = 0,
            encoder_out: Optional[torch.Tensor] = None):
    """Backbone forward. Returns (hidden (B,S,D), cache, aux).

    ``cache_len`` (decode): the tokens processed including this one, an int
    or a 0-d int tensor on the model's device.  An encoder-decoder takes
    ``encoder_out``, or encodes ``frontend`` when it is not given; a VLM
    merges ``frontend`` into the prompt (not at decode).
    """
    Bsz, S = tokens.shape
    if mode == "decode":
        if isinstance(cache_len, torch.Tensor):
            positions = (cache_len.reshape(1, 1) - 1).expand(Bsz, 1)
        else:
            positions = torch.full((Bsz, 1), cache_len - 1,
                                   device=tokens.device)
        ctx = B.BlockCtx(mode=mode, positions=positions, cache_len=cache_len,
                         capacity=capacity)
    else:
        positions = torch.arange(S, device=tokens.device)[None].expand(Bsz, S)
        ctx = B.BlockCtx(mode=mode, positions=positions, capacity=capacity or S)
    x = _embed_tokens(params, cfg, tokens)
    if cfg.num_encoder_layers:
        if encoder_out is None:
            if frontend is None:
                raise ValueError(f"{cfg.name}: an encoder-decoder forward "
                                 "needs encoder_out or frontend")
            encoder_out = encode(params, cfg, frontend)
    elif mode != "decode":
        x = _merge_frontend(params, cfg, x, frontend)
    x, new_cache, aux = apply_stack(params["stack"], x, ctx, cfg, cache=cache,
                                    encoder_out=encoder_out)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, new_cache, aux


def train_loss(params: Params, cfg: ModelConfig,
               batch: dict) -> tuple[torch.Tensor, dict]:
    """The training objective (``lm.py:283`` in the JAX package): batch
    {"tokens": (B, S), "labels": (B, S), optional "mask" (B, S) and
    "frontend"}; returns (loss, {"nll", "z_loss", "aux_loss"}), loss = nll +
    z_loss + aux_loss (the MoE load-balance term), all fp32 0-d."""
    hidden, _, aux = forward(params, cfg, batch["tokens"], mode="train",
                             frontend=batch.get("frontend"))
    nll, zl = L.chunked_cross_entropy(
        hidden, _lm_head(params, cfg), batch["labels"],
        mask=batch.get("mask"), logit_cap=cfg.logit_softcap,
        valid_vocab=cfg.vocab_size)
    loss = nll + zl + aux
    return loss, {"nll": nll, "z_loss": zl, "aux_loss": aux}


def logits_of(params: Params, cfg: ModelConfig,
              hidden: torch.Tensor) -> torch.Tensor:
    """(B, vocab_size) fp32 logits of the last position of ``hidden``: the
    product in the activation dtype, softcapped, cut from ``vocab_padded``."""
    logits = (hidden[:, -1] @ _lm_head(params, cfg)).float()
    return L.softcap(logits, cfg.logit_softcap)[:, :cfg.vocab_size]


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            frontend: Optional[torch.Tensor] = None, capacity: int = 0,
            encoder_out: Optional[torch.Tensor] = None):
    """Process a prompt; returns (last-token logits, cache)."""
    hidden, cache, _ = forward(params, cfg, tokens, mode="prefill",
                               frontend=frontend,
                               capacity=capacity or tokens.shape[1],
                               encoder_out=encoder_out)
    return logits_of(params, cfg, hidden), cache


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params, cache_len, *, capacity: int,
                encoder_out: Optional[torch.Tensor] = None):
    """One decode step. ``token``: (B,1). ``cache_len``: valid entries incl.
    this token. Returns (logits (B,V), cache), the cache updated in place."""
    hidden, new_cache, _ = forward(params, cfg, token, mode="decode",
                                   cache=cache, cache_len=cache_len,
                                   capacity=capacity, encoder_out=encoder_out)
    return logits_of(params, cfg, hidden), new_cache


def count_params(cfg: ModelConfig) -> int:
    params = init_params(None, cfg, device="meta")
    return sum(t.numel() for t in tree_leaves(params))


# ---------------------------------------------------------------------------
# weight carry from and to the JAX package's parameter tree
# ---------------------------------------------------------------------------

def _to_tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: carry the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)  # never alias the live params
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only bf16 trees need it

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(np_params: Params, cfg: ModelConfig, *,
                      device="cuda") -> Params:
    """The port's parameters from the JAX package's ``lm.init_params`` tree
    (numpy arrays, or anything ``np.asarray`` takes), in either layout of
    the units: stacked along a leading layer axis (``scan_layers=True``) or
    a per-unit list.  The result has the layout ``cfg.scan_layers`` asks
    for, bit for bit the same values; an encoder-decoder's encoder stack
    too."""
    dev = resolve_device(device)
    params = tree_map(lambda a: _to_tensor(a, dev), np_params)
    stacks = [(params["stack"], cfg)]
    if "encoder" in params:
        stacks.append((params["encoder"]["stack"], _encoder_config(cfg)))
    for stack, c in stacks:
        units = stack["units"]
        if cfg.scan_layers and isinstance(units, list):
            stack["units"] = _stack(units)
        elif not cfg.scan_layers and isinstance(units, dict):
            stack["units"] = [tree_map(lambda t: t[i].clone(), units)
                              for i in range(_pattern(c)[1])]
    return params


def params_to_numpy(params: Params) -> Params:
    """The parameters as numpy arrays in the same tree (bf16 as
    ``ml_dtypes.bfloat16``, as the JAX package holds it)."""
    return tree_map(_to_numpy, params)
