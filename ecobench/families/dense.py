"""A dense GQA decoder (RMSNorm, RoPE, gated SiLU MLP): its sizes, its
weights made from the seed, the same weights in the tree that
``repro_torch.models.lm`` reads, and what the harness counts of it.

The weights are made on the device in the served dtype, one call per
stacked tensor, in a flat dict that the reference reads as it is; the
port's tree holds the same tensors (no copy).

A family is what the harness (``harness.py``'s docstring) asks of an
architecture: ``check``, ``dims``, ``port_config``, ``make_weights``,
``port_params``, and the counts that depend on it: the model FLOPs
(``prefill_flops``, ``decode_flops``, from the frozen ``costs``), the
launches its path must show (``launches``) and the kernels whose roofline
the benchmark reads (``kernel_bounds``).  Another architecture brings a
module of its own beside this one and leaves this one as it is.
"""
from __future__ import annotations

import math

from ecobench import costs
from ecobench.costs import Dims
from ecobench.harness import KernelBound
from ecobench.traffic import subseed

# the served ops, whose counters the gate reads, and the kernels of each in
# the trace (decode's split combine timed with it, not counted as a launch)
FLASH_OP = "repro_torch.kernels.flash_attention.ops.flash_attention"
DECODE_OP = "repro_torch.kernels.decode_attention.ops.decode_attention"
FLASH_KERNELS = ("flash_attention_tc_kernel",)
DECODE_KERNELS = ("decode_attention_tc_kernel", "decode_tc_combine_kernel")


def dims(c: dict) -> Dims:
    return Dims(layers=c["num_hidden_layers"], d_model=c["hidden_size"],
                heads=c["num_attention_heads"],
                kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
                d_ff=c["intermediate_size"], vocab=c["vocab_size"])


def prefill_flops(c: dict, B: int, S: int) -> int:
    return costs.prefill_flops(dims(c), B, S)


def decode_flops(c: dict, B: int, cache_len: int) -> int:
    return costs.decode_flops(dims(c), B, cache_len)


def launches(c: dict, batches, on_card: bool) -> dict:
    """On the card one tensor-core flash_attention a layer a prefill and
    one tensor-core decode_attention a layer a decode step, nothing else;
    on the CPU (the plain versions) none."""
    L = c["num_hidden_layers"]
    flash = L * len(batches) if on_card else 0
    dec = L * sum(b.steps for b in batches) if on_card else 0
    return {FLASH_OP: {"launches": flash, "launches_tc": flash,
                       "launches_ffma": 0, "launches_lse": 0},
            DECODE_OP: {"launches": dec, "launches_tc": dec,
                        "launches_ffma": 0, "launches_lse": 0}}


def kernel_bounds(c: dict, batches) -> dict:
    """The two attention kernels over ``batches``: one flash launch a
    layer a prefill at its shape (``costs.flash_cost``), one decode launch
    a layer a step over the live cache, S + t + 1 positions at step t
    (``costs.decode_cost``)."""
    m = dims(c)
    steps = sum(b.steps for b in batches)
    flash = sum(m.layers * costs.bound_s(*costs.flash_cost(
        b.B, b.S, m.heads, m.kv_heads, m.head_dim)) for b in batches)
    dec = sum(m.layers * costs.bound_s(*costs.decode_cost(
        b.B, m.heads, m.kv_heads, m.head_dim, b.S + t + 1))
        for b in batches for t in range(b.steps))
    return {"flash_attention": KernelBound(
                FLASH_KERNELS, FLASH_KERNELS, m.layers * len(batches), flash),
            "decode_attention": KernelBound(
                DECODE_KERNELS, DECODE_KERNELS[:1], m.layers * steps, dec)}


def check(c: dict) -> None:
    """Refuse a configuration this family does not compute as stated."""
    if c["hidden_act"] != "silu":
        raise ValueError(f"{c['name']}: hidden_act {c['hidden_act']!r}")
    if c["head_dim"] * c["num_attention_heads"] != c["hidden_size"]:
        raise ValueError(f"{c['name']}: head_dim x heads != hidden_size")
    if c["num_attention_heads"] % c["num_key_value_heads"]:
        raise ValueError(f"{c['name']}: heads not a multiple of kv heads")
    for key in ("bias", "attention_bias", "mlp_bias"):
        if c.get(key):
            raise ValueError(f"{c['name']}: {key} is not computed")


def port_config(c: dict):
    """The port's ``ModelConfig`` for ``c``, every size and constant as the
    file states it."""
    from repro_torch.models.config import ModelConfig

    check(c)
    return ModelConfig(
        name=c["name"], family="dense", num_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], num_heads=c["num_attention_heads"],
        num_kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
        activation="swiglu", rope_theta=float(c["rope_theta"]),
        norm_eps=float(c["rms_norm_eps"]),
        tie_embeddings=bool(c["tie_word_embeddings"]),
        dtype=c["torch_dtype"])


def padded_vocab(c: dict) -> int:
    """The port's embedding rows: the vocabulary rounded up to 16."""
    return (c["vocab_size"] + 15) // 16 * 16


def make_weights(torch, c: dict, seed: int, device) -> dict:
    """Random weights from ``seed``: one normal draw per stacked tensor, in
    the served dtype on ``device``, scaled by 1/sqrt(fan_in); embedding
    rows N(0, 0.02) (the tied head too); norm weights N(0, 0.1), read as the
    gain 1 + w."""
    check(c)
    dt = getattr(torch, c["torch_dtype"])
    L, D, F = c["num_hidden_layers"], c["hidden_size"], c["intermediate_size"]
    H, Kv, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                 c["head_dim"])
    V = padded_vocab(c)
    gen = torch.Generator(device=device)
    gen.manual_seed(subseed(seed, "weights"))

    def draw(shape, scale):
        w = torch.randn(shape, generator=gen, device=device, dtype=dt)
        return w.mul_(scale)

    w = {
        "embed": draw((V, D), 0.02),
        "final_norm": draw((D,), 0.1),
        "ln1": draw((L, D), 0.1),
        "ln2": draw((L, D), 0.1),
        "wq": draw((L, D, H, hd), 1 / math.sqrt(D)),
        "wk": draw((L, D, Kv, hd), 1 / math.sqrt(D)),
        "wv": draw((L, D, Kv, hd), 1 / math.sqrt(D)),
        "wo": draw((L, H, hd, D), 1 / math.sqrt(H * hd)),
        "w_gate": draw((L, D, F), 1 / math.sqrt(D)),
        "w_up": draw((L, D, F), 1 / math.sqrt(D)),
        "w_down": draw((L, F, D), 1 / math.sqrt(F)),
    }
    if not c["tie_word_embeddings"]:
        w["head"] = draw((D, V), 1 / math.sqrt(D))
    return w


def port_params(w: dict) -> dict:
    """The tree ``repro_torch.models.lm`` reads, over the same tensors: the
    layers stacked along a leading axis (the port's ``scan_layers``)."""
    p = {
        "embed": w["embed"],
        "final_norm": w["final_norm"],
        "stack": {"units": {"b0": {
            "ln1": w["ln1"], "ln2": w["ln2"],
            "attn": {k: w[k] for k in ("wq", "wk", "wv", "wo")},
            "mlp": {k: w[k] for k in ("w_gate", "w_up", "w_down")},
        }}},
    }
    if "head" in w:
        p["head"] = w["head"]
    return p
