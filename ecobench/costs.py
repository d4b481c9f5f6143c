"""The yardstick's counts: the H100's peaks, the model FLOPs of a dense GQA
step, and the work of the two attention kernels, all from shapes.

These are frozen copies, kept with the benchmark so that a change to the
program cannot move them: ``cost`` of ``kernels/flash_attention/kernel.py``
and of ``kernels/decode_attention/kernel.py`` (4 hd FLOPs per visible
(query, key) pair; each input read once and the output written once), and
the model-FLOP count of ``perf/cost_model.py`` with one correction: a
prefill forms the logits of the last position only (``lm.logits_of``), so
the head is counted once per sequence and not once per prompt position.
"""
from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


@dataclass(frozen=True)
class Dims:
    """The sizes of a dense GQA decoder that the counts read."""
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int


def causal_pairs(S: int) -> int:
    """Visible (query, key) pairs of causal attention over S positions."""
    return S * (S + 1) // 2


def gemm_flops_per_token(m: Dims) -> int:
    """FLOPs of the per-layer products for one token, summed over the
    layers: q, k, v and o projections (GQA: k and v at ``kv_heads``) and the
    three products of the gated MLP."""
    qo = 2 * 2 * m.d_model * m.heads * m.head_dim
    kv = 2 * 2 * m.d_model * m.kv_heads * m.head_dim
    mlp = 3 * 2 * m.d_model * m.d_ff
    return m.layers * (qo + kv + mlp)


def head_flops(m: Dims) -> int:
    """The output head's product for one position."""
    return 2 * m.d_model * m.vocab


def prefill_flops(m: Dims, B: int, S: int) -> int:
    """Model FLOPs of one prefill of B prompts of S tokens: every product
    at every position, causal attention over the visible pairs, the head on
    the last position of each prompt."""
    attn = m.layers * 4 * m.heads * m.head_dim * causal_pairs(S)
    return B * (S * gemm_flops_per_token(m) + attn + head_flops(m))


def decode_flops(m: Dims, B: int, cache_len: int) -> int:
    """Model FLOPs of one decode step of B sequences whose cache holds
    ``cache_len`` positions including this token."""
    attn = m.layers * 4 * m.heads * m.head_dim * cache_len
    return B * (gemm_flops_per_token(m) + attn + head_flops(m))


def flash_cost(B: int, S: int, H: int, Kv: int, hd: int,
               element_size: int = 2) -> tuple[int, int]:
    """(FLOPs, bytes) of one causal prefill attention launch: 4 hd FLOPs a
    visible pair; q, k and v read once, out written once."""
    flops = 4 * B * H * hd * causal_pairs(S)
    nbytes = element_size * (2 * B * S * H * hd + 2 * B * S * Kv * hd)
    return flops, nbytes


def decode_cost(B: int, H: int, Kv: int, hd: int, live: int,
                element_size: int = 2) -> tuple[int, int]:
    """(FLOPs, bytes) of one decode attention launch over ``live`` cached
    positions: q read, the live K and V slots read once, out written once
    (the capacity past ``live`` is not read)."""
    flops = 4 * B * H * live * hd
    nbytes = element_size * (2 * B * H * hd + 2 * B * live * Kv * hd)
    return flops, nbytes


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the H100 could take: the larger of the compute and
    the memory term."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
