"""Launch of the hand-written Hopper prefill attention kernels.

Replace the Pallas TPU kernel ``flash_attention_kernel``
(``src/repro/kernels/flash_attention/kernel.py:91``, ``pallas_call`` at
:119).  Query head h reads KV head ``h // (H // Kv)`` in place, so nothing
is repeated, transposed or padded.  Causal prefill is bound by operations
on the H100 (4 hd FLOPs per visible query-key pair, hundreds per byte).

* ``"tc"``, bf16: ``flash_attention_tc_kernel``
  (``repro_torch/csrc/flash_attention_tc.cu``), the FA3 shape: TMA loads Q
  once and K/V tiles through a two-stage mbarrier ring, two consumer
  warpgroups run Q K^T and P V on the tensor cores (wgmma), the online
  softmax stays in registers.  TMA needs 16-byte global strides, which the
  attention contract (head_dim a multiple of 16) already gives in bf16.
* ``"ffma"``, fp32: ``flash_attention_kernel`` (``csrc/attention.cu``), the
  first port's design: fp32 tiles in shared memory and a 4 x 4 FFMA score
  tile per thread, one block per (b, h, 64-row query tile).

Training launches each variant's lse twin (a template flag of the same
kernel, so the serving variant is untouched), which also writes lse (B, H,
Sq) in fp32, and the backward ``csrc/flash_attention_bwd.cu`` (``launch_bwd``):
a delta kernel, then a dK/dV kernel over KV tiles and a dQ kernel over query
tiles, deterministic (no atomics).  Its variants (``route_bwd``):
``"tc"``, bf16, on wgmma fed by TMA (the forward's shape; its delta
kernel also packs lse * log2(e) and delta into one scratch padded to 64
rows, so that both load by bulk copy): one pair up to head_dim 128, a wide
pair above it (up to 256), whose two consumer warpgroups split the head
dimension of dK and dV, and whose dK/dV blocks may split a KV group's query
heads (``bwd_head_splits``); ``"ffma"``, fp32, on the CUDA cores.

With ``shape_only`` (the ops wrapper's shape route for fake tensors, the
dry run) ``launch`` and ``launch_bwd`` check the same route and return
their outputs' shapes without a launch, reporting ``cost`` / ``cost_bwd``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import kernel_library
from repro_torch.kernels.common import (KERNEL_DTYPES, on_device, raw_stream,
                                        record_kernel, sm_count)
from repro_torch.kernels.flash_attention.ref import visible_pairs

VARIANTS = ("tc", "ffma")
WIDE_KEYS = 64  # keys of a block of the wide dK/dV kernel (head_dim > 128)


def cost(B: int, Sq: int, Skv: int, H: int, Kv: int, hd: int,
         element_size: int, *, causal: bool, window: int, chunk_attn: int,
         with_lse: bool = False) -> tuple[int, int]:
    """(FLOPs, bytes) of one forward launch: 4 hd FLOPs per visible (query,
    key) pair (``visible_pairs``); q, k and v read once, out (and the
    twin's lse, fp32) written once."""
    pairs = visible_pairs(Sq, Skv, causal=causal, window=window,
                          chunk_attn=chunk_attn)
    nbytes = element_size * (2 * B * Sq * H * hd + 2 * B * Skv * Kv * hd)
    return 4 * B * H * hd * pairs, nbytes + (4 * B * H * Sq if with_lse
                                              else 0)


def cost_bwd(B: int, Sq: int, Skv: int, H: int, Kv: int, hd: int,
             element_size: int, *, causal: bool, window: int,
             chunk_attn: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one backward launch: 10 hd FLOPs per visible pair
    (S and dP recomputed, dV, dK and dQ); q, out, dout, k, v and lse read
    once, dq, dk and dv written once."""
    pairs = visible_pairs(Sq, Skv, causal=causal, window=window,
                          chunk_attn=chunk_attn)
    nbytes = element_size * (3 * B * Sq * H * hd + 2 * B * Skv * Kv * hd) \
        + 4 * B * H * Sq \
        + element_size * (B * Sq * H * hd + 2 * B * Skv * Kv * hd)
    return 10 * hd * B * H * pairs, nbytes


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The variant for attention inputs of ``dtype`` that pass
    ``check_attention_inputs`` (head_dim a multiple of 16 up to 256)."""
    if dtype == torch.bfloat16 and head_dim % 16 == 0 and head_dim <= 256:
        return "tc"
    return "ffma"


def route_bwd(dtype: torch.dtype, head_dim: int) -> str:
    """The backward's variant for inputs that pass
    ``check_attention_inputs`` (head_dim a multiple of 16 up to 256)."""
    if dtype == torch.bfloat16 and head_dim <= 256:
        return "tc"
    return "ffma"


def bwd_head_splits(B: int, Skv: int, Kv: int, H: int, head_dim: int,
                    sms: int) -> int:
    """How many dK/dV blocks share the G = H / Kv query heads of one KV
    group in the tensor-core backward (each walks a contiguous run of them,
    and a second kernel adds their fp32 partials in run order).

    Only the wide kernel (head_dim > 128) splits, and only where its grid,
    B Kv ceil(Skv / 64) blocks of one an SM (its shared memory leaves room
    for no second), is under one wave of ``sms`` blocks.  Then the heads are
    cut into the fewest equal runs (a divisor of G) that make two waves, or
    into G: under a causal or window mask the key tiles carry unequal work,
    and two waves of smaller blocks let the SMs even it out.
    RecurrentGemma-2B trains at B 1, Skv 4096, one KV head of 10: 64
    blocks, 5 runs of 2 heads (on the H100 faster than 1, 2 or 10 runs,
    PERF.md).  Otherwise 1."""
    blocks = B * Kv * -(-Skv // WIDE_KEYS)
    if head_dim <= 128 or blocks >= sms:
        return 1
    G = H // Kv
    return next(d for d in range(1, G + 1)
                if G % d == 0 and (blocks * d >= 2 * sms or d == G))


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, variant: str,
           *, causal: bool, window: int, chunk_attn: int,
           with_lse: bool = False, shape_only: bool = False):
    """(B, Sq, H, hd) in q's dtype through ``variant``, and with ``with_lse``
    also lse (B, H, Sq) fp32 (the training twin); the caller has validated
    the inputs (and ``"tc"`` takes only what ``route`` sends it).
    ``shape_only`` (the shape route, fake tensors): the outputs' shapes and
    the launch's work, no launch."""
    B, Sq, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    if variant not in VARIANTS:
        raise ValueError(f"flash_attention: unknown variant {variant!r}")
    if variant == "tc" and route(q.dtype, hd) != "tc":
        raise ValueError(f"flash_attention: the tensor-core variant takes "
                         f"bf16, got {q.dtype}")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if shape_only:
        record_kernel("flash_attention" + ("_lse" if with_lse else ""), cost(
            B, Sq, Skv, H, Kv, hd, q.element_size(), causal=causal,
            window=window, chunk_attn=chunk_attn, with_lse=with_lse))
        return (out, lse) if with_lse else out
    lib = kernel_library().lib
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr())
    masks = (int(causal), window, chunk_attn)
    with on_device(q.device):
        stream = raw_stream(q.device)
        if variant == "tc":
            err = lib.flash_attention_tc_launch(*ptrs, B, Sq, Skv, H, Kv, hd,
                                                *masks, stream)
        else:
            err = lib.flash_attention_launch(*ptrs, KERNEL_DTYPES[q.dtype], B,
                                             Sq, Skv, H, Kv, hd, *masks,
                                             stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {variant} launch failed: "
                           f"error {err}")
    return (out, lse) if with_lse else out


def launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
               variant: str, *, causal: bool, window: int, chunk_attn: int,
               shape_only: bool = False):
    """(dq, dk, dv) in the inputs' dtype from ``csrc/flash_attention_bwd.cu``
    through ``variant``; the caller has validated q, k, v, out and dout (one
    dtype, contiguous) and lse (B, H, Sq) fp32 contiguous (and ``"tc"``
    takes only what ``route_bwd`` sends it).  ``shape_only``: as in
    ``launch``."""
    B, Sq, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    if variant not in VARIANTS:
        raise ValueError(f"flash_attention backward: unknown variant "
                         f"{variant!r}")
    if variant == "tc" and route_bwd(q.dtype, hd) != "tc":
        raise ValueError(f"flash_attention backward: the tensor-core variant "
                         f"takes bf16 with head_dim <= 256, got {q.dtype}, "
                         f"{hd}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if shape_only:
        record_kernel("flash_attention_bwd", cost_bwd(
            B, Sq, Skv, H, Kv, hd, q.element_size(), causal=causal,
            window=window, chunk_attn=chunk_attn))
        return dq, dk, dv
    # "tc": lse * log2(e) and delta side by side, rows padded to 64
    shape = (B, H, 2, -(-Sq // 64) * 64) if variant == "tc" else (B, H, Sq)
    delta = torch.empty(shape, dtype=torch.float32, device=q.device)
    splits = bwd_head_splits(B, Skv, Kv, H, hd, sm_count(q.device)) \
        if variant == "tc" else 1
    # the splits' fp32 dK and dV partials
    part = torch.empty((2, splits, k.numel()), dtype=torch.float32,
                       device=q.device) if splits > 1 else None
    lib = kernel_library().lib
    with on_device(q.device):
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), KERNEL_DTYPES[q.dtype], B, Sq, Skv,
            H, Kv, hd, int(causal), window, chunk_attn, int(variant == "tc"),
            splits, None if part is None else part.data_ptr(),
            raw_stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: error "
                           f"{err}")
    return dq, dk, dv
