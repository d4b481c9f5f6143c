"""Launch of the hand-written Hopper decode attention kernels.

Replace the Pallas TPU kernel ``decode_attention_kernel``
(``src/repro/kernels/decode_attention/kernel.py:77``, ``pallas_call`` at
:115).  The TPU kernel walks the cache sequentially for each (b, kv head);
here the cache is split along W across blocks (flash-decoding), and the
partial softmax states are combined.  Decode is bound by bytes on the H100
(the live cache is read once).  Two variants, chosen by one rule
(``route``):

* ``"tc"``, bf16 with G = H / Kv <= 16 and head_dim a multiple of 16 (every
  served model): ``decode_attention_tc_kernel`` in
  ``repro_torch/csrc/decode_attention_tc.cu``.  K and V tiles stay bf16 in
  shared memory and arrive through a 3-stage ``cp.async`` ring; Q K^T and
  P V run on ``mma.sync`` with the G heads padded to 16 rows, the softmax
  in registers; one wave of blocks (``tc_splits``), and a combine kernel
  only when W is split.
* ``"ffma"``, the rest (fp32): the first port's ``decode_partial_kernel``
  + ``decode_combine_kernel`` (``csrc/attention.cu``), fp32 tiles and
  FFMA, about ``BLOCKS_PER_SM`` blocks per SM (``splits``).

Each variant has an lse twin (a template flag of the same kernels, so the
served launch is untouched): the cache is the slice of global slots
``slot0 .. slot0 + W - 1`` of a cache of ``slots`` slots, the mask reads
global slot numbers, and lse (B, H) fp32 is written beside the output.
A rank of a cache sharded along its slots runs it on its slice
(``distributed/api.py: local_decode``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import kernel_library
from repro_torch.kernels.common import (on_device, raw_stream, record_kernel,
                                        sm_count)
from repro_torch.perf import spans

VARIANTS = ("tc", "ffma")
TILE = 64  # cache slots per tile of both variants (kTK, kTile)
BLOCKS_PER_SM = 8  # the FFMA variant's grid
TC_STAGES = 3  # the tensor-core variant's ring (kStages)
TC_ROWS = 16  # query heads per block, padded (kRows)
SM_SHARED_BYTES = 233472  # 228 KB of an H100 SM; 1 KB of it per block is
# the system's


def route(dtype: torch.dtype, G: int, head_dim: int) -> str:
    """The variant for decode inputs of ``dtype`` with G query heads per KV
    head that pass ``check_attention_inputs`` (head_dim a multiple of 16 up
    to 256)."""
    if dtype == torch.bfloat16 and G <= TC_ROWS and head_dim % 16 == 0:
        return "tc"
    return "ffma"


def splits(B: int, Kv: int, W: int, sms: int) -> tuple[int, int]:
    """FFMA variant: (slots per split, number of splits): enough splits
    that B * Kv * splits blocks fill ``sms`` SMs ``BLOCKS_PER_SM`` deep,
    each split a whole number of tiles."""
    want = max(1, -(-BLOCKS_PER_SM * sms // (B * Kv)))
    n = min(want, -(-W // TILE))
    split = -(-W // n)
    split = -(-split // TILE) * TILE
    return split, -(-W // split)


def tc_smem_bytes(head_dim: int) -> int:
    """Tensor-core variant: one block's shared memory, Q and a ring of K
    and V tiles in bf16 rows padded by 16 bytes (``smem_bytes`` in
    ``decode_attention_tc.cu``)."""
    ld = head_dim + 8
    return 2 * ld * (TC_ROWS + TC_STAGES * 2 * TILE)


def tc_blocks_per_sm(head_dim: int) -> int:
    """Blocks of the tensor-core variant that share one SM's shared
    memory: 2 up to head_dim 128, 1 above."""
    return max(1, SM_SHARED_BYTES // (tc_smem_bytes(head_dim) + 1024))


def tc_splits(B: int, Kv: int, W: int, sms: int,
              head_dim: int) -> tuple[int, int]:
    """Tensor-core variant: (slots per split, number of splits).  As many
    splits as keep B * Kv * splits blocks within one wave (every block
    resident at once), each a whole number of tiles; one split when B * Kv
    alone fills the wave, and then no combine."""
    n_tiles = -(-W // TILE)
    wave = tc_blocks_per_sm(head_dim) * sms
    n = max(1, min(wave // (B * Kv), n_tiles))
    split = -(-n_tiles // n) * TILE
    return split, -(-W // split)


def cost(B: int, H: int, Kv: int, hd: int, live: int, element_size: int,
         with_lse: bool = False) -> tuple[int, int]:
    """(FLOPs, bytes) of one decode launch over ``live`` visible slots: 4 G
    FLOPs per cached element pair (Q K^T and P V); q read, the live slots of
    K and V read once, out (and the twin's lse) written once."""
    flops = 4 * B * H * live * hd
    nbytes = element_size * (2 * B * H * hd + 2 * B * live * Kv * hd)
    return flops, nbytes + (4 * B * H if with_lse else 0)


def launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           cache_len: torch.Tensor, dtype_code: int, variant: str, *,
           ring: bool, chunk_attn: int, slot0: int = 0,
           slots: int | None = None, with_lse: bool = False,
           shape_only: bool = False):
    """(B, 1, H, hd) in q's dtype through ``variant``, and with
    ``with_lse`` (the twin, on global slots ``slot0 ..`` of ``slots``) also
    lse (B, H) fp32; the caller has validated the inputs and made
    ``cache_len`` a (1,) int32 tensor on the cache's device (and ``"tc"``
    takes only what ``route`` sends it).  ``shape_only`` (the shape route,
    fake tensors): the outputs' shapes, and the work of a launch over every
    slot (the dry run cannot read ``cache_len``)."""
    B, _, H, hd = q.shape
    W, Kv = k_cache.shape[1], k_cache.shape[2]
    if variant not in VARIANTS:
        raise ValueError(f"decode_attention: unknown variant {variant!r}")
    if variant == "tc" and route(q.dtype, H // Kv, hd) != "tc":
        raise ValueError(f"decode_attention: the tensor-core variant takes "
                         f"bf16 with G <= {TC_ROWS}, got {q.dtype}, "
                         f"G = {H // Kv}")
    slots = W if slots is None else slots
    if not with_lse and (slot0, slots) != (0, W):
        raise ValueError("decode_attention: a slice of a cache (slot0, "
                         "slots) runs on the lse twin")
    if not 0 <= slot0 <= slots - W:
        raise ValueError(f"decode_attention: slots {slot0} .. {slot0 + W} "
                         f"lie outside a cache of {slots}")
    out = torch.empty_like(q)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if shape_only:
        record_kernel("decode_attention" + ("_lse" if with_lse else ""),
                      cost(B, H, Kv, hd, W, q.element_size(), with_lse))
        return (out, lse) if with_lse else out
    dev = q.device
    if variant == "tc":
        split, n_splits = tc_splits(B, Kv, W, sm_count(dev), hd)
    else:
        split, n_splits = splits(B, Kv, W, sm_count(dev))
    parts = (None, None, None)
    if variant == "ffma" or n_splits > 1:  # (m, l, acc) of each split, in
        # one allocation: m and l (B, H, n_splits), acc (B, H, n_splits, hd)
        scratch = torch.empty(B * H * n_splits * (hd + 2),
                              dtype=torch.float32, device=dev)
        n = B * H * n_splits
        parts = (scratch.data_ptr(), scratch[n:].data_ptr(),
                 scratch[2 * n:].data_ptr())
    args = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            cache_len.data_ptr(), *parts, out.data_ptr())
    lib = kernel_library().lib
    with on_device(dev):
        stream = raw_stream(dev)
        if spans.on:
            spans.begin("launch")
        if with_lse:
            twin = (slot0, slots, lse.data_ptr(), stream)
            if variant == "tc":
                err = lib.decode_attention_tc_lse_launch(
                    *args, B, W, H, Kv, hd, split, n_splits, int(ring),
                    chunk_attn, *twin)
            else:
                err = lib.decode_attention_lse_launch(
                    *args, dtype_code, B, W, H, Kv, hd, split, n_splits,
                    int(ring), chunk_attn, *twin)
        elif variant == "tc":
            err = lib.decode_attention_tc_launch(
                *args, B, W, H, Kv, hd, split, n_splits, int(ring),
                chunk_attn, stream)
        else:
            err = lib.decode_attention_launch(
                *args, dtype_code, B, W, H, Kv, hd, split, n_splits,
                int(ring), chunk_attn, stream)
        if spans.on:
            spans.end()
    if err != 0:
        raise RuntimeError(f"decode_attention {variant} launch failed: CUDA "
                           f"error {err}")
    return (out, lse) if with_lse else out
