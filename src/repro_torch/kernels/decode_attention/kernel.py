"""Launch of the hand-written Hopper decode attention kernel.

Replaces the Pallas TPU kernel ``decode_attention_kernel``
(``src/repro/kernels/decode_attention/kernel.py:77``, ``pallas_call`` at
:115).  The CUDA source is ``repro_torch/csrc/attention.cu``; its header
comment states what bounds it on the card.  The TPU kernel walks the cache
sequentially for each (b, kv head); here the cache is split along W over
about ``BLOCKS_PER_SM`` blocks per SM (flash-decoding), and a second kernel
combines the partial softmax states.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.build import kernel_library

TILE = 64  # cache slots per tile (kTK in attention.cu)
BLOCKS_PER_SM = 8


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def splits(B: int, Kv: int, W: int, sms: int) -> tuple[int, int]:
    """(slots per split, number of splits): enough splits that B * Kv *
    splits blocks fill ``sms`` SMs ``BLOCKS_PER_SM`` deep, each split a
    whole number of tiles."""
    want = max(1, -(-BLOCKS_PER_SM * sms // (B * Kv)))
    n = min(want, -(-W // TILE))
    split = -(-W // n)
    split = -(-split // TILE) * TILE
    return split, -(-W // split)


def launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           cache_len: torch.Tensor, dtype_code: int, *, ring: bool,
           chunk_attn: int) -> torch.Tensor:
    """(B, 1, H, hd) in q's dtype; the caller has validated the inputs and
    made ``cache_len`` a (1,) int32 tensor on the cache's device."""
    B, _, H, hd = q.shape
    W, Kv = k_cache.shape[1], k_cache.shape[2]
    dev = q.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    split, n_splits = splits(B, Kv, W, _sm_count(index))
    part_m = torch.empty((B, H, n_splits), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, H, n_splits, hd), dtype=torch.float32,
                           device=dev)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = kernel_library().lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            cache_len.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
            part_acc.data_ptr(), out.data_ptr(), dtype_code, B, W, H, Kv, hd,
            split, n_splits, int(ring), chunk_attn,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {err}")
    return out
