"""Launch of the hand-written Hopper prefill attention kernel.

Replaces the Pallas TPU kernel ``flash_attention_kernel``
(``src/repro/kernels/flash_attention/kernel.py:91``, ``pallas_call`` at
:119).  The CUDA source is ``repro_torch/csrc/attention.cu``; its header
comment states what bounds it on the card.  One block owns one
(b, h, 64-row query tile) and loops over 64-key tiles, skipping those
masked whole; query head h reads KV head ``h // (H // Kv)`` in place, so
nothing is repeated, transposed or padded.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import kernel_library


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dtype_code: int,
           *, causal: bool, window: int, chunk_attn: int) -> torch.Tensor:
    """(B, Sq, H, hd) in q's dtype; the caller has validated the inputs."""
    B, Sq, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = kernel_library().lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dtype_code, B, Sq, Skv, H, Kv, hd, int(causal), window,
            chunk_attn, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    return out
