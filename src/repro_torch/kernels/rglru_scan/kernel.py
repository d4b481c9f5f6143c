"""Launch of the hand-written Hopper RG-LRU scan kernel.

Replaces the Pallas TPU kernel ``rglru_scan_kernel``
(``src/repro/kernels/rglru_scan/kernel.py:41``, ``pallas_call`` at :54).
The CUDA source is ``repro_torch/csrc/rglru_scan.cu``; its header comment
states what bounds it on the card.  One thread owns one (b, r) channel and
carries its state in a register along S; the TPU kernel's sequential chunk
grid axis and VMEM carry become that loop, and its padding of R to 128
lanes and of S to the chunk becomes a bounds check.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import kernel_library


def launch(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor,
           dtype_code: int) -> torch.Tensor:
    """(B, S, R) fp32; the caller has validated the inputs and made h0 a
    contiguous fp32 (B, R) tensor."""
    B, S, R = a.shape
    out = torch.empty((B, S, R), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = kernel_library().lib.rglru_scan_launch(
            a.data_ptr(), x.data_ptr(), h0.data_ptr(), out.data_ptr(),
            dtype_code, B, S, R, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {err}")
    return out
