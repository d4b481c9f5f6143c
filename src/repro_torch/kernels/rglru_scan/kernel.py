"""Launch of the hand-written Hopper RG-LRU scan kernel.

Replaces the Pallas TPU kernel ``rglru_scan_kernel``
(``src/repro/kernels/rglru_scan/kernel.py:41``, ``pallas_call`` at :54).
The CUDA source is ``repro_torch/csrc/rglru_scan.cu``; its header comment
states what bounds it on the card.  One thread owns one (b, r) channel and
carries its state in a register along S; the TPU kernel's sequential chunk
grid axis and VMEM carry become that loop, and its padding of R to 128
lanes and of S to the chunk becomes a bounds check.  The backward
(``launch_bwd``) walks S the other way in the same layout, one thread a
channel, from the saved states.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import kernel_library
from repro_torch.kernels.common import on_device, raw_stream


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


def launch_bwd(a: torch.Tensor, h0: torch.Tensor, h: torch.Tensor,
               dh: torch.Tensor, dtype_code: int):
    """(da, dx) (B, S, R) in a's dtype and dh0 (B, R) fp32 from the saved
    states h and their gradient dh; the caller has validated the inputs
    (a contiguous, h0, h and dh contiguous fp32)."""
    B, S, R = a.shape
    da = torch.empty_like(a)
    dx = torch.empty_like(a)
    dh0 = torch.empty((B, R), dtype=torch.float32, device=a.device)
    with on_device(a.device):
        err = kernel_library().lib.rglru_scan_bwd_launch(
            a.data_ptr(), h0.data_ptr(), h.data_ptr(), dh.data_ptr(),
            da.data_ptr(), dx.data_ptr(), dh0.data_ptr(), dtype_code, B, S, R,
            raw_stream(a.device))
    if err != 0:
        raise RuntimeError(f"rglru_scan backward launch failed: CUDA error "
                           f"{err}")
    return da, dx, dh0
