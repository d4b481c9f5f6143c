"""Launch of the hand-written Hopper grouped expert matmul.

Replaces the Pallas TPU kernel ``moe_gmm_kernel``
(``src/repro/kernels/moe_gmm/kernel.py:39``, ``pallas_call`` at :56).  The
CUDA source is ``repro_torch/csrc/moe_gmm.cu``; its header comment states
what bounds it on the card.  One block owns one (row tile, 128-column tile)
of one expert's output and walks D, staging an x tile and a w tile in shared
memory; the row tile's height follows C, so at decode (C = 8) the kernel is
a stream of the expert weights.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import kernel_library


def launch(x: torch.Tensor, w: torch.Tensor, dtype_code: int) -> torch.Tensor:
    """(E, C, F) in x's dtype; the caller has validated the inputs."""
    E, C, D = x.shape
    F = w.shape[2]
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = kernel_library().lib.moe_gmm_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), dtype_code, E, C, D,
            F, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_gmm launch failed: CUDA error {err}")
    return out
