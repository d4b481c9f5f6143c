"""Launch of the hand-written Hopper grouped expert matmul, in two variants.

Replaces the Pallas TPU kernel ``moe_gmm_kernel``
(``src/repro/kernels/moe_gmm/kernel.py:39``, ``pallas_call`` at :56).  The
CUDA source is ``repro_torch/csrc/moe_gmm.cu``; its header comment states
what bounds it on the card (operations at prefill, the bytes of w at
decode) and how each variant is built.

* ``"tc"``, bf16 with D and F multiples of 8: ``moe_gmm_tc_kernel``, wgmma
  on the tensor cores fed by a TMA ring.  TMA needs every global stride to
  be a multiple of 16 bytes, hence the rule on D and F; x is read through a
  3-D tensor map, so rows of a tile past C are zeros, not the next expert's.
* ``"ffma"``, everything else (fp32, and bf16 shapes TMA cannot take):
  ``moe_gmm_kernel``, the first port's fp32 FFMA design from shared memory.

The backward (``launch_bwd``) computes dx = dy . w^T and then dw = x^T .
dy, by one rule (``route_bwd``, the forward's): ``"tc"`` launches
``moe_gmm_bwd_tc_kernel`` twice, a persistent kernel (one block an SM, a
fixed walk over output tiles, the epilogue's TMA store overlapping the next
tile) that computes dx as dx^T = w . dy^T in tiles of C fitted to 160 rows,
and dw with x and dy read MN-major; ``"ffma"`` launches the FFMA kernel on
the other operand layouts, loading each along its contiguous axis.  Both
are deterministic (no split-K, no atomics).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import kernel_library
from repro_torch.kernels.common import KERNEL_DTYPES, on_device, raw_stream

VARIANTS = ("tc", "ffma")


def route(dtype: torch.dtype, D: int, F: int) -> str:
    """The variant that computes x (E, C, D) @ w (E, D, F) of ``dtype``."""
    if dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0:
        return "tc"
    return "ffma"


def launch(x: torch.Tensor, w: torch.Tensor, variant: str) -> torch.Tensor:
    """(E, C, F) in x's dtype through ``variant``; the caller has validated
    the inputs (and ``"tc"`` takes only what ``route`` sends it)."""
    E, C, D = x.shape
    F = w.shape[2]
    if variant not in VARIANTS:
        raise ValueError(f"moe_gmm: unknown variant {variant!r}")
    if variant == "tc" and route(x.dtype, D, F) != "tc":
        raise ValueError(f"moe_gmm: the tensor-core variant takes bf16 with "
                         f"D, F multiples of 8, got {x.dtype}, D {D}, F {F}")
    if variant == "tc" and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("moe_gmm: the tensor-core variant reads x and w "
                         "through TMA, which needs 16-byte aligned bases")
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    lib = kernel_library().lib
    ptrs = (x.data_ptr(), w.data_ptr(), out.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if variant == "tc":
            err = lib.moe_gmm_tc_launch(*ptrs, E, C, D, F, stream)
        else:
            err = lib.moe_gmm_launch(*ptrs, KERNEL_DTYPES[x.dtype], E, C, D,
                                     F, stream)
    if err != 0:
        raise RuntimeError(f"moe_gmm {variant} launch failed: error {err}")
    return out


def bwd_tc_tiles(E: int, C: int, D: int, F: int) -> tuple[int, int]:
    """The output tiles the tensor-core backward walks, (dx, dw): dx as
    dx^T (E, D, C) in 128 x 160 tiles (128 x 64 when C <= 64), dw (E, D, F)
    in 128 x 256 (``csrc/moe_gmm.cu: gmm_bwd_tc``).  Each launch runs
    min(tiles, SMs) blocks."""
    m = -(-D // 128)
    return E * m * -(-C // (64 if C <= 64 else 160)), E * m * -(-F // 256)


def route_bwd(dtype: torch.dtype, D: int, F: int) -> str:
    """The backward's variant for x (E, C, D), w (E, D, F) of ``dtype``:
    the forward's rule (both products read the same tensors through TMA)."""
    return route(dtype, D, F)


def launch_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
               variant: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx (E, C, D), dw (E, D, F)) in x's dtype through ``variant``; the
    caller has validated the inputs (one dtype, contiguous, C >= 1)."""
    E, C, D = x.shape
    F = w.shape[2]
    if variant not in VARIANTS:
        raise ValueError(f"moe_gmm backward: unknown variant {variant!r}")
    if variant == "tc" and route_bwd(x.dtype, D, F) != "tc":
        raise ValueError(f"moe_gmm backward: the tensor-core variant takes "
                         f"bf16 with D, F multiples of 8, got {x.dtype}, D "
                         f"{D}, F {F}")
    if variant == "tc" and any(t.data_ptr() % 16 for t in (x, w, dy)):
        raise ValueError("moe_gmm backward: the tensor-core variant reads x, "
                         "w and dy through TMA, which needs 16-byte aligned "
                         "bases")
    dx = torch.empty((E, C, D), dtype=x.dtype, device=x.device)
    dw = torch.empty((E, D, F), dtype=x.dtype, device=x.device)
    lib = kernel_library().lib
    ptrs = (x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dw.data_ptr())
    with on_device(x.device):
        stream = raw_stream(x.device)
        if variant == "tc":
            err = lib.moe_gmm_bwd_tc_launch(*ptrs, E, C, D, F, stream)
        else:
            err = lib.moe_gmm_bwd_launch(*ptrs, KERNEL_DTYPES[x.dtype], E, C,
                                         D, F, stream)
    if err != 0:
        raise RuntimeError(f"moe_gmm backward {variant} launch failed: error "
                           f"{err}")
    return dx, dw
