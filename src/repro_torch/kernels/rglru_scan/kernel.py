"""Launch of the hand-written Hopper RG-LRU scan kernels and their plan.

Replaces the Pallas TPU kernel ``rglru_scan_kernel``
(``src/repro/kernels/rglru_scan/kernel.py:41``, ``pallas_call`` at :54).
The CUDA source is ``repro_torch/csrc/rglru_scan.cu``; its header comment
states what bounds it on the card (bytes) and how the ring works.  A block
owns ``CH`` channels of one batch row and walks all of S, one consumer lane
a channel carrying its state in a register; a producer warp keeps a ring of
``D`` tiles of ``T`` steps filled ahead of it in shared memory.  The
backward (``launch_bwd``) walks the tiles from the end of S in the same
layout, from the saved states.

``scan_plan`` is the rule both launchers apply before launch (the C side
applies the same rule, ``make_plan``; ``rglru_scan_plan`` reports it):
the ``"tma"`` producer where every row stride and base takes TMA, else the
``"cp_async"`` producer; the ring's depth and its shared memory.  The TMA
route stages each output tile in shared memory and stores it through TMA;
the cp.async route stores every step.  ``last_route`` reads the producer
the C side actually launched.

With ``shape_only`` (the ops wrapper's shape route for fake tensors, the
dry run) ``launch`` and ``launch_bwd`` take the plan (``plan_for``) and
return their outputs' shapes without a launch, reporting ``cost`` /
``cost_bwd``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels.build import kernel_library
from repro_torch.kernels.common import (aligned16, on_device, raw_stream,
                                        record_kernel)

ROUTES = ("tma", "cp_async")
CH = 32  # channels a block owns: 128-byte rows of fp32
# time steps a ring tile holds, by route: the consumer holds a whole tile of
# every input in registers, and a cp.async row's word shift costs more
T = {"tma": 64, "cp_async": 32}
# steps the ring holds ahead of the consumer: ~5.2 MB (forward, 8 bytes a
# step in fp32) and ~5.9 MB (backward, 12) in flight over the 80 blocks of
# B 1, R 2560, more than 3.35 TB/s needs over ~1 us of memory latency
DEPTH = {False: 256, True: 192}
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on an H100
_ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2}


def cost(B: int, S: int, R: int, element_size: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one forward launch: a multiply and an add per
    element; a and x read once, h0 read and every state written in
    fp32."""
    return 2 * B * S * R, B * S * R * (2 * element_size + 4) + 4 * B * R


def cost_bwd(B: int, S: int, R: int, element_size: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one backward launch: a, dh and h read once, da and
    dx written once, h0 read and dh0 written (fp32 but a, da and dx)."""
    return 3 * B * S * R, B * S * R * (3 * element_size + 8) + 8 * B * R


class ScanPlan(NamedTuple):
    route: str  # "tma" or "cp_async"
    ch: int  # channels a block owns
    t: int  # steps a ring tile holds
    d: int  # ring stages
    smem_bytes: int  # dynamic shared memory of a block
    blocks: int  # ceil(R / ch) x B


def _round128(n: int) -> int:
    return (n + 127) // 128 * 128


def _tile_bytes(es: int, tma: bool) -> int:
    # a cp.async row carries one word more: its copy starts at the 4-byte
    # word that holds the row's first element
    return _round128(T[ROUTES[not tma]] * (CH * es + (0 if tma else 4)))


@functools.lru_cache(maxsize=256)
def scan_plan(B: int, S: int, R: int, dtype: torch.dtype, backward: bool,
              aligned: bool = True) -> ScanPlan:
    """The launch plan of the forward (``backward=False``) or the backward
    on (B, S, R) of ``dtype`` (a's; h0, h and dh are fp32).

    Route: ``"tma"`` when every tensor TMA reads or writes starts on 16
    bytes (``aligned``) and a row, R x element size, is a multiple of 16
    bytes, as TMA's global strides must be; else ``"cp_async"``.  The ring
    holds D tiles of T steps (T 64 on the TMA route, 32 on the cp.async
    one), T x D >= min(S, DEPTH) (256 steps forward, 192 backward): the
    whole sequence when it is shorter, never more stages than tiles.
    Shared memory: 128 bytes of alignment slack, the D full and D empty
    mbarriers rounded to 128, D stages (forward: an a and an x tile;
    backward: a, dh and h), and on the TMA route two staging tiles of every
    output.
    """
    if dtype not in _ELEMENT_BYTES:
        raise TypeError(f"rglru_scan takes float32 or bfloat16, got {dtype}")
    if min(B, S, R) < 1:
        raise ValueError(f"rglru_scan plans non-empty shapes, got "
                         f"{(B, S, R)}")
    es = _ELEMENT_BYTES[dtype]
    tma = aligned and (R * es) % 16 == 0
    route = ROUTES[not tma]
    t = T[route]
    d = max(1, min(-(-DEPTH[backward] // t), -(-S // t)))
    stage = (_tile_bytes(es, tma) + 2 * _tile_bytes(4, tma) if backward
             else 2 * _tile_bytes(es, tma))
    staging = 0
    if tma:
        staging = 2 * (2 * _round128(t * CH * es) if backward
                       else _round128(t * CH * 4))
    smem = 128 + _round128(16 * d) + d * stage + staging
    return ScanPlan(route, CH, t, d, smem, -(-R // CH) * B)


def plan_for(a: torch.Tensor, *others: torch.Tensor,
             backward: bool) -> ScanPlan:
    """``scan_plan`` of a launch on a (B, S, R) with the other tensors its
    producer reads (x; or h and dh): the outputs are fresh allocations, on
    512 bytes."""
    B, S, R = a.shape
    aligned = all(aligned16(t) for t in (a, *others))
    return scan_plan(B, S, R, a.dtype, backward, aligned)


def library_plan(S: int, R: int, dtype_code: int, backward: bool,
                 aligned: bool = True) -> tuple:
    """The plan the C side applies (``rglru_scan_plan``): (route, CH, T, D,
    shared bytes); the card tests hold it against ``scan_plan``."""
    out = (ctypes.c_int * 5)()
    kernel_library().lib.rglru_scan_plan(S, R, dtype_code, int(backward),
                                         int(aligned), out)
    return (ROUTES[0] if out[0] else ROUTES[1], *out[1:])


def last_route() -> str:
    """The producer route (``"tma"`` or ``"cp_async"``) of this thread's
    last launch of either scan kernel, as the C launcher took it."""
    code = kernel_library().lib.rglru_scan_last_route()
    if code < 0:
        raise RuntimeError("rglru_scan: no launch to report a route of")
    return ROUTES[0] if code else ROUTES[1]


def launch(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor,
           dtype_code: int, *, shape_only: bool = False) -> torch.Tensor:
    """(B, S, R) fp32; the caller has validated the inputs and made h0 a
    contiguous fp32 (B, R) tensor.  ``shape_only`` (the shape route, fake
    tensors): the plan checked, the output's shape and the launch's work,
    no launch."""
    B, S, R = a.shape
    out = torch.empty((B, S, R), dtype=torch.float32, device=a.device)
    if shape_only:
        plan_for(a, x, backward=False)
        record_kernel("rglru_scan", cost(B, S, R, a.element_size()))
        return out
    lib = kernel_library().lib
    args = (a.data_ptr(), x.data_ptr(), h0.data_ptr(), out.data_ptr(),
            dtype_code, B, S, R)
    with on_device(a.device):
        err = lib.rglru_scan_launch(*args, raw_stream(a.device))
    if err != 0:
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {err}")
    return out


def launch_bwd(a: torch.Tensor, h0: torch.Tensor, h: torch.Tensor,
               dh: torch.Tensor, dtype_code: int, *,
               shape_only: bool = False):
    """(da, dx) (B, S, R) in a's dtype and dh0 (B, R) fp32 from the saved
    states h and their gradient dh; the caller has validated the inputs
    (a contiguous, h0, h and dh contiguous fp32).  ``shape_only``: as in
    ``launch``."""
    B, S, R = a.shape
    da = torch.empty_like(a)
    dx = torch.empty_like(a)
    dh0 = torch.empty((B, R), dtype=torch.float32, device=a.device)
    if shape_only:
        plan_for(a, h, dh, backward=True)
        record_kernel("rglru_scan_bwd", cost_bwd(B, S, R, a.element_size()))
        return da, dx, dh0
    lib = kernel_library().lib
    args = (a.data_ptr(), h0.data_ptr(), h.data_ptr(), dh.data_ptr(),
            da.data_ptr(), dx.data_ptr(), dh0.data_ptr(), dtype_code, B, S, R)
    with on_device(a.device):
        err = lib.rglru_scan_bwd_launch(*args, raw_stream(a.device))
    if err != 0:
        raise RuntimeError(f"rglru_scan backward launch failed: CUDA error "
                           f"{err}")
    return da, dx, dh0
