"""Launch of the hand-written Hopper retrieval top-k kernel.

Replaces the Pallas TPU kernel ``retrieval_topk_kernel``
(``src/repro/kernels/retrieval_topk/kernel.py:87``, merge ``topk_merge``
at :38).  The CUDA source is ``repro_torch/csrc/selection.cu`` with the
shared running top-k in ``csrc/topk.cuh``; its header comment states what
bounds it on the card.  One warp owns one query row and a block of four
warps walks the corpus in 32-row tiles staged in shared memory; the ragged
edge is masked by bounds, so there are no zero-padded rows to mask.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.build import selection_library


# device index -> widest d made ready.  The attribute set for a width also
# covers every narrower one, and it is only ever raised: lowering it for a
# narrow width would fail a later launch at a wider one.
_ready_width: dict[int, int] = {}


def prepare(d: int, device: torch.device) -> None:
    """Once per device and new widest d: refuse a width whose corpus tile
    does not fit one block's shared memory (d above about 1600 on an H100),
    and allow both selection kernels that much shared memory."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    if d <= _ready_width.get(index, 0):
        return
    lib = selection_library().lib
    need = lib.selection_smem_bytes(d)
    limit = torch.cuda.get_device_properties(index).shared_memory_per_block_optin
    if need > limit:
        raise ValueError(f"d={d} needs {need} B of shared memory per block; "
                         f"the card allows {limit}")
    with torch.cuda.device(index):
        err = lib.selection_prepare(d)
    if err != 0:
        raise RuntimeError(f"selection kernels: setting {need} B of shared "
                           f"memory failed: CUDA error {err}")
    _ready_width[index] = d


@functools.cache
def max_k() -> int:
    return selection_library().lib.selection_max_k()


def launch(q: torch.Tensor, corpus: torch.Tensor, k: int):
    """(vals (B, k) fp32, ids (B, k) int32) for contiguous fp32 CUDA inputs;
    the caller has validated shapes and ``1 <= k <= max_k()``."""
    B, d = q.shape
    n = corpus.shape[0]
    prepare(d, q.device)
    vals = torch.empty((B, k), dtype=torch.float32, device=q.device)
    ids = torch.empty((B, k), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        err = selection_library().lib.retrieval_topk_launch(
            q.data_ptr(), corpus.data_ptr(), vals.data_ptr(), ids.data_ptr(),
            B, n, d, k, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"retrieval_topk launch failed: CUDA error {err}")
    return vals, ids
