"""Launch of the hand-written Hopper retrieval top-k kernels.

Replace the Pallas TPU kernel ``retrieval_topk_kernel``
(``src/repro/kernels/retrieval_topk/kernel.py:87``, merge ``topk_merge``
at :38).  Two variants, chosen by one rule on shape (``route``):

* ``"tiled"`` (d a multiple of 4: rows copied 16 bytes at a time):
  ``retrieval_topk_tiled_kernel`` in ``repro_torch/csrc/retrieval_topk.cu``.
  A block scores a 64- (or 16-) query x 128-row tile on a register-tiled
  fp32 outer product fed by a two-stage ``cp.async`` ring, and folds each
  tile into running top-k lists with bitonic networks, for one split of the
  corpus; the grid (``grid``) covers (query tile, corpus split), and a merge
  kernel folds the splits' lists, unless one split covers the corpus.
* ``"row"`` (the rest): the first port's ``retrieval_topk_kernel`` in
  ``csrc/selection.cu`` (shared running top-k in ``csrc/topk.cuh``), one
  warp per query row streaming 32-row corpus tiles through shared memory.

Both give the exact top-k under (value desc, id asc), so an exact tie
admits the lowest id: the warp kernel by ``topk.cuh``'s ordered inserts,
the tiled one by networks that compare (value, id).  The CUDA sources'
header comments state what bounds them.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels.build import kernel_library
from repro_torch.kernels.common import on_device, raw_stream, sm_count

VARIANTS = ("tiled", "row")
CORPUS_TILE = 128  # corpus rows per tile (kBN in retrieval_topk.cu)
# query rows per block: 64 (an 8 x 8 score tile a thread), or 16 (2 x 8)
# where 64-row tiles cannot give every SM a block
QUERY_TILES = (64, 16)
WAVES = 2  # blocks per SM the grid asks for where the corpus allows


class Grid(NamedTuple):
    query_tile: int  # query rows per block
    q_tiles: int
    per_split: int  # corpus tiles per split
    n_splits: int  # 1: no merge


def route(d: int) -> str:
    """The variant for a retrieval call of width ``d``: the tiled kernel
    copies 16-byte pieces of rows, so it takes d a multiple of 4."""
    return "tiled" if d % 4 == 0 else "row"


def grid(B: int, n: int, sms: int) -> Grid:
    """The tiled kernel's grid: 64-row query tiles unless one block per
    (query tile, corpus tile) would leave SMs idle, then 16-row tiles; the
    corpus cut into splits of whole tiles, as many as give at least
    ``WAVES`` blocks per SM (no split shorter than one tile)."""
    n_tiles = -(-n // CORPUS_TILE)
    big, small = QUERY_TILES
    query_tile = big if -(-B // big) * n_tiles >= sms else small
    q_tiles = -(-B // query_tile)
    per_split = max(1, n_tiles * q_tiles // (WAVES * sms))
    return Grid(query_tile, q_tiles, per_split, -(-n_tiles // per_split))


# device index -> widest d made ready.  The attribute set for a width also
# covers every narrower one, and it is only ever raised: lowering it for a
# narrow width would fail a later launch at a wider one.
_ready_width: dict[int, int] = {}


def prepare(d: int, device: torch.device) -> None:
    """Once per device and new widest d: refuse a width whose corpus tile
    does not fit one block's shared memory (d above about 1600 on an H100),
    and allow both warp-per-row selection kernels that much shared
    memory."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    if d <= _ready_width.get(index, 0):
        return
    lib = kernel_library().lib
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
    """The largest k both variants take (``kMaxK`` of ``csrc/topk.cuh``)."""
    return kernel_library().lib.selection_max_k()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy in fresh storage when its base is not 16-byte
    aligned (an offset view): the tiled kernel copies 16-byte pieces."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch(q: torch.Tensor, corpus: torch.Tensor, k: int, variant: str):
    """(vals (B, k) fp32, ids (B, k) int32) through ``variant`` for
    contiguous fp32 CUDA inputs; the caller has validated shapes and
    ``1 <= k <= max_k()`` (and ``"tiled"`` takes only what ``route`` sends
    it)."""
    B, d = q.shape
    n = corpus.shape[0]
    if variant not in VARIANTS:
        raise ValueError(f"retrieval_topk: unknown variant {variant!r}")
    if variant == "tiled" and route(d) != "tiled":
        raise ValueError(f"retrieval_topk: the tiled variant takes d a "
                         f"multiple of 4, got d={d}")
    vals = torch.empty((B, k), dtype=torch.float32, device=q.device)
    ids = torch.empty((B, k), dtype=torch.int32, device=q.device)
    lib = kernel_library().lib
    if variant == "row":
        prepare(d, q.device)
    with on_device(q.device):
        stream = raw_stream(q.device)
        if variant == "row":
            err = lib.retrieval_topk_launch(
                q.data_ptr(), corpus.data_ptr(), vals.data_ptr(),
                ids.data_ptr(), B, n, d, k, stream)
        else:
            q, corpus = _aligned(q), _aligned(corpus)
            g = grid(B, n, sm_count(q.device))
            n_splits = g.n_splits
            parts = (None, None, None)
            if n_splits > 1:  # each split's k best per query (values, ids),
                # then a merge; the splits share their k-th values through
                # zeroed floors (B,)
                lists = torch.empty(2 * B * n_splits * k, dtype=torch.int32,
                                    device=q.device)
                floors = torch.zeros(B, dtype=torch.int32, device=q.device)
                parts = (lists.data_ptr(), lists[B * n_splits * k:].data_ptr(),
                         floors.data_ptr())
            err = lib.retrieval_topk_tiled_launch(
                q.data_ptr(), corpus.data_ptr(), *parts, vals.data_ptr(),
                ids.data_ptr(), B, n, d, k, *g, stream)
    if err != 0:
        raise RuntimeError(f"retrieval_topk {variant} launch failed: CUDA "
                           f"error {err}")
    return vals, ids
