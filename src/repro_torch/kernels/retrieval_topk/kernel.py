"""Launch of the hand-written Hopper retrieval top-k kernels.

Replace the Pallas TPU kernel ``retrieval_topk_kernel``
(``src/repro/kernels/retrieval_topk/kernel.py:87``, merge ``topk_merge``
at :38): every 1 <= k <= n and every width d.  Two routes, chosen by one
rule on k (``route``), both on the tiled top-k core of
``repro_torch/csrc/tiled_topk.cuh`` (kernels in ``csrc/retrieval_topk.cu``):

* ``"tiled"`` (k <= 64): ``retrieval_topk_tiled_kernel``.  A block scores a
  64- (or 16-) query x 128-row tile on a register-tiled fp32 outer product
  fed by a two-stage ``cp.async`` ring, and folds each tile into running
  top-k lists with bitonic networks, for one split of the corpus; the grid
  (``grid``) covers (query tile, corpus split), and a merge kernel folds
  the splits' lists, unless one split covers the corpus.
* ``"select"`` (k > 64): the same product writes the (B, n) similarity
  block (B in chunks of ``select_chunk`` rows), then one block per query
  row radix-selects the k-th value, keeps the entries above it and the
  lowest ids among those equal to it, and sorts them.

Rows are copied 16 bytes at a time where d is a multiple of 4 and both
bases are 16-byte aligned, else 4 bytes at a time.  A third variant,
``"row"`` (the first port's warp-per-row ``retrieval_topk_kernel`` in
``csrc/selection.cu``, k <= 64 and d up to about 1600), is reached only by
name, for comparison.

All give the exact top-k under (value desc, id asc), so an exact tie
admits the lowest id.  The CUDA sources' header comments state what bounds
them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.build import kernel_library
from repro_torch.kernels.common import on_device, raw_stream, sm_count

ROUTES = ("tiled", "select")  # what ``route`` picks
VARIANTS = (*ROUTES, "row")  # "row" only by name
CORPUS_TILE = 128  # corpus rows per tile (kBN in tiled_topk.cuh)
# query rows per block: 64 (an 8 x 8 score tile a thread), or 16 (2 x 8)
# where 64-row tiles cannot give every SM a block
QUERY_TILES = (64, 16)
WAVES = 2  # blocks per SM the grid asks for where the corpus allows
# the longest running list of the tiled kernel (R = 64), and of the row
# kernel (two slots a lane in csrc/topk.cuh)
TILED_MAX_K = 64
SORT_CHUNK = 8192  # kSortChunk of tiled_topk.cuh: keys sorted in shared memory
# 4-byte words of the select route's scratch: chunks of B keep the
# similarity block (and any spilled sort keys) within 64 MB
SELECT_SCRATCH_WORDS = 1 << 24


class Grid(NamedTuple):
    query_tile: int  # query rows per block
    q_tiles: int
    per_split: int  # corpus tiles per split
    n_splits: int  # 1: no merge


def route(k: int) -> str:
    """The variant for a call of k (of any width d): the tiled kernel's
    running lists hold up to 64 entries, the select route any k."""
    return "tiled" if k <= TILED_MAX_K else "select"


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


def sort_words(k: int) -> int:
    """4-byte words of spilled sort keys a select row needs: none while its
    sort_n (the power of two >= k) keys fit shared memory, else 2 sort_n."""
    sort_n = 1 << (k - 1).bit_length()
    return 2 * sort_n if sort_n > SORT_CHUNK else 0


def select_chunk(B: int, n: int, k: int) -> int:
    """Query rows of one chunk of the select route: as many as keep the
    (rows, n) similarity block and the spilled sort keys within
    ``SELECT_SCRATCH_WORDS`` (at least one)."""
    return max(1, min(B, SELECT_SCRATCH_WORDS // (n + sort_words(k))))


def vec4(*tensors: torch.Tensor) -> bool:
    """Whether the tiled product may copy rows 16 bytes at a time: the
    width a multiple of 4 and every base 16-byte aligned."""
    return all(t.shape[-1] % 4 == 0 and t.data_ptr() % 16 == 0
               for t in tensors)


def select_scratch(rows: int, n: int, k: int, device):
    """One allocation for the select route: the spilled sort keys first
    (8-byte aligned), then the (rows, n) similarity block.  Returns the
    tensor (to keep until the launch is queued) and the addresses of the
    block and the keys."""
    spill = rows * sort_words(k)
    buf = torch.empty(spill + rows * n, dtype=torch.int32, device=device)
    return buf, (buf[spill:].data_ptr(), buf.data_ptr())


def launch(q: torch.Tensor, corpus: torch.Tensor, k: int, variant: str):
    """(vals (B, k) fp32, ids (B, k) int32) through ``variant`` for
    contiguous fp32 CUDA inputs; the caller has validated shapes and
    ``1 <= k <= n``."""
    B, d = q.shape
    n = corpus.shape[0]
    if variant not in VARIANTS:
        raise ValueError(f"retrieval_topk: unknown variant {variant!r}")
    if variant in ("tiled", "row") and k > TILED_MAX_K:
        raise ValueError(f"retrieval_topk: the {variant} variant takes "
                         f"k <= {TILED_MAX_K}, got k={k}")
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
        elif variant == "tiled":
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
                ids.data_ptr(), B, n, d, k, vec4(q, corpus), *g, stream)
        else:
            chunk = select_chunk(B, n, k)
            g = grid(chunk, n, sm_count(q.device))
            _buf, (sims, spill) = select_scratch(chunk, n, k, q.device)
            err = lib.retrieval_topk_select_launch(
                q.data_ptr(), corpus.data_ptr(), sims, spill, vals.data_ptr(),
                ids.data_ptr(), B, n, d, k, vec4(q, corpus), chunk,
                g.query_tile, g.per_split, g.n_splits, stream)
    if err != 0:
        raise RuntimeError(f"retrieval_topk {variant} launch failed: CUDA "
                           f"error {err}")
    return vals, ids
