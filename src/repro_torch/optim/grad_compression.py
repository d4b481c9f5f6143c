"""Gradient compression for the data-parallel all-reduce.

int8 block quantization with error feedback, the JAX package's
``optim/grad_compression.py`` bit for bit: each worker quantizes its local
gradient to int8 with a max-abs scale per block of 256 values (rounding half
to even, as ``jnp.round``), the all-reduce moves a quarter of the fp32 bytes,
and the quantization residual is carried into the next step's gradient.

``compressed_psum`` is the collective around it: each rank quantizes its
gradient, the int8 codes are summed as int32 over the group, the scales
averaged, and the sum dequantized and divided by the group's size.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.optim.optimizers import tree_map

Tree = Any
BLOCK = 256


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 quantization.  Returns (q (n_blocks, 256)
    int8, scales (n_blocks,) fp32)."""
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp_min(scale, 1e-12)),
                    -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype) -> torch.Tensor:
    blocks = q.to(torch.float32) * scale[:, None]
    n = math.prod(shape)
    return blocks.reshape(-1)[:n].reshape(shape).to(dtype)


def compress_tree(grads: Tree, error: Tree) -> tuple[Tree, Tree]:
    """Quantize grads + error; returns (compressed tree of {"q", "s"}, new
    error feedback)."""

    def comp(g, e):
        g32 = g.to(torch.float32) + e
        q, s = quantize_int8(g32)
        deq = dequantize_int8(q, s, g.shape, torch.float32)
        return {"q": q, "s": s}, g32 - deq

    pairs = tree_map(comp, grads, error)
    return tree_map(lambda x: x[0], pairs), tree_map(lambda x: x[1], pairs)


def decompress_tree(comp: Tree, like: Tree) -> Tree:
    """The dequantized tree, with ``like``'s shapes and dtypes."""
    return tree_map(lambda g, c: dequantize_int8(c["q"], c["s"], g.shape,
                                                 g.dtype), like, comp)


def init_error(params: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum(grads: Tree, error: Tree,
                    group=None) -> tuple[Tree, Tree]:
    """The mean of ``grads`` over the ranks of ``group`` (a
    ``torch.distributed`` process group, default the world) through int8
    codes, in the JAX function's order (``compressed_psum``): quantize
    locally, all-reduce the codes as int32 sums, average the scales (a
    shared-scale approximation), dequantize, divide by n.  Returns (the
    reduced tree in fp32, the new error feedback).  A DTensor leaf is
    taken as its local shard (what a data-parallel rank holds)."""
    import torch.distributed as dist

    local = tree_map(lambda t: t.to_local() if hasattr(t, "to_local")
                     else t, grads)
    comp, new_err = compress_tree(local, tree_map(
        lambda t: t.to_local() if hasattr(t, "to_local") else t, error))
    n = dist.get_world_size(group)

    def reduce_leaf(g, c):
        q32 = c["q"].to(torch.int32)
        dist.all_reduce(q32, group=group)
        s = c["s"].clone()
        dist.all_reduce(s, group=group)
        s = s / n  # pmean
        return (q32.to(torch.float32) * s[:, None]).reshape(-1)[
            :g.numel()].reshape(g.shape)

    reduced = tree_map(reduce_leaf, local, comp)
    return tree_map(lambda g: g / n, reduced), new_err
