"""Gradient compression for the data-parallel all-reduce.

int8 block quantization with error feedback, the JAX package's
``optim/grad_compression.py`` bit for bit: each worker quantizes its local
gradient to int8 with a max-abs scale per block of 256 values (rounding half
to even, as ``jnp.round``), the all-reduce moves a quarter of the fp32 bytes,
and the quantization residual is carried into the next step's gradient.

``compressed_psum``, the collective around it, waits for a
``torch.distributed`` mesh (ROADMAP.md queue 1, item 12).
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
