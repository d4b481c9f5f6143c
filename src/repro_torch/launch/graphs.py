"""The decode step as one CUDA graph, replayed step after step.

An eager decode step dispatches dozens of small ops a layer from Python,
and on the card the host takes several times longer to launch them than the
device takes to run them.  ``GraphedDecode`` captures the whole step once
and replays it: one graph launch a step, the kernels unchanged (the
hand-written ``decode_attention`` among them, launched from inside the
graph).

The step graphs itself where it can, by what it observes and with no
setting: a plain step (no sharding policy) of a decoder-only stack of
attention blocks with a dense MLP (``dense_decoder``), given a token and a
``cache_len`` that are plain CUDA tensors and a cache of plain CUDA
tensors.  Every other call runs the eager step unchanged: an int
``cache_len``, a policy (DTensors), MoE blocks (``moe_apply`` reads its
expert counts on the host), recurrent blocks, an encoder-decoder or a VLM.

A graph holds addresses.  The token and ``cache_len`` are copied into the
graph's own buffers at each step; the parameters and the cache are taken
by address, so a graph is kept for one *key*, the storage addresses of
every parameter and cache tensor, within a *family* of key-independent
shapes (token, ``cache_len``).  A cache at a new address gets a new
capture; ``HELD`` captures a family are kept, and the least recently used
one is freed with its memory pool.  A family's first step runs eager on
the step's side stream, which readies cuBLAS there for the captures that
follow on the same stream.

The logits a graphed step returns are the graph's output buffer: valid
until the next replay of that graph.  The cache returned is the caller's,
updated in place.  The kernels' launch counters (``launches*`` of each op
in ``KERNEL_OPS``) stay exact: what a capture adds is taken back and added
again at each replay.  The step's own counters: ``captures``, ``replays``
(graphed steps) and ``eager_steps`` (steps the rule sent eager, and each
family's first step).  With ``repro_torch.perf.spans`` on, a graphed step
is one ``decode_step`` span, its copies and replay included; the spans
inside the step appear on eager steps only.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.moe_gmm.ops import moe_gmm
from repro_torch.kernels.rglru_scan.ops import rglru_scan_op
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.perf import spans

HELD = 2  # captures kept a family
KERNEL_OPS = (decode_attention, flash_attention, moe_gmm, rglru_scan_op)


def dense_decoder(cfg: ModelConfig) -> bool:
    """Does ``cfg``'s decode step run with no host sync: a decoder-only
    stack of attention blocks with a dense MLP, and no frontend."""
    return (not cfg.num_encoder_layers and not cfg.cross_attention and
            not cfg.frontend and not cfg.num_experts and
            all(t == "attn" for t in cfg.layer_types))


def on_card(t) -> bool:
    """A plain CUDA tensor: not a DTensor, a fake or a CPU tensor."""
    return type(t) is torch.Tensor and t.is_cuda


def launch_counts() -> dict:
    """Every ``launches*`` counter of the kernel ops: (op, name) -> n."""
    return {(op, name): n for op in KERNEL_OPS
            for name, n in vars(op).items() if name.startswith("launches")}


def add_counts(delta: dict) -> None:
    for (op, name), n in delta.items():
        setattr(op, name, getattr(op, name) + n)


@dataclass
class Captured:
    graph: object  # torch.cuda.CUDAGraph
    token: torch.Tensor  # the graph's inputs
    cache_len: torch.Tensor
    logits: torch.Tensor  # the graph's output
    launches: dict  # (op, name) -> launches a replay


class GraphedDecode:
    """``decode_step(params, token, cache, cache_len[, encoder_out]) ->
    (logits, cache)``: ``eager`` itself, or one replayed CUDA graph of it
    where ``graphable`` (the step's rule, fixed by ``build_decode_step``)
    and the inputs allow (module docstring)."""

    def __init__(self, eager: Callable, graphable: bool):
        self.eager, self.graphable = eager, graphable
        self.captures = self.replays = self.eager_steps = 0
        self._held: dict = {}  # family -> OrderedDict(key -> Captured)
        self._side: dict = {}  # device -> stream of warm-ups and captures

    @property
    def held(self) -> int:
        """Captures held, over every family."""
        return sum(len(h) for h in self._held.values())

    def __call__(self, *args):
        if self.graphable:
            params, token, cache, cache_len = args
            leaves = tree_leaves(cache)
            if on_card(token) and on_card(cache_len) and \
                    all(on_card(t) for t in leaves):
                return self._graphed(params, token, cache, cache_len, leaves)
        self.eager_steps += 1
        return self.eager(*args)

    def _graphed(self, params, token, cache, cache_len, leaves):
        dev = token.device
        family = (dev, token.shape, token.dtype, cache_len.shape,
                  cache_len.dtype)
        held = self._held.get(family)
        if held is None:  # the family's first step: eager, on the side stream
            out = self._on_side(dev, self.eager, params, token, cache,
                                cache_len)
            self._held[family] = OrderedDict()
            self.eager_steps += 1
            return out
        key = (tuple((t.data_ptr(), t.shape) for t in leaves),
               tuple(p.data_ptr() for p in tree_leaves(params)))
        if spans.on:
            spans.begin("decode_step")
        try:
            cap = held.get(key)
            if cap is None:
                cap = self._capture(dev, params, token, cache, cache_len)
                held[key] = cap
                if len(held) > HELD:
                    held.popitem(last=False)
            else:
                held.move_to_end(key)
            cap.token.copy_(token)
            cap.cache_len.copy_(cache_len)
            cap.graph.replay()
            add_counts(cap.launches)
            self.replays += 1
        finally:
            if spans.on:
                spans.end()
        return cap.logits, cache

    def _on_side(self, dev, fn, *args):
        """``fn(*args)`` on the side stream, ordered after the current
        stream's work and before what the current stream does next."""
        side = self._side.get(dev)
        if side is None:
            side = self._side[dev] = torch.cuda.Stream(dev)
        current = torch.cuda.current_stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = fn(*args)
        current.wait_stream(side)
        return out

    def _capture(self, dev, params, token, cache, cache_len) -> Captured:
        """A new graph of the eager step on its own copies of ``token``
        and ``cache_len``; runs no kernel and counts no launch."""
        static_token, static_len = token.clone(), cache_len.clone()
        graph = torch.cuda.CUDAGraph()

        def capture():
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                return self.eager(params, static_token, cache, static_len)[0]
            finally:
                graph.capture_end()

        before = launch_counts()
        recording = spans.on
        spans.disable()
        try:
            logits = self._on_side(dev, capture)
        finally:
            if recording:
                spans.enable()
            after = launch_counts()
            for (op, name), n in before.items():
                setattr(op, name, n)
        self.captures += 1
        return Captured(graph, static_token, static_len, logits,
                        {k: after[k] - n for k, n in before.items()
                         if after[k] != n})
