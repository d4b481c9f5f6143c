"""Optimizers as transforms over a parameter tree (no ``torch.optim``).

``Optimizer`` carries two functions:
  * ``init(params) -> state``
  * ``update(grads, state, params, step) -> (new_params, new_state)``

AdamW updates the moments of ``state`` in place and returns that state (the
JAX version returns new moments; a second copy of them would set a train
step's peak memory); params and grads are never written.

A tree is a leaf (a tensor), or a dict / list of trees; state mirrors the param
tree.  These are the JAX package's own optimizers (``optim/optimizers.py``)
with its defaults: AdamW with b2 = 0.95 and global-norm clipping at 1.0
(``torch.optim.AdamW`` has b2 = 0.999 and never clips), Adafactor with
factored second moments for leaves of two or more dims, and SGD with
momentum; ``pick_optimizer`` takes Adafactor above 20B parameters.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

Tree = Any
Schedule = Callable[[int], torch.Tensor]
# Adafactor updates a stacked leaf of 3+ dims above this many bytes of fp32
# one leading slice at a time, as the JAX package does (lax.map)
ADAFACTOR_SLICE_BYTES = 1 << 28


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree, int], tuple[Tree, Tree]]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def _global_norm(tree: Tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree_leaves(tree)]
    return torch.sqrt(sum(leaves))


def _clip_scale(grads: Tree, max_norm: float):
    """(the factor that brings the global norm to at most ``max_norm``, the
    global norm)."""
    norm = _global_norm(grads)
    return torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0), norm


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.to(torch.float32) * scale).to(g.dtype)


def clip_by_global_norm(grads: Tree, max_norm: float) -> tuple[Tree, torch.Tensor]:
    scale, norm = _clip_scale(grads, max_norm)
    return tree_map(lambda g: _clipped(g, scale), grads), norm


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, grad_clip: float = 1.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(grads, state, params, step):
        scale, _ = _clip_scale(grads, grad_clip)
        # bias corrections in float32, as the JAX version computes them
        t = torch.tensor(step + 1, dtype=torch.float32)
        bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** t
        bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** t
        lr_t = lr(step)
        dev = tree_leaves(params)[0].device
        bc1, bc2, lr_t = bc1.to(dev), bc2.to(dev), lr_t.to(dev)

        def upd(g, m, v, p):
            # the clipped gradient one leaf at a time, and the moments in
            # place (the same operations in the same order): a clipped copy
            # of every gradient or a second copy of the fp32 moments would
            # set the train step's peak memory
            g32 = _clipped(g, scale).to(torch.float32)
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_((1 - b2) * torch.square(g32))
            mhat = m / bc1
            vhat = v / bc2
            delta = mhat / (torch.sqrt(vhat) + eps) \
                + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr_t * delta).to(p.dtype)

        new_params = tree_map(upd, grads, state["m"], state["v"], params)
        return new_params, state

    return Optimizer("adamw", init, update)



# ---------------------------------------------------------------------------
# Adafactor (factored second moments, no first moment)
# ---------------------------------------------------------------------------

def adafactor(lr: Schedule, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    def _factored(p) -> bool:
        return p.dim() >= 2

    def init(params):
        def st(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p):
                return {"row": torch.zeros(p.shape[:-1], **f32),
                        "col": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}

        return tree_map(st, params)

    def update(grads, state, params, step):
        dev = tree_leaves(params)[0].device
        t = torch.tensor(step + 1, dtype=torch.float32)
        beta = (1.0 - t ** (-decay)).to(dev)
        lr_t = lr(step).to(dev)

        def upd_one(g, s, p):
            # Each full-size fp32 temporary is freed or overwritten in place
            # as soon as it is used (the same operations in the same order):
            # for a large leaf (an (E, D, F) expert slice) the temporaries,
            # not the state, set the step's peak memory.
            g32 = g.to(torch.float32)
            g2 = torch.square(g32).add_(eps)
            if _factored(p):
                row = _placed_like(beta * s["row"]
                                   + (1 - beta) * g2.mean(dim=-1), s["row"])
                col = _placed_like(beta * s["col"]
                                   + (1 - beta) * g2.mean(dim=-2), s["col"])
                del g2
                row_mean = row.mean(dim=-1, keepdim=True)
                den = (row / torch.clamp_min(row_mean, eps))[..., None] \
                    * col[..., None, :]
                den.clamp_min_(eps).sqrt_()
                new_s = {"row": row, "col": col}
            else:
                vhat = beta * s["v"] + (1 - beta) * g2
                del g2
                den = torch.sqrt(torch.clamp_min(vhat, eps))
                new_s = {"v": vhat}
            u = g32 / den
            del den
            # update clipping (RMS of update <= clip_threshold)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u.div_(torch.clamp_min(rms / clip_threshold, 1.0))
            p32 = p.to(torch.float32, copy=True)  # p itself when fp32
            delta = u.add_(weight_decay * p32)
            return p32.sub_(lr_t * delta).to(p.dtype), new_s

        def upd(g, s, p):
            # Stacked-layer leaves (L, ...) are updated one slice at a time,
            # as the JAX package's lax.map: the update clipping then acts per
            # slice, and the fp32 transient stays at one layer's slice.
            if p.dim() >= 3 and p.numel() * 4 > ADAFACTOR_SLICE_BYTES:
                parts = [upd_one(g[i], tree_map(lambda x: x[i], s), p[i])
                         for i in range(p.shape[0])]
                return (torch.stack([x[0] for x in parts]),
                        tree_map(lambda *xs: torch.stack(xs),
                                 *[x[1] for x in parts]))
            return upd_one(g, s, p)

        flat = _map_with_state(upd, grads, state, params)
        new_params = tree_map(lambda x: x[0], flat)
        new_state = tree_map(lambda x: x[1], flat)
        return new_params, new_state

    return Optimizer("adafactor", init, update)


def _placed_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` on ``ref``'s DTensor placements; a plain tensor as is.  A
    mean over a sharded dim leaves a ``Partial`` DTensor, which the
    in-place ops after it cannot take; the state keeps its placements."""
    if hasattr(ref, "placements") and t.placements != ref.placements:
        return t.redistribute(ref.device_mesh, ref.placements)
    return t


def _map_with_state(fn, grads, state, params):
    """``fn(g, s, p)`` at each param leaf, where ``s`` is the state subtree
    (a dict of moment tensors) that mirrors that leaf."""
    if isinstance(params, dict):
        return {k: _map_with_state(fn, grads[k], state[k], params[k])
                for k in params}
    if isinstance(params, list):
        return [_map_with_state(fn, g, s, p)
                for g, s, p in zip(grads, state, params)]
    return fn(grads, state, params)


# ---------------------------------------------------------------------------
# SGD + momentum
# ---------------------------------------------------------------------------

def sgd(lr: Schedule, momentum: float = 0.9,
        grad_clip: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)}

    def update(grads, state, params, step):
        if grad_clip:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        lr_t = lr(step).to(tree_leaves(params)[0].device)

        def upd(g, m, p):
            m = momentum * m + g.to(torch.float32)
            return (p.to(torch.float32) - lr_t * m).to(p.dtype), m

        flat = tree_map(upd, grads, state["m"], params)
        return (tree_map(lambda x: x[0], flat),
                {"m": tree_map(lambda x: x[1], flat)})

    return Optimizer("sgd", init, update)


def pick_optimizer(param_count: int, lr_schedule: Schedule) -> Optimizer:
    """Framework default: Adafactor above 20B params (state memory), AdamW
    otherwise."""
    if param_count > 20_000_000_000:
        return adafactor(lr_schedule)
    return adamw(lr_schedule)
