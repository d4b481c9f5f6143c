"""AdamW as a pure transform over a parameter tree (no ``torch.optim``).

``Optimizer`` carries two pure functions:
  * ``init(params) -> state``
  * ``update(grads, state, params, step) -> (new_params, new_state)``

A tree is a leaf (a tensor), or a dict / list of trees; state mirrors the param
tree.  This is the JAX package's own AdamW (``optim/optimizers.py``) with
its defaults — b2 = 0.95 and global-norm clipping at 1.0 — which
``torch.optim.AdamW`` does not share (its b2 is 0.999 and it never clips).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

Tree = Any
Schedule = Callable[[int], torch.Tensor]


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


def clip_by_global_norm(grads: Tree, max_norm: float) -> tuple[Tree, torch.Tensor]:
    norm = _global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), norm


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, grad_clip: float = 1.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(grads, state, params, step):
        grads, _ = clip_by_global_norm(grads, grad_clip)
        # bias corrections in float32, as the JAX version computes them
        t = torch.tensor(step + 1, dtype=torch.float32)
        bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** t
        bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** t
        lr_t = lr(step)
        dev = tree_leaves(params)[0].device
        bc1, bc2, lr_t = bc1.to(dev), bc2.to(dev), lr_t.to(dev)

        def upd(g, m, v, p):
            g32 = g.to(torch.float32)
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * torch.square(g32)
            mhat = m / bc1
            vhat = v / bc2
            delta = mhat / (torch.sqrt(vhat) + eps) \
                + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr_t * delta).to(p.dtype), m, v

        flat = tree_map(upd, grads, state["m"], state["v"], params)
        new_params = tree_map(lambda x: x[0], flat)
        new_m = tree_map(lambda x: x[1], flat)
        new_v = tree_map(lambda x: x[2], flat)
        return new_params, {"m": new_m, "v": new_v}

    return Optimizer("adamw", init, update)

