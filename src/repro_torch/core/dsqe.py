"""Domain-Specific Query Encoding (paper §3.3.3) — in PyTorch.

A frozen base embedding e_q is passed through a trained MLP projection
f_θ (Eq. 10-11: Linear -> Dropout -> ReLU stack) into a space where queries
that need the same critical component set cluster; K learnable prototype
vectors {v_k} represent CCA's distinct component sets.  Training optimizes
(Eq. 12):

    L = L_contrast + α·L_diversity + β·L_reg

  * contrastive: InfoNCE of the query against its set's prototype,
  * diversity: mean pairwise prototype cosine (pushed down, anti-collapse),
  * reg: L2 on projection weights.

Parameters keep the JAX package's layout, ``{"layers": [{"w", "b"}],
"protos"}``, as float32 tensors on the encoder's device;
``DSQE.from_numpy`` / ``DSQE.to_numpy`` carry them across packages.
Randomness comes from an explicit ``torch.Generator`` seeded from ``seed``;
it does not reproduce ``jax.random`` streams, so a trained encoder matches
the JAX one in quality, not bit for bit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.stages import Stage
from repro_torch.optim import adamw, constant_schedule
from repro_torch.optim.optimizers import tree_leaves, tree_map


def projection_stage(params: dict, *, in_key: str = "emb",
                     out_key: str = "z") -> Stage:
    """Device stage wrapping the trained DSQE projection.

    State: the parameter tree (already on its device).  Adds the unit-norm
    projection ``carry[out_key]`` (B, d) of ``carry[in_key]``.
    """
    def init():
        def apply(params_dev, carry):
            return {**carry, out_key: project(params_dev, carry[in_key])}

        return params, apply

    return Stage("dsqe_project", init)


@dataclass
class DSQE:
    params: dict  # float32 tensors on ``device``
    n_sets: int
    temperature: float = 0.1
    device: torch.device = torch.device("cpu")

    @classmethod
    def from_numpy(cls, params: dict, n_sets: int, *,
                   temperature: float = 0.1, device="cuda") -> "DSQE":
        """An encoder from numpy params in the JAX package's layout (as
        ``repro.core.dsqe.DSQE.params`` holds them after training)."""
        dev = resolve_device(device)
        tensors = tree_map(
            lambda x: torch.tensor(np.asarray(x, np.float32), device=dev),
            params)
        return cls(params=tensors, n_sets=n_sets, temperature=temperature,
                   device=dev)

    def to_numpy(self) -> dict:
        """The params as numpy float32 arrays, in the same layout."""
        return tree_map(lambda t: t.detach().cpu().numpy(), self.params)

    def project(self, e) -> torch.Tensor:
        """Unit-norm projection of (..., d_in) embeddings (numpy or tensor)
        as a float32 tensor on the encoder's device."""
        e = torch.as_tensor(e, dtype=torch.float32, device=self.device)
        return project(self.params, e, dropout_rng=None)

    def as_stage(self, *, in_key: str = "emb", out_key: str = "z") -> Stage:
        """This encoder's frozen projection as a composable device stage."""
        return projection_stage(self.params, in_key=in_key, out_key=out_key)

    def predict_set(self, e) -> torch.Tensor:
        """Most-similar prototype index per query. e: (..., d)."""
        z = self.project(e)
        sims = prototype_sims(self.params, z)
        return torch.argmax(sims, dim=-1)


def init_dsqe(gen: torch.Generator, d_in: int, n_sets: int,
              d_hidden: int = 256, n_layers: int = 2) -> dict:
    dev = gen.device
    layers = []
    dims = [d_in] + [d_hidden] * n_layers
    for i in range(n_layers):
        w = torch.randn((dims[i], dims[i + 1]), generator=gen, device=dev)
        layers.append({"w": w / math.sqrt(dims[i]),
                       "b": torch.zeros((dims[i + 1],), device=dev)})
    protos = torch.randn((n_sets, dims[-1]), generator=gen, device=dev)
    protos = protos / torch.linalg.norm(protos, dim=-1, keepdim=True)
    return {"layers": layers, "protos": protos}


def project(params: dict, e: torch.Tensor, dropout_rng=None,
            dropout: float = 0.1) -> torch.Tensor:
    x = e
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        x = x @ layer["w"] + layer["b"]
        if dropout_rng is not None:
            keep = torch.rand(x.shape, generator=dropout_rng,
                              device=x.device) < 1 - dropout
            x = torch.where(keep, x / (1 - dropout), 0.0)
        if i < n - 1:
            x = torch.relu(x)
    return x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True), 1e-6)


def prototype_sims(params: dict, z: torch.Tensor) -> torch.Tensor:
    protos = params["protos"]
    protos = protos / torch.clamp_min(
        torch.linalg.norm(protos, dim=-1, keepdim=True), 1e-6)
    return z @ protos.T


def dsqe_loss(params: dict, e: torch.Tensor, labels: torch.Tensor, rng,
              temperature: float = 0.1, alpha: float = 0.5,
              beta: float = 1e-4):
    z = project(params, e, dropout_rng=rng)
    sims = prototype_sims(params, z) / temperature  # (B, K)
    logp = torch.log_softmax(sims, dim=-1)
    contrast = -torch.mean(logp[torch.arange(e.shape[0], device=e.device),
                                labels])
    protos = params["protos"]
    protos = protos / torch.clamp_min(
        torch.linalg.norm(protos, dim=-1, keepdim=True), 1e-6)
    K = protos.shape[0]
    gram = protos @ protos.T
    off = gram - torch.eye(K, device=gram.device) * gram
    diversity = torch.sum(torch.relu(off)) / max(K * (K - 1), 1)
    reg = sum(torch.sum(torch.square(l["w"])) for l in params["layers"])
    total = contrast + alpha * diversity + beta * reg
    return total, {"contrast": contrast, "diversity": diversity, "reg": reg}


def loss_grads(params: dict, e: torch.Tensor, labels: torch.Tensor, rng,
               temperature: float = 0.1):
    """(loss, grads) of ``dsqe_loss``; grads mirror the params tree."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, _ = dsqe_loss(leaves, e, labels, rng, temperature)
    g = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
    grads = tree_map(lambda _: next(g), leaves)  # same leaf order
    return loss.detach(), grads


def train_dsqe(embeddings: np.ndarray, set_ids: np.ndarray, n_sets: int,
               *, steps: int = 400, batch: int = 64, lr: float = 3e-3,
               seed: int = 0, temperature: float = 0.1,
               device="cuda") -> DSQE:
    """Train projection + prototypes on CCA labels.  Returns a frozen DSQE."""
    dev = resolve_device(device)
    d = embeddings.shape[1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = init_dsqe(gen, d, n_sets)
    opt = adamw(constant_schedule(lr), weight_decay=0.0)
    opt_state = opt.init(params)
    e_all = torch.as_tensor(np.asarray(embeddings, np.float32), device=dev)
    y_all = torch.as_tensor(np.asarray(set_ids, np.int64), device=dev)
    n = e_all.shape[0]
    for i in range(steps):
        idx = torch.randint(0, n, (min(batch, n),), generator=gen, device=dev)
        _, grads = loss_grads(params, e_all[idx], y_all[idx], gen,
                              temperature)
        params, opt_state = opt.update(grads, opt_state, params, i)
    params = tree_map(lambda t: t.detach(), params)
    return DSQE(params=params, n_sets=n_sets, temperature=temperature,
                device=dev)
