"""Step builders: train_step / prefill_step / decode_step per (arch, mesh).

The JAX package's ``build_train_step`` / ``build_prefill_step`` /
``build_decode_step`` (``src/repro/launch/steps.py:69, 135, 180``) bind a
config, an optimizer and a shape to ``lm.train_loss`` / ``lm.prefill`` /
``lm.decode_step``.  Here a step is a closure over the config (and the
optimizer, or the cache capacity).  With ``policy=None`` it runs on plain
tensors on one device; with a ``ShardingPolicy`` it takes DTensors placed
by the policy (a plain batch is placed on ``data_pspec``) and runs under
its activation policy.  ``build_step`` returns a ``StepBundle``: the
function, ``meta`` stand-ins of its inputs, and the placements of each
input and output.  The serving signatures follow the family as the JAX
steps do: an encoder-decoder's prefill takes the source frames and returns
the encoder output beside the cache, and its decode step takes that output
back; a VLM's prefill takes the patch embeddings.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch import configs as cfglib
from repro_torch.configs import resolve_shape
from repro_torch.distributed.api import activation_policy
from repro_torch.launch.graphs import GraphedDecode, dense_decoder
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, ShapeSpec
from repro_torch.optim import Optimizer, pick_optimizer, warmup_cosine
from repro_torch.optim.optimizers import _global_norm, tree_leaves, tree_map


@dataclass
class StepBundle:
    name: str
    fn: Callable
    args_sds: tuple  # meta stand-ins of the inputs
    in_placements: tuple  # per input: a tree of DTensor placements
    out_placements: Any  # per output, or None where DTensor propagates them
    static_meta: dict


def params_sds(cfg: ModelConfig):
    """The parameter tree as ``meta`` tensors (no allocation)."""
    return lm.init_params(None, cfg, device="meta")


def default_optimizer(cfg: ModelConfig) -> Optimizer:
    """AdamW (Adafactor above 20B params) on warmup_cosine(3e-4, 2000,
    100 000), the JAX package's default."""
    return pick_optimizer(cfg.param_count(), warmup_cosine(3e-4, 2000,
                                                           100_000))


def default_microbatches(cfg: ModelConfig, shape: Optional[ShapeSpec]) -> int:
    """Gradient-accumulation depth: 4 for a train shape of a model above
    100B params (its activations do not fit at the global batch), else 1."""
    if shape is None or shape.kind != "train":
        return 1
    return 4 if cfg.param_count() > 100_000_000_000 else 1


def _grads(cfg: ModelConfig, params, batch):
    """(loss, metrics, grads) of ``lm.train_loss``: grads mirror ``params``
    in the params' dtype (zeros for a leaf the loss does not reach, as JAX
    gives); loss and metrics detached."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, metrics = lm.train_loss(leaves, cfg, batch)
    flat = tree_leaves(leaves)
    gs = torch.autograd.grad(loss, flat, allow_unused=True)
    gs = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(flat, gs)])
    grads = tree_map(lambda _: next(gs), params)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def build_train_step(cfg: ModelConfig, optimizer: Optional[Optimizer] = None,
                     shape: Optional[ShapeSpec] = None,
                     microbatches: Optional[int] = None,
                     policy=None) -> Callable:
    """``train_step(params, opt_state, step, batch) -> (params, opt_state,
    step + 1, metrics)``, as the JAX step: the gradient of ``lm.train_loss``
    and one optimizer update.  ``batch`` is a dict of (B, ...) tensors; with
    ``microbatches`` > 1 it is cut along B into that many, whose gradients
    are summed in fp32 and divided by the count (the JAX ``acc_body``) and
    whose metrics are averaged.  Metrics: loss, nll, z_loss, aux_loss (fp32
    0-d tensors on the device) and, beyond the JAX step's, grad_norm, the
    global norm of the gradient the optimizer receives.  ``step`` is an int.
    The returned params do not require grad.  With a ``policy`` the step
    takes params and optimizer state as DTensors on the policy's placements
    (``ShardingPolicy.distribute``), places a plain batch on
    ``data_pspec`` and runs under the activation policy (``sharded``);
    the metrics come back as plain tensors."""
    optimizer = optimizer or default_optimizer(cfg)
    if microbatches is None:
        microbatches = default_microbatches(cfg, shape)

    def train_step(params, opt_state, step, batch):
        if policy is None:
            return plain_step(params, opt_state, step, batch)
        with sharded(policy):
            params, opt_state, step, metrics = plain_step(
                params, opt_state, step, place_batch(policy, batch))
        return params, opt_state, step, {k: full(v)
                                         for k, v in metrics.items()}

    def plain_step(params, opt_state, step, batch):
        if microbatches > 1:
            gacc, ms = None, []
            for i in range(microbatches):
                mb = {k: microbatch(v, microbatches, i)
                      for k, v in batch.items()}
                loss, metrics, grads = _grads(cfg, params, mb)
                if gacc is None:
                    gacc = tree_map(lambda g: g.to(torch.float32), grads)
                else:
                    tree_map(lambda a, g: a.add_(g.to(torch.float32)), gacc,
                             grads)
                del grads
                ms.append(dict(metrics, loss=loss))
            # in place: a second fp32 copy of every gradient would be the
            # step's peak (26 GB of fp32 for Scout cut to 2 layers)
            grads = tree_map(lambda g: g.div_(microbatches), gacc)
            del gacc
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        else:
            loss, metrics, grads = _grads(cfg, params, batch)
            metrics = dict(metrics, loss=loss)
        metrics["grad_norm"] = _global_norm(grads)
        new_params, new_opt = optimizer.update(grads, opt_state, params, step)
        return new_params, new_opt, step + 1, metrics

    return train_step


def build_prefill_step(cfg: ModelConfig, shape: ShapeSpec | str,
                       policy=None) -> Callable:
    """``prefill_step(params, tokens) -> (logits, cache)`` with the cache
    sized to the shape's sequence length; ``prefill_step(params, tokens,
    frontend)`` for a VLM, and ``-> (logits, cache, encoder_out)`` for an
    encoder-decoder, which encodes ``frontend`` once."""
    capacity = resolve_shape(shape).seq_len

    if cfg.num_encoder_layers:
        def prefill_step(params, tokens, frontend):
            enc = lm.encode(params, cfg, frontend)
            logits, cache = lm.prefill(params, cfg, tokens, capacity=capacity,
                                       encoder_out=enc)
            return logits, cache, enc
    elif cfg.frontend:
        def prefill_step(params, tokens, frontend):
            return lm.prefill(params, cfg, tokens, frontend=frontend,
                              capacity=capacity)
    else:
        def prefill_step(params, tokens):
            return lm.prefill(params, cfg, tokens, capacity=capacity)

    return _under(policy, prefill_step)


def build_decode_step(cfg: ModelConfig, shape: ShapeSpec | str,
                      policy=None) -> GraphedDecode:
    """``decode_step(params, token, cache, cache_len) -> (logits, cache)``
    for a cache of the shape's sequence length, updated in place (the JAX
    step donates it); an encoder-decoder's step also takes
    ``encoder_out``.  Without a policy, a dense decoder's step on CUDA
    tensors with a tensor ``cache_len`` replays one CUDA graph a step, and
    its logits are then valid until the next step (``launch/graphs.py``,
    which also keeps the step's counters ``captures``, ``replays`` and
    ``eager_steps``)."""
    capacity = resolve_shape(shape).seq_len

    if cfg.num_encoder_layers:
        def decode_step(params, token, cache, cache_len, encoder_out):
            return lm.decode_step(params, cfg, token, cache, cache_len,
                                  capacity=capacity, encoder_out=encoder_out)
    else:
        def decode_step(params, token, cache, cache_len):
            return lm.decode_step(params, cfg, token, cache, cache_len,
                                  capacity=capacity)

    return GraphedDecode(_under(policy, decode_step),
                         graphable=policy is None and dense_decoder(cfg))


@contextlib.contextmanager
def sharded(policy):
    """The activation policy, with plain tensors taken as replicated where
    they meet DTensors (positions, masks, the zero aux of a block)."""
    from torch.distributed.tensor.experimental import implicit_replication

    with activation_policy(policy.activation_policy()), implicit_replication():
        yield


def microbatch(v, n: int, i: int):
    """Microbatch ``i`` of ``n`` of a (B, ...) batch tensor: rows [i B/n,
    (i + 1) B/n) of a plain tensor, as the JAX step splits it.  A DTensor
    batch is split rank by rank instead, the i-th of n runs of each rank's
    local rows on the same placements: no row leaves its rank (the
    contiguous split would put each microbatch on a few data ranks, which
    DTensor cannot reshape to), and the microbatches' gradients still sum
    to the whole batch's where the loss is a mean over rows."""
    from torch.distributed.tensor import DTensor

    if isinstance(v, DTensor):
        local = v.to_local()
        part = local.reshape(n, local.shape[0] // n, *local.shape[1:])[i]
        return DTensor.from_local(part, v.device_mesh, v.placements,
                                  run_check=False)
    return v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]


def full(t):
    """A DTensor as its full value on this rank; a plain tensor as is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def place_batch(policy, batch: dict) -> dict:
    """A batch of plain (B, ...) tensors, the same on every rank, as
    DTensors on ``policy.data_pspec`` (DTensors pass through)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    return {k: v if isinstance(v, DTensor) else distribute_tensor(
        v, policy.mesh, policy.data_sharding(v)) for k, v in batch.items()}


def _under(policy, fn: Callable) -> Callable:
    """``fn`` itself without a policy; else ``fn`` under ``sharded``."""
    if policy is None:
        return fn

    def step(*args):
        with sharded(policy):
            return fn(*args)

    return step


def build_step(cfg: ModelConfig, policy, shape: ShapeSpec | str,
               optimizer: Optional[Optimizer] = None) -> StepBundle:
    """The step of ``shape.kind`` with its ``meta`` inputs and the
    placements the policy gives them (the JAX ``build_step``).  The policy
    may sit on a stand-in mesh: placements need only its axis names."""
    shape = resolve_shape(shape)
    specs = cfglib.input_specs(cfg, shape)
    p_sds = params_sds(cfg)
    p_spec = policy.param_pspecs(cfg, p_sds)
    p_pl = policy.shardings_of(p_spec)
    rep, data = policy.replicated(), policy.data_sharding
    if shape.kind == "train":
        optimizer = optimizer or default_optimizer(cfg)
        o_sds = optimizer.init(p_sds)
        o_pl = policy.shardings_of(policy.opt_pspecs(optimizer.name, p_spec,
                                                     p_sds))
        batch = specs["batch"]
        metrics = {k: rep for k in ("nll", "z_loss", "aux_loss", "loss",
                                    "grad_norm")}
        return StepBundle(
            name=f"train:{cfg.name}",
            fn=build_train_step(cfg, optimizer=optimizer, shape=shape,
                                policy=policy),
            args_sds=(p_sds, o_sds, 0, batch),
            in_placements=(p_pl, o_pl, rep, tree_map(data, batch)),
            out_placements=(p_pl, o_pl, rep, metrics),
            static_meta={"optimizer": optimizer.name, "shape": shape.name})
    if shape.kind == "prefill":
        names = ("tokens", "frontend") if cfg.frontend or \
            cfg.num_encoder_layers else ("tokens",)
        args = tuple(specs[n] for n in names)
        return StepBundle(
            name=f"prefill:{cfg.name}",
            fn=build_prefill_step(cfg, shape, policy=policy),
            args_sds=(p_sds,) + args,
            in_placements=(p_pl,) + tuple(data(a) for a in args),
            out_placements=None,  # logits data-sharded, cache per policy
            static_meta={"shape": shape.name, "capacity": shape.seq_len})
    if shape.kind == "decode":
        cache_pl = policy.shardings_of(policy.cache_pspecs(specs["cache"]))
        args = (p_sds, specs["token"], specs["cache"], specs["cache_len"])
        in_pl = (p_pl, data(specs["token"]), cache_pl, rep)
        if cfg.num_encoder_layers:
            args += (specs["encoder_out"],)
            in_pl += (data(specs["encoder_out"]),)
        logits_pl = policy.placements(policy.data_pspec(
            (shape.global_batch, cfg.vocab_size)))
        return StepBundle(
            name=f"decode:{cfg.name}",
            fn=build_decode_step(cfg, shape, policy=policy),
            args_sds=args, in_placements=in_pl,
            out_placements=(logits_pl, cache_pl),
            static_meta={"shape": shape.name, "capacity": shape.seq_len})
    raise ValueError(shape.kind)
