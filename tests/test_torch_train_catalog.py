"""The port's train step for the catalog's dense 7-8B models and Kimi-K2 at
their own head shapes, against the JAX package, on the CPU.

``tests/test_torch_train.py`` holds every arch's step through ``reduced()``,
which sets head_dim 16, 4 heads and, for an MoE, 8 experts top-2.  Here
each keeps what its card run trains: its published head_dim and H : Kv
ratio, rope_theta, activation, tied or untied head, Gemma's embedding scale,
and Kimi-K2's routing (384 experts top-8, one shared expert, capacity
factor 1.25, so that the dispatch drops assignments); cut to 2 layers in
fp32, stacked under remat as the published configs train:

* Gemma-7B: H 2 / Kv 2 (G 1) of hd 256, GeGLU, tied head, d_model 192;
* Granite-8B: H 8 / Kv 2 (G 4) of hd 128, tied head, d_model 1024;
* Llama-3-8B: as Granite-8B with an untied head;
* Kimi-K2: H 8 / Kv 1 (G 8) of hd 112, d_model 256, moe_d_ff 32, under
  Adafactor (the published model's choice: 1 T params is over 20 B).

The weights, N(0, 0.05^2) from a numpy seed in the tree of the JAX
package's ``params_sds``, go to JAX as they are and to the port through
``params_from_numpy``; tokens from a numpy seed.  One ``build_train_step``
step in 2 microbatches against JAX's ``value_and_grad(lm.train_loss)`` over
the same two microbatches, summed in fp32 and halved, then
``optimizer.update`` (``tests/test_torch_train_frontends.py``'s composition
and bounds): metrics rel 1e-5; the gradient the optimizer receives within
1e-4 of each leaf's max; params after the step within 1e-5 of each leaf's
max where the gradient stands clear of 0 and within 2e-2 everywhere;
optimizer state within 1e-4 of each leaf's max.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import steps as jax_steps
from repro.models import lm as jax_lm
from repro.optim import adafactor as jax_adafactor
from repro.optim import adamw as jax_adamw
from repro.optim import constant_schedule as jax_constant
from repro_torch.configs import get_config
from repro_torch.launch.steps import build_train_step, default_optimizer
from repro_torch.models import blocks, lm
from repro_torch.optim import Optimizer, adafactor, adamw, constant_schedule
from repro_torch.optim.optimizers import tree_leaves

torch.set_num_threads(1)  # several xdist workers share the cores

REL = 1e-5
GRAD_REL = 1e-4
MB, STEP, LR = 2, 3, 1e-2
DENSE_CUT = dict(num_layers=2, d_ff=256, vocab_size=512, dtype="float32")
KIMI = "kimi-k2-1t-a32b"
# arch -> (config overrides, B, S, the port's optimizer, JAX's)
CASES = {
    "gemma-7b": (dict(DENSE_CUT, num_heads=2, num_kv_heads=2, head_dim=256,
                      d_model=192), 4, 32, adamw, jax_adamw),
    "granite-8b": (dict(DENSE_CUT, num_heads=8, num_kv_heads=2,
                        head_dim=128, d_model=1024), 4, 32, adamw, jax_adamw),
    "llama3-8b": (dict(DENSE_CUT, num_heads=8, num_kv_heads=2, head_dim=128,
                       d_model=1024), 4, 32, adamw, jax_adamw),
    # S 128 a dispatch group (a row): capacity 8 slots an expert at 384
    # experts top-8, factor 1.25, which the routing overflows
    KIMI: (dict(num_layers=2, d_model=256, num_heads=8, num_kv_heads=1,
                moe_d_ff=32, vocab_size=512, dtype="float32"), 4, 128,
           adafactor, jax_adafactor),
}
ARCHS = tuple(CASES)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _sorted(tree):
    """A port tree with every dict's keys sorted, as ``jax.tree.leaves``
    walks them (Adafactor's state is ``{"row", "col"}`` in the port)."""
    if isinstance(tree, list):
        return [_sorted(t) for t in tree]
    if not isinstance(tree, dict):
        return tree
    return {k: _sorted(tree[k]) for k in sorted(tree)}


@functools.cache
def _jax_side(arch: str):
    """Seeded weights and batch, and one JAX step: the two microbatches'
    fp32 gradient mean and metric means, and the params and state after
    ``optimizer.update`` at step STEP."""
    overrides, B, S, _, jax_opt = CASES[arch]
    jcfg = jax_get_config(arch).with_overrides(**overrides)
    rng = np.random.default_rng(5)
    np_params = jax.tree.map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(s.dtype),
        jax_steps.params_sds(jcfg))
    jparams = jax.tree.map(jnp.asarray, np_params)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (B, S + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    grad_fn = jax.jit(jax.value_and_grad(jax_lm.train_loss, has_aux=True),
                      static_argnums=1)
    m = B // MB
    mbs = [grad_fn(jparams, jcfg, {k: v[i * m:(i + 1) * m]
                                   for k, v in jb.items()})
           for i in range(MB)]
    grads = jax.tree.map(
        lambda *gs: sum(g.astype(jnp.float32) for g in gs) / MB,
        *[g for _, g in mbs])
    metrics = jax.tree.map(lambda *ms: sum(ms) / MB,
                           *[dict(aux, loss=loss) for (loss, aux), _ in mbs])
    jopt = jax_opt(jax_constant(LR))
    new, state = jax.jit(jopt.update)(grads, jopt.init(jparams), jparams,
                                      jnp.int32(STEP))
    as_np = lambda t: jax.tree.map(np.asarray, t)
    return dict(np_params=np_params, batch=batch,
                metrics=jax.tree.map(float, metrics), grads=as_np(grads),
                new=as_np(new), state=as_np(state))


def test_the_published_models_keep_these_shapes_and_optimizers():
    """The cut configs keep each published model's head_dim, head group,
    rope_theta, activation, head tying, layout and (Kimi-K2) routing, and
    the optimizer is the one the published config gets from
    ``default_optimizer``."""
    for arch, (overrides, _, _, opt, _) in CASES.items():
        published = get_config(arch)
        cfg = published.with_overrides(**overrides)
        keep = ("head_dim", "rope_theta", "activation", "tie_embeddings",
                "scan_layers", "remat", "num_experts", "experts_per_token",
                "num_shared_experts", "capacity_factor")
        assert [getattr(cfg, f) for f in keep] == \
            [getattr(published, f) for f in keep]
        assert cfg.scan_layers and cfg.remat
        assert published.num_heads // published.num_kv_heads == \
            cfg.num_heads // cfg.num_kv_heads
        assert default_optimizer(published).name == \
            opt(constant_schedule(LR)).name


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax_at_published_head_shapes(arch, monkeypatch):
    j = _jax_side(arch)
    overrides, _, S, make_opt, _ = CASES[arch]
    cfg = get_config(arch).with_overrides(**overrides)
    params = lm.params_from_numpy(j["np_params"], cfg, device="cpu")
    batch = {k: torch.from_numpy(v).long() for k, v in j["batch"].items()}
    plain, seen = make_opt(constant_schedule(LR)), {}

    def update(grads, state, params, step):
        seen["grads"] = grads
        return plain.update(grads, state, params, step)

    # the dispatch's dropped assignments (slot E * C), call by call
    dropped = []
    dispatch = blocks.moe_dispatch_indices

    def counting(probs, *, top_k, capacity):
        out = dispatch(probs, top_k=top_k, capacity=capacity)
        dropped.append(int((out[2] == probs.shape[-1] * capacity).sum()))
        return out

    monkeypatch.setattr(blocks, "moe_dispatch_indices", counting)
    opt = Optimizer(plain.name, plain.init, update)
    step_fn = build_train_step(cfg, optimizer=opt, microbatches=MB)
    new, state, step, metrics = step_fn(params, opt.init(params), STEP, batch)
    assert step == STEP + 1
    if cfg.num_experts:
        assert blocks.moe_capacity(S, cfg) == 8
        assert len(dropped) >= cfg.num_layers * MB and sum(dropped) > 0
    else:
        assert not dropped
    for k in ("loss", "nll", "z_loss", "aux_loss"):
        want = j["metrics"][k]
        assert abs(float(metrics[k]) - want) <= REL * max(abs(want), 1e-6), k
    jgrads = jax.tree.leaves(j["grads"])
    grads = tree_leaves(_sorted(seen["grads"]))
    assert len(grads) == len(jgrads)
    for got, want in zip(grads, jgrads):
        assert got.shape == want.shape and _rel(got, want) < GRAD_REL
    norm = float(np.sqrt(sum(np.sum(np.square(g, dtype=np.float64))
                             for g in jgrads)))
    assert abs(float(metrics["grad_norm"]) - norm) <= REL * norm
    # AdamW's update keeps m / (sqrt(v) + eps) of the gradient clipped to
    # global norm 1: fp32-equal where |g| stands clear of the grads' 1e-4
    # difference and the clipped |g| of eps; within ~lr elsewhere
    clip = min(1.0, 1.0 / norm) if plain.name == "adamw" else 1.0
    for got, want, g in zip(tree_leaves(_sorted(new)),
                            jax.tree.leaves(j["new"]), jgrads):
        got, g = got.numpy(), np.abs(g)
        assert got.shape == want.shape
        clear = (g > 1e-3 * g.max()) & (clip * g > 1e4 * 1e-8)
        diff = np.abs(got - want)
        assert np.all(diff[clear] <= REL * np.abs(want).max() + 1e-7)
        assert np.all(diff <= 2e-2)
    got_state = tree_leaves(_sorted(state))
    want_state = jax.tree.leaves(j["state"])
    assert len(got_state) == len(want_state)
    for got, want in zip(got_state, want_state):
        assert _rel(got, want) < GRAD_REL
