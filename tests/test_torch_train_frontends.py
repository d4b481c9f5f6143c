"""The port's train step for the encoder-decoder, VLM and xLSTM families
against the JAX package, on the CPU.

Reduced SeamlessM4T (AdamW), LLaVA (Adafactor: the published model's
choice, 34.4 B params being over 20 B) and xLSTM (AdamW), the port's seeded
weights carried to JAX (``params_to_numpy``: JAX's eager init is most of
the time otherwise), a seeded float ``frontend`` where the family has one
(stub audio frames, S of them; patch embeddings, ``frontend_len`` of
them):

* one ``build_train_step`` step in 2 microbatches (the float frontend
  split along B with the tokens, ``launch/steps.py: microbatch``) against
  JAX's ``value_and_grad(lm.train_loss)`` over the same two microbatches,
  summed in fp32 and halved (the JAX step's ``acc_body``), then
  ``optimizer.update``; per-unit, and stacked under remat where the
  optimizer is AdamW (elementwise, so the per-unit JAX step is the
  reference; Adafactor clips its update over a whole leaf, and a stacked
  leaf holds every unit).  Metrics rel
  1e-5; the gradient the optimizer receives within 1e-4 of each leaf's
  max; params after the step within 1e-5 of each leaf's max where the
  gradient stands clear of 0 and within 2e-2 everywhere; optimizer state
  within 1e-4 of each leaf's max (``tests/test_torch_train.py``'s bounds);
* ``launch.train.train`` on each family: finite losses, the driver's
  stub frontend drawn from each step's seed;
* the JAX driver's zero frontend overflows the gradient to NaN at depth
  in both packages' ``lm.train_loss`` (the port's driver draws it
  instead), and the port's driver trains SeamlessM4T's 12 encoder layers.

The JAX driver's ``train`` fails under jax 0.9.0 (ROADMAP.md §3), so the
JAX side is composed from ``lm.train_loss`` and the optimizer, jitted, once
per arch.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jax_lm
from repro.optim import adafactor as jax_adafactor
from repro.optim import adamw as jax_adamw
from repro.optim import constant_schedule as jax_constant
from repro_torch.configs import get_config
from repro_torch.launch.steps import build_train_step, default_optimizer
from repro_torch.models import lm
from repro_torch.optim import Optimizer, adafactor, adamw, constant_schedule
from repro_torch.optim.optimizers import tree_leaves, tree_map

torch.set_num_threads(1)  # several xdist workers share the cores

REL = 1e-5
GRAD_REL = 1e-4
B, S, MB, STEP, LR = 4, 16, 2, 3, 1e-2

# arch -> (the port's optimizer, JAX's): the published model's choice
OPTIMIZERS = {
    "seamless-m4t-medium": (adamw, jax_adamw),
    "llava-next-34b": (adafactor, jax_adafactor),
    "xlstm-125m": (adamw, jax_adamw),
}
ARCHS = tuple(OPTIMIZERS)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


@functools.cache
def _jax_side(arch: str):
    """JAX weights, a batch with a seeded float frontend, and one JAX step:
    the two microbatches' fp32 gradient mean and metric means, and the
    params and state after ``optimizer.update`` at step STEP."""
    jcfg = jax_get_config(arch).reduced()
    gen = torch.Generator()
    gen.manual_seed(0)
    np_params = lm.params_to_numpy(lm.init_params(gen,
                                                  get_config(arch).reduced()))
    jparams = jax.tree.map(jnp.asarray, np_params)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if jcfg.frontend:
        n = S if jcfg.frontend == "audio" else jcfg.frontend_len
        batch["frontend"] = rng.standard_normal(
            (B, n, jcfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
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
    jopt = OPTIMIZERS[arch][1](jax_constant(LR))
    new, state = jax.jit(jopt.update)(grads, jopt.init(jparams), jparams,
                                      jnp.int32(STEP))
    as_np = lambda t: jax.tree.map(np.asarray, t)
    return dict(np_params=np_params, batch=batch,
                metrics=jax.tree.map(float, metrics), grads=as_np(grads),
                new=as_np(new), state=as_np(state))


def _as_jax(tree, stacked: bool):
    """A port tree laid out as the JAX reduced config's: every stacked
    ``units`` (the decoder's, an encoder's) as a list of units, and every
    dict's keys sorted, as ``jax.tree.leaves`` walks them (Adafactor's
    state is ``{"row", "col"}`` in the port's order)."""
    if isinstance(tree, list):
        return [_as_jax(t, stacked) for t in tree]
    if not isinstance(tree, dict):
        return tree
    if stacked and "units" in tree:
        units = tree["units"]
        n = len(tree_leaves(units)[0])
        tree = dict(tree, units=[tree_map(lambda t: t[i], units)
                                 for i in range(n)])
    return {k: _as_jax(tree[k], stacked) for k in sorted(tree)}


def test_the_published_models_pick_these_optimizers():
    """The optimizers the step tests take are the ones the published
    configs get from ``default_optimizer`` (20 B params the line)."""
    for arch, (opt, _) in OPTIMIZERS.items():
        assert default_optimizer(get_config(arch)).name == \
            opt(constant_schedule(LR)).name


@pytest.mark.parametrize("arch,stacked", [
    (arch, False) for arch in ARCHS] + [
    (arch, True) for arch in ARCHS if OPTIMIZERS[arch][0] is adamw])
def test_train_step_with_frontend_matches_jax(arch, stacked):
    j = _jax_side(arch)
    cfg = get_config(arch).reduced()
    if stacked:
        cfg = cfg.with_overrides(scan_layers=True, remat=True)
    params = lm.params_from_numpy(j["np_params"], cfg, device="cpu")
    batch = {k: torch.from_numpy(v) if k == "frontend"
             else torch.from_numpy(v).long() for k, v in j["batch"].items()}
    plain, seen = OPTIMIZERS[arch][0](constant_schedule(LR)), {}

    def update(grads, state, params, step):
        seen["grads"] = grads
        return plain.update(grads, state, params, step)

    opt = Optimizer(plain.name, plain.init, update)
    step_fn = build_train_step(cfg, optimizer=opt, microbatches=MB)
    new, state, step, metrics = step_fn(params, opt.init(params), STEP, batch)
    assert step == STEP + 1
    for k in ("loss", "nll", "z_loss", "aux_loss"):
        want = j["metrics"][k]
        assert abs(float(metrics[k]) - want) <= REL * max(abs(want), 1e-6)
    jgrads = jax.tree.leaves(j["grads"])
    grads = tree_leaves(_as_jax(seen["grads"], stacked))
    assert len(grads) == len(jgrads)
    for got, want in zip(grads, jgrads):
        assert got.shape == want.shape and _rel(got, want) < GRAD_REL
    norm = float(np.sqrt(sum(np.sum(np.square(g, dtype=np.float64))
                             for g in jgrads)))
    assert abs(float(metrics["grad_norm"]) - norm) <= REL * norm
    new, state = _as_jax(new, stacked), _as_jax(state, stacked)
    # AdamW's update keeps m / (sqrt(v) + eps) of the gradient clipped to
    # global norm 1: fp32-equal where |g| stands clear of the grads' 1e-4
    # difference and the clipped |g| of eps (reduced xLSTM's norm is ~100,
    # so elements at 1e-3 of a leaf's max come within 20 eps of it, where
    # the update follows the gradient's rounding); within ~lr elsewhere
    clip = min(1.0, 1.0 / norm) if plain.name == "adamw" else 1.0
    for got, want, g in zip(tree_leaves(new), jax.tree.leaves(j["new"]),
                            jgrads):
        got, g = got.numpy(), np.abs(g)
        assert got.shape == want.shape
        clear = (g > 1e-3 * g.max()) & (clip * g > 1e4 * 1e-8)
        diff = np.abs(got - want)
        assert np.all(diff[clear] <= REL * np.abs(want).max() + 1e-7)
        assert np.all(diff <= 2e-2)
    got_state, want_state = tree_leaves(state), jax.tree.leaves(j["state"])
    assert len(got_state) == len(want_state)
    for got, want in zip(got_state, want_state):
        assert _rel(got, want) < GRAD_REL


@pytest.mark.parametrize("arch", ARCHS)
def test_train_driver_runs_each_family(arch, monkeypatch):
    """``launch.train.train`` on the CPU, 2 steps of 4 x 32: finite losses;
    the driver hands an audio model S stub frames and a VLM
    ``frontend_len`` stub patches a row, in the activation dtype, drawn
    from the step's seed (``stub_frontend``), and xLSTM none."""
    import repro_torch.launch.train as train_mod

    seen = []
    orig = train_mod.build_train_step

    def recording(*a, **kw):
        step_fn = orig(*a, **kw)

        def step(params, opt_state, i, batch):
            seen.append(batch.get("frontend"))
            return step_fn(params, opt_state, i, batch)

        return step

    monkeypatch.setattr(train_mod, "build_train_step", recording)
    losses = train_mod.train(arch, device="cpu", steps=2, batch=4, seq=32,
                             log_every=100)
    assert len(losses) == 2 and all(np.isfinite(losses))
    cfg = get_config(arch).reduced()
    assert len(seen) == 2
    for i, f in enumerate(seen):
        if not cfg.frontend:
            assert f is None
            continue
        n = 32 if cfg.frontend == "audio" else cfg.frontend_len
        assert f.shape == (4, n, cfg.d_model)
        assert f.dtype == cfg.activation_dtype
        assert torch.equal(f, train_mod.stub_frontend(cfg, 4, 32, i, "cpu"))
    if cfg.frontend:
        assert not torch.equal(seen[0], seen[1])
        assert 0.9 < float(seen[0].std()) < 1.1


# a zero stub frontend at depth: (arch, the depth field, its value)
ZERO_FRONTEND_DEPTH = [("seamless-m4t-medium", "num_encoder_layers", 8),
                       ("llava-next-34b", "num_layers", 16)]


@pytest.mark.parametrize("arch,field,depth", ZERO_FRONTEND_DEPTH)
def test_a_zero_stub_frontend_overflows_the_gradient_in_both_packages(
        arch, field, depth):
    """The JAX driver's zero frames (patches): every ``rms_norm`` at a zero
    row passes its gradient on times rsqrt(eps), so at depth the gradient
    overflows to NaN, in ``lm.train_loss`` of both packages alike; on the
    driver's seeded stub input both are finite.  Reduced widths, the
    encoder (decoder) cut to ``depth`` layers, fp32, stacked units (JAX
    compiles one scanned unit)."""
    depth = {field: depth, "scan_layers": True}
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **depth)
    cfg = get_config(arch).reduced().with_overrides(**depth)
    grad_fn = jax.jit(jax.grad(lambda p, b: jax_lm.train_loss(p, jcfg, b)[0]))
    gen = torch.Generator()
    gen.manual_seed(0)
    np_params = lm.params_to_numpy(lm.init_params(gen, cfg))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, S + 1))
    n = S if cfg.frontend == "audio" else cfg.frontend_len
    for frames, finite in ((np.zeros((2, n, cfg.d_model), np.float32),
                            False),
                           (rng.standard_normal((2, n, cfg.d_model))
                            .astype(np.float32), True)):
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                 "frontend": frames}
        jgrads = grad_fn(jax.tree.map(jnp.asarray, np_params),
                         {k: jnp.asarray(v) for k, v in batch.items()})
        params = lm.params_from_numpy(np_params, cfg, device="cpu")
        leaves = tree_map(lambda t: t.requires_grad_(True), params)
        loss, _ = lm.train_loss(leaves, cfg, {
            k: torch.from_numpy(v) if k == "frontend"
            else torch.from_numpy(v).long() for k, v in batch.items()})
        grads = torch.autograd.grad(loss, tree_leaves(leaves),
                                    allow_unused=True)
        assert bool(torch.isfinite(loss))
        assert all(bool(np.isfinite(g).all())
                   for g in jax.tree.leaves(jgrads)) == finite
        assert all(g is None or bool(torch.isfinite(g).all())
                   for g in grads) == finite


def test_train_driver_trains_seamless_at_its_published_encoder_depth(
        monkeypatch):
    """The driver at SeamlessM4T-medium's 12 encoder layers (reduced
    widths, 2 decoder layers, fp32): its seeded stub frames keep every
    step's loss and gradient norm finite, where zero frames give NaN."""
    import repro_torch.configs as cfglib
    from repro_torch.launch.train import train

    cfg = get_config("seamless-m4t-medium").reduced().with_overrides(
        num_encoder_layers=12)
    monkeypatch.setattr(cfglib, "get_config", lambda name: cfg)
    norms = []
    losses = train("seamless-m4t-medium", reduced=False, device="cpu",
                   steps=2, batch=2, seq=16, log_every=100,
                   on_step=lambda i, m: norms.append(m["grad_norm"]))
    assert all(np.isfinite(losses)) and all(np.isfinite(norms))
