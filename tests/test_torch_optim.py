"""The port's optimizers, schedules and gradient compression
(``repro_torch.optim``) against the JAX package's, on the CPU.

Identical numpy trees go through both.  Tolerances: optimizer updates rel
1e-6 of each leaf's largest value (the same fp32 arithmetic, reductions
summed in another order); schedules equal to 1 ulp of fp32; int8 codes and
scales of the gradient compression exactly equal (max-abs scales and
half-to-even rounding on both sides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro.optim import grad_compression as jax_gc
from repro.optim import schedules as jax_schedules
from repro_torch import optim
from repro_torch.optim import grad_compression as gc
from repro_torch.optim import optimizers
from repro_torch.optim import schedules
from repro_torch.optim.optimizers import tree_leaves

REL = 1e-6


def _tree(rng, scale=1.0):
    return {"w": (rng.standard_normal((6, 5)) * scale).astype(np.float32),
            "b": (rng.standard_normal(7) * scale).astype(np.float32),
            "stack": [{"k": (rng.standard_normal((3, 4, 8)) * scale
                             ).astype(np.float32)}]}


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(port, ref, rel=REL):
    # both in JAX's leaf order (dict keys sorted; torch tensors are leaves)
    got, want = jax.tree.leaves(port), jax.tree.leaves(ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert np.max(np.abs(g.numpy() - w)) <= rel * max(np.abs(w).max(),
                                                         1e-30)


@pytest.mark.parametrize("name,kw", [
    ("adamw", {}), ("adamw", dict(weight_decay=0.0, grad_clip=0.5)),
    ("adafactor", {}), ("adafactor", dict(weight_decay=0.1)),
    ("sgd", {}), ("sgd", dict(grad_clip=0.5))])
def test_optimizer_updates_match_jax(name, kw):
    """Three updates from the same params and grads (grads large enough
    that AdamW's clip acts); params and state equal."""
    rng = np.random.default_rng(len(name) + len(kw))
    params = _tree(rng)
    jopt = getattr(jax_optim, name)(jax_optim.constant_schedule(0.05), **kw)
    opt = getattr(optim, name)(optim.constant_schedule(0.05), **kw)
    jp, jstate = _j(params), None
    tp, state = _t(params), None
    jstate, state = jopt.init(jp), opt.init(tp)
    for step in range(3):
        grads = _tree(rng, scale=3.0)
        jp, jstate = jopt.update(_j(grads), jstate, jp, jnp.int32(step))
        tp, state = opt.update(_t(grads), state, tp, step)
    _close(tp, jp)
    _close(state, jstate)


def test_adafactor_updates_large_stacked_leaves_slice_by_slice(monkeypatch):
    """A stacked leaf above the size threshold is updated one leading slice
    at a time (the JAX package's ``lax.map``), so update clipping acts per
    slice: equal to JAX's update of each slice as its own leaf."""
    monkeypatch.setattr(optimizers, "ADAFACTOR_SLICE_BYTES", 64)
    rng = np.random.default_rng(3)
    p = rng.standard_normal((4, 8, 16)).astype(np.float32)
    g = (rng.standard_normal((4, 8, 16))
         * np.array([1, 10, 0.1, 3])[:, None, None]).astype(np.float32)
    opt = optim.adafactor(optim.constant_schedule(0.05))
    new, state = opt.update({"w": torch.from_numpy(g)},
                            opt.init({"w": torch.from_numpy(p)}),
                            {"w": torch.from_numpy(p)}, 0)
    jopt = jax_optim.adafactor(jax_optim.constant_schedule(0.05))
    for i in range(4):
        jp = {"w": jnp.asarray(p[i])}
        jnew, jstate = jopt.update({"w": jnp.asarray(g[i])}, jopt.init(jp),
                                   jp, jnp.int32(0))
        _close({"w": new["w"][i]}, jnew)
        _close({"row": state["w"]["row"][i], "col": state["w"]["col"][i]},
               {"row": jstate["w"]["row"], "col": jstate["w"]["col"]})


def test_pick_optimizer_follows_the_jax_threshold():
    lr = optim.constant_schedule(1e-3)
    assert optim.pick_optimizer(20_000_000_000, lr).name == "adamw"
    assert optim.pick_optimizer(20_000_000_001, lr).name == "adafactor"
    assert jax_optim.pick_optimizer(20_000_000_001, lr).name == "adafactor"


@pytest.mark.parametrize("make", ["warmup_cosine", "linear_warmup_rsqrt"])
def test_schedules_match_jax(make):
    args = (3e-4, 2000, 100_000) if make == "warmup_cosine" else (3e-4, 2000)
    fn, jfn = getattr(schedules, make)(*args), getattr(jax_schedules,
                                                       make)(*args)
    for step in (0, 1, 1999, 2000, 50_000, 100_000, 150_000):
        got, want = float(fn(step)), float(jfn(jnp.int32(step)))
        assert got == pytest.approx(want, rel=2 ** -23, abs=1e-12), step
    assert float(fn(0)) == 0.0


@pytest.mark.parametrize("n", [1, 256, 1000, 3 * 256 + 7])
def test_grad_compression_is_bit_equal_to_jax(n):
    """int8 codes and scales equal, including exact half-way values (x.5 x
    scale rounds half to even on both sides) and an all-zero block."""
    rng = np.random.default_rng(n)
    g = rng.standard_normal(n).astype(np.float32) * 3
    if n > 512:
        g[256:512] = 0.0  # a block of zeros: scale 0
    if n >= 4:
        g[:4] = [127.0, 0.5, 1.5, -2.5]  # scale 1: codes 127, 0, 2, -2
    grads = {"w": g.reshape(-1, 1) if n % 2 else g, "b": g[: max(n // 3, 1)]}
    # error feedback on "b" only, so that "w" keeps its exact ties
    err = {"w": np.zeros_like(grads["w"]),
           "b": (grads["b"] * 0.01).astype(np.float32)}
    comp, new_err = gc.compress_tree(_t(grads), _t(err))
    jcomp, jnew_err = jax_gc.compress_tree(_j(grads), _j(err))
    if n >= 4:
        assert comp["w"]["q"].reshape(-1)[:4].tolist() == [127, 0, 2, -2]
    for key in grads:
        np.testing.assert_array_equal(comp[key]["q"].numpy(),
                                      np.asarray(jcomp[key]["q"]))
        np.testing.assert_array_equal(comp[key]["s"].numpy(),
                                      np.asarray(jcomp[key]["s"]))
        np.testing.assert_array_equal(new_err[key].numpy(),
                                      np.asarray(jnew_err[key]))
    deq = gc.decompress_tree(comp, _t(grads))
    jdeq = jax_gc.decompress_tree(jcomp, _j(grads))
    for key in grads:
        np.testing.assert_array_equal(deq[key].numpy(), np.asarray(jdeq[key]))
    z = gc.init_error(_t(grads))
    assert all(float(t.abs().max()) == 0 and t.dtype == torch.float32
               for t in tree_leaves(z))


def test_grad_compression_round_trip_of_bf16_leaves():
    g = torch.randn(300, dtype=torch.float32).bfloat16()
    comp, err = gc.compress_tree({"g": g}, gc.init_error({"g": g}))
    out = gc.decompress_tree(comp, {"g": g})["g"]
    assert out.dtype == torch.bfloat16 and out.shape == g.shape
    q = comp["g"]["q"]
    assert q.dtype == torch.int8 and q.shape == (2, 256)
    assert float((out.float() + err["g"] - g.float()).abs().max()) < 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adafactor_leaves_its_inputs_unchanged(monkeypatch, dtype):
    """The update overwrites its fp32 temporaries in place, never the params,
    grads or state it is given (an fp32 param is its own fp32 view), in the
    whole-leaf and the slice-by-slice path."""
    monkeypatch.setattr(optimizers, "ADAFACTOR_SLICE_BYTES", 64)
    rng = np.random.default_rng(5)
    params = {"w": torch.from_numpy(rng.standard_normal((3, 8, 16))
                                    .astype(np.float32)).to(dtype),
              "b": torch.from_numpy(rng.standard_normal(16)
                                    .astype(np.float32)).to(dtype)}
    grads = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(
        1)).to(dtype) for k, v in params.items()}
    opt = optim.adafactor(optim.constant_schedule(0.05), weight_decay=0.1)
    state = opt.update(grads, opt.init(params), params, 0)[1]
    before = [t.clone() for t in tree_leaves([params, grads, state])]
    new, _ = opt.update(grads, state, params, 1)
    after = tree_leaves([params, grads, state])
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert not any(torch.equal(n, p)
                   for n, p in zip(tree_leaves(new), tree_leaves(params)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_updates_its_moments_in_place_and_nothing_else(dtype):
    """AdamW writes the moments it is given (and returns them) and neither
    the params nor the grads; the clip scales each gradient as
    ``clip_by_global_norm`` does (a norm above 1 is clipped here)."""
    rng = np.random.default_rng(6)
    params = {"w": torch.from_numpy(rng.standard_normal((8, 16))
                                    .astype(np.float32)).to(dtype)}
    grads = {"w": torch.from_numpy(3 * rng.standard_normal((8, 16))
                                   .astype(np.float32)).to(dtype)}
    opt = optim.adamw(optim.constant_schedule(0.05))
    state = opt.init(params)
    kept = [t.clone() for t in tree_leaves([params, grads])]
    new, new_state = opt.update(grads, state, params, 0)
    assert all(torch.equal(a, b)
               for a, b in zip(kept, tree_leaves([params, grads])))
    assert new_state["m"]["w"] is state["m"]["w"]
    assert new_state["v"]["w"] is state["v"]["w"]
    clipped, _ = optim.clip_by_global_norm(grads, 1.0)
    g32 = clipped["w"].float()
    assert torch.equal(state["m"]["w"], (1 - 0.9) * g32)
    assert not torch.equal(new["w"], params["w"])
