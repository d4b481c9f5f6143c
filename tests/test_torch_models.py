"""The port's dense model substrate (``repro_torch.models``) against the JAX
package, on the CPU.

Weights made by JAX's ``lm.init_params`` are carried across with
``params_from_numpy``; the same numpy tokens then go through both
packages' ``prefill`` and ``decode_step``.  Tolerance: logits within rel
1e-4 of the largest logit in fp32 (the same arithmetic, matmuls summed in
another order).  The port's own prefill -> decode consistency is held to
the JAX test's bound (``tests/test_models.py``: rel < 2e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jax_lm
from repro_torch.configs import get_config
from repro_torch.launch.steps import build_decode_step, build_prefill_step
from repro_torch.models import lm
from repro_torch.models.config import ShapeSpec

torch.set_num_threads(1)  # several xdist workers share the cores

REL = 1e-4
DENSE = ("internlm2-1.8b", "llama3-8b", "granite-8b", "gemma-7b")
# MoE (top-1 + shared, top-2 + shared after reduced()) and hybrid (RG-LRU +
# local attention)
MOE_HYBRID = ("llama4-scout-17b-a16e", "kimi-k2-1t-a32b", "recurrentgemma-2b")


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(np.asarray(got, np.float32) - want))
                 / np.max(np.abs(want)))


def _carried(arch, **overrides):
    jcfg = jax_get_config(arch).reduced().with_overrides(**overrides)
    cfg = get_config(arch).reduced().with_overrides(**overrides)
    jparams = jax_lm.init_params(jax.random.key(0), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, cfg, lm.params_from_numpy(np_params, cfg,
                                                    device="cpu")


@pytest.mark.parametrize("arch,overrides", [
    *[(a, {}) for a in DENSE + MOE_HYBRID],
    ("internlm2-1.8b", {"scan_layers": True}),  # the stacked layout
    ("llama4-scout-17b-a16e", {"scan_layers": True}),
    ("recurrentgemma-2b", {"scan_layers": True}),
    ("internlm2-1.8b", {"attention_type": "local", "window_size": 8}),
    ("internlm2-1.8b", {"attention_type": "chunked", "window_size": 8}),
])
def test_prefill_and_decode_match_jax(arch, overrides):
    """Ring caches (local / chunked, window 8 < 15 prompt tokens) take the
    ring prefill and the ring decode on both sides."""
    jcfg, jparams, cfg, params = _carried(arch, **overrides)
    B, S = 2, 16
    cap = S + 4
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    jlog, jcache = jax_lm.prefill(jparams, jcfg, jnp.asarray(tokens[:, :-1]),
                                  capacity=cap)
    jstep, _ = jax_lm.decode_step(jparams, jcfg, jnp.asarray(tokens[:, -1:]),
                                  jcache, jnp.int32(S), capacity=cap)
    t = torch.from_numpy(tokens)
    logits, cache = lm.prefill(params, cfg, t[:, :-1], capacity=cap)
    step, cache2 = lm.decode_step(params, cfg, t[:, -1:], cache,
                                  torch.tensor(S, dtype=torch.int32),
                                  capacity=cap)
    assert cache2 is cache  # updated in place
    assert logits.dtype == torch.float32
    assert logits.shape == step.shape == (B, cfg.vocab_size)
    assert _rel(logits.numpy(), jlog) < REL
    assert _rel(step.numpy(), jstep) < REL


@pytest.mark.parametrize("arch", DENSE + MOE_HYBRID)
def test_prefill_decode_consistency(arch):
    """decode_step logits after prefill == full-forward logits."""
    cfg = get_config(arch).reduced()
    gen = torch.Generator()
    gen.manual_seed(1)
    params = lm.init_params(gen, cfg)
    B, S = 2, 16
    cap = S + 4
    tokens = torch.as_tensor(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)))
    hidden, cache, _ = lm.forward(params, cfg, tokens)
    assert cache is None
    full = lm.logits_of(params, cfg, hidden)
    _, cache = lm.prefill(params, cfg, tokens[:, :-1], capacity=cap)
    step, _ = lm.decode_step(params, cfg, tokens[:, -1:], cache, S,
                             capacity=cap)
    assert _rel(step.numpy(), full.numpy()) < 2e-2


def test_steps_bind_the_shape_capacity():
    cfg = get_config("internlm2-1.8b").reduced()
    gen = torch.Generator()
    gen.manual_seed(3)
    params = lm.init_params(gen, cfg)
    shape = ShapeSpec("served", 24, 2, "prefill")
    tokens = torch.as_tensor(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 10)))
    logits, cache = build_prefill_step(cfg, shape)(params, tokens)
    assert cache["units"][0]["b0"]["k"].shape[1] == 24
    want, _ = lm.prefill(params, cfg, tokens, capacity=24)
    assert torch.equal(logits, want)
    step, _ = build_decode_step(cfg, shape)(params, logits.argmax(-1)[:, None],
                                            cache, 11)
    assert step.shape == (2, cfg.vocab_size)


def test_ring_cache_matches_full_cache():
    """The port's twin of ``tests/test_models.py``'s ring-cache test: local
    attention with a ring cache (window 64 < 191 prompt tokens, so the ring
    wraps) decodes as the full forward does, and the ring stays bounded by
    the window."""
    cfg = get_config("recurrentgemma-2b").reduced()
    gen = torch.Generator()
    gen.manual_seed(3)
    params = lm.init_params(gen, cfg)
    B, S = 1, 192
    tokens = torch.as_tensor(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S)))
    hidden, _, _ = lm.forward(params, cfg, tokens, mode="train")
    full = lm.logits_of(params, cfg, hidden)
    _, cache = lm.prefill(params, cfg, tokens[:, :-1], capacity=S)
    logits, _ = lm.decode_step(params, cfg, tokens[:, -1:], cache, S,
                               capacity=S)
    assert _rel(logits.numpy(), full.numpy()) < 2e-2
    k_cache = cache["units"][0]["b2"]["k"]
    assert k_cache.shape[1] == cfg.window_size
    assert max(k_cache.shape) <= max(cfg.window_size, B, cfg.num_layers, S - 1)


@pytest.mark.parametrize("arch", ["granite-8b", *MOE_HYBRID])
def test_stacked_init_equals_per_unit_init(arch):
    """``init_stack`` writes each unit into its slot of the stacked layout
    as it is drawn: both layouts from one seed hold the same bits."""
    cfg = get_config(arch).reduced().with_overrides(num_layers=6)
    trees = {}
    for stacked in (True, False):
        gen = torch.Generator()
        gen.manual_seed(11)
        trees[stacked] = lm.init_params(
            gen, cfg.with_overrides(scan_layers=stacked))
    units = trees[True]["stack"]["units"]
    n_units = len(trees[False]["stack"]["units"])
    assert n_units >= 2
    for i in range(n_units):
        want = jax.tree.leaves(trees[False]["stack"]["units"][i])
        got = [t[i] for t in jax.tree.leaves(units)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    for key in ("embed", "final_norm"):
        assert torch.equal(trees[True][key], trees[False][key])
    assert torch.equal(trees[True].get("head", trees[True]["embed"]),
                       trees[False].get("head", trees[False]["embed"]))


@pytest.mark.parametrize("arch", DENSE + MOE_HYBRID + (
    "xlstm-125m", "seamless-m4t-medium", "llava-next-34b"))
def test_param_count_equals_jax(arch):
    assert get_config(arch).param_count() == \
        jax_get_config(arch).param_count()


@pytest.mark.parametrize("overrides", [{}, {"scan_layers": True},
                                       {"dtype": "bfloat16"}])
def test_params_round_trip_bit_for_bit(overrides):
    arch = "granite-8b"
    jcfg = jax_get_config(arch).reduced().with_overrides(**overrides)
    cfg = get_config(arch).reduced().with_overrides(**overrides)
    np_params = jax.tree.map(np.asarray,
                             jax_lm.init_params(jax.random.key(2), jcfg))
    back = lm.params_to_numpy(lm.params_from_numpy(np_params, cfg,
                                                   device="cpu"))
    want, got = jax.tree.leaves(np_params), jax.tree.leaves(back)
    assert jax.tree.structure(np_params) == jax.tree.structure(back)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


@pytest.mark.parametrize("arch", MOE_HYBRID)
@pytest.mark.parametrize("scan_layers", [False, True])
def test_moe_and_rglru_trees_round_trip_bit_for_bit(arch, scan_layers):
    """The router, experts, shared expert and RG-LRU trees carry across in
    either unit layout; fp32 leaves (router, RG-LRU gates, lam) stay fp32 in
    a bf16 model, every leaf bit for bit."""
    over = dict(scan_layers=scan_layers, dtype="bfloat16", num_layers=6)
    jcfg = jax_get_config(arch).reduced().with_overrides(**over)
    cfg = get_config(arch).reduced().with_overrides(**over)
    np_params = jax.tree.map(np.asarray,
                             jax_lm.init_params(jax.random.key(5), jcfg))
    params = lm.params_from_numpy(np_params, cfg, device="cpu")
    unit = params["stack"]["units"]
    unit = unit if scan_layers else unit[0]
    if cfg.num_experts:
        moe = unit["b0"]["moe"]
        assert moe["router"].dtype == torch.float32
        assert moe["w_gate"].dtype == torch.bfloat16 and "shared" in moe
    else:
        rg = unit["b0"]
        assert {"w_x", "w_gate_in", "w_out", "conv_w", "conv_b", "w_a", "b_a",
                "w_i", "b_i", "lam"} <= set(rg)
        assert rg["lam"].dtype == rg["w_a"].dtype == torch.float32
        assert rg["conv_w"].dtype == torch.bfloat16
    back = lm.params_to_numpy(params)
    assert jax.tree.structure(np_params) == jax.tree.structure(back)
    for w, g in zip(jax.tree.leaves(np_params), jax.tree.leaves(back)):
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


def test_params_carry_across_layouts():
    """A per-unit tree loads into a stacked config and back, unchanged."""
    arch = "internlm2-1.8b"
    jcfg = jax_get_config(arch).reduced()
    np_params = jax.tree.map(np.asarray,
                             jax_lm.init_params(jax.random.key(4), jcfg))
    cfg = get_config(arch).reduced()
    stacked = lm.params_from_numpy(np_params, cfg.with_overrides(
        scan_layers=True), device="cpu")
    assert stacked["stack"]["units"]["b0"]["attn"]["wq"].shape[0] == 2
    flat = lm.params_from_numpy(lm.params_to_numpy(stacked), cfg,
                                device="cpu")
    back = lm.params_to_numpy(flat)
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    for w, g in zip(jax.tree.leaves(np_params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch", ["xlstm-125m", "seamless-m4t-medium",
                                  "llava-next-34b"])
def test_new_family_init_matches_jax_tree(arch):
    """The xLSTM, encoder-decoder and VLM inits build JAX's tree: the same
    structure (encoder subtree, cross-attention, frontend projection, mLSTM
    and sLSTM leaves), shapes and dtypes, in both unit layouts."""
    for scan_layers in (False, True):
        cfg = get_config(arch).reduced().with_overrides(
            scan_layers=scan_layers, dtype="bfloat16")
        jcfg = jax_get_config(arch).reduced().with_overrides(
            scan_layers=scan_layers, dtype="bfloat16")
        gen = torch.Generator()
        gen.manual_seed(0)
        got = lm.params_to_numpy(lm.init_params(gen, cfg))
        want = jax.eval_shape(lambda: jax_lm.init_params(jax.random.key(0),
                                                         jcfg))
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert g.shape == w.shape and g.dtype == w.dtype
