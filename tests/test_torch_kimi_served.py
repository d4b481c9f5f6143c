"""Kimi-K2 at its own routing and head shape: the port's serving steps
against the JAX package's, on the CPU.

``tests/test_torch_models.py`` holds Kimi-K2 through ``reduced()``: 8
experts, top-2, head_dim 16.  Here it keeps its published routing (384
experts, top-8, one shared expert), head_dim 112 with a G-8 head group (H 8
/ Kv 1, as its 64 / 8), rope_theta and activation, and is cut to 2 layers,
d_model 256, moe_d_ff 32 and vocab 512 in fp32.  The weights, N(0, 0.05^2)
from a numpy seed in the tree of the JAX package's ``params_sds``, go to
the JAX steps as they are and to the port through ``params_from_numpy``; a
prefill of 2 prompts and 4 decode steps go through both packages'
``build_prefill_step`` / ``build_decode_step``, and every step's logits
must be within rel 1e-4 of the largest logit.  Two capacity factors: the
published 1.25 over 2 x 384 tokens, where the prefill's dispatch drops
assignments by capacity (both packages drop the same ones), and the
dropless E / k = 48 over 2 x 64 (at 384 tokens its capacity, 384 slots an
expert, would make the dispatch 6 times as large for no new case).

The JAX steps run under a (1, 1) host mesh whose axes are ``Auto``, as in
``tests/test_torch_dense_served.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import ShardingPolicy
from repro.launch import steps as jax_steps
from repro.models.config import ShapeSpec as JaxShapeSpec
from repro_torch.configs import get_config
from repro_torch.launch.steps import build_decode_step, build_prefill_step
from repro_torch.models import blocks, lm
from repro_torch.models.config import ShapeSpec

torch.set_num_threads(1)  # several xdist workers share the cores

ARCH = "kimi-k2-1t-a32b"
REL = 1e-4
B, STEPS = 2, 4
CUT = dict(num_layers=2, d_model=256, num_heads=8, num_kv_heads=1,
           moe_d_ff=32, vocab_size=512, dtype="float32")


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(np.asarray(got, np.float32) - want))
                 / np.max(np.abs(want)))


@pytest.mark.parametrize("capacity_factor,S", [(1.25, 384), (48.0, 64)])
def test_served_steps_match_jax_at_published_routing(capacity_factor, S,
                                                     monkeypatch):
    published = jax_get_config(ARCH)
    jcfg = published.with_overrides(**CUT, capacity_factor=capacity_factor)
    cfg = get_config(ARCH).with_overrides(**CUT,
                                          capacity_factor=capacity_factor)
    assert (cfg.num_experts, cfg.experts_per_token, cfg.num_shared_experts,
            cfg.head_dim, cfg.rope_theta, cfg.activation, cfg.scan_layers) \
        == (384, 8, 1, 112, published.rope_theta, published.activation,
            published.scan_layers)
    assert published.num_heads // published.num_kv_heads == \
        cfg.num_heads // cfg.num_kv_heads == 8
    dropless = capacity_factor == cfg.num_experts / cfg.experts_per_token
    assert dropless or capacity_factor == published.capacity_factor
    rng = np.random.default_rng(5)
    np_params = jax.tree.map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(s.dtype),
        jax_steps.params_sds(jcfg))
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = lm.params_from_numpy(np_params, cfg, device="cpu")
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                               (B, S + STEPS))
    cap = S + STEPS

    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    policy = ShardingPolicy(mesh)
    with mesh:
        jprefill = jax.jit(jax_steps.build_prefill_step(
            jcfg, policy, JaxShapeSpec("served", cap, B, "prefill")).fn)
        jdecode = jax.jit(jax_steps.build_decode_step(
            jcfg, policy, JaxShapeSpec("served", cap, B, "decode")).fn)
        jlogits, jcache = jprefill(jparams, jnp.asarray(tokens[:, :S]))
        want = [np.asarray(jlogits)]
        for t in range(STEPS):
            jlogits, jcache = jdecode(jparams,
                                      jnp.asarray(tokens[:, S + t:S + t + 1]),
                                      jcache, jnp.int32(S + t + 1))
            want.append(np.asarray(jlogits))

    # the port's prefill dispatch: assignments dropped by capacity (slot
    # E * C) counted layer by layer
    dropped = []
    plain = blocks.moe_dispatch_indices

    def counting(probs, *, top_k, capacity):
        out = plain(probs, top_k=top_k, capacity=capacity)
        dropped.append(int((out[2] == probs.shape[-1] * capacity).sum()))
        return out

    monkeypatch.setattr(blocks, "moe_dispatch_indices", counting)
    shape = ShapeSpec("served", cap, B, "prefill")
    t = torch.from_numpy(tokens)
    logits, cache = build_prefill_step(cfg, shape)(params, t[:, :S])
    prefill_dropped = sum(dropped)
    got = [logits]
    decode = build_decode_step(cfg, shape)
    for i in range(STEPS):
        logits, cache = decode(params, t[:, S + i:S + i + 1], cache,
                               torch.tensor(S + i + 1, dtype=torch.int32))
        got.append(logits)
    assert len(dropped) == cfg.num_layers * (1 + STEPS)
    assert (prefill_dropped == 0) if dropless else (prefill_dropped > 0)
    assert sum(dropped) == prefill_dropped  # 2 tokens a group at decode
    for step, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (B, cfg.vocab_size) and g.dtype == torch.float32
        assert _rel(g.numpy(), w) < REL, step


def test_one_unit_stacked_init_is_a_view_of_the_per_unit_draw():
    """A stack of one unit (Kimi-K2 served at 1 of its 61 layers) is the
    unit's own tensors viewed with a leading layer axis, not a copy (which
    would hold the layer twice while it is made), and holds the per-unit
    layout's values leaf for leaf."""
    cfg = get_config(ARCH).reduced().with_overrides(num_layers=1)
    trees = {}
    for stacked in (True, False):
        gen = torch.Generator()
        gen.manual_seed(13)
        trees[stacked] = lm.init_params(
            gen, cfg.with_overrides(scan_layers=stacked))
    got = jax.tree.leaves(trees[True]["stack"]["units"])
    want = jax.tree.leaves(trees[False]["stack"]["units"][0])
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.shape == (1, *w.shape) and g._base is not None
        assert g.dtype == w.dtype and torch.equal(g[0], w)
    for key in ("embed", "final_norm", "head"):
        assert torch.equal(trees[True][key], trees[False][key])
