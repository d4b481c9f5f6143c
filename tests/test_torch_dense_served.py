"""The catalog's dense 7-8B models at their own head shapes: the port's
serving steps against the JAX package's, on the CPU.

``tests/test_torch_models.py`` holds these archs through ``reduced()``,
which sets head_dim 16 and 4 heads.  Here each keeps its published
head_dim, its H : Kv ratio, rope_theta, activation, tied or untied head and
Gemma's embedding scale, and is cut to 2 layers, d_ff 256 and vocab 512 in
fp32: Gemma-7B takes H 2 / Kv 2 (G 1) at hd 256 with d_model 192, unlike
H * hd (its published 3072 against 4096); Granite-8B and Llama-3-8B take H 8
/ Kv 2 (G 4) at hd 128 with d_model H * hd.  The weights, N(0, 0.05^2)
from a numpy seed in the tree of the JAX package's ``params_sds`` (norm
gains are zero-centred, applied as 1 + w), go to the JAX steps as they are
and to the port through ``params_from_numpy``; a prefill and 4 decode
steps, on tokens from a numpy seed, go through both packages'
``build_prefill_step`` / ``build_decode_step``, and every step's logits
must be within rel 1e-4 of the largest logit
(``test_prefill_and_decode_match_jax``'s bound).

The JAX steps run under a (1, 1) host mesh whose axes are ``Auto``: the
installed jax refuses ``with_sharding_constraint`` on ``Explicit`` axes,
which ``make_host_mesh`` makes.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import ShardingPolicy
from repro.launch import steps as jax_steps
from repro.models import lm as jax_lm
from repro.models.config import ShapeSpec as JaxShapeSpec
from repro_torch.configs import get_config
from repro_torch.launch.steps import build_decode_step, build_prefill_step
from repro_torch.models import lm
from repro_torch.models.config import ShapeSpec

torch.set_num_threads(1)  # several xdist workers share the cores

REL = 1e-4
B, S, STEPS = 2, 16, 4
CUT = dict(num_layers=2, d_ff=256, vocab_size=512, dtype="float32")
HEADS = {
    "gemma-7b": dict(num_heads=2, num_kv_heads=2, head_dim=256, d_model=192),
    "granite-8b": dict(num_heads=8, num_kv_heads=2, head_dim=128,
                       d_model=1024),
    "llama3-8b": dict(num_heads=8, num_kv_heads=2, head_dim=128,
                      d_model=1024),
}


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(np.asarray(got, np.float32) - want))
                 / np.max(np.abs(want)))


@pytest.mark.parametrize("arch", sorted(HEADS))
def test_served_steps_match_jax_at_published_head_shapes(arch):
    published = jax_get_config(arch)
    jcfg = published.with_overrides(**CUT, **HEADS[arch])
    cfg = get_config(arch).with_overrides(**CUT, **HEADS[arch])
    assert (cfg.head_dim, cfg.rope_theta, cfg.activation,
            cfg.tie_embeddings, cfg.scan_layers) == (
        published.head_dim, published.rope_theta, published.activation,
        published.tie_embeddings, published.scan_layers)
    assert published.num_heads // published.num_kv_heads == \
        cfg.num_heads // cfg.num_kv_heads
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

    shape = ShapeSpec("served", cap, B, "prefill")
    t = torch.from_numpy(tokens)
    logits, cache = build_prefill_step(cfg, shape)(params, t[:, :S])
    got = [logits]
    decode = build_decode_step(cfg, shape)
    for i in range(STEPS):
        logits, cache = decode(params, t[:, S + i:S + i + 1], cache,
                               torch.tensor(S + i + 1, dtype=torch.int32))
        got.append(logits)
    for step, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (B, cfg.vocab_size) and g.dtype == torch.float32
        assert _rel(g.numpy(), w) < REL, step


@pytest.mark.parametrize("arch", ["gemma-7b", "recurrentgemma-2b"])
def test_bf16_embedding_scale_is_bit_equal(arch):
    """Gemma scales the embedding by sqrt(d_model) rounded to the
    activation dtype (``src/repro/models/lm.py: _embed_tokens``): in bf16 at
    the published d_model the constant and the scaled rows are bit-equal to
    the reference's."""
    jcfg = jax_get_config(arch).with_overrides(vocab_size=64)
    cfg = get_config(arch).with_overrides(vocab_size=64)
    assert cfg.activation_dtype == torch.bfloat16
    jconst = np.asarray(jnp.asarray(math.sqrt(jcfg.d_model), jnp.bfloat16))
    const = torch.tensor(math.sqrt(cfg.d_model), dtype=torch.bfloat16)
    assert const.view(torch.int16).item() == int(jconst.view(np.int16))
    table = np.random.default_rng(3).standard_normal(
        (cfg.vocab_padded, cfg.d_model)).astype(np.float32)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 5))
    jtable = jnp.asarray(table, jnp.bfloat16)
    want = np.asarray(jax_lm._embed_tokens({"embed": jtable}, jcfg,
                                           jnp.asarray(tokens)))
    got = lm._embed_tokens(
        {"embed": torch.from_numpy(table).to(torch.bfloat16)}, cfg,
        torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(),
                          want.view(np.int16))
