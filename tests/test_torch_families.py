"""The port's xLSTM, encoder-decoder and VLM families against the JAX
package, on the CPU.

Weights made by JAX (``lm.init_params`` or the block inits) are carried
across bit for bit; the same numpy inputs then go through both packages.
Tolerances, relative to the largest magnitude of the JAX result, in fp32:

* 1e-5 for one function (``mlstm_chunkwise`` over several chunks from a
  nonzero state, ``mlstm_step``, ``_slstm_cell``, ``encode``,
  ``_cross_attention``, ``_merge_frontend``): the same arithmetic, sums in
  another order;
* 1e-4 for whole-model prefill and decode logits, as
  ``tests/test_torch_models.py`` holds the other families;
* the port's own prefill -> decode within 2e-2, ``tests/test_models.py``'s
  bound.

The reduced configs keep each family's structure: xlstm-125m's 5 mLSTM + 1
sLSTM pattern, seamless-m4t-medium's 2 encoder + 2 decoder layers with
cross-attention, llava-next-34b's 8 patch slots.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import blocks as jax_blocks
from repro.models import lm as jax_lm
from repro_torch.configs import get_config
from repro_torch.launch.steps import build_decode_step, build_prefill_step
from repro_torch.models import blocks, lm
from repro_torch.models.config import ShapeSpec
from repro_torch.optim.optimizers import tree_map

torch.set_num_threads(1)  # several xdist workers share the cores

FN_REL = 1e-5
REL = 1e-4
FAMILIES = ("xlstm-125m", "seamless-m4t-medium", "llava-next-34b")
SRC_LEN = 12  # encoder frames of the reduced enc-dec runs


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(np.asarray(got, np.float32) - want))
                 / np.max(np.abs(want)))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    """JAX's reduced config and weights, per-unit layout, made once per
    arch: the JAX side runs eagerly, and its first run of each shape is
    most of a test's time."""
    jcfg = jax_get_config(arch).reduced()
    return jcfg, jax_lm.init_params(jax.random.key(0), jcfg)


def _carried(arch, scan_layers=False):
    """(JAX config, JAX weights, the port's config and weights): the JAX
    tree carried into the unit layout ``scan_layers`` asks for."""
    jcfg, jparams = _jax_model(arch)
    cfg = get_config(arch).reduced().with_overrides(scan_layers=scan_layers)
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, cfg, lm.params_from_numpy(np_params, cfg,
                                                    device="cpu")


def _frontend(cfg, B, rng):
    """Stub frames (enc-dec) or patch embeddings (VLM), or None."""
    if not cfg.frontend:
        return None
    T = SRC_LEN if cfg.num_encoder_layers else cfg.frontend_len
    return rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# mLSTM and sLSTM functions
# ---------------------------------------------------------------------------

def _mlstm_inputs(rng, B, S, NH, DH, nonzero_state):
    q, k, v = (rng.standard_normal((B, S, NH, DH)).astype(np.float32)
               for _ in range(3))
    li = rng.standard_normal((B, S, NH)).astype(np.float32)
    lf = np.asarray(jax.nn.log_sigmoid(
        2.0 + rng.standard_normal((B, S, NH)).astype(np.float32)))
    if nonzero_state:
        state = {"C": rng.standard_normal((B, NH, DH, DH)).astype(np.float32),
                 "n": rng.standard_normal((B, NH, DH)).astype(np.float32),
                 "m": rng.standard_normal((B, NH)).astype(np.float32)}
    else:
        state = {"C": np.zeros((B, NH, DH, DH), np.float32),
                 "n": np.zeros((B, NH, DH), np.float32),
                 "m": np.full((B, NH), -1e30, np.float32)}
    return (q, k, v, li, lf), state


@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("nonzero_state", [False, True])
def test_mlstm_chunkwise_matches_jax(chunk, nonzero_state):
    """S 16 in chunks of 4, 8 or the whole sequence, from the initial state
    or a nonzero one: the output and the carried state."""
    rng = np.random.default_rng(chunk + 10 * nonzero_state)
    ins, state = _mlstm_inputs(rng, 2, 16, 3, 8, nonzero_state)
    jh, jst = jax_blocks.mlstm_chunkwise(
        *(jnp.asarray(a) for a in ins),
        {n: jnp.asarray(a) for n, a in state.items()}, chunk=chunk)
    h, st = blocks.mlstm_chunkwise(*(_t(a) for a in ins),
                                   {n: _t(a) for n, a in state.items()},
                                   chunk=chunk)
    assert h.shape == (2, 16, 3, 8)
    assert _rel(h.numpy(), jh) < FN_REL
    for name in ("C", "n", "m"):
        assert _rel(st[name].numpy(), jst[name]) < FN_REL, name


def test_mlstm_chunkwise_refuses_a_ragged_sequence():
    rng = np.random.default_rng(0)
    ins, state = _mlstm_inputs(rng, 1, 12, 2, 4, False)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        blocks.mlstm_chunkwise(*(_t(a) for a in ins),
                               {n: _t(a) for n, a in state.items()}, chunk=8)


@pytest.mark.parametrize("nonzero_state", [False, True])
def test_mlstm_step_matches_jax(nonzero_state):
    rng = np.random.default_rng(3 + nonzero_state)
    ins, state = _mlstm_inputs(rng, 2, 1, 3, 8, nonzero_state)
    jh, jst = jax_blocks.mlstm_step(
        *(jnp.asarray(a) for a in ins),
        {n: jnp.asarray(a) for n, a in state.items()})
    h, st = blocks.mlstm_step(*(_t(a) for a in ins),
                              {n: _t(a) for n, a in state.items()})
    assert h.shape == (2, 1, 24)
    assert _rel(h.numpy(), jh) < FN_REL
    for name in ("C", "n", "m"):
        assert _rel(st[name].numpy(), jst[name]) < FN_REL, name


def test_mlstm_step_takes_bf16_inputs_with_an_fp32_state():
    """Decode hands the step bf16 q/k/v and an fp32 state.  The JAX serving
    step runs jitted, where XLA keeps the bf16 k v^T product in fp32
    (excess precision): the port widens q/k/v first, so it equals JAX's
    jitted step within 1e-5 (and is bit for bit the step on the widened
    values)."""
    rng = np.random.default_rng(5)
    ins, state = _mlstm_inputs(rng, 2, 1, 3, 8, True)
    st32 = {n: _t(a) for n, a in state.items()}
    q, k, v = (_t(a).bfloat16() for a in ins[:3])
    li, lf = _t(ins[3]), _t(ins[4])
    h, st = blocks.mlstm_step(q, k, v, li, lf, st32)
    jh, jst = jax.jit(jax_blocks.mlstm_step)(
        *(jnp.asarray(a, jnp.bfloat16) for a in ins[:3]),
        jnp.asarray(ins[3]), jnp.asarray(ins[4]),
        {n: jnp.asarray(a) for n, a in state.items()})
    assert h.dtype == st["C"].dtype == torch.float32
    assert _rel(h.numpy(), jh) < FN_REL
    assert _rel(st["C"].numpy(), jst["C"]) < FN_REL
    want, _ = blocks.mlstm_step(q.float(), k.float(), v.float(), li, lf,
                                st32)
    assert torch.equal(h, want)


@pytest.mark.parametrize("nonzero_state", [False, True])
def test_slstm_cell_matches_jax(nonzero_state):
    jcfg, jmodel = _jax_model("xlstm-125m")
    jparams = jmodel["stack"]["units"][0]["b5"]  # the sLSTM block
    params = {n: _t(a) for n, a in jparams.items() if n != "mlp"}
    B, D, NH = 3, jcfg.d_model, jcfg.num_heads
    rng = np.random.default_rng(7 + nonzero_state)
    xt = {g: rng.standard_normal((B, D)).astype(np.float32) for g in "zifo"}
    state = {"h": np.zeros((B, D), np.float32),
             "c": np.zeros((B, D), np.float32),
             "n": np.ones((B, D), np.float32),
             "m": np.zeros((B, D), np.float32)}
    if nonzero_state:
        state = {n: rng.standard_normal((B, D)).astype(np.float32)
                 for n in state}
        state["n"] = np.abs(state["n"]) + 0.5
    want = jax_blocks._slstm_cell(
        jparams, {g: jnp.asarray(a) for g, a in xt.items()},
        {n: jnp.asarray(a) for n, a in state.items()}, NH)
    got = blocks._slstm_cell(params, {g: _t(a) for g, a in xt.items()},
                             {n: _t(a) for n, a in state.items()}, NH)
    for name in ("h", "c", "n", "m"):
        assert _rel(got[name].numpy(), want[name]) < FN_REL, name


# ---------------------------------------------------------------------------
# encoder-decoder and VLM functions
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_run(arch):
    """The JAX side of the whole-model tests, once per arch: (tokens, stub
    frontend, encoder output, prefill logits of the first 15 tokens, the
    decode step's logits for the 16th)."""
    jcfg, jparams = _jax_model(arch)
    B, S = 2, 16
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S))
    fe = _frontend(jcfg, B, rng)
    pre, dec, enc = {}, {}, None
    if jcfg.num_encoder_layers:
        enc = jax_lm.encode(jparams, jcfg, jnp.asarray(fe))
        pre["encoder_out"] = dec["encoder_out"] = enc
    elif fe is not None:
        pre["frontend"] = jnp.asarray(fe)
    logits, cache = jax_lm.prefill(jparams, jcfg, jnp.asarray(tokens[:, :-1]),
                                   capacity=S + 4, **pre)
    step, _ = jax_lm.decode_step(jparams, jcfg, jnp.asarray(tokens[:, -1:]),
                                 cache, jnp.int32(S), capacity=S + 4, **dec)
    return tokens, fe, enc, logits, step


@pytest.mark.parametrize("scan_layers", [False, True])
def test_encode_matches_jax(scan_layers):
    _, _, cfg, params = _carried("seamless-m4t-medium", scan_layers)
    _, fe, want, _, _ = _jax_run("seamless-m4t-medium")
    got = lm.encode(params, cfg, torch.from_numpy(fe))
    assert got.shape == (2, SRC_LEN, cfg.d_model)
    assert _rel(got.numpy(), want) < FN_REL


@pytest.mark.parametrize("Sq", [1, 5])
def test_cross_attention_matches_jax(Sq):
    """One decode row and a prefix of 5 against 12 encoder frames (Sq !=
    Skv, no rotary, no mask)."""
    jcfg, jparams, cfg, params = _carried("seamless-m4t-medium")
    jx = jparams["stack"]["units"][0]["b0"]["xattn"]
    x = params["stack"]["units"][0]["b0"]["xattn"]
    rng = np.random.default_rng(Sq)
    h = rng.standard_normal((2, Sq, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, SRC_LEN, cfg.d_model)).astype(np.float32)
    want = jax_blocks._cross_attention(jx, jnp.asarray(h), jnp.asarray(enc),
                                       jcfg)
    got = blocks._cross_attention(x, _t(h), _t(enc), cfg)
    assert got.shape == (2, Sq, cfg.d_model)
    assert _rel(got.numpy(), want) < FN_REL


@pytest.mark.parametrize("S", [8, 13])
def test_merge_frontend_matches_jax(S):
    """The 8 patch embeddings are the whole sequence (S == P) or replace
    its first 8 token slots (S > P)."""
    jcfg, jparams, cfg, params = _carried("llava-next-34b")
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    fe = _frontend(cfg, 2, rng)
    want = jax_lm._merge_frontend(jparams, jcfg, jnp.asarray(x),
                                  jnp.asarray(fe))
    got = lm._merge_frontend(params, cfg, _t(x), _t(fe))
    assert got.shape == (2, S, cfg.d_model)
    assert _rel(got.numpy(), want) < FN_REL
    np.testing.assert_array_equal(got[:, 8:].numpy(), x[:, 8:])


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("scan_layers", [False, True])
def test_prefill_and_decode_match_jax(arch, scan_layers):
    """Prefill 15 tokens, then one decode step, in either unit layout of the
    port, against JAX's per-unit run (both JAX layouts compute the same
    function).  The stacked layout also checks that the mLSTM / sLSTM
    states reach the stack's cache (its entries are views)."""
    _, _, cfg, params = _carried(arch, scan_layers)
    tokens, fe, _, jlog, jstep = _jax_run(arch)
    B, S = tokens.shape
    pre, dec = {}, {}
    if cfg.num_encoder_layers:
        dec["encoder_out"] = pre["encoder_out"] = lm.encode(params, cfg,
                                                            _t(fe))
    elif fe is not None:
        pre["frontend"] = _t(fe)
    t = torch.from_numpy(tokens)
    logits, cache = lm.prefill(params, cfg, t[:, :-1], capacity=S + 4, **pre)
    step, cache2 = lm.decode_step(params, cfg, t[:, -1:], cache,
                                  torch.tensor(S, dtype=torch.int32),
                                  capacity=S + 4, **dec)
    assert cache2 is cache  # updated in place
    assert logits.shape == step.shape == (B, cfg.vocab_size)
    assert _rel(logits.numpy(), jlog) < REL
    assert _rel(step.numpy(), jstep) < REL


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_consistency(arch):
    """Three decode steps after a prefill of 13 tokens == the full forward's
    last-token logits over the same 14, 15 and 16 tokens (the VLM's first 8
    slots hold patches in both; the enc-dec reads one encoder output)."""
    cfg = get_config(arch).reduced().with_overrides(scan_layers=True)
    gen = torch.Generator()
    gen.manual_seed(1)
    params = lm.init_params(gen, cfg)
    B, S, P = 2, 16, 13
    rng = np.random.default_rng(2)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)))
    fe = _frontend(cfg, B, rng)
    pre, dec = {}, {}
    if cfg.num_encoder_layers:
        dec["encoder_out"] = pre["encoder_out"] = lm.encode(params, cfg,
                                                            _t(fe))
    elif fe is not None:
        pre["frontend"] = _t(fe)
    _, cache = lm.prefill(params, cfg, tokens[:, :P], capacity=S, **pre)
    for n in range(P, S):
        step, _ = lm.decode_step(params, cfg, tokens[:, n:n + 1], cache,
                                 n + 1, capacity=S, **dec)
        hidden, _, _ = lm.forward(params, cfg, tokens[:, :n + 1], **pre)
        full = lm.logits_of(params, cfg, hidden)
        assert _rel(step.numpy(), full.numpy()) < 2e-2, n


def _jax_tree(arch, scan_layers, dtype):
    """JAX's tree for the reduced config in ``dtype`` and either layout,
    numpy: the JAX-made fp32 weights stacked as the JAX init stacks them
    (``lm.init_stack``) and cast leaf by leaf to the dtypes JAX's init
    gives that config (fp32 gates stay fp32 in a bf16 model)."""
    _, jparams = _jax_model(arch)
    jcfg = jax_get_config(arch).reduced().with_overrides(
        scan_layers=scan_layers, dtype=dtype)
    tree = jax.tree.map(np.asarray, jparams)
    if scan_layers:
        stacks = [tree["stack"]]
        if "encoder" in tree:
            stacks.append(tree["encoder"]["stack"])
        for stack in stacks:
            stack["units"] = jax.tree.map(lambda *xs: np.stack(xs),
                                          *stack["units"])
    like = jax.eval_shape(lambda: jax_lm.init_params(jax.random.key(0), jcfg))
    return jax.tree.map(lambda a, s: a.astype(s.dtype), tree, like)


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("scan_layers", [False, True])
def test_new_trees_round_trip_bit_for_bit(arch, scan_layers):
    """The mLSTM / sLSTM, encoder, cross-attention and frontend trees carry
    across in either unit layout; fp32 leaves (mLSTM and sLSTM gate
    weights and biases) stay fp32 in a bf16 model, every leaf bit for
    bit."""
    cfg = get_config(arch).reduced().with_overrides(scan_layers=scan_layers,
                                                    dtype="bfloat16")
    np_params = _jax_tree(arch, scan_layers, "bfloat16")
    params = lm.params_from_numpy(np_params, cfg, device="cpu")
    units = params["stack"]["units"]
    unit = units if scan_layers else units[0]
    if arch == "xlstm-125m":
        assert unit["b0"]["w_f"].dtype == unit["b5"]["b_f"].dtype == \
            torch.float32
        assert unit["b0"]["wq"].dtype == unit["b5"]["r_z"].dtype == \
            torch.bfloat16
    elif arch == "seamless-m4t-medium":
        enc_units = params["encoder"]["stack"]["units"]
        assert isinstance(enc_units, dict) == scan_layers
        assert {"ln_x", "xattn"} <= set(unit["b0"])
    else:
        assert params["frontend_proj"].shape == (cfg.d_model, cfg.d_model)
    back = lm.params_to_numpy(params)
    assert jax.tree.structure(np_params) == jax.tree.structure(back)
    for w, g in zip(jax.tree.leaves(np_params), jax.tree.leaves(back)):
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


def test_encdec_steps_encode_once_and_take_encoder_out(monkeypatch):
    """The enc-dec prefill step takes the source frames, encodes them once
    and returns the encoder output beside the logits and cache; the decode
    step takes it back.  Both equal the direct ``lm`` calls."""
    cfg = get_config("seamless-m4t-medium").reduced()
    gen = torch.Generator()
    gen.manual_seed(4)
    params = lm.init_params(gen, cfg)
    rng = np.random.default_rng(4)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 6)))
    fe = _t(_frontend(cfg, 2, rng))
    shape = ShapeSpec("served", 10, 2, "prefill")
    calls = []
    encode = lm.encode
    monkeypatch.setattr(lm, "encode",
                        lambda *a: calls.append(1) or encode(*a))
    logits, cache, enc = build_prefill_step(cfg, shape)(params, tokens, fe)
    assert len(calls) == 1 and enc.shape == (2, SRC_LEN, cfg.d_model)
    assert cache["units"][0]["b0"]["k"].shape[1] == 10
    want, _ = lm.prefill(params, cfg, tokens, capacity=10, encoder_out=enc)
    assert torch.equal(logits, want)
    token = logits.argmax(-1, keepdim=True)
    step, _ = build_decode_step(cfg, shape)(params, token, cache, 7, enc)
    assert len(calls) == 1 and step.shape == (2, cfg.vocab_size)


def test_vlm_prefill_step_takes_patch_embeddings():
    cfg = get_config("llava-next-34b").reduced()
    gen = torch.Generator()
    gen.manual_seed(5)
    params = lm.init_params(gen, cfg)
    rng = np.random.default_rng(5)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 11)))
    fe = _t(_frontend(cfg, 2, rng))
    shape = ShapeSpec("served", 14, 2, "prefill")
    logits, cache = build_prefill_step(cfg, shape)(params, tokens, fe)
    want, _ = lm.prefill(params, cfg, tokens, frontend=fe, capacity=14)
    assert torch.equal(logits, want)
    plain, _ = lm.prefill(params, cfg, tokens, capacity=14)
    assert not torch.equal(logits, plain)  # the patches took slots 0..7
    step, _ = build_decode_step(cfg, shape)(
        params, logits.argmax(-1, keepdim=True), cache, 12)
    assert step.shape == (2, cfg.vocab_size)


def test_stacked_recurrent_cache_starts_from_the_initial_state():
    """The stacked cache repeats each block's initial state over the units
    (mLSTM m = -1e30, sLSTM n = 1), as the JAX package broadcasts it."""
    cfg = get_config("xlstm-125m").reduced().with_overrides(scan_layers=True,
                                                            num_layers=12)
    cache = lm.init_stack_cache(cfg, 2, 8, "cpu")["units"]
    assert cache["b0"]["m"].shape == (2, 2, cfg.num_heads)
    assert bool((cache["b0"]["m"] == -1e30).all())
    assert bool((cache["b5"]["n"] == 1.0).all())
    assert not cache["b0"]["C"].any()
    per_unit = tree_map(lambda t: t[1], cache)
    assert per_unit["b5"]["n"].data_ptr() == cache["b5"]["n"][1].data_ptr()
