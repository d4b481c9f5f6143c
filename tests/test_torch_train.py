"""The port's training path (``repro_torch``) against the JAX package, on the
CPU.

The same numpy inputs (and, for the model, JAX's ``lm.init_params`` weights
carried across by ``params_from_numpy``) go through both packages:

* the flash backward's plain version (the autograd Function on the CPU)
  against ``jax.grad`` of JAX's ``flash_attention_xla`` (its custom VJP),
  and the plain forward's lse against ``_flash_mha_fwd_impl``'s: rel 1e-5
  in fp32 (the same arithmetic, summed in another order);
* ``chunked_cross_entropy`` values and grads: rel 1e-5;
* ``lm.train_loss`` and every grad leaf of each of the ten archs,
  reduced (the MoE archs through ``moe_gmm``'s autograd Function and the
  gather backwards of the dispatch, the RG-LRU hybrid through
  ``rglru_scan``'s): loss rel 1e-5, each leaf within 1e-4 of its largest
  |g| (24 fp32 ops deep);
* one ``build_train_step`` step (1 and 2 microbatches) against JAX's
  ``value_and_grad`` + ``adamw.update``: metrics rel 1e-5, params and
  moments within 1e-4 of each leaf's max.

The JAX driver's ``train`` fails under jax 0.9.0, which refuses its
sharding constraint (ROADMAP.md §3), so the JAX side is composed from
``lm.train_loss`` and the optimizer; it runs once per module (cached,
jitted).  Then the port alone: the driver lowers the
loss, and restart from a checkpoint reproduces the uninterrupted run bit
for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro.models import lm as jax_lm
from repro.optim import adamw as jax_adamw
from repro.optim import constant_schedule as jax_constant
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_lse_ref
from repro_torch.launch.steps import build_train_step
from repro_torch.models import layers
from repro_torch.models import lm
from repro_torch.optim import adamw, constant_schedule
from repro_torch.optim.optimizers import tree_leaves, tree_map

torch.set_num_threads(1)  # several xdist workers share the cores

REL = 1e-5
GRAD_REL = 1e-4


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


# -- flash attention: the plain backward and lse against JAX's custom VJP -----

@pytest.mark.parametrize("B,Sq,Skv,H,Kv,hd,masks", [
    (2, 24, 24, 4, 2, 16, dict(causal=True, window=0, chunk_attn=0)),
    (2, 24, 24, 4, 2, 32, dict(causal=True, window=5, chunk_attn=0)),
    (2, 24, 24, 4, 2, 16, dict(causal=True, window=0, chunk_attn=8)),
    (2, 16, 24, 4, 2, 32, dict(causal=False, window=0, chunk_attn=0)),
    (2, 24, 16, 4, 2, 16, dict(causal=True, window=0, chunk_attn=0)),
    (1, 24, 24, 4, 4, 16, dict(causal=True, window=0, chunk_attn=0)),
    # RecurrentGemma-2B's attention: MQA (G 10), hd 256, a window
    (1, 24, 24, 10, 1, 256, dict(causal=True, window=8, chunk_attn=0)),
])
def test_flash_backward_matches_jax_custom_vjp(B, Sq, Skv, H, Kv, hd, masks):
    rng = np.random.default_rng(Sq + Skv + hd)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Kv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Kv, hd)).astype(np.float32)
    g = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)

    def jloss(q, k, v):
        out = jax_layers.flash_attention_xla(q, k, v, **masks)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = flash_attention(tq, tk, tv, **masks)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    assert _rel(out.detach(), jout) < REL
    for got, want in zip(grads, jgrads):
        assert _rel(got, want) < REL

    # lse: JAX's forward on (B, H, S, hd) with the KV heads repeated
    G = H // Kv
    qt = jnp.asarray(q).transpose(0, 2, 1, 3)
    kt = jnp.repeat(jnp.asarray(k), G, axis=2).transpose(0, 2, 1, 3)
    vt = jnp.repeat(jnp.asarray(v), G, axis=2).transpose(0, 2, 1, 3)
    _, jlse = jax.jit(jax_layers._flash_mha_fwd_impl,
                      static_argnums=(3, 4, 5, 6, 7))(
        qt, kt, vt, masks["causal"], masks["window"], masks["chunk_attn"], Sq,
        Skv)
    _, lse = flash_attention_lse_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                     **masks)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=REL,
                               atol=REL)


def test_flash_rows_that_see_nothing_have_zero_gradients():
    """chunk 8, Sq 24 > Skv 12: rows 16-23 see no key.  The port writes 0
    there (the JAX forward would average v) and the backward gives zeros,
    never NaN; lse is NEG_INF."""
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.standard_normal((1, 24, 2, 16)), dtype=torch.float32,
                     requires_grad=True)
    k = torch.tensor(rng.standard_normal((1, 12, 1, 16)), dtype=torch.float32,
                     requires_grad=True)
    v = torch.tensor(rng.standard_normal((1, 12, 1, 16)), dtype=torch.float32,
                     requires_grad=True)
    out = flash_attention(q, k, v, causal=True, chunk_attn=8)
    dq, dk, dv = torch.autograd.grad(out.square().sum(), (q, k, v))
    assert (out[:, 16:] == 0).all() and (dq[:, 16:] == 0).all()
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    _, lse = flash_attention_lse_ref(q.detach(), k.detach(), v.detach(),
                                     causal=True, chunk_attn=8)
    assert (lse[:, :, 16:] == -1e30).all()


# -- chunked cross-entropy ----------------------------------------------------

@pytest.mark.parametrize("masked,valid,cap", [
    (False, 0, 0.0), (True, 0, 0.0), (False, 37, 0.0), (True, 37, 30.0)])
def test_chunked_cross_entropy_matches_jax(masked, valid, cap):
    rng = np.random.default_rng(int(masked) + valid)
    B, S, D, V = 2, 16, 8, 48
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    head = (rng.standard_normal((D, V)) * 2).astype(np.float32)
    labels = rng.integers(0, valid or V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32) if masked else None
    kw = dict(chunk=8, logit_cap=cap, valid_vocab=valid)

    def jloss(x, head):
        nll, zl = jax_layers.chunked_cross_entropy(
            x, head, labels, None if mask is None else jnp.asarray(mask),
            **kw)
        return nll + zl, (nll, zl)

    (_, (jnll, jzl)), (jgx, jgh) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(x, head)
    tx, th = (torch.from_numpy(a).requires_grad_(True) for a in (x, head))
    nll, zl = layers.chunked_cross_entropy(
        tx, th, torch.from_numpy(labels).long(),
        None if mask is None else torch.from_numpy(mask), **kw)
    gx, gh = torch.autograd.grad(nll + zl, (tx, th))
    nll, zl = float(nll.detach()), float(zl.detach())
    assert abs(nll - float(jnll)) <= REL * abs(float(jnll))
    assert abs(zl - float(jzl)) <= REL * abs(float(jzl))
    assert _rel(gx, jgx) < REL and _rel(gh, jgh) < REL


# -- train_loss and the train step on reduced InternLM2 -----------------------

ARCH = "internlm2-1.8b"
B, S = 4, 16


@functools.cache
def _jax_side(arch: str = ARCH):
    """JAX weights, a batch, and JAX's loss, metrics and grads (computed
    once per module and arch; InternLM2's also per microbatch)."""
    jcfg = jax_get_config(arch).reduced()
    jparams = jax_lm.init_params(jax.random.key(0), jcfg)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if jcfg.frontend:  # stub audio frames or patch embeddings
        n = S if jcfg.frontend == "audio" else jcfg.frontend_len
        batch["frontend"] = rng.standard_normal(
            (B, n, jcfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    # jitted: a first eager run of each shape takes several times longer
    grad_fn = jax.jit(jax.value_and_grad(jax_lm.train_loss, has_aux=True),
                      static_argnums=1)
    (loss, metrics), grads = grad_fn(jparams, jcfg, jb)
    # the step's two microbatches, as JAX's acc_body takes them
    mb = [grad_fn(jparams, jcfg, {k: v[i * 2:(i + 1) * 2]
                                  for k, v in jb.items()})
          for i in range(2)] if arch == ARCH else None
    np_params = jax.tree.map(np.asarray, jparams)
    return dict(jcfg=jcfg, jparams=jparams, np_params=np_params, batch=batch,
                loss=float(loss), metrics=jax.tree.map(float, metrics),
                grads=jax.tree.map(np.asarray, grads), mb=mb)


def _port(arch: str = ARCH, **overrides):
    j = _jax_side(arch)
    cfg = get_config(arch).reduced().with_overrides(**overrides)
    params = lm.params_from_numpy(j["np_params"], cfg, device="cpu")
    batch = {k: torch.from_numpy(v).long() if k != "frontend"
             else torch.from_numpy(v) for k, v in j["batch"].items()}
    return cfg, params, batch


def _unstacked(tree, cfg):
    """A port tree (params or grads) in the per-unit layout of the JAX
    reduced config: every stacked ``units`` (the decoder's, an encoder's)
    as a list of units."""
    if not cfg.scan_layers:
        return tree
    if isinstance(tree, list):
        return [_unstacked(t, cfg) for t in tree]
    if not isinstance(tree, dict):
        return tree
    out = {k: _unstacked(v, cfg) for k, v in tree.items() if k != "units"}
    if "units" in tree:
        units = tree["units"]
        n = len(tree_leaves(units)[0])
        out["units"] = [tree_map(lambda t: t[i], units) for i in range(n)]
    return {k: out[k] for k in tree}


@pytest.mark.parametrize("overrides", [
    {}, {"scan_layers": True, "remat": True}])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_loss_and_grads_match_jax(arch, overrides):
    """Every arch, reduced, in both unit layouts: per-unit, and stacked
    with per-unit remat (``torch.utils.checkpoint``).  The MoE archs run
    ``moe_gmm``'s autograd Function and the gather backwards of
    ``moe_permute`` / ``moe_unpermute``, the RG-LRU hybrid ``rglru_scan``'s
    (their plain versions on the CPU)."""
    j = _jax_side(arch)
    cfg, params, batch = _port(arch, **overrides)
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, metrics = lm.train_loss(leaves, cfg, batch)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    assert abs(float(loss.detach()) - j["loss"]) <= REL * abs(j["loss"])
    for k in ("nll", "z_loss", "aux_loss"):
        assert abs(float(metrics[k].detach()) - j["metrics"][k]) <= \
            REL * max(abs(j["metrics"][k]), 1e-6)
    it = iter(grads)
    grads = _unstacked(tree_map(lambda _: next(it), leaves), cfg)
    for got, want in zip(tree_leaves(grads),
                         jax.tree.leaves(j["grads"])):
        assert got.shape == want.shape
        assert _rel(got.detach(), want) < GRAD_REL


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches):
    """One step of ``build_train_step`` against JAX's value_and_grad +
    ``adamw.update`` (constant lr 1e-2, step 3, so the update moves the
    params visibly), with JAX's fp32 accumulation for 2 microbatches."""
    j = _jax_side()
    cfg, params, batch = _port()
    jopt = jax_adamw(jax_constant(1e-2))
    if microbatches == 1:
        jm, jg = dict(j["metrics"], loss=j["loss"]), j["grads"]
    else:
        jg = jax.tree.map(lambda a, b: (a.astype(jnp.float32)
                                        + b.astype(jnp.float32)) / 2,
                          j["mb"][0][1], j["mb"][1][1])
        jm = jax.tree.map(lambda a, b: (a + b) / 2,
                          dict(j["mb"][0][0][1], loss=j["mb"][0][0][0]),
                          dict(j["mb"][1][0][1], loss=j["mb"][1][0][0]))
    jstate = jopt.init(j["jparams"])
    jnew, jstate = jax.jit(jopt.update)(jg, jstate, j["jparams"],
                                        jnp.int32(3))

    opt = adamw(constant_schedule(1e-2))
    step_fn = build_train_step(cfg, optimizer=opt, microbatches=microbatches)
    new, state, step, metrics = step_fn(params, opt.init(params), 3, batch)
    assert step == 4
    assert not any(t.requires_grad for t in tree_leaves(new))
    for k in ("loss", "nll", "z_loss", "aux_loss"):
        assert abs(float(metrics[k]) - float(jm[k])) <= \
            REL * max(abs(float(jm[k])), 1e-6)
    assert np.isfinite(float(metrics["grad_norm"]))
    # AdamW's update m / sqrt(v) keeps only the grad's sign and is fp32-equal
    # where |g| stands clear of the grads' 1e-4 difference; where g is near
    # 0 the update may differ by up to its own size, ~lr
    for got, want, g in zip(tree_leaves(new), jax.tree.leaves(jnew),
                            jax.tree.leaves(jg)):
        got, want, g = got.numpy(), np.asarray(want), np.abs(np.asarray(g))
        clear = g > 1e-3 * g.max()
        diff = np.abs(got - want)
        assert np.all(diff[clear] <= REL * np.abs(want).max() + 1e-7)
        assert np.all(diff <= 2e-2)
    for key in ("m", "v"):
        for got, want in zip(tree_leaves(state[key]),
                             jax.tree.leaves(jstate[key])):
            assert _rel(got, want) < GRAD_REL


# -- the port's driver alone --------------------------------------------------

def test_train_driver_lowers_the_loss(tmp_path):
    """``train`` for 12 steps on the CPU (the JAX driver's own test's
    arguments).  The default schedule warms up over 2000 steps, so 12 steps
    move each weight by ~1e-6 and the per-batch loss wanders by more than
    that; the weights after the run score lower than the initial ones on
    the batches of the first and the last step."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.steps import default_optimizer
    from repro_torch.launch.train import train

    losses = train(ARCH, steps=12, batch=4, seq=64, log_every=100,
                   ckpt_dir=str(tmp_path), ckpt_every=12, device="cpu")
    assert len(losses) == 12 and all(np.isfinite(losses))
    cfg = get_config(ARCH).reduced()
    gen = torch.Generator()
    gen.manual_seed(0)
    init = lm.init_params(gen, cfg)
    like = (init, default_optimizer(cfg).init(init))
    step, (trained, _) = Checkpointer(tmp_path).restore(like)
    assert step == 12
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=64,
                         global_batch=4)
    with torch.no_grad():
        for s in (0, 11):
            b = {k: torch.from_numpy(v).long()
                 for k, v in pipe.batch_at(s).items()}
            before = float(lm.train_loss(init, cfg, b)[0])
            after = float(lm.train_loss(trained, cfg, b)[0])
            assert after < before
    assert losses[0] == pytest.approx(
        float(lm.train_loss(init, cfg, {
            k: torch.from_numpy(v).long()
            for k, v in pipe.batch_at(0).items()})[0]), rel=1e-6)


def test_train_restart_is_bit_equal(tmp_path):
    """Kill and restore: 2 steps with a checkpoint, then a fresh ``train``
    call resumes from it and reproduces the uninterrupted run's losses bit
    for bit (the JAX test's bound is 1e-4)."""
    from repro_torch.launch.train import train

    kw = dict(batch=2, seq=32, ckpt_every=2, log_every=100, device="cpu",
              microbatches=2)
    full = train(ARCH, steps=4, ckpt_dir=str(tmp_path / "a"), **kw)
    train(ARCH, steps=2, ckpt_dir=str(tmp_path / "b"), **kw)
    resumed = train(ARCH, steps=4, ckpt_dir=str(tmp_path / "b"), **kw)
    assert resumed == full[2:]


def test_train_refuses_what_waits_for_later_items():
    """Nothing waits any more: tensor parallelism runs on a DeviceMesh
    (``tests/test_torch_distributed.py`` drives ``train(..., tp=2)`` on two
    ranks), so without a world of ranks to build the mesh over, ``tp=2``
    raises for the missing process group, not as work left for later; and
    every arch's train path has its backward kernels."""
    from repro_torch.launch import train as train_mod

    with pytest.raises(RuntimeError, match="no process group"):
        train_mod.train(ARCH, steps=1, tp=2, device="cpu")
    assert not hasattr(train_mod, "kernels_without_backward")


def test_kernels_without_backward_refuse_grad_on_the_card(monkeypatch):
    """The rule of ``kernels/common.py: refuse_grad`` for the three kernels
    no train path reaches: on the kernel path (``use_kernel`` stubbed True,
    as for CUDA tensors), an input that requires grad under grad mode
    raises; without grad mode, or without such an input, the rule lets the
    call pass."""
    import importlib

    dec, dsqe, topk = (
        importlib.import_module(f"repro_torch.kernels.{op}.ops")
        for op in ("decode_attention", "dsqe_score", "retrieval_topk"))

    for mod in (dec, dsqe, topk):
        monkeypatch.setattr(mod, "use_kernel", lambda *ts: True)
    x = torch.zeros((2, 4, 16), requires_grad=True)
    w = torch.zeros((2, 16, 8))
    calls = [
        lambda x: dec.decode_attention(x[:, :1, None], x[:, :, None],
                                       x[:, :, None], 3),
        lambda x: topk.retrieval_topk(x[0], x[1], k=2),
        lambda x: dsqe.dsqe_score(x[0], x[1], x[1], torch.zeros((4, 3)),
                                  torch.zeros((4, 3)), torch.zeros(3),
                                  torch.zeros(3), torch.zeros(3),
                                  torch.zeros(3), torch.zeros((4, 2)), knn=2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no train path reaches it"):
            call(x)
    from repro_torch.kernels.common import refuse_grad

    refuse_grad("op", x.detach(), w)  # nothing requires grad
    with torch.no_grad():
        refuse_grad("op", x, w)  # grad mode off
