"""The port's training backwards of the MoE and RG-LRU paths against the
JAX package, on the CPU, where the ops take their plain versions.

The same seeded numpy inputs go through both packages:

* ``moe_gmm_bwd_ref`` (dx = dy . w^T, dw = x^T . dy) against ``jax.vjp`` of
  JAX's ``moe_gmm_ref``: fp32, max |port - JAX| <= 1e-5 of each gradient's
  max (fp32 sums of the same products in another order), and through the
  ``MoeGmm`` autograd Function;
* ``rglru_scan_bwd_ref`` (a reverse loop) with a non-zero h0 against
  ``jax.vjp`` of JAX's ``rglru_scan`` (an associative scan over log a):
  da, dx and dh0 within 1e-5 of each gradient's max |g| (the same
  recurrence in another order, and exp(log a) against a); and through the
  ``RglruScan`` autograd Function;
* ``moe_permute`` / ``moe_unpermute`` gradients against JAX's custom VJPs
  (gathers over the inverse maps, with capacity drops and top-2): exactly
  equal, since both sum the same fp32 values in the same order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gmm.ref import moe_gmm_ref as jax_moe_gmm_ref
from repro.models import blocks as JB
from repro_torch.kernels.moe_gmm.ops import moe_gmm
from repro_torch.kernels.moe_gmm.ref import moe_gmm_bwd_ref, moe_gmm_ref
from repro_torch.kernels.rglru_scan.ops import rglru_scan_op
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_ref,
                                                rglru_scan_ref)
from repro_torch.models import blocks as B

torch.set_num_threads(1)  # several xdist workers share the cores

REL = 1e-5


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want), initial=0.0)
                 / max(np.max(np.abs(want), initial=0.0), 1e-30))


# -- moe_gmm ------------------------------------------------------------------

def _gmm_inputs(E, C, D, F, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((E, C, D)) / np.sqrt(D)).astype(np.float32)
    w = rng.standard_normal((E, D, F)).astype(np.float32)
    dy = rng.standard_normal((E, C, F)).astype(np.float32)
    return x, w, dy


@pytest.mark.parametrize("E,C,D,F", [
    (4, 64, 256, 512),  # whole tiles
    (8, 24, 100, 96),   # ragged D and F
    (3, 77, 72, 136),   # ragged C, D and F multiples of 8 (the tc route)
    (16, 8, 64, 48),    # decode-sized C
    (2, 0, 32, 16),     # no rows: dw is 0
])
def test_moe_gmm_bwd_ref_matches_jax_vjp(E, C, D, F):
    x, w, dy = _gmm_inputs(E, C, D, F, E * C + D + F)
    _, vjp = jax.vjp(jax_moe_gmm_ref, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    dx, dw = moe_gmm_bwd_ref(*(torch.from_numpy(a) for a in (x, w, dy)))
    assert dx.dtype == torch.float32 and dx.shape == (E, C, D)
    assert dw.dtype == torch.float32 and dw.shape == (E, D, F)
    assert _rel(dx, jdx) <= REL and _rel(dw, jdw) <= REL
    if C == 0:
        assert not dw.any()


def test_moe_gmm_bwd_ref_casts_to_the_inputs_dtype():
    x, w, dy = (torch.from_numpy(a).bfloat16()
                for a in _gmm_inputs(2, 16, 32, 24, 3))
    dx, dw = moe_gmm_bwd_ref(x, w, dy)
    assert dx.dtype == dw.dtype == torch.bfloat16
    want_dx = torch.einsum("ecf,edf->ecd", dy.float(), w.float())
    assert torch.equal(dx, want_dx.bfloat16())


def test_moe_gmm_function_differentiates_through_its_backward():
    """Under grad mode ``moe_gmm`` goes through ``MoeGmm``: its gradients are
    ``moe_gmm_bwd_ref``'s bit for bit and equal autograd through the plain
    einsum to fp32 rounding; without grad mode it is the plain forward."""
    x, w, dy = (torch.from_numpy(a) for a in _gmm_inputs(3, 20, 40, 24, 5))
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = moe_gmm(xg, wg)
    assert out.grad_fn is not None and "MoeGmm" in type(out.grad_fn).__name__
    gx, gw = torch.autograd.grad(out, (xg, wg), dy)
    dx, dw = moe_gmm_bwd_ref(x, w, dy)
    assert torch.equal(gx, dx) and torch.equal(gw, dw)
    xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    ax, aw = torch.autograd.grad(moe_gmm_ref(xa, wa), (xa, wa), dy)
    assert _rel(gx, ax) <= REL and _rel(gw, aw) <= REL
    with torch.no_grad():
        assert moe_gmm(xg, wg).grad_fn is None
    assert torch.equal(moe_gmm(x, w), moe_gmm_ref(x, w))


# -- rglru_scan ---------------------------------------------------------------

def _scan_inputs(Bn, S, R, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.7, 0.999, (Bn, S, R)).astype(np.float32)
    x = rng.standard_normal((Bn, S, R)).astype(np.float32)
    h0 = rng.standard_normal((Bn, R)).astype(np.float32)
    dh = rng.standard_normal((Bn, S, R)).astype(np.float32)
    return a, x, h0, dh


@pytest.mark.parametrize("Bn,S,R", [(2, 64, 32), (1, 129, 17), (3, 17, 64),
                                    (2, 1, 8)])
def test_rglru_scan_bwd_ref_matches_jax_vjp(Bn, S, R):
    a, x, h0, dh = _scan_inputs(Bn, S, R, S + R)

    @jax.jit  # eager, each scan level compiles on its own (~13 s a shape)
    def jax_side(a, x, h0, dh):
        h, vjp = jax.vjp(lambda *v: JB.rglru_scan(None, jnp.log(v[0]), *v[1:]),
                         a, x, h0)
        return h, vjp(dh)

    h_jax, (jda, jdx, jdh0) = jax_side(*(jnp.asarray(v)
                                         for v in (a, x, h0, dh)))
    ta, tx, th0 = (torch.from_numpy(v) for v in (a, x, h0))
    h = rglru_scan_ref(ta, tx, th0)
    assert _rel(h, h_jax) <= REL
    da, dx, dh0 = rglru_scan_bwd_ref(ta, th0, h, torch.from_numpy(dh))
    assert da.shape == dx.shape == (Bn, S, R) and dh0.shape == (Bn, R)
    assert _rel(da, jda) <= REL and _rel(dx, jdx) <= REL
    assert _rel(dh0, jdh0) <= REL


def test_rglru_scan_function_differentiates_through_its_backward():
    """Under grad mode ``rglru_scan_op`` goes through ``RglruScan``, whose
    gradients are ``rglru_scan_bwd_ref``'s bit for bit (dx and da in a's
    dtype, dh0 in h0's) and match autograd through the plain loop."""
    a, x, h0, dh = (torch.from_numpy(v) for v in _scan_inputs(2, 40, 24, 9))
    leaves = [t.clone().requires_grad_(True) for t in (a, x, h0)]
    h = rglru_scan_op(*leaves)
    assert "RglruScan" in type(h.grad_fn).__name__
    got = torch.autograd.grad(h, leaves, dh)
    want = rglru_scan_bwd_ref(a, h0, rglru_scan_ref(a, x, h0), dh)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    plain = [t.clone().requires_grad_(True) for t in (a, x, h0)]
    auto = torch.autograd.grad(rglru_scan_ref(*plain), plain, dh)
    assert all(_rel(g, w) <= REL for g, w in zip(got, auto))
    with torch.no_grad():
        assert rglru_scan_op(*leaves).grad_fn is None


# -- moe_permute / moe_unpermute ---------------------------------------------

@pytest.mark.parametrize("G,T,E,k,cap", [
    (2, 24, 4, 2, 8),    # capacity drops (12 slots a token pair can need)
    (1, 16, 8, 1, 8),    # top-1, dropless
    (3, 10, 4, 2, 8),    # ragged
])
def test_moe_permute_grads_equal_jax_custom_vjps(G, T, E, k, cap):
    rng = np.random.default_rng(G * T + E)
    D = 12
    logits = rng.standard_normal((G, T, E)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    jidx, _, jslots = jax.vmap(lambda p: JB.moe_dispatch_indices(
        p, top_k=k, capacity=cap))(jnp.asarray(probs))
    idx, _, slots = B.moe_dispatch_indices(torch.from_numpy(probs), top_k=k,
                                           capacity=cap)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(slots.numpy(), np.asarray(jslots))
    jidx = jidx.reshape(G, E * cap)
    idx = idx.reshape(G, E * cap)
    x = rng.standard_normal((G, T, D)).astype(np.float32)
    g_disp = rng.standard_normal((G, E * cap, D)).astype(np.float32)
    g_tok = rng.standard_normal((G, T, D)).astype(np.float32)

    @jax.jit
    def jax_grads(x, hw, g_disp, g_tok):
        _, vjp = jax.vjp(lambda v: JB.moe_permute(v, jidx, jslots), x)
        _, vjp_un = jax.vjp(lambda v: JB.moe_unpermute(v, jidx, jslots), hw)
        return vjp(g_disp)[0], vjp_un(g_tok)[0]

    hw = rng.standard_normal((G, E * cap, D)).astype(np.float32)
    jdx, jdhw = jax_grads(*(jnp.asarray(v) for v in (x, hw, g_disp, g_tok)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (dx,) = torch.autograd.grad(B.moe_permute(xt, idx, slots), xt,
                                torch.from_numpy(g_disp))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(jdx))

    hwt = torch.from_numpy(hw).requires_grad_(True)
    (dhw,) = torch.autograd.grad(B.moe_unpermute(hwt, idx, slots), hwt,
                                 torch.from_numpy(g_tok))
    np.testing.assert_array_equal(dhw.numpy(), np.asarray(jdhw))
    # the forwards are the reference's too
    np.testing.assert_array_equal(
        B.moe_unpermute(torch.from_numpy(hw), idx, slots).numpy(),
        np.asarray(JB.moe_unpermute(jnp.asarray(hw), jidx, jslots)))
