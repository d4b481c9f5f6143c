"""The port's RG-LRU block (``repro_torch.models.blocks`` RG-LRU section and
the ``rglru_scan`` op) against the JAX package, on the CPU, where
``rglru_scan_op`` takes its plain version.

Tolerances, max abs difference over the largest |reference|:
  * the scan op against ``rglru_scan_ref`` and the Pallas kernel (interpret
    mode): <= 1e-5.  All three run the same fp32 recurrence in order; the
    port rounds the product and the sum apart, XLA may fuse them into one
    multiply-add (observed: ~2e-7).
  * ``blocks.rglru_scan`` against the JAX associative scan: <= 1e-5.  The
    sequential loop and the scan's tree add in another order; with decays
    in [0.5, 0.999] over 200 steps the difference stays near 1e-7.
  * ``apply_rglru_block`` output and cache: <= 1e-5 (fp32 matmuls summed in
    another order on top of the scan).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.rglru_scan.ops import rglru_scan_op as jax_scan_kernel
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_scan_ref
from repro.models import blocks as JB
from repro_torch.configs import get_config
from repro_torch.kernels.rglru_scan.ops import rglru_scan_op
from repro_torch.models import blocks as B

torch.set_num_threads(1)  # several xdist workers share the cores

REL = 1e-5


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(np.asarray(got, np.float32) - want))
                 / np.max(np.abs(want)))


def _t(a) -> torch.Tensor:
    """A JAX or numpy array as a torch tensor (fp32 or bf16, bits kept)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("Bsz,S,R,chunk", [(2, 256, 128, 64),
                                           (1, 512, 100, 128),
                                           (3, 100, 256, 32)])
def test_rglru_scan_plain_matches_jax(Bsz, S, R, chunk, dtype):
    rng = np.random.default_rng(Bsz * S)
    a = jnp.asarray(rng.uniform(0.7, 0.999, (Bsz, S, R)), dtype)
    x = jnp.asarray(rng.standard_normal((Bsz, S, R)), dtype)
    h0 = jnp.asarray(rng.standard_normal((Bsz, R)), dtype)
    before = rglru_scan_op.launches
    got = rglru_scan_op(_t(a), _t(x), _t(h0))
    assert rglru_scan_op.launches == before  # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (Bsz, S, R)
    f32 = lambda v: v.astype(jnp.float32)
    ref = jax_scan_ref(f32(a), f32(x), f32(h0))
    pallas = jax_scan_kernel(a, x, h0, chunk=chunk, interpret=True)
    assert _rel(got.numpy(), ref) <= REL
    assert _rel(got.numpy(), pallas) <= REL


@pytest.mark.parametrize("S", [16, 200])
@pytest.mark.parametrize("with_h0", [False, True])
def test_block_rglru_scan_matches_jax_associative_scan(S, with_h0):
    rng = np.random.default_rng(S)
    a_log = np.log(rng.uniform(0.5, 0.999, (2, S, 64))).astype(np.float32)
    gated = rng.standard_normal((2, S, 64)).astype(np.float32)
    h0 = rng.standard_normal((2, 64)).astype(np.float32) if with_h0 else None
    want = JB.rglru_scan(None, jnp.asarray(a_log), jnp.asarray(gated),
                         None if h0 is None else jnp.asarray(h0))
    got = B.rglru_scan(None, _t(a_log), _t(gated),
                       None if h0 is None else _t(h0))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= REL


def _block(S):
    jcfg = jax_get_config("recurrentgemma-2b").reduced()
    cfg = get_config("recurrentgemma-2b").reduced()
    jp = JB.init_rglru_block(jax.random.key(S), jcfg)
    return jcfg, jp, cfg, jax.tree.map(_t, jp)


@pytest.mark.parametrize("S", [1, 3, 40])  # shorter than, and past, the conv
def test_apply_rglru_block_prefill_then_decode_matches_jax(S):
    jcfg, jp, cfg, tp = _block(S)
    rng = np.random.default_rng(S)
    Bsz, D = 2, cfg.d_model
    x = rng.standard_normal((Bsz, S, D)).astype(np.float32)
    x_next = rng.standard_normal((Bsz, 1, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (Bsz, S))

    jctx = JB.BlockCtx(mode="prefill", positions=jnp.asarray(pos), capacity=S)
    want, want_cache, _ = JB.apply_rglru_block(jp, jnp.asarray(x), jctx, jcfg)
    ctx = B.BlockCtx(mode="prefill", positions=_t(pos), capacity=S)
    before = rglru_scan_op.launches
    got, cache, aux = B.apply_rglru_block(tp, _t(x), ctx, cfg)
    assert rglru_scan_op.launches == before
    assert float(aux) == 0.0
    assert _rel(got.numpy(), want) <= REL
    for name in ("h", "conv"):
        assert cache[name].dtype == _t(want_cache[name]).dtype
        assert _rel(cache[name].numpy(), want_cache[name]) <= REL

    step_pos = np.full((Bsz, 1), S)
    jctx = JB.BlockCtx(mode="decode", positions=jnp.asarray(step_pos),
                       cache_len=jnp.int32(S + 1), capacity=S + 1)
    want, want_cache, _ = JB.apply_rglru_block(jp, jnp.asarray(x_next), jctx,
                                               jcfg, cache=want_cache)
    ctx = B.BlockCtx(mode="decode", positions=_t(step_pos), cache_len=S + 1,
                     capacity=S + 1)
    got, cache2, _ = B.apply_rglru_block(tp, _t(x_next), ctx, cfg,
                                         cache=cache)
    assert cache2 is cache  # updated in place
    assert _rel(got.numpy(), want) <= REL
    for name in ("h", "conv"):
        assert _rel(cache[name].numpy(), want_cache[name]) <= REL
