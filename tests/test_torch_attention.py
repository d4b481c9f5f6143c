"""The port's attention ops (``repro_torch.kernels.{flash,decode}_attention``)
against the JAX package, on the CPU, where each op takes its plain version.

The same numpy inputs go to the port and to JAX's oracles
(``attention_ref`` / ``decode_attention_ref``), its XLA layers
(``layers.flash_attention_xla`` / ``decode_attention_xla``) and, one small
case each, its Pallas kernels in interpret mode.  Tolerance: fp32, atol
1e-5 (the same fp32 softmax, summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode_kernel
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref
from repro.kernels.flash_attention.ops import flash_attention as jax_flash_kernel
from repro.kernels.flash_attention.ref import attention_ref as jax_flash_ref
from repro.models import layers as JL
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers as L

ATOL = 1e-5

torch.set_num_threads(1)  # several xdist workers share the cores


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


FLASH_CASES = [
    # B, Sq, Skv, H, Kv, hd, causal, window, chunk
    (2, 37, 37, 4, 4, 16, True, 0, 0),     # G = 1, ragged Sq
    (1, 100, 100, 8, 4, 32, True, 24, 0),  # G = 2, sliding window
    (2, 70, 70, 8, 2, 16, True, 0, 32),    # G = 4, chunked
    (1, 50, 50, 4, 1, 16, False, 0, 0),    # MQA, non-causal
    (2, 13, 40, 4, 2, 16, False, 0, 0),    # Sq != Skv
]


@pytest.mark.parametrize("B,Sq,Skv,H,Kv,hd,causal,window,chunk", FLASH_CASES)
def test_flash_attention_matches_jax(B, Sq, Skv, H, Kv, hd, causal, window,
                                     chunk):
    q, k, v = _inputs(Sq + H, (B, Sq, H, hd), (B, Skv, Kv, hd),
                      (B, Skv, Kv, hd))
    before = flash_attention.launches
    got = flash_attention(*_t(q, k, v), causal=causal, window=window,
                          chunk_attn=chunk).numpy()
    assert flash_attention.launches == before  # CPU: the plain version
    want = jax_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, window=window, chunk_attn=chunk)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    xla = JL.flash_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, window=window,
                                 chunk_attn=chunk)
    port = L.flash_attention_xla(*_t(q, k, v), causal=causal, window=window,
                                 chunk_attn=chunk).numpy()
    np.testing.assert_allclose(port, np.asarray(xla), atol=ATOL, rtol=0)


def test_flash_attention_matches_the_pallas_kernel():
    q, k, v = _inputs(5, (1, 128, 4, 64), (1, 128, 2, 64), (1, 128, 2, 64))
    want = jax_flash_kernel(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True, block_q=64, block_k=64,
                            interpret=True)
    got = flash_attention(*_t(q, k, v), causal=True).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


def test_flash_attention_row_that_sees_no_key_is_zero():
    """The port's contract (the kernel's tile skip): a row with no visible
    key comes out 0, where attention_ref averages v.  Every other row
    matches attention_ref."""
    q, k, v = _inputs(9, (1, 20, 2, 16), (1, 8, 2, 16), (1, 8, 2, 16))
    got = flash_attention(*_t(q, k, v), causal=False, window=4).numpy()
    want = np.asarray(jax_flash_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=False, window=4))
    blind = np.arange(20) >= 8 + 4 - 1  # t - u >= 4 for every key u < 8
    assert (got[:, blind] == 0).all()
    np.testing.assert_allclose(got[:, ~blind], want[:, ~blind], atol=ATOL)


DECODE_CASES = [
    # B, H, Kv, hd, W, ring, chunk, cache_len
    (2, 4, 4, 16, 40, False, 0, 23),   # G = 1
    (2, 8, 4, 32, 64, False, 0, 64),   # G = 2, full cache
    (1, 8, 2, 16, 50, False, 0, 1),    # G = 4, one token
    (1, 4, 1, 16, 32, True, 0, 75),    # MQA ring, wrapped
    (2, 4, 2, 16, 32, True, 0, 20),    # ring not yet full
    (2, 8, 8, 16, 32, True, 16, 90),   # chunked ring
    (1, 4, 2, 32, 48, True, 24, 48),   # chunk boundary at the ring edge
]


@pytest.mark.parametrize("B,H,Kv,hd,W,ring,chunk,clen", DECODE_CASES)
def test_decode_attention_matches_jax(B, H, Kv, hd, W, ring, chunk, clen):
    q, kc, vc = _inputs(W + clen, (B, 1, H, hd), (B, W, Kv, hd),
                        (B, W, Kv, hd))
    want = jax_decode_ref(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                          jnp.int32(clen), ring=ring, chunk_attn=chunk)
    xla = JL.decode_attention_xla(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.int32(clen), ring=ring,
                                  chunk_attn=chunk)
    before = decode_attention.launches
    for cache_len in (clen, torch.tensor(clen, dtype=torch.int32)):
        got = decode_attention(*_t(q, kc, vc), cache_len, ring=ring,
                               chunk_attn=chunk).numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
        port = L.decode_attention_xla(*_t(q, kc, vc), cache_len, ring=ring,
                                      chunk_attn=chunk).numpy()
        np.testing.assert_allclose(port, np.asarray(xla), atol=ATOL, rtol=0)
    assert decode_attention.launches == before


def test_decode_attention_matches_the_pallas_kernel():
    q, kc, vc = _inputs(3, (2, 1, 8, 64), (2, 256, 4, 64), (2, 256, 4, 64))
    for ring, clen in ((False, 300), (True, 700)):
        want = jax_decode_kernel(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.int32(clen), ring=ring,
                                 block_k=128, interpret=True)
        got = decode_attention(*_t(q, kc, vc), clen, ring=ring).numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
