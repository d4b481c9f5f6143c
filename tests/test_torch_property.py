"""Property tests on system invariants of the port, case by case with
``tests/test_property.py``, each drawn input also through the JAX
package's function.

The reference case's invariant is checked on the port's function, and the
port's output is held against JAX's on the same numpy input: host numpy
code (Pareto front, k-means) and integer plans (MoE dispatch indices,
int8 codes) exactly, float32 device math at the tolerance stated beside
it.  Hypothesis runs 5 derandomized examples a case (the reference draws
25), so the JAX side stays within the time budget.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="hypothesis not installed; property tests skipped")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core.emulator import pareto_front as jax_pareto_front  # noqa: E402
from repro.core.kmeans import kmeans as jax_kmeans  # noqa: E402
from repro.core.kmeans import representatives as jax_representatives  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.optim.grad_compression import dequantize_int8 as jax_dequantize  # noqa: E402
from repro.optim.grad_compression import quantize_int8 as jax_quantize  # noqa: E402
from repro_torch.core.emulator import pareto_front  # noqa: E402
from repro_torch.core.kmeans import kmeans, representatives  # noqa: E402
from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention.ref import slot_visible  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.optim.grad_compression import dequantize_int8, quantize_int8  # noqa: E402

torch.set_num_threads(1)
_settings = settings(max_examples=5, derandomize=True, deadline=None,
                     database=None)
# jitted: eager JAX dispatches the scan's and the dispatch plan's many small
# ops one by one, several times slower than one compile per drawn shape
_jax_dispatch = jax.jit(JB.moe_dispatch_indices,
                        static_argnames=("top_k", "capacity"))
_jax_scan = jax.jit(JB.rglru_scan)


@_settings
@given(st.integers(1, 6), st.integers(1, 32), st.floats(0.1, 100.0))
def test_quantize_roundtrip_error_bound(seed, blocks, scale):
    rng = np.random.RandomState(seed)
    x_np = rng.randn(blocks * 256).astype(np.float32) * scale
    x = torch.from_numpy(x_np)
    q, s = quantize_int8(x)
    back = dequantize_int8(q, s, x.shape, torch.float32)
    # error bounded by half a quantization step per block
    per_block = np.abs(x_np).reshape(-1, 256).max(1) / 127.0
    err = np.abs((back - x).numpy()).reshape(-1, 256).max(1)
    assert np.all(err <= per_block * 0.5 + 1e-6)
    # the same int8 codes and fp32 scales as the JAX package's, bit for bit
    jq, js = jax_quantize(jnp.asarray(x_np))
    assert np.array_equal(q.numpy(), np.asarray(jq).reshape(q.shape))
    assert np.array_equal(s.numpy().view(np.uint32),
                          np.asarray(js).reshape(s.shape).view(np.uint32))
    jback = jax_dequantize(jq, js, x_np.shape, jnp.float32)
    assert np.array_equal(back.numpy(), np.asarray(jback))


@_settings
@given(st.integers(0, 10), st.integers(5, 60), st.integers(2, 3))
def test_pareto_front_nonempty_and_contains_best(seed, n, dims):
    rng = np.random.RandomState(seed)
    pts = rng.rand(n, dims)
    mask = pareto_front(pts)
    assert mask.any()
    # the max-accuracy point is always on the front
    best = np.where(pts[:, 0] == pts[:, 0].max())[0]
    assert mask[best].any()
    assert np.array_equal(mask, jax_pareto_front(pts))


@_settings
@given(st.integers(0, 5), st.integers(8, 60), st.integers(2, 6))
def test_kmeans_representatives_valid(seed, n, k):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 8).astype(np.float32)
    reps = representatives(x, k, seed=seed)
    assert len(reps) >= 1
    assert len(set(reps)) == len(reps)
    assert all(0 <= r < n for r in reps)
    C, assign = kmeans(x, k, seed=seed)
    assert assign.shape == (n,)
    assert assign.max() < C.shape[0]
    assert reps == jax_representatives(x, k, seed=seed)
    jC, jassign = jax_kmeans(x, k, seed=seed)
    assert np.array_equal(C, jC) and np.array_equal(assign, jassign)


@_settings
@given(st.integers(0, 8), st.integers(2, 5), st.integers(1, 3), st.integers(8, 32))
def test_moe_dispatch_conservation(seed, E, k, T):
    """Every kept assignment routes a real token to the expert the router
    chose; combine weights are the normalized router weights; the plan is
    the JAX package's on the same router probabilities, index for index."""
    k = min(k, E)
    rng = np.random.RandomState(seed)
    jprobs = jax.nn.softmax(jnp.asarray(rng.randn(T, E).astype(np.float32)), -1)
    probs = torch.from_numpy(np.array(jprobs))
    cap = max(8, T)  # dropless capacity for the invariant check
    gi, cw, slots = B.moe_dispatch_indices(probs, top_k=k, capacity=cap)
    jgi, jcw, jslots = _jax_dispatch(jprobs, top_k=k, capacity=cap)
    assert np.array_equal(gi.numpy(), np.asarray(jgi))
    assert np.array_equal(slots.numpy(), np.asarray(jslots))
    np.testing.assert_allclose(cw.numpy(), np.asarray(jcw), rtol=0, atol=1e-6)
    gi = gi.numpy().reshape(-1)
    cw = cw.numpy().reshape(-1)
    slots = slots.numpy()
    top_p, top_e = torch.topk(probs, k)
    top_p = (top_p / top_p.sum(-1, keepdim=True)).numpy()
    top_e = top_e.numpy()
    # inverse map consistency: slot_table points at a slot holding that token
    for t in range(T):
        for j in range(k):
            s = slots[t, j]
            assert s < E * cap  # dropless -> no sentinel
            assert gi[s] == t
            assert abs(cw[s] - top_p[t, j]) < 1e-6
            assert s // cap == top_e[t, j]  # right expert
    # weight conservation: kept combine weights sum to 1 per token
    sums = np.zeros(T)
    for s in range(E * cap):
        if gi[s] < T:
            sums[gi[s]] += cw[s]
    np.testing.assert_allclose(sums, 1.0, atol=1e-5)


@_settings
@given(st.integers(0, 5), st.sampled_from([16, 64, 256]), st.integers(1, 4))
def test_chunked_ce_matches_full(seed, S, bsz):
    rng = np.random.RandomState(seed)
    D, V = 16, 64
    x_np = rng.randn(bsz, S, D).astype(np.float32)
    head_np = rng.randn(D, V).astype(np.float32)
    labels_np = rng.randint(0, V, (bsz, S))
    x, head = torch.from_numpy(x_np), torch.from_numpy(head_np)
    labels = torch.from_numpy(labels_np)
    nll_c, _ = L.chunked_cross_entropy(x, head, labels, chunk=16, z_loss=0.0)
    logits = x @ head
    lse = torch.logsumexp(logits, -1)
    gold = torch.take_along_dim(logits, labels[..., None], -1)[..., 0]
    nll_full = torch.mean(lse - gold)
    assert abs(float(nll_c - nll_full)) < 1e-4
    # JAX's chunked loss on the same arrays: fp32 sums in another order
    jnll, _ = JL.chunked_cross_entropy(jnp.asarray(x_np), jnp.asarray(head_np),
                                       jnp.asarray(labels_np), chunk=16,
                                       z_loss=0.0)
    assert abs(float(nll_c) - float(jnll)) <= 1e-5 * max(1.0, abs(float(jnll)))


@_settings
@given(st.integers(2, 512), st.integers(0, 2**20))
def test_ring_cache_position_math(width, qpos):
    """Ring slot j holds p_j = qpos - ((qpos - j) mod W): p_j is in
    (qpos - W, qpos], p_j % W == j, and slot(qpos) maps to qpos itself.
    The port's ring mask is p_j >= 0, and its ring decode attention over
    a cache whose values name their slot averages the slots JAX's oracle
    averages."""
    slots = np.arange(width)
    p = qpos - np.mod(qpos - slots, width)
    assert np.all(p <= qpos)
    assert np.all(p > qpos - width)
    assert np.all(np.mod(p, width) == slots)
    assert p[qpos % width] == qpos
    visible = slot_visible(width, qpos + 1, ring=True, chunk_attn=0,
                           device="cpu")
    assert np.array_equal(visible.numpy(), p >= 0)
    q = np.zeros((1, 1, 1, 16), np.float32)  # equal scores: a plain mean
    k = np.zeros((1, width, 1, 16), np.float32)
    v = np.zeros((1, width, 1, 16), np.float32)
    v[0, :, 0, 0] = slots
    v[0, :, 0, 1] = 1.0
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), qpos + 1, ring=True)
    want = decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.int32(qpos + 1), ring=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy()[0, 0, 0, 0], slots[p >= 0].mean(),
                               rtol=1e-5)


@_settings
@given(st.integers(0, 5), st.integers(1, 3), st.sampled_from([32, 128]),
       st.booleans())
def test_rglru_scan_associative_matches_sequential(seed, bsz, S, use_h0):
    """The port's scan (its plain loop here) against the sequential
    recurrence and JAX's associative scan, from zeros or from a drawn
    initial state."""
    rng = np.random.RandomState(seed)
    R = 16
    a_log = -np.abs(rng.rand(bsz, S, R)).astype(np.float32) * 0.5
    x = rng.randn(bsz, S, R).astype(np.float32)
    h0 = rng.randn(bsz, R).astype(np.float32) if use_h0 else None
    h = B.rglru_scan(torch.from_numpy(x), torch.from_numpy(a_log),
                     torch.from_numpy(x),
                     None if h0 is None else torch.from_numpy(h0)).numpy()
    # sequential reference
    a = np.exp(a_log)
    hh = np.zeros((bsz, R), np.float32) if h0 is None else h0.copy()
    outs = []
    for t in range(S):
        hh = a[:, t] * hh + x[:, t]
        outs.append(hh.copy())
    ref = np.stack(outs, axis=1)
    np.testing.assert_allclose(h, ref, atol=1e-4)
    jh = _jax_scan(jnp.asarray(x), jnp.asarray(a_log), jnp.asarray(x),
                   None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(h, np.asarray(jh), atol=1e-4)
