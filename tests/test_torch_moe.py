"""The port's MoE FFN (``repro_torch.models.blocks`` MoE section and the
``moe_gmm`` op) against the JAX package, on the CPU, where ``moe_gmm``
takes its plain version.

Tolerances:
  * ``moe_gmm`` fp32: max |port - JAX| <= 1e-5 of max |JAX oracle|, the bound
    of ``tests/test_kernels.py`` (fp32 sums of the same products in another
    order).  bf16: element by element against the fp32 oracle,
    2^-8 |ref| + 1e-5 (|x| . |w|) (the port rounds its fp32 sum to bf16 once,
    at most 2^-8 of the value, and the two fp32 sums differ by far less than
    1e-5 of the sum of the products' magnitudes); against the Pallas kernel,
    whose output is rounded too, 2^-7 |ref| + 1e-5 (|x| . |w|).
  * dispatch indices (gather_idx, combine_w, slot_table): exactly equal.
  * ``moe_apply`` and ``moe_group_compute``: max abs difference <= 1e-5 of
    the largest output (fp32 matmuls summed in another order); aux <= 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.moe_gmm.ops import moe_gmm as jax_moe_gmm_kernel
from repro.kernels.moe_gmm.ref import moe_gmm_ref as jax_moe_gmm_ref
from repro.models import blocks as JB
from repro_torch.configs import get_config
from repro_torch.kernels.moe_gmm.ops import moe_gmm
from repro_torch.models import blocks as B

torch.set_num_threads(1)  # several xdist workers share the cores

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(np.asarray(got, np.float32) - want))
                 / np.max(np.abs(want)))


def _to_torch(tree):
    """A JAX tree as torch tensors (fp32 or bf16, bits kept)."""
    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree.map(leaf, tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,D,F", [(4, 64, 256, 512), (8, 24, 100, 96),
                                     (2, 128, 512, 128)])
def test_moe_gmm_plain_matches_jax(E, C, D, F, dtype):
    jdt, tdt = _DTYPES[dtype]
    rng = np.random.default_rng(E * C)
    x32 = (rng.standard_normal((E, C, D)) / np.sqrt(D)).astype(np.float32)
    w32 = rng.standard_normal((E, D, F)).astype(np.float32)
    jx, jw = jnp.asarray(x32).astype(jdt), jnp.asarray(w32).astype(jdt)
    tx, tw = _to_torch((jx, jw))
    before = moe_gmm.launches
    got = moe_gmm(tx, tw)
    assert moe_gmm.launches == before  # CPU: the plain version
    assert got.dtype == tdt and got.shape == (E, C, F)
    got = got.float().numpy()
    ref = np.asarray(jax_moe_gmm_ref(jx.astype(jnp.float32),
                                     jw.astype(jnp.float32)))
    pallas = np.asarray(jax_moe_gmm_kernel(jx, jw, block_m=32, block_n=128,
                                           block_k=128, interpret=True),
                        np.float32)
    if dtype == "float32":
        assert _rel(got, ref) <= 1e-5
        assert _rel(got, pallas) <= 1e-5
        return
    mag = np.einsum("ecd,edf->ecf", np.abs(np.asarray(jx, np.float32)),
                    np.abs(np.asarray(jw, np.float32)))
    assert (np.abs(got - ref) <= 2.0 ** -8 * np.abs(ref) + 1e-5 * mag).all()
    assert (np.abs(got - pallas) <= 2.0 ** -7 * np.abs(ref) + 1e-5 * mag).all()


def _probs(rng, T, E, ties: bool):
    if ties:  # few distinct values: exact ties inside rows and across them
        return rng.choice(np.float32([0.05, 0.1, 0.2]), size=(T, E))
    logits = rng.standard_normal((T, E)).astype(np.float32)
    return np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))


@pytest.mark.parametrize("T,E,k,cap,ties", [
    (40, 8, 2, 16, False),   # room for every assignment
    (64, 8, 2, 8, False),    # capacity drops tokens
    (30, 16, 1, 8, False),   # top-1, some experts overflow
    (24, 6, 2, 8, True),     # exact router ties, with drops
    (9, 4, 3, 8, True),      # ties at the k-th place
])
def test_moe_dispatch_indices_equal_jax(T, E, k, cap, ties):
    probs = _probs(np.random.default_rng(T * E + k), T, E, ties)
    want = JB.moe_dispatch_indices(jnp.asarray(probs), top_k=k, capacity=cap)
    got = B.moe_dispatch_indices(torch.from_numpy(probs), top_k=k,
                                 capacity=cap)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    slot_table = got[2].numpy()
    if cap * E < T * k:
        assert (slot_table == E * cap).any()  # the case does drop


def test_moe_dispatch_indices_batched_equal_jax_vmap():
    rng = np.random.default_rng(5)
    probs = np.stack([_probs(rng, 32, 8, ties=g == 1) for g in range(3)])
    want = jax.vmap(lambda p: JB.moe_dispatch_indices(p, top_k=2,
                                                      capacity=8))(
        jnp.asarray(probs))
    got = B.moe_dispatch_indices(torch.from_numpy(probs), top_k=2, capacity=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _moe_params(arch, **overrides):
    jcfg = jax_get_config(arch).reduced().with_overrides(**overrides)
    cfg = get_config(arch).reduced().with_overrides(**overrides)
    jp = JB.init_moe(jax.random.key(7), jcfg)
    return jcfg, jp, cfg, _to_torch(jp)


@pytest.mark.parametrize("arch,overrides,S", [
    ("llama4-scout-17b-a16e", {}, 24),      # top-1 + shared expert
    ("kimi-k2-1t-a32b", {}, 24),            # top-2 + shared expert
    ("kimi-k2-1t-a32b", {"capacity_factor": 0.5}, 40),  # drops by capacity
    ("llama4-scout-17b-a16e", {}, 1),       # decode: one group of B tokens
])
def test_moe_apply_matches_jax(arch, overrides, S):
    jcfg, jp, cfg, tp = _moe_params(arch, **overrides)
    x = np.random.default_rng(S).standard_normal(
        (3, S, cfg.d_model)).astype(np.float32)
    want, want_aux = JB.moe_apply(jp, jnp.asarray(x), jcfg)
    if overrides:  # 3 groups of 40 tokens x 2 > 8 experts x capacity 8
        assert B.moe_capacity(S, cfg) * cfg.num_experts < 2 * S
    before = moe_gmm.launches
    got, aux = B.moe_apply(tp, torch.from_numpy(x), cfg)
    assert moe_gmm.launches == before
    assert got.shape == x.shape and aux.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-5
    assert abs(float(aux) - float(want_aux)) <= 1e-5


def test_moe_group_compute_with_expert_offset_matches_jax():
    """An expert-parallel shard: experts 3..6 of 8, tokens above capacity
    dropped; only the shard's experts contribute."""
    jcfg, jp, cfg, tp = _moe_params("kimi-k2-1t-a32b")
    rng = np.random.default_rng(9)
    T = 40
    x = rng.standard_normal((T, cfg.d_model)).astype(np.float32)
    probs = _probs(rng, T, cfg.num_experts, ties=False)
    lo, hi = 3, 7
    kw = dict(capacity=8, top_k=2, activation=cfg.activation, expert_offset=lo)
    want = JB.moe_group_compute(jnp.asarray(x), jnp.asarray(probs),
                                jp["w_gate"][lo:hi], jp["w_up"][lo:hi],
                                jp["w_down"][lo:hi], **kw)
    got = B.moe_group_compute(torch.from_numpy(x), torch.from_numpy(probs),
                              tp["w_gate"][lo:hi], tp["w_up"][lo:hi],
                              tp["w_down"][lo:hi], **kw)
    assert got.shape == (T, cfg.d_model)
    assert _rel(got.numpy(), want) <= 1e-5
    # tokens routed to no local expert get nothing
    top_e = np.argsort(-probs, axis=-1, kind="stable")[:, :2]
    outside = ~((top_e >= lo) & (top_e < hi)).any(-1)
    assert outside.any() and not np.abs(got.numpy()[outside]).any()
