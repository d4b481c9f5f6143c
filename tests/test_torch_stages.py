"""Port stage composition (``repro_torch.kernels.stages``): serial ==
sequential, associativity, the carry contract, first-argmax decode, and
stage outputs held against the JAX package's stages on the same numpy
tables.  (One bucket count per batch bucket is pinned at the selector, in
``tests/test_torch_rps.py``.)

Tolerances: the port against itself is bit-for-bit (same ops, same CPU);
the port against JAX is 1e-5 on unit-scale fp32 values, with ids, set ids,
best paths and feasibility equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dsqe import init_dsqe as jax_init
from repro.core.dsqe import projection_stage as jax_projection_stage
from repro.kernels import stages as jst
from repro_torch.core.dsqe import DSQE
from repro_torch.kernels.stages import (decode_stage, retrieve_stage,
                                        score_stage, serial,
                                        shard_projection_stage,
                                        shard_retrieve_stage,
                                        shard_score_stage)

# several xdist workers share the CPU cores: torch's default of one thread
# per core in every worker oversubscribes them and stalls every test
torch.set_num_threads(1)

D_IN, D, K, N, P, KNN = 48, 256, 5, 37, 29, 8


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    unit = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)
    protos = unit(rng.normal(size=(K, D))).astype(np.float32)
    train = unit(rng.normal(size=(N, D))).astype(np.float32)
    pathw = (rng.uniform(size=(N, P)) * (rng.uniform(size=(N, P)) < 0.2)
             ).astype(np.float32)
    contains = (rng.uniform(size=(K, P)) < 0.6).astype(np.float32)
    lat = rng.uniform(0.1, 5.0, P).astype(np.float32)
    cost = rng.uniform(0.0, 0.01, P).astype(np.float32)
    prior = (rng.uniform(size=P) * 1e-3).astype(np.float32)
    valid = (rng.uniform(size=P) < 0.9).astype(np.float32)
    return protos, train, pathw, contains, lat, cost, prior, valid


def _params(seed=0):
    return jax.tree.map(np.asarray, jax_init(jax.random.key(seed), D_IN, K))


def _stages(seed=0):
    protos, train, pathw, contains, lat, cost, prior, valid = _tables(seed)
    enc = DSQE.from_numpy(_params(seed), K, device="cpu")
    return [
        enc.as_stage(),
        retrieve_stage(train, k=KNN, query_key="z", device="cpu"),
        score_stage(protos, pathw, contains, lat, cost, prior, valid,
                    device="cpu"),
        decode_stage(),
    ]


def _carry_np(B=8, seed=1):
    rng = np.random.default_rng(seed)
    return {
        "emb": rng.normal(size=(B, D_IN)).astype(np.float32),
        "slo": np.stack([rng.uniform(0.0, 6.0, B),
                         rng.uniform(0.0, 0.012, B)], axis=1).astype(np.float32),
    }


def _carry(B=8, seed=1):
    return {k: torch.as_tensor(v) for k, v in _carry_np(B, seed).items()}


def _assert_carries_equal(a, b):
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key].numpy(), b[key].numpy(),
                                      err_msg=key)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_serial_prefix_equals_sequential(n):
    """serial of the first n stages == the same n applies run one at a time
    with a host hop between them — bit-for-bit."""
    stages = _stages()[:n]
    state, fused = serial(*stages).init()
    got = fused(state, _carry())

    want = _carry()
    for st, ap in (s.init() for s in stages):
        want = ap(st, want)
        want = {k: torch.as_tensor(v.numpy()) for k, v in want.items()}
    _assert_carries_equal(got, want)


def test_serial_is_associative():
    a, b, c, d = _stages()
    s1, f1 = serial(serial(a, b), c, d).init()
    s2, f2 = serial(a, b, c, d).init()
    _assert_carries_equal(f1(s1, _carry()), f2(s2, _carry()))


def test_fused_carry_contract():
    state, fused = serial(*_stages()).init()
    out = fused(state, _carry())
    assert set(out) == {"emb", "slo", "z", "topk_vals", "topk_ids",
                        "scores", "set_id", "best", "feasible"}
    assert out["topk_ids"].dtype == torch.int32
    assert out["set_id"].dtype == torch.int32
    assert out["best"].dtype == torch.int32
    scores = out["scores"].numpy()
    np.testing.assert_array_equal(out["best"].numpy(), np.argmax(scores, 1))
    np.testing.assert_array_equal(
        out["feasible"].numpy(),
        scores[np.arange(scores.shape[0]), np.argmax(scores, 1)] > -5e29)


def test_decode_first_argmax_on_ties():
    """torch.argmax returns the FIRST maximal index, as np.argmax does."""
    _, apply = decode_stage().init()
    scores = torch.tensor([[0.5, 0.7, 0.7, 0.1], [-1e30, -1e30, -1e30, -1e30],
                           [0.2, 0.2, 0.2, 0.2]])
    out = apply(None, {"scores": scores})
    assert out["best"].tolist() == [1, 0, 0]
    assert out["feasible"].tolist() == [True, False, True]


def test_stages_match_jax_stages():
    """The composed pipeline against the JAX package's on the same params,
    tables and batch."""
    protos, train, pathw, contains, lat, cost, prior, valid = _tables()
    jstages = [jax_projection_stage(_params()),
               jst.retrieve_stage(train, k=KNN, query_key="z"),
               jst.score_stage(protos, pathw, contains, lat, cost, prior, valid),
               jst.decode_stage()]
    jstate, jfused = jst.serial(*jstages).init()
    want = jax.jit(jfused)(jstate, {k: jnp.asarray(v)
                                    for k, v in _carry_np().items()})
    state, fused = serial(*_stages()).init()
    got = fused(state, _carry())
    for key in ("topk_ids", "set_id", "best", "feasible"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    for key in ("z", "topk_vals", "scores"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-5, err_msg=key)


def test_shard_stages_match_jax_shard_stages():
    """The domain-sharded stages (plain torch on both devices) against the
    JAX package's, with padded train rows and prototypes in shard 1."""
    D_ = 2
    t0, t1 = _tables(0), _tables(1)
    layers = [{"w": np.stack([p["layers"][i]["w"] for p in (_params(0), _params(1))]),
               "b": np.stack([p["layers"][i]["b"] for p in (_params(0), _params(1))])}
              for i in range(2)]
    corpora = np.stack([t0[1], t1[1]])
    corpus_valid = np.ones((D_, N), np.float32)
    corpus_valid[1, N - 5:] = 0.0
    corpora[1, N - 5:] = 0.0
    proto_valid = np.ones((D_, K), np.float32)
    proto_valid[1, K - 1] = 0.0
    tabs = [np.stack([a, b]) for a, b in zip(t0, t1)]
    protos, pathw = tabs[0], tabs[2]
    pathw[1, N - 5:] = 0.0
    rest = tabs[3:]
    jst_list = [jst.shard_projection_stage(layers),
                jst.shard_retrieve_stage(corpora, corpus_valid, k=KNN),
                jst.shard_score_stage(protos, proto_valid, pathw, *rest),
                jst.decode_stage()]
    pst_list = [shard_projection_stage(layers, device="cpu"),
                shard_retrieve_stage(corpora, corpus_valid, k=KNN, device="cpu"),
                shard_score_stage(protos, proto_valid, pathw, *rest, device="cpu"),
                decode_stage()]
    jstate, jfused = jst.serial(*jst_list).init()
    state, fused = serial(*pst_list).init()
    for did in (0, 1):
        cnp = _carry_np(seed=did + 3)
        want = jax.jit(jfused)(jstate, {**{k: jnp.asarray(v) for k, v in cnp.items()},
                                        "domain_id": jnp.asarray(did, jnp.int32)})
        got = fused(state, {**{k: torch.as_tensor(v) for k, v in cnp.items()},
                            "domain_id": did})
        for key in ("topk_ids", "set_id", "best", "feasible"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]), err_msg=key)
        np.testing.assert_allclose(got["scores"].numpy(),
                                   np.asarray(want["scores"]), atol=1e-5)
