"""Port DSQE encoder and AdamW (``repro_torch.core.dsqe``, ``repro_torch.optim``)
against the JAX package on carried parameters.

Tolerances: forward values within 1e-5 and gradients within 1e-6 (fp32
matmuls blocked differently by XLA and torch on the CPU); one AdamW step on
the same gradients within 1e-6 (the step is ~3e-3 per entry);
trained set-prediction accuracy within 0.05 (the two packages draw
different random streams from the same seed).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dsqe import dsqe_loss as jax_loss
from repro.core.dsqe import init_dsqe as jax_init
from repro.core.dsqe import project as jax_project
from repro.core.dsqe import prototype_sims as jax_sims
from repro.core.dsqe import train_dsqe as jax_train
from repro.optim import adamw as jax_adamw
from repro.optim import constant_schedule as jax_const
from repro.optim.optimizers import clip_by_global_norm as jax_clip
from repro_torch.core.dsqe import (DSQE, dsqe_loss, loss_grads,
                                   prototype_sims, train_dsqe)
from repro_torch.optim import adamw, clip_by_global_norm, constant_schedule

# several xdist workers share the CPU cores: torch's default of one thread
# per core in every worker oversubscribes them and stalls every test
torch.set_num_threads(1)

D_IN, K, B = 48, 5, 16


@pytest.fixture(scope="module")
def carried():
    """JAX-initialised params (numpy), the port's copy, and a fixed batch."""
    params = jax.tree.map(np.asarray, jax_init(jax.random.key(0), D_IN, K))
    rng = np.random.default_rng(1)
    e = rng.normal(size=(B, D_IN)).astype(np.float32)
    y = rng.integers(0, K, B)
    return params, DSQE.from_numpy(params, K, device="cpu"), e, y


def test_from_numpy_to_numpy_round_trip_is_exact(carried):
    params, enc, *_ = carried
    back = enc.to_numpy()
    assert len(back["layers"]) == len(params["layers"])
    np.testing.assert_array_equal(back["protos"], params["protos"])
    for a, b in zip(back["layers"], params["layers"]):
        np.testing.assert_array_equal(a["w"], b["w"])
        np.testing.assert_array_equal(a["b"], b["b"])


def test_project_and_prototype_sims_match_jax(carried):
    params, enc, e, _ = carried
    z = enc.project(e)
    jz = jax_project(jax.tree.map(jnp.asarray, params), jnp.asarray(e))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-5)
    np.testing.assert_allclose(
        prototype_sims(enc.params, z).numpy(),
        np.asarray(jax_sims(params, jz)), atol=1e-5)
    np.testing.assert_array_equal(
        enc.predict_set(e).numpy(), np.argmax(np.asarray(jax_sims(params, jz)), -1))


def test_no_dropout_loss_matches_jax(carried):
    params, enc, e, y = carried
    total, parts = dsqe_loss(enc.params, torch.as_tensor(e),
                             torch.as_tensor(y), None)
    jt, jparts = jax_loss(jax.tree.map(jnp.asarray, params), jnp.asarray(e),
                          jnp.asarray(y), None)
    np.testing.assert_allclose(float(total), float(jt), rtol=1e-5)
    for name in ("contrast", "diversity", "reg"):
        np.testing.assert_allclose(float(parts[name]), float(jparts[name]),
                                   rtol=1e-5, atol=1e-7)


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(2)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": [rng.normal(size=5).astype(np.float32)]}
    for max_norm in (0.5, 100.0):  # clipping and pass-through
        got, norm = clip_by_global_norm(
            {"a": torch.as_tensor(tree["a"]), "b": [torch.as_tensor(tree["b"][0])]},
            max_norm)
        want, jnorm = jax_clip(jax.tree.map(jnp.asarray, tree), max_norm)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
        np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(got["b"][0].numpy(),
                                   np.asarray(want["b"][0]), rtol=1e-6)


def test_loss_grads_match_jax(carried):
    params, enc, e, y = carried
    _, grads = loss_grads(enc.params, torch.as_tensor(e), torch.as_tensor(y),
                          None)
    jgrads = jax.grad(lambda p: jax_loss(p, jnp.asarray(e), jnp.asarray(y),
                                         None)[0])(jax.tree.map(jnp.asarray, params))
    np.testing.assert_allclose(grads["protos"].numpy(),
                               np.asarray(jgrads["protos"]), atol=1e-6)
    for a, b in zip(grads["layers"], jgrads["layers"]):
        np.testing.assert_allclose(a["w"].numpy(), np.asarray(b["w"]), atol=1e-6)
        np.testing.assert_allclose(a["b"].numpy(), np.asarray(b["b"]), atol=1e-6)


def test_one_adamw_step_matches_jax(carried):
    """One AdamW step of each package (b2 = 0.95, global-norm clip 1.0,
    weight_decay 0) from the same params and the same gradients — the JAX
    gradients of a fixed no-dropout batch, fed to both, because the first
    step is ~lr * sign(g) and would amplify ulp noise in near-zero
    gradient entries."""
    params, _, e, y = carried
    jparams = jax.tree.map(jnp.asarray, params)
    jgrads = jax.grad(lambda p: jax_loss(p, jnp.asarray(e), jnp.asarray(y),
                                         None)[0])(jparams)
    jopt = jax_adamw(jax_const(3e-3), weight_decay=0.0)
    jnew, jstate = jopt.update(jgrads, jopt.init(jparams), jparams,
                               jnp.zeros((), jnp.int32))

    to_t = lambda tree: jax.tree.map(lambda x: torch.as_tensor(np.array(x)), tree)
    tparams = to_t(params)
    opt = adamw(constant_schedule(3e-3), weight_decay=0.0)
    new, state = opt.update(to_t(jgrads), opt.init(tparams), tparams, 0)
    np.testing.assert_allclose(new["protos"].numpy(),
                               np.asarray(jnew["protos"]), atol=1e-6)
    for a, b in zip(new["layers"], jnew["layers"]):
        np.testing.assert_allclose(a["w"].numpy(), np.asarray(b["w"]), atol=1e-6)
        np.testing.assert_allclose(a["b"].numpy(), np.asarray(b["b"]), atol=1e-6)
    for mom in ("m", "v"):
        np.testing.assert_allclose(state[mom]["protos"].numpy(),
                                   np.asarray(jstate[mom]["protos"]),
                                   rtol=1e-6, atol=1e-12)


def test_port_trained_accuracy_close_to_jax():
    """End-to-end training is held by quality: set-prediction accuracy on
    the training split within 0.05 of the JAX encoder's."""
    from repro.core.cca import critical_component_analysis
    from repro.core.domains import build_domain, train_test_split
    from repro.core.emulator import Emulator
    from repro.core.paths import PathSpace

    dom = build_domain("agriculture", n_queries=40, seed=3)
    train_idx, _ = train_test_split(dom, 0.3)
    table = Emulator(dom, PathSpace(), seed=3).explore(train_idx, budget=3.0,
                                                       lam=0)
    cca = critical_component_analysis(table, lam=0)
    emb = dom.query_embeddings[train_idx]
    labels = np.asarray(cca.set_ids)
    n_sets = len(cca.set_vocab)
    jenc = jax_train(emb, labels, n_sets, seed=3)
    jacc = float(np.mean(np.argmax(np.asarray(
        jax_sims(jenc.params, jenc.project(jnp.asarray(emb)))), -1) == labels))
    enc = train_dsqe(emb, labels, n_sets, seed=3, device="cpu")
    acc = float(np.mean(enc.predict_set(emb).numpy() == labels))
    assert abs(acc - jacc) <= 0.05, (acc, jacc)
    assert acc > 1.0 / n_sets  # learned something beyond chance
