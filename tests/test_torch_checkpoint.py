"""The port's checkpointer and data pipeline (``repro_torch.checkpoint``,
``repro_torch.data``) against the JAX package's, on the CPU.

The checkpointer's cases are the JAX package's own
(``tests/test_fault_tolerance.py``: round trip, gc and latest, async and
atomic) on the port, then parity: the port writes the JAX package's files
(``manifest.json`` equal, every ``.npy`` member of ``shards.npz`` equal byte
for byte, bf16 leaves included), and JAX-written fp32 and bf16 trees
restore bit-equal in the port.  The pipeline's batches equal the JAX
package's exactly, for every dp rank and from a corpus.
"""
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.data import ByteTokenizer as JaxTokenizer
from repro.data import TokenPipeline as JaxPipeline
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import ByteTokenizer, TokenPipeline


def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_checkpoint_roundtrip(tmp_path):
    ckpt = Checkpointer(tmp_path)
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": [torch.ones(5), {"c": torch.zeros(2, dtype=torch.int32)}],
            "h": torch.randn(7).bfloat16()}
    ckpt.save(7, tree)
    step, restored = ckpt.restore(tree)
    assert step == 7
    assert list(restored) == list(tree)  # the caller's key order
    _leaves_equal(restored, tree)


def test_checkpoint_gc_and_latest(tmp_path):
    ckpt = Checkpointer(tmp_path, keep=2)
    tree = {"w": torch.ones(3)}
    for s in [1, 2, 3, 4]:
        ckpt.save(s, tree)
    assert ckpt.all_steps() == [3, 4]
    assert ckpt.latest_step() == 4


def test_checkpoint_async_and_atomic(tmp_path):
    ckpt = Checkpointer(tmp_path)
    tree = {"w": torch.arange(1000.0)}
    ckpt.save_async(5, tree)
    tree["w"] += 1  # the host copy was taken before save_async returned
    ckpt.wait()
    assert ckpt.latest_step() == 5
    # a stale tmp dir never counts as a checkpoint
    (tmp_path / "step_0000000009.tmp").mkdir()
    assert ckpt.latest_step() == 5
    _, restored = ckpt.restore(tree)
    assert torch.equal(restored["w"], torch.arange(1000.0))


def test_checkpoint_restore_places_on_like_and_refuses_a_shape(tmp_path):
    ckpt = Checkpointer(tmp_path)
    ckpt.save(1, {"w": torch.arange(4, dtype=torch.float32)})
    _, r = ckpt.restore({"w": torch.zeros(4, dtype=torch.float64)})
    assert r["w"].dtype == torch.float64
    _, r = ckpt.restore({"w": torch.zeros(4)}, device="cpu")
    assert r["w"].device.type == "cpu"
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore({"w": torch.zeros(5)})
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore({"w": torch.zeros(4)})


def _trees():
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    b16 = rng.standard_normal((2, 7)).astype(np.float32)
    jtree = ({"w": jnp.asarray(b16, jnp.bfloat16),
              "b": [jnp.asarray(f32), {"c": jnp.arange(6, dtype=jnp.int32)}]},
             {"m": {"x": jnp.float32(2.5)}})
    ttree = ({"w": torch.from_numpy(b16).bfloat16(),
              "b": [torch.from_numpy(f32),
                    {"c": torch.arange(6, dtype=torch.int32)}]},
             {"m": {"x": torch.tensor(2.5)}})
    return jtree, ttree


def test_port_writes_the_jax_files(tmp_path):
    jtree, ttree = _trees()
    JaxCheckpointer(tmp_path / "jax").save(3, jtree)
    Checkpointer(tmp_path / "port").save(3, ttree)
    jdir = tmp_path / "jax" / "step_0000000003"
    tdir = tmp_path / "port" / "step_0000000003"
    assert (jdir / "manifest.json").read_text() == \
        (tdir / "manifest.json").read_text()
    manifest = json.loads((tdir / "manifest.json").read_text())
    assert [m["dtype"] for m in manifest["leaves"]] == \
        ["float32", "int32", "bfloat16", "float32"]
    with zipfile.ZipFile(jdir / "shards.npz") as zj, \
            zipfile.ZipFile(tdir / "shards.npz") as zt:
        assert zj.namelist() == zt.namelist()
        for name in zj.namelist():
            assert zj.read(name) == zt.read(name), name


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_jax_checkpoints_restore_bit_equal_in_the_port(tmp_path, dtype):
    """fp32 and bf16 trees written by the JAX package (whose own restore
    cannot read a bf16 leaf back, ROADMAP.md §3) restore bit for bit."""
    rng = np.random.default_rng(1)
    arrays = {"embed": rng.standard_normal((16, 8)),
              "stack": {"units": [{"w": rng.standard_normal((8, 8))}
                                  for _ in range(2)]}}
    jtree = jax.tree.map(lambda a: jnp.asarray(a, dtype), arrays)
    opt = jax.tree.map(lambda a: jnp.asarray(a * 0.5, jnp.float32), arrays)
    JaxCheckpointer(tmp_path).save(4, (jtree, {"m": opt}))
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    like = (jax.tree.map(lambda a: torch.zeros(a.shape, dtype=tdt), arrays),
            {"m": jax.tree.map(lambda a: torch.zeros(a.shape), arrays)})
    step, (params, state) = Checkpointer(tmp_path).restore(like)
    assert step == 4
    for got, want in zip(jax.tree.leaves(params), jax.tree.leaves(jtree)):
        want = np.asarray(want)
        if dtype == jnp.bfloat16:
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)
    for got, want in zip(jax.tree.leaves(state), jax.tree.leaves(opt)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dp_size,seed", [(1, 0), (2, 3), (4, 11)])
def test_pipeline_batches_equal_jax(dp_size, seed):
    for rank in range(dp_size):
        kw = dict(vocab_size=512, seq_len=16, global_batch=8, dp_rank=rank,
                  dp_size=dp_size, seed=seed)
        port, ref = TokenPipeline(**kw), JaxPipeline(**kw)
        for step in (0, 1, 10, 12345):
            got, want = port.batch_at(step), ref.batch_at(step)
            assert set(got) == {"tokens", "labels"}
            for k in got:
                assert got[k].dtype == want[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], want[k])


def test_pipeline_from_a_corpus_and_the_tokenizer_equal_jax():
    corpus = ["the port trains", "on the card", "ünïcode ok"]
    kw = dict(vocab_size=300, seq_len=12, global_batch=4, seed=2,
              corpus=corpus)
    np.testing.assert_array_equal(TokenPipeline(**kw).batch_at(5)["tokens"],
                                  JaxPipeline(**kw).batch_at(5)["tokens"])
    tok, jtok = ByteTokenizer(), JaxTokenizer()
    assert tok.vocab_size == jtok.vocab_size
    assert tok.encode(corpus[2]) == jtok.encode(corpus[2])
    assert tok.decode(tok.encode(corpus[2])) == corpus[2]
    it = iter(TokenPipeline(**kw).iter_from(5))
    np.testing.assert_array_equal(next(it)["tokens"],
                                  JaxPipeline(**kw).batch_at(5)["tokens"])
