"""The port's distributed layer on several ranks, on the CPU.

Two ranks run as spawned processes on ``gloo`` over a ``FileStore`` in the
test's ``tmp_path``; rank 0 writes what it measured to a file that the
test reads.  Against the port's unsharded step (which
``tests/test_torch_train.py`` holds against JAX's loss, grads and AdamW):

* one reduced InternLM2 fp32 train step (stacked units under remat, 2
  microbatches) on the meshes (1, 2) (tp, AdamW and Adafactor) and (2, 1)
  (dp), and with
  ``Kv % tp != 0`` (MQA, and 6 query heads over 3 or 1 KV heads), where k
  and v stay replicated and each rank passes its query heads' KV heads:
  loss within rel 1e-5, the gradient the optimizer receives and every
  updated parameter within 1e-4 of the leaf's max (``PERF.md`` §2's
  fp32-twin bounds);
* the loss and every grad leaf of each other block family (MoE, RG-LRU
  hybrid, xLSTM, encoder-decoder, VLM), reduced, on a (1, 2) mesh: loss
  rel 1e-5, each leaf within 1e-4 of its max |g|;
* ``launch.train.train(..., tp=2)`` against the same call on one device;
* ``compressed_psum`` on 2 ranks bit-equal to the value built here from
  JAX's ``compress_tree`` of each rank's gradients (the int32 sum of the
  codes times the mean scale, over n);
* ``reshard_restore`` of a reduced xLSTM onto a (1, 2) mesh bit-equal, and
  a save of the DTensors (gathered whole) that restores bit-equal too.

``decode_attention`` on its rank's shard (``api.local_decode``) against
the plain op, on a cache whose heads or whose slots are split over the
ranks (the slices merged by their lse); a prefill and a decode step of
reduced InternLM2, Scout, RecurrentGemma (its one KV head puts the cache
on the policy's sequence fallback), LLaVA, SeamlessM4T and xLSTM with the
policy against the plain steps (logits within 1e-5 of the largest).  In one process:
``PodMonitor``'s heartbeat sequence (the reference's,
``tests/test_fault_tolerance.py``); on fake process groups
``survivor_mesh`` of a (2, 2, 1) mesh, and the production meshes, which
need worlds of 256 and 512 ranks.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
LOSS_REL = 1e-5
PARAM_REL = 1e-4
GRAD_REL = 1e-4


def _entry(rank, world, store, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, fn, *args, world=2):
    mp.spawn(_entry, args=(world, str(tmp_path / "store"), fn, args),
             nprocs=world, join=True)


def _rel_worst(got, want) -> float:
    from repro_torch.optim.optimizers import tree_leaves

    return max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


def _step_case(mesh_shape, overrides, opt_name) -> dict:
    """One sharded train step against the unsharded one on the same
    weights and batch: loss rel, the worst gradient leaf (the gradient
    the optimizer receives, rel to its max |g|) and the worst updated
    parameter leaf (rel to its max |p|), and the state's tensor types."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import ShardingPolicy, \
        to_local_tree
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import lm
    from repro_torch.optim import (Optimizer, adafactor, adamw,
                                   constant_schedule, sgd)
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    cfg = get_config("internlm2-1.8b").reduced().with_overrides(
        scan_layers=True, remat=True, **overrides)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = lm.init_params(gen, cfg, device="cpu")
    opt = {"adamw": adamw, "sgd": sgd, "adafactor": adafactor}[opt_name](
        constant_schedule(1e-3))
    seen = {}

    def recording(tag):
        def update(grads, state, p, step):
            seen[tag] = grads
            return opt.update(grads, state, p, step)

        return Optimizer(opt.name, opt.init, update)

    state = opt.init(params)
    rng = np.random.default_rng(1)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 33)))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    clone = lambda t: tree_map(lambda x: x.clone(), t)
    ref_p, _, _, ref_m = build_train_step(
        cfg, optimizer=recording("ref"), microbatches=2)(
        clone(params), clone(state), 3, batch)
    mesh = make_host_mesh(mesh_shape[1], device="cpu")
    assert tuple(mesh.shape) == mesh_shape
    policy = ShardingPolicy(mesh)
    spec = policy.param_pspecs(cfg, params)
    step = build_train_step(cfg, optimizer=recording("sharded"),
                            microbatches=2, policy=policy)
    new_p, new_s, _, m = step(
        policy.distribute(params, spec),
        policy.distribute(state, policy.opt_pspecs(opt.name, spec, params)),
        3, batch)
    loss, ref = float(m["loss"]), float(ref_m["loss"])
    kinds = {type(t).__name__ for t in tree_leaves(new_s)}
    return dict(loss_rel=abs(loss - ref) / abs(ref),
                grad_rel=_rel_worst(to_local_tree(seen["sharded"]),
                                    seen["ref"]),
                param_rel=_rel_worst(to_local_tree(new_p), ref_p),
                state_kinds=sorted(kinds))


def _steps_worker(rank, out, cases):
    res = {name: _step_case(shape, ov, opt)
           for name, shape, ov, opt in cases}
    if rank == 0:
        torch.save(res, out)


# AdamW for the default layouts; for 6 query heads over 2 ranks (a rank's
# heads straddle KV groups: one KV head taken per query head) AdamW's
# first step turns gradient elements near its eps into updates of either
# sign, which the sharded sums' order alone can flip, so the gradients are
# held directly and the parameters after an SGD step
STEP_CASES = {
    "tp_dp": [("tp", (1, 2), {}, "adamw"), ("dp", (2, 1), {}, "adamw"),
              ("tp_adafactor", (1, 2), {}, "adafactor")],
    "gqa": [("mqa", (1, 2), {"num_kv_heads": 1}, "adamw"),
            ("kv3_of_6", (1, 2), {"num_heads": 6, "num_kv_heads": 3}, "sgd"),
            ("kv1_of_6", (1, 2), {"num_heads": 6, "num_kv_heads": 1}, "sgd")],
}


@pytest.mark.parametrize("group", list(STEP_CASES))
def test_sharded_train_step_matches_the_unsharded_step(group, tmp_path):
    out = tmp_path / "res.pt"
    _spawn(tmp_path, _steps_worker, str(out), STEP_CASES[group])
    res = torch.load(out)
    assert set(res) == {name for name, _, _, _ in STEP_CASES[group]}
    for name, r in res.items():
        assert r["loss_rel"] <= LOSS_REL, (name, r)
        assert r["grad_rel"] <= GRAD_REL, (name, r)
        assert r["param_rel"] <= PARAM_REL, (name, r)
        assert r["state_kinds"] == ["DTensor"], (name, r)


def _family_case(arch: str) -> dict:
    """Loss and every grad leaf of ``lm.train_loss`` of a reduced arch on a
    (1, 2) mesh against the same on plain tensors: (loss rel, worst grad
    leaf rel to its max |g|)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import ShardingPolicy, \
        to_local_tree
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import _grads, place_batch, sharded
    from repro_torch.models import lm

    cfg = get_config(arch).reduced()
    gen = torch.Generator()
    gen.manual_seed(0)
    params = lm.init_params(gen, cfg, device="cpu")
    rng = np.random.default_rng(2)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 9)))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.frontend:
        n = cfg.frontend_len if cfg.frontend == "vision" else 16
        batch["frontend"] = torch.as_tensor(
            rng.standard_normal((2, n, cfg.d_model)), dtype=torch.float32)
    ref_loss, _, ref_g = _grads(cfg, params, batch)
    policy = ShardingPolicy(make_host_mesh(2, device="cpu"))
    placed = policy.distribute(params, policy.param_pspecs(cfg, params))
    with sharded(policy):
        loss, _, g = _grads(cfg, placed, place_batch(policy, batch))
    loss = float(loss.full_tensor())
    return dict(loss_rel=abs(loss - float(ref_loss)) / abs(float(ref_loss)),
                grad_rel=_rel_worst(to_local_tree(g), ref_g))


def _decode_case() -> dict:
    """``decode_attention`` through ``api.local_decode`` on a (1, 2) mesh
    (heads over model; GQA with Kv 2 and MQA with a replicated cache
    sliced per rank; and a cache sharded along its slots, dense with the
    second slice partly and wholly past cache_len, a ring, a chunked ring,
    each rank on its slice merged by lse) against the op on plain
    tensors; and cache writes into the slot-sharded cache (one slot, then
    a permutation of every slot) equal to ``index_copy_`` on the whole."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed import api
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.launch.mesh import make_host_mesh

    policy = ShardingPolicy(make_host_mesh(2, device="cpu"))
    mesh = policy.mesh
    rng = np.random.default_rng(3)
    worst = 0.0
    with api.activation_policy(policy.activation_policy()):
        for kv, ring in ((2, False), (1, True)):
            q = torch.as_tensor(rng.standard_normal((2, 1, 4, 16)),
                                dtype=torch.float32)
            k, v = (torch.as_tensor(rng.standard_normal((2, 12, kv, 16)),
                                    dtype=torch.float32) for _ in range(2))
            want = decode_attention(q, k, v, 9, ring=ring)
            cache_pl = [Replicate(), Shard(2) if kv == 2 else Replicate()]
            got = api.local_decode(
                decode_attention,
                distribute_tensor(q, mesh, [Replicate()] * 2),
                distribute_tensor(k, mesh, cache_pl),
                distribute_tensor(v, mesh, cache_pl), 9, ring=ring)
            worst = max(worst, float((got.full_tensor() - want).abs().max()))
        seq = [Replicate(), Shard(1)]
        for clen, masks in ((9, {}), (5, {}), (30, dict(ring=True)),
                            (30, dict(ring=True, chunk_attn=8))):
            want = decode_attention(q, k, v, clen, **masks)
            got = api.local_decode(
                decode_attention,
                distribute_tensor(q, mesh, [Replicate()] * 2),
                distribute_tensor(k, mesh, seq),
                distribute_tensor(v, mesh, seq),
                torch.tensor(clen, dtype=torch.int32), **masks)
            worst = max(worst, float((got.full_tensor() - want).abs().max()))
        # cache writes into the slot-sharded cache: one slot on each rank's
        # side (a decode step's, its index a device tensor), then a ring
        # prefill's permutation of every slot
        cache = distribute_tensor(k.clone(), mesh, seq)
        plain = k.clone()
        for slot in (3, 10):
            new = torch.full((2, 1, 1, 16), float(slot))
            api.local_index_copy(cache, 1, torch.tensor([slot]), new)
            plain.index_copy_(1, torch.tensor([slot]), new)
        slots = torch.arange(18, 30) % 12
        new = torch.as_tensor(rng.standard_normal((2, 12, 1, 16)),
                              dtype=torch.float32)
        api.local_index_copy(cache, 1, slots, new)
        plain.index_copy_(1, slots, new)
        writes_equal = torch.equal(cache.full_tensor(), plain)
    return dict(max_abs=worst, writes_equal=writes_equal)


def _serve_case(arch: str) -> dict:
    """A prefill and one decode step of a reduced arch on a (1, 2) mesh
    (``build_prefill_step`` / ``build_decode_step`` with the policy: the
    cache placed by ``cache_pspecs``, written on each rank's shard) against
    the same steps on plain tensors: the worst logit difference rel to the
    largest logit."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (build_decode_step,
                                          build_prefill_step, place_batch)
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeSpec

    cfg = get_config(arch).reduced()
    gen = torch.Generator()
    gen.manual_seed(0)
    params = lm.init_params(gen, cfg, device="cpu")
    rng = np.random.default_rng(4)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 8)))
    front = ()
    if cfg.frontend:  # patch embeddings, or the encoder's source frames
        n = cfg.frontend_len if cfg.frontend == "vision" else 8
        front = (torch.as_tensor(rng.standard_normal((2, n, cfg.d_model)),
                                 dtype=torch.float32),)
    shape = ShapeSpec("serve", 16, 2, "prefill")
    logits, cache, *enc = build_prefill_step(cfg, shape)(params, tok, *front)
    nxt = logits.argmax(-1)[:, None]
    want, _ = build_decode_step(cfg, shape)(params, nxt, cache, 9, *enc)
    policy = ShardingPolicy(make_host_mesh(2, device="cpu"))
    placed = policy.distribute(params, policy.param_pspecs(cfg, params))
    got, d_cache, *d_enc = build_prefill_step(cfg, shape, policy=policy)(
        placed, place_batch(policy, {"t": tok})["t"], *front)
    step, _ = build_decode_step(cfg, shape, policy=policy)(
        placed, nxt, d_cache, 9, *d_enc)
    rel = lambda a, b: float((a.full_tensor() - b).abs().max()
                             / b.abs().max())
    return dict(prefill_rel=rel(got, logits), decode_rel=rel(step, want))


def _families_worker(rank, out, archs):
    res = {a: _family_case(a) for a in archs}
    if "llama4-scout-17b-a16e" in archs:
        res["decode_attention"] = _decode_case()
    res["serve"] = {a: _serve_case(a) for a in SERVED[archs]}
    if rank == 0:
        torch.save(res, out)


# every block family beside InternLM2's: MoE (the dispatch plan and the
# permutes per group, moe_gmm per rank's experts), the RG-LRU hybrid
# (rglru_scan per rank's channels), xLSTM (mLSTM and sLSTM), the
# encoder-decoder and the VLM
FAMILIES = [("llama4-scout-17b-a16e", "recurrentgemma-2b"),
            ("llava-next-34b", "seamless-m4t-medium"), ("xlstm-125m",)]
# the served archs each spawn also runs a prefill and a decode step of
SERVED = {FAMILIES[0]: ("internlm2-1.8b", "llama4-scout-17b-a16e",
                        "recurrentgemma-2b"),
          FAMILIES[1]: FAMILIES[1], FAMILIES[2]: FAMILIES[2]}


@pytest.mark.parametrize("archs", FAMILIES, ids=lambda a: "+".join(a))
def test_every_family_differentiates_tensor_parallel(archs, tmp_path):
    out = tmp_path / "res.pt"
    _spawn(tmp_path, _families_worker, str(out), archs)
    res = torch.load(out)
    decode = res.pop("decode_attention", None)
    serve = res.pop("serve", None)
    if "llama4-scout-17b-a16e" in archs:
        assert decode["max_abs"] <= 1e-6 and decode["writes_equal"], decode
    # RecurrentGemma's one KV head puts its cache on the sequence fallback:
    # its prefill writes and its decode steps run slice by slice
    assert len(serve) == len(SERVED[archs])
    for arch, r in serve.items():
        assert r["prefill_rel"] <= LOSS_REL, (arch, r)
        assert r["decode_rel"] <= LOSS_REL, (arch, r)
    assert set(res) == set(archs)
    for arch, r in res.items():
        assert r["loss_rel"] <= LOSS_REL, (arch, r)
        assert r["grad_rel"] <= GRAD_REL, (arch, r)


def _train_worker(rank, out):
    from repro_torch.launch.train import train

    losses = train("internlm2-1.8b", steps=2, batch=4, seq=32, tp=2,
                   microbatches=2, device="cpu", log_every=10)
    if rank == 0:
        torch.save(losses, out)


def test_train_entry_point_runs_tensor_parallel(tmp_path):
    from repro_torch.launch.train import train

    out = tmp_path / "losses.pt"
    _spawn(tmp_path, _train_worker, str(out))
    tp = torch.load(out)
    plain = train("internlm2-1.8b", steps=2, batch=4, seq=32, microbatches=2,
                  device="cpu", log_every=10)
    assert len(tp) == 2
    np.testing.assert_allclose(tp, plain, rtol=LOSS_REL)


def _grad_tree(rank: int) -> tuple[dict, dict]:
    """A rank's stand-in gradients (sizes off the 256-value blocks) and
    error feedback, from a seed."""
    rng = np.random.default_rng(10 + rank)
    g = {"a": rng.standard_normal((3, 300)).astype(np.float32),
         "b": [rng.standard_normal((17,)).astype(np.float32) * 1e-3,
               rng.standard_normal((4, 64, 8)).astype(np.float32)]}
    e = {"a": rng.standard_normal((3, 300)).astype(np.float32) * 1e-3,
         "b": [np.zeros((17,), np.float32),
               rng.standard_normal((4, 64, 8)).astype(np.float32) * 1e-3]}
    return g, e


def _psum_worker(rank, out):
    from repro_torch.optim.grad_compression import compressed_psum
    from repro_torch.optim.optimizers import tree_map

    g, e = _grad_tree(rank)
    red, err = compressed_psum(tree_map(torch.from_numpy, g),
                               tree_map(torch.from_numpy, e))
    torch.save((red, err), out + f".{rank}")


def test_compressed_psum_on_two_ranks_matches_jax_compress_tree(tmp_path):
    import jax
    import jax.numpy as jnp

    from repro.optim import grad_compression as jgc

    out = str(tmp_path / "psum")
    _spawn(tmp_path, _psum_worker, out)
    n = 2
    comps, errs = [], []
    for r in range(n):
        g, e = _grad_tree(r)
        c, ne = jgc.compress_tree(jax.tree.map(jnp.asarray, g),
                                  jax.tree.map(jnp.asarray, e))
        comps.append(c)
        errs.append(ne)
    is_rec = lambda x: isinstance(x, dict) and set(x) == {"q", "s"}
    like = _grad_tree(0)[0]

    def reduce(like_leaf, *cs):
        q32 = sum(np.asarray(c["q"]).astype(np.int32) for c in cs)
        s = sum(np.asarray(c["s"]) for c in cs) / np.float32(n)
        full = (q32.astype(np.float32) * s[:, None]).reshape(-1)
        return full[:like_leaf.size].reshape(like_leaf.shape) / np.float32(n)

    want = jax.tree.map(reduce, like, *comps,
                        is_leaf=lambda x: is_rec(x) or isinstance(
                            x, np.ndarray))
    flat_want = jax.tree.leaves(want)
    for r in range(n):
        red, err = torch.load(f"{out}.{r}")
        got = [red["a"], *red["b"]]
        assert len(got) == len(flat_want)
        for a, b in zip(got, flat_want):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), b)
        for a, b in zip([err["a"], *err["b"]], jax.tree.leaves(errs[r])):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _reshard_worker(rank, ckpt_dir, out):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.distributed.fault_tolerance import reshard_restore
    from repro_torch.distributed.sharding import map_specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import params_sds
    from repro_torch.models import lm
    from repro_torch.optim import adamw, constant_schedule
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    cfg = get_config("xlstm-125m").reduced()
    gen = torch.Generator()
    gen.manual_seed(0)
    params = lm.init_params(gen, cfg, device="cpu")
    opt = adamw(constant_schedule(1e-3))
    state = tree_map(lambda t: t + 0.5, opt.init(params))
    if rank == 0:
        Checkpointer(ckpt_dir).save(3, (params, state))
    dist.barrier()
    mesh = make_host_mesh(2, device="cpu")
    p_like = params_sds(cfg)
    step, p, s, policy = reshard_restore(
        Checkpointer(ckpt_dir), (p_like, opt.init(p_like)), mesh, cfg,
        "adamw")
    spec = policy.param_pspecs(cfg, p_like)
    placed = [tuple(t.placements) for t in tree_leaves(p)]
    want_pl = []
    map_specs(lambda x: want_pl.append(policy.placements(x)), spec)
    equal = all(torch.equal(a.full_tensor(), b) for a, b in
                zip(tree_leaves(p) + tree_leaves(s),
                    tree_leaves(params) + tree_leaves(state)))
    sharded = sum(any(pl.is_shard() for pl in t.placements)
                  for t in tree_leaves(p))
    # a save of the DTensors: every rank gathers, rank 0 writes
    Checkpointer(ckpt_dir + "_again").save(4, (p, s))
    dist.barrier()
    _, back = Checkpointer(ckpt_dir + "_again").restore((params, state))
    again = all(torch.equal(a, b) for a, b in
                zip(tree_leaves(list(back)), tree_leaves([params, state])))
    if rank == 0:
        torch.save(dict(step=step, equal=equal, again=again,
                        placed=placed == want_pl, sharded=sharded), out)


def test_reshard_restore_is_bit_equal(tmp_path):
    out = tmp_path / "res.pt"
    _spawn(tmp_path, _reshard_worker, str(tmp_path / "ckpt"), str(out))
    res = torch.load(out)
    assert res == dict(step=3, equal=True, again=True, placed=True,
                       sharded=res["sharded"])
    assert res["sharded"] > 0  # the (1, 2) mesh splits some leaves


def test_pod_monitor_heartbeats():
    from repro_torch.distributed.fault_tolerance import PodMonitor

    mon = PodMonitor(n_pods=2, max_missed=2)
    assert mon.beat({0, 1}) == set()
    assert mon.beat({0}) == set()
    assert mon.beat({0}) == {1}
    assert mon.alive == [0]
    assert mon.beat(set()) == set()  # pod 0 misses once: still alive
    assert mon.alive == [0]


SURVIVOR = """
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.distributed.fault_tolerance import survivor_mesh, \\
    survivor_ranks
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = init_device_mesh("cpu", (2, 2, 1),
                        mesh_dim_names=("pod", "data", "model"))
names = mesh.mesh_dim_names
for alive, want in (([1], [[[2], [3]]]), ([0], [[[0], [1]]]),
                    ([0, 1], [[[0], [1]], [[2], [3]]])):
    ranks = survivor_ranks(mesh.mesh, names, "pod", alive)
    assert ranks.tolist() == want, (alive, ranks)
    sub = survivor_mesh(mesh.mesh, names, "pod", alive, device_type="cpu")
    assert sub.mesh.tolist() == want and sub.mesh_dim_names == names
    assert tuple(sub.shape) == (len(alive), 2, 1)
from repro_torch.launch.mesh import make_production_mesh, required_devices
for multi in (False, True):
    try:
        make_production_mesh(multi_pod=multi, device="cpu")
        raise AssertionError("a world of 4 built a production mesh")
    except RuntimeError:
        pass
dist.destroy_process_group()
for multi in (False, True):
    n = required_devices(multi)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    prod = make_production_mesh(multi_pod=multi, device="cpu")
    assert tuple(prod.shape) == ((2, 16, 16) if multi else (16, 16))
    assert prod.mesh_dim_names == (("pod", "data", "model") if multi
                                   else ("data", "model"))
    dist.destroy_process_group()
print("ok")
"""


def test_survivor_and_production_meshes_on_fake_worlds():
    proc = subprocess.run([sys.executable, "-c", SURVIVOR],
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ,
                               "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
