"""The port's dry run (``launch/dryrun.py``), its collective count
(``perf/hlo_analysis.py``) and the kernels' shape routes, on the CPU.

* ``CollectiveOp.wire_bytes`` equals the JAX package's for every kind at
  group sizes 1, 2, 16 and 256.
* On a fake world of 256 ranks (16 x 16), the probe program ``x @ w`` with
  x (64, 4096) on ``[Shard(0), Shard(1)]`` and w (4096, 4096) on
  ``[Replicate(), Shard(0)]``, brought to ``[Shard(0), Replicate()]``:
  rank 0 runs one local (4, 256) @ (256, 4096) product, 8 388 608 FLOPs
  (``FlopCounterMode`` around the DTensor program counts the global
  2 147 483 648), and one all-reduce of 4 x 4096 bf16 over 16 ranks.
  In the same subprocess the full-width cell ``internlm2-1.8b x decode_32k``
  traces ``ok``; its KV cache on rank 0 is 2 x 24 x 128 x 32 768 x 8 x 128
  x 2 / 256 bytes (B over data, the slots over model: 8 KV heads do not
  split 16 ways).
* Every shape route under ``FakeTensorMode`` gives the shapes and dtypes
  the plain route gives on real CPU tensors, refuses what the card
  kernel's contract refuses, and reports ``kernel.cost``.
* ``decode_attention_ref`` on slices of a cache (``slot0`` / ``slots``),
  merged by lse, equals the JAX package's ``decode_attention_xla`` on the
  whole cache within 1e-5: dense, ring, chunked ring, and a slice wholly
  past ``cache_len``.
* ``run_cell`` on reduced configs on a fake (2, 2) world: the ``train``
  and ``decode`` kinds trace ``ok`` and reach their kernels' shape routes;
  the reduced InternLM2 train cell's rank-0 ``argument_bytes`` equals the
  local shard bytes of the JAX package's specs (parameters, AdamW state,
  batch).  Tier-1 runs the dense and the hybrid family (the attention
  kernels, the scan, the slot-sharded cache; the MoE kernel's shape routes
  are held above); the sweep of every arch, ~80 s (xLSTM's first trace
  alone ~35 s), is ``slow``.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels import common
from repro_torch.kernels.decode_attention import kernel as decode_kernel
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
from repro_torch.kernels.moe_gmm.ops import moe_gmm
from repro_torch.kernels.rglru_scan import kernel as scan_kernel
from repro_torch.kernels.rglru_scan.ops import rglru_scan_op
from repro_torch.perf.hlo_analysis import CollectiveOp

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
         "ragged-all-to-all", "collective-permute", "collective-broadcast")


def _run(code: str, *argv: str, timeout: int = 300) -> dict:
    """``code`` in a fresh interpreter (a fake world is one per process);
    its last stdout line is JSON."""
    proc = subprocess.run([sys.executable, "-c", code, *argv],
                          capture_output=True,
                          text=True, timeout=timeout,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("n", [1, 2, 16, 256])
@pytest.mark.parametrize("kind", KINDS)
def test_wire_bytes_match_jax(kind, n):
    from repro.perf.hlo_analysis import CollectiveOp as JaxCollectiveOp

    for nbytes in (0, 2, 32768, 3 * 10 ** 9):
        assert CollectiveOp(kind, nbytes, n).wire_bytes == \
            JaxCollectiveOp(kind, nbytes, n).wire_bytes


FAKE_256 = """
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch.dryrun import (DeviceCounter, host_bookkeeping,
                                       local_arguments, run_cell, _storage_bytes)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_step
from repro_torch.distributed.sharding import ShardingPolicy
from repro_torch import configs
torch.set_num_threads(1)
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
mesh = make_production_mesh(device="cpu")
fake = FakeTensorMode()
with fake:
    xl = torch.empty(4, 256, dtype=torch.bfloat16)
    wl = torch.empty(256, 4096, dtype=torch.bfloat16)
x = DTensor.from_local(xl, mesh, [Shard(0), Shard(1)], run_check=False,
                       shape=(64, 4096), stride=(4096, 1))
w = DTensor.from_local(wl, mesh, [Replicate(), Shard(0)], run_check=False,
                       shape=(4096, 4096), stride=(4096, 1))
c = DeviceCounter()
with host_bookkeeping(c), fake, c:
    y = (x @ w).redistribute(mesh, [Shard(0), Replicate()])
out = dict(flops=c.flops, records=[[r.kind, r.result_bytes, r.group_size]
                                   for r in c.records],
           by_kind=c.by_kind(), local=list(y.to_local().shape))
# a Shard -> Shard redistribute (the card's all-to-all, not gloo's
# all-gather fallback) and compressed_psum's explicit all-reduces
from repro_torch.optim.grad_compression import compressed_psum
with fake:
    zl = torch.empty(4, 4096, dtype=torch.bfloat16)
z = DTensor.from_local(zl, mesh, [Shard(0), Replicate()], run_check=False,
                       shape=(64, 4096), stride=(4096, 1))
c = DeviceCounter()
with host_bookkeeping(c), fake, c:
    z.redistribute(mesh, [Shard(1), Replicate()])
    g = {"a": torch.empty(3, 300)}
    compressed_psum(g, {"a": torch.empty(3, 300)})
out["more"] = [[r.kind, r.result_bytes, r.group_size] for r in c.records]
cfg = configs.get_config("internlm2-1.8b")
rec = run_cell("internlm2-1.8b", "decode_32k", mesh, verbose=False)
bundle = build_step(cfg, ShardingPolicy(mesh, sequence_parallel=True),
                    "decode_32k")
args = local_arguments(bundle, mesh, FakeTensorMode())
out.update(status=rec["status"], memory=rec["memory"],
           kernels=rec["kernels"], collectives=rec["collectives"],
           cache_bytes=sum(n for _, n in _storage_bytes(args[2]).values()),
           cache_placements=sorted({str(tuple(t.placements)) for t in
                                    args[2]["units"]["b0"].values()}))
print(json.dumps(out))
"""


def test_probe_and_full_width_decode_on_a_256_rank_world():
    res = _run(FAKE_256)
    assert res["records"] == [["all-reduce", 32768, 16]]
    assert res["by_kind"] == {"all-reduce": {
        "count": 1, "wire_bytes": 2 * 32768 * 15 / 16,
        "result_bytes": 32768.0}}
    assert res["flops"] == 8_388_608 == 2 * 4 * 256 * 4096
    assert res["local"] == [4, 4096]
    # z (64, 4096) from [Shard(0), Replicate()] to [Shard(1), Replicate()]:
    # one all-to-all over data of the local (64, 256) bf16 result;
    # compressed_psum: the int32 codes (900 values in 256-value blocks:
    # 1024) and the fp32 scales (4 blocks), over the world
    assert res["more"] == [["all-to-all", 64 * 256 * 2, 16],
                           ["all-reduce", 1024 * 4, 256],
                           ["all-reduce", 4 * 4, 256]], res["more"]
    assert res["status"] == "ok"
    assert res["cache_bytes"] == 2 * 24 * 128 * 32768 * 8 * 128 * 2 // 256 \
        == 1_610_612_736
    # the stacked (units, B, W, Kv, hd) leaves: B over data, the slots over
    # model
    assert res["cache_placements"] == ["(Shard(dim=1), Shard(dim=2))"]
    # the cache is updated in place: the aliased outputs are exactly it
    assert res["memory"]["alias_bytes"] == res["cache_bytes"]
    # every layer's decode on its slice through the lse twin, merged by
    # two all-reduces over the 16 model ranks
    assert res["kernels"]["decode_attention_lse"]["count"] == 24
    assert res["collectives"]["all-reduce"]["count"] >= 48


def _shape_and_plain(fn, *shapes_dtypes, grad=False):
    """``fn`` on real CPU tensors (the plain route) and on fake tensors of
    the same shapes (the shape route): the outputs' (shape, dtype) from
    each, and the shape route's kernel reports."""
    gen = torch.Generator().manual_seed(0)
    real = [torch.randn(s, generator=gen).to(dt).requires_grad_(grad)
            for s, dt in shapes_dtypes]
    reports = []
    plain = [t.detach() for t in real]
    with FakeTensorMode() as mode, common.kernel_costs(
            lambda *r: reports.append(r)):
        fake = [mode.from_tensor(t).requires_grad_(grad) for t in plain]
        got = fn(*fake)
        got = got if isinstance(got, tuple) else (got,)
        meta = [(tuple(t.shape), t.dtype) for t in got]
    want = fn(*real)
    want = want if isinstance(want, tuple) else (want,)
    assert meta == [(tuple(t.shape), t.dtype) for t in want]
    return reports


bf16, f32 = torch.bfloat16, torch.float32
MASKS = dict(causal=True, window=0, chunk_attn=0)


@pytest.mark.parametrize("dt", [bf16, f32])
def test_flash_shape_routes(dt):
    B, S, H, Kv, hd = 2, 48, 4, 2, 32
    shapes = (((B, S, H, hd), dt), ((B, S, Kv, hd), dt), ((B, S, Kv, hd), dt))
    rep = _shape_and_plain(lambda q, k, v: flash_attention(q, k, v, **MASKS),
                           *shapes)
    assert rep == [("flash_attention", *flash_kernel.cost(
        B, S, S, H, Kv, hd, dt.itemsize, **MASKS))]

    def train(q, k, v):
        out = flash_attention(q, k, v, **MASKS)
        return torch.autograd.grad(out.float().square().sum(), (q, k, v))

    rep = _shape_and_plain(train, *shapes, grad=True)
    assert rep == [
        ("flash_attention_lse", *flash_kernel.cost(
            B, S, S, H, Kv, hd, dt.itemsize, **MASKS, with_lse=True)),
        ("flash_attention_bwd", *flash_kernel.cost_bwd(
            B, S, S, H, Kv, hd, dt.itemsize, **MASKS))]


@pytest.mark.parametrize("dt", [bf16, f32])
def test_decode_shape_routes(dt):
    B, W, H, Kv, hd = 2, 40, 4, 2, 16
    shapes = (((B, 1, H, hd), dt), ((B, W, Kv, hd), dt), ((B, W, Kv, hd), dt))
    rep = _shape_and_plain(lambda q, k, v: decode_attention(
        q, k, v, 30, ring=True), *shapes)
    assert rep == [("decode_attention", *decode_kernel.cost(
        B, H, Kv, hd, W, dt.itemsize))]
    rep = _shape_and_plain(lambda q, k, v: decode_attention(
        q, k, v, 30, slot0=40, slots=80, return_lse=True), *shapes)
    assert rep == [("decode_attention_lse", *decode_kernel.cost(
        B, H, Kv, hd, W, dt.itemsize, with_lse=True))]


@pytest.mark.parametrize("dt", [bf16, f32])
def test_moe_gmm_shape_routes(dt):
    E, C, D, F = 3, 10, 32, 24
    shapes = (((E, C, D), dt), ((E, D, F), dt))
    rep = _shape_and_plain(moe_gmm, *shapes)
    assert rep == [("moe_gmm", *gmm_kernel.cost(E, C, D, F, dt.itemsize))]
    rep = _shape_and_plain(lambda x, w: torch.autograd.grad(
        moe_gmm(x, w).float().sum(), (x, w)), *shapes, grad=True)
    assert rep == [("moe_gmm", *gmm_kernel.cost(E, C, D, F, dt.itemsize)),
                   ("moe_gmm_bwd", *gmm_kernel.cost_bwd(E, C, D, F,
                                                        dt.itemsize))]


@pytest.mark.parametrize("dt", [bf16, f32])
def test_rglru_scan_shape_routes(dt):
    B, S, R = 2, 70, 36
    shapes = (((B, S, R), dt), ((B, S, R), dt), ((B, R), f32))
    rep = _shape_and_plain(rglru_scan_op, *shapes)
    assert rep == [("rglru_scan", *scan_kernel.cost(B, S, R, dt.itemsize))]
    rep = _shape_and_plain(lambda a, x, h0: torch.autograd.grad(
        rglru_scan_op(a, x, h0).sum(), (a, x, h0)), *shapes, grad=True)
    assert rep == [("rglru_scan", *scan_kernel.cost(B, S, R, dt.itemsize)),
                   ("rglru_scan_bwd", *scan_kernel.cost_bwd(B, S, R,
                                                            dt.itemsize))]


@pytest.mark.parametrize("call,match", [
    # the attention kernels' contract: head_dim a multiple of 16, one dtype
    (lambda: flash_attention(*(torch.empty(1, 8, 2, 20) for _ in range(3))),
     "head_dim"),
    (lambda: flash_attention(torch.empty(1, 8, 2, 16),
                             *(torch.empty(1, 8, 2, 16, dtype=bf16)
                               for _ in range(2))), "one dtype"),
    (lambda: decode_attention(torch.empty(1, 1, 4, 16, dtype=torch.float16),
                              *(torch.empty(1, 8, 2, 16,
                                            dtype=torch.float16)
                                for _ in range(2)), 3), "one dtype"),
    # shapes the kernels cannot take: the plain versions fail on them too
    (lambda: flash_attention(torch.empty(1, 8, 3, 16),
                             *(torch.empty(1, 8, 2, 16) for _ in range(2))),
     "do not fit"),
    (lambda: moe_gmm(torch.empty(2, 4, 8), torch.empty(3, 8, 8)),
     "do not fit"),
    (lambda: rglru_scan_op(torch.empty(1, 4, 8), torch.empty(1, 4, 9),
                           torch.empty(1, 8)), "do not fit"),
    # a slice of a cache needs the twin; slots beyond the cache are refused
    (lambda: decode_attention(*(torch.empty(1, 1, 2, 16),) + tuple(
        torch.empty(1, 8, 2, 16) for _ in range(2)), 3, slot0=8, slots=16),
     "return_lse"),
    (lambda: decode_attention(*(torch.empty(1, 1, 2, 16, dtype=bf16),) + tuple(
        torch.empty(1, 8, 2, 16, dtype=bf16) for _ in range(2)), 3, slot0=12,
        slots=16, return_lse=True), "outside"),
])
def test_shape_routes_refuse_what_the_card_refuses(call, match):
    """On fake tensors the card kernel's contract is checked as on the
    card, before any output is made."""
    with FakeTensorMode(), pytest.raises((ValueError, TypeError),
                                         match=match):
        call()


def test_use_kernel_answers_by_tensor_kind():
    t = torch.zeros(2)
    assert common.use_kernel(t) is False
    with FakeTensorMode() as mode:
        f = mode.from_tensor(t)
        assert common.use_kernel(f, f) == common.SHAPE
        with pytest.raises(ValueError, match="fake and real"):
            common.use_kernel(f, t)


SPLIT_CASES = [  # (W, cache_len, ring, chunk_attn)
    (24, 17, False, 0),   # dense, the last slices partly or wholly past
    (24, 5, False, 0),    # dense, most slices wholly past cache_len
    (24, 61, True, 0),    # a ring wrapped twice
    (16, 23, True, 6),    # a chunked ring
]


@pytest.mark.parametrize("W,clen,ring,chunk", SPLIT_CASES)
@pytest.mark.parametrize("ways", [2, 4])
def test_decode_slices_merged_equal_jax(W, clen, ring, chunk, ways):
    import jax.numpy as jnp

    from repro.models.layers import decode_attention_xla
    from repro_torch.kernels.common import NEG_INF
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_lse_ref

    rng = np.random.default_rng(W + clen + ways)
    B, H, Kv, hd = 2, 6, 2, 16
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, W, Kv, hd)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(decode_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(clen),
        ring=ring, chunk_attn=chunk))
    w = W // ways
    outs, lses = [], []
    for r in range(ways):
        o, lse = decode_attention_lse_ref(
            torch.from_numpy(q), torch.from_numpy(k[:, r * w:(r + 1) * w]),
            torch.from_numpy(v[:, r * w:(r + 1) * w]), clen, ring=ring,
            chunk_attn=chunk, slot0=r * w, slots=W)
        if not ring and r * w >= clen:  # wholly past: 0 and NEG_INF
            assert o.abs().max() == 0 and bool((lse == NEG_INF).all())
        outs.append(o)
        lses.append(lse)
    lse = torch.stack(lses)
    wts = torch.exp(lse - lse.max(0).values)[..., None]
    merged = sum(wt[:, None] * o for wt, o in zip(wts, outs)) \
        / wts.sum(0)[:, None]
    np.testing.assert_allclose(merged.numpy(), want, rtol=0, atol=1e-5)
    # the whole cache as one slice: the plain op, and its lse
    whole, lse_whole = decode_attention_lse_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), clen,
        ring=ring, chunk_attn=chunk)
    np.testing.assert_allclose(whole.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(torch.logsumexp(lse, 0).numpy(),
                               lse_whole.numpy(), rtol=0, atol=1e-5)


REDUCED = """
import json, sys, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import configs
from repro_torch.models.config import ShapeSpec
from repro_torch.launch.dryrun import run_cell
torch.set_num_threads(1)
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
out = {}
for arch in sys.argv[1].split(","):
    cfg = configs.get_config(arch).reduced()
    for spec in (ShapeSpec("train_small", 8, 4, "train"),
                 ShapeSpec("decode_small", 16, 4, "decode")):
        r = run_cell(arch, spec, mesh, cfg=cfg, verbose=False)
        out[arch + "/" + spec.kind] = dict(
            status=r["status"], memory=r["memory"], step=r["step"],
            flops=r["cost"]["flops_per_device"],
            kernels=sorted(r["kernels"]))
print(json.dumps(out))
"""


def _jax_argument_bytes(arch: str, mesh: dict, B: int, S: int) -> int:
    """Rank 0's bytes of a reduced train cell's arguments (parameters,
    optimizer state, batch) from the JAX package's specs: each leaf's size
    over the mesh axes its spec names (the policy only names axes that
    divide)."""
    import jax

    from repro import configs as jax_configs
    from repro.distributed.sharding import ShardingPolicy as JaxPolicy
    from repro.launch.steps import default_optimizer, params_sds

    class FakeMesh:
        def __init__(self, shape):
            self.shape = dict(shape)
            self.axis_names = tuple(shape)

    cfg = jax_configs.get_config(arch).reduced()
    policy = JaxPolicy(FakeMesh(mesh))
    p_sds = params_sds(cfg)
    opt = default_optimizer(cfg)
    p_spec = policy.param_pspecs(cfg, p_sds)
    o_sds = jax.eval_shape(opt.init, p_sds)
    o_spec = policy.opt_pspecs(opt.name, p_spec, p_sds)

    def local_bytes(sds, spec):
        n = sds.dtype.itemsize
        parts = list(spec) + [None] * (len(sds.shape) - len(spec))
        for dim, entry in zip(sds.shape, parts):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            n *= dim // math.prod(mesh[a] for a in axes)
        return n

    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)
    total = 0
    for sds_tree, spec_tree in ((p_sds, p_spec), (o_sds, o_spec)):
        specs = jax.tree.leaves(spec_tree, is_leaf=is_spec)
        leaves = jax.tree.leaves(sds_tree)
        assert len(specs) == len(leaves)
        total += sum(local_bytes(a, s) for a, s in zip(leaves, specs))
    tokens = jax.ShapeDtypeStruct((B, S), np.int32)
    return total + 2 * local_bytes(tokens, policy.data_pspec((B, S)))


FAMILIES = ("internlm2-1.8b", "recurrentgemma-2b")
# the kernels each family's step reaches, by their shape routes
KERNELS = {
    "internlm2-1.8b/train": ["flash_attention_bwd", "flash_attention_lse"],
    "internlm2-1.8b/decode": ["decode_attention"],
    "llama4-scout-17b-a16e/train": ["flash_attention_bwd",
                                    "flash_attention_lse", "moe_gmm",
                                    "moe_gmm_bwd"],
    "recurrentgemma-2b/train": ["flash_attention_bwd", "flash_attention_lse",
                                "rglru_scan", "rglru_scan_bwd"],
    # one KV head over 2 model ranks: the cache is cut along its slots
    "recurrentgemma-2b/decode": ["decode_attention_lse"],
    "xlstm-125m/decode": [],
}


@pytest.mark.parametrize("archs", [
    FAMILIES,
    pytest.param(None, marks=pytest.mark.slow, id="every-arch")],
    ids=lambda a: "+".join(a) if a else "every-arch")
def test_reduced_cells_on_a_2x2_world(archs):
    from repro_torch import configs

    archs = archs or configs.ALL_ARCHS
    res = _run(REDUCED, ",".join(archs), timeout=600)
    assert set(res) == {f"{a}/{k}" for a in archs
                        for k in ("train", "decode")}
    for cell, r in res.items():
        assert r["status"] == "ok" and r["step"] == cell.split("/")[1], cell
        assert r["flops"] > 0, cell
        if cell in KERNELS:
            assert r["kernels"] == KERNELS[cell], (cell, r["kernels"])
    assert res["internlm2-1.8b/train"]["memory"]["argument_bytes"] == \
        _jax_argument_bytes("internlm2-1.8b", {"data": 2, "model": 2}, 4, 8)
