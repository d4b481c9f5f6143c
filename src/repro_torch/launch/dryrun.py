"""Multi-pod dry run: trace every (architecture x input shape x mesh) cell on
the production meshes, on the host, with no card and no memory for the
model.

The JAX package's ``launch/dryrun.py`` lowers and compiles each cell's
step under a 256- or 512-device host mesh and reads XLA's memory and cost
analyses and the collectives of the partitioned HLO.  The port has no
compiler to ask, so it runs the step once as rank 0 of a fake world:

  1. a ``torch.distributed`` world of 256 (16 x 16) or 512 (2 x 16 x 16)
     ranks on the ``fake`` backend (``torch.testing._internal.distributed.
     fake_pg``), whose collectives return at once, and the production mesh
     over it (``launch/mesh.py``);
  2. ``build_step(cfg, policy, shape)``; each argument becomes a DTensor on
     its placements, built from rank 0's local shard as a fake tensor
     (``FakeTensorMode``: shapes and dtypes, no storage), so that no global
     tensor is ever made (Kimi-K2 has about 1 T parameters);
  3. one call of the step under ``FakeTensorMode`` and ``DeviceCounter``,
     a ``TorchDispatchMode`` that sees the local ops rank 0 runs (DTensor
     ops are handed back to DTensor, which lowers them to local ops and
     collectives), and counts their FLOPs (``torch.utils.flop_counter``'s
     formulas), the bytes they read and write, the live bytes, and each
     collective (``perf/hlo_analysis.py``).  The hand-written kernels take
     their shape route on fake tensors (``kernels/common.py: use_kernel``)
     and report the work of the card kernel (``kernel.cost``).

The report keeps the reference's keys where their meaning carries over
(``memory`` on rank 0, ``cost`` per device, ``collectives`` by kind, which
``perf/roofline.py: full_table`` reads); ``trace_s``, the seconds of the
traced call, replaces ``lower_s`` and ``compile_s``.  FLOPs and bytes are
counts of the eager program on the host, not card measurements: bytes are
every non-view op's inputs read and outputs written (no fusion), and each
kernel's count is its ``kernel.cost``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single   # 16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi    # 2x16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \
      --shape train_4k
  ... --report reports/dryrun_all.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing
import os
import time
import traceback
import weakref
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils.flop_counter import flop_registry

from repro_torch import configs as cfglib
from repro_torch.distributed import api
from repro_torch.distributed.sharding import ShardingPolicy
from repro_torch.kernels import common
from repro_torch.launch.mesh import make_production_mesh, required_devices
from repro_torch.launch.steps import build_step
from repro_torch.models.config import ModelConfig
from repro_torch.perf.hlo_analysis import CollectiveRecorder

SKIP_REASON = "full-attention arch; 500k dense KV infeasible (DESIGN.md)"


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for t in x:
            yield from _tensors(t)
    elif isinstance(x, dict):
        for t in x.values():
            yield from _tensors(t)


def _storage_bytes(ts) -> dict:
    """{id(storage): (storage, nbytes)} of the distinct storages under
    ``ts`` (a DTensor counts its local shard)."""
    out = {}
    for t in _tensors(ts):
        st = (t.to_local() if hasattr(t, "to_local") else t).untyped_storage()
        out[id(st)] = (st, st.nbytes())
    return out


class DeviceCounter(CollectiveRecorder):
    """One rank's work in a traced step: FLOPs and bytes of every local op
    (``kernel`` adds a hand-written kernel's own count), the live bytes
    and their peak, and the collectives.  ``paused`` work (DTensor's own
    bookkeeping: the global-shape op it runs to infer an output's shape)
    is not the rank's and is not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.kernels: dict[str, dict] = {}
        self.paused = 0
        self._live: dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    def kernel(self, name: str, flops: int, nbytes: int) -> None:
        if self.paused:
            return
        k = self.kernels.setdefault(name, {"count": 0, "flops": 0,
                                           "bytes": 0})
        k["count"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(nbytes)
        self.flops += int(flops)
        self.bytes += int(nbytes)

    def hold(self, st) -> None:
        """Count storage ``st`` as live until it is freed."""
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def observe(self, func, args, kwargs, out) -> None:
        if self.paused:
            return
        super().observe(func, args, kwargs, out)
        outs = list(_tensors(out))
        if not outs or any(t.device.type == "meta" for t in outs):
            return  # no result, or shape stand-ins (a new cache's shapes)
        for t in outs:
            self.hold(t.untyped_storage())
        pk = func._overloadpacket
        if pk in flop_registry:
            self.flops += int(flop_registry[pk](*args, **kwargs,
                                                out_val=out))
        name = func._schema.name
        if func.is_view or name.startswith("aten::empty") or \
                name == "_c10d_functional::wait_tensor":
            return
        self.bytes += sum(t.numel() * t.element_size()
                          for t in _tensors((args, kwargs, out)))


@contextlib.contextmanager
def _paused(counter: DeviceCounter):
    counter.paused += 1
    try:
        yield
    finally:
        counter.paused -= 1


@contextlib.contextmanager
def host_bookkeeping(counter: DeviceCounter):
    """DTensor's bookkeeping outside the count, and on real tensors.

    * To infer an output's global shape DTensor runs the op once on fake
      global tensors (``ShardingPropagator._propagate_tensor_meta_non_cached``);
      that op is no rank's work, so the counter pauses.
    * A ``_StridedShard``'s local size and offset come from an index tensor
      it builds and reads back (``.tolist()``), which fails on a fake
      tensor; it runs with the fake mode unset (and uncounted).
    * A ``Shard(a) -> Shard(b)`` redistribute is an all-to-all on the
      card's NCCL mesh, but on a CPU mesh DTensor falls back to an
      all-gather and a chunk (gloo has no all-to-all); the dry run's mesh
      takes the card's collective (a fake world runs no collective).
    """
    import torch.distributed._functional_collectives as funcol
    import torch.distributed.tensor.placement_types as placement_types
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard

    meta = ShardingPropagator._propagate_tensor_meta_non_cached
    strided = _StridedShard.local_shard_size_and_offset

    def meta_paused(self, *a, **kw):
        with _paused(counter):
            return meta(self, *a, **kw)

    def strided_real(*a, **kw):
        with _paused(counter), unset_fake_temporarily():
            return strided(*a, **kw)

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = funcol._resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, funcol._group_or_group_name(group))

    to_all = placement_types.shard_dim_alltoall
    ShardingPropagator._propagate_tensor_meta_non_cached = meta_paused
    _StridedShard.local_shard_size_and_offset = strided_real
    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = meta
        _StridedShard.local_shard_size_and_offset = strided
        placement_types.shard_dim_alltoall = to_all


def local_arguments(bundle, mesh, fake_mode) -> tuple:
    """``bundle.args_sds`` as DTensors on ``bundle.in_placements``, each
    from rank 0's local shard, a fake tensor of the shard's shape (a
    non-tensor argument, the step count, passes through)."""
    from torch.distributed.tensor import DTensor

    def place(t, pl):
        if isinstance(t, dict):
            return {k: place(t[k], pl[k]) for k in t}
        if isinstance(t, list):
            return [place(a, p) for a, p in zip(t, pl)]
        if not isinstance(t, torch.Tensor):
            return t
        shape = api.local_shape(mesh, pl, t.shape)
        with fake_mode:
            local = torch.empty(shape, dtype=t.dtype)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())

    return tuple(place(a, p) for a, p in zip(bundle.args_sds,
                                             bundle.in_placements))


def run_cell(arch: str, shape_name, mesh, *, verbose: bool = True,
             sequence_parallel: bool = True,
             cfg: Optional[ModelConfig] = None) -> dict:
    """Trace one cell on ``mesh`` (a ``DeviceMesh`` over a fake world) and
    return its record.  ``cfg`` replaces ``get_config(arch)`` and
    ``shape_name`` may be a ``ShapeSpec`` (the tests' reduced cells)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = cfg or cfglib.get_config(arch)
    spec = cfglib.resolve_shape(shape_name)
    if not cfg.supports_shape(spec):
        return {"arch": arch, "shape": spec.name, "status": "skip",
                "reason": SKIP_REASON}

    policy = ShardingPolicy(mesh, sequence_parallel=sequence_parallel)
    t0 = time.time()
    bundle = build_step(cfg, policy, spec)
    fake_mode = FakeTensorMode()
    counter = DeviceCounter()
    args = local_arguments(bundle, mesh, fake_mode)
    arg_st = _storage_bytes(args)
    for st, _ in arg_st.values():
        counter.hold(st)
    base = counter.live_bytes
    counter.peak_bytes = base
    with host_bookkeeping(counter), fake_mode, counter, \
            common.kernel_costs(counter.kernel):
        out = bundle.fn(*args)
    trace_s = time.time() - t0
    out_st = _storage_bytes(out)
    memory = {
        "argument_bytes": sum(n for _, n in arg_st.values()),
        "output_bytes": sum(n for _, n in out_st.values()),
        "temp_bytes": counter.peak_bytes - base,
        "alias_bytes": sum(n for k, (_, n) in out_st.items()
                           if k in arg_st),
    }
    names = tuple(mesh.mesh_dim_names)
    result = {
        "arch": arch,
        "shape": spec.name,
        "status": "ok",
        "mesh": dict(zip(names, tuple(mesh.shape))),
        "step": bundle.name.split(":")[0],
        "trace_s": round(trace_s, 1),
        "memory": memory,
        "cost": {"flops_per_device": float(counter.flops),
                 "bytes_per_device": float(counter.bytes)},
        "collectives": counter.by_kind(),
        "kernels": counter.kernels,
    }
    if verbose:
        print(describe(result))
    return result


def describe(r: dict) -> str:
    """A cell's record as the sweep prints it."""
    head = f"[{r['arch']} x {r['shape']}]"
    if r["status"] == "skip":
        return f"{head} skip: {r['reason']}"
    if r["status"] == "error":
        return f"{head} FAILED: {r['error']}\n{r.get('traceback', '')}"
    cost = r["cost"]
    return "\n".join([
        f"{head} {r['step']}:{r['arch']} trace={r['trace_s']}s",
        f"  memory (rank 0): {r['memory']}",
        f"  cost: flops={cost['flops_per_device']:.3e} "
        f"bytes={cost['bytes_per_device']:.3e} (per device, host counts)",
        f"  kernels: {r['kernels']}",
        f"  collectives (bytes/device): {r['collectives']}"])


@contextlib.contextmanager
def fake_world(multi_pod: bool):
    """A fake world of the production mesh's size and the mesh over it;
    the world is torn down after (only one default group can exist)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=required_devices(multi_pod))
    try:
        yield make_production_mesh(multi_pod=multi_pod, device="cpu")
    finally:
        dist.destroy_process_group()


def cell_in_world(task: tuple) -> dict:
    """``(mesh_name, arch, shape, sequence_parallel)`` traced in a fake world
    raised for it in this process and torn down after: the sweep's unit of
    work.  A failure becomes an ``error`` record with its traceback."""
    mesh_name, arch, shape, sequence_parallel = task
    try:
        with fake_world(mesh_name == "multi") as mesh:
            r = run_cell(arch, shape, mesh, verbose=False,
                         sequence_parallel=sequence_parallel)
    except Exception as e:  # noqa: BLE001 — reported; the sweep goes on
        r = {"arch": arch, "shape": shape, "status": "error",
             "error": repr(e), "traceback": traceback.format_exc()}
    r["mesh_name"] = mesh_name
    return r


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--report", default="")
    ap.add_argument("--sequence-parallel", action="store_true", default=True)
    ap.add_argument("--no-sequence-parallel", dest="sequence_parallel",
                    action="store_false")
    ap.add_argument("--halt-on-error", action="store_true")
    args = ap.parse_args()

    archs = list(cfglib.ALL_ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(cfglib.SHAPE_SUITE) if args.shape == "all" \
        else [args.shape]
    mesh_sel = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    tasks = [(m, a, s, args.sequence_parallel)
             for m in mesh_sel for a in archs for s in shapes]

    # the cells are independent, and each traces on one core for seconds to
    # half an hour (xLSTM's sLSTM loop over S): more than one runs in
    # processes of their own, one a core, and reports in order
    results = []
    n_fail = 0
    with contextlib.ExitStack() as stack:
        records = map(cell_in_world, tasks)
        if len(tasks) > 1:
            pool = stack.enter_context(multiprocessing.get_context(
                "spawn").Pool(min(len(tasks), os.cpu_count() or 1)))
            records = pool.imap(cell_in_world, tasks)
        for r in records:
            if not results or results[-1]["mesh_name"] != r["mesh_name"]:
                print(f"=== mesh {r['mesh_name']}: "
                      f"{required_devices(r['mesh_name'] == 'multi')} ranks,"
                      " fake ===", flush=True)
            print(describe(r) + "\n", flush=True)
            results.append(r)
            if r["status"] == "error":
                n_fail += 1
                if args.halt_on_error:
                    raise RuntimeError(f"{r['arch']} x {r['shape']} on "
                                       f"{r['mesh_name']}: {r['error']}")

    ok = sum(1 for r in results if r["status"] == "ok")
    skip = sum(1 for r in results if r["status"] == "skip")
    print(f"\n=== dry-run summary: {ok} ok, {skip} skip, {n_fail} failed, "
          f"{len(results)} total cells ===")
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(results, indent=1))
        print(f"report -> {args.report}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
