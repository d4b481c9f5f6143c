"""The benchmark of ``repro_torch``'s serving steps: set-up, the measured
window, the traced batch, the readers and the comparison.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``configs/<name>.json``, its family's weights in ``families/`` and its
plain reference in ``reference/``) and a traffic mix
(``traffic/<mix>.json``); its limits are in ``cells/<cell>.json``.  Each
metric is read by ``metrics/<metric>.py`` from the run's ``Context``; an
entry with a ``workloads`` list is read only in the cells it lists.

The harness knows no architecture.  What depends on one is the family's
(``families/<family>.py``, named by the configuration's ``family``), which
provides, beside ``check``, ``dims``, ``port_config``, ``make_weights``
and ``port_params``:

* ``prefill_flops(c, B, S)`` and ``decode_flops(c, B, cache_len)``: the
  model FLOPs the MFU readers divide by;
* ``launches(c, batches, on_card)``: for each op the family's path must
  launch, its dotted path and its counters with the values ``batches``
  need (0 on the CPU, where the plain versions run); the run's gate
  compares them, exactly, after the window;
* ``kernel_bounds(c, batches)``: for each kernel whose roofline a reader
  takes, by the key the reader asks for, a ``KernelBound``.

A new configuration comes as new files only: its config, a cell's limits,
a traffic mix if it needs one, a family and a plain reference where no
present one computes it, and readers for its own kernels, whose entries
in ``BENCHMARK.json`` list its cells under ``workloads``.  It edits no
file that is here: not this one, not ``costs.py``, not a reader or a
family another cell uses.

The entry the window drives is the port's ``build_prefill_step`` and
``build_decode_step`` (``repro_torch/launch/steps.py``).  Per batch: the
prefill; its first token taken to the host, which is every request's time
to first token; greedy decode steps dispatched with no host sync; one sync
when the batch has its answers.  The window runs whole cycles of the mix
and closes at the end of the cycle in flight once ``seconds`` have passed.
With ``--trace 1`` one more batch, of the mix's longest prompts (the
batches that set the time-to-first-token tail), is served under the
profiler after the window.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

from ecobench import check as checklib
from ecobench.traffic import Mix, PromptSource, load_mix

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    name: str
    config: dict
    mix: Mix
    chips: int
    limits: dict  # number -> {"limit": ...}
    end_to_end: list  # BENCHMARK.json metric entries
    per_layer: list


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, with its files."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    wl = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg = next(c for c in spec["configs"] if c["name"] == wl["config"])
    config = json.loads((root / cfg["file"]).read_text())
    return Cell(name=workload, config=config,
                mix=load_mix(HERE / "traffic" / f"{wl['traffic']}.json"),
                chips=int(wl["chips"]),
                limits=json.loads((HERE / "cells" / f"{workload}.json")
                                  .read_text()),
                end_to_end=spec["end_to_end"], per_layer=spec["per_layer"])


def family(config: dict):
    """The family module of ``config`` (``families/<family>.py``)."""
    return importlib.import_module(f"ecobench.families.{config['family']}")


class KernelBound(NamedTuple):
    """A kernel's launches in a traced batch, as its family counts them."""
    kernels: tuple  # trace names whose device time is the kernel's
    counted: tuple  # trace names counted as its launches
    launches: int  # the launches the batches must show
    bound_s: float  # their summed least time (``costs.bound_s``)


@dataclass
class Batch:
    S: int
    B: int
    steps: int  # decode steps
    t_send: float
    t_first: float  # the first token on the host
    t_done: float  # every answer done
    prompts: object = None  # (B, S) on the device
    answers: object = None  # (B, steps + 1) on the device


@dataclass
class Context:
    """What the metric readers read."""
    dims: object  # the family's ``dims``; readers take ``.layers``
    setup_s: float
    window_s: float
    batches: list
    trace: object = None  # trace.Trace of the traced batch
    family: object = None  # the configuration's family module
    config: dict = None  # the configuration, as its file states it


def forbidden_modules(names=None) -> list[str]:
    """The top-level names in ``FORBIDDEN`` of the loaded modules (or of
    ``names``), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


class Server:
    """The port's prefill and decode steps over one set of weights, serving
    one static batch at a time."""

    def __init__(self, torch, cell: Cell, params, device):
        from repro_torch.launch.steps import (build_decode_step,
                                              build_prefill_step)
        from repro_torch.models.config import ShapeSpec

        self.family, self.config = family(cell.config), cell.config
        self.torch, self.params, self.device = torch, params, device
        self.cfg = self.family.port_config(cell.config)
        shape = ShapeSpec(cell.name, cell.mix.capacity, cell.mix.batch,
                          "prefill")
        self.prefill = build_prefill_step(self.cfg, shape)
        self.decode = build_decode_step(self.cfg, shape)
        self.steps = cell.mix.answer_tokens - 1
        self.span = lambda name: contextlib.nullcontext()

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def serve(self, prompts, steps=None) -> Batch:
        """Prefill, the first token to the host, ``steps`` greedy decode
        steps with no host sync, one sync at the end."""
        torch, span = self.torch, self.span
        steps = self.steps if steps is None else steps
        B, S = prompts.shape
        t_send = time.perf_counter()
        with span("prefill"):
            logits, cache = self.prefill(self.params, prompts)
            token = logits.argmax(-1, keepdim=True)
        with span("first_token"):
            token.cpu()
        t_first = time.perf_counter()
        out = [token]
        with span("decode"):
            cache_len = torch.full((), S + 1, dtype=torch.int32,
                                   device=self.device)
            for _ in range(steps):
                logits, cache = self.decode(self.params, token, cache,
                                            cache_len)
                token = logits.argmax(-1, keepdim=True)
                out.append(token)
                cache_len += 1
            answers = torch.cat(out, dim=1)
            self.sync()
        t_done = time.perf_counter()
        return Batch(S=S, B=B, steps=steps, t_send=t_send, t_first=t_first,
                     t_done=t_done, prompts=prompts, answers=answers)


def allocator_counts(torch, device) -> dict:
    """The caching allocator's device allocations, frees and retries."""
    keys = ("num_device_alloc", "num_device_free", "num_alloc_retries")
    if device.type != "cuda":
        return dict.fromkeys(keys, 0)
    stats = torch.cuda.memory_stats(device)
    return {k: stats.get(k, 0) for k in keys}


def served_op(path: str):
    """The op at a dotted path, ``package.module.name``."""
    module, name = path.rsplit(".", 1)
    return getattr(importlib.import_module(module), name)


def zero_counters(cell: Cell) -> None:
    """Zero the counters that the cell's family checks."""
    c = cell.config
    for path, counters in family(c).launches(c, [], False).items():
        op = served_op(path)
        for name in counters:
            setattr(op, name, 0)


def launch_gate(cell: Cell, batches, device) -> list[str]:
    """The window's kernel launches against what its batches must launch,
    as the cell's family counts them (``launches``): each counter it names
    exactly.  Returns the mismatches."""
    c = cell.config
    want = family(c).launches(c, batches, device.type == "cuda")
    bad = []
    for path, counters in want.items():
        op, name = served_op(path), path.rsplit(".", 1)[1]
        got = {k: getattr(op, k, None) for k in counters}
        log(f"launches {name}: {got} want {counters}")
        if got != counters:
            bad.append(f"{name} launched {got}, want {counters}")
    return bad


def roofline(ctx: Context, key: str):
    """The share of its roofline (%) of the family's kernel ``key`` over
    the traced batch: the summed least time of its launches over its summed
    device time.  None without a trace, when the family lists no such
    kernel, or when the trace holds none of it or not the launches the
    family counts."""
    tr = ctx.trace
    if tr is None:
        return None
    kb = ctx.family.kernel_bounds(ctx.config, tr.batches).get(key)
    if kb is None:
        return None
    seconds, _ = tr.kernel_time(kb.kernels)
    _, launches = tr.kernel_time(kb.counted)
    if not seconds or launches != kb.launches:
        return None
    return 100.0 * kb.bound_s / seconds


def read_metrics(entries, ctx: Context, workload: str) -> dict:
    """Each entry's reader (``metrics/<name>.py``), in the cell
    ``workload``: an entry with a ``workloads`` list only where it lists
    the cell.  A reader that finds nothing to read returns None and its
    metric is left out."""
    out = {}
    for m in entries:
        if workload not in m.get("workloads", [workload]):
            continue
        reader = importlib.import_module(f"ecobench.metrics.{m['name']}")
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """One run of ``cell``; returns the result line's object.  ``device``
    is a ``torch.device``; the card's presence is the caller's to check."""
    import torch

    fam = family(cell.config)
    ref = importlib.import_module(
        f"ecobench.reference.{cell.config['reference']}")
    mix, c = cell.mix, cell.config
    if device.type == "cuda":
        from repro_torch.kernels.build import kernel_library

        lib = kernel_library()
        log(f"kernel library: built in {lib.build_s:.1f} s" if lib.build_s
            else "kernel library: reused")
    t_lib = time.perf_counter()
    w = fam.make_weights(torch, c, seed, device)
    server = Server(torch, cell, fam.port_params(w), device)
    server.sync()
    t_w = time.perf_counter()

    # warm-up: a prefill of every prompt length, two decode steps
    warm = PromptSource(torch, seed, c["vocab_size"], device, "warmup")
    for S in mix.prompt_buckets:
        server.serve(warm.batch(mix.batch, S), steps=2)
    server.sync()
    log(f"set-up: imports and kernel library {t_lib - t_start:.3f} s, "
        f"weights {t_w - t_lib:.3f} s, warm-up "
        f"{time.perf_counter() - t_w:.3f} s")
    prompts = PromptSource(torch, seed, c["vocab_size"], device)
    zero_counters(cell)
    gc.collect()
    alloc0 = allocator_counts(torch, device)

    batches, cycle = [], 0
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while True:
        for S in mix.cycle_order(seed, cycle):
            batches.append(server.serve(prompts.batch(mix.batch, S)))
        cycle += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    log(f"window: {cycle} cycles, {len(batches)} batches in "
        f"{window_s:.3f} s; set-up {setup_s:.3f} s")
    log("batches (S, prefill ms, decode ms): " + " ".join(
        f"({b.S}, {1e3 * (b.t_first - b.t_send):.1f}, "
        f"{1e3 * (b.t_done - b.t_first):.1f})" for b in batches))
    alloc1 = allocator_counts(torch, device)
    log("allocator in the window: " + ", ".join(
        f"{k} {alloc1[k] - alloc0[k]}" for k in alloc0))
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    bad = launch_gate(cell, batches, device)
    if bad:
        raise RuntimeError("the window did not run the port's kernels as "
                           "its batches need: " + "; ".join(bad))

    ctx = Context(dims=fam.dims(c), setup_s=setup_s, window_s=window_s,
                  batches=batches, family=fam, config=c)
    result = {"correct": None, "attempted": sum(b.B for b in batches),
              "failed": 0}
    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device)
        if device.type == "cuda" else "cpu",
        "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        ctx.trace = traced_batch(torch, server, mix, prompts)
        device_info["busy_s"] = ctx.trace.busy_s
        device_info["window_s"] = ctx.trace.window_s
        result["breakdown"] = {
            "device_ops": ctx.trace.top_ops(10),
            "idle_gaps": sorted(([k, v] for k, v in
                                 ctx.trace.idle_by_phase.items()),
                                key=lambda kv: -kv[1])[:10]}
    result["metrics"] = read_metrics(
        cell.per_layer if trace else cell.end_to_end, ctx, cell.name)
    result["device"] = device_info

    # the comparison, with the program's state freed
    del server
    if device.type == "cuda":
        torch.cuda.empty_cache()
    samples = checklib.sample_requests(batches, mix.check_requests, seed)
    got = checklib.served_gap(torch, ref, w, c, batches, samples)
    result["correct"], result["checks"] = checklib.judge(got, cell.limits)
    log(f"checked {got['requests']} requests, {got['tokens']} served tokens "
        f"against the float32 reference")
    return result


def traced_batch(torch, server: Server, mix: Mix, prompts: PromptSource):
    """One more batch after the window, of the mix's longest prompts: its
    device activity under ``torch.profiler``, its host phases on the host
    clock, and their reduction (``trace.reduce``).  One batch, not a cycle:
    a cycle of 150-token answers is ~2 * 10^6 device activities."""
    from torch.profiler import ProfilerActivity, profile

    from ecobench import trace as tracelib

    phases = []

    @contextlib.contextmanager
    def span(name):
        t = time.perf_counter()
        yield
        phases.append((name, t - t0, time.perf_counter() - t0))

    acts = [ProfilerActivity.CUDA] if server.device.type == "cuda" else []
    traced = []
    with profile(activities=acts or [ProfilerActivity.CPU]) as prof:
        torch.ones(1, device=server.device)  # the first marker
        server.sync()
        t0 = time.perf_counter()  # the marker's end, on the host clock
        server.span = span
        traced.append(server.serve(prompts.batch(mix.batch,
                                                 max(mix.prompt_buckets))))
        torch.ones(1, device=server.device)  # the second marker
        server.sync()
    server.span = lambda name: contextlib.nullcontext()
    t1 = time.perf_counter()
    out = tracelib.reduce(tracelib.device_ops(prof) if acts else [], phases,
                          traced)
    launched = ", ".join(
        f"{key} {out.kernel_time(kb.counted)[1]} (want {kb.launches})"
        for key, kb in server.family.kernel_bounds(server.config,
                                                   traced).items())
    log(f"trace: {len(out.ops)} device activities in {out.window_s:.3f} s, "
        f"reduced in {time.perf_counter() - t1:.1f} s; launches: "
        f"{launched or 'no kernel listed'}")
    return out
