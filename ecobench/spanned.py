"""The LM step's own spans (``repro_torch.perf.spans``) over one batch of a
cell's longest prompts, put on the device trace's clock: which program
span holds each idle gap of the card, how long after its launch each decode
attention kernel starts, and what the recorder costs when it is on.

    python3 ecobench/spanned.py --workload <cell> --seed <n>

Sets the cell up as ``run.py`` does (weights from the seed, a warm-up of
every prompt length), then serves, one after another, batches of the
mix's longest prompts:

* the traced batch of ``harness.traced_batch``, recorder off;
* the spanned batch: ``harness.traced_batch`` again, with the recorder on
  while it serves and a root span whose request id is the batch's number
  (1; the traced batch is 0);
* ``ON_COST_BATCHES`` batches without the profiler whose decode steps run
  with the recorder off and on in turns, so that the host's slow swings
  touch both alike: the recorder's cost a decode step; each batch's
  answers are compared with those of the same prompts served unspanned.

Prints progress on standard error and one JSON object as the last line of
standard output.  Exits 2 without a CUDA card, 1 when the launch pairs do
not validate the clock (``clock``).
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import importlib
import itertools
import json
import math
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DECODE_TC = "decode_attention_tc_kernel"
ROOT_SPAN = "batch"
ON_COST_BATCHES = 2
METRICS = ("decode_host_ms", "decode_layer_host_us",
           "decode_attention_host_us")  # the readers of ``ctx.spans``


@dataclass
class Spanned:
    """The spanned batch, what the readers in ``metrics/`` take as
    ``ctx.spans``."""
    spans: list  # repro_torch.perf.spans.Span, the harness's root first
    batch: object  # harness.Batch
    trace: object = None  # trace.Trace of the batch
    clock: dict = field(default_factory=dict)  # ``clock()``'s
    idle_by_span: dict = field(default_factory=dict)  # path -> idle s


def paths(spans) -> list[str]:
    """Each span's path from below its root, ``decode_step/block/attn_in``;
    a root's is empty."""
    out = []
    for r in spans:
        if r.parent < 0:
            out.append("")
        else:
            up = out[r.parent]
            out.append(f"{up}/{r.name}" if up else r.name)
    return out


def durations(sp: Spanned, name: str, parent: str | None = None) -> list:
    """Host ns of each span called ``name`` (whose parent is called
    ``parent``)."""
    return [r.end_ns - r.start_ns for r in sp.spans if r.name == name and
            (parent is None or sp.spans[r.parent].name == parent)]


def self_time(spans) -> dict:
    """Host seconds by path that each span holds outside its children."""
    own = [r.end_ns - r.start_ns for r in spans]
    for r in spans:
        if r.parent >= 0:
            own[r.parent] -= r.end_ns - r.start_ns
    out: dict = {}
    for p, t in zip(paths(spans), own):
        if p:
            out[p] = out.get(p, 0.0) + t / 1e9
    return out


def segments(spans, to_trace) -> list:
    """(start, end, path) on the trace's clock of the time each span holds
    outside its children, by start; ``to_trace`` takes host ns to the
    trace's clock.  The spans are nested (one thread opened them); where
    the map jumps between two decode steps, a piece is cut where the one
    before it ends, so the pieces do not overlap.  A root's own time is
    left out."""
    names = paths(spans)
    out, stack = [], []  # stack: [index, cursor] of the open spans

    def piece(i, s, e):
        if e > s and names[i]:
            out.append((to_trace(s), to_trace(e), names[i]))

    def close_until(t):
        while stack and spans[stack[-1][0]].end_ns <= t:
            i, cur = stack.pop()
            piece(i, cur, spans[i].end_ns)
            if stack:
                stack[-1][1] = spans[i].end_ns

    for i, r in enumerate(spans):
        close_until(r.start_ns)
        if stack:
            piece(stack[-1][0], stack[-1][1], r.start_ns)
        stack.append([i, r.start_ns])
    close_until(float("inf"))
    out.sort()
    clipped, end = [], None
    for s, e, p in out:
        s = s if end is None else max(s, end)
        if e > s:
            clipped.append((s, e, p))
            end = e
    return clipped


def idle_intervals(trace) -> list:
    """The idle intervals between a reduced trace's first and last device
    activity, on its clock."""
    from ecobench.trace import _union

    busy = _union([(s, t) for _, s, t in trace.ops])
    return [(a[1], b[0]) for a, b in zip(busy, busy[1:])]


def charge_idle(trace, phases, spans, to_trace) -> dict:
    """Idle seconds of a reduced trace by the innermost program span that
    holds them, split by overlap, keyed by path.  Idle outside every
    program span goes to the harness phase that holds its midpoint
    (``phases``: (name, start_ns, end_ns) on the host clock), or to
    ``between batches``; the idle between the markers and the batch's
    first and last device activity, which the reduced trace no longer
    places, to ``edges``.  The entries sum to the trace's idle time."""
    segs = segments(spans, to_trace)
    mapped = [(to_trace(s), to_trace(e), n) for n, s, e in phases]
    starts = [s for s, _, _ in mapped]
    out: dict = {}

    def add(key, ns):
        out[key] = out.get(key, 0.0) + ns / 1e9

    def to_phase(s, t):
        mid = (s + t) // 2
        i = bisect.bisect_right(starts, mid) - 1
        add(mapped[i][2] if i >= 0 and mid < mapped[i][1]
            else "between batches", t - s)

    j = 0
    for s, t in idle_intervals(trace):
        while j < len(segs) and segs[j][1] <= s:
            j += 1
        cur, k = s, j
        while k < len(segs) and segs[k][0] < t:
            a, b = max(segs[k][0], cur), min(segs[k][1], t)
            if a > cur:
                to_phase(cur, a)
            if b > a:
                add(segs[k][2], b - a)
                cur = b
            k += 1
        if t > cur:
            to_phase(cur, t)
    edges = trace.window_s - trace.busy_s - sum(out.values())
    if edges > 0:
        out["edges"] = edges
    return out


def launch_pairs(ops, spans) -> list:
    """(index of the span, kernel start on the trace's clock) of the k-th
    ``launch`` span under ``decode_attention`` and the k-th
    ``decode_attention_tc_kernel``.  Raises when their counts differ, or
    when there are none: the spans cannot then be put on the trace's
    clock."""
    launches = [i for i, r in enumerate(spans) if r.name == "launch"
                and spans[r.parent].name == "decode_attention"]
    kernels = [s for n, s, _ in ops if DECODE_TC in n]
    if not kernels or len(launches) != len(kernels):
        raise ValueError(f"{len(launches)} decode launch spans against "
                         f"{len(kernels)} {DECODE_TC} activities: no clock")
    return list(zip(launches, kernels))


def tops(spans) -> list:
    """Each span's top-level ancestor (a child of a root, the span itself
    if it is one); -1 for a root."""
    out = []
    for i, r in enumerate(spans):
        if r.parent < 0:
            out.append(-1)
        elif spans[r.parent].parent < 0:
            out.append(i)
        else:
            out.append(out[r.parent])
    return out


@dataclass
class Clock:
    """Host ns to the trace's clock (whole ns): a line a decode step,
    ``offset[i] + rate[i] * (t - start[i])`` added to ``t``, which a time
    outside every step takes from the nearest step, held at that step's
    nearer end."""
    start: list
    end: list
    offset: list
    rate: list

    def __call__(self, t):
        i = max(bisect.bisect_right(self.start, t) - 1, 0)
        if i + 1 < len(self.start) and \
                self.start[i + 1] - t < t - self.end[i]:
            i += 1
        x = min(max(t, self.start[i]), self.end[i]) - self.start[i]
        return t + self.offset[i] + round(self.rate[i] * x)


def line(xy) -> tuple:
    """(intercept, slope) of the points ``xy`` by Theil and Sen: the median
    of the pairwise slopes, and the median intercept under it, so that a
    few stray points move neither."""
    rate = statistics.median([(y2 - y1) / (x2 - x1) for (x1, y1), (x2, y2)
                              in itertools.combinations(xy, 2) if x2 != x1]
                             or [0.0])
    return statistics.median(y - rate * x for x, y in xy), rate


def clock(ops, spans) -> dict:
    """The map from the host clock to the trace's, fitted on the launch
    pairs, and the check of it.

    The trace's clock drifts against the host's by up to a few hundred us
    a second and jumps back now and then, so no one offset holds over a
    batch.  Each decode step (a top-level span that holds pairs) gets a
    line instead: kernel start - launch start against the launch's start,
    over the step's pairs (``line``).  All lines then move by one
    constant, the 1st percentile of the pairs' residuals, so that 1 % of
    the kernels start before their launch span: that bound holds by
    construction.  What checks the map is the other side, which nothing
    fits: in a host-paced decode each kernel starts as soon as its launch
    is made, so at most 1 % may start more than ``window`` (the median
    launch span) after their launch span ended (``late``).

    Returns ``map`` (a ``Clock``), ``leads_ns`` (kernel start - launch
    end, a pair each), ``broken``, ``late``, ``window_ns``, ``rates`` (the
    steps' slopes) and ``ok``."""
    pairs = launch_pairs(ops, spans)
    top = tops(spans)
    base = pairs[0][1] - spans[pairs[0][0]].start_ns  # keeps floats small
    by_step: dict = {}
    for i, k in pairs:
        by_step.setdefault(top[i], []).append(
            (spans[i].start_ns - spans[top[i]].start_ns,
             k - spans[i].start_ns - base))
    steps = sorted(by_step, key=lambda t: spans[t].start_ns)
    lines = {t: line(by_step[t]) for t in steps}
    rest = sorted(y - lines[t][0] - lines[t][1] * x
                  for t, xy in by_step.items() for x, y in xy)
    q = rest[int(0.01 * len(rest))]
    to_trace = Clock(start=[spans[t].start_ns for t in steps],
                     end=[spans[t].end_ns for t in steps],
                     offset=[base + math.floor(lines[t][0] + q)
                             for t in steps],
                     rate=[lines[t][1] for t in steps])
    window = statistics.median(spans[i].end_ns - spans[i].start_ns
                               for i, _ in pairs)
    leads = [k - to_trace(spans[i].end_ns) for i, k in pairs]
    broken = sum(k < to_trace(spans[i].start_ns) for i, k in pairs)
    late = sum(x > window for x in leads)
    return {"map": to_trace, "leads_ns": leads, "broken": broken,
            "late": late, "window_ns": window,
            "rates": [r for _, r in lines.values()],
            "ok": max(broken, late) <= 0.01 * len(pairs)}


def spanned_batch(torch, server, mix, prompts, request_id: int) -> Spanned:
    """``harness.traced_batch`` with the program's recorder on while it
    serves, inside a root span whose request id is ``request_id``, and the
    harness's phases kept on the host clock.  On the card the spans are put
    on the trace's clock (``clock``) and, where its check holds, the
    batch's idle is charged to them."""
    from repro_torch.perf import spans as recorder

    from ecobench import harness

    phases, serve = [], server.serve

    def serve_spanned(batch, steps=None):
        timer = server.span  # the traced batch's phase timer

        @contextlib.contextmanager
        def phase(name):
            t = time.perf_counter_ns()
            with timer(name):
                yield
            phases.append((name, t, time.perf_counter_ns()))

        server.span = phase
        recorder.enable()
        try:
            with recorder.root(ROOT_SPAN, request_id):
                return serve(batch, steps)
        finally:
            recorder.disable()

    server.serve = serve_spanned
    try:
        trace = harness.traced_batch(torch, server, mix, prompts)
    finally:
        del server.serve
    out = Spanned(spans=recorder.collect(), batch=trace.batches[0],
                  trace=trace)
    if trace.ops:
        out.clock = clock(trace.ops, out.spans)
        if out.clock["ok"]:
            out.idle_by_span = charge_idle(trace, phases, out.spans,
                                           out.clock["map"])
    return out


def interleaved(server, prompts):
    """One batch served by ``Server.serve`` with the recorder on for its
    odd decode steps alone: the host ns of each decode step call with it
    off, of each with it on, and the batch."""
    from repro_torch.perf import spans as recorder

    step, times = server.decode, ([], [])

    def timed(*args):
        turn = (len(times[0]) + len(times[1])) % 2
        if turn:
            recorder.enable()
        t = time.perf_counter_ns()
        out = step(*args)
        times[turn].append(time.perf_counter_ns() - t)
        recorder.disable()
        return out

    server.decode = timed
    try:
        batch = server.serve(prompts)
    finally:
        server.decode = step
    recorder.collect()
    return times[0], times[1], batch


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def step_ms(batch) -> float:
    return 1e3 * (batch.t_done - batch.t_first) / batch.steps


def report(ctx, sp: Spanned, traced_ms: float) -> dict:
    """The readers' values and the spanned batch's breakdown: idle by span,
    the program's host self time by path under ``decode_step`` and under
    ``prefill``, and the clock's check."""
    out = {"metrics": {
        n: importlib.import_module(f"ecobench.metrics.{n}").read(ctx)
        for n in METRICS}}
    decode = {k: v for k, v in sp.idle_by_span.items()
              if k == "decode" or k.startswith("decode_step")}
    below = sum(v for k, v in decode.items() if "/block" in k)
    own = self_time(sp.spans)
    ck = sp.clock
    leads = sorted(ck.get("leads_ns", []))
    rates = ck.get("rates", [])
    out["breakdown"] = {
        "idle_by_span": top(sp.idle_by_span) if sp.idle_by_span else None,
        "idle_s": sum(sp.idle_by_span.values()),
        "idle_reduce_s": sum(sp.trace.idle_by_phase.values()),
        "decode_idle_below_block": below / sum(decode.values())
        if decode else None,
        "host_self_s_decode": top({k: v for k, v in own.items()
                                   if k.startswith("decode_step")}, 16),
        "host_self_s_prefill": top({k: v for k, v in own.items()
                                    if k.startswith("prefill")}, 16),
        "launch_pairs": len(leads), "broken": ck.get("broken"),
        "late": ck.get("late"), "clock_ok": ck.get("ok"),
        "launch_us_median": ck["window_ns"] / 1e3 if ck else None,
        "lead_us_min": leads[0] / 1e3 if leads else None,
        "lead_us_median": statistics.median(leads) / 1e3 if leads else None,
        "drift_ppm": [min(rates) * 1e6, max(rates) * 1e6] if rates else None,
        "decode_ms_spanned": step_ms(sp.batch),
        "decode_ms_traced": traced_ms,
    }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch

    from ecobench import harness
    from ecobench.traffic import PromptSource

    if not torch.cuda.is_available():
        harness.log("no CUDA card")
        return 2
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    c, mix = cell.config, cell.mix
    fam = importlib.import_module(f"ecobench.families.{c['family']}")
    from repro_torch.kernels.build import kernel_library

    kernel_library()
    w = fam.make_weights(torch, c, args.seed, dev)
    server = harness.Server(torch, cell, fam.port_params(w), dev)
    warm = PromptSource(torch, args.seed, c["vocab_size"], dev, "warmup")
    for S in mix.prompt_buckets:
        server.serve(warm.batch(mix.batch, S), steps=2)
    server.sync()
    prompts = PromptSource(torch, args.seed, c["vocab_size"], dev)
    traced = harness.traced_batch(torch, server, mix, prompts)
    harness.zero_counters(cell)
    sp = spanned_batch(torch, server, mix, prompts, request_id=1)
    bad = harness.launch_gate(cell, [sp.batch], dev)
    if bad:
        raise RuntimeError("the spanned batch did not run the port's "
                           "kernels as it must: " + "; ".join(bad))
    ctx = harness.Context(dims=fam.dims(c), setup_s=0.0, window_s=0.0,
                          batches=[], trace=traced)
    ctx.spans = sp
    out = {"workload": cell.name, "seed": args.seed,
           "device": torch.cuda.get_device_name(dev),
           **report(ctx, sp, step_ms(traced.batches[0]))}
    b = out["breakdown"]
    harness.log(f"spans: {len(sp.spans)}; {b['launch_pairs']} launch "
                f"pairs, {b['broken']} with the kernel before its launch (by "
                f"construction), {b['late']} more than "
                f"{b['launch_us_median']:.1f} us after it; clock check ok "
                f"{b['clock_ok']}; lead min {b['lead_us_min']:.3f} us, "
                f"median {b['lead_us_median']:.3f} us; drift "
                f"{b['drift_ppm']} ppm")
    harness.log(f"decode a step: spanned {b['decode_ms_spanned']:.3f} ms, "
                f"traced unspanned {b['decode_ms_traced']:.3f} ms")

    off, on, same = [], [], True
    for _ in range(ON_COST_BATCHES):
        p = prompts.batch(mix.batch, max(mix.prompt_buckets))
        off_ns, on_ns, batch = interleaved(server, p)
        off += off_ns
        on += on_ns
        same = same and torch.equal(batch.answers, server.serve(p).answers)
    off_ms, on_ms = statistics.median(off) / 1e6, statistics.median(on) / 1e6
    out["on_cost"] = {"steps": [len(off), len(on)], "off_ms": off_ms,
                      "on_ms": on_ms, "ratio": on_ms / off_ms,
                      "answers_equal": same}
    harness.log(f"recorder cost: median decode step call {off_ms:.3f} ms "
                f"off, {on_ms:.3f} ms on ({len(off)} and {len(on)} steps in "
                f"turns); answers equal {same}")
    print(json.dumps(out), flush=True)
    if not b["clock_ok"]:
        harness.log("the launch pairs do not hold the clock: idle is not "
                    "charged to spans")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
