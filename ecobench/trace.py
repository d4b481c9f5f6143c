"""Reduction of a device trace of one traced batch to what the per-layer
readers take: the device's activities (kernels, copies, fills) and the
host phases the harness timed.

The profiler records device activity only (CUPTI), so that tracing adds
little host time to the host-paced decode.  Host phases are timed on the
host clock and put on the trace's clock by a marker: the batch starts
with a one-element fill and a sync, and the fill's end on the device is
taken as the host time the sync returned.  The batch ends with a second
fill after its last sync, so the traced window, from the first marker's
end to the second's start, is read on the device's clock alone.  Device
busy time is the union of the activities' intervals, so nothing is
counted twice; idle time is what the window holds outside the union, and
each idle interval is charged to the host phase that holds its midpoint.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field


@dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: list  # (name, start_ns, end_ns) of every device activity
    idle_by_phase: dict  # host phase -> idle seconds
    batches: list = field(default_factory=list)  # the traced batches

    def kernel_time(self, names) -> tuple[float, int]:
        """Seconds and launches of the device activities whose name holds
        any of ``names``."""
        hit = [(s, e) for n, s, e in self.ops if any(k in n for k in names)]
        return sum(e - s for s, e in hit) / 1e9, len(hit)

    def top_ops(self, n: int = 10) -> list:
        """The ``n`` device activities with the most time, summed by name,
        as [name, seconds]."""
        tot: dict = {}
        for name, s, e in self.ops:
            tot[name] = tot.get(name, 0.0) + (e - s) / 1e9
        return [[k[:120], v] for k, v in sorted(tot.items(),
                                                key=lambda kv: -kv[1])[:n]]


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def device_ops(prof) -> list:
    """(name, start_ns, end_ns) of every device activity a
    ``torch.profiler.profile`` recorded, by start, from its raw events (parsing them
    into ``FunctionEvent``s takes minutes at a batch's 10^5 launches)."""
    from torch.autograd import DeviceType

    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA
                   and e.duration_ns() > 0 and not e.is_user_annotation()),
                  key=lambda op: op[1])


def reduce(ops, phases, batches) -> Trace:
    """``ops`` from ``device_ops``, by start; the first and the last are
    the batch's markers.  ``phases``: (name, start_s, end_s) on the host
    clock from the first marker's end."""
    if len(ops) < 2:
        return Trace(window_s=0.0, busy_s=0.0, ops=[], idle_by_phase={},
                     batches=list(batches))
    lo, hi = ops[0][2], ops[-1][1]
    ops = [(n, max(s, lo), min(t, hi)) for n, s, t in ops[1:-1]
           if t > lo and s < hi]
    busy = _union([(s, t) for _, s, t in ops])
    idle, prev = [], lo
    for s, t in busy:
        if s > prev:
            idle.append((prev, s))
        prev = max(prev, t)
    if hi > prev:
        idle.append((prev, hi))
    starts = [lo + int(s * 1e9) for _, s, _ in phases]
    by_phase: dict = {}
    for s, t in idle:
        mid = (s + t) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "between batches"
        if i >= 0 and mid < lo + int(phases[i][2] * 1e9):
            name = phases[i][0]
        by_phase[name] = by_phase.get(name, 0.0) + (t - s) / 1e9
    return Trace(window_s=(hi - lo) / 1e9,
                 busy_s=sum(t - s for s, t in busy) / 1e9, ops=ops,
                 idle_by_phase=by_phase, batches=list(batches))
