"""CPU tests of ``ecobench/spanned.py`` and its readers: idle charged to
the program's spans on a hand-made trace, the launch-pair check of the
clock, the readers on hand-made spans, and a spanned batch of a tiny cell
on the port's plain (CPU) kernels."""
from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from ecobench import harness, spanned
from ecobench.costs import Dims
from ecobench.families import dense
from ecobench.metrics import (decode_attention_host_us, decode_host_ms,
                              decode_layer_host_us)
from ecobench.test_ecobench import TINY, tiny_cell, tiny_run
from ecobench.trace import Trace
from ecobench.traffic import PromptSource
from repro_torch.perf import spans as recorder
from repro_torch.perf.spans import Span

US = 1000  # ns


def span(name, start, end, parent, attr=None):
    return Span(name, start * US, end * US, parent, 1, attr)


# a root, one decode step holding two blocks, the first with an attn_in
SPANS = [span("batch", 0, 95, -1), span("decode_step", 5, 70, 0),
         span("block", 8, 40, 1, 0), span("attn_in", 8, 30, 2),
         span("block", 45, 65, 1, 1)]
PHASES = [("prefill", 0, 4 * US), ("decode", 4 * US, 90 * US)]


def reduced(ops, window_us):
    """A reduced trace of ``ops`` (us) in a window of ``window_us``."""
    ops = [(n, s * US, e * US) for n, s, e in ops]
    busy = sum(e - s for _, s, e in ops) / 1e9
    return Trace(window_s=window_us * 1e-6, busy_s=busy, ops=ops,
                 idle_by_phase={})


@pytest.mark.parametrize("host_shift", [0, 123_456_789])
def test_idle_goes_to_the_innermost_span_split_by_overlap(host_shift):
    """The same spans and phases read on a host clock ``host_shift`` ns
    ahead of the trace's: uncovered idle goes to the harness phase of its
    midpoint, the rest to the innermost span, and the idle the trace holds
    outside its first and last activity to ``edges``."""
    recs = [r._replace(start_ns=r.start_ns + host_shift,
                       end_ns=r.end_ns + host_shift) for r in SPANS]
    phases = [(n, s + host_shift, e + host_shift) for n, s, e in PHASES]
    # kernels at 0-2, 10-20, 50-60, 98-100: idle 2-10, 20-50, 60-98
    trace = reduced([("k", 0, 2), ("gemm", 10, 20), ("gemm", 50, 60),
                     ("k", 98, 100)], window_us=110)
    got = spanned.charge_idle(trace, phases, recs,
                              lambda t: t - host_shift)
    want = {"prefill": 3, "decode_step": 3 + 5 + 5,
            "decode_step/block/attn_in": 2 + 10,
            "decode_step/block": 10 + 5 + 5, "decode": 28, "edges": 10}
    assert got == pytest.approx({k: v * 1e-6 for k, v in want.items()})
    assert sum(got.values()) == pytest.approx(trace.window_s - trace.busy_s)
    assert sum(t - s for s, t in spanned.idle_intervals(trace)) == 76 * US


def test_self_time_and_segments_partition_the_root():
    segs = spanned.segments(SPANS, lambda t: t)
    assert segs == sorted(segs)
    assert all(a[1] <= b[0] for a, b in zip(segs, segs[1:]))
    # the root's own 0-5 and 70-95 are left out
    assert sum(e - s for s, e, _ in segs) == 65 * US
    own = spanned.self_time(SPANS)
    assert own == pytest.approx({"decode_step": 13e-6,
                                 "decode_step/block": 30e-6,
                                 "decode_step/block/attn_in": 22e-6})
    assert spanned.paths(SPANS) == ["", "decode_step", "decode_step/block",
                                    "decode_step/block/attn_in",
                                    "decode_step/block"]


def decode_steps(steps, t0=0):
    """A root, a prefill span, then decode steps, each of ``steps[i]``
    decode_attention wrappers (us from ``t0``): 20 us apart, each 10 us
    long with its ``launch`` 4-6 us into it.  Returns the spans and each
    launch's start."""
    recs, starts, t = [span("batch", t0, t0 + 10**6, -1)], [], t0 + 5
    recs.append(span("prefill", t, t + 20, 0))
    t += 30
    for n in steps:
        recs.append(span("decode_step", t, t + 20 * n + 5, 0))
        step = len(recs) - 1
        for j in range(n):
            a = t + 2 + 20 * j
            recs.append(span("decode_attention", a, a + 10, step))
            recs.append(span("launch", a + 4, a + 6, len(recs) - 1))
            starts.append(a + 4)
        t += 20 * n + 10
    return recs, starts


def kernel_ops(starts):
    """Decode kernels that start ``starts`` (us) on the trace's clock, 3 us
    long, between two other activities."""
    return [("fill", -5 * US, 0)] + [
        ("decode_attention_tc_kernel<128>", int(s * US), int((s + 3) * US))
        for s in starts] + [("fill", 10**6 * US, 10**6 * US + 1)]


def drifting(recs, starts, lat):
    """Kernels ``lat`` us after their launch's start, on a trace clock
    that runs 2000 us behind the host's in the first decode step, and 2030
    us behind at the second's start, falling 2 % further behind through
    it.  Returns the ops and the true map from host ns."""
    second = [r.start_ns for r in recs if r.name == "decode_step"][1]

    def true(t):
        return t - 2000 * US if t < second else \
            t - 2030 * US - int(0.02 * (t - second))

    return kernel_ops([true(a * US) / US + x
                       for a, x in zip(starts, lat)]), true


def test_launch_pairs_set_each_steps_clock_and_the_marker_is_read():
    """No one offset holds; each step's line, fitted on its own pairs,
    puts every span within the kernels' latency of its true time on the
    trace's clock, and nothing starts late.  Counts that differ, or no
    pairs, raise: the marker is no longer read in their place."""
    recs, starts = decode_steps([30, 30])
    lat = [4 + (7 * j) % 3 for j in range(60)]  # 4-6 us
    ops, true = drifting(recs, starts, lat)
    ck = spanned.clock(ops, recs)
    assert ck["ok"] and ck["late"] == 0 and ck["broken"] <= 0.6
    assert ck["rates"] == pytest.approx([0.0, -0.02], abs=1e-3)
    for r in recs[1:]:
        assert 0 <= ck["map"](r.start_ns) - true(r.start_ns) <= 6 * US
    # a 2 us launch span, kernels 4-6 us after its start: 0-2 us after
    # the earliest; the map puts those at their launch's start
    assert min(ck["leads_ns"]) == pytest.approx(-2 * US, abs=0.1 * US)
    with pytest.raises(ValueError):
        spanned.clock(ops[:-2] + ops[-1:], recs)
    with pytest.raises(ValueError):
        spanned.clock(ops[:1] + ops[-1:], SPANS)


def test_a_stray_pair_breaks_alone_and_moves_no_offset():
    """120 pairs, the first of whose kernels reads 7 ms before its launch:
    at most 1 % of the pairs break, and the map moves by no more than a
    microsecond anywhere."""
    recs, starts = decode_steps([60, 60])
    lat = [4 + i % 3 for i in range(120)]
    clean = kernel_ops([a + x for a, x in zip(starts, lat)])
    stray = list(clean)
    stray[1] = (stray[1][0], stray[1][1] - 7000 * US, stray[1][2])
    a, b = spanned.clock(clean, recs), spanned.clock(stray, recs)
    assert a["broken"] == 0 and b["broken"] == 1
    assert b["broken"] <= 0.01 * len(b["leads_ns"]) and b["ok"]
    for r in recs:
        assert abs(a["map"](r.start_ns) - b["map"](r.start_ns)) <= US


def test_kernels_that_start_late_fail_the_check():
    """One offset for the whole batch, where the trace's clock jumps 300 us
    between the steps: half the kernels then start long after their launch
    ended, and the check fails where the per-step lines pass."""
    recs, starts = decode_steps([30, 30])
    lat = [4 + (7 * j) % 3 for j in range(60)]
    ops = kernel_ops([a + x + (300 if j >= 30 else 0)
                      for j, (a, x) in enumerate(zip(starts, lat))])
    assert spanned.clock(ops, recs)["ok"]
    whole = [span("batch", 0, 10**6, -1), span("decode_step", 30, 10**5, 0)]
    for j, a in enumerate(starts):
        whole.append(span("decode_attention", a - 4, a + 6, 1))
        whole.append(span("launch", a, a + 2, len(whole) - 1))
    ck = spanned.clock(ops, whole)
    assert not ck["ok"] and ck["late"] >= 25


def test_idle_on_the_pairs_clock_is_idle_on_the_true_clock():
    """The host clock runs 3 ms ahead of the trace's; the pairs (kernels at
    their launch) give back the idle charged on the host's own clock."""
    recs, starts = decode_steps([2, 2])
    ops = kernel_ops(starts)
    phases = [("prefill", 0, 30 * US), ("decode", 30 * US, 200 * US)]
    trace = reduced([("fill", 0, 1)] + [(n, s / US, e / US)
                                        for n, s, e in ops[1:-1]]
                    + [("fill", 199, 200)], 200)
    true = spanned.charge_idle(trace, phases, recs, lambda t: t)
    shifted = [r._replace(start_ns=r.start_ns + 3000 * US,
                          end_ns=r.end_ns + 3000 * US) for r in recs]
    ck = spanned.clock(ops, shifted)
    assert ck["ok"]
    moved = [(n, s + 3000 * US, e + 3000 * US) for n, s, e in phases]
    assert spanned.charge_idle(trace, moved, shifted, ck["map"]) == true
    assert sum(true.values()) == pytest.approx(
        trace.window_s - trace.busy_s)
    # each wrapper: 4 us before its kernel, 3 us after it (the kernel
    # covers its launch)
    assert true["decode_step/decode_attention"] == pytest.approx(
        4 * 7 * US / 1e9)
    assert "decode_step/decode_attention/launch" not in true


def spanned_steps(steps, layers, attn_us=7, block_us=100, step_us=1000):
    """A root and ``steps`` decode steps, each of ``layers`` blocks with
    one decode_attention wrapper."""
    recs = [span("batch", 0, 10**6, -1)]
    t = 10
    for _ in range(steps):
        recs.append(span("decode_step", t, t + step_us, 0))
        step = len(recs) - 1
        for i in range(layers):
            b = t + 1 + i * (block_us + 1)
            recs.append(span("block", b, b + block_us, step, i))
            recs.append(span("decode_attention", b + 1, b + 1 + attn_us,
                             len(recs) - 1))
        t += step_us + 5
    return recs


def test_readers_on_hand_made_spans():
    dims = Dims(layers=3, d_model=8, heads=2, kv_heads=1, head_dim=4,
                d_ff=16, vocab=10)
    sp = spanned.Spanned(spans=spanned_steps(4, 3),
                         batch=SimpleNamespace(steps=4))
    ctx = SimpleNamespace(dims=dims, spans=sp)
    assert decode_host_ms.read(ctx) == pytest.approx(1.0)
    assert decode_layer_host_us.read(ctx) == pytest.approx(100.0)
    assert decode_attention_host_us.read(ctx) == pytest.approx(7.0)


@pytest.mark.parametrize("reader", [decode_host_ms, decode_layer_host_us,
                                    decode_attention_host_us])
def test_readers_read_nothing_without_exact_spans(reader):
    dims = Dims(layers=3, d_model=8, heads=2, kv_heads=1, head_dim=4,
                d_ff=16, vocab=10)
    assert reader.read(SimpleNamespace(dims=dims, trace=None)) is None
    # a step short: every count is off
    short = spanned.Spanned(spans=spanned_steps(3, 3),
                            batch=SimpleNamespace(steps=4))
    assert reader.read(SimpleNamespace(dims=dims, spans=short)) is None
    none = spanned.Spanned(spans=[span("batch", 0, 1, -1)],
                           batch=SimpleNamespace(steps=0))
    assert reader.read(SimpleNamespace(dims=dims, spans=none)) is None


def test_a_spanned_batch_of_a_tiny_cell_on_the_cpu():
    """The recorder is on for that batch alone, every span carries its
    number, the answers are those of the same prompts served unspanned, and
    the readers report (no launch on the plain path, so no pairs)."""
    cell = tiny_cell(1e-3)
    cpu = torch.device("cpu")
    w = dense.make_weights(torch, TINY, 3, cpu)
    server = harness.Server(torch, cell, dense.port_params(w), cpu)
    plain = server.serve(PromptSource(torch, 3, TINY["vocab_size"], cpu)
                         .batch(cell.mix.batch, max(cell.mix.prompt_buckets)))
    assert recorder.collect() == []
    sp = spanned.spanned_batch(torch, server, cell.mix,
                               PromptSource(torch, 3, TINY["vocab_size"],
                                            cpu), request_id=5)
    assert not recorder.on and recorder.collect() == []
    assert torch.equal(sp.batch.answers, plain.answers)
    assert sp.spans[0].name == "batch"
    assert {r.request_id for r in sp.spans} == {5}
    names = [r.name for r in sp.spans]
    steps, L = sp.batch.steps, TINY["num_hidden_layers"]
    assert names.count("decode_step") == steps
    assert names.count("decode_attention") == L * steps
    assert names.count("flash_attention") == L and "launch" not in names
    ctx = SimpleNamespace(dims=dense.dims(TINY), spans=sp)
    for reader in (decode_host_ms, decode_layer_host_us,
                   decode_attention_host_us):
        assert reader.read(ctx) > 0
    out = spanned.report(ctx, sp, spanned.step_ms(plain))
    assert set(out["metrics"]) == set(spanned.METRICS)
    assert out["breakdown"]["launch_pairs"] == 0
    b = out["breakdown"]  # no device trace: no clock, no idle by span
    assert b["clock_ok"] is None and b["idle_by_span"] is None
    assert all(k.startswith("prefill") for k, _ in b["host_self_s_prefill"])
    assert any(k.endswith("flash_attention")
               for k, _ in b["host_self_s_prefill"])
    # the recorder in turns: the odd steps alone, the same answers
    p = PromptSource(torch, 3, TINY["vocab_size"], cpu).batch(
        cell.mix.batch, max(cell.mix.prompt_buckets))
    off, on, batch = spanned.interleaved(server, p)
    assert (len(off), len(on)) == ((steps + 1) // 2, steps // 2)
    assert torch.equal(batch.answers, plain.answers)
    assert not recorder.on and recorder.collect() == []


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_never_turns_the_recorder_on(trace, monkeypatch):
    calls = []
    monkeypatch.setattr(recorder, "enable", lambda: calls.append(1))
    out = tiny_run(tiny_cell(1e-3), trace=trace)
    assert out["correct"] is True
    assert calls == [] and not recorder.on
    assert recorder.collect() == []


def test_the_script_wants_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the script would run")
    assert spanned.main(["--workload", "internlm2-1.8b.rag",
                         "--seed", "1"]) == 2
