"""CPU tests of the benchmark: its files, its frozen counts, its traffic,
its reference, its import check, and whole runs of a tiny cell on the
port's plain (CPU) kernels, sound and with the timed path broken."""
from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import sys
from pathlib import Path

import pytest
import torch

from ecobench import check as checklib
from ecobench import costs, harness
from ecobench.families import dense
from ecobench.reference import dense as ref
from ecobench.traffic import Mix, load_mix

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")

TINY = {
    "name": "tiny", "family": "dense", "reference": "dense",
    "num_hidden_layers": 2, "hidden_size": 64, "intermediate_size": 128,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "vocab_size": 1000, "hidden_act": "silu", "rms_norm_eps": 1e-5,
    "rope_theta": 10000, "tie_word_embeddings": False,
    "torch_dtype": "float32",
}
TINY_MIX = Mix(batch=2, prompt_buckets=(8, 13), answer_tokens=5,
               check_requests=3)


def tiny_cell(limit: float, **overrides) -> harness.Cell:
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    return harness.Cell(name="tiny.cell", config={**TINY, **overrides},
                        mix=TINY_MIX, chips=1,
                        limits={"max_gap": {"limit": limit}},
                        end_to_end=spec["end_to_end"],
                        per_layer=spec["per_layer"])


def tiny_run(cell, seed=7, trace=False):
    return harness.run(cell, seed, 0.0, trace, torch.device("cpu"), 0.0)


# --- the files ---------------------------------------------------------

def test_every_benchmark_entry_resolves_to_its_files():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert spec["command"] == ["python3", "ecobench/run.py"]
    assert spec["paths"] == ["ecobench"]
    assert 1 <= spec["run_seconds"] <= 51
    metrics = spec["end_to_end"] + spec["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    assert "setup_s" in names
    for m in metrics:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "ecobench" / "metrics" / f"{m['name']}.py").exists()
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        # every key cut from the source is in the file, as it is run
        for key in cfg["reduced"]:
            assert key in cfg
        assert (ROOT / "ecobench" / "reference"
                / f"{cfg['reference']}.py").exists()
        dense.check(cfg)
    used = set()
    for w in spec["workloads"]:
        cell = harness.load_cell(w["name"])
        used.add(w["config"])
        assert cell.chips == 1 and cell.limits["max_gap"]["limit"] > 0
        assert cell.mix.capacity <= cell.config["max_position_embeddings"]
        assert len(w["why"]) <= 200 and NAME.match(w["name"])
    assert used == {c["name"] for c in spec["configs"]}


@pytest.mark.parametrize("mix", sorted(
    p.stem for p in (ROOT / "ecobench" / "traffic").glob("*.json")))
def test_traffic_cycles_carry_the_same_mix(mix):
    m = load_mix(ROOT / "ecobench" / "traffic" / f"{mix}.json")
    for seed in (0, 2**31 + 5, 987654321987):
        orders = [m.cycle_order(seed, c) for c in range(6)]
        for o in orders:
            assert sorted(o) == sorted(m.prompt_buckets)
        assert orders == [m.cycle_order(seed, c) for c in range(6)]
    assert len({tuple(m.cycle_order(s, 0)) for s in range(40)}) > 1


@pytest.mark.parametrize("mix", ["rag-b64", "rag-b32"])
def test_rag_lengths_follow_the_systems_prompt_model(mix):
    """The RAG buckets are ECO-LLM's own prompt lengths (query, system
    prompt, top_k chunks) at the median query of the smart-home and car
    domains, for each top_k of its RAG paths; answers are its nominal
    length.  (The system's model lives in the JAX package, read here on the
    CPU only; nothing the benchmark runs imports it.)"""
    import statistics

    from repro.core.domains import build_domain
    from repro.core.paths import DEFAULT_SPEC
    from repro.core.pipeline import OUT_TOKENS

    m = load_mix(ROOT / "ecobench" / "traffic" / f"{mix}.json")
    assert m.answer_tokens == OUT_TOKENS
    ks = sorted({k for impl in ("basic_rag", "hyde")
                 for k in DEFAULT_SPEC["retrieval"][impl]["top_k"]})
    want = []
    for domain in ("smarthome", "automotive"):
        d = build_domain(domain, n_queries=250, seed=0)
        words = statistics.median(q.prompt_words for q in d.queries)
        want += [int(words * 1.3) + 40 + int(k * d.profile.chunk_words * 1.3)
                 for k in ks]
    assert sorted(m.prompt_buckets) == sorted(want)


# --- the frozen counts -------------------------------------------------

def test_counts_against_hand_worked_numbers():
    m = costs.Dims(layers=2, d_model=8, heads=4, kv_heads=2, head_dim=2,
                   d_ff=16, vocab=10)
    # per layer per token: q, o 2*2*8*8 = 256; k, v 2*2*8*4 = 128;
    # MLP 3*2*8*16 = 768; two layers
    assert costs.gemm_flops_per_token(m) == 2 * (256 + 128 + 768)
    # B 3, S 5: 15 pairs; attention 2 * 4*4*2 * 15 = 960; head 2*8*10
    assert costs.prefill_flops(m, 3, 5) == 3 * (5 * 2304 + 960 + 160)
    assert costs.decode_flops(m, 3, 6) == 3 * (2304 + 2 * 4 * 4 * 2 * 6
                                               + 160)
    # flash: 4*B*H*hd*pairs; q, out (B S H hd) and k, v (B S Kv hd), bf16
    assert costs.flash_cost(3, 5, 4, 2, 2) == (
        4 * 3 * 4 * 2 * 15, 2 * (2 * 3 * 5 * 4 * 2 + 2 * 3 * 5 * 2 * 2))
    assert costs.decode_cost(3, 4, 2, 2, 6) == (
        4 * 3 * 4 * 6 * 2, 2 * (2 * 3 * 4 * 2 + 2 * 3 * 6 * 2 * 2))
    assert costs.bound_s(989e12, 0) == 1.0
    assert costs.bound_s(0, 3.35e12) == 1.0


# --- the reference -----------------------------------------------------

@pytest.mark.parametrize("tied", [False, True])
def test_reference_agrees_with_the_port_on_a_tiny_config(tied):
    from repro_torch.models import lm

    c = {**TINY, "tie_word_embeddings": tied}
    w = dense.make_weights(torch, c, 3, torch.device("cpu"))
    tokens = torch.randint(0, c["vocab_size"], (1, 20),
                           generator=torch.Generator().manual_seed(1))
    cfg = dense.port_config(c)
    hidden, _, _ = lm.forward(dense.port_params(w), cfg, tokens)
    head = lm._lm_head(dense.port_params(w), cfg)
    want = (hidden[0] @ head)[:, :c["vocab_size"]]
    got = ref.logits(w, c, tokens[0], 0)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    low = ref.logits(w, c, tokens[0], 0, precision="fp8")
    assert float((low - want).abs().max()) > 1e-2 * float(want.abs().max())


# --- the import check --------------------------------------------------

def test_import_check_compares_whole_top_level_names():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.models.lm",
                                      "repro_torchx", "jaxtyping", "os"]) == []
    assert harness.forbidden_modules(
        ["repro.core", "jax", "jaxlib.xla_client", "flax.linen",
         "repro_torch"]) == ["flax", "jax", "jaxlib", "repro"]


# --- whole runs of a tiny cell ----------------------------------------

def test_a_sound_run_is_correct_and_reports_every_metric():
    out = tiny_run(tiny_cell(1e-3))
    assert out["correct"] is True
    assert out["attempted"] == 4 and out["failed"] == 0
    assert out["checks"]["max_gap"]["value"] <= 1e-3
    assert set(out["metrics"]) == {"requests_per_s", "ttft_ms_p95",
                                   "setup_s"}
    assert list(out)[-1] == "checks"
    traced = tiny_run(tiny_cell(1e-3), trace=True)
    # no device: the device readers find nothing and are left out
    assert set(traced["metrics"]) == {"prefill_mfu", "decode_step_ms",
                                      "window_mfu"}
    assert traced["correct"] is True


@contextlib.contextmanager
def decode_keeps_its_state():
    """The decode step leaves the cache as it was: its token's k and v are
    never written."""
    from repro_torch.models import layers

    plain = layers.kv_cache_update

    def skipped(cache, k_new, v_new, pos):
        return cache if k_new.shape[1] == 1 else plain(cache, k_new, v_new,
                                                       pos)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "kv_cache_update", skipped)
        yield


@contextlib.contextmanager
def tokens_altered():
    """Every served token is the one after the argmax."""
    from repro_torch.models import lm

    plain = lm.logits_of
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lm, "logits_of",
                   lambda *a: plain(*a).roll(1, dims=-1))
        yield


@pytest.mark.parametrize("fault", [decode_keeps_its_state, tokens_altered])
def test_a_broken_timed_path_is_not_correct(fault):
    with fault():
        out = tiny_run(tiny_cell(1e-3))
    assert out["correct"] is False
    assert out["checks"]["max_gap"]["value"] > 1e-3


def test_the_control_fails_where_the_served_bf16_passes():
    """The control at a tiny size in bf16, 128 served tokens a seed: the
    program passes a limit that the float8 control, read on the same
    sequences and judged by the same ``check.judge`` as a run, fails (8
    seeds read 0.005-0.046 and 0.42-0.68)."""
    from ecobench.traffic import PromptSource

    c = {**TINY, "torch_dtype": "bfloat16", "vocab_size": 4000,
         "hidden_size": 128, "head_dim": 32, "intermediate_size": 256}
    mix = Mix(batch=4, prompt_buckets=(8, 13), answer_tokens=16,
              check_requests=8)
    cell = harness.Cell(name="tiny.bf16", config=c, mix=mix, chips=1,
                        limits={"max_gap": {"limit": 0.15}}, end_to_end=[],
                        per_layer=[])
    cpu = torch.device("cpu")
    for seed in (1, 2, 3):
        assert tiny_run(cell, seed)["correct"] is True
        w = dense.make_weights(torch, c, seed, cpu)
        server = harness.Server(torch, cell, dense.port_params(w), cpu)
        src = PromptSource(torch, seed, c["vocab_size"], cpu)
        batches = [server.serve(src.batch(mix.batch, S))
                   for S in mix.prompt_buckets]
        samples = checklib.sample_requests(batches, mix.check_requests, seed)
        got = checklib.control_gap(torch, ref, w, c, batches, samples)
        correct, checks = checklib.judge(got, cell.limits)
        assert correct is False, checks


MS = 1_000_000
# A marker, then two overlapping kernels, a gap in the decode phase and a
# gap between batches (ns on the trace's clock)
HAND_MADE_OPS = [("fill marker", 0, 1 * MS),
                 ("flash_attention_tc_kernel<128>", 1 * MS, 5 * MS),
                 ("gemm", 4 * MS, 6 * MS),
                 ("decode_attention_tc_kernel<16>", 9 * MS, 10 * MS),
                 ("decode_tc_combine_kernel", 10 * MS, 11 * MS),
                 ("fill marker", 13 * MS, 14 * MS)]


def test_trace_reduction_on_a_hand_made_trace():
    """The hand-made trace (``HAND_MADE_OPS``), with its host phases in s
    on the host's clock."""
    from ecobench import trace as tracelib

    phases = [("prefill", 0.0, 0.006), ("decode", 0.006, 0.011)]
    tr = tracelib.reduce(HAND_MADE_OPS, phases, batches=[])
    assert tr.window_s == 0.012
    assert abs(tr.busy_s - 0.007) < 1e-12  # 1-6 and 9-11 ms
    assert tr.idle_by_phase == {"decode": 0.003, "between batches": 0.002}
    assert tr.kernel_time(("flash_attention_tc_kernel",)) == (0.004, 1)
    assert tr.kernel_time(("decode_attention_tc_kernel",
                           "decode_tc_combine_kernel")) == (0.002, 2)
    assert tr.top_ops(1) == [["flash_attention_tc_kernel<128>", 0.004]]


# --- the family's counts ----------------------------------------------

CONFIGS = {**{p.stem: json.loads(p.read_text()) for p in
              sorted((ROOT / "ecobench" / "configs").glob("*.json"))},
           "tiny": TINY}
# a window of synthetic batches: every prompt length, ragged answers, times
# that are no round numbers
WINDOW = [harness.Batch(S=S, B=B, steps=steps, t_send=t, t_first=t + dt,
                        t_done=t + dt + 0.0073 * steps)
          for t, (S, B, steps, dt) in zip(
              (0.0, 0.61, 1.93, 2.017, 3.3), [
                  (202, 64, 149, 0.1183), (994, 64, 149, 0.5371),
                  (292, 32, 7, 0.1571), (670, 8, 0, 0.0942),
                  (13, 1, 1, 0.0029)])]


def hand_made_trace(flash: int, decode: int, batches):
    """The hand-made trace's kernels repeated: ``flash`` prefill launches,
    ``decode`` decode launches each with its combine, between the two
    markers, 12 ms apart."""
    from ecobench import trace as tracelib

    marker, kernels, end = HAND_MADE_OPS[0], HAND_MADE_OPS[1:-1], \
        HAND_MADE_OPS[-1]
    ops, t = [marker], 0
    for n, pick in ((flash, kernels[:2]), (decode, kernels[2:])):
        for _ in range(n):
            ops += [(name, s + t, e + t) for name, s, e in pick]
            t += 12 * MS
    ops.append((end[0], end[1] + t, end[2] + t))
    return tracelib.reduce(ops, [], batches)


def dense_context(c, batches=WINDOW, trace=None):
    return harness.Context(dims=dense.dims(c), setup_s=1.0, window_s=7.31,
                           batches=batches, trace=trace, family=dense,
                           config=c)


def old_rooflines(m, tr):
    """The two roofline readers as they stood before the families counted
    their kernels, inline."""
    flash_names = ("flash_attention_tc_kernel",)
    decode_names = ("decode_attention_tc_kernel", "decode_tc_combine_kernel")
    seconds, launches = tr.kernel_time(flash_names)
    flash = None
    if seconds and launches == m.layers * len(tr.batches):
        bound = sum(m.layers * costs.bound_s(*costs.flash_cost(
            b.B, b.S, m.heads, m.kv_heads, m.head_dim)) for b in tr.batches)
        flash = 100.0 * bound / seconds
    seconds, _ = tr.kernel_time(decode_names)
    _, launches = tr.kernel_time(decode_names[:1])
    dec = None
    if seconds and launches == m.layers * sum(b.steps for b in tr.batches):
        bound = sum(m.layers * costs.bound_s(*costs.decode_cost(
            b.B, m.heads, m.kv_heads, m.head_dim, b.S + t + 1))
            for b in tr.batches for t in range(b.steps))
        dec = 100.0 * bound / seconds
    return flash, dec


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_dense_family_reads_the_frozen_formulas_bit_for_bit(name):
    from ecobench.metrics import (decode_attention_roofline,
                                  flash_attention_roofline, prefill_mfu,
                                  window_mfu)

    c = CONFIGS[name]
    m = costs.Dims(layers=c["num_hidden_layers"], d_model=c["hidden_size"],
                   heads=c["num_attention_heads"],
                   kv_heads=c["num_key_value_heads"],
                   head_dim=c["head_dim"], d_ff=c["intermediate_size"],
                   vocab=c["vocab_size"])
    ctx = dense_context(c)
    peak = costs.PEAK_BF16_FLOPS
    flops = sum(costs.prefill_flops(m, b.B, b.S) for b in WINDOW)
    wall = sum(b.t_first - b.t_send for b in WINDOW)
    assert prefill_mfu.read(ctx) == 100.0 * flops / (wall * peak)
    flops = 0
    for b in WINDOW:
        flops += costs.prefill_flops(m, b.B, b.S)
        flops += sum(costs.decode_flops(m, b.B, b.S + t + 1)
                     for t in range(b.steps))
    assert window_mfu.read(ctx) == 100.0 * flops / (7.31 * peak)

    traced = [WINDOW[1]]  # a batch of the longest prompts
    L, steps = m.layers, traced[0].steps
    for flash, decode in ((L, L * steps), (L + 1, L * steps - 1), (1, 1)):
        ctx.trace = hand_made_trace(flash, decode, traced)
        old = old_rooflines(m, ctx.trace)
        assert (flash_attention_roofline.read(ctx),
                decode_attention_roofline.read(ctx)) == old
        if (flash, decode) == (L, L * steps):
            assert None not in old
    ctx.trace = None
    assert flash_attention_roofline.read(ctx) is None
    assert decode_attention_roofline.read(ctx) is None


@pytest.mark.parametrize("on_card", [True, False])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_dense_family_wants_the_launches_the_gate_wanted(name, on_card):
    c = CONFIGS[name]
    L = c["num_hidden_layers"]
    flash = L * len(WINDOW) if on_card else 0
    dec = L * sum(b.steps for b in WINDOW) if on_card else 0
    want = {"flash_attention": {"launches": flash, "launches_tc": flash,
                                "launches_ffma": 0, "launches_lse": 0},
            "decode_attention": {"launches": dec, "launches_tc": dec,
                                 "launches_ffma": 0, "launches_lse": 0}}
    got = dense.launches(c, WINDOW, on_card)
    assert {p.rsplit(".", 1)[1]: v for p, v in got.items()} == want
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention

    assert [harness.served_op(p) for p in got] == [flash_attention,
                                                   decode_attention]


def test_the_harness_names_no_kernel_op_or_shape():
    text = (ROOT / "ecobench" / "harness.py").read_text()
    names = (dense.FLASH_KERNELS + dense.DECODE_KERNELS
             + (dense.FLASH_OP, dense.DECODE_OP, "flash_attention",
                "decode_attention", "num_hidden_layers", "head_dim"))
    assert [n for n in names if n in text] == []


# --- a second family, defined here alone ------------------------------

PROBE = "probe_kernel"


@pytest.fixture
def doubled(monkeypatch):
    """A family on top of ``dense`` whose FLOPs are doubled, with a kernel
    entry of its own and a counter, ``launches_probe`` of an op defined
    here, that the dense family does not list: one count a call of the
    port's head, so one a prefill and one a decode step."""
    import types

    from repro_torch.models import lm

    ops = types.ModuleType("ecobench_probe_ops")

    def probe():
        pass

    probe.launches_probe = 0
    ops.probe = probe
    plain = lm.logits_of

    def counted(*a):
        probe.launches_probe += 1
        return plain(*a)

    fam = types.ModuleType("ecobench.families.doubled")
    fam.__dict__.update({k: v for k, v in vars(dense).items()
                         if not k.startswith("__")})
    fam.extra = 0  # added to the probe's wanted count

    def launches(c, batches, on_card):
        n = sum(1 + b.steps for b in batches)
        return {**dense.launches(c, batches, on_card),
                "ecobench_probe_ops.probe": {"launches_probe": n + fam.extra}}

    def kernel_bounds(c, batches):
        n = sum(b.B for b in batches)
        return {PROBE: harness.KernelBound(("probe_kernel_a",
                                            "probe_kernel_b"),
                                           ("probe_kernel_a",), n, 1e-3 * n)}

    fam.prefill_flops = lambda c, B, S: 2 * dense.prefill_flops(c, B, S)
    fam.decode_flops = lambda c, B, n: 2 * dense.decode_flops(c, B, n)
    fam.launches, fam.kernel_bounds = launches, kernel_bounds
    monkeypatch.setitem(sys.modules, "ecobench_probe_ops", ops)
    monkeypatch.setitem(sys.modules, "ecobench.families.doubled", fam)
    monkeypatch.setattr(lm, "logits_of", counted)
    return fam


def test_a_family_of_its_own_sets_the_flops_the_gate_and_the_kernels(
        doubled, monkeypatch):
    from ecobench.metrics import (decode_attention_roofline,
                                  flash_attention_roofline, prefill_mfu,
                                  window_mfu)

    seen = []
    plain = harness.read_metrics
    monkeypatch.setattr(harness, "read_metrics",
                        lambda e, ctx, w: seen.append(ctx) or plain(e, ctx,
                                                                    w))
    out = tiny_run(tiny_cell(1e-3, family="doubled"), trace=True)
    assert out["correct"] is True
    ctx = seen[0]
    assert ctx.family is doubled and ctx.config["family"] == "doubled"
    as_dense = dataclasses.replace(ctx, family=dense)
    assert out["metrics"]["prefill_mfu"]["value"] == \
        2 * prefill_mfu.read(as_dense)
    assert window_mfu.read(ctx) == 2 * window_mfu.read(as_dense)
    # its own kernel, read from a trace; the dense keys it does not list
    tr = hand_made_trace(0, 0, ctx.batches[:2])
    tr.ops = [("probe_kernel_a<1>", 0, 3 * MS), ("probe_kernel_b", 3 * MS,
                                                 4 * MS)] * 4
    ctx.trace = tr
    n = sum(b.B for b in ctx.batches[:2])
    assert n == 4
    assert harness.roofline(ctx, PROBE) == 100.0 * 1e-3 * n / 0.016
    assert harness.roofline(as_dense, PROBE) is None
    assert flash_attention_roofline.read(ctx) is None
    assert decode_attention_roofline.read(ctx) is None
    tr.ops = tr.ops[:-2]  # a launch short
    assert harness.roofline(ctx, PROBE) is None


def test_the_gate_checks_the_counter_a_family_names(doubled):
    doubled.extra = 1
    with pytest.raises(RuntimeError, match=r"probe launched "
                       r"\{'launches_probe': \d+\}"):
        tiny_run(tiny_cell(1e-3, family="doubled"))
    doubled.extra = 0
    assert tiny_run(tiny_cell(1e-3, family="doubled"))["correct"] is True


@pytest.mark.parametrize("listed", [["other.cell"], ["other.cell",
                                                     "tiny.cell"]])
def test_a_metric_is_read_only_in_the_cells_it_lists(listed):
    cell = tiny_cell(1e-3)
    cell.end_to_end = [{**m, "workloads": listed} if m["name"] ==
                       "ttft_ms_p95" else m for m in cell.end_to_end]
    out = tiny_run(cell)
    assert ("ttft_ms_p95" in out["metrics"]) == ("tiny.cell" in listed)
    assert {"requests_per_s", "setup_s"} <= set(out["metrics"])
