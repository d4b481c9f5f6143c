"""The graphed decode step (``repro_torch.launch.graphs``) on the CPU, with
stand-ins for the CUDA graph and streams.

The stand-in graph records the aten ops that run between ``capture_begin``
and ``capture_end`` (on the CPU they also run, where the card's capture
runs none) and replays them on the tensors they were recorded with,
writing each result into the tensor the capture gave back: a replay runs
no Python above aten, as a graph's replay runs none on the card (no kernel
wrapper, launch counter or span).  ``graphs.on_card`` is made to take a
plain CPU tensor as a card's, so that the step's rule, its keys, counters
and spans run here; the launch counters are bumped by a wrapper around the
decode attention op, as its kernel path bumps them on the card.
"""
import contextlib
import gc
import weakref

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.launch import graphs
from repro_torch.launch.steps import build_decode_step, build_prefill_step
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.config import ShapeSpec
from repro_torch.perf import spans

torch.set_num_threads(1)  # several xdist workers share the cores

B, S, STEPS = 2, 9, 5
LAYOUTS = [False, True]  # scan_layers: a list of units, or stacked
ON_CARD = graphs.on_card
INNER = ("block", "attn_in", "kv_write", "attention", "attn_out", "ffn",
         "embed", "head", "decode_attention")


class _Recorder(TorchDispatchMode):
    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise RuntimeError("a host sync under capture")
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out


def _tensors(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


class StandInGraph:
    made: list = []  # weak references to every graph made

    def __init__(self):
        self.ops = []
        self.mode = None
        StandInGraph.made.append(weakref.ref(self))

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.mode = _Recorder(self.ops)
        self.mode.__enter__()

    def capture_end(self):
        self.mode.__exit__(None, None, None)
        self.mode = None

    def replay(self):
        for func, args, kwargs, out in self.ops:
            if func.is_view:
                continue
            res = func(*args, **kwargs)
            if func._schema.is_mutable:
                continue
            for o, r in zip(_tensors(out), _tensors(res)):
                if isinstance(o, torch.Tensor):
                    o.copy_(r)


class StandInStream:
    def __init__(self, device=None):
        pass

    def wait_stream(self, other):
        pass


def _no_graph_context(*args, **kwargs):
    raise AssertionError("torch.cuda.graph synchronises and empties the "
                         "allocator's cache; the step captures without it")


@pytest.fixture
def card(monkeypatch):
    """The stand-ins, a CPU tensor taken as a card's, and the decode
    attention op counting its launches as its kernel path does."""
    StandInGraph.made.clear()
    monkeypatch.setattr(torch.cuda, "CUDAGraph", StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", _no_graph_context)
    monkeypatch.setattr(torch.cuda, "Stream", StandInStream)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: StandInStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(graphs, "on_card",
                        lambda t: type(t) is torch.Tensor)

    def counted(*args, **kwargs):
        decode_attention.launches += 1
        decode_attention.launches_tc += 1
        return decode_attention(*args, **kwargs)

    monkeypatch.setattr(L, "decode_attention", counted)
    saved = graphs.launch_counts()
    yield
    graphs.add_counts({k: n - graphs.launch_counts()[k]
                       for k, n in saved.items()})


@pytest.fixture(autouse=True)
def recorder_off():
    spans.disable()
    spans.collect()
    yield
    spans.disable()
    spans.collect()


def model(arch="internlm2-1.8b", scan_layers=True):
    cfg = get_config(arch).reduced().with_overrides(scan_layers=scan_layers)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    return cfg, params


def shape():
    return ShapeSpec("graphed", S + STEPS + 1, B, "prefill")


def prompts(cfg, seed=1):
    return torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(seed))


def serve(cfg, params, step, tokens, steps=STEPS, cache_len_of=None):
    """Prefill, then ``steps`` greedy steps through ``step`` with a tensor
    ``cache_len`` on the step's device (or ``cache_len_of(n)``); each
    step's logits (copied) and the final cache."""
    logits, cache = build_prefill_step(cfg, shape())(params, tokens)
    token = logits.argmax(-1, keepdim=True)
    n = torch.full((), S + 1, dtype=torch.int32)
    out = []
    for t in range(steps):
        arg = n if cache_len_of is None else cache_len_of(S + 1 + t)
        logits, cache = step(params, token, cache, arg)
        out.append(logits.clone())
        token = logits.argmax(-1, keepdim=True)
        n += 1
    return out, cache


def eager_step(cfg):
    return lambda p, t, c, n: lm.decode_step(p, cfg, t, c, n,
                                             capacity=shape().seq_len)


@pytest.mark.parametrize("scan_layers", LAYOUTS)
def test_dense_step_with_a_tensor_cache_len_replays_one_graph(card,
                                                              scan_layers):
    cfg, params = model(scan_layers=scan_layers)
    want, want_cache = serve(cfg, params, eager_step(cfg), prompts(cfg))
    step = build_decode_step(cfg, shape())
    got, cache = serve(cfg, params, step, prompts(cfg))
    assert (step.captures, step.replays, step.eager_steps) == \
        (1, STEPS - 1, 1)
    assert step.held == 1 and len(StandInGraph.made) == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(graphs.tree_leaves(cache), graphs.tree_leaves(want_cache)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("why", ["int cache_len", "moe", "policy", "cpu"])
def test_the_rule_sends_the_step_eager(card, monkeypatch, why):
    arch = "llama4-scout-17b-a16e" if why == "moe" else "internlm2-1.8b"
    cfg, params = model(arch)
    kw = {}
    if why == "policy":
        class Policy:  # replicates: no activation rule
            def activation_policy(self):
                return None
        kw["policy"] = Policy()
    if why == "cpu":  # the real rule: a CPU tensor is no card's
        monkeypatch.setattr(graphs, "on_card", ON_CARD)
    as_int = (lambda n: n) if why == "int cache_len" else None
    want, _ = serve(cfg, params, eager_step(cfg), prompts(cfg))
    step = build_decode_step(cfg, shape(), **kw)
    got, _ = serve(cfg, params, step, prompts(cfg), cache_len_of=as_int)
    assert (step.captures, step.replays, step.eager_steps) == (0, 0, STEPS)
    assert StandInGraph.made == [] and step.held == 0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_the_rule_reads_the_stack():
    """Dense decoders graph; MoE, recurrent, encoder-decoder and VLM stay
    eager."""
    got = {a: graphs.dense_decoder(get_config(a)) for a in (
        "internlm2-1.8b", "granite-8b", "gemma-7b", "llama3-8b",
        "llama4-scout-17b-a16e", "kimi-k2-1t-a32b", "recurrentgemma-2b",
        "xlstm-125m", "seamless-m4t-medium", "llava-next-34b")}
    assert [a for a, g in got.items() if g] == [
        "internlm2-1.8b", "granite-8b", "gemma-7b", "llama3-8b"]


def test_launch_counters_count_each_replay_and_no_capture(card):
    cfg, params = model()
    step = build_decode_step(cfg, shape())
    logits, cache = build_prefill_step(cfg, shape())(params, prompts(cfg))
    token = logits.argmax(-1, keepdim=True)
    n = torch.full((), S + 1, dtype=torch.int32)
    seen = []
    capture = step._capture

    def counted_capture(*args):
        before = decode_attention.launches_tc
        cap = capture(*args)
        seen.append(decode_attention.launches_tc - before)
        return cap

    step._capture = counted_capture
    for t in range(STEPS):
        before = (decode_attention.launches, decode_attention.launches_tc)
        logits, cache = step(params, token, cache, n)
        grew = (decode_attention.launches - before[0],
                decode_attention.launches_tc - before[1])
        assert grew == (cfg.num_layers, cfg.num_layers), t
        token = logits.argmax(-1, keepdim=True)
        n += 1
    assert seen == [0]
    assert decode_attention.launches_ffma == 0


def test_a_cache_at_a_new_address_is_captured_again_two_held(card):
    cfg, params = model()
    step = build_decode_step(cfg, shape())
    caches = []
    for seed in (1, 2, 3):  # three caches alive at once: three addresses
        _, cache = serve(cfg, params, step, prompts(cfg, seed), steps=2)
        caches.append(cache)
    assert (step.captures, step.held) == (3, 2)
    gc.collect()
    assert sum(r() is not None for r in StandInGraph.made) == 2
    # the second cache's graph is held: replayed, not captured again
    n = torch.full((), S + 3, dtype=torch.int32)
    token = torch.zeros((B, 1), dtype=torch.long)
    # the eager step writes the slot the replay writes again, alike
    want = eager_step(cfg)(params, token, caches[1], n)[0].clone()
    got, back = step(params, token, caches[1], n)
    assert back is caches[1]
    assert (step.captures, step.replays) == (3, 6)
    assert torch.equal(got, want)
    # the first's was freed: captured again, and the third's goes
    step(params, token, caches[0], n)
    assert (step.captures, step.held) == (4, 2)


def test_the_callers_cache_is_updated_in_place(card):
    cfg, params = model()
    step = build_decode_step(cfg, shape())
    logits, cache = build_prefill_step(cfg, shape())(params, prompts(cfg))
    leaves = graphs.tree_leaves(cache)
    before = [t.clone() for t in leaves]
    token = logits.argmax(-1, keepdim=True)
    n = torch.full((), S + 1, dtype=torch.int32)
    for _ in range(3):
        logits, back = step(params, token, cache, n)
        assert back is cache
        assert [t.data_ptr() for t in graphs.tree_leaves(back)] == \
            [t.data_ptr() for t in leaves]
        token = logits.argmax(-1, keepdim=True)
        n += 1
    assert step.replays == 2
    for t, b in zip(leaves, before):  # slots S .. S + 2 written, no other
        assert not torch.equal(t[..., S:S + 3, :, :], b[..., S:S + 3, :, :])
        assert torch.equal(t[..., :S, :, :], b[..., :S, :, :])
        assert torch.equal(t[..., S + 3:, :, :], b[..., S + 3:, :, :])


def test_a_graphed_step_is_one_decode_step_span(card):
    cfg, params = model()
    step = build_decode_step(cfg, shape())
    spans.enable()
    try:
        serve(cfg, params, step, prompts(cfg), steps=3)
    finally:
        spans.disable()
    recs = spans.collect()
    steps = [i for i, r in enumerate(recs) if r.name == "decode_step"]
    assert len(steps) == 3 and all(recs[i].parent == -1 for i in steps)
    inner = [r for r in recs if r.name in INNER and r.parent >= 0 and
             recs[r.parent].name != "prefill"]
    below = {i: [r for r in inner if r.start_ns >= recs[i].start_ns and
                 r.end_ns <= recs[i].end_ns] for i in steps}
    # the family's first step is eager: its spans; the capture and the
    # replays record none
    assert below[steps[0]] and not below[steps[1]] and not below[steps[2]]
    assert (step.captures, step.replays, step.eager_steps) == (1, 2, 1)
