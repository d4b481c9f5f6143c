"""The LM step's host spans (``repro_torch.perf.spans``) on the CPU: off by
default and then without effect on the step, on a small dense GQA model
(2 layers, 4 / 2 heads), and, when on, the spans of each layer boundary
once per layer, nested and tagged as the recorder promises."""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.perf import spans

torch.set_num_threads(1)  # several xdist workers share the cores

B, S, STEPS = 2, 9, 3
BLOCK_PARTS = ("attn_in", "kv_write", "attention", "attn_out", "ffn")
LAYOUTS = [False, True]  # scan_layers: a list of units, or stacked


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test leaves the recorder off and empty."""
    spans.disable()
    spans.collect()
    yield
    spans.disable()
    spans.collect()


def model(scan_layers: bool, arch: str = "internlm2-1.8b", **overrides):
    cfg = get_config(arch).reduced().with_overrides(scan_layers=scan_layers,
                                                    **overrides)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    return cfg, params


def serve(cfg, params, steps=STEPS):
    """Prefill of a seeded prompt, then ``steps`` greedy decode steps;
    every step's logits."""
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    capacity = S + steps
    logits, cache = lm.prefill(params, cfg, tokens, capacity=capacity)
    out = [logits]
    for t in range(steps):
        token = logits.argmax(-1, keepdim=True)
        logits, cache = lm.decode_step(params, cfg, token, cache, S + t + 1,
                                       capacity=capacity)
        out.append(logits)
    return out


def recorded(fn, request_id=7):
    spans.enable()
    try:
        with spans.root("request", request_id):
            fn()
    finally:
        spans.disable()
    return spans.collect()


def children(recs, i):
    return [r for r in recs if r.parent == i]


@pytest.mark.parametrize("scan_layers", LAYOUTS)
def test_off_records_nothing_and_reads_no_clock(scan_layers, monkeypatch):
    cfg, params = model(scan_layers)

    def no_clock():
        raise AssertionError("the clock was read with the recorder off")

    monkeypatch.setattr(spans.time, "perf_counter_ns", no_clock)
    with spans.root("request", 1):
        serve(cfg, params)
    assert spans.collect() == []


@pytest.mark.parametrize("scan_layers", LAYOUTS)
def test_logits_are_bit_equal_with_the_recorder_off_and_on(scan_layers):
    cfg, params = model(scan_layers)
    off = serve(cfg, params)
    got = []
    recs = recorded(lambda: got.extend(serve(cfg, params)))
    assert recs
    assert len(got) == len(off) == STEPS + 1
    for a, b in zip(off, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("scan_layers", LAYOUTS)
def test_one_decode_step_gives_each_span_once_a_layer(scan_layers):
    cfg, params = model(scan_layers)
    L = cfg.num_layers
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    logits, cache = lm.prefill(params, cfg, tokens, capacity=S + 1)
    token = logits.argmax(-1, keepdim=True)
    recs = recorded(lambda: lm.decode_step(params, cfg, token, cache, S + 1,
                                           capacity=S + 1))
    names = [r.name for r in recs]
    want = {"request": 1, "decode_step": 1, "embed": 1, "head": 1,
            "block": L, "decode_attention": L,
            **dict.fromkeys(BLOCK_PARTS, L)}
    assert {n: names.count(n) for n in set(names)} == want  # no launch here
    step = names.index("decode_step")
    blocks = [r for r in children(recs, step) if r.name == "block"]
    assert [r.attr for r in blocks] == list(range(L))
    for b in blocks:
        i = recs.index(b)
        assert [r.name for r in children(recs, i)] == list(BLOCK_PARTS)
        attention = recs.index(next(r for r in children(recs, i)
                                    if r.name == "attention"))
        assert [r.name for r in children(recs, attention)] == \
            ["decode_attention"]


@pytest.mark.parametrize("scan_layers", LAYOUTS)
def test_prefill_spans_the_flash_wrapper_and_writes_the_cache(scan_layers):
    cfg, params = model(scan_layers)
    L = cfg.num_layers
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    recs = recorded(lambda: lm.prefill(params, cfg, tokens, capacity=S + 4))
    names = [r.name for r in recs]
    assert names.count("prefill") == 1 and names.count("block") == L
    assert names.count("flash_attention") == L
    assert names.count("kv_write") == L and "decode_attention" not in names
    assert "launch" not in names  # the plain path launches nothing
    for r in recs:
        if r.name == "flash_attention":
            assert recs[r.parent].name == "attention"


@pytest.mark.parametrize("scan_layers", LAYOUTS)
def test_every_span_lies_inside_its_parent_and_shares_the_request_id(
        scan_layers):
    cfg, params = model(scan_layers)
    recs = recorded(lambda: serve(cfg, params), request_id=41)
    assert recs[0].name == "request" and recs[0].parent == -1
    assert all(r.parent >= 0 for r in recs[1:])
    for i, r in enumerate(recs):
        assert r.request_id == 41 and r.start_ns <= r.end_ns
        if r.parent >= 0:
            p = recs[r.parent]
            assert r.parent < i
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    names = [r.name for r in recs]
    assert names.count("prefill") == 1
    assert names.count("decode_step") == STEPS


def test_block_attribute_counts_the_layers_of_a_unit():
    """A hybrid stack of one (rglru, rglru, attn) unit: the block spans read
    layers 0-2 in order, and only the attention block opens the attention
    spans."""
    cfg, params = model(False, "recurrentgemma-2b", num_layers=3)
    recs = recorded(lambda: serve(cfg, params, steps=1))
    step = [i for i, r in enumerate(recs) if r.name == "decode_step"]
    assert len(step) == 1
    blocks = [r for r in children(recs, step[0]) if r.name == "block"]
    assert [r.attr for r in blocks] == [0, 1, 2]
    names = [r.name for r in recs]
    assert names.count("decode_attention") == 1
    assert names.count("attn_in") == 2  # the prefill's and the step's


def test_collect_clears_and_spans_outside_a_root_carry_no_request_id():
    spans.enable()
    spans.begin("outer")
    spans.begin("inner", 3)
    spans.end()
    spans.end()
    spans.disable()
    first = spans.collect()
    assert [(r.name, r.parent, r.request_id, r.attr) for r in first] == \
        [("outer", -1, None, None), ("inner", 0, None, 3)]
    assert spans.collect() == []
    with spans.root("request", 5):  # off: nothing
        pass
    assert spans.collect() == []
