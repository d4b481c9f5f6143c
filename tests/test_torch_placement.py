"""Port placement plane and cost model (``repro_torch.runtime.placement``,
``repro_torch.perf.cost_model``) on the CPU.

The first part carries over ``tests/test_placement.py`` case for case on the
port: split-point search edge cases, memory-infeasible plans kept out of the
path space, monotone chains, the pipeline simulator against its closed
form, and placed paths in the emulator and executor.  The second part holds
the port against the JAX package: ``get_plan`` field for field for every
(model, chain) the defaults and the reference's tests use, and
``model_layer_costs`` / ``cell_cost`` for all ten archs across
``SHAPE_SUITE``.  All of it is host arithmetic, so everything is exact.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core.slo import SLO as JaxSLO
from repro.launch.serve import build_server as jax_build_server
from repro.runtime.server import Request as JaxRequest
from repro.models.config import SHAPE_SUITE as JAX_SHAPES
from repro.models.config import ModelConfig as JaxModelConfig
from repro.perf import cost_model as jax_cost
from repro.runtime import placement as jax_placement
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.devices import EDGE_DEVICES
from repro_torch.core.cca import critical_component_analysis
from repro_torch.core.domains import build_domain, train_test_split
from repro_torch.core.dsqe import DSQE
from repro_torch.core.emulator import Emulator
from repro_torch.core.paths import (DEFAULT_PLACEMENT_CHAINS,
                                    DEFAULT_PLACEMENT_MODELS, DEFAULT_SPEC,
                                    PLACED_IMPL, PathSpace, with_placements,
                                    with_split_models)
from repro_torch.core.pipeline import (OUT_TOKENS, BatchedPipelineExecutor,
                                       PipelineExecutor)
from repro_torch.core.rps import RuntimePathSelector
from repro_torch.core.slo import SLO
from repro_torch.models.config import SHAPE_SUITE, ModelConfig
from repro_torch.perf import cost_model
from repro_torch.runtime.placement import (DEFAULT_OUT_TOKENS, get_plan,
                                           search_placement, simulate_pipeline)
from repro_torch.runtime.server import EcoLLMServer, Request

TINY = ModelConfig("tiny-dense", "dense", 8, 256, 4, 4, 1024, 1000)


def _total_s(plan) -> float:
    return (plan.predicted_prefill_s
            + DEFAULT_OUT_TOKENS * plan.predicted_decode_s_per_token)


# ---------------------------------------------------------------------------
# split-point search edge cases (tests/test_placement.py, on the port)
# ---------------------------------------------------------------------------


def test_single_layer_model_places_as_one_stage():
    cfg = ModelConfig("tiny-1l", "dense", 1, 256, 4, 4, 1024, 1000)
    plan = search_placement(cfg, ("orin", "m4"))
    assert plan.memory_ok
    assert len(plan.stages) == 1
    s = plan.stages[0]
    assert (s.start, s.end) == (0, 1)
    assert s.device in ("orin", "m4")
    sim = simulate_pipeline(plan)
    assert math.isclose(sim["makespan_s"],
                        plan.prefill_latency_s(plan.prompt_tokens),
                        rel_tol=1e-9)


def test_too_big_for_any_single_edge_device_must_pipeline():
    # gemma-7b (~17 GB bf16) exceeds orin (8 GB) and m1pro (16 GB) at the
    # 0.75 headroom rule, but a 2-stage pipeline over both fits
    for dev in ("orin", "m1pro"):
        assert not get_plan("gemma-7b", dev).memory_ok
    plan = get_plan("gemma-7b", "orin+m1pro")
    assert plan.memory_ok
    assert len(plan.stages) == 2
    assert [s.device for s in plan.stages] == ["orin", "m1pro"]
    # contiguous cover of the full stack
    assert plan.stages[0].start == 0 and plan.stages[-1].end == 28
    assert plan.stages[0].end == plan.stages[1].start


def test_too_big_for_all_edge_must_go_cloud():
    # kimi-k2 resident expert weights (~2 TB bf16) exceed every edge combo;
    # with the cloud in the chain every layer lands on the unbounded stage
    assert not get_plan("kimi-k2-cloud", "orin+m4").memory_ok
    plan = get_plan("kimi-k2-cloud", "orin+m4+cloud")
    assert plan.memory_ok
    assert plan.cloud_fraction == 1.0
    assert [s.device for s in plan.stages] == ["cloud"]


def test_memory_infeasible_plans_rejected_from_path_space():
    bad = with_placements(models=("kimi-k2-cloud",), chains=("orin+m4",))
    assert not [p for p in PathSpace(spec=bad).paths
                if p.model.impl == PLACED_IMPL]
    good = with_placements(models=("kimi-k2-cloud",), chains=("orin+m4+cloud",))
    placed = [p for p in PathSpace(spec=good).paths
              if p.model.impl == PLACED_IMPL]
    assert placed and all(
        get_plan(p.model.param("model"), p.model.param("chain")).memory_ok
        for p in placed)


def test_more_devices_never_predict_worse():
    # empty stages make a superset chain's candidate set contain every
    # subset chain's, so the latency objective is monotone by construction
    sup = search_placement(TINY, ("orin", "m4", "cloud"))
    for sub in (("orin",), ("m4",), ("orin", "m4"), ("m4", "cloud")):
        p = search_placement(TINY, sub)
        if p.memory_ok:
            assert sup.memory_ok
            assert _total_s(sup) <= _total_s(p) * (1 + 1e-9)
    sup = get_plan("gemma-7b", "orin+m1pro+cloud")
    sub = get_plan("gemma-7b", "orin+m1pro")
    assert _total_s(sup) <= _total_s(sub) * (1 + 1e-9)


def test_simulator_matches_closed_form_with_bubbles():
    # the forced-pipeline plan runs m > 1 micro-batches: fill/drain bubbles
    # are live, and the event-driven schedule must equal sum + (m-1)*max
    plan = get_plan("gemma-7b", "orin+m1pro")
    assert plan.micro_batches > 1
    sim = simulate_pipeline(plan)
    assert math.isclose(sim["makespan_s"], plan.predicted_prefill_s,
                        rel_tol=1e-9)
    assert 0.0 < sim["bubble_fraction"] < 1.0
    # closed form holds at off-reference prompt lengths too
    sim768 = simulate_pipeline(plan, prompt_tokens=768)
    assert math.isclose(sim768["makespan_s"], plan.prefill_latency_s(768),
                        rel_tol=1e-9)


def test_slo_aware_search_prefers_cheapest_feasible():
    # latency-only: the cloud's roofline wins; under an SLO the edge meets,
    # feasible-cheapest keeps the small model on free edge compute
    fast = get_plan("internlm2-1.8b", "orin+m4+cloud")
    assert fast.cloud_fraction > 0.0
    cheap = get_plan("internlm2-1.8b", "orin+m4+cloud",
                     slo=SLO(max_latency_s=2.0))
    assert cheap.slo_ok and cheap.memory_ok
    assert cheap.cloud_fraction == 0.0
    assert cheap.cost_usd(512, OUT_TOKENS) == 0.0


def test_plan_determinism_and_memo():
    a = get_plan("internlm2-1.8b", "orin+m4")
    b = get_plan("internlm2-1.8b", ("orin", "m4"))
    assert a is b  # one memoized entry per (model, chain, slo, prompt)
    c = search_placement(get_config("internlm2-1.8b"), ("orin", "m4"),
                         model="internlm2-1.8b")
    assert c.stages == a.stages and c.micro_batches == a.micro_batches


# ---------------------------------------------------------------------------
# path-space integration
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def placed_world():
    dom = build_domain("agriculture", n_queries=10, seed=0)
    space = PathSpace(spec=with_placements())
    ex = PipelineExecutor(dom, EDGE_DEVICES["m4"], seed=0)
    return dom, space, ex


def test_placed_cell_accounting_reproduces_plan(placed_world):
    dom, space, ex = placed_world
    q = dom.queries[0]
    # a bare placed path (null preprocessing): its latency/cost must be
    # EXACTLY the plan's closed-form prefill + cloud-fraction billing
    path = next(p for p in space.paths
                if p.model.impl == PLACED_IMPL
                and p.qproc.impl == "null" and p.retrieval.impl == "null"
                and p.cproc.impl == "null")
    acc, lat, cost = ex.run(q, path)
    plan = get_plan(path.model.param("model"), path.model.param("chain"))
    prompt = ex.initial_state(q).prompt_tokens
    assert lat == plan.prefill_latency_s(prompt)
    assert cost == plan.cost_usd(prompt, OUT_TOKENS)
    assert 0.0 <= acc <= 1.0


def test_batched_engine_parity_over_placed_space(placed_world):
    dom, space, ex = placed_world
    bx = BatchedPipelineExecutor(ex, space.paths)
    q = dom.queries[1]
    acc, lat, cost = bx.run_block(q)
    for j, p in enumerate(space.paths):
        a, l, c = ex.run(q, p)
        assert (a, l, c) == (acc[j], lat[j], cost[j]), p.key


def test_placed_stream_parity_and_pacing(placed_world):
    dom, space, ex = placed_world
    q = dom.queries[2]
    path = next(p for p in space.paths if p.model.impl == PLACED_IMPL)
    chunks = []
    res = ex.run_stream(q, path, lambda ch: chunks.append(ch) or True)
    assert res == ex.run(q, path)  # bit-identical final metrics
    assert sum(c.tokens for c in chunks) == OUT_TOKENS and chunks[-1].final
    plan = get_plan(path.model.param("model"), path.model.param("chain"))
    # chunk timeline paces by the plan's pipelined per-token decode rate
    done = chunks[0].tokens
    assert chunks[0].latency_s == res[1] + plan.decode_latency_s(done)


def test_default_spec_untouched_and_tables_byte_identical():
    spec = with_placements()
    assert PLACED_IMPL in spec["model"]
    assert PLACED_IMPL not in DEFAULT_SPEC["model"]
    assert PLACED_IMPL in with_placements(with_split_models())["model"]

    dom = build_domain("agriculture", n_queries=10, seed=0)
    idx = np.arange(6)
    before = Emulator(dom, PathSpace(), seed=0).explore(idx, budget=2.0)
    # building a placement-extended space must not perturb default tables
    PathSpace(spec=with_placements())
    after = Emulator(dom, PathSpace(), seed=0).explore(idx, budget=2.0)
    assert before.bit_equal(after)
    assert all(p.model.impl != PLACED_IMPL for p in PathSpace().paths)


def test_emulator_sweeps_placed_paths(placed_world):
    dom, space, ex = placed_world
    emu = Emulator(dom, space, seed=0)
    table = emu.explore(np.arange(4), budget=2.0)
    js = [p.pid for p in space.paths if p.model.impl == PLACED_IMPL]
    assert np.asarray(table.evaluated)[:, js].any(), \
        "placed paths never evaluated by the sweep"


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

# every (model, chain, slo latency) the defaults and the reference's tests plan
PLAN_CASES = sorted(
    {(m, c, None) for m in DEFAULT_PLACEMENT_MODELS
     for c in DEFAULT_PLACEMENT_CHAINS}
    | {("gemma-7b", "orin", None), ("gemma-7b", "m1pro", None),
       ("gemma-7b", "orin+m1pro", None), ("gemma-7b", "orin+m1pro+cloud", None),
       ("kimi-k2-cloud", "orin+m4", None),
       ("kimi-k2-cloud", "orin+m4+cloud", None),
       ("internlm2-1.8b", "orin+m4", None),
       ("internlm2-1.8b", "orin+m4+cloud", 2.0)},
    key=str)


@pytest.mark.parametrize("model,chain,max_lat", PLAN_CASES)
def test_get_plan_equals_jax_field_for_field(model, chain, max_lat):
    slo = None if max_lat is None else SLO(max_latency_s=max_lat)
    jslo = None if max_lat is None else JaxSLO(max_latency_s=max_lat)
    got = get_plan(model, chain, slo=slo)
    want = jax_placement.get_plan(model, chain, slo=jslo)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.describe() == want.describe()
    for tokens in (None, 96, 768):
        assert simulate_pipeline(got, tokens) == \
            jax_placement.simulate_pipeline(want, tokens)


@pytest.mark.parametrize("chain", [("orin",), ("m4",), ("orin", "m4"),
                                   ("m4", "cloud"), ("orin", "m4", "cloud")])
def test_search_placement_equals_jax_on_small_configs(chain):
    for fields in (("tiny-dense", "dense", 8, 256, 4, 4, 1024, 1000),
                   ("tiny-1l", "dense", 1, 256, 4, 4, 1024, 1000)):
        got = search_placement(ModelConfig(*fields), chain)
        want = jax_placement.search_placement(JaxModelConfig(*fields), chain)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cost_model_equals_jax(arch, monkeypatch):
    # the JAX count traces the whole init (seconds for the MoE archs), and
    # the cost model asks for it four times a shape: count once
    count = JaxModelConfig.param_count(jax_get_config(arch))
    monkeypatch.setattr(JaxModelConfig, "param_count", lambda self: count)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in SHAPE_SUITE.items():
        got = cost_model.cell_cost(cfg, shape)
        want = jax_cost.cell_cost(jcfg, JAX_SHAPES[name])
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        S = shape.seq_len
        assert [dataclasses.asdict(c)
                for c in cost_model.model_layer_costs(cfg, S)] == \
            [dataclasses.asdict(c) for c in jax_cost.model_layer_costs(jcfg, S)]
    assert cost_model.embed_head_bytes(cfg) == jax_cost.embed_head_bytes(jcfg)
    assert cost_model.head_flops_per_token(cfg) == \
        jax_cost.head_flops_per_token(jcfg)
    assert cost_model.activation_bytes(cfg, 7) == \
        jax_cost.activation_bytes(jcfg, 7)


def test_link_model_equals_jax():
    for a, b in ((cost_model.LAN_LINK, jax_cost.LAN_LINK),
                 (cost_model.WAN_LINK, jax_cost.WAN_LINK)):
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
        for nbytes in (0.0, 4096.0, 3.5e9):
            assert cost_model.transfer_time_s(a, nbytes) == \
                jax_cost.transfer_time_s(b, nbytes)


def test_placed_space_serves_like_jax():
    """``build_server(..., placements=True)`` on both packages, the JAX
    server's trained encoder carried across: the same placement-extended
    table, and every held-out request, served one at a time, answered with
    the same path and the same emulated outcome."""
    jserver, jtest = jax_build_server("agriculture", n_queries=24,
                                      budget=2.0, seed=0, placements=True)
    jsel = jserver.rps
    dom = build_domain("agriculture", n_queries=24, seed=0)
    space = PathSpace(spec=with_placements())
    train_idx, test_idx = train_test_split(dom, 0.3)
    emu = Emulator(dom, space, seed=0)
    table = emu.explore(train_idx, budget=2.0, lam=0)
    assert table.bit_equal(jsel.table)
    rps = RuntimePathSelector(
        space, DSQE.from_numpy(jsel.dsqe.params, jsel.dsqe.n_sets,
                               device="cpu"),
        critical_component_analysis(table, lam=0), table,
        dom.query_embeddings[train_idx], lam=0)
    server = EcoLLMServer(dom, rps, emu.exec, n_replicas=1)
    np.testing.assert_array_equal(test_idx, jtest)
    assert sum(p.model.impl == PLACED_IMPL for p in table.paths) > 0
    slo_args = ({}, {"max_latency_s": 2.0, "max_cost_usd": 0.004},
                {"max_latency_s": 1e-6, "max_cost_usd": 0.0})
    try:
        for i, q in enumerate(test_idx):
            a = slo_args[i % 3]
            g = server.handle(Request(prompt="", qid=int(q), slo=SLO(**a)))
            w = jserver.handle(JaxRequest(prompt="", qid=int(q),
                                          slo=JaxSLO(**a)))
            assert (g.path_key, g.accuracy, g.latency_s, g.cost_usd,
                    g.meta["set_id"], g.meta["fallback"]) == \
                (w.path_key, w.accuracy, w.latency_s, w.cost_usd,
                 w.meta["set_id"], w.meta["fallback"])
    finally:
        server.fleet.close()
        jserver.fleet.close()
