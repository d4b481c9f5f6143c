"""Port serving path (``repro_torch.runtime.server``, ``repro_torch.launch.serve``)
against the JAX package, on the CPU.

With the JAX server's trained DSQE carried across, the port's
``EcoLLMServer.handle_batch`` answers every request with the same path and
the same emulated outcome as the JAX server's.
"""
import numpy as np
import pytest
import torch

from repro.launch.serve import build_server as jax_build_server
from repro.runtime.server import Request as JaxRequest
from repro.core.slo import SLO as JaxSLO
from repro_torch.core.cca import critical_component_analysis
from repro_torch.core.domains import build_domain, train_test_split
from repro_torch.core.dsqe import DSQE
from repro_torch.core.emulator import Emulator
from repro_torch.core.paths import PathSpace
from repro_torch.core.rps import RuntimePathSelector
from repro_torch.core.slo import SLO
from repro_torch.launch import serve
from repro_torch.runtime.server import EcoLLMServer, Request

SLO_ARGS = [{}, {"max_latency_s": 2.0, "max_cost_usd": 0.004},
            {"max_latency_s": 1e-6, "max_cost_usd": 0.0},
            {"max_latency_s": 4.0, "max_cost_usd": 0.008}]

# several xdist workers share the CPU cores: torch's default of one thread
# per core in every worker oversubscribes them and stalls every test
torch.set_num_threads(1)


def _port_server_with(dsqe_params, n_sets):
    dom = build_domain("agriculture", n_queries=40, seed=3)
    space = PathSpace()
    train_idx, test_idx = train_test_split(dom, 0.3)
    emu = Emulator(dom, space, seed=3)
    table = emu.explore(train_idx, budget=3.0, lam=0)
    cca = critical_component_analysis(table, lam=0)
    dsqe = DSQE.from_numpy(dsqe_params, n_sets, device="cpu")
    rps = RuntimePathSelector(space, dsqe, cca, table,
                              dom.query_embeddings[train_idx], lam=0,
                              use_kernel=True)
    return EcoLLMServer(dom, rps, emu.exec, n_replicas=2, seed=3), test_idx


def test_handle_batch_answers_like_the_jax_server():
    jserver, jtest = jax_build_server("agriculture", n_queries=40, budget=3.0,
                                      seed=3, use_kernel=True)
    server, test = _port_server_with(jserver.rps.dsqe.params,
                                     jserver.rps.dsqe.n_sets)
    np.testing.assert_array_equal(test, jtest)
    slo_args = [SLO_ARGS[i % 4] for i in range(len(test))]
    want = jserver.handle_batch([JaxRequest(prompt="", qid=q, slo=JaxSLO(**a))
                                 for q, a in zip(jtest, slo_args)])
    got = server.handle_batch([Request(prompt="", qid=q, slo=SLO(**a))
                               for q, a in zip(test, slo_args)])
    assert len(got) == len(test)
    for g, w in zip(got, want):
        assert (g.path_key, g.accuracy, g.latency_s, g.cost_usd, g.slo_ok,
                g.meta["fallback"], g.meta["set_id"]) == \
            (w.path_key, w.accuracy, w.latency_s, w.cost_usd, w.slo_ok,
             w.meta["fallback"], w.meta["set_id"])
    state = server.system_state()
    assert state["rps_engine"] == "kernel"
    assert state["fused_traces"] == 1
    assert state["requests"] == len(test)


@pytest.mark.parametrize("mode", ["--batch", "--async"])
def test_main_serves_every_held_out_query(mode, capsys):
    serve.main(["--domain", "agriculture", "--queries", "40", "--budget",
                "3", "--use-kernel", "--device", "cpu", mode])
    out = capsys.readouterr().out
    assert "agriculture: served 12/12 queries" in out
    assert "'rps_engine': 'kernel'" in out


@pytest.mark.parametrize("flag", [["--placements"], ["--adapt"],
                                  ["--tenants", "2"], ["--repl"]])
def test_unported_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        serve.main(flag + ["--device", "cpu"])


def test_unported_branches_raise():
    from repro_torch.core.paths import with_placements
    from repro_torch.core.splitgen import DraftState

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        PathSpace(spec=with_placements())
    with pytest.raises(NotImplementedError, match="decode_attention"):
        DraftState.__new__(DraftState).attend(use_kernel=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        EcoLLMServer.enable_adaptation(None)
