"""Port serving path (``repro_torch.runtime.server``, ``repro_torch.launch.serve``)
against the JAX package, on the CPU.

With the JAX server's trained DSQE carried across, the port's
``EcoLLMServer.handle_batch`` answers every request with the same path and
the same emulated outcome as the JAX server's, and so does its
one-request ``handle`` on the numpy engine.
"""
import numpy as np
import pytest
import torch

from carried_server import carried_servers
from repro.runtime.server import Request as JaxRequest
from repro.core.slo import SLO as JaxSLO
from repro_torch.core.paths import PathSpace
from repro_torch.core.slo import SLO
from repro_torch.launch import serve
from repro_torch.runtime.server import Request

SLO_ARGS = [{}, {"max_latency_s": 2.0, "max_cost_usd": 0.004},
            {"max_latency_s": 1e-6, "max_cost_usd": 0.0},
            {"max_latency_s": 4.0, "max_cost_usd": 0.008}]

# several xdist workers share the CPU cores: torch's default of one thread
# per core in every worker oversubscribes them and stalls every test
torch.set_num_threads(1)


def test_handle_batch_answers_like_the_jax_server():
    jserver, server, test = carried_servers(use_kernel=True)
    slo_args = [SLO_ARGS[i % 4] for i in range(len(test))]
    want = jserver.handle_batch([JaxRequest(prompt="", qid=q, slo=JaxSLO(**a))
                                 for q, a in zip(test, slo_args)])
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


def test_handle_answers_like_the_jax_server_one_request_at_a_time():
    """``handle`` dispatches each request as a bucket of one through the
    numpy engine; request by request, the port answers as the JAX server."""
    jserver, server, test = carried_servers()
    for i, q in enumerate(test):
        a = SLO_ARGS[i % 4]
        w = jserver.handle(JaxRequest(prompt="", qid=q, slo=JaxSLO(**a)))
        g = server.handle(Request(prompt="", qid=q, slo=SLO(**a)))
        assert (g.path_key, g.accuracy, g.latency_s, g.cost_usd, g.slo_ok,
                g.meta["fallback"], g.meta["set_id"]) == \
            (w.path_key, w.accuracy, w.latency_s, w.cost_usd, w.slo_ok,
             w.meta["fallback"], w.meta["set_id"])
    state = server.system_state()
    assert state["rps_engine"] == "numpy"
    assert state["requests"] == len(test)


@pytest.mark.parametrize("mode", ["--batch", "--async", "--tenants 4 --async",
                                  "--adapt --async", "--placements --batch"])
def test_main_serves_every_held_out_query(mode, capsys):
    serve.main(["--domain", "agriculture", "--queries", "40", "--budget",
                "3", "--use-kernel", "--device", "cpu", *mode.split()])
    out = capsys.readouterr().out
    assert "agriculture: served 12/12 queries" in out
    assert "'rps_engine': 'kernel'" in out
    if "--tenants" in mode:
        assert "router: 2 shards, 4 tenants (zipf 1.1), shed 0" in out
    if "--adapt" in mode:
        assert "adaptation    0 table swap(s)" in out
    if "--placements" in mode:
        assert "gemma-7b@orin+m4: m4[0:28]" in out


def test_repl_answers_each_prompt_line(capsys, monkeypatch):
    import io

    monkeypatch.setattr("sys.stdin", io.StringIO(
        "how do I rotate the crops\nwhen should I irrigate\n\n"))
    serve.main(["--domain", "agriculture", "--queries", "40", "--budget",
                "3", "--device", "cpu", "--repl", "--adapt"])
    out = capsys.readouterr().out
    assert out.count("  path=") == 2
    assert "system state: " in out and "'admitted': 2" in out


@pytest.mark.parametrize("flag", [["--placements", "--adapt"],
                                  ["--adapt", "--batch"],
                                  ["--tenants", "2"],
                                  ["--repl", "--tenants", "2"]])
def test_unported_flags_raise(flag, capsys):
    """The flags the port once refused run now (above); they raise only
    where the JAX package's entry point refuses them: ``--adapt`` needs the
    async or REPL serving loop, ``--tenants`` the async one."""
    with pytest.raises(SystemExit):
        serve.main(flag + ["--device", "cpu"])
    need = "--adapt requires --async or --repl" if "--adapt" in flag \
        else "--tenants requires --async"
    assert need in capsys.readouterr().err


def test_placed_paths_and_new_families_plan_like_jax(monkeypatch):
    """Placed paths enter the path space, and the xLSTM, encoder-decoder
    and VLM archs, whose plans need the parameter count of the port's init,
    get the JAX package's placement plan field for field."""
    import dataclasses

    from repro.configs import get_config as jax_get_config
    from repro.models.config import ModelConfig as JaxModelConfig
    from repro.runtime.placement import search_placement as jax_search
    from repro_torch.configs import get_config
    from repro_torch.core.paths import PLACED_IMPL, with_placements
    from repro_torch.runtime.placement import search_placement

    assert any(p.model.impl == PLACED_IMPL
               for p in PathSpace(spec=with_placements()).paths)
    jax_count = JaxModelConfig.param_count
    for arch in ("xlstm-125m", "seamless-m4t-medium", "llava-next-34b"):
        jcfg = jax_get_config(arch)
        # the JAX count traces the whole init: count once per arch
        count = jax_count(jcfg)
        monkeypatch.setattr(JaxModelConfig, "param_count",
                            lambda self, n=count: n)
        for chain in (("orin", "cloud"), ("orin", "m4", "cloud")):
            got = search_placement(get_config(arch), chain)
            want = jax_search(jcfg, chain)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_draft_attend_through_decode_attention():
    """``attend(use_kernel=True)`` runs the draft's buffers through the
    port's decode_attention op (its plain version on the CPU): equal to the
    numpy readout and to JAX's decode_attention_ref, at every draft step."""
    import jax.numpy as jnp

    from repro.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.core.paths import MODEL_CATALOG
    from repro_torch.core.splitgen import DraftState

    draft = DraftState(seed=3, qid=11, edge=MODEL_CATALOG["internlm2-1.8b"],
                       n_chunks=5)
    for t in range(5):
        draft.append(t)
        got = draft.attend(use_kernel=True, device="cpu")
        want = np.asarray(decode_attention_ref(
            jnp.asarray(draft._q), jnp.asarray(draft.k_cache),
            jnp.asarray(draft.v_cache), jnp.int32(draft.cache_len)))[0, 0, 0]
        np.testing.assert_allclose(got, draft.attend(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
