"""Streaming delivery of the port (``repro_torch.runtime.fleet`` /
``orchestrator``, ``repro_torch.core.splitgen``), case by case with
``tests/test_streaming.py``, and against the JAX package.

Each case runs the reference case's assertions on the port.  Deterministic
results must also equal the JAX package's on the same seeds and catalog
entries: ``generate_split``'s ``SplitResult`` and chunk list field for
field (the cancellation after 2 chunks included), the draft's KV buffers
and readout, executor streams, the sequential fleet's chunk logs, and the
served responses and chunk timelines on a DSQE carried from the JAX
package (``tests/carried_server.py``).  Hedges, straggles and deadlines
depend on threads and clocks: those cases hold the reference case's own
assertions only.
"""
import asyncio
import dataclasses
import random
import time
from collections import defaultdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carried_server import carried_servers
from repro.core.devices import EDGE_DEVICES as JAX_EDGE_DEVICES
from repro.core.paths import MODEL_CATALOG as JAX_CATALOG
from repro.core.splitgen import DraftState as JaxDraftState
from repro.core.splitgen import generate_split as jax_generate_split
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro.runtime.fleet import Replica as JaxReplica
from repro.runtime.fleet import ReplicaFleet as JaxReplicaFleet
from repro.runtime.orchestrator import Orchestrator as JaxOrchestrator
from repro.runtime.server import Request as JaxRequest
from repro_torch.core.devices import EDGE_DEVICES
from repro_torch.core.paths import MODEL_CATALOG, SPLIT_IMPL
from repro_torch.core.splitgen import DraftState, generate_split
from repro_torch.runtime.fleet import Replica, ReplicaFleet
from repro_torch.runtime.orchestrator import Orchestrator, Overloaded
from repro_torch.runtime.server import Request

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def served():
    # split=True: the path space (and thus the trained RPS) includes the
    # CE-CoLLM edge-draft/cloud-verify configurations
    jserver, server, test_idx = carried_servers(
        "smarthome", n_queries=30, budget=2.0, seed=1, split=True)
    yield server, test_idx, jserver
    server.fleet.close()
    jserver.fleet.close()


def _fields(x):
    return dataclasses.astuple(x)


def _resp(r):
    return (r.path_key, r.accuracy, r.latency_s, r.cost_usd)


def _quiesce(fleet, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        snap = fleet.snapshot()
        if snap["in_flight"] == 0 and snap["queue_depth"] == 0:
            return snap
        time.sleep(0.002)
    raise AssertionError("fleet did not quiesce")


# -- satellite: Replica.call straggle accounting -----------------------------


def test_straggle_latency_not_double_counted():
    """Regression: modeled latency is wall + only the UN-slept remainder of
    the injected straggle (the same expression as the JAX package's)."""
    rep = Replica(rid=0, execute=lambda job: "ok",
                  straggle_rate=1.0, straggle_s=0.5)
    out, lat = rep.call("job", random.Random(0))
    assert out == "ok"
    wall = rep.stats.wall_latencies[-1]
    assert rep.stats.latencies[-1] == lat
    assert lat == wall + (0.5 - 0.05)  # exact: same float expression
    assert wall < 0.25  # only the bounded 50 ms sleep was real
    jrep = JaxReplica(rid=0, execute=lambda job: "ok",
                      straggle_rate=1.0, straggle_s=0.5)
    jout, jlat = jrep.call("job", random.Random(0))
    assert jout == out
    assert jlat == jrep.stats.wall_latencies[-1] + (0.5 - 0.05)


# -- fleet streaming: ownership, exactly-once, cancellation ------------------


def _streaming_fleet(n_chunks=3, chunk_delay=0.0, log=None, pkg="port", **kw):
    """Two replicas; rid 0 straggles before its stream starts (the bounded
    50 ms sleep happens in ``Replica.call`` ahead of ``execute_stream``)."""
    replica_cls, fleet_cls = ((Replica, ReplicaFleet) if pkg == "port"
                              else (JaxReplica, JaxReplicaFleet))

    def make(rid):
        def execute(job):
            return ("full", job)

        def execute_stream(job, emit):
            for i in range(n_chunks):
                ok = emit((rid, i))
                if log is not None:
                    log.append((rid, i, ok))
                if not ok:
                    return None  # torn down: a rival owns the stream
                if chunk_delay:
                    time.sleep(chunk_delay)
            return ("full", job)

        return replica_cls(rid=rid, execute=execute,
                           execute_stream=execute_stream,
                           straggle_rate=1.0 if rid == 0 else 0.0,
                           straggle_s=1.0)
    return fleet_cls(make, n=2, seed=2, **kw)


def test_hedged_stream_delivers_chunks_exactly_once_in_order():
    """A straggling primary gets a hedge duplicate; whoever emits first owns
    the stream, every subscriber sees each chunk exactly once and in order,
    and the loser is cancelled with exact counter accounting (retried until
    a hedge fired, as the reference case does)."""
    for _ in range(10):
        log = []
        fleet = _streaming_fleet(log=log)
        fleet.replicas[0].straggle_rate = 0.0
        for _ in range(24):
            fleet.submit("warm")
        fleet.replicas[0].straggle_rate = 1.0

        got = defaultdict(list)
        futs = fleet.submit_many_async([f"j{i}" for i in range(6)],
                                       stream=True)
        for i, fut in enumerate(futs):
            fut.add_chunk_callback(lambda c, i=i: got[i].append(c))
        outs = [fut.result(timeout=10.0) for fut in futs]
        snap = _quiesce(fleet)
        if any(m["hedges"] for _, m in outs):
            break
        fleet.close()  # everything landed on the fast replica: re-roll
    else:
        raise AssertionError("no hedge fired in 10 attempts")
    for i, (out, meta) in enumerate(outs):
        assert out == ("full", f"j{i}")
        chunks = got[i]
        assert [c[1] for c in chunks] == [0, 1, 2]
        assert {c[0] for c in chunks} == {meta["replica"]}
        assert meta["chunks"] == 3
        assert futs[i].chunks() == chunks  # snapshot matches live delivery
    refused = [(rid, i) for rid, i, ok in log if not ok]
    assert all(i == 0 for _, i in refused)
    assert snap["cancelled"] == sum(m["cancelled"] for _, m in outs)
    assert snap["hedges"] == sum(m["hedges"] for _, m in outs)
    fleet.close()


def test_midstream_duplicate_refused_and_accounted():
    """An eviction-driven duplicate lands while the stream is mid-flight:
    first-bytes-wins refuses the rival at its first emit, the flight settles
    with all chunks from one owner, and the loss is accounted through the
    same cancellation counters as a non-streaming race."""
    log = []
    fleet = _streaming_fleet(chunk_delay=0.03, log=log)
    fleet.scale_to(1)  # rid 1 drained: only the straggling rid 0 remains

    (fut,) = fleet.submit_many_async(["job"], stream=True)
    deadline = time.time() + 5.0
    while fleet.in_flight() == 0 and time.time() < deadline:
        time.sleep(0.001)
    assert fleet.in_flight() == 1  # parked in rid 0's pre-stream straggle

    fleet.scale_to(2)  # rid 2 joins; rid 0 then misses its beats
    for _ in range(fleet.max_missed):
        fleet.heartbeat(responding={r.rid for r in fleet.live()} - {0})

    out, meta = fut.result(timeout=10.0)
    snap = _quiesce(fleet)
    assert out == ("full", "job")
    chunks = fut.chunks()
    assert [c[1] for c in chunks] == [0, 1, 2]
    owner = {c[0] for c in chunks}
    assert len(owner) == 1  # one replica streamed every chunk
    assert meta["replica"] in owner and meta["chunks"] == 3
    assert meta["requeues"] == 1 and snap["requeues"] == 1
    refused = [(rid, i) for rid, i, ok in log if not ok]
    assert refused == [(({0, 2} - owner).pop(), 0)]
    assert meta["cancelled"] == 1 and snap["cancelled"] == 1
    fleet.close()


def _sequential_streams(pkg):
    fleet = _streaming_fleet(max_workers=1, pkg=pkg)
    fleet.replicas[0].straggle_rate = 0.0
    futs = fleet.submit_many_async(["a", "b"], stream=True)
    assert all(f.done() for f in futs)
    runs = []
    for fut in futs:
        out, meta = fut.result(0)
        replayed = []
        fut.add_chunk_callback(replayed.append)
        runs.append((out, {k: v for k, v in meta.items() if k != "latency_s"},
                     fut.chunks(), replayed))
    (fut,) = fleet.submit_many_async(["c"], stream=False)
    plain = (fut.result(0)[0], fut.chunks())
    fleet.close()
    return runs, plain


def test_sequential_stream_buffers_chunks_for_replay():
    """max_workers=1: futures come back complete with the chunk log already
    buffered; a late subscriber replays it in order.  Non-streaming submits
    on the same replicas still run plain ``execute``; every log, meta and
    result equals the JAX package's."""
    runs, plain = _sequential_streams("port")
    for (out, meta, chunks, replayed), job in zip(runs, ["a", "b"]):
        assert out == ("full", job)
        assert replayed == chunks
        assert [c[1] for c in replayed] == [0, 1, 2]
        assert {c[0] for c in replayed} == {meta["replica"]}
    assert plain == (("full", "c"), [])
    assert (runs, plain) == _sequential_streams("jax")


# -- orchestrator streaming: tickets as async iterators ----------------------


def _await_vs_iterate(server, request_cls, qid):
    async def run():
        orch = server.orchestrator(max_batch=8, max_wait_ms=1.0)
        await orch.start()
        t1 = await orch.submit(request_cls(prompt="", qid=qid))
        r1 = await t1
        t2 = await orch.submit(request_cls(prompt="", qid=qid))
        chunks = [c async for c in t2]
        r2 = await t2
        again = [c async for c in t2]  # exhausted: terminates immediately
        await orch.stop()
        return r1, r2, chunks, again, t1, t2

    return asyncio.run(run())


def test_await_vs_async_for_equivalence(served):
    """``await ticket`` is unchanged by streaming: iterating the chunks and
    awaiting yield the same Response, and the chunk timeline is ordered,
    cumulative, and stamped on the ticket; responses and chunks are the
    JAX server's."""
    server, test_idx, jserver = served
    qid = int(test_idx[0])
    r1, r2, chunks, again, t1, t2 = _await_vs_iterate(server, Request, qid)
    assert _resp(r1) == _resp(r2)
    assert chunks and chunks[-1].final and again == []
    assert [c.index for c in chunks] == list(range(len(chunks)))
    lats = [c.latency_s for c in chunks]
    assert lats == sorted(lats)  # cumulative along the chunk timeline
    assert len(t2.chunk_times) == len(chunks)
    for t in (t1, t2):  # t1 streamed too, even though nobody iterated it
        names = [n for n, _ in t.events]
        assert names.index("dispatched") < names.index("first_chunk") \
            < names.index("completed")
        stamps = [ts for _, ts in t.events]
        assert stamps == sorted(stamps)
    jr1, _, jchunks, _, _, _ = _await_vs_iterate(jserver, JaxRequest, qid)
    assert _resp(r1) == _resp(jr1)
    assert [_fields(c) for c in chunks] == [_fields(c) for c in jchunks]


def _stream_on_off(server, request_cls, qid):
    async def run(stream):
        orch = server.orchestrator(stream=stream)
        await orch.start()
        t = await orch.submit(request_cls(prompt="", qid=qid))
        r = await t
        chunks = [c async for c in t]
        await orch.stop()
        return r, chunks, t

    on, off = asyncio.run(run(True)), asyncio.run(run(False))
    server.orchestrator(stream=True)  # restore the module fixture's default
    return on, off


def test_stream_off_preserves_response_and_skips_chunk_machinery(served):
    server, test_idx, jserver = served
    qid = int(test_idx[0])
    (r_on, chunks_on, _), (r_off, chunks_off, t_off) = _stream_on_off(
        server, Request, qid)
    assert chunks_on and chunks_off == []
    assert t_off.event("first_chunk") is None
    # the final Response does not depend on whether chunks were delivered
    assert _resp(r_on) == _resp(r_off)
    (jr_on, jchunks, _), _ = _stream_on_off(jserver, JaxRequest, qid)
    assert _resp(r_on) == _resp(jr_on)
    assert [_fields(c) for c in chunks_on] == [_fields(c) for c in jchunks]


# -- satellite: stop sentinels must not inflate queue depth ------------------


def _stop_then_submit(orch_cls):
    async def run():
        orch = orch_cls(None, max_queue=4)
        await orch.start()
        assert orch.stats()["queue_depth"] == 0
        stopper = asyncio.create_task(orch.stop())
        await asyncio.sleep(0)  # stop() has enqueued its sentinel by now
        d_stopping = orch.stats()["queue_depth"]
        await stopper
        d_stopped = orch.stats()["queue_depth"]
        late = await orch.submit("late")
        return d_stopping, d_stopped, await late

    return asyncio.run(run())


def test_stop_sentinel_not_counted_in_queue_depth():
    d_stopping, d_stopped, shed = _stop_then_submit(Orchestrator)
    # the enqueued sentinel is not backlog — before the fix this read 1
    assert d_stopping == 0 and d_stopped == 0
    assert isinstance(shed, Overloaded) and shed.reason == "shutdown"
    assert shed.queue_depth == 0  # Overloaded carries the corrected depth
    jd_stopping, jd_stopped, jshed = _stop_then_submit(JaxOrchestrator)
    assert (d_stopping, d_stopped, _fields(shed)) == \
        (jd_stopping, jd_stopped, _fields(jshed))


# -- satellite: deadline-lapsed tickets must not squat on queue capacity -----


def test_full_queue_of_expired_tickets_admits_fresh_traffic():
    async def run():
        orch = Orchestrator(None, max_queue=4)  # loop not started: no drain
        stale = [await orch.submit(f"s{i}", deadline_s=0.005)
                 for i in range(4)]
        assert not any(t.done() for t in stale)  # queue now full of them
        await asyncio.sleep(0.02)  # every queued deadline lapses
        fresh = await orch.submit("fresh")
        outcomes = [await t for t in stale]
        return orch, outcomes, fresh

    orch, outcomes, fresh = asyncio.run(run())
    assert all(isinstance(o, Overloaded) and o.reason == "deadline"
               for o in outcomes)
    assert not fresh.done()
    assert [n for n, _ in fresh.events] == ["admitted"]
    stats = orch.stats()
    assert stats["admitted"] == 5 and stats["shed"] == 4
    assert stats["deadline_shed"] == 4 and stats["queue_depth"] == 1


def _overflow(orch_cls):
    async def run():
        orch = orch_cls(None, max_queue=2)
        for i in range(2):
            await orch.submit(f"v{i}")  # no deadline: nothing purgeable
        return await (await orch.submit("overflow"))

    return asyncio.run(run())


def test_full_queue_of_viable_tickets_still_sheds_overflow():
    shed = _overflow(Orchestrator)
    assert isinstance(shed, Overloaded) and shed.reason == "queue_full"
    assert _fields(shed) == _fields(_overflow(JaxOrchestrator))


# -- split inference: DraftState layout parity + deterministic traces --------


def test_draftstate_matches_decode_attention_oracle():
    """The draft KV cache is in the kernel's exact ``(B, W, Kv, hd)`` layout:
    the port's buffers and numpy readout equal the JAX draft's bit for bit,
    and the readout, JAX's oracle and the port's decode_attention op (its
    plain version here) agree at every incremental cache length."""
    ds = DraftState(seed=0, qid=3, edge=MODEL_CATALOG["internlm2-1.8b"],
                    n_chunks=5)
    jds = JaxDraftState(seed=0, qid=3, edge=JAX_CATALOG["internlm2-1.8b"],
                        n_chunks=5)
    for t in range(5):
        ds.append(t)
        jds.append(t)
        for a, b in ((ds._q, jds._q), (ds.k_cache, jds.k_cache),
                     (ds.v_cache, jds.v_cache)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert ds.cache_len == jds.cache_len
        o_np = ds.attend()
        assert np.array_equal(o_np.view(np.uint32),
                              jds.attend().view(np.uint32))
        o_ref = np.asarray(decode_attention_ref(
            jnp.asarray(ds._q), jnp.asarray(ds.k_cache),
            jnp.asarray(ds.v_cache), jnp.int32(ds.cache_len)))[0, 0, 0]
        np.testing.assert_allclose(o_np, o_ref, atol=1e-6)
        o_kernel = ds.attend(use_kernel=True, device="cpu")
        np.testing.assert_allclose(o_np, o_kernel, atol=1e-6)
    with pytest.raises(ValueError, match="out of order"):
        ds.append(7)


def _split_runs(gen, catalog, devices):
    common = dict(seed=3, qid=7, complexity=0.6,
                  edge=catalog["recurrentgemma-2b"],
                  cloud=catalog["kimi-k2-cloud"], tau=0.6,
                  device=devices["m4"], prompt_tokens=400,
                  out_tokens=150, grounding=0.3,
                  start_latency_s=0.1, start_cost_usd=0.001)
    chunks = []
    r = gen(**common, emit=lambda c: chunks.append(c) or True)
    silent = gen(**common)
    got = []
    r_c = gen(**common, emit=lambda c: got.append(c) or len(got) < 2)
    return r, silent, chunks, r_c, got


def test_generate_split_deterministic_stream_and_cancellation():
    r, silent, chunks, r_c, got = _split_runs(generate_split, MODEL_CATALOG,
                                              EDGE_DEVICES)
    assert silent == r  # emit cannot perturb the trace
    assert not r.cancelled and r.n_chunks == len(chunks) == 5
    assert [c.index for c in chunks] == list(range(5))
    assert sum(c.tokens for c in chunks) == 150 and chunks[-1].final
    assert {c.source for c in chunks} <= {"edge", "cloud"}
    assert sum(c.tokens for c in chunks if c.source == "cloud") \
        == r.cloud_tokens
    for a, b in zip(chunks, chunks[1:]):  # cumulative timeline
        assert b.latency_s >= a.latency_s and b.cost_usd >= a.cost_usd
    assert chunks[-1].cost_usd == r.cost_usd
    assert r_c.cancelled and len(got) == 2
    assert got == chunks[:2]  # identical spans up to the teardown
    assert r_c.cost_usd == got[-1].cost_usd  # only generated spans billed

    want = _split_runs(jax_generate_split, JAX_CATALOG, JAX_EDGE_DEVICES)
    for a, b in zip((r, silent, r_c), (want[0], want[1], want[3])):
        assert _fields(a) == _fields(b)  # SplitResult field for field
    for a, b in ((chunks, want[2]), (got, want[4])):
        assert [_fields(c) for c in a] == [_fields(c) for c in b]


def test_split_paths_stream_through_executor(served):
    """Split paths ride the resolution-path machinery: ``run_stream`` emits
    edge/cloud spans and settles to the exact ``run`` result; whole-model
    paths stream decode spans with the same bit-for-bit settlement; every
    result and span equals the JAX executor's."""
    server, _, jserver = served
    space = server.rps.space
    jpaths = {p.key: p for p in jserver.rps.space.paths}
    split_paths = [p for p in space.paths if p.model.impl == SPLIT_IMPL]
    assert split_paths, "split=True server lost its split configurations"
    q, jq = server.domain.queries[5], jserver.domain.queries[5]

    def stream(executor, query, path, gate=lambda c: True):
        chunks = []
        out = executor.run_stream(query, path,
                                  lambda c: chunks.append(c) or gate(c))
        return out, [_fields(c) for c in chunks], chunks

    for path in split_paths[:3]:
        base = server.executor.run(q, path)
        out, fields, chunks = stream(server.executor, q, path)
        assert out == base
        assert chunks[-1].final and sum(c.tokens for c in chunks) == 150
        assert {c.source for c in chunks} <= {"edge", "cloud"}
        assert (out, fields) == stream(jserver.executor, jq,
                                       jpaths[path.key])[:2]

    whole = next(p for p in space.paths if p.model.impl != SPLIT_IMPL)
    base = server.executor.run(q, whole)
    out, fields, chunks = stream(server.executor, q, whole)
    assert out == base
    assert {c.source for c in chunks} == {whole.model.impl}
    assert all(c.confidence == 1.0 for c in chunks)
    assert (out, fields) == stream(jserver.executor, jq, jpaths[whole.key])[:2]

    # mid-stream teardown: the emit gate returns False -> no settlement
    out, fields, got = stream(server.executor, q, split_paths[0],
                              lambda c: False)
    assert out is None and len(got) == 1
    assert (out, fields) == stream(jserver.executor, jq,
                                   jpaths[split_paths[0].key],
                                   lambda c: False)[:2]
