"""Asyncio-native serving front-end (paper §4: the always-on Runtime).

One ``Orchestrator`` replaces the three parallel blocking entrypoints that
had accreted around the server (``EcoLLMServer.handle``, ``handle_batch``,
``ReplicaFleet.submit_many``): callers ``submit()`` requests with per-request
SLO / priority / deadline and get an awaitable ``Ticket`` back.  A
micro-batching admission loop coalesces concurrent submissions — up to
``max_batch`` tickets or ``max_wait_ms`` after the first, whichever comes
first — and dispatches each bucket as ONE fused
``RuntimePathSelector.select_batch`` pass plus ONE non-blocking
``ReplicaFleet.submit_many_async`` fan-out, so open-world traffic rides the
amortized batch machinery by default instead of opt-in.  With the kernel
engine the whole bucket is handed to the composed
embed -> retrieve -> score -> argmax device program ONCE per admission
bucket (one jit trace per shape bucket — ``stats()['fused_traces']``); only
the rare OOD-fallback rows return to host Python.

Backpressure is explicit: the admission queue is bounded (``max_queue``) and
overflow is rejected immediately with a typed ``Overloaded`` result (load
shedding) instead of queueing without bound; a per-request ``deadline_s``
additionally sheds tickets whose admission deadline lapsed before dispatch.
Higher ``priority`` tickets are admitted first when a backlog forms.

Every ticket carries a lifecycle timeline (``Ticket.events``):
``admitted -> selected -> dispatched -> completed`` (or ``... -> shed``),
stamped with ``time.perf_counter()``.  Selection overheads ride on the
``Decision`` as before — amortized ``overhead_s`` plus the full
``batch_overhead_s`` of the bucket's selection pass.

Streaming contract: a ticket is also an async iterator — ``async for chunk
in ticket`` yields the response's ``GenChunk``s (split-inference drafts or
whole-model decode spans) in order, exactly once, as the fleet delivers
them; ``first_chunk`` lands on the timeline between ``dispatched`` and
``completed`` and ``Ticket.chunk_times`` records per-chunk arrival stamps.
The iterator terminates when the ticket settles (completed, shed, or
failed), so it is safe on non-streaming outcomes too — it just yields
nothing.  Chunks are a single-consumer side channel; ``await ticket`` is
unchanged and bit-for-bit identical to the pre-streaming contract (the
final Response comes from the same non-streamed accounting).

The synchronous ``EcoLLMServer.handle`` / ``handle_batch`` survive as thin
compatibility shims over ``dispatch_sync`` — the same bucket-dispatch
pipeline with the blocking fleet fan-out, bit-for-bit the pre-orchestrator
responses.
"""
from __future__ import annotations

import asyncio
import heapq
import itertools
import threading
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional, Union

import numpy as np

if TYPE_CHECKING:  # circular only for typing: server builds an Orchestrator
    from repro_torch.runtime.server import EcoLLMServer, Request, Response


@dataclass(frozen=True)
class Overloaded:
    """Typed load-shed result: the orchestrator refused this request instead
    of queueing it without bound.  ``reason`` is ``"queue_full"`` (bounded
    admission queue overflowed), ``"deadline"`` (the per-request admission
    deadline lapsed before dispatch), ``"shutdown"``, or ``"stale_loop"``
    (submitted in a previous, now-closed event-loop session — nothing can
    await it anymore)."""

    reason: str
    queue_depth: int
    max_queue: int


_STREAM_END = object()  # chunk-queue terminator (pushed when the ticket settles)


class Ticket:
    """Awaitable handle for one admitted (or shed) request.

    ``await ticket`` / ``await ticket.wait()`` yields the ``Response`` — or
    an ``Overloaded`` marker if the request was shed.  ``events`` is the
    lifecycle timeline: ``[(name, perf_counter_ts), ...]`` through
    ``admitted -> selected -> dispatched -> completed`` (``shed`` replaces
    the tail for rejected tickets; ``failed`` for a bucket whose dispatch
    raised — awaiting the ticket then re-raises that error).

    ``async for chunk in ticket`` consumes the streamed partial results
    (module docstring): ordered, exactly-once, terminated when the ticket
    settles.  The first delivered chunk stamps ``first_chunk`` on the
    timeline; every arrival appends to ``chunk_times``.  Single consumer:
    chunks go to whichever iterator reads them first (a second ``async
    for`` after exhaustion terminates immediately).
    """

    __slots__ = ("request", "priority", "deadline_s", "deadline_at", "events",
                 "chunk_times", "_future", "_chunk_q", "_stream_done")

    def __init__(self, request: "Request", priority: int,
                 deadline_s: Optional[float], future: asyncio.Future):
        self.request = request
        self.priority = priority
        self.deadline_s = deadline_s
        self.deadline_at: Optional[float] = None  # set on admission
        self.events: list[tuple[str, float]] = []
        self.chunk_times: list[float] = []  # perf_counter per chunk arrival
        self._future = future
        self._chunk_q: asyncio.Queue = asyncio.Queue()
        self._stream_done = False

    def mark(self, name: str) -> None:
        self.events.append((name, time.perf_counter()))

    def event(self, name: str) -> Optional[float]:
        """Timestamp of the first occurrence of ``name``, or None."""
        for n, ts in self.events:
            if n == name:
                return ts
        return None

    def done(self) -> bool:
        return self._future.done()

    @property
    def shed(self) -> bool:
        return (self._future.done() and not self._future.cancelled()
                and self._future.exception() is None
                and isinstance(self._future.result(), Overloaded))

    def __await__(self):
        return self._future.__await__()

    async def wait(self) -> Union["Response", Overloaded]:
        return await self._future

    # -- streaming side channel (loop-thread only) --------------------------

    def _on_chunk(self, chunk) -> None:
        """Deliver one streamed chunk (scheduled onto the event loop by the
        orchestrator's fleet-side chunk forwarder)."""
        if self._stream_done:
            return  # settled already (e.g. raced with an error) — drop
        if not self.chunk_times:
            self.mark("first_chunk")
        self.chunk_times.append(time.perf_counter())
        self._chunk_q.put_nowait(chunk)

    def _end_stream(self) -> None:
        """Terminate the chunk iterator; idempotent, called at settle."""
        if not self._stream_done:
            self._stream_done = True
            self._chunk_q.put_nowait(_STREAM_END)

    async def _iter_chunks(self):
        while True:
            item = await self._chunk_q.get()
            if item is _STREAM_END:
                # re-arm the terminator so a later `async for` (or a racing
                # second consumer) terminates instead of hanging forever
                self._chunk_q.put_nowait(_STREAM_END)
                return
            yield item

    def __aiter__(self):
        return self._iter_chunks()


_STOP_PRIO = float("inf")  # sorts after every real ticket in the heap


class Orchestrator:
    """Single async front-end over a trained ``EcoLLMServer``.

    Usage (async)::

        orch = Orchestrator(server, max_batch=32, max_wait_ms=2.0)
        await orch.start()
        ticket = await orch.submit(Request(...), priority=1, deadline_s=0.5)
        response = await ticket            # Response | Overloaded
        await orch.stop()                  # drains admitted tickets first

    or ``async with Orchestrator(server) as orch: ...``.  The synchronous
    ``dispatch_sync`` path (used by the ``handle``/``handle_batch`` shims)
    shares the same one-``select_batch``-one-fan-out pipeline without
    needing a running event loop.
    """

    def __init__(self, server: "EcoLLMServer", *, max_batch: int = 32,
                 max_wait_ms: float = 2.0, max_queue: int = 256,
                 hedge: bool = True, stream: bool = True,
                 shard_id: Optional[int] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.server = server
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.max_queue = max_queue
        self.hedge = hedge
        self.stream = stream  # thread chunk delivery through to tickets
        # multi-tenant serving plane: an orchestrator can be one admission
        # shard of a TenantRouter (runtime/router.py); the id tags its fleet
        # dispatches so the ONE shared fleet attributes load per shard
        self.shard_id = shard_id
        # heap entries: (-priority, seq, ticket) — seq breaks ties FIFO and
        # keeps ticket objects out of the comparison
        self._queue: asyncio.PriorityQueue = asyncio.PriorityQueue(
            maxsize=max_queue)
        # stop sentinels currently enqueued: qsize() minus this is the real
        # backlog (a bare qsize() reported depth 1 on an empty stopping queue)
        self._stop_sentinels = 0
        self._seq = itertools.count()
        self._queue_loop: Optional[asyncio.AbstractEventLoop] = None
        self._task: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._closed = False
        # admission telemetry; completions land from fleet worker threads,
        # shim dispatches from arbitrary caller threads — lock the counters
        self._stats_lock = threading.Lock()
        self.admitted = 0
        self.shed_count = 0
        self.deadline_shed_count = 0
        self.batches = 0
        self.dispatched = 0
        self.completed = 0  # executions that produced a Response
        self.failed = 0     # executions whose await re-raises
        # online adaptation observer (runtime/adaptation.py); None keeps the
        # settle/shed hooks at a single attribute load on the hot path
        self._adaptation = None

    def attach_adaptation(self, plane) -> None:
        """Attach an ``AdaptationPlane`` observer: every settled/shed
        outcome is appended (lock-free ring write, no table access) from
        the ``_note_*`` hooks.  Pass ``None`` to detach."""
        self._adaptation = plane

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> "Orchestrator":
        """Start the micro-batching admission loop on the running loop."""
        if self._task is not None and not self._task.done():
            return self
        self._loop = asyncio.get_running_loop()
        # the asyncio queue loop-binds on its first awaited get(); a fresh
        # loop (a second asyncio.run session against the same orchestrator,
        # e.g. the server-singleton) needs a fresh queue, otherwise the
        # admission task dies instantly on a cross-loop get() and every
        # subsequently submitted ticket hangs forever.  put_nowait/get_nowait
        # are loop-free, so pending entries transfer safely.
        if self._queue_loop is not self._loop:
            # runs on the first start too (_queue_loop None): submits may
            # have happened under an earlier, since-closed loop even if no
            # admission loop ever ran there
            old, self._queue = self._queue, asyncio.PriorityQueue(
                maxsize=self.max_queue)
            while not old.empty():
                entry = old.get_nowait()
                ticket = entry[2]
                if ticket is None:
                    # stale stop sentinel from a torn-down session: carrying
                    # it over would make the fresh admission loop exit as
                    # soon as it drains to it
                    self._stop_sentinels = max(0, self._stop_sentinels - 1)
                    continue
                if ticket._future.get_loop() is not self._loop:
                    # the ticket's future is bound to a previous (dead)
                    # loop: nothing in this session can await it, and
                    # settling it could raise on the closed loop — shed it
                    try:
                        self._shed(ticket, "stale_loop")
                    except RuntimeError:  # dead-loop future had awaiters
                        pass
                    continue
                self._queue.put_nowait(entry)
        self._queue_loop = self._loop
        self._closed = False
        self._task = self._loop.create_task(self._admission_loop())
        return self

    async def stop(self) -> None:
        """Stop the admission loop, dispatching every already-admitted
        ticket first; subsequent submits are shed with reason 'shutdown'.
        Idempotent under concurrency: the task handle is claimed before the
        first suspension point, so racing stop() calls enqueue exactly one
        stop sentinel (a stale second sentinel would make the NEXT session's
        admission loop exit on arrival)."""
        task, self._task = self._task, None
        # flag first: stop() before (or without) start() must still flip the
        # orchestrator to shedding, else later submits enqueue onto a queue
        # with no consumer and hang forever
        self._closed = True
        if task is None:
            return
        if not task.done():
            await self._queue.put((_STOP_PRIO, next(self._seq), None))
            # counted after the put lands; both sides run on the loop
            # thread, so the admission loop can't pop it before this line
            self._stop_sentinels += 1
        await task

    async def __aenter__(self) -> "Orchestrator":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    def reconfigure(self, *, max_batch: Optional[int] = None,
                    max_wait_ms: Optional[float] = None,
                    max_queue: Optional[int] = None,
                    hedge: Optional[bool] = None,
                    stream: Optional[bool] = None) -> "Orchestrator":
        """Change the admission policy while the loop is NOT running (the
        synchronous ``dispatch_sync`` path is policy-free, so a shim-created
        orchestrator can be re-tuned before its first async ``start()``).
        Already-enqueued tickets are carried over; if a smaller ``max_queue``
        cannot hold them the overflow is shed (``queue_full``)."""
        if self._task is not None and not self._task.done():
            raise RuntimeError("cannot reconfigure a running admission loop")
        if max_batch is not None:
            if max_batch < 1:
                raise ValueError("max_batch must be >= 1")
            self.max_batch = max_batch
        if max_wait_ms is not None:
            self.max_wait_s = max_wait_ms / 1e3
        if hedge is not None:
            self.hedge = hedge
        if stream is not None:
            self.stream = stream
        if max_queue is not None and max_queue != self.max_queue:
            self.max_queue = max_queue
            old, self._queue = self._queue, asyncio.PriorityQueue(
                maxsize=max_queue)
            while not old.empty():
                entry = old.get_nowait()
                try:
                    self._queue.put_nowait(entry)
                except asyncio.QueueFull:
                    if entry[2] is not None:
                        self._shed(entry[2], "queue_full")
        return self

    # -- admission -----------------------------------------------------------

    async def submit(self, request: "Request", *, priority: int = 0,
                     deadline_s: Optional[float] = None) -> Ticket:
        """Admit one request; returns immediately with an awaitable Ticket.

        If the bounded admission queue is full (or the orchestrator is
        stopping) the ticket comes back already completed with a typed
        ``Overloaded`` result — explicit load shedding, never unbounded
        queueing.  ``priority`` orders admission under backlog (higher
        first); ``deadline_s`` sheds the ticket if it is still waiting for
        dispatch that many seconds after admission.
        """
        loop = asyncio.get_running_loop()
        ticket = Ticket(request, priority, deadline_s, loop.create_future())
        if self._closed:
            self._shed(ticket, "shutdown")
            return ticket
        try:
            self._queue.put_nowait((-float(priority), next(self._seq), ticket))
        except asyncio.QueueFull:
            # before shedding viable traffic, evict queue entries whose own
            # deadline already lapsed — they are shed either way, and they
            # must not squat on bounded-queue capacity
            if not self._purge_lapsed():
                self._shed(ticket, "queue_full")
                return ticket
            try:
                self._queue.put_nowait(
                    (-float(priority), next(self._seq), ticket))
            except asyncio.QueueFull:  # full of still-viable tickets
                self._shed(ticket, "queue_full")
                return ticket
        ticket.mark("admitted")
        if deadline_s is not None:
            ticket.deadline_at = ticket.events[-1][1] + deadline_s
        with self._stats_lock:
            self.admitted += 1
        # yield once per admission: enqueueing itself never suspends, so a
        # tight submit loop would otherwise starve the admission loop and
        # spuriously shed a closed workload larger than max_queue
        await asyncio.sleep(0)
        return ticket

    def _queue_depth(self) -> int:
        """Real admission backlog: qsize() minus enqueued stop sentinels."""
        return max(0, self._queue.qsize() - self._stop_sentinels)

    def _fail(self, ticket: Ticket, err: Exception) -> None:
        ticket.mark("failed")
        with self._stats_lock:
            self.failed += 1
            self._note_settled(ticket, None, err)
        if not ticket._future.done():
            ticket._future.set_exception(err)
        ticket._end_stream()

    def _shed(self, ticket: Ticket, reason: str) -> None:
        ticket.mark("shed")
        with self._stats_lock:
            self.shed_count += 1
            if reason == "deadline":
                self.deadline_shed_count += 1
            self._note_shed(ticket, reason)
        if not ticket._future.done():
            ticket._future.set_result(
                Overloaded(reason, self._queue_depth(), self.max_queue))
        ticket._end_stream()

    # -- outcome hooks (AdmissionShard overrides add per-tenant accounting
    # and MUST call super() so adaptation observation still fires).  Both
    # run UNDER self._stats_lock so shard counters stay consistent with the
    # aggregate ones they refine; the adaptation observer is a bounded ring
    # append — producers are serialized by this very lock, and the fold work
    # happens on the plane's background thread, never here.

    def _note_shed(self, ticket: Ticket, reason: str) -> None:
        plane = self._adaptation
        if plane is not None:
            plane.observe_shed(self, ticket, reason)

    def _note_settled(self, ticket: Ticket, resp, err) -> None:
        plane = self._adaptation
        if plane is not None:
            plane.observe_settled(self, ticket, resp, err)

    def _purge_lapsed(self) -> int:
        """Shed queued tickets whose admission deadline already lapsed, so
        dead entries stop counting against ``max_queue`` capacity (they were
        previously only shed when popped into a bucket, squatting on slots
        and forcing ``queue_full`` sheds of viable traffic).  Runs on the
        loop thread; rebuilds the underlying heap in place."""
        now = time.perf_counter()
        heap = self._queue._queue

        def lapsed(entry) -> bool:
            t = entry[2]
            return (t is not None and t.deadline_at is not None
                    and now > t.deadline_at)

        dead = [e for e in heap if lapsed(e)]
        if not dead:
            return 0
        keep = [e for e in heap if not lapsed(e)]
        heap.clear()
        heap.extend(keep)
        heapq.heapify(heap)
        # the Queue's unfinished-task counter tracks puts, not the heap; the
        # orchestrator never calls task_done/join, so no rebalance is needed
        for e in dead:
            self._shed(e[2], "deadline")
        return len(dead)

    async def _admission_loop(self) -> None:
        """Accumulate concurrent submissions into buckets and dispatch each
        as one fused selection pass + one fleet fan-out."""
        while True:
            entry = await self._queue.get()
            if entry[2] is None:  # stop sentinel sorts last: queue is drained
                self._stop_sentinels = max(0, self._stop_sentinels - 1)
                return
            bucket = [entry[2]]
            t0 = time.perf_counter()
            stop = False
            while len(bucket) < self.max_batch:
                remaining = self.max_wait_s - (time.perf_counter() - t0)
                if remaining <= 0:
                    break
                try:
                    nxt = await asyncio.wait_for(self._queue.get(), remaining)
                except asyncio.TimeoutError:
                    break  # deadline flush: dispatch the partial bucket
                if nxt[2] is None:
                    self._stop_sentinels = max(0, self._stop_sentinels - 1)
                    stop = True
                    break
                bucket.append(nxt[2])
            now = time.perf_counter()
            live = []
            for t in bucket:
                if t.deadline_at is not None and now > t.deadline_at:
                    self._shed(t, "deadline")
                else:
                    live.append(t)
            if live:
                try:
                    await self._dispatch(live)
                except Exception as e:  # noqa: BLE001 — fail the bucket,
                    # keep admitting: a dead admission loop would hang every
                    # pending ticket forever
                    for t in live:
                        self._fail(t, e)
            if stop:
                return

    # -- dispatch ------------------------------------------------------------

    def _select(self, reqs: list["Request"]):
        """One fused selection pass for a bucket: resolve -> ``select_batch``
        -> (query, path, domain) jobs.  Shared by the async admission loop
        and the synchronous shim path, so both produce identical decisions.

        Single-domain servers take EXACTLY the pre-multi-tenant path (same
        selector, same call); on a multi-domain server the bucket's rows are
        grouped by domain and each group runs through the domain-sharded
        fused program — one traced pass per group with the domain id as a
        carried scalar, no re-trace per tenant/domain."""
        srv = self.server
        resolved = [srv._resolve_query(r) for r in reqs]
        if not srv.is_multi_domain():
            embs = np.stack([emb for _, emb in resolved])
            decisions = srv.rps.select_batch(embs, [r.slo for r in reqs])
        else:
            sharded = srv.sharded_selector()
            groups: dict[str, list[int]] = {}
            for i, r in enumerate(reqs):
                groups.setdefault(srv.canonical_domain(r.domain), []).append(i)
            decisions = [None] * len(reqs)
            for dom, idxs in groups.items():
                embs = np.stack([resolved[i][1] for i in idxs])
                ds = sharded.select_batch(
                    embs, [reqs[i].slo for i in idxs], dom)
                for i, d in zip(idxs, ds):
                    decisions[i] = d
        jobs = [(query, d.path, r.domain or srv.DEFAULT_DOMAIN)
                for (query, _), d, r in zip(resolved, decisions, reqs)]
        return resolved, decisions, jobs

    def _fleet_tag(self) -> Optional[str]:
        """Fleet dispatch-attribution tag: ``shard<i>`` when this
        orchestrator is an admission shard, None (untagged) otherwise."""
        return None if self.shard_id is None else f"shard{self.shard_id}"

    async def _dispatch(self, tickets: list[Ticket]) -> None:
        """Dispatch one bucket without blocking the event loop: selection is
        CPU-bound so it runs on the default executor; the fleet fan-out is
        non-blocking and completes each ticket via callback."""
        reqs = [t.request for t in tickets]
        with self._stats_lock:
            self.batches += 1
            self.dispatched += len(tickets)
        resolved, decisions, jobs = await self._loop.run_in_executor(
            None, self._select, reqs)
        for t in tickets:
            t.mark("selected")
        futures = self.server.fleet.submit_many_async(jobs, hedge=self.hedge,
                                                      stream=self.stream,
                                                      tag=self._fleet_tag())
        for t in tickets:
            t.mark("dispatched")
        for t, (query, _), dec, fut in zip(tickets, resolved, decisions,
                                           futures):
            if self.stream:
                # register the chunk forwarder BEFORE the done callback:
                # call_soon_threadsafe is FIFO per thread, so buffered-chunk
                # replay (inline sequential mode) schedules ahead of settle
                # and `first_chunk` always precedes `completed`
                fut.add_chunk_callback(self._chunk_forwarder(t))
            fut.add_done_callback(self._completer(t, query, dec))

    def _chunk_forwarder(self, ticket: Ticket):
        """Fleet-side chunk callback: hop each chunk onto the loop thread
        (all ticket state is loop-confined)."""
        loop = self._loop

        def fwd(chunk):
            try:
                loop.call_soon_threadsafe(ticket._on_chunk, chunk)
            except RuntimeError:
                pass  # loop closed mid-stream: nothing can consume chunks

        return fwd

    def _completer(self, ticket: Ticket, query, decision):
        """Fleet-side completion callback: build the Response off-loop, then
        settle the ticket's future on the loop thread."""
        srv, loop = self.server, self._loop

        def cb(fut):
            try:
                result, meta = fut.result(0)
                resp = srv._respond(ticket.request, query, decision, result,
                                    meta)
                err = None
            except Exception as e:  # noqa: BLE001 — surfaced on the ticket
                resp, err = None, e

            def record():
                ticket.mark("completed" if err is None else "failed")
                with self._stats_lock:
                    if err is None:
                        self.completed += 1
                    else:
                        self.failed += 1
                    self._note_settled(ticket, resp, err)

            def settle():
                record()
                if not ticket._future.done():
                    if err is not None:
                        ticket._future.set_exception(err)
                    else:
                        ticket._future.set_result(resp)
                ticket._end_stream()

            try:
                loop.call_soon_threadsafe(settle)
            except RuntimeError:
                # the loop already closed (the caller abandoned the session
                # without awaiting this ticket): nothing can observe the
                # future anymore — record the outcome for telemetry and let
                # the fleet worker finish cleanly instead of dying here
                record()

        return cb

    # -- synchronous shim path -----------------------------------------------

    def dispatch_sync(self, reqs) -> list["Response"]:
        """Dispatch one explicit bucket synchronously: the same
        one-``select_batch`` + one-fan-out pipeline as the admission loop,
        but over the blocking ``submit_many`` so callers get responses
        directly.  ``EcoLLMServer.handle`` / ``handle_batch`` are thin
        wrappers over this — a single request is simply a bucket of one."""
        reqs = list(reqs)
        if not reqs:
            return []
        with self._stats_lock:
            self.admitted += len(reqs)
            self.batches += 1
            self.dispatched += len(reqs)
        try:
            resolved, decisions, jobs = self._select(reqs)
            outcomes = self.server.fleet.submit_many(jobs, hedge=self.hedge,
                                                     tag=self._fleet_tag())
        except Exception:
            with self._stats_lock:  # keep completed + failed == dispatched
                self.failed += len(reqs)
            raise
        with self._stats_lock:
            self.completed += len(reqs)
        return [self.server._respond(req, query, d, result, meta)
                for req, (query, _), d, (result, meta)
                in zip(reqs, resolved, decisions, outcomes)]

    # -- telemetry -----------------------------------------------------------

    def stats(self) -> dict:
        """Admission counters + queue depth in one consistent observation."""
        with self._stats_lock:
            return {
                "admitted": self.admitted,
                "shed": self.shed_count,
                "deadline_shed": self.deadline_shed_count,
                "batches": self.batches,
                # (re)traces of the fused selection program: bounded by the
                # distinct shape buckets seen, 0 for the numpy engine (or a
                # serverless orchestrator, e.g. shed-path unit tests)
                "fused_traces": getattr(
                    getattr(self.server, "rps", None),
                    "kernel_trace_count", 0),
                "dispatched": self.dispatched,
                "completed": self.completed,
                "failed": self.failed,
                "queue_depth": self._queue_depth(),
                "max_batch": self.max_batch,
                "max_queue": self.max_queue,
                "shard_id": self.shard_id,
            }

    def adaptation_state(self) -> Optional[dict]:
        """This orchestrator's (shard's) adaptation-plane telemetry, or
        None when no plane is attached."""
        plane = self._adaptation
        return None if plane is None else plane.shard_state(self)
