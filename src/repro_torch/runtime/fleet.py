"""Serving fleet: replicas, health, real hedging, elastic scaling.

On a real multi-pod deployment each ``Replica`` wraps a jitted serve step on
a mesh slice; here replicas execute the ECO-LLM pipeline (modeled latency) so
the scheduling logic — the part that must survive thousands of nodes — is
fully exercised:

  * heartbeat-based health: replicas that miss ``max_missed`` beats are
    evicted and their in-flight requests re-queued on surviving replicas
    (node-failure handling).  Failure/heartbeat eviction never drains the
    fleet below one live replica, so a burst of concurrent faults on the
    last member cannot evict it to zero.
  * hedged requests: once a dispatched call has been running longer than the
    hedge deadline — ``hedge_mult`` x the best rolling wall-clock p95 among
    candidate backup replicas, floored at ``hedge_floor_s`` — a duplicate
    fires on a second replica; the first completion wins and the loser is
    cancelled (dropped from the queue if it never started, discarded on
    arrival otherwise; Dean & Barroso tail-at-scale style).
  * elastic scaling: ``scale_to(n)`` adds/removes replicas; drained members
    hand their queued and in-flight work back to the dispatcher, so resizes
    are hitless.

``submit_many`` fans a batch out across live replicas: each replica owns a
work deque served by up to ``per_replica_concurrency`` pool workers that
drain their own deque first and steal the tail of the longest other deque
when idle, so batch wall-clock tracks the slowest replica instead of the sum
over all calls.  ``submit_many_async`` is the non-blocking variant: it
returns ``FleetFuture`` handles immediately and pushes completion through
callbacks (a background monitor thread covers hedging/orphan rescue), so an
asyncio front-end never parks a thread per request.  With ``max_workers=1``
the fleet degrades to the deterministic sequential dispatcher (bit-for-bit
the pre-threaded behaviour, including its simulated post-hoc hedge
accounting) — the mode the parity tests pin.

Streaming contract (``submit_many_async(..., stream=True)``): replicas with
an ``execute_stream`` deliver partial results through
``FleetFuture.add_chunk_callback`` — in order, exactly once, buffered chunks
replayed to late subscribers under the flight lock.  Ownership is
first-bytes-wins: the first replica to emit a chunk claims the stream
(``_Flight.stream_owner``); a hedged/requeued duplicate that emits later is
refused at its first chunk and stops drafting, and a duplicate that runs to
completion is discarded on arrival — either way it is accounted through the
same cancellation counters as a lost non-streaming race (fleet
``cancelled_count`` == sum of per-flight ``meta["cancelled"]``, exact at
quiescence).  A flight whose stream is already owned is never hedged (a
backup could not win) and never requeued by eviction (delivered chunks
cannot be replayed; the owning thread still settles it).

Accounting is exact under concurrency: every hedge/failover/requeue/cancel
increments the fleet counter and the per-flight counter inside the same
critical section, so ``sum(meta[...]) == fleet counter`` always holds.
"""
from __future__ import annotations

import random
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Optional

LAT_WINDOW = 512  # bounded stats window: unbounded lists leaked memory


@dataclass
class ReplicaStats:
    calls: int = 0
    hedges: int = 0
    failures: int = 0
    # rolling windows; `latencies` keeps the modeled (nominal) latency the
    # old list carried, `wall_latencies` the real wall-clock used for hedging
    latencies: deque = field(default_factory=lambda: deque(maxlen=LAT_WINDOW))
    wall_latencies: deque = field(
        default_factory=lambda: deque(maxlen=LAT_WINDOW))
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)
    # memoized p95 views, keyed by the record generation: the hedge monitor
    # reads p95_wall on every tick for every candidate replica, and re-sorting
    # the 512-entry window each time put an O(n log n) sort on the hot
    # dispatch path.  `_gen` bumps on every record_success (the only writer
    # of the windows), so a cache entry (gen, value) is valid exactly until
    # the next sample lands.
    _gen: int = field(default=0, repr=False, compare=False)
    _p95_lat_memo: Optional[tuple] = field(default=None, repr=False,
                                           compare=False)
    _p95_wall_memo: Optional[tuple] = field(default=None, repr=False,
                                            compare=False)

    def record_success(self, lat: float, wall: float) -> None:
        with self._lock:
            self.calls += 1
            self.latencies.append(lat)
            self.wall_latencies.append(wall)
            self._gen += 1  # invalidates both p95 memos

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1

    def record_hedge(self) -> None:
        with self._lock:
            self.hedges += 1

    @staticmethod
    def _p95(xs: list, default: float) -> float:
        if len(xs) < 8:
            return default
        xs = sorted(xs[-256:])
        return xs[int(0.95 * (len(xs) - 1))]

    def _p95_memoized(self, window: deque, memo_attr: str,
                      default: float) -> float:
        with self._lock:
            if len(window) < 8:
                # below the warmup floor the caller's per-call default is the
                # answer — never cached (defaults vary between call sites)
                return default
            memo = getattr(self, memo_attr)
            if memo is not None and memo[0] == self._gen:
                return memo[1]
            val = self._p95(list(window), default)
            setattr(self, memo_attr, (self._gen, val))
            return val

    def p95(self, default: float = 0.5) -> float:
        return self._p95_memoized(self.latencies, "_p95_lat_memo", default)

    def p95_wall(self, default: float = 0.5) -> float:
        return self._p95_memoized(self.wall_latencies, "_p95_wall_memo",
                                  default)


@dataclass
class Replica:
    rid: int
    execute: Callable  # (request) -> result; may raise / stall
    healthy: bool = True
    missed_beats: int = 0
    stats: ReplicaStats = field(default_factory=ReplicaStats)
    # fault injection knobs (tests)
    fail_rate: float = 0.0
    straggle_rate: float = 0.0
    straggle_s: float = 0.5
    # streaming variant: (request, emit) -> result | None (None == torn down
    # mid-stream by the emit callback); optional — replicas without it serve
    # streamed flights as a single final result
    execute_stream: Optional[Callable] = None

    def call(self, request, rng: random.Random, emit: Optional[Callable] = None):
        t0 = time.perf_counter()
        if rng.random() < self.fail_rate:
            self.stats.record_failure()
            raise RuntimeError(f"replica {self.rid} failed")
        extra = self.straggle_s if rng.random() < self.straggle_rate else 0.0
        slept = 0.0
        if extra:
            slept = min(extra, 0.05)  # bounded real sleep in tests
            time.sleep(slept)
        if emit is not None and self.execute_stream is not None:
            out = self.execute_stream(request, emit)
        else:
            out = self.execute(request)
        wall = time.perf_counter() - t0
        # modeled latency = real wall + only the UN-slept remainder of the
        # injected straggle: the slept part is already inside `wall`, so
        # adding `extra` whole double-counted it and inflated the rolling
        # p95 that hedge deadlines derive from
        lat = wall + (extra - slept)
        self.stats.record_success(lat, wall)
        return out, lat


class _Flight:
    """One logical request tracked through dispatch, failover, hedging and
    eviction re-queues.  ``lock`` guards all mutable state; the completion
    flag flips exactly once (first finisher wins), so a request can neither
    be lost nor double-delivered.  Streamed flights additionally track the
    owning replica (first-bytes-wins) and the ordered chunk log — delivery
    to chunk callbacks happens under ``lock``, so subscribers observe every
    chunk exactly once and in order."""

    __slots__ = ("request", "hedge_allowed", "lock", "done", "result", "meta",
                 "error", "failures", "hedges", "requeues",
                 "tried_failed", "active", "completed", "claims", "callbacks",
                 "stream", "stream_owner", "chunks", "chunk_cbs", "cancelled")

    def __init__(self, request, hedge_allowed: bool, stream: bool = False):
        self.request = request
        self.hedge_allowed = hedge_allowed
        self.lock = threading.Lock()
        self.done = threading.Event()
        # zero-arg completion thunks; None once fired (exactly-once contract)
        self.callbacks: Optional[list] = []
        self.result = None
        self.meta: Optional[dict] = None
        self.error: Optional[Exception] = None
        self.failures = 0        # executions that raised
        self.hedges = 0          # hedge duplicates dispatched
        self.requeues = 0        # eviction-driven duplicates dispatched
        self.cancelled = 0       # duplicate executions discarded (this flight)
        self.tried_failed: set[int] = set()   # rids that failed this flight
        self.active: dict[int, float] = {}    # rid -> start wall time
        self.completed = False
        self.stream = stream
        self.stream_owner: Optional[int] = None  # rid holding first-bytes-wins
        self.chunks: list = []                   # ordered delivered chunks
        self.chunk_cbs: list = []                # chunk subscribers
        # copies popped from a queue but not yet registered as executing;
        # covers the hand-off window so the orphan rescue can't double-
        # dispatch a flight that a worker is about to start (guarded by
        # the fleet lock)
        self.claims = 0


class FleetFuture:
    """Completion handle for one flight — the non-blocking half of
    ``submit_many_async``.  ``result()`` blocks like ``submit`` would;
    ``add_done_callback`` pushes completion instead, so an async front-end
    can track thousands of flights without parking a thread on each."""

    __slots__ = ("_flight",)

    def __init__(self, flight: _Flight):
        self._flight = flight

    def done(self) -> bool:
        return self._flight.done.is_set()

    def result(self, timeout: Optional[float] = None):
        """(result, meta) of the winning execution; raises like ``submit``."""
        if not self._flight.done.wait(timeout):
            raise TimeoutError("flight still pending")
        f = self._flight
        if f.error is not None:
            raise RuntimeError(f"request failed after retries: {f.error!r}")
        return f.result, f.meta

    def add_done_callback(self, fn: Callable[["FleetFuture"], None]) -> None:
        """``fn(self)`` fires exactly once on completion — immediately if the
        flight already finished, otherwise from the thread that finishes it
        (possibly while fleet locks are held).  Callbacks must be fast and
        must not call back into the fleet; hand real work to an event loop
        (e.g. ``call_soon_threadsafe``)."""
        f = self._flight
        fire = False
        with f.lock:
            if f.callbacks is None:
                fire = True
            else:
                f.callbacks.append(lambda: fn(self))
        if fire:
            fn(self)

    def add_chunk_callback(self, fn: Callable) -> None:
        """Subscribe to streamed partial results: ``fn(chunk)`` per chunk,
        in order, exactly once.  Chunks delivered before subscription are
        replayed first (under the flight lock, so the replay and the live
        tail cannot interleave or duplicate).  Same discipline as done
        callbacks: be fast, don't call back into the fleet."""
        f = self._flight
        with f.lock:
            for chunk in f.chunks:
                fn(chunk)
            f.chunk_cbs.append(fn)

    def chunks(self) -> list:
        """Snapshot of the chunks delivered so far (ordered)."""
        f = self._flight
        with f.lock:
            return list(f.chunks)


class ReplicaFleet:
    """Elastic replica pool with a concurrent, hedging dispatcher.

    Lock discipline: ``self._lock`` (fleet state: replicas, queues, counters)
    is always acquired *before* a flight's ``lock``; never the reverse.
    """

    def __init__(self, make_replica: Callable[[int], Replica], n: int = 2,
                 max_missed: int = 3, seed: int = 0,
                 max_workers: Optional[int] = None,
                 per_replica_concurrency: int = 2, max_attempts: int = 4,
                 max_hedges: int = 1, hedge_floor_s: float = 0.02,
                 hedge_mult: float = 2.0, hedge_cold_s: float = 0.5):
        self._make = make_replica
        self.replicas: dict[int, Replica] = {}
        self._next_id = 0
        self.max_missed = max_missed
        self.rng = random.Random(seed)
        self._lock = threading.Lock()
        self.max_workers = (max_workers if max_workers is not None
                            else min(16, max(4, 2 * n)))
        self.per_replica_concurrency = per_replica_concurrency
        self.max_attempts = max_attempts
        self.max_hedges = max_hedges
        self.hedge_floor_s = hedge_floor_s
        self.hedge_mult = hedge_mult
        self.hedge_cold_s = hedge_cold_s
        self._tick_s = 0.002  # dispatcher monitor granularity

        self.hedge_count = 0
        self.failover_count = 0
        self.requeue_count = 0
        self.cancelled_count = 0
        # per-shard (or any caller-chosen tag) dispatch accounting: admission
        # shards pass ``tag="shard<i>"`` so one shared fleet can attribute
        # load to the shard that fanned it out; folded into ``snapshot()``
        self.dispatched_by_tag: dict[str, int] = {}

        # `replicas` is the full registry and retains evicted members for
        # introspection (their stats windows are bounded); the hot paths
        # below only ever iterate `_live`, and a dead rid's dispatcher state
        # is garbage-collected once its queue, workers and in-flight drain
        self._live: dict[int, Replica] = {}
        self._queues: dict[int, deque] = {}
        self._workers: dict[int, int] = {}          # rid -> active workers
        self._active_by_rid: dict[int, set] = {}    # rid -> executing flights
        self._wake = threading.Event()
        self._pool = (ThreadPoolExecutor(
            max_workers=self.max_workers,
            thread_name_prefix="fleet") if self.max_workers > 1 else None)
        # async flights are monitored (hedge / kick / orphan rescue) by a
        # lazily-started background thread instead of the caller's loop
        self._async_lock = threading.Lock()
        self._async_flights: list[_Flight] = []
        self._monitor: Optional[threading.Thread] = None
        self._monitor_stop = False
        self.scale_to(n)

    # -- elasticity ----------------------------------------------------------

    def scale_to(self, n: int) -> None:
        with self._lock:
            live = list(self._live.values())
            while len(live) < n:
                r = self._make(self._next_id)
                self.replicas[r.rid] = r
                self._live[r.rid] = r
                self._queues.setdefault(r.rid, deque())
                self._workers.setdefault(r.rid, 0)
                self._active_by_rid.setdefault(r.rid, set())
                self._next_id += 1
                live.append(r)
            while len(live) > n:
                victim = live.pop()
                # drain: operator intent, so the last-replica guard is off
                self._evict_locked(victim, force=True)

    def live(self) -> list[Replica]:
        with self._lock:
            return list(self._live.values())

    def queue_depth(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    def in_flight(self) -> int:
        with self._lock:
            return sum(len(s) for s in self._active_by_rid.values())

    def snapshot(self) -> dict:
        """All fleet counters and load gauges under ONE lock acquisition.

        Field-by-field reads (``fleet.hedge_count`` then ``queue_depth()``
        ...) can interleave with completions, so the set of values observed
        may correspond to no single fleet state and the invariant
        ``counters == sum(per-request meta)`` can appear violated.  A
        snapshot is internally consistent by construction.
        """
        with self._lock:
            return {
                "replicas": len(self._live),
                "hedges": self.hedge_count,
                "failovers": self.failover_count,
                "requeues": self.requeue_count,
                "cancelled": self.cancelled_count,
                "queue_depth": sum(len(q) for q in self._queues.values()),
                "in_flight": sum(len(s) for s in self._active_by_rid.values()),
                "dispatched_by_tag": dict(self.dispatched_by_tag),
            }

    def close(self) -> None:
        with self._async_lock:
            self._monitor_stop = True
            mon = self._monitor
        self._wake.set()
        if mon is not None:
            mon.join(timeout=2.0)
        if self._pool is not None:
            self._pool.shutdown(wait=True)

    # -- health ---------------------------------------------------------------

    def heartbeat(self, responding: Optional[set[int]] = None) -> None:
        """One monitor tick; replicas not in ``responding`` accrue a miss.
        Eviction is atomic (under the fleet lock) and re-queues the evicted
        member's outstanding work onto survivors."""
        with self._lock:
            for r in list(self._live.values()):
                if responding is not None and r.rid not in responding:
                    r.missed_beats += 1
                    if r.missed_beats >= self.max_missed:
                        self._evict_locked(r)
                else:
                    r.missed_beats = 0

    def _evict_locked(self, r: Optional[Replica], force: bool = False) -> bool:
        """Mark ``r`` unhealthy and hand its queued + in-flight work back to
        the dispatcher.  Refuses to evict the last live replica unless
        ``force`` (scale-down drain).  Caller holds ``self._lock``."""
        if r is None or not r.healthy:
            return False
        if not force and len(self._live) <= 1:
            return False
        r.healthy = False
        self._live.pop(r.rid, None)
        q = self._queues.get(r.rid)
        stranded = list(q) if q else []
        if q:
            q.clear()
        # duplicate in-flight executions elsewhere; the original thread may
        # still land, in which case first-completion-wins settles it
        for f in list(self._active_by_rid.get(r.rid, ())):
            with f.lock:
                if f.completed or r.rid not in f.active:
                    continue
                if f.stream_owner is not None:
                    # an owned stream cannot be duplicated: chunks already
                    # delivered would be missing from the replay.  The owner
                    # thread keeps running and settles the flight itself
                    # (success or a terminal owner-death failure).
                    continue
                f.requeues += 1
            self.requeue_count += 1
            self._requeue_locked(f, exclude={r.rid} | set(f.tried_failed),
                                 priority=True)
        for f in stranded:
            self._requeue_locked(f, exclude={r.rid}, priority=False)
        self._gc_rid_locked(r.rid)
        return True

    def _gc_rid_locked(self, rid: int) -> None:
        """Drop a dead rid's dispatcher state once its queue, workers and
        in-flight set have drained, so churn (evict + re-provision) doesn't
        grow the hot-path dicts without bound.  ``self.replicas`` keeps the
        evicted Replica itself as an introspection tombstone (its stats
        windows are bounded)."""
        if (rid in self._live or self._queues.get(rid)
                or self._active_by_rid.get(rid)
                or self._workers.get(rid, 0) > 0):
            return
        self._queues.pop(rid, None)
        self._workers.pop(rid, None)
        self._active_by_rid.pop(rid, None)

    # -- dispatch with hedging -------------------------------------------------

    def submit(self, request, hedge: bool = True):
        """Run a request with failover + tail hedging. Returns (result, meta)."""
        if self._pool is None:
            return self._submit_sequential(request, hedge)
        return self._run_flights([_Flight(request, hedge)], hedge)[0]

    def submit_many(self, requests, hedge: bool = True,
                    tag: Optional[str] = None):
        """Dispatch a batch concurrently across the fleet; results keep the
        input order.  ``max_workers=1`` falls back to the deterministic
        sequential loop.  ``tag`` attributes the dispatch to a caller-chosen
        bucket (admission shards use ``shard<i>``) in ``snapshot()``."""
        requests = list(requests)
        self._count_tag(tag, len(requests))
        if self._pool is None:
            return [self._submit_sequential(r, hedge) for r in requests]
        return self._run_flights([_Flight(r, hedge) for r in requests], hedge)

    def _count_tag(self, tag: Optional[str], n: int) -> None:
        if tag is None or n <= 0:
            return
        with self._lock:
            self.dispatched_by_tag[tag] = self.dispatched_by_tag.get(tag, 0) + n

    def submit_many_async(self, requests, hedge: bool = True,
                          stream: bool = False,
                          tag: Optional[str] = None) -> list[FleetFuture]:
        """Non-blocking fan-out: enqueue the batch and return a
        ``FleetFuture`` per request without waiting for any of them.

        Completion is pushed through ``FleetFuture.add_done_callback`` from
        the worker thread that finishes each flight, so an event loop can
        await thousands of flights without a thread parked per request; a
        persistent monitor thread takes over hedging/orphan rescue (the job
        ``_run_flights`` does inline for the blocking entrypoints).  With
        ``stream=True`` replicas exposing ``execute_stream`` push partial
        results through ``FleetFuture.add_chunk_callback`` (module
        docstring: first-bytes-wins ownership, exactly-once delivery).
        With ``max_workers=1`` the deterministic sequential dispatcher runs
        inline and the returned futures are already complete — same RNG
        draw order and accounting as ``submit_many`` (chunks, if streamed,
        are buffered for replay)."""
        requests = list(requests)
        self._count_tag(tag, len(requests))
        if self._pool is None:
            if not self.live():  # match the threaded branch: fail at submit
                raise RuntimeError("no live replicas")
            out = []
            for r in requests:
                f = _Flight(r, hedge, stream)
                emit = self._make_emit(f, rid=-1) if stream else None
                try:
                    f.result, f.meta = self._submit_sequential(r, hedge, emit)
                except Exception as e:  # noqa: BLE001 — surfaced via future
                    # store the ORIGINAL failure (the sequential dispatcher
                    # chains it as __cause__) so FleetFuture.result wraps it
                    # exactly once, same error surface as the threaded path
                    f.error = getattr(e, "__cause__", None) or e
                with f.lock:
                    f.completed = True
                self._finish(f)
                out.append(FleetFuture(f))
            return out
        flights = [_Flight(r, hedge, stream) for r in requests]
        with self._lock:
            if not self._live:
                raise RuntimeError("no live replicas")
            for f in flights:
                self._enqueue_locked(f)
        with self._async_lock:
            self._async_flights.extend(
                f for f in flights if not f.done.is_set())
            self._ensure_monitor_locked()
        self._wake.set()
        return [FleetFuture(f) for f in flights]

    @staticmethod
    def _make_emit(f: _Flight, rid: int) -> Callable:
        """Chunk-emission hook for one (flight, replica) execution.  The
        first emitted chunk claims stream ownership (first-bytes-wins);
        emits from any other replica — a hedge/requeue duplicate that lost
        the race — return False, telling the producer to stop drafting.
        Chunk buffering and callback delivery happen under the flight lock:
        exactly-once, in order, atomic with the ownership check."""
        def emit(chunk) -> bool:
            with f.lock:
                if f.completed or (f.stream_owner is not None
                                   and f.stream_owner != rid):
                    return False  # a rival already owns (or won) this flight
                f.stream_owner = rid
                f.chunks.append(chunk)
                for cb in f.chunk_cbs:
                    cb(chunk)
            return True
        return emit

    @staticmethod
    def _finish(f: _Flight) -> None:
        """Flip the done event and fire completion callbacks exactly once.
        ``done`` is set under the flight lock, atomically with nulling the
        callback list: a concurrent ``add_done_callback`` that observes
        ``callbacks is None`` is therefore guaranteed to see ``done`` set,
        so its immediate ``fn(self)`` can call ``result()`` safely."""
        with f.lock:
            cbs, f.callbacks = f.callbacks, None
            f.done.set()
        if cbs:
            for cb in cbs:
                cb()

    def _ensure_monitor_locked(self) -> None:
        if self._monitor is None or not self._monitor.is_alive():
            self._monitor_stop = False
            self._monitor = threading.Thread(
                target=self._monitor_loop, name="fleet-monitor", daemon=True)
            self._monitor.start()

    def _monitor_loop(self) -> None:
        """Hedge/kick monitor for async flights — the counterpart of the
        inline loop in ``_run_flights``, which only covers flights whose
        caller is blocked waiting on them.  Parks itself (exits) after a
        short quiet period with no async flights outstanding; the exit and
        the ``_monitor`` unset are atomic under ``_async_lock``, so a
        concurrent ``submit_many_async`` either sees the live thread or
        starts a fresh one — flights are never left unmonitored."""
        idle_polls = 0
        while True:
            with self._async_lock:
                if self._monitor_stop:
                    self._monitor = None
                    return
                self._async_flights = [f for f in self._async_flights
                                       if not f.done.is_set()]
                pending = list(self._async_flights)
                if pending:
                    idle_polls = 0
                else:
                    idle_polls += 1
                    if idle_polls >= 4:  # ~0.2 s quiet: park until next use
                        self._monitor = None
                        return
            if pending:
                self._hedge_and_kick(pending, hedge=True)
            self._wake.clear()
            self._wake.wait(self._tick_s if pending else 0.05)

    # -- sequential reference dispatcher (deterministic mode) ----------------

    def _submit_sequential(self, request, hedge: bool, emit=None):
        """Pre-threaded behaviour, bit-for-bit: same RNG draw order, same
        simulated hedge accounting (min with the backup's rolling p95),
        with the hedge threshold floored at ``hedge_floor_s`` like the
        threaded monitor's deadline.
        ``emit`` (streamed flights) rides along unchanged — it cannot alter
        the draw order, and non-streaming calls never pass it."""
        attempts = 0
        last_err: Optional[Exception] = None
        while attempts < self.max_attempts:
            live = self.live()
            if not live:
                raise RuntimeError("no live replicas")
            primary = self.rng.choice(live)
            try:
                out, lat = primary.call(request, self.rng, emit)
            except Exception as e:  # noqa: BLE001 — failover path
                with self._lock:
                    self.failover_count += 1
                    self._evict_locked(primary)  # no-op on the last replica
                last_err = e
                attempts += 1
                continue
            # floored like the threaded monitor's deadline: with a warm p95
            # window of trivially-fast calls, a bare `2 * p95` threshold is
            # microseconds — scheduler jitter would fire spurious hedges
            # (and burn an extra rng draw, breaking determinism)
            if (hedge and len(live) > 1
                    and lat > max(self.hedge_floor_s,
                                  2.0 * primary.stats.p95())):
                backup = self.rng.choice(
                    [r for r in live if r.rid != primary.rid])
                with self._lock:
                    self.hedge_count += 1
                primary.stats.record_hedge()
                lat = min(lat, backup.stats.p95(default=lat))
            return out, {"replica": primary.rid, "latency_s": lat,
                         "attempts": attempts + 1}
        raise RuntimeError(
            f"request failed after retries: {last_err!r}") from last_err

    # -- concurrent dispatcher ----------------------------------------------

    def _run_flights(self, flights: list[_Flight], hedge: bool):
        with self._lock:
            if not self._live:
                raise RuntimeError("no live replicas")
            for f in flights:
                self._enqueue_locked(f)
        pending = list(flights)
        while pending:
            pending = [f for f in pending if not f.done.is_set()]
            if not pending:
                break
            self._hedge_and_kick(pending, hedge)
            self._wake.clear()
            self._wake.wait(self._tick_s)
        out = []
        for f in flights:
            if f.error is not None:
                raise RuntimeError(f"request failed after retries: {f.error!r}")
            out.append((f.result, f.meta))
        return out

    def _pick_target_locked(self, exclude) -> Optional[Replica]:
        cands = [r for r in self._live.values() if r.rid not in exclude]
        if not cands:
            return None
        return min(cands, key=lambda r: (
            len(self._queues[r.rid]) + len(self._active_by_rid[r.rid]),
            self.rng.random()))

    def _enqueue_locked(self, f: _Flight, priority: bool = False,
                        exclude=frozenset(), hard_exclude=frozenset()) -> None:
        """``exclude`` is advisory (dropped if it would leave no target);
        ``hard_exclude`` holds replicas already executing this flight — a
        duplicate there would corrupt the rid-keyed active bookkeeping, so
        it is never dropped.  With no target at all the flight errors out
        unless a copy is still running somewhere (that copy can still win)."""
        target = self._pick_target_locked(exclude | hard_exclude)
        if target is None and exclude:
            target = self._pick_target_locked(hard_exclude)
        if target is None:
            errored = False
            with f.lock:
                if not f.completed and not f.active:
                    f.completed = True
                    f.error = RuntimeError("no live replicas")
                    errored = True
            if errored:
                self._finish(f)
            return
        q = self._queues[target.rid]
        (q.appendleft if priority else q.append)(f)
        self._ensure_worker_locked(target.rid)

    def _requeue_locked(self, f: _Flight, exclude, priority: bool) -> None:
        with f.lock:
            if f.completed:
                return
            hard = set(f.active)
        self._enqueue_locked(f, priority=priority,
                             exclude=set(exclude) - hard, hard_exclude=hard)

    def _ensure_worker_locked(self, rid: int) -> None:
        if (self._pool is None
                or self._workers.get(rid, 0) >= self.per_replica_concurrency):
            return
        self._workers[rid] = self._workers.get(rid, 0) + 1
        self._pool.submit(self._worker_loop, rid)

    def _worker_loop(self, rid: int) -> None:
        try:
            while True:
                flight = None
                with self._lock:
                    if rid not in self._live:
                        break
                    q = self._queues.get(rid)
                    if q:
                        flight = q.popleft()
                    else:
                        flight = self._steal_locked(rid)
                    if flight is None:
                        break
                    flight.claims += 1
                self._execute_one(rid, flight)
        finally:
            with self._lock:
                self._workers[rid] = self._workers.get(rid, 1) - 1
                self._gc_rid_locked(rid)
            self._wake.set()

    def _steal_locked(self, rid: int) -> Optional[_Flight]:
        """Work stealing: take the tail of the longest other live deque, if
        this replica is eligible to run it."""
        donor_q, best = None, 0
        for x in self._live.values():
            if x.rid == rid:
                continue
            q = self._queues.get(x.rid)
            if q and len(q) > best:
                best, donor_q = len(q), q
        if donor_q is None:
            return None
        f = donor_q[-1]
        with f.lock:
            ok = (not f.completed and rid not in f.active
                  and rid not in f.tried_failed)
        if not ok:
            return None
        donor_q.pop()
        return f

    def _execute_one(self, rid: int, f: _Flight) -> None:
        rep = None
        with self._lock:
            f.claims -= 1  # hand-off ends here, atomically with the outcome
            r = self._live.get(rid)
            if r is not None:
                with f.lock:
                    if f.completed or (f.stream_owner is not None
                                       and f.stream_owner != rid):
                        # cancelled before start (or a rival stream already
                        # owns delivery): same accounting as a lost race
                        f.cancelled += 1
                        if f.meta is not None:
                            f.meta["cancelled"] = f.cancelled
                        self.cancelled_count += 1
                        return
                    f.active[rid] = time.perf_counter()
                self._active_by_rid[rid].add(f)
                rep = r
            else:
                # replica evicted between enqueue and execution
                self._requeue_locked(f, exclude={rid}, priority=True)
        if rep is None:
            return
        emit = self._make_emit(f, rid) if f.stream else None
        try:
            out, lat = rep.call(f.request, self.rng, emit)
            err = None
        except Exception as e:  # noqa: BLE001 — failover path
            err, out, lat = e, None, 0.0
        if err is None:
            winner = False
            with self._lock:
                self._active_by_rid.get(rid, set()).discard(f)
                with f.lock:
                    f.active.pop(rid, None)
                    # a streamed flight is only winnable by its owner: a
                    # duplicate that ran to completion without ever claiming
                    # first bytes is a loser even if it lands first
                    loser = (f.completed or (f.stream_owner is not None
                                             and f.stream_owner != rid))
                    if not loser:
                        winner = True
                        f.completed = True
                        # "attempts" = retries + 1, mirroring the sequential
                        # dispatcher (hedge/requeue duplicates not included
                        # — those are under their own keys)
                        f.meta = {"replica": rid, "latency_s": lat,
                                  "attempts": f.failures + 1,
                                  "hedges": f.hedges, "requeues": f.requeues,
                                  "cancelled": f.cancelled,
                                  "chunks": len(f.chunks)}
                        f.result = out
                    else:
                        # per-flight mirror of cancelled_count; late losers
                        # update the already-published meta in place (exact
                        # equality is asserted at quiescence)
                        f.cancelled += 1
                        if f.meta is not None:
                            f.meta["cancelled"] = f.cancelled
                if not winner:
                    self.cancelled_count += 1  # loser of a hedge/requeue race
                self._gc_rid_locked(rid)
            if winner:
                self._finish(f)
            self._wake.set()
            return
        give_up = False
        with self._lock:
            self.failover_count += 1
            self._active_by_rid.get(rid, set()).discard(f)
            with f.lock:
                f.active.pop(rid, None)
                f.failures += 1
                f.tried_failed.add(rid)
                # an owner dying mid-stream is terminal: chunks already
                # delivered cannot be replayed by a fresh replica, so the
                # flight fails instead of silently double-streaming
                owner_died = f.stream_owner == rid
                if not f.completed and (owner_died
                                        or f.failures >= self.max_attempts):
                    f.completed = True
                    f.error = err
                    give_up = True
                retry = not f.completed
            self._evict_locked(rep)  # atomic: never drains the last replica
            self._gc_rid_locked(rid)
            if retry:
                self._requeue_locked(f, exclude=set(f.tried_failed),
                                     priority=True)
        if give_up:
            self._finish(f)
        self._wake.set()

    def _hedge_deadline_for(self, exclude) -> Optional[float]:
        with self._lock:
            cands = [r for r in self._live.values() if r.rid not in exclude]
        if not cands:
            return None
        p95 = min(r.stats.p95_wall(default=self.hedge_cold_s) for r in cands)
        return max(self.hedge_floor_s, self.hedge_mult * p95)

    def _hedge_and_kick(self, pending: list[_Flight], hedge: bool) -> None:
        """Monitor pass: fire hedges whose deadline passed, make sure every
        non-empty queue has a worker, rescue orphaned flights."""
        now = time.perf_counter()
        to_hedge = []
        if hedge:
            for f in pending:
                with f.lock:
                    # an owned stream is never hedged: the backup could not
                    # win (first bytes already committed delivery to rid0)
                    if (f.completed or not f.hedge_allowed
                            or f.stream_owner is not None
                            or f.hedges >= self.max_hedges or not f.active):
                        continue
                    rid0, t0 = min(f.active.items(), key=lambda kv: kv[1])
                    exclude = set(f.active) | set(f.tried_failed)
                deadline = self._hedge_deadline_for(exclude)
                if deadline is not None and (now - t0) >= deadline:
                    to_hedge.append((f, rid0))
        with self._lock:
            for f, rid0 in to_hedge:
                fired = False
                with f.lock:
                    # recheck under the lock: the stream may have been
                    # claimed between the eligibility scan and the fire
                    if (not f.completed and f.stream_owner is None
                            and f.hedges < self.max_hedges):
                        f.hedges += 1
                        fired = True
                if fired:
                    self.hedge_count += 1
                    rep = self.replicas.get(rid0)
                    if rep is not None:
                        rep.stats.record_hedge()
                    self._requeue_locked(f, exclude=set(f.tried_failed),
                                         priority=True)
            queued = set()
            for rid in self._live:
                q = self._queues.get(rid)
                if q:
                    self._ensure_worker_locked(rid)
                    queued.update(id(f) for f in q)
            for f in pending:
                with f.lock:
                    orphan = (not f.completed and not f.active
                              and id(f) not in queued)
                if orphan and f.claims == 0:
                    self._enqueue_locked(f, priority=True)
