"""Online adaptation plane: drift-aware continual table updates.

The JAX package's plane (``src/repro/runtime/adaptation.py``) with the same
numpy statistics, monitors, sweeps and swaps; only the DSQE projection of
the far-from-prototype signal runs on the encoder's device.

Closes the emulator -> runtime loop (ROADMAP "Online adaptation"): the
runtime no longer serves frozen deploy-time tables — served outcomes feed
per-shard statistics, drift monitors watch them, and a drift verdict
triggers a targeted background re-exploration whose rows hot-swap into the
serving selector.

The adaptation contract
=======================

**What updates online.**  Per-(shard, domain, cluster, path) decayed EWMA
statistics of served latency, cost, SLO hits, and judge scores where the
response carries them (benchmark mode; open serving has NaN accuracy and
skips the accuracy cell).  These statistics (1) drive the drift monitors
and (2) blend into the next table version's per-path means
(``OnlinePathStats``: convex ``(1-w)*emulated + w*online`` with
``w = n_eff / (n_eff + blend_prior)``).  Nothing on the serving hot path
writes a table: the ``Orchestrator._note_settled`` / ``_note_shed`` hooks
(which already run under the shard's stats lock) only APPEND a small
outcome record to a bounded per-shard ring — the plane's background thread
folds rings into statistics, so the hot path gains one list store and one
integer increment per outcome.

**Decay semantics.**  Every cell keeps ``mean += decay * (x - mean)`` per
observation and a decayed observation count ``n = n*(1-decay) + 1``
(asymptote ``1/decay``), so stale evidence fades at the same rate fresh
evidence accrues and the blend weight saturates at
``(1/decay) / (1/decay + blend_prior)``.  Drift monitors use the same
per-observation EWMA on three rates — SLO-violation, OOD-fallback, and
far-from-every-prototype (max DSQE prototype similarity below
``ood_sim_floor``; the new-cluster signal) — with hysteresis: a monitor
must stay above threshold for ``trip_folds`` consecutive ACTIVE folds
(folds that saw that domain's traffic) to trip, and ``cooldown_folds``
active folds must pass between sweeps of the same (shard, domain), so
transient bursts trigger nothing.

**Swap atomicity.**  A tripped monitor enqueues a bounded sweep job:
``Emulator.explore_targeted`` re-measures ONLY the stale clusters' query
neighborhoods (rows whose CCA set id the per-set violation statistics
flag, capped at ``max_sweep_queries``) against the LIVE executor
(``Emulator(..., executor=...)`` + ``refresh_environment()``, so drifted
device profiles are what gets measured).  The sweep doubles as an
environment probe: a consistent per-path latency shift between the swept
rows and their old cells rescales that path's unswept rows too
(``_recalibrate_latency``), so a device-level drift propagates to the
whole column instead of being diluted by stale means.  The fresh rows
merge into a copy of the serving table (``EvalTable.updated``) and
publish via
``RuntimePathSelector.swap_table``: build-aside, one atomic reference
store under ``_kernel_build_lock``, in-flight buckets finish on the old
version, and the fused pass is reused (state-as-argument), so
``kernel_trace_count`` stays bounded by shape buckets — never by swaps.
Multi-domain servers restack the sharded selector afterwards
(``EcoLLMServer.notify_table_swap``), also without a new bucket.

**On the card.**  A swap builds the new version's device state (host to
device copies) on the sweeping thread while orchestrator threads launch the
selection kernels against the old version's.  Both run on the current
stream, so the caching allocator can never hand a block the old version
still reads to the new one; a reader holds its version (and with it that
version's tensors) until its result is on the host.  A side stream here
would need ``record_stream`` or an event before it may touch either.

**What stays frozen.**  The DSQE projection and prototypes, the CCA set
vocabulary and per-train-query set ids, the path space, and the (Q, P)
table shape: re-exploration refreshes existing rows, it never grows the
table (a genuinely new cluster re-explores its nearest existing
neighborhood; growing prototypes/rows online is a recorded follow-on,
with judge-in-the-loop scoring and cross-shard gossip).  The per-row
best-path labels the kNN vote targets are NOT frozen — a swap re-derives
them from the refreshed rows with the same lexicographic rule CCA used,
so re-exploration that discovers a better path moves the vote.

Deterministic tests drive ``AdaptationPlane.pump()`` directly;
``start()`` runs the same pump on a daemon thread every
``fold_interval_s``.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

import numpy as np

if TYPE_CHECKING:
    from repro_torch.runtime.orchestrator import Orchestrator, Ticket
    from repro_torch.runtime.server import EcoLLMServer

__all__ = ["AdaptConfig", "AdaptationPlane", "Outcome"]


@dataclass(frozen=True)
class AdaptConfig:
    """Knobs for the adaptation plane (see the module docstring)."""

    decay: float = 0.05           # EWMA step for per-cell path statistics
    drift_decay: float = 0.1      # EWMA step for the drift-monitor rates
    viol_threshold: float = 0.35  # SLO-violation rate that counts as hot
    fallback_threshold: float = 0.5   # OOD-fallback rate that counts as hot
    ood_sim_floor: float = 0.3    # max prototype sim below this = far/OOD
    ood_threshold: float = 0.5    # far-query rate that counts as hot
    min_obs: float = 8.0          # decayed obs before a monitor may trip
    trip_folds: int = 3           # consecutive hot active folds to trip
    clear_folds: int = 2          # consecutive cool active folds to clear
    cooldown_folds: int = 8       # active folds between sweeps per domain
    ring_size: int = 2048         # per-shard outcome ring capacity
    fold_interval_s: float = 0.05  # background thread pump period
    max_sweep_queries: int = 16   # bound on one targeted re-exploration
    max_pending_sweeps: int = 4   # bound on the sweep queue
    max_sweeps_per_pump: int = 1  # bound on sweep work per pump
    blend_prior: float = 8.0      # pseudo-count in w = n / (n + prior)
    stage_cache_max: int = 4096   # LRU bound for sweep emulators' caches


@dataclass(slots=True)
class Outcome:
    """One settled/shed outcome, as appended on the serving hot path."""

    kind: str                 # "served" | "failed" | "shed"
    tenant: str
    domain: Optional[str]     # as requested; canonicalized at fold time
    qid: Optional[int]
    prompt: str
    path_key: Optional[str]
    set_id: int
    fallback: bool
    latency_s: float
    cost_usd: float
    slo_ok: bool
    accuracy: float           # judge score; NaN in open serving
    reason: Optional[str]     # shed reason


class _Ring:
    """Bounded outcome ring.  Producers are serialized by the owning
    shard's stats lock (the ``_note_*`` hooks run under it), so ``append``
    needs no lock of its own; the single folding consumer snapshots
    ``head`` and reads behind it.  Overrun drops the OLDEST unfolded
    records (counted in ``dropped``) — adaptation statistics are decayed
    estimates, losing a burst's tail under extreme pressure only slows
    adaptation, never corrupts serving state."""

    __slots__ = ("buf", "size", "head", "dropped")

    def __init__(self, size: int):
        self.buf: list = [None] * size
        self.size = size
        self.head = 0
        self.dropped = 0

    def append(self, rec: Outcome) -> None:
        self.buf[self.head % self.size] = rec
        self.head += 1

    def drain(self, cursor: int) -> tuple[list, int]:
        """Records in [cursor, head) (clamped to capacity) + new cursor."""
        head = self.head
        if head - cursor > self.size:
            self.dropped += head - cursor - self.size
            cursor = head - self.size
        out = [self.buf[i % self.size] for i in range(cursor, head)]
        return out, head


class _Ewma:
    __slots__ = ("mean", "n")

    def __init__(self):
        self.mean = 0.0
        self.n = 0.0

    def update(self, x: float, decay: float) -> None:
        if self.n == 0.0:
            self.mean = float(x)
        else:
            self.mean += decay * (float(x) - self.mean)
        self.n = self.n * (1.0 - decay) + 1.0


class _PathCell:
    """Per-(domain, path) decayed serving statistics."""

    __slots__ = ("lat", "cost", "acc", "slo_hit")

    def __init__(self):
        self.lat = _Ewma()
        self.cost = _Ewma()
        self.acc = _Ewma()
        self.slo_hit = _Ewma()


class _Monitor:
    """Per-(shard, domain) drift monitor with hysteresis."""

    __slots__ = ("viol", "fallback", "ood", "hot_streak", "cool_streak",
                 "active_folds", "last_sweep_fold", "trips", "last_cause")

    def __init__(self):
        self.viol = _Ewma()
        self.fallback = _Ewma()
        self.ood = _Ewma()
        self.hot_streak = 0
        self.cool_streak = 0
        self.active_folds = 0
        self.last_sweep_fold = -(10 ** 9)  # never swept
        self.trips = 0
        self.last_cause: Optional[str] = None

    def reset_rates(self) -> None:
        """Clean slate after a table swap: measure the NEW table instead of
        letting the old table's violation history trip again."""
        self.viol = _Ewma()
        self.fallback = _Ewma()
        self.ood = _Ewma()
        self.hot_streak = 0
        self.cool_streak = 0


class _ShardState:
    """Everything the plane keeps per admission shard."""

    __slots__ = ("key", "ring", "cursor", "folds", "observed", "cells",
                 "set_viol", "monitors")

    def __init__(self, key, ring_size: int):
        self.key = key
        self.ring = _Ring(ring_size)
        self.cursor = 0
        self.folds = 0
        self.observed = 0
        # (domain, path_key) -> _PathCell
        self.cells: dict[tuple, _PathCell] = {}
        # (domain, set_id) -> _Ewma of SLO violations (staleness attribution)
        self.set_viol: dict[tuple, _Ewma] = {}
        self.monitors: dict[str, _Monitor] = {}


@dataclass(frozen=True)
class _SweepJob:
    shard_key: object
    domain: str
    stale_sets: frozenset
    cause: str


_NAN = float("nan")


class AdaptationPlane:
    """Drift-aware continual table updates for one ``EcoLLMServer``.

    Attach via ``EcoLLMServer.enable_adaptation()`` (which hangs the plane
    off every admission shard's ``_note_settled``/``_note_shed``); drive
    with ``start()`` (background thread) or ``pump()`` (deterministic).
    """

    def __init__(self, server: "EcoLLMServer", *,
                 config: AdaptConfig | None = None):
        self.server = server
        self.config = config or AdaptConfig()
        self._shards: dict = {}          # shard key -> _ShardState
        self._sweep_q: deque = deque()   # pending _SweepJobs (bounded)
        self._queued: set = set()        # (shard_key, domain) dedupe
        self._emulators: dict = {}       # domain -> sweep Emulator
        self._path_index: dict = {}      # domain -> {path_key: column j}
        self._pump_lock = threading.Lock()
        self._q_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.sweeps = 0
        self.swaps = 0
        self.swap_log: list[dict] = []   # bounded trail of swap events

    # -- hot path (called under the shard's stats lock) -----------------------

    def _shard(self, orch: "Orchestrator") -> _ShardState:
        key = orch.shard_id if orch.shard_id is not None else "main"
        st = self._shards.get(key)
        if st is None:
            # at most one producer per key (the shard serializes its own
            # hooks), so setdefault is belt-and-braces
            st = self._shards.setdefault(
                key, _ShardState(key, self.config.ring_size))
        return st

    def observe_settled(self, orch: "Orchestrator", ticket: "Ticket",
                        resp, err) -> None:
        req = ticket.request
        if err is not None or resp is None:
            rec = Outcome("failed", req.tenant, req.domain, req.qid,
                          req.prompt, None, -1, False, _NAN, _NAN, False,
                          _NAN, None)
        else:
            m = resp.meta
            rec = Outcome("served", req.tenant, req.domain, req.qid,
                          req.prompt, resp.path_key,
                          int(m.get("set_id", -1)),
                          bool(m.get("fallback", False)),
                          resp.latency_s, resp.cost_usd, bool(resp.slo_ok),
                          resp.accuracy, None)
        self._shard(orch).ring.append(rec)

    def observe_shed(self, orch: "Orchestrator", ticket: "Ticket",
                     reason: str) -> None:
        req = ticket.request
        self._shard(orch).ring.append(
            Outcome("shed", req.tenant, req.domain, req.qid, req.prompt,
                    None, -1, False, _NAN, _NAN, False, _NAN, reason))

    # -- background folding ---------------------------------------------------

    def pump(self, max_sweeps: Optional[int] = None) -> dict:
        """One adaptation step: fold every shard's ring into statistics,
        evaluate drift monitors, then run up to ``max_sweeps`` (default
        ``config.max_sweeps_per_pump``) queued re-exploration sweeps.
        Returns a summary of what happened — tests assert on it."""
        with self._pump_lock:
            folded = 0
            for st in list(self._shards.values()):
                folded += self._fold_shard(st)
            budget = (self.config.max_sweeps_per_pump
                      if max_sweeps is None else max_sweeps)
            swapped: list[dict] = []
            while budget > 0:
                with self._q_lock:
                    if not self._sweep_q:
                        break
                    job = self._sweep_q.popleft()
                    self._queued.discard((job.shard_key, job.domain))
                res = self._run_sweep(job)
                if res is not None:
                    swapped.append(res)
                budget -= 1
            return {"folded": folded, "swaps": swapped,
                    "pending_sweeps": len(self._sweep_q)}

    def _embeddings_for(self, domain: str, recs: list) -> np.ndarray:
        """(R, d) embeddings for the fold's served records, via the known
        query id or the server's memoized prompt-embedding cache."""
        dom = self.server.domain_entry(domain)[0]
        out = []
        for r in recs:
            if r.qid is not None:
                out.append(dom.query_embeddings[r.qid])
            else:
                out.append(self.server._embed_entry(r.prompt)[0])
        return np.stack(out)

    def _max_proto_sims(self, domain: str, recs: list) -> np.ndarray:
        """Max DSQE-prototype similarity per served record (the far-from-
        every-prototype / new-cluster drift signal)."""
        sel = self.server.domain_entry(domain)[1]
        embs = self._embeddings_for(domain, recs)
        # fp32 on the encoder's device (no TF32: these similarities are
        # compared with ood_sim_floor); the prototype product is numpy's
        z = sel.dsqe.project(embs).cpu().numpy()
        return (z @ sel._protos_unit.T).max(axis=1)

    def _fold_shard(self, st: _ShardState) -> int:
        cfg = self.config
        recs, st.cursor = st.ring.drain(st.cursor)
        if not recs:
            return 0
        st.folds += 1
        st.observed += len(recs)
        srv = self.server
        by_domain: dict[str, list] = {}
        for r in recs:
            by_domain.setdefault(srv.canonical_domain(r.domain), []).append(r)
        for domain, rows in by_domain.items():
            served = [r for r in rows if r.kind == "served"]
            mon = st.monitors.get(domain)
            if mon is None:
                mon = st.monitors[domain] = _Monitor()
            if not served:
                continue  # sheds/failures alone say nothing about the table
            try:
                maxsims = self._max_proto_sims(domain, served)
            except Exception:  # unresolvable domain/prompt: skip OOD signal
                maxsims = np.full(len(served), np.inf)
            for r, ms in zip(served, maxsims):
                cell = st.cells.get((domain, r.path_key))
                if cell is None:
                    cell = st.cells[(domain, r.path_key)] = _PathCell()
                cell.lat.update(r.latency_s, cfg.decay)
                cell.cost.update(r.cost_usd, cfg.decay)
                cell.slo_hit.update(1.0 if r.slo_ok else 0.0, cfg.decay)
                if not math.isnan(r.accuracy):
                    cell.acc.update(r.accuracy, cfg.decay)
                viol = 0.0 if r.slo_ok else 1.0
                mon.viol.update(viol, cfg.drift_decay)
                mon.fallback.update(1.0 if r.fallback else 0.0,
                                    cfg.drift_decay)
                mon.ood.update(1.0 if ms < cfg.ood_sim_floor else 0.0,
                               cfg.drift_decay)
                if r.set_id >= 0:
                    sv = st.set_viol.get((domain, r.set_id))
                    if sv is None:
                        sv = st.set_viol[(domain, r.set_id)] = _Ewma()
                    sv.update(viol, cfg.drift_decay)
            self._evaluate_monitor(st, domain, mon)
        return len(recs)

    def _evaluate_monitor(self, st: _ShardState, domain: str,
                          mon: _Monitor) -> None:
        cfg = self.config
        mon.active_folds += 1
        cause = None
        if mon.viol.n >= cfg.min_obs and mon.viol.mean > cfg.viol_threshold:
            cause = "slo_violations"
        elif (mon.fallback.n >= cfg.min_obs
              and mon.fallback.mean > cfg.fallback_threshold):
            cause = "ood_fallbacks"
        elif mon.ood.n >= cfg.min_obs and mon.ood.mean > cfg.ood_threshold:
            cause = "far_from_prototypes"
        if cause is None:
            mon.cool_streak += 1
            if mon.cool_streak >= cfg.clear_folds:
                mon.hot_streak = 0
            return
        mon.hot_streak += 1
        mon.cool_streak = 0
        mon.last_cause = cause
        if mon.hot_streak < cfg.trip_folds:
            return
        if mon.active_folds - mon.last_sweep_fold < cfg.cooldown_folds:
            return
        stale = frozenset(
            sid for (dom, sid), sv in st.set_viol.items()
            if dom == domain and sv.n >= 1.0
            and sv.mean > cfg.viol_threshold)
        if not stale:
            # no per-set culprit (e.g. pure OOD drift): re-explore the
            # clusters the recent traffic actually landed on
            stale = frozenset(sid for (dom, sid) in st.set_viol
                              if dom == domain)
        if not stale:
            return
        if self._enqueue_sweep(_SweepJob(st.key, domain, stale, cause)):
            mon.trips += 1
            mon.hot_streak = 0
            mon.last_sweep_fold = mon.active_folds

    def _enqueue_sweep(self, job: _SweepJob) -> bool:
        with self._q_lock:
            if (job.shard_key, job.domain) in self._queued:
                return False
            if len(self._sweep_q) >= self.config.max_pending_sweeps:
                return False
            self._sweep_q.append(job)
            self._queued.add((job.shard_key, job.domain))
            return True

    # -- targeted re-exploration + hot swap -----------------------------------

    def _emulator(self, domain: str):
        from repro_torch.core.emulator import Emulator

        emu = self._emulators.get(domain)
        if emu is None:
            dom, sel, ex = self.server.domain_entry(domain)
            emu = self._emulators[domain] = Emulator(
                dom, sel.space, executor=ex,
                stage_cache_max=self.config.stage_cache_max)
        return emu

    def _columns(self, domain: str, sel) -> dict:
        idx = self._path_index.get(domain)
        if idx is None:
            idx = self._path_index[domain] = {
                p.key: j for j, p in enumerate(sel.table.paths)}
        return idx

    def _online_for_domain(self, domain: str, sel):
        """Merge every shard's per-path cells for ``domain`` into one
        ``OnlinePathStats`` (cells are per shard for locality/telemetry;
        the domain's table is shared, so the blend pools the evidence,
        weighting each shard's mean by its decayed count)."""
        from repro_torch.core.rps import OnlinePathStats

        cols = self._columns(domain, sel)
        P = len(sel.table.paths)
        n_lat = np.zeros(P)
        s_lat = np.zeros(P)
        s_cost = np.zeros(P)
        n_acc = np.zeros(P)
        s_acc = np.zeros(P)
        for st in self._shards.values():
            for (dom, pk), cell in st.cells.items():
                if dom != domain:
                    continue
                j = cols.get(pk)
                if j is None:
                    continue
                n_lat[j] += cell.lat.n
                s_lat[j] += cell.lat.n * cell.lat.mean
                s_cost[j] += cell.cost.n * cell.cost.mean
                n_acc[j] += cell.acc.n
                s_acc[j] += cell.acc.n * cell.acc.mean
        with np.errstate(invalid="ignore", divide="ignore"):
            lat = np.where(n_lat > 0, s_lat / np.maximum(n_lat, 1e-12), np.nan)
            cost = np.where(n_lat > 0, s_cost / np.maximum(n_lat, 1e-12), np.nan)
            acc = np.where(n_acc > 0, s_acc / np.maximum(n_acc, 1e-12), np.nan)
        w = n_lat / (n_lat + self.config.blend_prior)
        return OnlinePathStats(latency_s=lat, cost_usd=cost, accuracy=acc,
                               weight=w)

    @staticmethod
    def _recalibrate_latency(old_lat: np.ndarray, new_table,
                             swept_rows: list, *,
                             min_ratio_log: float = 0.18) -> int:
        """Environment recalibration: the targeted sweep doubles as a probe
        of the CURRENT device environment.  For each path column, compare
        the freshly measured latencies on the swept rows against the old
        table's cells; a consistent multiplicative shift (median ratio off
        by more than ~20%) means the environment moved for that path's
        composition (e.g. the edge device throttled), so the UNSWEPT rows
        of that column — measurements from the old environment — are
        rescaled by the same ratio.  Accuracy and cost are never touched
        (the judge does not depend on the device; pricing is per-token).
        Returns the number of rescaled columns."""
        lat = new_table.latency
        swept = np.asarray(swept_rows, dtype=int)
        mask = np.ones(lat.shape[0], bool)
        mask[swept] = False
        rescaled = 0
        for j in range(lat.shape[1]):
            old_c, new_c = old_lat[swept, j], lat[swept, j]
            ok = np.isfinite(old_c) & np.isfinite(new_c) & (old_c > 1e-9)
            if not ok.any():
                continue
            r = float(np.median(new_c[ok] / old_c[ok]))
            if r <= 0 or abs(math.log(r)) < min_ratio_log:
                continue
            col = lat[:, j]
            col[mask & np.isfinite(col)] *= r
            rescaled += 1
        return rescaled

    def _run_sweep(self, job: _SweepJob) -> Optional[dict]:
        """One bounded re-exploration: stale clusters' rows -> exhaustive
        targeted sweep against the live executor -> merge -> atomic swap."""
        cfg = self.config
        srv = self.server
        try:
            dom, sel, _ = srv.domain_entry(job.domain)
        except KeyError:
            return None
        set_ids = np.asarray(sel.cca.set_ids)
        rows = [i for i, sid in enumerate(set_ids) if int(sid) in job.stale_sets]
        if not rows:
            rows = list(range(len(sel.table.query_ids)))
        qids = [sel.table.query_ids[i] for i in rows][:cfg.max_sweep_queries]
        emu = self._emulator(job.domain)
        # drifted environments invalidate baked stage latencies and the
        # batched engine's per-path columns — re-measure, don't re-serve
        emu.refresh_environment()
        sub = emu.explore_targeted(qids, max_queries=cfg.max_sweep_queries)
        old_table = sel.table
        new_table = old_table.updated(sub)
        recal = self._recalibrate_latency(old_table.latency, new_table,
                                          rows[:len(qids)])
        online = self._online_for_domain(job.domain, sel)
        version = sel.swap_table(new_table, online=online)
        srv.notify_table_swap(job.domain)
        self.sweeps += 1
        self.swaps += 1
        # the new table gets a clean measurement window on every shard
        for st in self._shards.values():
            mon = st.monitors.get(job.domain)
            if mon is not None:
                mon.reset_rates()
            for key in list(st.set_viol):
                if key[0] == job.domain:
                    del st.set_viol[key]
        event = {"domain": job.domain, "shard": job.shard_key,
                 "cause": job.cause, "version": version,
                 "stale_sets": sorted(job.stale_sets),
                 "queries_swept": len(qids), "recalibrated_paths": recal}
        self.swap_log.append(event)
        del self.swap_log[:-64]  # bounded trail
        return event

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "AdaptationPlane":
        """Run ``pump()`` every ``fold_interval_s`` on a daemon thread."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.config.fold_interval_s):
                try:
                    self.pump()
                except Exception:  # noqa: BLE001 — adaptation must never
                    # take serving down; next pump retries
                    pass

        self._thread = threading.Thread(
            target=loop, name="adaptation-plane", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None

    # -- telemetry ------------------------------------------------------------

    def _shard_dict(self, st: _ShardState) -> dict:
        return {
            "observed": st.observed,
            "folds": st.folds,
            "ring_dropped": st.ring.dropped,
            "ring_backlog": st.ring.head - st.cursor,
            "domains": {
                d: {"viol_rate": m.viol.mean,
                    "fallback_rate": m.fallback.mean,
                    "ood_rate": m.ood.mean,
                    "n_eff": m.viol.n,
                    "hot_streak": m.hot_streak,
                    "trips": m.trips,
                    "last_cause": m.last_cause}
                for d, m in st.monitors.items()},
        }

    def shard_state(self, orch: "Orchestrator") -> dict:
        key = orch.shard_id if orch.shard_id is not None else "main"
        st = self._shards.get(key)
        if st is None:
            return {"observed": 0, "folds": 0, "ring_dropped": 0,
                    "ring_backlog": 0, "domains": {}}
        return self._shard_dict(st)

    def state(self) -> dict:
        return {
            "sweeps": self.sweeps,
            "swaps": self.swaps,
            "pending_sweeps": len(self._sweep_q),
            "recent_swaps": list(self.swap_log[-8:]),
            "shards": {str(st.key): self._shard_dict(st)
                       for st in self._shards.values()},
        }
