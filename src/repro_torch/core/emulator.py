"""ECO-LLM Emulator (paper §3.2): systematic path-space exploration.

Implements Algorithm 1 — adaptive Stratified Budget Allocation:
  1. k-means (per query type) picks B*sqrt(|Q|) representative queries which
     are evaluated on ALL paths;
  2. paths are ranked per type (accuracy first, cost/latency tiebreak per the
     λ strategy);
  3. remaining queries see only the top B*sqrt(|P|) paths (+ random probes).

Total evaluations drop from O(|Q||P|) to O(sqrt(|Q|)|P| + |Q|sqrt(|P|)).

A stage-granular prefix cache reuses shared path prefixes across evaluations
(§3.2.4); the hit-rate is reported so the paper's 30-50% saving is checkable.
"""
from __future__ import annotations

import math
import random
import threading
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.devices import DeviceProfile, EDGE_DEVICES
from repro_torch.core.domains import DomainData, Query
from repro_torch.core.kmeans import representatives
from repro_torch.core.paths import Path, PathSpace
from repro_torch.core.pipeline import (BatchedPipelineExecutor, PipelineExecutor,
                                 StageState)


@dataclass
class EvalTable:
    """Dense (query x path) metric arrays; NaN = not evaluated."""

    query_ids: list[int]
    paths: list[Path]
    accuracy: np.ndarray  # (Q, P)
    latency: np.ndarray
    cost: np.ndarray
    evaluated: np.ndarray  # bool (Q, P)
    cache_stats: dict = field(default_factory=dict)

    @property
    def coverage(self) -> float:
        return float(self.evaluated.mean())

    def bit_equal(self, other: "EvalTable") -> bool:
        """Bit-for-bit table parity: the contract the batched engine and
        the cross-query retrieval prefetch are held to (same cells
        evaluated, same metric bit patterns, same cache statistics)."""
        return (
            np.array_equal(self.evaluated, other.evaluated)
            and np.array_equal(self.accuracy, other.accuracy, equal_nan=True)
            and np.array_equal(self.latency, other.latency, equal_nan=True)
            and np.array_equal(self.cost, other.cost, equal_nan=True)
            and self.cache_stats == other.cache_stats)

    def row(self, qid: int) -> int:
        return self.query_ids.index(qid)

    def updated(self, sub: "EvalTable") -> "EvalTable":
        """A copy of this table with ``sub``'s evaluated cells merged in.

        ``sub`` is a targeted re-exploration over a SUBSET of this table's
        query ids (same path space); its evaluated cells overwrite the
        corresponding rows here.  The receiver is untouched — the merge is
        the build-aside half of an atomic table swap
        (``RuntimePathSelector.swap_table``), so the serving snapshot must
        never be mutated in place.
        """
        if len(sub.paths) != len(self.paths):
            raise ValueError(
                f"merge needs one shared path space: {len(sub.paths)} != "
                f"{len(self.paths)}")
        acc, lat = self.accuracy.copy(), self.latency.copy()
        cost, done = self.cost.copy(), self.evaluated.copy()
        for si, qid in enumerate(sub.query_ids):
            ri = self.row(qid)
            m = sub.evaluated[si]
            acc[ri, m] = sub.accuracy[si, m]
            lat[ri, m] = sub.latency[si, m]
            cost[ri, m] = sub.cost[si, m]
            done[ri, m] = True
        return EvalTable(
            query_ids=list(self.query_ids), paths=list(self.paths),
            accuracy=acc, latency=lat, cost=cost, evaluated=done,
            cache_stats=dict(self.cache_stats))


class StageCacheLRU:
    """Bounded LRU over the emulator's stage-prefix cache.

    Implements exactly the dict subset the executors use (``get`` /
    ``setdefault`` / ``[]`` / ``len``), with reads counting as LRU touches
    and eviction on insert.  Thread-safe: sweeps may share one cache
    across threads, and ``OrderedDict`` reordering is not safe lock-free.
    Eviction never changes results — stage states are deterministic
    functions of their prefix key, an evicted prefix is simply recomputed
    (the miss/eviction counters make the cost visible via
    ``Emulator.stats()``).

    ``maxsize`` must exceed one block sweep's prefix working set
    (<= 3 * |paths| keys, all touched in dependency order) so a parent
    state is never evicted before the same block reads it back.
    """

    def __init__(self, maxsize: int):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = int(maxsize)
        self.evictions = 0
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key, default=None):
        with self._lock:
            try:
                v = self._d[key]
            except KeyError:
                return default
            self._d.move_to_end(key)
            return v

    def __getitem__(self, key):
        with self._lock:
            v = self._d[key]
            self._d.move_to_end(key)
            return v

    def setdefault(self, key, value):
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                return self._d[key]
            self._d[key] = value
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)
                self.evictions += 1
            return value

    def __setitem__(self, key, value) -> None:
        self.setdefault(key, value)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._d

    def __len__(self) -> int:
        return len(self._d)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()


class Emulator:
    def __init__(self, domain: DomainData, space: PathSpace,
                 device: DeviceProfile | None = None, seed: int = 0,
                 *, executor: PipelineExecutor | None = None,
                 stage_cache_max: int | None = None):
        """``executor`` lets a caller (the online adaptation plane) run the
        sweep through the SERVING pipeline executor — same device profile,
        same retrieval memos — so re-explored rows measure the environment
        the runtime actually dispatches into, not a fresh replica of the
        deploy-time one.  ``stage_cache_max`` bounds the stage-prefix cache
        with LRU eviction (long-lived serving processes re-explore
        repeatedly); the default ``None`` keeps the pre-existing unbounded
        dict, which the bit-for-bit parity suites rely on."""
        self.domain = domain
        self.space = space
        self.seed = executor.seed if executor is not None else seed
        self.exec = executor if executor is not None else PipelineExecutor(
            domain, device or EDGE_DEVICES["m4"], seed=seed)
        self.device = self.exec.device
        self.batched = BatchedPipelineExecutor(self.exec, space.paths)
        self.stage_cache_max = stage_cache_max
        self._stage_cache = ({} if stage_cache_max is None
                             else StageCacheLRU(stage_cache_max))
        self._cache_hits = 0
        self._cache_misses = 0

    def stats(self) -> dict:
        """Stage-prefix cache counters (hits/misses/evictions/size)."""
        return {
            "hits": self._cache_hits,
            "misses": self._cache_misses,
            "evictions": (self._stage_cache.evictions
                          if isinstance(self._stage_cache, StageCacheLRU)
                          else 0),
            "size": len(self._stage_cache),
            "bounded": self.stage_cache_max is not None,
        }

    def reset_stage_cache(self) -> None:
        """Drop every cached stage state (counters keep accumulating).

        Cached states bake the device profile's stage latencies at
        evaluation time, so a caller observing environment drift (the
        adaptation plane, before a re-exploration sweep) must reset the
        cache or the sweep would re-serve pre-drift measurements."""
        self._stage_cache.clear()

    def refresh_environment(self) -> None:
        """Re-measure against the executor's CURRENT device profile.

        The batched engine bakes per-path latency/cost columns at
        construction and cached stage states bake them at evaluation, so
        both must be rebuilt when the environment may have drifted — the
        adaptation plane calls this before every targeted sweep."""
        self.batched = BatchedPipelineExecutor(self.exec, self.space.paths)
        self.reset_stage_cache()

    # -- cached staged execution -------------------------------------------

    def _eval(self, q: Query, path: Path) -> tuple[float, float, float]:
        """Run one (query, path) with stage-prefix caching."""
        ex = self.exec
        st = ex.initial_state(q)
        stages = (
            ("qproc", path.qproc, ex.run_qproc),
            ("retrieval", path.retrieval, ex.run_retrieval),
            ("cproc", path.cproc, ex.run_cproc),
        )
        prefix = f"q{q.qid}"
        for name, choice, fn in stages:
            prefix = f"{prefix}|{choice.key}"
            hit = self._stage_cache.get(prefix)
            if hit is not None:
                self._cache_hits += 1
                st = hit
            else:
                self._cache_misses += 1
                # atomic setdefault: one canonical state per prefix even if
                # the cache is shared with concurrent readers
                st = self._stage_cache.setdefault(prefix, fn(q, choice, st))
        st = ex.run_model(q, path.model, st)
        acc = ex.judge(q, path, st)
        return acc, st.latency_s, st.cost_usd

    # -- Algorithm 1 ----------------------------------------------------------

    def explore(self, query_ids: list[int], budget: float | None = None,
                lam: int = 0, batched: bool = True,
                prefetch: bool = True) -> EvalTable:
        """budget None -> exhaustive; otherwise the paper's B factor.

        ``batched=True`` sweeps whole path blocks per query through the
        vectorized engine; ``batched=False`` is the scalar reference oracle.
        Both produce bit-identical tables and cache statistics.

        ``prefetch`` (batched mode only) additionally resolves the
        retrieval stage CROSS-QUERY: before a block of queries is swept,
        every distinct (stepback?, hyde?, top_k) search the block needs
        runs as one ``VectorStore.search_batch`` matmul pass instead of
        one GEMV per query.  Results, cache stats, and the judge noise
        stay bit-for-bit identical either way (the store's batched-search
        contract); ``prefetch=False`` keeps the per-query search path for
        A/B benchmarking.
        """
        queries = [self.domain.queries[i] for i in query_ids]
        P = len(self.space.paths)
        Q = len(queries)
        acc = np.full((Q, P), np.nan, np.float64)
        lat = np.full((Q, P), np.nan, np.float64)
        cost = np.full((Q, P), np.nan, np.float64)
        done = np.zeros((Q, P), bool)
        rng = random.Random(self.seed + 17)

        def eval_cell(qi: int, pj: int):
            if done[qi, pj]:
                return
            a, l, c = self._eval(queries[qi], self.space.paths[pj])
            acc[qi, pj], lat[qi, pj], cost[qi, pj] = a, l, c
            done[qi, pj] = True

        def eval_row(qi: int, pjs) -> None:
            """One query against a block of paths, on the selected engine."""
            if not batched:
                for pj in pjs:
                    eval_cell(qi, pj)
                return
            js = np.asarray(pjs, np.int64)
            row_done = done[qi]
            if row_done.any():
                js = js[~row_done[js]]
            if js.size == 0:
                return
            q = queries[qi]
            states, inv, n_new = self.batched.block_states(q, js, self._stage_cache)
            self._cache_misses += n_new
            self._cache_hits += 3 * int(js.size) - n_new
            a, l, c = self.batched.finish_block(q, states, inv, js)
            acc[qi, js], lat[qi, js], cost[qi, js] = a, l, c
            done[qi, js] = True

        def prefetch_rows(rows) -> None:
            """Cross-query batched resolution of the rows' retrieval stage."""
            if batched and prefetch and rows:
                self.batched.prefetch_retrieval(
                    [(queries[qi], np.asarray(list(pjs), np.int64))
                     for qi, pjs in rows])

        if budget is None:
            prefetch_rows([(qi, range(P)) for qi in range(Q)])
            for qi in range(Q):
                eval_row(qi, range(P))
        else:
            # stage 1: stratified representative queries (k-means per type)
            n_rep_total = max(1, min(Q, int(budget * math.sqrt(Q))))
            types = sorted({q.qtype for q in queries})
            reps: list[int] = []
            for t in types:
                t_idx = [i for i, q in enumerate(queries) if q.qtype == t]
                if not t_idx:
                    continue
                share = max(1, round(n_rep_total * len(t_idx) / Q))
                emb = self.domain.query_embeddings[[query_ids[i] for i in t_idx]]
                sel = representatives(emb, share, seed=self.seed)
                reps.extend(t_idx[s] for s in sel)
            reps = sorted(set(reps))
            prefetch_rows([(qi, range(P)) for qi in reps])
            for qi in reps:
                eval_row(qi, range(P))

            # rank paths per type: accuracy desc, then latency (λ=1) or cost
            k_paths = max(1, min(P, int(budget * math.sqrt(P))))
            top_by_type: dict[str, list[int]] = {}
            for t in types:
                t_reps = [qi for qi in reps if queries[qi].qtype == t]
                if not t_reps:
                    top_by_type[t] = list(range(P))[:k_paths]
                    continue
                a_mean = np.nanmean(acc[t_reps], axis=0)
                second = np.nanmean(lat[t_reps] if lam == 1 else cost[t_reps], axis=0)
                order = sorted(range(P), key=lambda j: (-round(a_mean[j], 2), second[j]))
                top_by_type[t] = order[:k_paths]

            # stage 2: remaining queries on top paths + random probes.  The
            # row blocks are drawn first (same rng order as the scalar
            # walk), prefetched cross-query, then evaluated.
            stage2 = []
            for qi in range(Q):
                if qi in reps:
                    continue
                sel = list(top_by_type[queries[qi].qtype])
                n_random = max(1, k_paths // 4)
                sel += rng.sample(range(P), min(n_random, P))
                stage2.append((qi, sorted(set(sel))))
            prefetch_rows(stage2)
            for qi, pjs in stage2:
                eval_row(qi, pjs)

        total = self._cache_hits + self._cache_misses
        return EvalTable(
            query_ids=list(query_ids),
            paths=list(self.space.paths),
            accuracy=acc, latency=lat, cost=cost, evaluated=done,
            cache_stats={
                "hits": self._cache_hits,
                "misses": self._cache_misses,
                "hit_rate": self._cache_hits / total if total else 0.0,
                "evaluations": int(done.sum()),
                "exhaustive_evaluations": Q * P,
            },
        )

    def explore_targeted(self, query_ids: list[int], *,
                         max_queries: int | None = None,
                         batched: bool = True,
                         prefetch: bool = True) -> EvalTable:
        """Cluster-scoped re-exploration: exhaustive sweep over ONLY the
        given query neighborhood (the adaptation plane passes the rows of
        the clusters a drift monitor flagged stale).

        No budget stratification — the caller already narrowed the query
        set, so every (query, path) cell is re-measured against the current
        environment.  ``max_queries`` bounds the sweep (first-come order,
        deduplicated); merge the result into a serving table with
        ``EvalTable.updated`` and swap it in with
        ``RuntimePathSelector.swap_table``.
        """
        seen: set[int] = set()
        qids = [q for q in query_ids
                if not (q in seen or seen.add(q))]
        if max_queries is not None:
            qids = qids[:max_queries]
        if not qids:
            raise ValueError("explore_targeted needs >= 1 query id")
        return self.explore(qids, budget=None, batched=batched,
                            prefetch=prefetch)


def pareto_front(points: np.ndarray) -> np.ndarray:
    """Boolean mask of pareto-optimal rows for (maximize col0, minimize rest)."""
    n = points.shape[0]
    keep = np.ones(n, bool)
    for i in range(n):
        if not keep[i]:
            continue
        dominated = (
            (points[:, 0] >= points[i, 0])
            & np.all(points[:, 1:] <= points[i, 1:], axis=1)
            & (np.any(points != points[i], axis=1))
        )
        if dominated.any():
            keep[i] = False
    return keep
