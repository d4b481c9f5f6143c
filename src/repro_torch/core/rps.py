"""Runtime Path Selection (paper §3.3.4, Algorithm 3).

Online per-query decision:
  1. project the query embedding with the trained DSQE; nearest prototype
     reveals the critical component set;
  2. filter paths: SLO-feasible ∧ critical set ⊆ path (Eq. 13) ∧ evaluated
     (never-explored paths have no evidence and are excluded);
  3. score surviving paths by similarity-weighted kNN over training queries
     (Eq. 14) and pick the argmax;
  4. fallback for out-of-distribution queries (no valid path): best global
     path honoring the critical set, cheapest above the accuracy bar.

The whole decision is a handful of matvecs over precomputed tables.
``RuntimePathSelector(use_kernel=True)`` routes ``select_batch`` through the
composed stage pipeline (``repro_torch.kernels.stages``): the DSQE projection,
train-similarity retrieve (hard top-k kNN), Algorithm-3 score (vote
gather, tie-break prior, per-query SLO mask), and argmax decode are
init/apply stages ``serial``-composed into ONE device pass over
device-resident state on the encoder's device (the retrieve stage launches
the ``retrieval_topk`` CUDA kernel on the card, its plain torch version on
the CPU); only the rare infeasible-row fallback stays on the host.  Batches
are padded to power-of-two buckets and ``kernel_trace_count`` counts the
distinct buckets the fused pass has run (the JAX package's jit traces).
``select_batch_staged`` runs the SAME stages with a host round-trip between
each — the fused-vs-staged A/B baseline — and makes identical decisions by
construction (same stage applies, same floats).  Numpy remains the reference
implementation (``use_kernel=False``, and always for single-query
``select``).  The two engines make identical decisions modulo exact float
ties: the fused pass scores in float32 (numpy accumulates in float64), so
candidates within ~1 ulp of each other can in principle resolve
differently, and an EXACT similarity tie at the kNN boundary resolves to
the lowest index in the fused pass but to an unspecified tied member in
numpy's ``argpartition`` — neither occurs on the parity suite or on real
float similarities.  SLO feasibility is compared in
float32 with directed rounding (tables up, thresholds down), so the fused
engine can only be *stricter* at a boundary within one float32 ulp of the
threshold — it never admits a path the float64 oracle rejects.

Table versioning (the online-adaptation seam, ``runtime/adaptation.py``):
everything the selector derives from an ``EvalTable`` lives in ONE
immutable ``_TableVersion`` snapshot behind ``self._ver``.  Every
selection entry point loads that reference exactly once and threads it
through scoring, fallback, and Decision construction, so a concurrent
``swap_table`` can never produce a torn read — a decision is drawn
entirely from version N or entirely from version N+1.  ``swap_table``
builds the new snapshot aside (including its device-resident stage state),
then publishes it with a single reference assignment under
``_kernel_build_lock``.  The fused pass is NOT rebuilt on swap: the
stage applies close over static config only (``kernels/stages.py`` threads
state as an argument), so the new version's state — same shapes, same
dtypes — runs through the existing pass and ``kernel_trace_count`` stays
bounded by shape buckets, never by table versions.

What stays frozen across versions: the DSQE parameters and prototypes, the
CCA set vocabulary / per-train-query set ids / best-path labels, the
projected train embeddings, and the path space (shapes are part of the
pass's contract).  What a new version recomputes: per-path latency/cost/accuracy
means (optionally blended with decayed online serving statistics, see
``OnlinePathStats``), the evaluated mask, the kNN vote weights, and the
per-version OOD-fallback memo.

The selector is generic over the path space's configuration axes: split
edge/cloud inference (``with_split_models``) and pipelined layer placement
(``with_placements`` — which device chain hosts which layer span,
``runtime/placement.py``) enter as ordinary model-stage choices with
emulated evidence rows, so "which shard plan" is selected per (query, SLO)
by the same kNN vote with zero selector-side special cases.  Both
extensions change the path-space SHAPE, so they are fixed at table build
time — the shape contract above is untouched.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.cca import CCAResult, find_best_path
from repro_torch.core.dsqe import DSQE
from repro_torch.core.emulator import EvalTable
from repro_torch.core.paths import MODULES, Path, PathSpace
from repro_torch.core.slo import SLO
from repro_torch.kernels.common import resolve_device

def _f32_ceil(x: np.ndarray) -> np.ndarray:
    """Smallest float32 >= each float64 value (inf/0 map exactly)."""
    y = np.asarray(x, np.float32)
    low = y.astype(np.float64) < np.asarray(x, np.float64)
    return np.where(low, np.nextafter(y, np.float32(np.inf)), y)


def _f32_floor(x: np.ndarray) -> np.ndarray:
    """Largest float32 <= each float64 value (inf/0 map exactly)."""
    y = np.asarray(x, np.float32)
    high = y.astype(np.float64) > np.asarray(x, np.float64)
    return np.where(high, np.nextafter(y, np.float32(-np.inf)), y)


def _count_bucket(owner, lock, bucket: int) -> None:
    """Bump ``owner.kernel_trace_count`` the first time its fused pass
    runs ``bucket`` (the JAX package counts a jit trace there)."""
    with lock:
        if bucket not in owner._buckets_seen:
            owner._buckets_seen.add(bucket)
            owner.kernel_trace_count += 1


def bucket_batch(B: int) -> int:
    """Power-of-two bucket (floor 8) for a fused-selector batch of B
    queries.  Padding every micro-batch up to its bucket bounds the shapes
    the scoring pass sees: any B in (bucket/2, bucket] shares one bucket."""
    return max(8, 1 << max(B - 1, 0).bit_length())


@dataclass(frozen=True)
class OnlinePathStats:
    """Decayed per-path serving statistics to blend into a table version.

    ``weight[j]`` in [0, 1] is the trust in the online estimate for path j
    (the adaptation plane derives it from the decayed observation count:
    ``n_eff / (n_eff + prior)``).  The blend is convex —
    ``(1-w)*emulated + w*online`` — and applies only where the emulated
    estimate exists and the online estimate is finite: a never-evaluated
    path cannot be promoted by serving evidence alone (evidence can only
    come from paths the runtime already selects), and paths with no online
    observations (w == 0) keep their emulated means bit-for-bit.
    """

    latency_s: np.ndarray  # (P,) observed mean, NaN where unobserved
    cost_usd: np.ndarray   # (P,)
    accuracy: np.ndarray   # (P,) judge-score mean, NaN where unobserved
    weight: np.ndarray     # (P,) blend weight in [0, 1]

    def blend(self, base: np.ndarray, obs: np.ndarray,
              valid: np.ndarray) -> np.ndarray:
        w = np.clip(np.nan_to_num(self.weight, nan=0.0), 0.0, 1.0)
        use = (w > 0) & valid & np.isfinite(obs)
        return np.where(use, (1.0 - w) * base + w * obs, base)


class _TableVersion:
    """One immutable snapshot of everything derived from an EvalTable.

    Readers load ``selector._ver`` once per call and never touch selector
    attributes for version-dependent data again — the snapshot is the
    torn-read barrier.  ``kernel_state`` / ``staged_states`` are the
    device-resident stage states for this version (built lazily or aside
    during a swap; the pass callables live on the selector and are shared by
    every version)."""

    __slots__ = ("version", "table", "path_latency", "path_cost",
                 "path_mean_acc", "path_evaluated", "lat_f", "cost_f",
                 "train_best_path", "train_best_acc", "fallback_memo",
                 "kernel_state", "staged_states")

    def __init__(self, version: int, table: EvalTable):
        self.version = version
        self.table = table
        self.fallback_memo: OrderedDict[tuple[int, SLO], Path] = OrderedDict()
        self.kernel_state = None
        self.staged_states = None


@dataclass
class Decision:
    path: Path
    set_id: int
    used_fallback: bool
    # per-query selection overhead: full wall-clock for `select`, the
    # amortized total/B share for `select_batch`.  This is the figure
    # `Response.selection_overhead_s` carries.
    overhead_s: float
    expected_latency_s: float
    expected_cost_usd: float
    # full wall-clock of the selection pass that produced this decision
    # (== overhead_s for `select`, == B * overhead_s for `select_batch`)
    batch_overhead_s: float = 0.0
    # which table snapshot the decision was drawn from (monotonic per
    # selector; bumped by `swap_table`)
    table_version: int = 0


class RuntimePathSelector:
    def __init__(self, space: PathSpace, dsqe: DSQE, cca: CCAResult,
                 table: EvalTable, train_embeddings: np.ndarray,
                 *, lam: int = 0, knn: int = 16, acc_floor: float = 0.5,
                 use_kernel: bool = False, fallback_memo_cap: int = 512):
        # knn=16: with the judge oracle's ±0.07 noise band, 8 neighbours let
        # a single noisy best-path vote dominate Eq. 14; 16 measures equal or
        # better accuracy on 4/5 domains (within 0.003 on the fifth) at
        # equal-or-lower cost (swept at budget=4, n_queries=100, seed=0).
        self.space = space
        self.dsqe = dsqe
        self.cca = cca
        self._train_embeddings = train_embeddings
        self.lam = lam  # 0 cost-first, 1 latency-first
        self.knn = knn
        self.acc_floor = acc_floor
        self.use_kernel = use_kernel
        # the fallback depends only on (set_id, slo) over one version's
        # tables, so a batch with many infeasible rows resolves each
        # distinct case once; the memo is LRU-capped — it is keyed by
        # (set_id, slo) and a tenant issuing many distinct SLO values
        # would otherwise grow it without bound
        self.fallback_memo_cap = fallback_memo_cap
        self._fallback_lock = threading.Lock()

        P = len(table.paths)
        K = len(self.cca.set_vocab)
        self.path_contains_set = np.zeros((K, P), bool)
        for k, req in enumerate(self.cca.set_vocab):
            for j, p in enumerate(table.paths):
                self.path_contains_set[k, j] = p.contains(req)

        protos = self.dsqe.to_numpy()["protos"]
        self._protos_unit = protos / np.maximum(
            np.linalg.norm(protos, axis=-1, keepdims=True), 1e-6)
        self._path_index = {p: j for j, p in enumerate(table.paths)}
        resolve_device(self.dsqe.device)  # the selector's tables live there
        self.train_emb_proj = self.dsqe.project(
            self._train_embeddings).cpu().numpy()
        # number of distinct batch buckets the fused pass has run (the JAX
        # package's jit trace count): bounded by the buckets seen, not the
        # distinct batch sizes or table versions (regression-tested)
        self.kernel_trace_count = 0
        self._buckets_seen: set[int] = set()
        self._kernel_build_lock = threading.Lock()  # concurrent handle_batch
        self._fused_pass = None     # the ONE fused pass, shared by versions
        self._staged_applies = None  # per-stage applies for the staged path
        self._ver = self._derive_version(table, None, 0)

    # -- versioned table snapshots --------------------------------------------

    def _derive_version(self, table: EvalTable,
                        online: OnlinePathStats | None,
                        version: int) -> _TableVersion:
        """Build (aside) one immutable snapshot of the table-derived state."""
        ver = _TableVersion(version, table)
        t = table
        # per-path expected latency/cost: mean over evaluated queries
        # (all-NaN columns — never-explored paths — warn as "empty slice")
        import warnings
        with np.errstate(invalid="ignore"), warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            lat = np.nanmean(t.latency, axis=0)
            cost = np.nanmean(t.cost, axis=0)
            acc = np.nanmean(t.accuracy, axis=0)
        lat = np.nan_to_num(lat, nan=np.inf)
        cost = np.nan_to_num(cost, nan=np.inf)
        acc = np.nan_to_num(acc, nan=0.0)
        # paths never explored by SBA have no evidence (all-NaN columns →
        # inf latency/cost above): under an unconstrained SLO `inf <= inf`
        # would pass the filter, so exclude them explicitly
        evaluated = t.evaluated.any(axis=0)
        if online is not None:
            lat = online.blend(lat, online.latency_s, evaluated)
            cost = online.blend(cost, online.cost_usd, evaluated)
            acc = online.blend(acc, online.accuracy, evaluated)
        ver.path_latency = lat
        ver.path_cost = cost
        ver.path_mean_acc = acc
        ver.path_evaluated = evaluated
        # plain-float copies keep the Decision-building epilogue off the
        # numpy-scalar conversion path (it is shared by both engines)
        ver.lat_f = [float(x) for x in lat]
        ver.cost_f = [float(x) for x in cost]
        rows = np.arange(len(t.query_ids))
        # per-train-row best-path labels (the kNN vote targets) are
        # TABLE-derived, so a swap re-derives them from the refreshed rows —
        # re-exploration that discovers a better path must move the vote.
        # Version 0 takes the CCA labels verbatim (same rule, same table:
        # bit-for-bit with the pre-versioned selector); refreshed rows are
        # relabelled with the SAME lexicographic rule (cca.find_best_path).
        if version == 0:
            tbp = np.array(self.cca.best_path, np.int64)
        else:
            from repro_torch.core.cca import find_best_path
            prev = self._ver.train_best_path
            tbp = np.array([
                find_best_path(t.accuracy[i], t.latency[i], t.cost[i],
                               self.lam)
                if np.any(~np.isnan(t.accuracy[i])) else prev[i]
                for i in rows], np.int64)
        ver.train_best_path = tbp
        ver.train_best_acc = t.accuracy[rows, tbp]
        return ver

    def swap_table(self, table: EvalTable, *,
                   online: OnlinePathStats | None = None) -> int:
        """Atomically replace the serving table snapshot; returns the new
        version number.

        Build-aside, swap-under-lock: the derived arrays AND the new
        device-resident stage state are constructed while readers keep
        serving the old version, then ``self._ver`` is repointed in one
        reference assignment under ``_kernel_build_lock``.  In-flight
        batches that already loaded the old version finish on it — never a
        torn read.  The fused pass is reused (state is an argument, not a
        closure), so a swap adds no bucket to ``kernel_trace_count``.

        Shapes are part of the pass's contract: the new table must cover the
        same query rows and path space as the one it replaces.
        """
        cur = self._ver
        if len(table.paths) != len(cur.table.paths) or \
                len(table.query_ids) != len(cur.table.query_ids):
            raise ValueError(
                "swap_table requires the frozen (Q, P) shape: got "
                f"({len(table.query_ids)}, {len(table.paths)}), serving "
                f"({len(cur.table.query_ids)}, {len(cur.table.paths)})")
        with self._kernel_build_lock:
            ver = self._derive_version(table, online, self._ver.version + 1)
            if self._fused_pass is not None:
                self._build_kernel_state(ver)
            if self._staged_applies is not None:
                self._build_staged_states(ver)
            self._ver = ver  # the publish: a single atomic reference store
        return ver.version

    # version-dependent state is attribute-compatible with the pre-versioned
    # selector: external readers (tests, benchmarks, the sharded selector)
    # see the CURRENT snapshot
    @property
    def table(self) -> EvalTable:
        return self._ver.table

    @property
    def table_version(self) -> int:
        return self._ver.version

    @property
    def path_latency(self) -> np.ndarray:
        return self._ver.path_latency

    @property
    def path_cost(self) -> np.ndarray:
        return self._ver.path_cost

    @property
    def path_mean_acc(self) -> np.ndarray:
        return self._ver.path_mean_acc

    @property
    def path_evaluated(self) -> np.ndarray:
        return self._ver.path_evaluated

    @property
    def train_best_path(self) -> np.ndarray:
        return self._ver.train_best_path

    @property
    def train_best_acc(self) -> np.ndarray:
        return self._ver.train_best_acc

    @property
    def _lat_f(self) -> list[float]:
        return self._ver.lat_f

    @property
    def _cost_f(self) -> list[float]:
        return self._ver.cost_f

    @property
    def _fallback_memo(self):
        return self._ver.fallback_memo

    # -- fused-kernel scoring pass --------------------------------------------

    def _selection_stages(self, ver: _TableVersion | None = None):
        """The four composable init/apply stages of the selection pipeline.

        ``embed -> retrieve -> score -> argmax`` as ``kernels.stages``
        Stage values; ``serial`` of these is the fused program,
        stage-by-stage execution is the staged A/B baseline.  SLO
        feasibility compares float32 on device but float64 in numpy: the
        latency/cost tables are rounded UP to float32 here (and the
        per-query thresholds DOWN, in ``_pad_bucket``) so the device engine
        can only be *stricter* — it never admits a path the float64 oracle
        rejects.
        """
        from repro_torch.kernels.common import NEG_INF
        from repro_torch.kernels.stages import (decode_stage, retrieve_stage,
                                                score_stage)

        dev = self.dsqe.device
        ver = ver if ver is not None else self._ver
        # masked entries come back as NEG_INF; anything above half of it is
        # a real (feasible) score — the constant is shared with kernel/ref
        self._kernel_floor = NEG_INF / 2

        N, P = len(ver.table.query_ids), len(ver.table.paths)
        pathw = np.zeros((N, P), np.float32)
        pathw[np.arange(N), ver.train_best_path] = np.nan_to_num(ver.train_best_acc)
        return [
            self.dsqe.as_stage(in_key="emb", out_key="z"),
            retrieve_stage(np.asarray(self.train_emb_proj, np.float32),
                           k=min(self.knn, N), query_key="z", device=dev),
            score_stage(self._protos_unit, pathw, self.path_contains_set,
                        _f32_ceil(ver.path_latency),
                        _f32_ceil(ver.path_cost),
                        1e-3 * ver.path_mean_acc, ver.path_evaluated,
                        query_key="z", slo_key="slo", device=dev),
            decode_stage(self._kernel_floor),
        ]

    def _ensure_kernel(self, ver: _TableVersion | None = None):
        """This version's stage state + the ONE end-to-end pass.

        The pass is built once per selector: every stage's apply closes over
        static config only and takes the state as an argument
        (``kernels/stages.py`` contract), so later table versions rebuild
        the STATE and reuse the pass.  Each batch then costs one
        host->device transfer of (B, d) embeddings and (B, 2) SLOs and one
        device->host read of the decision arrays — no host hop between
        stages.
        """
        ver = ver if ver is not None else self._ver
        if ver.kernel_state is not None and self._fused_pass is not None:
            return ver.kernel_state, self._fused_pass
        with self._kernel_build_lock:
            if ver.kernel_state is None or self._fused_pass is None:
                self._build_kernel_state(ver)
        return ver.kernel_state, self._fused_pass

    def _build_kernel_state(self, ver: _TableVersion):
        """Build ``ver``'s device state (and, first time, the pass).
        Caller holds ``_kernel_build_lock``."""
        from repro_torch.kernels.stages import serial

        state, fused_apply = serial(*self._selection_stages(ver)).init()
        if self._fused_pass is None:
            def _pass(state, embs, slo):
                carry = fused_apply(state, {"emb": embs, "slo": slo})
                return (carry["scores"], carry["set_id"], carry["best"],
                        carry["feasible"])

            self._fused_pass = _pass
        ver.kernel_state = state

    def _ensure_staged(self, ver: _TableVersion | None = None):
        """Per-stage applies for the staged A/B baseline (lazy, built once).

        The SAME stage list as the fused program, run one apply at a time
        so ``select_batch_staged`` pays a host round-trip at every stage
        boundary — the dispatch pattern the fused pass exists to kill.
        Does not touch ``kernel_trace_count``.  Like the fused path, the
        applies are shared across table versions and only the per-stage
        states are rebuilt on swap.
        """
        ver = ver if ver is not None else self._ver
        if ver.staged_states is not None and self._staged_applies is not None:
            return list(zip(ver.staged_states, self._staged_applies))
        with self._kernel_build_lock:
            if ver.staged_states is None or self._staged_applies is None:
                self._build_staged_states(ver)
        return list(zip(ver.staged_states, self._staged_applies))

    def _build_staged_states(self, ver: _TableVersion):
        """Caller holds ``_kernel_build_lock``."""
        pairs = [s.init() for s in self._selection_stages(ver)]
        if self._staged_applies is None:
            self._staged_applies = [ap for _, ap in pairs]
        ver.staged_states = [st for st, _ in pairs]

    def _pad_bucket(self, embs: np.ndarray, max_lat: np.ndarray,
                    max_cost: np.ndarray):
        """Bucket-pad a batch for the device engines.

        The query batch is padded up to its power-of-two bucket
        (``bucket_batch``) so varying micro-batch sizes share one shape per
        bucket instead of one per distinct B.  Pad rows are zero
        queries with IMPOSSIBLE (-inf) SLOs — all-infeasible by
        construction, so even before being sliced off they can never
        surface a decision — and every stage is row-independent, so they
        cannot leak into real rows either.  Returns (embs32 (Bb,d),
        slo32 (Bb,2), B).
        """
        B = embs.shape[0]
        Bb = bucket_batch(B)
        lat32, cost32 = _f32_floor(max_lat), _f32_floor(max_cost)
        embs32 = np.asarray(embs, np.float32)
        if Bb != B:
            pad = Bb - B
            embs32 = np.concatenate(
                [embs32, np.zeros((pad, embs32.shape[1]), np.float32)])
            lat32 = np.concatenate(
                [lat32, np.full(pad, -np.inf, np.float32)])
            cost32 = np.concatenate(
                [cost32, np.full(pad, -np.inf, np.float32)])
        return embs32, np.stack([lat32, cost32], axis=1).astype(np.float32), B

    def _score_batch_kernel(self, embs: np.ndarray, max_lat: np.ndarray,
                            max_cost: np.ndarray, ver: _TableVersion):
        """One fused pass: masked scores (B, P), set ids, argmax decisions
        and feasibility flags (B,), all as numpy with pad rows sliced off."""
        embs32, slo32, B = self._pad_bucket(embs, max_lat, max_cost)
        state, score_pass = self._ensure_kernel(ver)
        self._count_bucket(embs32.shape[0])
        dev = self.dsqe.device
        scores, set_ids, best, feas = score_pass(
            state, torch.from_numpy(embs32).to(dev),
            torch.from_numpy(slo32).to(dev))
        return (scores.cpu().numpy()[:B],
                set_ids.cpu().numpy().astype(np.int64)[:B],
                best.cpu().numpy().astype(np.int64)[:B],
                feas.cpu().numpy()[:B])

    def _count_bucket(self, bucket: int) -> None:
        _count_bucket(self, self._kernel_build_lock, bucket)

    # -- Algorithm 3 ----------------------------------------------------------

    def select(self, query_emb: np.ndarray, slo: SLO) -> Decision:
        t0 = time.perf_counter()
        ver = self._ver  # one load: the whole decision reads this snapshot
        z = self.dsqe.project(query_emb[None]).cpu().numpy()[0]
        set_id = int(np.argmax(self._protos_unit @ z))

        feasible = (
            (ver.path_latency <= slo.max_latency_s)
            & (ver.path_cost <= slo.max_cost_usd)
            & self.path_contains_set[set_id]
            & ver.path_evaluated
        )
        if not feasible.any():
            path = self._fallback(set_id, slo, ver)
            j = self._path_index[path]
            dt = time.perf_counter() - t0
            return Decision(path, set_id, True, dt,
                            ver.lat_f[j], ver.cost_f[j],
                            batch_overhead_s=dt, table_version=ver.version)

        # Eq. 14: sum over k nearest training queries of w_q * A(q, P_q) *
        # I[P_q == P].  The similarity pass runs only for in-distribution
        # queries — fallback rows above never pay for it.
        sims = self.train_emb_proj @ z  # (N,)
        k = min(self.knn, sims.shape[0])
        nn = np.argpartition(-sims, k - 1)[:k]
        w = np.maximum(sims[nn], 0.0)
        scores = np.zeros(len(ver.table.paths))
        np.add.at(scores, ver.train_best_path[nn], w * np.nan_to_num(ver.train_best_acc[nn]))
        # break ties / unseen paths with global mean accuracy prior
        scores = scores + 1e-3 * ver.path_mean_acc
        scores[~feasible] = -np.inf
        j = int(np.argmax(scores))
        dt = time.perf_counter() - t0
        return Decision(ver.table.paths[j], set_id, False, dt,
                        ver.lat_f[j], ver.cost_f[j],
                        batch_overhead_s=dt, table_version=ver.version)

    def _score_batch_numpy(self, embs: np.ndarray, max_lat: np.ndarray,
                           max_cost: np.ndarray, ver: _TableVersion):
        """Reference vectorized scoring: (B, P) masked scores + (B,) set ids."""
        B = embs.shape[0]
        Z = self.dsqe.project(embs).cpu().numpy()  # (B, d)
        set_ids = np.argmax(Z @ self._protos_unit.T, axis=1)  # (B,)

        feasible = (
            (ver.path_latency[None, :] <= max_lat[:, None])
            & (ver.path_cost[None, :] <= max_cost[:, None])
            & self.path_contains_set[set_ids]
            & ver.path_evaluated[None, :]
        )  # (B, P)

        sims = self.train_emb_proj @ Z.T  # (N, B)
        P = len(ver.table.paths)
        k = min(self.knn, sims.shape[0])
        nn = np.argpartition(-sims, k - 1, axis=0)[:k].T  # (B, k), per-row kNN
        w = np.maximum(np.take_along_axis(sims.T, nn, axis=1), 0.0)
        contrib = w * np.nan_to_num(ver.train_best_acc)[nn]
        rows = np.repeat(np.arange(B), k)
        scores = np.zeros((B, P))
        np.add.at(scores, (rows, ver.train_best_path[nn].ravel()), contrib.ravel())
        scores = scores + 1e-3 * ver.path_mean_acc
        scores[~feasible] = -np.inf
        return scores, set_ids

    def select_batch(self, query_embs: np.ndarray, slos) -> list[Decision]:
        """Vectorized Algorithm 3 over a batch of queries.

        ``slos`` is one SLO for the whole batch or a per-query sequence.
        One DSQE projection, one train-similarity pass, and one (B, P)
        score scatter replace B independent ``select`` calls; with
        ``use_kernel=True`` the whole scoring pass instead runs as a single
        device pass (see the module docstring).  The algorithm
        (hard top-k kNN vote, score prior, tie-breaks) is identical to
        ``select``; batched matmuls (and the kernel's float32 accumulation)
        may differ from the single-query matvecs in the last float ulp, so a
        decision can in principle diverge when two candidates are within
        ~1 ulp of each other.
        """
        t0 = time.perf_counter()
        ver = self._ver  # one load: the whole batch reads this snapshot
        embs, slo_list, max_lat, max_cost = self._batch_inputs(query_embs, slos)

        if self.use_kernel:
            # thin driver over the fused program: scores, set ids, argmax
            # decisions and feasibility all come back from ONE device pass
            _, set_ids, best, has_feasible = self._score_batch_kernel(
                embs, max_lat, max_cost, ver)
        else:
            scores, set_ids = self._score_batch_numpy(embs, max_lat, max_cost, ver)
            best = np.argmax(scores, axis=1)
            has_feasible = scores[np.arange(embs.shape[0]), best] > -np.inf
        return self._decisions(slo_list, set_ids, best, has_feasible, t0, ver)

    def select_batch_staged(self, query_embs: np.ndarray, slos) -> list[Decision]:
        """A/B baseline: the SAME four stages as the fused engine, executed
        one stage at a time with a full host round-trip (device -> numpy ->
        device) at every stage boundary.  Decisions are identical to
        ``select_batch(use_kernel=True)`` by construction — same stage
        applies over the same float32 state — this path only exists to
        measure what the fused pass buys."""
        t0 = time.perf_counter()
        ver = self._ver
        embs, slo_list, max_lat, max_cost = self._batch_inputs(query_embs, slos)
        embs32, slo32, B = self._pad_bucket(embs, max_lat, max_cost)
        dev = self.dsqe.device
        carry = {"emb": torch.from_numpy(embs32).to(dev),
                 "slo": torch.from_numpy(slo32).to(dev)}
        for state, apply in self._ensure_staged(ver):
            carry = apply(state, carry)
            # the host hop the fused pass eliminates: pull every carry
            # tensor to numpy, push it back
            carry = {key: torch.from_numpy(v.cpu().numpy()).to(dev)
                     for key, v in carry.items()}
        set_ids = carry["set_id"].cpu().numpy().astype(np.int64)[:B]
        best = carry["best"].cpu().numpy().astype(np.int64)[:B]
        has_feasible = carry["feasible"].cpu().numpy()[:B]
        return self._decisions(slo_list, set_ids, best, has_feasible, t0, ver)

    def _batch_inputs(self, query_embs, slos):
        embs = np.asarray(query_embs)
        B = embs.shape[0]
        slo_list = [slos] * B if isinstance(slos, SLO) else list(slos)
        if len(slo_list) != B:
            raise ValueError(f"got {len(slo_list)} SLOs for {B} queries")
        max_lat = np.array([s.max_latency_s for s in slo_list])
        max_cost = np.array([s.max_cost_usd for s in slo_list])
        return embs, slo_list, max_lat, max_cost

    def _decisions(self, slo_list, set_ids, best, has_feasible,
                   t0: float, ver: _TableVersion | None = None) -> list[Decision]:
        """Shared epilogue: host-side OOD fallback + Decision construction."""
        ver = ver if ver is not None else self._ver
        B = len(slo_list)
        set_l, best_l, feas_l = set_ids.tolist(), best.tolist(), has_feasible.tolist()
        picks: list[tuple[int, bool]] = []
        for b in range(B):
            if feas_l[b]:
                picks.append((best_l[b], False))
            else:
                path = self._fallback(set_l[b], slo_list[b], ver)
                picks.append((self._path_index[path], True))
        total_overhead = time.perf_counter() - t0
        overhead = total_overhead / max(B, 1)  # amortized per-query share
        return [Decision(ver.table.paths[j], set_l[b], fell_back,
                         overhead, ver.lat_f[j], ver.cost_f[j],
                         batch_overhead_s=total_overhead,
                         table_version=ver.version)
                for b, (j, fell_back) in enumerate(picks)]

    def _fallback(self, set_id: int, slo: SLO,
                  ver: _TableVersion | None = None) -> Path:
        """OOD fallback (Algorithm 3 lines 10-11): respect the critical set,
        demand accuracy above the floor, minimize cost (λ=0) / latency."""
        ver = ver if ver is not None else self._ver
        memo = ver.fallback_memo
        with self._fallback_lock:
            hit = memo.get((set_id, slo))
            if hit is not None:
                memo.move_to_end((set_id, slo))  # LRU touch
                return hit
        mask = self.path_contains_set[set_id] & (ver.path_mean_acc >= self.acc_floor)
        if not mask.any():
            mask = ver.path_mean_acc >= self.acc_floor
        if not mask.any():
            mask = np.ones(len(ver.table.paths), bool)
        second = ver.path_latency if self.lam == 1 else ver.path_cost
        cand = np.where(mask)[0]
        path = ver.table.paths[int(cand[np.argmin(second[cand])])]
        with self._fallback_lock:
            memo[(set_id, slo)] = path
            memo.move_to_end((set_id, slo))
            while len(memo) > self.fallback_memo_cap:
                memo.popitem(last=False)  # evict least-recently-used
        return path


class DomainShardedSelector:
    """Per-domain selection-table shards behind ONE fused device program.

    A multi-tenant server composes several ``DomainData``s, each with its own
    trained ``RuntimePathSelector``.  Instead of one fused pass (and one
    resident copy of the pipeline) per domain, this selector stacks every
    domain's device state on a leading domain axis — DSQE projection
    parameters (shapes agree across domains by construction), projected
    train embeddings, prototypes, vote weights, containment, SLO tables —
    padded to the fleet-wide maxima with validity masks, and selects the
    shard row with a SCALAR ``domain_id`` carry key inside the pass
    (``kernels/stages.py`` shard stages).  Switching domains re-runs the
    SAME pass: ``kernel_trace_count`` stays bounded by batch shape buckets,
    not by tenants or domains.

    One admission bucket = one domain (the orchestrator groups bucket rows
    by domain before selection), so the id is scalar, not per-row — a
    per-row gather would materialize a (B, N, d) corpus intermediate.

    Decision-level parity with each domain's own numpy oracle
    (``RuntimePathSelector.select_batch``) holds by the same argument as the
    single-domain fused engine (module docstring), because pad rows are
    inert by construction: padded train rows are masked to ``NEG_INF``
    before the top-k (vote weight ``max(NEG_INF, 0) = 0`` and an all-zero
    ``path_weights`` row), padded prototypes are masked out of the
    critical-set argmax (``proto_valid``), and the per-path tables are each
    domain's own directed-rounded float32 rows.  The host epilogue
    (fallback, Decision construction) delegates to the owning domain's
    selector, so fallback memoization and path identity stay per-domain.

    Table versioning: the stacked device state captures each domain's
    ``_TableVersion`` at build time, and the (state, pass, versions)
    triple is swapped as ONE reference — a batch either scores against the
    whole old stack or the whole new one.  After a per-domain
    ``swap_table``, call ``refresh_tables()`` to restack; like the
    single-domain engine this rebuilds the state only and reuses the pass,
    so refreshes add no bucket.
    """

    def __init__(self, selectors: "dict[str, RuntimePathSelector]"):
        if not selectors:
            raise ValueError("DomainShardedSelector needs >= 1 domain")
        self.names = list(selectors)
        self._sel = dict(selectors)
        self.domain_ids = {n: i for i, n in enumerate(self.names)}
        sels = [self._sel[n] for n in self.names]
        first = sels[0]
        P = len(first.table.paths)
        for n, s in zip(self.names, sels):
            if len(s.table.paths) != P:
                raise ValueError(
                    f"domain {n!r}: path space size {len(s.table.paths)} != {P}"
                    " — sharded tables need one shared path space shape")
            if s.knn != first.knn:
                raise ValueError(f"domain {n!r}: knn {s.knn} != {first.knn}")
            if s.train_emb_proj.shape[1] != first.train_emb_proj.shape[1]:
                raise ValueError(f"domain {n!r}: projection width differs")
        for n, s in zip(self.names, sels):
            if s.dsqe.device != first.dsqe.device:
                raise ValueError(f"domain {n!r}: encoder on {s.dsqe.device}, "
                                 f"not {first.dsqe.device}")
        self.knn = first.knn
        self.device = first.dsqe.device
        # distinct batch buckets the fused pass has run (see
        # RuntimePathSelector.kernel_trace_count)
        self.kernel_trace_count = 0
        self._buckets_seen: set[int] = set()
        # (stacked state, pass, {domain: _TableVersion}) — swapped as one
        # reference so readers never see a half-refreshed stack
        self._kernel_state = None
        self._staged_state = None  # ([(state, apply), ...], {domain: ver})
        # bumped by every refresh_tables(); telemetry only
        self.table_epoch = 0
        self._build_lock = threading.Lock()

    def selector(self, domain: str) -> RuntimePathSelector:
        return self._sel[domain]

    # -- stacked table construction -------------------------------------------

    def _capture_versions(self) -> dict:
        return {n: self._sel[n]._ver for n in self.names}

    def _selection_stages(self, vers: dict):
        """Domain-sharded mirror of ``RuntimePathSelector._selection_stages``:
        same four-stage pipeline, every table stacked (D, ...) with pad
        validity masks, the shard row gathered by the ``domain_id`` carry.
        ``vers`` pins each domain's table snapshot for this stack."""
        from repro_torch.kernels.common import NEG_INF
        from repro_torch.kernels.stages import (decode_stage,
                                                shard_projection_stage,
                                                shard_retrieve_stage,
                                                shard_score_stage)

        self._kernel_floor = NEG_INF / 2
        sels = [self._sel[n] for n in self.names]
        vlist = [vers[n] for n in self.names]
        D = len(sels)
        P = len(vlist[0].table.paths)
        dp = sels[0].train_emb_proj.shape[1]
        K_max = max(s._protos_unit.shape[0] for s in sels)
        N_max = max(s.train_emb_proj.shape[0] for s in sels)

        params = [s.dsqe.to_numpy() for s in sels]
        n_layers = len(params[0]["layers"])
        layers = [
            {"w": np.stack([p["layers"][i]["w"] for p in params]),
             "b": np.stack([p["layers"][i]["b"] for p in params])}
            for i in range(n_layers)]

        protos = np.zeros((D, K_max, dp), np.float32)
        proto_valid = np.zeros((D, K_max), np.float32)
        train = np.zeros((D, N_max, dp), np.float32)
        train_valid = np.zeros((D, N_max), np.float32)
        pathw = np.zeros((D, N_max, P), np.float32)
        contains = np.zeros((D, K_max, P), np.float32)
        lat = np.zeros((D, P), np.float32)
        cost = np.zeros((D, P), np.float32)
        prior = np.zeros((D, P), np.float32)
        valid = np.zeros((D, P), np.float32)
        for di, (s, v) in enumerate(zip(sels, vlist)):
            K = s._protos_unit.shape[0]
            N = s.train_emb_proj.shape[0]
            protos[di, :K] = s._protos_unit
            proto_valid[di, :K] = 1.0
            train[di, :N] = s.train_emb_proj
            train_valid[di, :N] = 1.0
            pw = np.zeros((N, P), np.float32)
            pw[np.arange(N), v.train_best_path] = np.nan_to_num(
                v.train_best_acc)
            pathw[di, :N] = pw
            contains[di, :K] = s.path_contains_set
            lat[di] = _f32_ceil(v.path_latency)
            cost[di] = _f32_ceil(v.path_cost)
            prior[di] = 1e-3 * v.path_mean_acc
            valid[di] = v.path_evaluated
        dev = self.device
        return [
            shard_projection_stage(layers, in_key="emb", out_key="z",
                                   device=dev),
            shard_retrieve_stage(train, train_valid,
                                 k=min(self.knn, N_max), query_key="z",
                                 device=dev),
            shard_score_stage(protos, proto_valid, pathw, contains, lat,
                              cost, prior, valid, query_key="z",
                              slo_key="slo", device=dev),
            decode_stage(self._kernel_floor),
        ]

    def _ensure_kernel(self):
        if self._kernel_state is not None:
            return self._kernel_state
        with self._build_lock:
            if self._kernel_state is not None:
                return self._kernel_state
            from repro_torch.kernels.stages import serial

            vers = self._capture_versions()
            state, fused_apply = serial(*self._selection_stages(vers)).init()

            def _pass(state, embs, slo, did):
                carry = fused_apply(
                    state, {"emb": embs, "slo": slo, "domain_id": did})
                return (carry["scores"], carry["set_id"], carry["best"],
                        carry["feasible"])

            self._kernel_state = (state, _pass, vers)
            return self._kernel_state

    def _ensure_staged(self):
        if self._staged_state is not None:
            return self._staged_state
        with self._build_lock:
            if self._staged_state is None:
                vers = self._capture_versions()
                pairs = [s.init() for s in self._selection_stages(vers)]
                self._staged_state = (pairs, vers)
        return self._staged_state

    def refresh_tables(self) -> int:
        """Restack the per-domain tables after one or more ``swap_table``
        calls on the underlying selectors.  Build-aside like the
        single-domain swap: the new stacked state is constructed while
        readers keep the old (state, pass, versions) triple, then published
        as one reference.  The pass (and the staged per-stage applies) are
        reused — state is an argument, so refreshes add no bucket."""
        from repro_torch.kernels.stages import serial

        with self._build_lock:
            self.table_epoch += 1
            vers = self._capture_versions()
            if self._kernel_state is not None:
                state, _ = serial(*self._selection_stages(vers)).init()
                self._kernel_state = (state, self._kernel_state[1], vers)
            if self._staged_state is not None:
                pairs = [st for st, _ in
                         (s.init() for s in self._selection_stages(vers))]
                applies = [ap for _, ap in self._staged_state[0]]
                self._staged_state = (list(zip(pairs, applies)), vers)
            return self.table_epoch

    # -- selection ------------------------------------------------------------

    def select_batch(self, query_embs: np.ndarray, slos,
                     domain: str) -> list[Decision]:
        """Fused selection for one domain's query batch (one admission
        bucket).  Same bucket padding as the single-domain engine; the
        domain id rides as a scalar in the carry."""
        t0 = time.perf_counter()
        sel = self._sel[domain]
        did = self.domain_ids[domain]
        embs, slo_list, max_lat, max_cost = sel._batch_inputs(
            query_embs, slos)
        embs32, slo32, B = sel._pad_bucket(embs, max_lat, max_cost)
        state, score_pass, vers = self._ensure_kernel()
        _count_bucket(self, self._build_lock, embs32.shape[0])
        _, set_ids, best, feas = score_pass(
            state, torch.from_numpy(embs32).to(self.device),
            torch.from_numpy(slo32).to(self.device), did)
        return sel._decisions(slo_list,
                              set_ids.cpu().numpy().astype(np.int64)[:B],
                              best.cpu().numpy().astype(np.int64)[:B],
                              feas.cpu().numpy()[:B], t0, vers[domain])

    def select_batch_staged(self, query_embs: np.ndarray, slos,
                            domain: str) -> list[Decision]:
        """A/B baseline: same shard stages, host round-trip per boundary."""
        t0 = time.perf_counter()
        sel = self._sel[domain]
        did = self.domain_ids[domain]
        embs, slo_list, max_lat, max_cost = sel._batch_inputs(
            query_embs, slos)
        embs32, slo32, B = sel._pad_bucket(embs, max_lat, max_cost)
        dev = self.device
        carry = {"emb": torch.from_numpy(embs32).to(dev),
                 "slo": torch.from_numpy(slo32).to(dev)}
        pairs, vers = self._ensure_staged()
        for state, apply in pairs:
            carry = apply(state, {**carry, "domain_id": did})
            carry = {key: torch.from_numpy(v.cpu().numpy()).to(dev)
                     for key, v in carry.items() if key != "domain_id"}
        return sel._decisions(slo_list,
                              carry["set_id"].cpu().numpy().astype(np.int64)[:B],
                              carry["best"].cpu().numpy().astype(np.int64)[:B],
                              carry["feasible"].cpu().numpy()[:B], t0,
                              vers[domain])


def build_static_policy(table: EvalTable, lam: int, tol: float = 0.02) -> int:
    """Ablation Config 1 (paper §5.4): single best-average path — filter to
    within ``tol`` of best mean accuracy, then min cost/latency."""
    acc = np.nan_to_num(np.nanmean(table.accuracy, axis=0), nan=0.0)
    lat = np.nan_to_num(np.nanmean(table.latency, axis=0), nan=np.inf)
    cost = np.nan_to_num(np.nanmean(table.cost, axis=0), nan=np.inf)
    cand = np.where(acc >= acc.max() - tol)[0]
    second = lat if lam == 1 else cost
    return int(cand[np.argmin(second[cand])])
