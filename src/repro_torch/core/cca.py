"""Critical Component Analysis (paper §3.3.2, Algorithm 2).

For each training query: find the best path P* (lexicographic — accuracy
first with 1% tolerance, then latency (λ=1) or cost (λ=0)); then for each
module type t, the impact of P*'s component value v is

    Impact(q,t,v) = mean acc over paths with t=v  -  mean acc over paths with t≠v   (Eqs. 7-9)

Components with impact > τ form the query's critical set Φ[q].  All the
per-query math is vectorized over the (Q, P) metric arrays.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.emulator import EvalTable
from repro_torch.core.paths import MODULES, Path


@dataclass
class CCAResult:
    critical_sets: list[tuple[tuple[str, str], ...]]  # per query: ((module, impl_key), ...)
    best_path: list[int]  # per query: best path index (into table.paths)
    set_vocab: list[tuple[tuple[str, str], ...]]  # K distinct critical sets
    set_ids: np.ndarray  # (Q,) index into set_vocab


def find_best_path(acc_row: np.ndarray, lat_row: np.ndarray, cost_row: np.ndarray,
                   lam: int, tol: float = 0.01) -> int:
    """Lexicographic: within ``tol`` of max accuracy, minimize latency/cost."""
    valid = ~np.isnan(acc_row)
    best_acc = np.nanmax(acc_row)
    cand = np.where(valid & (acc_row >= best_acc - tol))[0]
    second = lat_row if lam == 1 else cost_row
    return int(cand[np.argmin(second[cand])])


def critical_component_analysis(table: EvalTable, *, tau: float = 0.03,
                                lam: int = 0) -> CCAResult:
    paths = table.paths
    Q, P = table.accuracy.shape

    # component membership masks per (module, impl-key)
    masks: dict[tuple[str, str], np.ndarray] = {}
    for m in MODULES:
        for j, p in enumerate(paths):
            key = (m, p.component(m).key)
            masks.setdefault(key, np.zeros(P, bool))[j] = True

    critical_sets: list[tuple[tuple[str, str], ...]] = []
    best_paths: list[int] = []
    for qi in range(Q):
        acc = table.accuracy[qi]
        evald = ~np.isnan(acc)
        best = find_best_path(acc, table.latency[qi], table.cost[qi], lam)
        best_paths.append(best)
        crit: list[tuple[str, str]] = []
        for m in MODULES:
            v_key = (m, paths[best].component(m).key)
            with_mask = masks[v_key] & evald
            without_mask = ~masks[v_key] & evald
            if not with_mask.any() or not without_mask.any():
                continue
            impact = float(np.mean(acc[with_mask]) - np.mean(acc[without_mask]))
            if impact > tau:
                crit.append(v_key)
        critical_sets.append(tuple(crit))

    vocab: list[tuple[tuple[str, str], ...]] = sorted(set(critical_sets))
    vocab_idx = {s: i for i, s in enumerate(vocab)}
    set_ids = np.array([vocab_idx[s] for s in critical_sets], np.int64)
    return CCAResult(critical_sets, best_paths, vocab, set_ids)
