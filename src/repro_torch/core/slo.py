"""Service Level Objectives (paper Eq. 4) and violation accounting."""
from __future__ import annotations

import threading
from dataclasses import dataclass, field


@dataclass(frozen=True)
class SLO:
    max_latency_s: float = float("inf")
    max_cost_usd: float = float("inf")  # per query

    def ok(self, latency_s: float, cost_usd: float) -> bool:
        return latency_s <= self.max_latency_s and cost_usd <= self.max_cost_usd


@dataclass
class SLOTracker:
    total: int = 0
    violated_queries: int = 0  # queries violating >= 1 dimension
    latency_violations: int = 0
    cost_violations: int = 0
    # concurrent handlers record through the same tracker; the lock keeps
    # the read-modify-write counters exact
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def record(self, slo: SLO, latency_s: float, cost_usd: float) -> None:
        lat_bad = latency_s > slo.max_latency_s
        cost_bad = cost_usd > slo.max_cost_usd
        with self._lock:
            self.total += 1
            if lat_bad:
                self.latency_violations += 1
            if cost_bad:
                self.cost_violations += 1
            if lat_bad or cost_bad:
                self.violated_queries += 1

    @property
    def violation_rate(self) -> float:
        """Fraction of queries violating at least one SLO dimension — a
        query blowing both latency and cost counts once, so the rate is
        bounded in [0, 1].  Per-dimension rates are reported separately."""
        if not self.total:
            return 0.0
        return self.violated_queries / self.total

    @property
    def latency_violation_rate(self) -> float:
        return self.latency_violations / self.total if self.total else 0.0

    @property
    def cost_violation_rate(self) -> float:
        return self.cost_violations / self.total if self.total else 0.0
