"""Query-resolution path space (paper §3.1).

A path P = (M_q, M_r, M_c, M_m): query processing, retrieval, context
processing, model selection — each a (implementation, parameter-config)
choice.  The space is the cartesian product (Eq. 1), filtered per device
(models must fit device RAM — the hardware-dependent path spaces of Table 3).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Iterable

from repro_torch.core.devices import EDGE_DEVICES, DeviceProfile, ModelProfile

MODULES = ("qproc", "retrieval", "cproc", "model")

# virtual model impl for CE-CoLLM split inference (edge drafts chunks behind a
# confidence gate, cloud verifies/continues low-confidence spans); parameters
# name the edge/cloud members and the early-exit threshold tau.  Opt-in via
# `with_split_models` so the default space (and every table keyed off it)
# stays byte-identical.
SPLIT_IMPL = "split"

# virtual model impl for pipelined layer placement (runtime/placement.py):
# the catalog model's layer stack is partitioned into contiguous stages
# across a device chain by the roofline + link cost model.  Parameters name
# the underlying catalog model and the "+"-joined chain.  Opt-in via
# `with_placements` — same byte-identical-default contract as SPLIT_IMPL.
PLACED_IMPL = "placed"


@dataclass(frozen=True)
class ComponentChoice:
    module: str  # one of MODULES
    impl: str
    params: tuple[tuple[str, Any], ...] = ()

    def param(self, key: str, default=None):
        for k, v in self.params:
            if k == key:
                return v
        return default

    @property
    def key(self) -> str:
        ps = ",".join(f"{k}={v}" for k, v in self.params)
        return f"{self.impl}({ps})" if ps else self.impl


@dataclass(frozen=True)
class Path:
    pid: int
    qproc: ComponentChoice
    retrieval: ComponentChoice
    cproc: ComponentChoice
    model: ComponentChoice

    def component(self, module: str) -> ComponentChoice:
        return getattr(self, module)

    @property
    def key(self) -> str:
        return "|".join(self.component(m).key for m in MODULES)

    def contains(self, required: Iterable[tuple[str, str]]) -> bool:
        """criticalComps ⊆ P check (Eq. 13): (module, impl-key) pairs."""
        return all(self.component(m).key == k for m, k in required)


# ---------------------------------------------------------------------------
# model catalog: assigned architectures playing the paper's edge SLM / cloud
# LLM roles (DESIGN.md §4).  quality_tier feeds the judge-oracle; pricing is
# GPT-4.1-era cloud pricing; edge models cost $0 (paper's accounting).
# ---------------------------------------------------------------------------

MODEL_CATALOG: dict[str, ModelProfile] = {
    "xlstm-125m": ModelProfile("xlstm-125m", 0.125, "edge", 0.40, arch="xlstm-125m"),
    "internlm2-1.8b": ModelProfile("internlm2-1.8b", 1.8, "edge", 0.56, arch="internlm2-1.8b"),
    "recurrentgemma-2b": ModelProfile("recurrentgemma-2b", 2.7, "edge", 0.62, arch="recurrentgemma-2b"),
    "gemma-7b": ModelProfile("gemma-7b", 8.5, "edge", 0.72, arch="gemma-7b"),
    "granite-8b-cloud": ModelProfile("granite-8b-cloud", 8.0, "cloud", 0.76,
                                     usd_per_1k_in=0.0001, usd_per_1k_out=0.0004, arch="granite-8b"),
    "llama4-scout-cloud": ModelProfile("llama4-scout-cloud", 17.0, "cloud", 0.87,
                                       usd_per_1k_in=0.0004, usd_per_1k_out=0.0016, arch="llama4-scout-17b-a16e"),
    "kimi-k2-cloud": ModelProfile("kimi-k2-cloud", 32.0, "cloud", 0.96,
                                  usd_per_1k_in=0.002, usd_per_1k_out=0.008, arch="kimi-k2-1t-a32b"),
}

EDGE_MODEL_GB_PER_B = 0.75  # 4-bit weights + KV + runtime overhead per B params


def model_fits_device(m: ModelProfile, device: DeviceProfile) -> bool:
    if m.placement == "cloud":
        return True
    return m.params_b * EDGE_MODEL_GB_PER_B <= device.ram_gb * 0.75


# ---------------------------------------------------------------------------
# default component spec (≈ paper's §5.1 configuration: 3+ edge models,
# 3 cloud tiers, step-back + compression, basic RAG + HyDE, corrective RAG +
# reranking -> 200-300 paths per domain/device)
# ---------------------------------------------------------------------------

DEFAULT_SPEC: dict[str, dict[str, dict[str, list]]] = {
    "qproc": {
        "null": {},
        "stepback": {"abstraction": [1]},
        "compress": {"ratio": [0.5]},
    },
    "retrieval": {
        "null": {},
        "basic_rag": {"top_k": [2, 8]},
        "hyde": {"top_k": [8], "hypotheses": [1]},
    },
    "cproc": {
        "null": {},
        "rerank": {"keep": [2]},
        "corrective_rag": {"threshold": [0.35]},
    },
    "model": {name: {} for name in MODEL_CATALOG},
}


def with_split_models(spec: dict | None = None, *,
                      edges: Iterable[str] = ("internlm2-1.8b",
                                              "recurrentgemma-2b"),
                      clouds: Iterable[str] = ("llama4-scout-cloud",
                                               "kimi-k2-cloud"),
                      taus: Iterable[float] = (0.6,)) -> dict:
    """A spec extending ``spec`` (default: ``DEFAULT_SPEC``) with split
    edge-draft/cloud-verify model choices — one per (edge, cloud, tau)."""
    base = dict(spec or DEFAULT_SPEC)
    base["model"] = dict(base["model"])
    base["model"][SPLIT_IMPL] = {
        "edge": list(edges), "cloud": list(clouds), "tau": list(taus)}
    return base


DEFAULT_PLACEMENT_MODELS = ("internlm2-1.8b", "gemma-7b")
DEFAULT_PLACEMENT_CHAINS = ("orin+m4", "orin+m4+cloud")


def with_placements(spec: dict | None = None, *,
                    models: Iterable[str] = DEFAULT_PLACEMENT_MODELS,
                    chains: Iterable[str] = DEFAULT_PLACEMENT_CHAINS) -> dict:
    """A spec extending ``spec`` (default: ``DEFAULT_SPEC``) with pipelined
    placement model choices — one per (catalog model, device chain), chains
    as "+"-joined device names (``runtime/placement.py``).  Composes with
    ``with_split_models`` (pass its result as ``spec``)."""
    base = dict(spec or DEFAULT_SPEC)
    base["model"] = dict(base["model"])
    base["model"][PLACED_IMPL] = {
        "model": list(models), "chain": list(chains)}
    return base


class PathSpace:
    def __init__(self, spec: dict | None = None, device: DeviceProfile | None = None):
        self.spec = spec or DEFAULT_SPEC
        self.device = device or EDGE_DEVICES["m4"]
        self.paths: list[Path] = list(self._enumerate())
        self.by_key = {p.key: p for p in self.paths}

    def _choices(self, module: str) -> list[ComponentChoice]:
        out = []
        for impl, grid in self.spec[module].items():
            if module == "model":
                if impl == SPLIT_IMPL:
                    # split inference runs its draft loop on-device: the
                    # configuration fits iff its edge member fits (the cloud
                    # member always "fits" — it is remote)
                    keys = sorted(grid)
                    for combo in itertools.product(*(grid[k] for k in keys)):
                        params = dict(zip(keys, combo))
                        if not model_fits_device(
                                MODEL_CATALOG[params["edge"]], self.device):
                            continue
                        out.append(ComponentChoice(
                            module, impl, tuple(zip(keys, combo))))
                    continue
                if impl == PLACED_IMPL:
                    # placed paths are filtered by their placement plan's
                    # memory fit, and the planner is outside this port
                    raise NotImplementedError(
                        "placed paths need runtime.placement, not ported yet "
                        "(ROADMAP.md queue 1: serving runtime — adaptation, "
                        "router, placement)")
                prof = MODEL_CATALOG[impl]
                if not model_fits_device(prof, self.device):
                    continue
            if not grid:
                out.append(ComponentChoice(module, impl))
                continue
            keys = sorted(grid)
            for combo in itertools.product(*(grid[k] for k in keys)):
                out.append(ComponentChoice(module, impl, tuple(zip(keys, combo))))
        return out

    def _enumerate(self):
        pid = 0
        for qp, rt, cp, mm in itertools.product(
            self._choices("qproc"), self._choices("retrieval"),
            self._choices("cproc"), self._choices("model"),
        ):
            # a context processor without retrieval is a no-op path variant:
            # skip to keep the space non-degenerate (paper prunes these too)
            if rt.impl == "null" and cp.impl != "null":
                continue
            yield Path(pid, qp, rt, cp, mm)
            pid += 1

    def __len__(self) -> int:
        return len(self.paths)

    def model_profile(self, path: Path) -> ModelProfile:
        if path.model.impl == SPLIT_IMPL:
            # the on-device half; callers sizing RAM/latency budgets see the
            # resident edge member (the cloud half never occupies the device)
            return MODEL_CATALOG[path.model.param("edge")]
        if path.model.impl == PLACED_IMPL:
            # placement moves layers, not weights: quality/pricing callers
            # see the underlying catalog model (its layers live on the
            # plan's chain, not the space's resident device)
            return MODEL_CATALOG[path.model.param("model")]
        return MODEL_CATALOG[path.model.impl]
