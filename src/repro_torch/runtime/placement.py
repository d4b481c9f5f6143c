"""Pipelined edge-cloud model placement plane (the placement contract),
the JAX package's (``src/repro/runtime/placement.py``) decision for decision:
pure host code, so plans are equal field for field.

EdgeShard-style layer-wise partitioning (PAPERS.md): given a model's layer
stack, an ordered device chain (edge tiers + optionally ``cloud``), and an
SLO, the search assigns CONTIGUOUS layer spans to devices and returns a
``PlacementPlan`` — stage→device assignment, predicted pipelined prefill
latency, per-token decode latency, per-token cost, and a memory-fit verdict.
Plans are what ``with_placements`` (core/paths.py) registers as resolution
paths: "which shard plan" becomes one more axis of the paper's joint
optimization, selectable per (query, SLO) by the CCA/RPS like any other
component choice.

What the cost model promises (``perf/cost_model.py``):

  * Per-layer FLOPs and bytes come from ``model_layer_costs`` — the same
    analytic roofline the rest of ``perf/`` uses, calibrated so per-layer
    parameter bytes sum exactly to the meta-device ``param_count()``.
  * Stage prefill time per micro-batch is the device roofline
    ``max(compute, weight-stream floor)`` — identical structure to
    ``core/devices.py prefill_latency_s`` — plus the outgoing activation
    transfer (``LinkProfile``: rtt + residual-stream bytes / bandwidth).
  * Stage decode time per token is bandwidth-bound on the bytes actually
    streamed (MoE: router + routed-k + shared experts, not every expert),
    with the same per-boundary transfer added per token.

Memory-fit rules: a stage must hold its layer span's resident weights
(MoE: EVERY expert — routing is data-dependent) plus its per-sequence
caches at the reference context, within ``ram_gb * 0.75`` of its device —
the same headroom fraction ``model_fits_device`` applies to whole models.
The first stage also holds the embedding, the last the LM head (tied heads
are counted once, with the embedding).  The cloud profile is treated as
capacity-unbounded, consistent with ``model_fits_device`` for cloud models.

Bubble model: ``m`` equal micro-batches flow through the stages GPipe-style;
each stage is busy ``t_i`` per micro-batch (compute/stream roof + blocking
send).  For identical micro-batches the flow-shop makespan is EXACTLY
``sum(t_i) + (m-1) * max(t_i)`` — the fill/drain bubble plus the
max-stage bottleneck — and ``simulate_pipeline`` (an event-driven schedule
of the same plan) reproduces the closed form to float tolerance; the
equality is gated in ``tests/test_torch_placement.py``.  Per-request
fixed costs (device launch overheads, one ``CLOUD_RTT_S`` when the chain
reaches the cloud) are charged once, outside the overlapped region.

What stays frozen: ``DEFAULT_SPEC`` and every table keyed off it are
byte-identical with placements off (opt-in via ``with_placements``, the
``with_split_models`` pattern); plans never change response *quality* —
placement moves layers, not weights, so the judge reads the underlying
catalog model's tier; and plan search is deterministic (pure function of
(model, chain, SLO, prompt reference), memoized process-wide).

Cost accounting: edge compute is free (the paper's accounting); the
cloud-resident layer *fraction* of a placed model is billed at the model's
catalog per-token rates, or at a flat documented rate
(``PLACED_USD_PER_1K_IN/OUT``) for edge models with no cloud price.
"""
from __future__ import annotations

import itertools
import math
import threading
from dataclasses import dataclass
from typing import Sequence

from repro_torch.core.devices import (CLOUD_DEVICE, CLOUD_RTT_S,
                                      EDGE_DEVICES, DeviceProfile)
from repro_torch.models.config import ModelConfig
from repro_torch.perf.cost_model import (BYTES, LAN_LINK, WAN_LINK,
                                         LinkProfile, embed_head_bytes,
                                         head_flops_per_token,
                                         model_layer_costs)

RAM_FRACTION = 0.75  # usable fraction of device RAM (= model_fits_device)
DEFAULT_PROMPT_TOKENS = 512  # reference prompt the search optimizes for
DEFAULT_OUT_TOKENS = 150  # reference decode tail (= core.pipeline.OUT_TOKENS)
MICROBATCH_GRID = (1, 2, 4, 8)
# flat cloud rate for placed layer-fractions of models with no catalog price
PLACED_USD_PER_1K_IN = 0.0002
PLACED_USD_PER_1K_OUT = 0.0008


def device_profile(name: str) -> DeviceProfile:
    return CLOUD_DEVICE if name == "cloud" else EDGE_DEVICES[name]


def link_between(a: str, b: str) -> LinkProfile:
    return WAN_LINK if "cloud" in (a, b) else LAN_LINK


def _avail_bytes(dev: DeviceProfile) -> float:
    if dev.name == "cloud":
        return math.inf  # consistent with model_fits_device for cloud
    return dev.ram_gb * RAM_FRACTION * 1e9


@dataclass(frozen=True)
class StagePlan:
    """One pipeline stage: a contiguous layer span resident on one device."""

    device: str
    start: int  # block indices [start, end)
    end: int
    weight_bytes: float  # resident params incl. embed/head attachment
    mem_bytes: float  # weights + per-sequence caches at reference context
    flops_per_s: float  # device sustained FLOP/s (tflops * 1e12 * util)
    mem_bytes_per_s: float
    prefill_flops_per_token: float
    decode_flops_per_token: float
    decode_stream_bytes: float  # active weights touched per decode token
    out_rtt_s: float = 0.0  # link to the next stage (zeros on the last)
    out_gbytes_per_s: float = 0.0

    @property
    def n_layers(self) -> int:
        return self.end - self.start

    def prefill_time_s(self, micro_tokens: float) -> float:
        """Busy time per micro-batch: roofline + blocking send."""
        comp = micro_tokens * self.prefill_flops_per_token / self.flops_per_s
        t = max(comp, self.weight_bytes / self.mem_bytes_per_s)
        if self.out_gbytes_per_s:
            t += self.out_rtt_s + micro_tokens * self._act_bytes \
                / (self.out_gbytes_per_s * 1e9)
        return t

    def decode_time_s(self) -> float:
        """Per-token busy time: bandwidth/compute roof + boundary transfer."""
        t = max(self.decode_flops_per_token / self.flops_per_s,
                self.decode_stream_bytes / self.mem_bytes_per_s)
        if self.out_gbytes_per_s:
            t += self.out_rtt_s + self._act_bytes / (self.out_gbytes_per_s * 1e9)
        return t

    # activation bytes per boundary token, stamped by the search
    _act_bytes: float = 0.0


@dataclass(frozen=True)
class PlacementPlan:
    """A complete placement decision for one (model, device chain)."""

    model: str  # MODEL_CATALOG name (or raw arch for ad-hoc plans)
    arch: str
    chain: tuple[str, ...]  # ordered candidate devices, as requested
    stages: tuple[StagePlan, ...]  # used (non-empty) stages, chain order
    micro_batches: int
    prompt_tokens: int  # reference prompt length the plan optimized for
    overhead_s: float  # per-request fixed costs (launch + cloud RTT once)
    predicted_prefill_s: float  # at the reference prompt
    predicted_decode_s_per_token: float
    usd_per_1k_in: float  # already scaled by the cloud layer fraction
    usd_per_1k_out: float
    cloud_fraction: float  # fraction of blocks resident on the cloud
    memory_ok: bool
    slo_ok: bool = True  # predicted TTFT within the SLO given to the search

    @property
    def key(self) -> str:
        return f"{self.model}@{'+'.join(self.chain)}"

    def prefill_latency_s(self, prompt_tokens: int) -> float:
        """Bubble-aware pipelined TTFT: GPipe makespan over the plan's
        micro-batch count at an arbitrary prompt length."""
        tm = prompt_tokens / self.micro_batches
        t = [s.prefill_time_s(tm) for s in self.stages]
        return self.overhead_s + sum(t) + (self.micro_batches - 1) * max(t)

    def decode_latency_s(self, out_tokens: int) -> float:
        return out_tokens * self.predicted_decode_s_per_token

    def cost_usd(self, prompt_tokens: int, out_tokens: int) -> float:
        return (self.usd_per_1k_in * prompt_tokens
                + self.usd_per_1k_out * out_tokens) / 1000.0

    def describe(self) -> str:
        spans = "+".join(f"{s.device}[{s.start}:{s.end}]" for s in self.stages)
        return (f"{self.key}: {spans} m={self.micro_batches} "
                f"prefill={self.predicted_prefill_s:.2f}s "
                f"decode={self.predicted_decode_s_per_token * 1e3:.1f}ms/tok "
                f"mem_ok={self.memory_ok}")


def simulate_pipeline(plan: PlacementPlan, prompt_tokens: int | None = None
                      ) -> dict:
    """Event-driven schedule of the plan's prefill: stage i starts
    micro-batch j when it finished j-1 AND received j from stage i-1
    (sends are blocking, matching ``StagePlan.prefill_time_s``).  For
    identical micro-batches this must reproduce the closed form exactly —
    the parity gate in ``tests/test_torch_placement.py``."""
    T = plan.prompt_tokens if prompt_tokens is None else prompt_tokens
    m = plan.micro_batches
    t = [s.prefill_time_s(T / m) for s in plan.stages]
    finish = [[0.0] * m for _ in t]
    for j in range(m):
        for i, ti in enumerate(t):
            ready = finish[i - 1][j] if i else 0.0
            prev = finish[i][j - 1] if j else 0.0
            finish[i][j] = max(ready, prev) + ti
    span = finish[-1][m - 1]
    # each stage is busy m * t_i of the span; the rest is fill/drain bubble
    busy = m * sum(t)
    return {
        "makespan_s": plan.overhead_s + span,
        "per_stage_s": t,
        "bubble_s": len(t) * span - busy,
        "bubble_fraction": 1.0 - busy / (len(t) * span),
    }


def search_placement(cfg: ModelConfig, chain: Sequence[str], *,
                     model: str = "", slo=None,
                     prompt_tokens: int = DEFAULT_PROMPT_TOKENS,
                     usd_per_1k_in: float | None = None,
                     usd_per_1k_out: float | None = None) -> PlacementPlan:
    """Exhaustive contiguous-partition search over an ordered device chain.

    Every assignment of contiguous layer spans to the chain's devices
    (empty spans allowed — so a longer chain's candidate set strictly
    contains every subset chain's, giving cost monotonicity by
    construction) is scored with the roofline + link model over the
    ``MICROBATCH_GRID``.  Ranking: memory-feasible first; with an SLO,
    plans whose predicted TTFT meets it are preferred and ranked by cost,
    then latency; without one, by predicted total latency (TTFT +
    reference decode tail), then cost.  Always returns a plan — when no
    assignment fits, the least-bad one with ``memory_ok=False``.
    """
    chain = tuple(chain)
    if not chain or len(set(chain)) != len(chain):
        raise ValueError(f"chain must be non-empty distinct devices: {chain}")
    devs = [device_profile(n) for n in chain]
    L = cfg.num_layers
    layers = model_layer_costs(cfg, prompt_tokens + DEFAULT_OUT_TOKENS)
    act_bytes = float(cfg.d_model) * BYTES[cfg.dtype]
    eb, hb = embed_head_bytes(cfg)
    head_fl = head_flops_per_token(cfg)

    # prefix sums: span [a, b) cost = pre[b] - pre[a]
    def prefix(vals):
        out = [0.0]
        for v in vals:
            out.append(out[-1] + v)
        return out

    pf = prefix(l.prefill_flops for l in layers)
    df = prefix(l.decode_flops for l in layers)
    wb = prefix(l.weight_bytes for l in layers)
    ab = prefix(l.active_weight_bytes for l in layers)
    kb = prefix(l.kv_bytes for l in layers)

    rate_in = usd_per_1k_in if usd_per_1k_in is not None else PLACED_USD_PER_1K_IN
    rate_out = usd_per_1k_out if usd_per_1k_out is not None else PLACED_USD_PER_1K_OUT

    best_key, best = None, None
    n = len(chain)
    for cuts in itertools.combinations_with_replacement(range(L + 1), n - 1):
        bounds = (0,) + cuts + (L,)
        spans = [(i, bounds[i], bounds[i + 1]) for i in range(n)
                 if bounds[i + 1] > bounds[i]]
        stages = []
        mem_ok = True
        cloud_blocks = 0
        for pos, (di, a, b) in enumerate(spans):
            dev = devs[di]
            weight = wb[b] - wb[a]
            stream = ab[b] - ab[a]
            dec_fl = df[b] - df[a]
            if a == 0:
                weight += eb
                stream += act_bytes  # embedding row read per token
            last = pos == len(spans) - 1
            if b == L:
                weight += hb
                stream += hb if hb else eb  # tied head still streams weights
                dec_fl += head_fl
            mem = weight + (kb[b] - kb[a])
            if mem > _avail_bytes(dev):
                mem_ok = False
            if dev.name == "cloud":
                cloud_blocks += b - a
            out_rtt = out_bw = 0.0
            if not last:
                link = link_between(dev.name, devs[spans[pos + 1][0]].name)
                out_rtt, out_bw = link.rtt_s, link.gbytes_per_s
            stages.append(StagePlan(
                device=dev.name, start=a, end=b, weight_bytes=weight,
                mem_bytes=mem, flops_per_s=dev.tflops * 1e12 * dev.util,
                mem_bytes_per_s=dev.mem_gbps * 1e9,
                prefill_flops_per_token=pf[b] - pf[a],
                decode_flops_per_token=dec_fl, decode_stream_bytes=stream,
                out_rtt_s=out_rtt, out_gbytes_per_s=out_bw,
                _act_bytes=act_bytes))
        overhead = sum(devs[di].overhead_s for di, _, _ in spans)
        if any(devs[di].name == "cloud" for di, _, _ in spans):
            overhead += CLOUD_RTT_S
        decode_tok = sum(s.decode_time_s() for s in stages)
        cfrac = cloud_blocks / L
        for m in MICROBATCH_GRID:
            tm = prompt_tokens / m
            t = [s.prefill_time_s(tm) for s in stages]
            prefill = overhead + sum(t) + (m - 1) * max(t)
            total = prefill + DEFAULT_OUT_TOKENS * decode_tok
            cost = cfrac * (rate_in * prompt_tokens
                            + rate_out * DEFAULT_OUT_TOKENS) / 1000.0
            slo_ok = slo is None or prefill <= slo.max_latency_s
            # ns-rounded latencies: float-noise ties (e.g. a single stage at
            # any micro-batch count) resolve to the FIRST candidate — fewer
            # micro-batches, earlier cut — keeping plans deterministic
            if slo is not None:
                key = (not mem_ok, not slo_ok, round(cost, 12),
                       round(total, 9))
            else:
                key = (not mem_ok, round(total, 9), round(cost, 12))
            if best_key is None or key < best_key:
                best_key = key
                best = (tuple(stages), m, overhead, prefill, decode_tok,
                        cfrac, mem_ok, slo_ok)

    stages, m, overhead, prefill, decode_tok, cfrac, mem_ok, slo_ok = best
    return PlacementPlan(
        model=model or cfg.name, arch=cfg.name, chain=chain, stages=stages,
        micro_batches=m, prompt_tokens=prompt_tokens, overhead_s=overhead,
        predicted_prefill_s=prefill, predicted_decode_s_per_token=decode_tok,
        usd_per_1k_in=cfrac * rate_in, usd_per_1k_out=cfrac * rate_out,
        cloud_fraction=cfrac, memory_ok=mem_ok, slo_ok=slo_ok)


# ---------------------------------------------------------------------------
# memoized catalog-level entry point (what core/paths and core/pipeline use)
# ---------------------------------------------------------------------------

_PLAN_CACHE: dict[tuple, PlacementPlan] = {}
_PLAN_LOCK = threading.Lock()


def get_plan(model: str, chain: Sequence[str] | str, *, slo=None,
             prompt_tokens: int = DEFAULT_PROMPT_TOKENS) -> PlacementPlan:
    """The plan for a catalog model on a device chain ("a+b+c" or a tuple).

    Deterministic and memoized process-wide: plan search costs ~0.1-2 s per
    (model, chain) — the arch's meta-device param count plus the partition
    sweep — so every consumer (path enumeration, pipeline execution, the
    batched engine's scalar rows) shares one cache entry.
    """
    if isinstance(chain, str):
        chain = tuple(chain.split("+"))
    else:
        chain = tuple(chain)
    slo_key = None if slo is None else (slo.max_latency_s, slo.max_cost_usd)
    key = (model, chain, prompt_tokens, slo_key)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        from repro_torch.configs import get_config
        from repro_torch.core.paths import MODEL_CATALOG

        prof = MODEL_CATALOG[model]
        cfg = get_config(prof.arch)
        plan = search_placement(
            cfg, chain, model=model, slo=slo, prompt_tokens=prompt_tokens,
            usd_per_1k_in=prof.usd_per_1k_in or None,
            usd_per_1k_out=prof.usd_per_1k_out or None)
        with _PLAN_LOCK:
            plan = _PLAN_CACHE.setdefault(key, plan)
    return plan
