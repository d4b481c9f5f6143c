"""CE-CoLLM-style split inference: edge-draft / cloud-verify chunked generation.

The edge SLM drafts the response in token chunks behind an early-exit
confidence gate (CE-CoLLM, PAPERS.md): each drafted chunk carries a
confidence read out of a real incremental-attention pass over the draft's
KV cache.  The cache lives in the exact ``(B, W, Kv, hd)`` layout
``repro_torch.kernels.decode_attention`` consumes, appended slot-by-slot like an
incremental transformer-LM decode, and ``DraftState.attend`` mirrors the
kernel oracle's masked-softmax readout (``use_kernel=True`` routes the very
same buffers through the decode-attention op — the layout contract is
load-bearing, not decorative).  Chunks whose confidence clears the gate are
final at edge latency; low-confidence chunks escalate: the cloud LLM
attaches once (RTT + context prefill, paid on the first escalation only)
and verifies/continues that span at cloud quality and cloud token pricing.

The whole trace is a deterministic function of ``(seed, qid, edge, cloud,
tau)``, so the Emulator can evaluate split paths like any other
configuration and the RPS can select them per (query, SLO):

  * latency keeps the repo's TTFT-style path accounting — edge prefill,
    plus the one-time cloud attach overhead iff any span escalated.  The
    per-chunk decode pacing rides on the streamed ``GenChunk`` timeline,
    not on the path metric, exactly as whole-model paths account TTFT only;
  * cost is cloud-only: context prefill once plus output tokens for the
    escalated spans (edge tokens are free — the paper's accounting);
  * the judge scores the blend: effective capability interpolates edge ->
    cloud by the escalated-token fraction.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.devices import (CLOUD_DEVICE, CLOUD_RTT_S, DeviceProfile,
                                ModelProfile, decode_latency_s,
                                prefill_latency_s)
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.decode_attention.ops import decode_attention

CHUNK_TOKENS = 30   # draft chunk width (OUT_TOKENS=150 -> 5 chunks)
HEAD_DIM = 16       # confidence-scorer head dim (the kernel takes multiples of 16)
CONF_SPREAD = 0.5   # attention-readout swing around the base confidence


@dataclass(frozen=True)
class GenChunk:
    """One streamed span of a response.

    ``source`` is ``"edge"`` / ``"cloud"`` for split-inference spans, or the
    serving model's impl name for whole-model streams.  ``latency_s`` /
    ``cost_usd`` are cumulative along the chunk timeline (decode pacing
    included), so consumers can derive inter-chunk gaps directly.
    """

    index: int
    tokens: int
    source: str
    confidence: float
    latency_s: float
    cost_usd: float
    final: bool = False


# chunk-emission callback: return False to tear the stream down mid-flight
EmitFn = Callable[[GenChunk], bool]


@dataclass(frozen=True)
class SplitResult:
    """Terminal state of one split-inference generation."""

    latency_s: float   # TTFT-style path metric (edge prefill [+ cloud attach])
    cost_usd: float
    knowledge: float   # edge tier -> cloud tier, by escalated-token fraction
    cloud_tokens: int
    n_chunks: int
    cancelled: bool    # emit() returned False before the final chunk


class DraftState:
    """Stateful chunked draft: a KV cache in the decode_attention layout.

    ``k_cache``/``v_cache`` are ``(B=1, W, Kv=1, hd)`` float32 — exactly what
    ``repro_torch.kernels.decode_attention`` consumes — with one slot appended per
    drafted chunk like an incremental LM decode.  ``attend`` reads the
    current query against the cache via the kernel oracle's masked-softmax
    math (float32 numpy mirror of ``decode_attention_ref``); pass
    ``use_kernel=True`` to route the identical buffers through the port's
    ``decode_attention`` op on ``device`` instead (the hand-written kernel
    on the card, its plain version on the CPU; tests pin both against each
    other).
    """

    def __init__(self, seed: int, qid: int, edge: ModelProfile,
                 n_chunks: int, head_dim: int = HEAD_DIM):
        self.seed = seed
        self.qid = qid
        self.edge = edge
        self.hd = head_dim
        self.cache_len = 0
        self.k_cache = np.zeros((1, n_chunks, 1, head_dim), np.float32)
        self.v_cache = np.zeros((1, n_chunks, 1, head_dim), np.float32)
        self._q = np.zeros((1, 1, 1, head_dim), np.float32)

    def _draft_vectors(self, t: int):
        """Deterministic pseudo-activations for draft step ``t`` — the stand-in
        for the edge model's hidden states, seeded like the judge oracle."""
        h = hashlib.blake2b(
            f"{self.seed}:{self.qid}:{self.edge.name}:{t}".encode(),
            digest_size=3 * self.hd).digest()
        raw = np.frombuffer(h, np.uint8).astype(np.float32) / 255.0
        q = raw[:self.hd] * 2.0 - 1.0
        k = raw[self.hd:2 * self.hd] * 2.0 - 1.0
        v = raw[2 * self.hd:]  # in [0, 1]: readout lands in [0, 1] too
        return q, k, v

    def append(self, t: int) -> None:
        if t != self.cache_len:
            raise ValueError(f"append out of order: t={t}, len={self.cache_len}")
        q, k, v = self._draft_vectors(t)
        self.k_cache[0, t, 0] = k
        self.v_cache[0, t, 0] = v
        self._q[0, 0, 0] = q
        self.cache_len = t + 1

    def attend(self, use_kernel: bool = False, device="cuda") -> np.ndarray:
        if use_kernel:
            dev = resolve_device(device)
            q, k, v = (torch.from_numpy(a).to(dev)
                       for a in (self._q, self.k_cache, self.v_cache))
            out = decode_attention(q, k, v, self.cache_len)
            return out[0, 0, 0].cpu().numpy()
        # numpy mirror of kernels/decode_attention/ref.py: float32 logits at
        # 1/sqrt(hd) scale, slots >= cache_len masked, max-subtracted softmax
        W = self.k_cache.shape[1]
        s = (self.k_cache[0, :, 0] @ self._q[0, 0, 0]).astype(np.float32)
        s = s * np.float32(1.0 / math.sqrt(self.hd))
        s = np.where(np.arange(W) < self.cache_len, s, np.float32(-1e30))
        p = np.exp((s - s.max()).astype(np.float32))
        p = p / p.sum()
        return (p @ self.v_cache[0, :, 0]).astype(np.float32)

    def step(self, t: int, base: float) -> float:
        """Draft chunk ``t`` and read its early-exit confidence off the cache."""
        self.append(t)
        o = self.attend()
        return float(np.clip(base + CONF_SPREAD * (float(o[0]) - 0.5), 0.0, 1.0))


def base_confidence(edge: ModelProfile, grounding: float,
                    complexity: float) -> float:
    """Center of the per-chunk confidence distribution: stronger edge models
    with better-grounded contexts self-assess higher; complex queries lower."""
    return float(np.clip(
        0.15 + 0.65 * edge.quality_tier + 0.2 * grounding - 0.3 * complexity,
        0.0, 1.0))


def generate_split(*, seed: int, qid: int, complexity: float,
                   edge: ModelProfile, cloud: ModelProfile, tau: float,
                   device: DeviceProfile, prompt_tokens: int,
                   out_tokens: int, grounding: float,
                   start_latency_s: float, start_cost_usd: float,
                   emit: Optional[EmitFn] = None,
                   chunk_tokens: int = CHUNK_TOKENS) -> SplitResult:
    """Run one edge-draft / cloud-verify generation.

    Deterministic in all arguments; ``emit`` (if given) receives each
    ``GenChunk`` in order and may return False to cancel mid-stream (the
    returned ``SplitResult`` then has ``cancelled=True`` and reflects only
    the spans generated before teardown).
    """
    n_chunks = max(1, math.ceil(out_tokens / chunk_tokens))
    draft = DraftState(seed, qid, edge, n_chunks)
    base = base_confidence(edge, grounding, complexity)

    edge_ttft = prefill_latency_s(edge, device, prompt_tokens)
    metric_lat = start_latency_s + edge_ttft   # TTFT-style path metric
    timeline_lat = start_latency_s + edge_ttft  # chunk pacing (decode incl.)
    cost = start_cost_usd
    cloud_attached = False
    cloud_tokens = 0
    done_tokens = 0
    cancelled = False

    for t in range(n_chunks):
        tokens = min(chunk_tokens, out_tokens - done_tokens)
        done_tokens += tokens
        conf = draft.step(t, base)
        if conf >= tau:
            source = "edge"
            timeline_lat += decode_latency_s(edge, device, tokens)
        else:
            source = "cloud"
            if not cloud_attached:
                # one-time attach: RTT + cloud-side context prefill (and the
                # context's input-token cost), amortized over later spans
                cloud_attached = True
                attach = CLOUD_RTT_S + prefill_latency_s(
                    cloud, CLOUD_DEVICE, prompt_tokens)
                metric_lat += attach
                timeline_lat += attach
                cost += cloud.usd_per_1k_in * prompt_tokens / 1000.0
            cloud_tokens += tokens
            timeline_lat += decode_latency_s(cloud, CLOUD_DEVICE, tokens)
            cost += cloud.usd_per_1k_out * tokens / 1000.0
        if emit is not None and not emit(GenChunk(
                index=t, tokens=tokens, source=source, confidence=conf,
                latency_s=timeline_lat, cost_usd=cost,
                final=done_tokens >= out_tokens)):
            cancelled = True
            break

    frac_cloud = cloud_tokens / max(out_tokens, 1)
    knowledge = edge.quality_tier + (cloud.quality_tier - edge.quality_tier) * frac_cloud
    return SplitResult(latency_s=metric_lat, cost_usd=cost,
                       knowledge=knowledge, cloud_tokens=cloud_tokens,
                       n_chunks=n_chunks, cancelled=cancelled)
