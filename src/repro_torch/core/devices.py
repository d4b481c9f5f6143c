"""Edge / cloud device profiles and the analytic latency model.

The paper measures TTFT on four physical edge platforms (Table 3).  This
container has no GPUs/NPUs, so latency comes from a roofline-style model per
device profile: prefill is compute-bound (2N FLOPs/token at the device's
sustained throughput), decode/streaming is bandwidth-bound (N bytes/token),
plus fixed overheads (process launch, network RTT for cloud calls).

Profiles use the paper's published specs (TOPS / bandwidth / power); the
sustained-utilization factors are set so the modeled TTFTs land in the same
regime the paper reports (sub-second M4 vs 12+s Orin on automotive).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DeviceProfile:
    name: str
    tflops: float  # sustained dense bf16/int8-equivalent TFLOP/s
    mem_gbps: float  # memory bandwidth GB/s
    ram_gb: float
    watts: float
    util: float = 0.35  # sustained fraction of peak for SLM inference
    overhead_s: float = 0.03  # runtime launch/tokenizer overhead


EDGE_DEVICES: dict[str, DeviceProfile] = {
    # name            TFLOPs  BW     RAM  W     util  overhead
    "orin": DeviceProfile("orin", 1.3, 68.0, 8, 15, 0.30, 0.08),
    "m1pro": DeviceProfile("m1pro", 5.2, 200.0, 16, 45, 0.35, 0.04),
    "m4": DeviceProfile("m4", 9.0, 120.0, 32, 65, 0.40, 0.03),
    "a4500": DeviceProfile("a4500", 47.0, 640.0, 20, 200, 0.35, 0.03),
    # the TPU serving fleet this framework targets (per-chip v5e)
    "tpu_v5e": DeviceProfile("tpu_v5e", 197.0, 819.0, 16, 170, 0.45, 0.005),
}

CLOUD_RTT_S = 0.18  # request RTT + queuing to a cloud endpoint
CLOUD_TFLOPS = 900.0  # aggregated cloud accelerator slice for one request
CLOUD_UTIL = 0.5
# the device profile every cloud model call runs against (shared by the
# scalar latency model below and the batched engine's precomputed constants)
CLOUD_DEVICE = DeviceProfile("cloud", CLOUD_TFLOPS, 8000.0, 640, 0, CLOUD_UTIL, 0.0)


@dataclass(frozen=True)
class ModelProfile:
    """A model as the orchestrator sees it: size, placement, pricing."""

    name: str
    params_b: float  # billions of parameters
    placement: str  # "edge" | "cloud"
    quality_tier: float  # [0, 1] headline capability (oracle input)
    usd_per_1k_in: float = 0.0  # $ per 1k input tokens
    usd_per_1k_out: float = 0.0
    arch: str = ""  # link back to the assigned-architecture zoo


def prefill_latency_s(model: ModelProfile, device: DeviceProfile, prompt_tokens: int) -> float:
    """Time to first token for a prompt: compute-bound prefill + fixed costs."""
    flops = 2.0 * model.params_b * 1e9 * prompt_tokens
    compute_s = flops / (device.tflops * 1e12 * device.util)
    # weight streaming floor (model must be touched once)
    stream_s = (model.params_b * 1e9 * 2.0) / (device.mem_gbps * 1e9)
    return device.overhead_s + max(compute_s, stream_s)


def decode_latency_s(model: ModelProfile, device: DeviceProfile, out_tokens: int) -> float:
    per_tok = (model.params_b * 1e9 * 2.0) / (device.mem_gbps * 1e9)
    return out_tokens * per_tok


def model_call_latency_s(model: ModelProfile, device: DeviceProfile,
                         prompt_tokens: int, out_tokens: int = 0) -> float:
    """TTFT (+ optional decode tail) for one model call on a device."""
    if model.placement == "cloud":
        t = CLOUD_RTT_S + prefill_latency_s(model, CLOUD_DEVICE, prompt_tokens)
        if out_tokens:
            t += decode_latency_s(model, CLOUD_DEVICE, out_tokens)
        return t
    t = prefill_latency_s(model, device, prompt_tokens)
    if out_tokens:
        t += decode_latency_s(model, device, out_tokens)
    return t


def model_call_cost_usd(model: ModelProfile, prompt_tokens: int, out_tokens: int) -> float:
    return (model.usd_per_1k_in * prompt_tokens + model.usd_per_1k_out * out_tokens) / 1000.0
