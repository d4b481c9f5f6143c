"""Plain torch version of the RG-LRU diagonal recurrence.

Mirrors the JAX package's sequential oracle ``rglru_scan_ref``
(``src/repro/kernels/rglru_scan/ref.py:8``): a loop over time in fp32.
Each step rounds the product and then the sum, as the kernel does, so on
the same inputs the two agree bit for bit.  The CPU path uses it, and on
the card it is what the kernel is held against.
"""
from __future__ import annotations

import torch


def rglru_scan_ref(a: torch.Tensor, x: torch.Tensor,
                   h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + x_t.  a, x (B, S, R); h0 (B, R) -> (B, S, R)
    fp32."""
    a32, x32 = a.float(), x.float()
    h = h0.float()
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    for t in range(a.shape[1]):
        h = a32[:, t] * h + x32[:, t]
        out[:, t] = h
    return out


def rglru_scan_bwd_ref(a: torch.Tensor, h0: torch.Tensor, h: torch.Tensor,
                       dh: torch.Tensor):
    """The backward of ``rglru_scan_ref`` from the states it returned, h (B,
    S, R) fp32, and their upstream gradient dh: a reverse loop in fp32,
    g_t = dh_t + a_{t+1} g_{t+1} (g_S = 0), rounding the product and then
    the sum as the kernel does.  Returns (da, dx, dh0): da_t = g_t h_{t-1}
    (h_{-1} = h0) and dx_t = g_t in a's dtype, dh0 = a_0 g_0 in fp32."""
    a32, dh32, h0_32 = a.float(), dh.float(), h0.float()
    g = torch.zeros_like(h0_32)
    a_next = torch.zeros_like(h0_32)
    da = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    dx = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    for t in range(a.shape[1] - 1, -1, -1):
        g = dh32[:, t] + a_next * g
        dx[:, t] = g
        da[:, t] = g * (h[:, t - 1] if t > 0 else h0_32)
        a_next = a32[:, t]
    return da, dx, a_next * g
