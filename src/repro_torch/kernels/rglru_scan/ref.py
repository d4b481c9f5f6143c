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
