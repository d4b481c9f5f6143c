"""Shared sentinel, device policy and dispatch rule for every kernel op.

Dispatch rule (one for all ops): a tensor on the CPU goes to the op's plain
torch version (``ref.py``); a CUDA tensor goes to the hand-written kernel,
or the call raises.  There is no fallback from the card to the plain
version: a kernel that fails to build or launch is an error, never a
silent slow path.
"""
from __future__ import annotations

import torch

# Masked-score sentinel shared by the selection kernels and their refs.
# Finite (not -inf) so masked lanes never poison reductions with NaNs via
# inf - inf; anything below NEG_INF / 2 is "masked", anything above is real.
NEG_INF = -1e30


def resolve_device(device) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    ``"cuda"`` on a machine without a usable GPU raises instead of falling
    back to the CPU.  TF32 is switched off for matmuls and cuDNN: it keeps
    about three decimal digits, which moves train/prototype similarities
    enough to flip kNN membership and argmax decisions against the fp32
    reference.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not "
                               "available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def use_kernel(*tensors: torch.Tensor) -> bool:
    """The dispatch rule: True for CUDA tensors (launch the kernel), False
    for CPU tensors (plain version).  Mixed devices raise."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"}:
        return True
    raise ValueError(f"tensors on mixed or unsupported devices: {sorted(types)}")


def check_f32(name: str, t: torch.Tensor, shape: tuple) -> None:
    """Kernel input contract: a contiguous float32 tensor of ``shape``
    (``None`` entries match any size)."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
