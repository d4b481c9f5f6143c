"""Shared sentinel, device policy and dispatch rule for every kernel op.

Dispatch rule (one for all ops): a tensor on the CPU goes to the op's plain
torch version (``ref.py``); a CUDA tensor goes to the hand-written kernel,
or the call raises.  There is no fallback from the card to the plain
version: a kernel that fails to build or launch is an error, never a
silent slow path.  A fake tensor (``FakeTensorMode``, the dry run's
``launch/dryrun.py``) takes the kernel's *shape route*: the card kernel's
input contract and route are checked as on the card, the outputs are
``torch.empty`` of the kernel's shapes and dtypes, and the kernel's work
(``kernel.cost``) goes to the installed counter (``kernel_costs``).
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch
from torch._subclasses.fake_tensor import FakeTensor

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


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (the grid rules' input)."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return _sm_count(index)


def on_device(device: torch.device):
    """A context that makes ``device`` the current CUDA device for a
    launch, or does nothing when it already is (the usual case, where
    ``torch.cuda.device`` would still spend microseconds on lookups)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def raw_stream(device: torch.device) -> int:
    """The current stream of ``device`` as a ``cudaStream_t`` address for a
    kernel's C launcher: ``torch.cuda.current_stream(device).cuda_stream``
    without the Stream object and its device lookups."""
    return torch._C._cuda_getCurrentRawStream(device.index)


SHAPE = "shape"  # use_kernel's answer for fake tensors: the shape route


def use_kernel(*tensors: torch.Tensor):
    """The dispatch rule: True for CUDA tensors (launch the kernel), False
    for CPU tensors (plain version), ``SHAPE`` for fake tensors (the
    kernel's shape route; a real tensor never takes it).  Mixed devices,
    or fake and real tensors together, raise."""
    fake = [isinstance(t, FakeTensor) for t in tensors]
    if any(fake):
        if not all(fake):
            raise ValueError("fake and real tensors in one kernel call")
        return SHAPE
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"}:
        return True
    raise ValueError(f"tensors on mixed or unsupported devices: {sorted(types)}")


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """The rule for a kernel that has no backward (``decode_attention``,
    ``retrieval_topk`` and ``dsqe_score``: no train path reaches them): on
    the card, under grad mode, an input that requires grad raises.  The
    kernel writes a tensor that autograd cannot see through, so a backward
    pass would drop every gradient below it without a word.  Called on the
    kernel path only (CUDA tensors); the plain versions on the CPU
    differentiate through autograd."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward (no train path "
            "reaches it); call it under torch.no_grad() or on inputs that do "
            "not require grad")


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


# dtype codes of the C interface of the attention, moe_gmm and rglru_scan
# kernels (csrc/attention.cu, moe_gmm.cu, rglru_scan.cu)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_attention_inputs(**tensors: torch.Tensor) -> int:
    """Attention kernel input contract: one dtype for every tensor, fp32 or
    bf16, contiguous and 16-byte aligned (the kernels load 16 bytes at a
    time), head_dim (the last axis) a multiple of 16 up to 256.  Returns the
    dtype's code."""
    dtypes = {t.dtype for t in tensors.values()}
    if len(dtypes) != 1 or next(iter(dtypes)) not in KERNEL_DTYPES:
        raise TypeError(f"attention kernels take one dtype of float32 or "
                        f"bfloat16, got {sorted(map(str, dtypes))}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if not aligned16(t):
            raise ValueError(f"{name}: must be 16-byte aligned")
        hd = t.shape[-1]
        if hd % 16 or not 16 <= hd <= 256:
            raise ValueError(f"{name}: head_dim must be a multiple of 16 in "
                             f"[16, 256], got {hd}")
    return KERNEL_DTYPES[next(iter(dtypes))]


_costs = threading.local()


@contextlib.contextmanager
def kernel_costs(sink):
    """Install ``sink(name, flops, nbytes)``, which each shape route calls
    with its kernel's work (``kernel.cost``), for the calls in this
    thread."""
    prev = getattr(_costs, "sink", None)
    _costs.sink = sink
    try:
        yield
    finally:
        _costs.sink = prev


def record_kernel(name: str, cost: tuple[int, int]) -> None:
    """A shape route's report of one kernel launch, ``cost`` its (FLOPs,
    bytes); nothing happens without an installed counter."""
    sink = getattr(_costs, "sink", None)
    if sink is not None:
        sink(name, *cost)


def aligned16(t: torch.Tensor) -> bool:
    """Does ``t`` start on 16 bytes?  A fake tensor has no address; its
    storage is taken as a fresh allocation (256-byte aligned on the card),
    so its offset into that storage decides."""
    if isinstance(t, FakeTensor):
        return t.storage_offset() * t.element_size() % 16 == 0
    return t.data_ptr() % 16 == 0
