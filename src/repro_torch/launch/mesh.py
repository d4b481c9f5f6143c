"""Device meshes over an initialized ``torch.distributed`` world.

The JAX package's ``launch/mesh.py``: a host mesh of the ranks at hand
(``("data", "model")``, shape ``(world // tp, tp)``) and the production
meshes, single pod 16 x 16 = 256 ranks ``("data", "model")`` and multi-pod
2 x 16 x 16 = 512 ``("pod", "data", "model")``; the sharding policy folds
the "pod" axis into the FSDP/DP axis set.  Building a mesh never starts a
world: the caller initializes the process group (``init_world`` brings up a
world of one in this process), and a mesh needs as many ranks as it has
devices.
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.kernels.common import resolve_device


def init_world(device="cuda") -> None:
    """A world of one rank in this process, on a ``HashStore``: ``nccl`` on
    the card, ``gloo`` on the CPU.  Needs no environment variables; does
    nothing when a process group is already up."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def _mesh(device, shape: tuple[int, ...], names: tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_host_mesh(tp: int = 1, device="cuda"):
    """``("data", "model")`` mesh of shape ``(world // tp, tp)`` over the
    initialized world."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh: no process group is initialized "
                           "(init_world, or init_process_group)")
    n = dist.get_world_size()
    if tp < 1 or n % tp:
        raise ValueError(f"tp {tp} does not divide the world of {n} ranks")
    return _mesh(device, (n // tp, tp), ("data", "model"))


def required_devices(multi_pod: bool) -> int:
    return 512 if multi_pod else 256


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production mesh; raises unless a world of exactly
    ``required_devices(multi_pod)`` ranks is initialized."""
    want = required_devices(multi_pod)
    n = dist.get_world_size() if dist.is_initialized() else 0
    if n != want:
        raise RuntimeError(f"the {'multi-pod' if multi_pod else 'single-pod'}"
                           f" mesh needs a world of {want} ranks, have {n}")
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device, shape, axes)
