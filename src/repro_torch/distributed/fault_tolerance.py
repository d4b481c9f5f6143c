"""Multi-pod fault tolerance: elastic re-meshing after pod loss.

The JAX package's ``distributed/fault_tolerance.py``.  The trainer
checkpoints params/opt-state in a mesh-agnostic (name -> array) layout
(``repro_torch.checkpoint``; a DTensor is gathered whole).  On pod failure
the controller:

  1. detects missed heartbeats (``PodMonitor``),
  2. rebuilds a mesh over the surviving pods (same axis names, a smaller
     "pod" dim) from the old mesh's rank array (``survivor_mesh``),
  3. restores the latest checkpoint onto the new mesh's placements
     (``reshard_restore``: resharding happens in ``distribute_tensor``),
  4. resumes the deterministic data pipeline from the restored step
     (``TokenPipeline.batch_at`` is a pure function of step).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.distributed.sharding import ShardingPolicy


@dataclass
class PodMonitor:
    n_pods: int
    max_missed: int = 2
    missed: dict[int, int] = field(default_factory=dict)
    dead: set = field(default_factory=set)

    def beat(self, responding: set[int]) -> set[int]:
        """One heartbeat round; returns newly-dead pods."""
        new_dead = set()
        for pod in range(self.n_pods):
            if pod in self.dead:
                continue
            if pod in responding:
                self.missed[pod] = 0
            else:
                self.missed[pod] = self.missed.get(pod, 0) + 1
                if self.missed[pod] >= self.max_missed:
                    self.dead.add(pod)
                    new_dead.add(pod)
        return new_dead

    @property
    def alive(self) -> list[int]:
        return [p for p in range(self.n_pods) if p not in self.dead]


def survivor_ranks(ranks, axis_names: tuple[str, ...], pod_axis: str,
                   alive_pods: list[int]) -> torch.Tensor:
    """The rank array of the surviving pods: ``ranks`` (a mesh's rank
    array, e.g. ``DeviceMesh.mesh``) sliced along the pod axis."""
    pod_dim = axis_names.index(pod_axis)
    ranks = torch.as_tensor(ranks)
    return ranks.index_select(pod_dim, torch.tensor(list(alive_pods),
                                                    dtype=torch.long))


def survivor_mesh(ranks, axis_names: tuple[str, ...], pod_axis: str,
                  alive_pods: list[int], device_type: str = "cuda"):
    """Rebuild the mesh over surviving pods (the rank array is (pod, ...)).
    Every rank of the world calls it, as ``DeviceMesh`` creates groups."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type,
                      survivor_ranks(ranks, axis_names, pod_axis, alive_pods),
                      mesh_dim_names=tuple(axis_names))


def reshard_restore(checkpointer, like, mesh, cfg, optimizer_name: str):
    """Restore (params, opt_state, step) onto ``mesh`` with fresh
    placements: ``like`` is (params, opt_state) of the right shapes (e.g.
    ``meta`` tensors of the right dtypes)."""
    policy = ShardingPolicy(mesh)
    p_like, o_like = like
    p_spec = policy.param_pspecs(cfg, p_like)
    o_spec = policy.opt_pspecs(optimizer_name, p_spec, p_like)
    placements = (policy.shardings_of(p_spec), policy.shardings_of(o_spec))
    step, (params, opt_state) = checkpointer.restore(
        (p_like, o_like), placements=placements, mesh=mesh)
    return step, params, opt_state, policy
