"""Collective traffic of a step, from the collectives each rank dispatches.

The JAX package's ``perf/hlo_analysis.py`` reads the partitioned HLO text
of a compiled step: every all-gather, all-reduce, reduce-scatter and
all-to-all with its result bytes and replica-group size, and the trip
counts of the while loops around them, which it folds in because XLA's
cost analysis counts a loop body once.  The port compiles no program.
What stands in for the HLO here is the stream of collectives that one rank
dispatches while it runs the step eagerly: DTensor's redistributes (an
FSDP all-gather of a weight, the all-reduce of a ``Partial`` sum, the
reduce-scatter of a gradient) and the port's explicit ones (the softmax
merge of ``api.local_decode``, ``compressed_psum``'s ``all_reduce``).
``CollectiveRecorder`` is a ``TorchDispatchMode`` that records each of
them, as ``CommDebugMode`` does, with its result bytes and group size.

Nothing is scaled by a trip count: the eager step dispatches every layer,
microbatch and loop iteration, so each collective is recorded as often as
it runs.  ``parse_hlo``, ``trip_count`` and ``while_trip_counts`` have no
counterpart for that reason.

``CollectiveOp.wire_bytes`` and ``collective_bytes_by_kind`` keep the
reference's formulas, kind names and report layout, which
``perf/roofline.py: full_table`` reads.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# functional collectives (``torch.distributed._functional_collectives``, what
# DTensor's redistributes dispatch) and the in-place c10d ops (what
# ``torch.distributed.all_reduce`` and its kin dispatch) -> the reference's
# kind names
_FUNCTIONAL_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
}
_C10D_KINDS = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast_": "collective-broadcast",
}


@dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    group_size: int

    @property
    def wire_bytes(self) -> float:
        """Approximate bytes crossing links per participating device.

        Ring algorithms: all-gather moves (n-1)/n of the result through each
        device; reduce-scatter likewise on its input (~= result * n ... we
        only see the local result, so scale by (n-1)); all-reduce is
        reduce-scatter + all-gather (2x); permute/all-to-all move the buffer
        once.
        """
        n = max(self.group_size, 1)
        f = (n - 1) / n
        if self.kind == "all-gather":
            return self.result_bytes * f
        if self.kind == "reduce-scatter":
            return self.result_bytes * (n - 1)
        if self.kind == "all-reduce":
            return 2.0 * self.result_bytes * f
        if self.kind in ("all-to-all", "ragged-all-to-all"):
            return self.result_bytes * f
        if self.kind == "collective-permute":
            return float(self.result_bytes)
        if self.kind == "collective-broadcast":
            return float(self.result_bytes)
        return float(self.result_bytes)


def collective_bytes_by_kind(records: Iterable[CollectiveOp]) -> dict:
    """Per-device collective traffic grouped by kind: ``{kind: {count,
    wire_bytes, result_bytes}}``, the reference's layout."""
    out: dict[str, dict] = {}
    for op in records:
        d = out.setdefault(op.kind, {"count": 0, "wire_bytes": 0.0,
                                     "result_bytes": 0.0})
        d["count"] += 1
        d["wire_bytes"] += op.wire_bytes
        d["result_bytes"] += float(op.result_bytes)
    return out


def total_collective_wire_bytes(records: Iterable[CollectiveOp]) -> float:
    return sum(d["wire_bytes"]
               for d in collective_bytes_by_kind(records).values())


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _group_size(func, args, kwargs) -> int:
    """The group size of a collective: an explicit ``group_size`` argument,
    else the size of the process group it names (functional ops) or takes
    (c10d ops)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    schema = func._schema
    named = dict(kwargs)
    for a, v in zip(schema.arguments, args):
        named.setdefault(a.name, v)
    if isinstance(named.get("group_size"), int):
        return named["group_size"]
    if isinstance(named.get("group_name"), str):
        return _resolve_process_group(named["group_name"]).size()
    if named.get("process_group") is not None:  # a boxed ProcessGroup
        return dist.ProcessGroup.unbox(named["process_group"]).size()
    raise ValueError(f"{func}: no group size in its arguments")


def collective_of(func, args, kwargs, out) -> CollectiveOp | None:
    """The ``CollectiveOp`` of one dispatched op, or None where the op is no
    collective (``wait_tensor`` included: it finishes one)."""
    ns, name = func.namespace, func._schema.name.split("::")[-1]
    if ns == "_dtensor" and name == "shard_dim_alltoall":
        kind, result = "all-to-all", out
    elif ns == "_c10d_functional":
        kind = _FUNCTIONAL_KINDS.get(name)
        result = out
    elif ns == "c10d":
        kind = _C10D_KINDS.get(name)
        # the in-place ops write their first tensor (list) argument
        result = args[0] if args else out
    else:
        return None
    if kind is None:
        return None
    return CollectiveOp(kind, _nbytes(result), _group_size(func, args,
                                                           kwargs))


class CollectiveRecorder(TorchDispatchMode):
    """Records every collective this rank dispatches as a ``CollectiveOp``
    (``.records``).  A DTensor op is handed back to DTensor
    (``NotImplemented``) so that the recorder sees the local ops and the
    collectives it lowers to, as ``CommDebugMode`` does."""

    def __init__(self):
        super().__init__()
        self.records: list[CollectiveOp] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        self.observe(func, args, kwargs, out)
        return out

    def observe(self, func, args, kwargs, out) -> None:
        op = collective_of(func, args, kwargs, out)
        if op is not None:
            self.records.append(op)

    def by_kind(self) -> dict:
        return collective_bytes_by_kind(self.records)
