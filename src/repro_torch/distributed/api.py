"""Decoupling shim between model code and the active sharding policy.

Model code calls ``constrain(x, "act_btd")`` with a *logical* activation
name, as in the JAX package (``src/repro/distributed/api.py``).  When a
sharding policy is installed (``repro_torch.distributed.sharding``) and
``x`` is a ``DTensor``, the call redistributes it to the rule's placements;
otherwise it is the identity, so the same model runs on plain tensors on one
device and on DTensors over a ``DeviceMesh`` without code changes.

A spec is a tuple with one entry per tensor dim: ``None``, a mesh axis name,
or a tuple of names (the JAX ``PartitionSpec`` read as a tuple; a
one-name tuple is written as the bare name, as ``PartitionSpec`` normalises
it).  A mesh is a ``DeviceMesh`` with named dims, or any object with
``axis_names`` and a ``shape`` mapping from name to size (the policy reads
nothing else, so a production mesh can stand in without its devices).

The hand-written kernels take plain tensors.  ``local_attention``,
``local_moe_gmm``, ``local_scan`` and ``local_decode`` are their boundary
under DTensor: each brings its inputs to the placements its kernel can run
on a rank's shard alone, calls the op on the local shards, and wraps the
result back; autograd goes through the boundary.  A layout the boundary
cannot serve raises: no input is gathered to one rank and no plain
version is taken in its place.  ``local_groups``, ``local_embed``,
``local_pointwise`` and ``local_index_copy`` do the same for the model's
ops that DTensor has no rule for (the MoE dispatch plan and permutes, the
embedding lookup's backward, ``logsigmoid``'s backward, cache writes).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, Optional

import torch

_state = threading.local()


def _policy() -> Optional["ActivationPolicy"]:
    return getattr(_state, "policy", None)


def norm_entry(entry):
    """One spec entry in the form ``PartitionSpec`` keeps: a one-name tuple
    becomes the name, an empty one ``None``."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if not entry:
            return None
        return entry[0] if len(entry) == 1 else entry
    return entry


def spec(*entries) -> tuple:
    return tuple(norm_entry(e) for e in entries)


def axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    return tuple(names)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a stand-in."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(axis_names(mesh), tuple(shape)))


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh, spec_: tuple) -> tuple:
    """The DTensor placements of ``spec_`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that entry ``d`` names, ``Replicate()`` on the others and on
    a mesh dim of size 1 (the same layout; DTensor's view rules refuse to
    merge a dim sharded even over one rank)."""
    from torch.distributed.tensor import Replicate, Shard

    names, sizes = axis_names(mesh), axis_sizes(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec_):
        for a in _axes(entry):
            i = names.index(a)
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {a!r} shards two dims of "
                                 f"{spec_}")
            if sizes[a] > 1:
                out[i] = Shard(d)
    return tuple(out)


class ActivationPolicy:
    """Maps logical activation names to specs under a mesh.

    Constraints are *best-effort*: any dim whose size is not divisible by
    the requested axis set is left unsharded (batch 1 long-context decode
    cannot shard its batch dim; 56 query heads cannot split 16 ways).
    """

    def __init__(self, mesh, rules: dict[str, tuple],
                 cache_placer: Optional[Callable] = None):
        self.mesh = mesh
        self.rules = rules
        self.cache_placer = cache_placer  # serve cache tree -> DTensors
        self._sizes = axis_sizes(mesh)

    def axis_size(self, axes) -> int:
        return math.prod(self._sizes[a] for a in _axes(axes))

    def fit_spec(self, spec_: tuple, shape: tuple[int, ...]) -> tuple:
        parts = list(spec_) + [None] * (len(shape) - len(spec_))
        return tuple(norm_entry(ax) if dim % self.axis_size(ax) == 0
                     else None for ax, dim in zip(parts, shape))

    def fitted(self, name: str, shape: tuple[int, ...]) -> Optional[tuple]:
        """The rule ``name`` fitted to ``shape``, or None where there is no
        rule or the rule has more dims than the tensor."""
        spec_ = self.rules.get(name)
        if spec_ is None or len(spec_) > len(shape):
            return None
        return self.fit_spec(spec_, tuple(shape))

    def constrain(self, x, name: str):
        from torch.distributed.tensor import DTensor

        if not isinstance(x, DTensor):
            return x
        fitted = self.fitted(name, x.shape)
        if fitted is None:
            return x
        want = placements(x.device_mesh, fitted)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(x.device_mesh, want)


@contextlib.contextmanager
def activation_policy(policy: Optional[ActivationPolicy]):
    prev = _policy()
    _state.policy = policy
    try:
        yield
    finally:
        _state.policy = prev


def constrain(x, name: str):
    p = _policy()
    if p is None:
        return x
    return p.constrain(x, name)


def place_cache(cache):
    """A new serve cache (plain tensors) placed by the installed policy
    (``ShardingPolicy.cache_pspecs``); raises without one."""
    p = _policy()
    if p is None or p.cache_placer is None:
        raise RuntimeError("a cache for DTensor activations needs a policy "
                           "that places caches")
    return p.cache_placer(cache)


def current_mesh():
    p = _policy()
    return p.mesh if p is not None else None


def checkpoint_context():
    """``context_fn`` for ``torch.utils.checkpoint``: the recomputation in
    the backward runs under the policy of the forward.  (On the card the
    backward runs on autograd's device thread, where the thread-local
    policy is not installed.)"""
    p = _policy()
    return contextlib.nullcontext(), activation_policy(p)


# ---------------------------------------------------------------------------
# the kernels' boundary under DTensor
# ---------------------------------------------------------------------------

def is_dtensor(*ts) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(t, DTensor) for t in ts)


def _fit_or_replicate(name: str, shape) -> tuple:
    p = _policy()
    fitted = p.fitted(name, shape) if p is not None else None
    return fitted if fitted is not None else (None,) * len(shape)


def _to(x, mesh, spec_: tuple):
    """``x`` (a DTensor, or a plain tensor taken as replicated) on
    ``spec_``'s placements."""
    from torch.distributed.tensor import DTensor, Replicate

    want = placements(mesh, spec_)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) != want:
        x = x.redistribute(mesh, want)
    return x


def _shard_range(mesh, entry, size: int) -> tuple[int, int]:
    """[lo, hi) of a dim of ``size`` that this rank holds when the dim is
    sharded over the mesh axes of ``entry`` (in order)."""
    names = axis_names(mesh)
    lo, n = 0, size
    for a in _axes(entry):
        i = names.index(a)
        k = mesh.size(i)
        n //= k
        lo += mesh.get_local_rank(i) * n
    return lo, lo + n


def _mesh_of(*ts):
    from torch.distributed.tensor import DTensor

    return next(t.device_mesh for t in ts if isinstance(t, DTensor))


def _partial_over(mesh, spec_: tuple, axes: tuple[str, ...]) -> tuple:
    """Placements of ``spec_`` with ``Partial()`` on ``axes``: the gradient
    of a replicated input whose rank-local uses are summed over them."""
    from torch.distributed.tensor import Partial

    out = list(placements(mesh, spec_))
    names = axis_names(mesh)
    for a in axes:
        out[names.index(a)] = Partial()
    return tuple(out)


def local_attention(op: Callable, q, k, v, *args, **kw):
    """``op(q, k, v, **kw)`` (the flash or decode attention op, GQA native:
    q (B, S, H, hd), k and v (B, Skv, Kv, hd), query head h reading KV head
    ``h // (H / Kv)``) on each rank's shard, with the placements of the
    policy's ``attn_bhsd`` rule read in this layout: batch over data, heads
    over model.

    Where the KV heads do not split over the heads' axes (``Kv % tp != 0``)
    k and v stay replicated over them, and each rank passes its query
    heads' KV heads: a contiguous slice when a rank's heads cover whole
    groups or lie in one group, else one KV head per query head.  Their
    gradient is then summed over those axes (``Partial``).  The backward
    of the flash op (its kernel) runs on the same shards.
    """
    from torch.distributed.tensor import DTensor

    mesh = _mesh_of(q, k, v)
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    G = H // Kv
    bhsd = _fit_or_replicate("attn_bhsd", (B, H, S, hd))
    if bhsd[2] is not None or bhsd[3] is not None:
        raise NotImplementedError(f"attention kernels under DTensor: "
                                  f"sequence or head_dim sharding {bhsd}")
    heads = bhsd[1]
    q_spec = (bhsd[0], None, heads, None)
    kv_split = heads is not None and Kv % _policy().axis_size(heads) == 0
    kv_spec = (bhsd[0], None, heads if kv_split else None, None)
    q, k, v = _to(q, mesh, q_spec), _to(k, mesh, kv_spec), \
        _to(v, mesh, kv_spec)
    if heads is None or kv_split:
        kl, vl = k.to_local(), v.to_local()
    else:
        grad_pl = _partial_over(mesh, kv_spec, _axes(heads))
        kl = k.to_local(grad_placements=grad_pl)
        vl = v.to_local(grad_placements=grad_pl)
        lo, hi = _shard_range(mesh, heads, H)
        if (hi - lo) % G == 0 or lo // G == (hi - 1) // G:
            # whole groups, or inside one group: a contiguous slice
            sel = slice(lo // G, max(hi // G, lo // G + 1))
            kl, vl = kl[:, :, sel], vl[:, :, sel]
        else:  # one KV head per query head
            idx = torch.arange(lo, hi, device=kl.device) // G
            kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
    out = op(q.to_local(), kl, vl, *args, **kw)
    return DTensor.from_local(out, mesh, placements(mesh, q_spec),
                              run_check=False)


def local_decode(op: Callable, q, k_cache, v_cache, cache_len, **kw):
    """``op(q, k_cache, v_cache, cache_len, **kw)`` (``decode_attention``)
    on each rank's shard, as ``local_attention``: batch over data, heads
    over model, a replicated cache's KV heads sliced per rank.  A cache
    sharded along its sequence (the policy's fallback for ``Kv % tp != 0``)
    would need a softmax merge across the shards, which the kernel does not
    do: it raises."""
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(k_cache, DTensor) and Shard(1) in k_cache.placements:
        raise NotImplementedError("decode_attention under DTensor: a KV "
                                  "cache sharded along its sequence needs a "
                                  "cross-shard softmax merge")
    if isinstance(cache_len, DTensor):
        cache_len = cache_len.full_tensor()
    return local_attention(op, q, k_cache, v_cache, cache_len, **kw)


def local_moe_gmm(op: Callable, x, w):
    """``op(x, w)`` (``moe_gmm``: x (E, N, D) rows per expert, w (E, D, F))
    on each rank's experts: E over the model axes of the ``moe_dispatch``
    rule, the rows over its data axes, w whole on every data rank (its
    gradient, a sum over the rows, is then ``Partial`` over them)."""
    from torch.distributed.tensor import DTensor

    mesh = _mesh_of(x, w)
    E, N, D = x.shape
    disp = _fit_or_replicate("moe_dispatch", (N, E, 1, D))
    x_spec = (disp[1], disp[0], None)
    w_spec = (disp[1], None, None)
    x = _to(x, mesh, x_spec)
    w = _to(w, mesh, w_spec)
    wl = w.to_local(grad_placements=_partial_over(mesh, w_spec,
                                                  _axes(disp[0])))
    return DTensor.from_local(op(x.to_local(), wl), mesh,
                              placements(mesh, x_spec), run_check=False)


def local_scan(op: Callable, a, x, h0):
    """``op(a, x, h0)`` (``rglru_scan``: a, x (B, S, R) fp32, h0 (B, R)) on
    each rank's channels and batch rows, the ``act_btr`` rule's placements:
    the recurrence is elementwise in (b, r), so a shard needs nothing of
    the others."""
    from torch.distributed.tensor import DTensor

    mesh = _mesh_of(a, x, h0)
    B, S, R = a.shape
    btr = _fit_or_replicate("act_btr", (B, S, R))
    if btr[1] is not None:
        raise NotImplementedError("rglru_scan under DTensor: the sequence "
                                  "is sharded")
    a = _to(a, mesh, btr)
    x = _to(x, mesh, btr)
    h0 = _to(h0, mesh, (btr[0], btr[2]))
    out = op(a.to_local().contiguous(), x.to_local().contiguous(),
             h0.to_local())
    return DTensor.from_local(out, mesh, placements(mesh, btr),
                              run_check=False)


def local_groups(fn: Callable, *args):
    """``fn(*args)`` on each rank's rows of the leading (group) dim: every
    tensor argument on the placements of the ``act_btd`` rule's batch entry
    over its dim 0 and replicated otherwise, every tensor output wrapped
    the same way.  For per-group work that DTensor has no rule for (the MoE
    dispatch plan: sorts, scatters and gathers within each group)."""
    from torch.distributed.tensor import DTensor

    mesh = _mesh_of(*args)

    def spec_of(t):
        lead = _fit_or_replicate("act_btd", (t.shape[0], 1, 1))[0]
        return (lead,) + (None,) * (t.dim() - 1)

    local = [_to(a, mesh, spec_of(a)).to_local()
             if isinstance(a, torch.Tensor) else a for a in args]
    lead = spec_of(next(a for a in args if isinstance(a, torch.Tensor)))[0]
    out = fn(*local)

    def wrap(t):
        return DTensor.from_local(t, mesh, placements(
            mesh, (lead,) + (None,) * (t.dim() - 1)), run_check=False)

    return tuple(wrap(t) for t in out) if isinstance(out, tuple) \
        else wrap(out)


def local_pointwise(fn: Callable, x):
    """``fn(x)`` for an elementwise ``fn`` that DTensor has no rule for
    (``logsigmoid``'s backward): on the local shard, same placements
    (a ``Partial`` input is reduced first)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(x, DTensor):
        return fn(x)
    pl = tuple(Replicate() if isinstance(p, Partial) else p
               for p in x.placements)
    if pl != tuple(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, pl,
                              run_check=False)


def local_embed(table, tokens):
    """``table[tokens]`` (the embedding lookup, the same indexing op as on
    plain tensors) on each rank's batch rows: tokens on the ``act_btd``
    rule's batch placements, the table whole on every rank (an FSDP
    gather of its data-sharded dim), its gradient then ``Partial`` over
    the axes that split the batch.  DTensor's own rule for the indexing
    backward (``index_put``) does not hold across torch versions."""
    from torch.distributed.tensor import DTensor

    mesh = _mesh_of(table, tokens)
    lead = _fit_or_replicate("act_btd", (tokens.shape[0], 1, 1))[0]
    tok_spec = (lead,) + (None,) * (tokens.dim() - 1)
    tokens = _to(tokens, mesh, tok_spec)
    table = _to(table, mesh, (None, None))
    tl = table.to_local(grad_placements=_partial_over(mesh, (None, None),
                                                      _axes(lead)))
    return DTensor.from_local(tl[tokens.to_local()], mesh,
                              placements(mesh, tok_spec + (None,)),
                              run_check=False)


def local_index_copy(dst, dim: int, index: torch.Tensor, src):
    """``dst.index_copy_(dim, index, src)`` in place on each rank's shard of
    ``dst`` (a serve cache), ``src`` brought to ``dst``'s placements.  A
    ``dst`` sharded along ``dim`` (the cache's sequence fallback) would
    need the writes routed to their shards: it raises."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if any(p == Shard(dim) for p in dst.placements):
        raise NotImplementedError("a cache write under DTensor into a "
                                  "cache sharded along its sequence")
    mesh = dst.device_mesh
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    if tuple(src.placements) != tuple(dst.placements):
        src = src.redistribute(mesh, dst.placements)
    if isinstance(index, DTensor):
        index = index.full_tensor()
    dst.to_local().index_copy_(dim, index,
                               src.to_local().to(dst.dtype))
    return dst
