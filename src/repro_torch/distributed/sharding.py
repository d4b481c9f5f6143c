"""Parameter / activation / cache sharding policy.

The JAX package's rule engine (``src/repro/distributed/sharding.py``), one
for every architecture in the zoo, giving the same spec tuples:

  * TP ("model" axis): attention heads, FFN hidden dim, MoE expert dim,
    vocab dim of embedding/head, recurrent inner dims.
  * FSDP (all data axes, incl. the "pod" axis multi-pod): the remaining
    large dim of each weight.
  * DP: batch dim of activations / caches / inputs over the data axes.
  * KV heads replicate when n_kv < |model| (GQA with few KV heads); dims
    that don't divide fall back to replication per dim.

The specs are pure data (tuples, ``distributed/api.py``) and need only the
mesh's axis names and sizes.  ``placements`` / ``param_shardings`` /
``shardings_of`` turn them into DTensor placements on a real
``DeviceMesh``, and ``distribute`` places a tree of tensors on them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from repro_torch.distributed import api
from repro_torch.distributed.api import ActivationPolicy, norm_entry
from repro_torch.models.config import ModelConfig

Tree = Any


def tree_map_with_path(fn, tree, *rest, path: tuple = ()):
    """``fn(path, leaf, *rest_leaves)`` leafwise; ``path`` holds the dict
    keys and list indices down to the leaf (``tree_map`` of
    ``optim/optimizers.py`` with the path)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      path=path + (k,)) for k in tree}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, t, *(r[i] for r in rest),
                                   path=path + (i,))
                for i, t in enumerate(tree)]
    return fn(path, tree, *rest)


def _is_spec(x) -> bool:
    return isinstance(x, tuple)


def map_specs(fn, tree: Tree, *rest) -> Tree:
    """``fn`` over the spec tuples of a spec tree (whose leaves are tuples,
    not tensors)."""
    if _is_spec(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_specs(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return [map_specs(fn, t, *(r[i] for r in rest))
            for i, t in enumerate(tree)]


@dataclass
class ShardingPolicy:
    mesh: Any
    sequence_parallel: bool = False  # Megatron-SP style activation sharding
    dp_axes: tuple[str, ...] = field(init=False)
    tp_axis: str = "model"

    def __post_init__(self):
        self.dp_axes = tuple(a for a in api.axis_names(self.mesh)
                             if a != self.tp_axis)
        self._sizes = api.axis_sizes(self.mesh)

    # -- axis helpers -------------------------------------------------------
    def _size(self, axes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        n = 1
        for a in axes:
            n *= self._sizes[a]
        return n

    def dp(self, dim: int):
        """Largest data-axis set that divides ``dim`` (greedy suffixes)."""
        for k in range(len(self.dp_axes)):
            axes = self.dp_axes[k:]
            if dim % self._size(axes) == 0:
                return axes if len(axes) > 1 else axes[0]
        return None

    def tp(self, dim: int):
        return self.tp_axis if dim % self._size(self.tp_axis) == 0 else None

    # -- parameters ---------------------------------------------------------
    def param_pspecs(self, cfg: ModelConfig, params_shapes: Tree) -> Tree:
        """Spec tree matching ``params_sds(cfg)`` (or any tree of tensors
        of those shapes)."""

        def rule(path, leaf) -> tuple:
            keys = list(path)
            name = keys[-1] if isinstance(keys[-1], str) else ""
            in_moe = "moe" in keys and "shared" not in keys
            stacked = "units" in keys and cfg.scan_layers
            shape = tuple(leaf.shape)
            tail = shape[1:] if stacked else shape

            def spec(*tail_axes) -> tuple:
                fitted = [
                    (ax if d % self._size(ax) == 0 else None)
                    if ax is not None else None
                    for ax, d in zip(tail_axes, tail)
                ]
                if stacked:
                    fitted = [None] + fitted
                return tuple(norm_entry(f) for f in fitted)

            dp, tp = self.dp_axes, self.tp_axis
            if name == "embed":
                if cfg.tie_embeddings:
                    return spec(tp, None)
                return spec(None, dp)
            if name == "head":
                return spec(None, tp)
            if name in ("frontend_proj",):
                return spec(dp, tp)
            if name == "wq":
                return spec(dp, tp, None)
            if name in ("wk", "wv"):
                return spec(dp, tp, None)  # replicates when n_kv < |model|
            if name == "wo":
                return spec(tp, None, dp)
            if in_moe and name in ("w_gate", "w_up"):
                return spec(tp, dp, None)  # (E, D, F)
            if in_moe and name == "w_down":
                return spec(tp, None, dp)
            if name == "router":
                return spec(None, None)
            if name in ("w_gate", "w_up"):  # dense/shared MLP (D, F)
                return spec(dp, tp)
            if name == "w_down":  # (F, D)
                return spec(tp, dp)
            # recurrent families ------------------------------------------
            if name in ("w_x", "w_gate_in"):  # (D, R)
                return spec(dp, tp)
            if name == "w_out":  # (R, D) / slstm (D, D)
                return spec(tp, dp)
            if name in ("w_a", "w_i", "w_f", "w_z", "w_o") and len(tail) == 2:
                return spec(dp, tp)
            if name.startswith("r_") and len(tail) == 3:  # slstm (NH, dh, dh)
                return spec(tp, None, None)
            # norms, biases, conv weights, gates: replicate
            return (None,) * len(shape)

        return tree_map_with_path(rule, params_shapes)

    def param_shardings(self, cfg: ModelConfig, params_shapes: Tree) -> Tree:
        return self.shardings_of(self.param_pspecs(cfg, params_shapes))

    # -- optimizer state ----------------------------------------------------
    def opt_pspecs(self, optimizer_name: str, param_pspecs: Tree,
                   params_shapes: Tree) -> Tree:
        if optimizer_name == "adamw":
            return {"m": param_pspecs, "v": param_pspecs}
        if optimizer_name == "sgd":
            return {"m": param_pspecs}
        if optimizer_name == "adafactor":
            def per_leaf(spec_: tuple, t) -> dict:
                nd = len(t.shape)
                if nd >= 2:
                    parts = list(spec_) + [None] * (nd - len(spec_))
                    return {"row": tuple(parts[:-1]),
                            "col": tuple(parts[:-2] + parts[-1:])}
                return {"v": spec_}

            return map_specs(per_leaf, param_pspecs,
                             _leaves_like(param_pspecs, params_shapes))
        raise ValueError(optimizer_name)

    # -- activations --------------------------------------------------------
    def activation_rules(self) -> dict[str, tuple]:
        dp, tp = norm_entry(self.dp_axes), self.tp_axis
        seq = tp if self.sequence_parallel else None
        return {
            "act_btd": (dp, seq, None),
            "act_btf": (dp, None, tp),
            "act_btr": (dp, None, tp),
            "act_bshd": (dp, None, tp, None),
            "act_bskd": (dp, None, tp, None),
            "attn_bhsd": (dp, tp, None, None),
            "act_btv": (dp, None, tp),
            "moe_idx": (dp, tp, None),
            "moe_dispatch": (dp, tp, None, None),
            "moe_hidden": (dp, tp, None, None),
        }

    def activation_policy(self) -> ActivationPolicy:
        return ActivationPolicy(
            self.mesh, self.activation_rules(),
            cache_placer=self.new_cache)

    # -- step inputs --------------------------------------------------------
    def data_pspec(self, shape: tuple[int, ...]) -> tuple:
        """Batch-leading arrays (tokens, labels, frontend embeds)."""
        return (norm_entry(self.dp(shape[0])),) + (None,) * (len(shape) - 1)

    def data_sharding(self, t) -> tuple:
        return self.placements(self.data_pspec(tuple(t.shape)))

    def cache_pspecs(self, cache_shapes: Tree) -> Tree:
        """Serve caches: batch over data axes; KV-head / state dims over
        model.  Rules address dims from the END so the same rule covers both
        plain (B, ...) and scan-stacked (n_units, B, ...) layouts."""
        rules = {
            "k": (4, {2: "tp"}),       # (B, W, Kv, hd); seq fallback below
            "v": (4, {2: "tp"}),
            "C": (4, {3: "tp"}),       # mlstm (B, NH, dh, dh)
            "n": (3, {2: "tp"}),       # mlstm normalizer (B, NH, dh)
            "m": (2, {1: "tp"}),       # mlstm stabilizer (B, NH)
            "h": (2, {1: "tp"}),       # rglru/slstm state (B, R)
            "c": (2, {1: "tp"}),       # slstm cell (B, D)
            "conv": (3, {1: "tp"}),    # rglru conv history (B, W-1, R)
        }

        def rule(path, leaf) -> tuple:
            name = next((k for k in reversed(path) if isinstance(k, str)), "")
            shape = tuple(leaf.shape)
            parts: list = [None] * len(shape)
            r = rules.get(name)
            if r is not None and len(shape) >= r[0]:
                b_idx = len(shape) - r[0]
                parts[b_idx] = self.dp(shape[b_idx])
                for from_end, kind in r[1].items():
                    i = len(shape) - from_end
                    parts[i] = self.tp(shape[i]) if kind == "tp" \
                        else self.dp(shape[i])
                if name in ("k", "v") and parts[len(shape) - 2] is None:
                    # GQA with n_kv < |model|: shard the SEQUENCE dim
                    w_idx = len(shape) - 3
                    parts[w_idx] = self.tp(shape[w_idx])
            elif shape:
                parts[0] = self.dp(shape[0])
            return tuple(norm_entry(p) for p in parts)

        return tree_map_with_path(rule, cache_shapes)

    # -- DTensor placements on a real DeviceMesh ----------------------------
    def placements(self, spec_: tuple) -> tuple:
        return api.placements(self.mesh, spec_)

    def replicated(self) -> tuple:
        return self.placements(())

    def shardings_of(self, pspec_tree: Tree) -> Tree:
        return map_specs(self.placements, pspec_tree)

    def new_cache(self, shapes: Tree, fills: Tree) -> Tree:
        """A new serve cache as DTensors on ``cache_pspecs(shapes)``, each
        rank making only its own shard: ``shapes`` is the cache's tree of
        ``meta`` tensors, ``fills`` the same tree at batch 1 and capacity 1.
        Every block's initial state fills each leaf with one constant, which
        the shard takes from ``fills``; no rank holds the global cache."""
        from torch.distributed.tensor import DTensor

        def shard(spec_, meta, fill):
            pl = self.placements(spec_)
            local = api.local_shape(self.mesh, pl, meta.shape)
            t = fill.reshape(-1)[:1].reshape((1,) * meta.dim())
            return DTensor.from_local(t.expand(local).contiguous(), self.mesh,
                                      pl, run_check=False, shape=meta.shape,
                                      stride=meta.stride())

        specs = self.cache_pspecs(shapes)
        return map_specs(shard, specs, _leaves_like(specs, shapes),
                         _leaves_like(specs, fills))

    def distribute(self, tree: Tree, pspec_tree: Tree) -> Tree:
        """``tree``'s tensors as DTensors on the placements of
        ``pspec_tree``; each source tensor must hold the full value on
        every rank (the same seed)."""
        from torch.distributed.tensor import distribute_tensor

        return map_specs(
            lambda s, t: distribute_tensor(t, self.mesh, self.placements(s)),
            pspec_tree, _leaves_like(pspec_tree, tree))


def _leaves_like(spec_tree: Tree, tree: Tree) -> Tree:
    """``tree`` cut to ``spec_tree``'s structure (the two mirror each
    other; this only checks it)."""
    if _is_spec(spec_tree):
        if isinstance(tree, (dict, list)):
            raise ValueError("spec tree and tree differ in structure")
        return tree
    if isinstance(spec_tree, dict):
        return {k: _leaves_like(spec_tree[k], tree[k]) for k in spec_tree}
    return [_leaves_like(s, t) for s, t in zip(spec_tree, tree)]


def to_local_tree(tree: Tree) -> Tree:
    """Every DTensor of ``tree`` as the full tensor on this rank."""
    from torch.distributed.tensor import DTensor

    from repro_torch.optim.optimizers import tree_map

    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)

