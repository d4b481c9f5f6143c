"""The port's sharding policy and input specs against the JAX package's.

Both packages' ``ShardingPolicy`` read only a mesh's axis names and sizes,
so the production meshes stand in as plain objects (``FakeMesh``, as
``tests/test_sharding.py`` does): (1, 1), (1, 2), (16, 16) and (2, 16,
16).  Every spec the port gives must equal the reference's
``PartitionSpec`` read as a tuple, leaf by leaf by path:

* ``param_pspecs`` for all ten archs at full size in both unit layouts
  (stacked for ``lax.scan``, and a per-unit list), from ``params_sds``;
* ``opt_pspecs`` for adamw, sgd and adafactor;
* ``cache_pspecs`` of ``cache_specs(cfg, 4, 64)``;
* ``activation_rules`` with and without sequence parallelism, and
  ``data_pspec``;
* ``fit_spec``'s divisibility guard (the reference's three cases).

Then ``input_specs`` / ``cache_specs`` shapes and dtypes for every assigned
cell, and ``assigned_cells`` / ``runnable_cells``, against JAX's.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jax_configs
from repro.distributed.api import ActivationPolicy as JaxActivationPolicy
from repro.distributed.sharding import ShardingPolicy as JaxPolicy
from repro.launch.steps import params_sds as jax_params_sds
from repro_torch import configs
from repro_torch.distributed.api import ActivationPolicy
from repro_torch.distributed.sharding import ShardingPolicy, \
    tree_map_with_path
from repro_torch.launch.steps import build_step, params_sds

torch.set_num_threads(1)


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {
    "1x1": {"data": 1, "model": 1},
    "1x2": {"data": 1, "model": 2},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}


def _jax_flat(tree) -> dict:
    """{path: leaf} of a JAX tree whose leaves may be PartitionSpecs."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            leaf for path, leaf in flat}


def _port_flat(tree) -> dict:
    """{path: leaf} of a port tree (spec tuples are leaves)."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], path + (k,))
        elif isinstance(t, list):
            for i, x in enumerate(t):
                walk(x, path + (i,))
        else:
            out[path] = t

    walk(tree, ())
    return out


def _same_specs(port_tree, jax_tree):
    got, want = _port_flat(port_tree), _jax_flat(jax_tree)
    assert set(got) == set(want)
    bad = {p: (got[p], tuple(want[p])) for p in want
           if got[p] != tuple(want[p])}
    assert not bad, list(bad.items())[:5]


@pytest.fixture(scope="module")
def trees():
    """(port params_sds, JAX params_sds) per (arch, scan_layers)."""
    cache = {}

    def get(arch, scan):
        if (arch, scan) not in cache:
            pc = configs.get_config(arch).with_overrides(scan_layers=scan)
            jc = jax_configs.get_config(arch).with_overrides(scan_layers=scan)
            cache[arch, scan] = (pc, params_sds(pc), jc, jax_params_sds(jc))
        return cache[arch, scan]

    return get


@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("arch", configs.ALL_ARCHS)
def test_param_and_opt_pspecs_match_jax(arch, scan, trees):
    pc, p_sds, jc, j_sds = trees(arch, scan)
    for name, shape in MESHES.items():
        port, ref = ShardingPolicy(FakeMesh(shape)), JaxPolicy(FakeMesh(shape))
        assert port.dp_axes == ref.dp_axes
        p_spec, j_spec = port.param_pspecs(pc, p_sds), \
            ref.param_pspecs(jc, j_sds)
        _same_specs(p_spec, j_spec)
        for opt in ("adamw", "sgd", "adafactor"):
            _same_specs(port.opt_pspecs(opt, p_spec, p_sds),
                        ref.opt_pspecs(opt, j_spec, j_sds))


@pytest.mark.parametrize("arch", configs.ALL_ARCHS)
def test_cache_pspecs_match_jax(arch):
    for scan in (True, False):
        pc = configs.get_config(arch).with_overrides(scan_layers=scan)
        jc = jax_configs.get_config(arch).with_overrides(scan_layers=scan)
        p_cache = configs.cache_specs(pc, 4, 64)
        j_cache = jax_configs.cache_specs(jc, 4, 64)
        for shape in MESHES.values():
            _same_specs(ShardingPolicy(FakeMesh(shape)).cache_pspecs(p_cache),
                        JaxPolicy(FakeMesh(shape)).cache_pspecs(j_cache))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("sp", [False, True])
def test_activation_rules_and_data_pspec_match_jax(mesh, sp):
    shape = MESHES[mesh]
    port = ShardingPolicy(FakeMesh(shape), sequence_parallel=sp)
    ref = JaxPolicy(FakeMesh(shape), sequence_parallel=sp)
    got, want = port.activation_rules(), ref.activation_rules()
    assert set(got) == set(want)
    assert {k: got[k] for k in got} == {k: tuple(v) for k, v in want.items()}
    assert got["act_btd"][1] == ("model" if sp else None)
    for dims in [(4, 7), (32,), (256, 9, 3), (3, 5), (512, 2), (2, 1, 1)]:
        assert port.data_pspec(dims) == tuple(ref.data_pspec(dims))


@pytest.mark.parametrize("spec,shape,want", [
    (("data", "model"), (3, 7), (None, None)),  # nothing divides: replicate
    (("data", "model"), (32, 7), ("data", None)),  # partial fit
    ((("data", "model"), None), (256, 7), (("data", "model"), None)),
])
def test_fit_spec_divisibility_guard(spec, shape, want):
    mesh = FakeMesh({"data": 16, "model": 16})
    got = ActivationPolicy(mesh, {"x": ("data", None)}).fit_spec(spec, shape)
    ref = JaxActivationPolicy(mesh, {"x": P("data", None)}).fit_spec(
        P(*spec), shape)
    assert got == tuple(ref) == want


def _shapes(tree, jax_side: bool) -> dict:
    flat = _jax_flat(tree) if jax_side else _port_flat(tree)
    return {p: (tuple(x.shape), str(np.dtype(x.dtype)) if jax_side
                else str(x.dtype).replace("torch.", ""))
            for p, x in flat.items()}


@pytest.mark.parametrize("arch", configs.ALL_ARCHS)
def test_input_specs_match_jax_for_every_assigned_cell(arch):
    for a, shape in configs.assigned_cells():
        if a != arch:
            continue
        got = configs.input_specs(configs.get_config(a), shape)
        want = jax_configs.input_specs(jax_configs.get_config(a), shape)
        assert all(x.device.type == "meta"
                   for x in _port_flat(got).values())
        assert _shapes(got, False) == _shapes(want, True), (a, shape)


def test_cells_match_jax():
    assert configs.assigned_cells() == jax_configs.assigned_cells()
    assert configs.runnable_cells() == jax_configs.runnable_cells()


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "seamless-m4t-medium",
                                  "llava-next-34b"])
def test_build_step_places_every_input(arch, shape):
    """``build_step`` on the production mesh stand-in: one placement tree
    per input, the params' from ``param_pspecs``, the batch's from
    ``data_pspec``."""
    from torch.distributed.tensor import Replicate, Shard

    cfg = configs.get_config(arch)
    policy = ShardingPolicy(FakeMesh(MESHES["16x16"]))
    bundle = build_step(cfg, policy, shape)
    assert len(bundle.args_sds) == len(bundle.in_placements)
    p_pl = _port_flat(bundle.in_placements[0])
    want = tree_map_with_path(lambda _, s: policy.placements(s),
                              policy.param_pspecs(cfg, bundle.args_sds[0]))
    assert p_pl == _port_flat(want)
    if shape == "train_4k":
        batch_pl = bundle.in_placements[3]
        assert batch_pl["tokens"] == (Shard(0), Replicate())
    assert bundle.name.startswith(configs.resolve_shape(shape).kind)
