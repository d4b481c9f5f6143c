"""The port's roofline (``perf/roofline.py``, the H100's terms) against the
JAX package's (the TPU's terms) on the same analytic cost model: the FLOP
and byte counts behind each term are equal, so ``compute_s x 989e12`` and
``memory_s x 3.35e12`` must equal JAX's ``compute_s x 197e12`` and
``memory_s x 819e9`` (rel 1e-12); the useful-compute fields and the
dominant term agree where the terms keep their order; and the reference's
own sanity tests (``tests/test_roofline.py``) hold on the port."""
import json

import pytest

from repro.perf import roofline as jax_roofline
from repro_torch.configs import get_config
from repro_torch.models.config import SHAPE_SUITE
from repro_torch.perf import roofline
from repro_torch.perf.cost_model import cell_cost

REL = 1e-12


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= REL * max(abs(a), abs(b))


def test_terms_are_the_h100_datasheet_figures():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 450e9


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_terms_match_jax_on_the_same_cost_model(shape):
    row = roofline.roofline_for_cell("llama3-8b", shape, 256, None)
    ref = jax_roofline.roofline_for_cell("llama3-8b", shape, 256, None)
    assert _close(row.compute_s * 989e12, ref.compute_s * 197e12)
    assert _close(row.kernel_compute_s * 989e12,
                  ref.kernel_compute_s * 197e12)
    assert _close(row.memory_s * 3.35e12, ref.memory_s * 819e9)
    assert row.collective_s == ref.collective_s == 0.0
    assert row.model_flops == ref.model_flops
    assert row.impl_flops == ref.impl_flops
    assert row.useful_ratio == ref.useful_ratio
    # the dominant term where the terms keep their order under the new
    # rates (compute / memory ratios of 989e12 / 3.35e12 vs 197e12 / 819e9)
    same_order = (row.compute_s > row.memory_s) == \
        (ref.compute_s > ref.memory_s)
    if same_order:
        assert row.dominant == ref.dominant
    assert row.step_s == max(row.compute_s, row.memory_s, row.collective_s)


def test_collective_term_reads_a_dryrun_report(tmp_path):
    report = [{"status": "ok", "arch": "llama3-8b", "shape": "train_4k",
               "mesh_name": "single",
               "collectives": {"all-reduce": {"wire_bytes": 9e9},
                               "all-gather": {"wire_bytes": 4.5e9}}},
              {"status": "error", "arch": "gemma-7b", "shape": "train_4k",
               "mesh_name": "single"}]
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(report))
    loaded = roofline.load_dryrun_report(path)
    assert set(loaded) == {("llama3-8b", "train_4k", "single")}
    rows = {(r.arch, r.shape): r for r in roofline.full_table(path)}
    assert _close(rows["llama3-8b", "train_4k"].collective_s,
                  13.5e9 / (roofline.LINKS * roofline.LINK_BW))
    assert rows["gemma-7b", "train_4k"].collective_s == 0.0
    # no report: every runnable cell, no collective term
    plain = roofline.full_table(tmp_path / "missing.json")
    assert len(plain) == len(rows)
    assert all(r.collective_s == 0.0 for r in plain)
    text = roofline.render(plain)
    assert text.splitlines()[0].split()[:2] == ["arch", "shape"]
    assert len(text.splitlines()) == len(plain) + 2


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_roofline_rows_sane(shape):
    row = roofline.roofline_for_cell("llama3-8b", shape, 256, None)
    assert row.compute_s > 0
    assert row.memory_s > 0
    assert 0 < row.useful_ratio <= 2.0
    if shape == "train_4k":
        # 6ND sanity: 6 x 8e9 params x 1.05e6 tokens ~ 5e16
        assert 1e16 < row.model_flops < 1e17


def test_kernel_flops_below_impl_flops_for_causal():
    cfg = get_config("llama3-8b")
    c = cell_cost(cfg, SHAPE_SUITE["train_4k"])
    assert c.kernel_flops < c.impl_flops
    c2 = cell_cost(cfg, SHAPE_SUITE["prefill_32k"])
    # longer context -> bigger causal-waste gap
    assert c2.kernel_flops / c2.impl_flops < \
        c.kernel_flops / c.impl_flops + 0.05


def test_moe_active_params_drive_model_flops():
    kimi = get_config("kimi-k2-1t-a32b")
    c = cell_cost(kimi, SHAPE_SUITE["train_4k"])
    dense_equiv = 6.0 * kimi.param_count() * 256 * 4096
    assert c.model_flops < 0.1 * dense_equiv  # active << total for 1T MoE
