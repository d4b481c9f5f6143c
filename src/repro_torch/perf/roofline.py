"""Three-term roofline per (arch x shape x mesh), on the H100's terms.

    compute_term    = impl_FLOPs / (chips x 989 TFLOP/s dense bf16)
    memory_term     = HBM_bytes / (chips x 3.35 TB/s HBM3)
    collective_term = wire_bytes_per_chip / (links x 450 GB/s NVLink 4)

The JAX package's ``perf/roofline.py`` (three terms over the analytic cost
model) with the H100 SXM5's datasheet figures in place of the TPU's:
NVIDIA H100 Tensor Core GPU datasheet, SXM5 column: 989 TFLOP/s dense BF16
tensor core (1 979 with sparsity), 3.35 TB/s HBM3, and NVLink 4 at 900
GB/s per GPU in both directions together, 450 GB/s each way.  FLOPs and
bytes come from ``perf/cost_model.py``, the JAX package's model unchanged;
collective bytes come from a dry-run report where one exists.
``MODEL_FLOPS = 6 N(_active) D`` is reported alongside as the
useful-compute ratio.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from repro_torch import configs as cfglib
from repro_torch.models.config import SHAPE_SUITE
from repro_torch.perf.cost_model import cell_cost

PEAK_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s per H100 SXM5
HBM_BW = 3.35e12  # bytes/s per H100 SXM5 (HBM3)
LINK_BW = 450e9  # bytes/s each way per GPU over NVLink 4
LINKS = 1  # NVLink is one aggregate port per GPU (the switch fans it out)


@dataclass
class RooflineRow:
    arch: str
    shape: str
    chips: int
    compute_s: float
    kernel_compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    impl_flops: float
    useful_ratio: float
    dominant: str
    step_s: float  # max of terms (no-overlap bound)

    def table_row(self) -> str:
        return (f"{self.arch:24s} {self.shape:12s} {self.compute_s*1e3:9.2f} "
                f"{self.memory_s*1e3:9.2f} {self.collective_s*1e3:9.2f} "
                f"{self.useful_ratio:6.2f} {self.dominant:10s}")


def roofline_for_cell(arch: str, shape_name: str, chips: int,
                      collectives: Optional[dict] = None,
                      *, use_kernel_flops: bool = False) -> RooflineRow:
    cfg = cfglib.get_config(arch)
    shape = SHAPE_SUITE[shape_name]
    cost = cell_cost(cfg, shape)
    per_dev = cost.per_device(chips)

    compute_s = per_dev.impl_flops / PEAK_FLOPS
    kernel_s = per_dev.kernel_flops / PEAK_FLOPS
    memory_s = per_dev.hbm_bytes / HBM_BW
    wire = 0.0
    if collectives:
        wire = sum(d.get("wire_bytes", 0.0) for d in collectives.values())
    collective_s = wire / (LINKS * LINK_BW)

    use_c = kernel_s if use_kernel_flops else compute_s
    terms = {"compute": use_c, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    return RooflineRow(
        arch=arch, shape=shape_name, chips=chips,
        compute_s=compute_s, kernel_compute_s=kernel_s,
        memory_s=memory_s, collective_s=collective_s,
        model_flops=cost.model_flops, impl_flops=cost.impl_flops,
        useful_ratio=cost.model_flops / max(cost.impl_flops, 1.0),
        dominant=dominant, step_s=max(terms.values()),
    )


def load_dryrun_report(path: str | Path) -> dict:
    rows = json.loads(Path(path).read_text())
    out = {}
    for r in rows:
        if r.get("status") == "ok":
            out[(r["arch"], r["shape"], r["mesh_name"])] = r
    return out


def full_table(report_path: str | Path = "reports/dryrun_all.json",
               mesh_name: str = "single") -> list[RooflineRow]:
    report = load_dryrun_report(report_path) if Path(report_path).exists() \
        else {}
    chips = 256 if mesh_name == "single" else 512
    rows = []
    for arch, shape, status in cfglib.runnable_cells():
        if status != "run":
            continue
        rec = report.get((arch, shape, mesh_name))
        colls = rec.get("collectives") if rec else None
        rows.append(roofline_for_cell(arch, shape, chips, colls))
    return rows


def render(rows: list[RooflineRow]) -> str:
    hdr = (f"{'arch':24s} {'shape':12s} {'comp(ms)':>9s} {'mem(ms)':>9s} "
           f"{'coll(ms)':>9s} {'useful':>6s} {'dominant':10s}")
    return "\n".join([hdr, "-" * len(hdr)] + [r.table_row() for r in rows])


def step_share(cfg, shape, step_s: float, chips: int = 1) -> dict:
    """A measured step against its roofline: the larger of the compute and
    memory terms of ``cell_cost(cfg, shape)`` on ``chips`` cards, and the
    model-FLOP share ``model_flops / (step_s x chips x PEAK_FLOPS)``."""
    cost = cell_cost(cfg, shape)
    per = cost.per_device(chips)
    compute_s, memory_s = per.impl_flops / PEAK_FLOPS, per.hbm_bytes / HBM_BW
    return dict(roofline_ms=1e3 * max(compute_s, memory_s),
                roofline_by="compute" if compute_s >= memory_s else "memory",
                model_flops=cost.model_flops,
                model_flop_share=cost.model_flops
                / (step_s * chips * PEAK_FLOPS))


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="the roofline table of every "
                                 "runnable cell, on the H100's terms")
    ap.add_argument("--report", default="reports/dryrun_all.json")
    ap.add_argument("--mesh", default="single", choices=("single", "multi"))
    args = ap.parse_args()
    print(render(full_table(args.report, args.mesh)))


if __name__ == "__main__":
    main()
