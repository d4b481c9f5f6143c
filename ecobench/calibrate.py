"""Readings that a cell's limit is set from, on the card, at the cell's own
size, in one process:

    python3 ecobench/calibrate.py --workload <cell> --seeds 1-12 \
        --control-seeds 1-3

For each seed: weights and prompts from the seed, one whole cycle of the
cell's traffic through the port (the window's path at its batch and
lengths), the sample the run would check, and its widest gap against the
float32 reference (the program's reading).  For each control seed also the
float8 control's widest gap on the same sequences.  Each reading is
judged as a run judges it (``check.judge``) against the cell's committed
limit.  One JSON line a seed on standard output, and a summary: the lower
reading (the program's largest), the upper (the control's smallest), and
the seeds each side read correct on.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def seed_list(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, type=seed_list)
    ap.add_argument("--control-seeds", default="", type=lambda s:
                    seed_list(s) if s else [])
    args = ap.parse_args(argv)
    for p in (ROOT, ROOT / "src"):
        sys.path.insert(0, str(p))

    import importlib

    import torch

    from ecobench import check as checklib
    from ecobench import harness
    from ecobench.traffic import PromptSource

    if not torch.cuda.is_available():
        harness.log("no CUDA card")
        return 2
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    c, mix = cell.config, cell.mix
    fam = importlib.import_module(f"ecobench.families.{c['family']}")
    ref = importlib.import_module(f"ecobench.reference.{c['reference']}")
    program, control = {}, {}
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t0 = time.perf_counter()
        w = fam.make_weights(torch, c, seed, dev)
        server = harness.Server(torch, cell, fam.port_params(w), dev)
        prompts = PromptSource(torch, seed, c["vocab_size"], dev)
        batches = [server.serve(prompts.batch(mix.batch, S))
                   for S in mix.cycle_order(seed, 0)]
        del server
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        samples = checklib.sample_requests(batches, mix.check_requests, seed)
        row = {"seed": seed, "cycle_s": t1 - t0}
        if seed in args.seeds:
            row["program"] = checklib.served_gap(torch, ref, w, c, batches,
                                                 samples)
            row["program"]["correct"], _ = checklib.judge(row["program"],
                                                          cell.limits)
            program[seed] = row["program"]
        t2 = time.perf_counter()
        if seed in args.control_seeds:
            row["control"] = checklib.control_gap(torch, ref, w, c, batches,
                                                  samples)
            row["control"]["correct"], _ = checklib.judge(row["control"],
                                                          cell.limits)
            control[seed] = row["control"]
        row["reference_s"], row["control_s"] = t2 - t1, time.perf_counter() - t2
        print(json.dumps(row), flush=True)
        del w, batches
        torch.cuda.empty_cache()
    def summary(side):
        gaps = {s: r["max_gap"] for s, r in side.items()}
        return gaps, [s for s, r in side.items() if r["correct"]]

    (pg, p_ok), (cg, c_ok) = summary(program), summary(control)
    print(json.dumps({
        "workload": args.workload, "card": torch.cuda.get_device_name(dev),
        "limit": cell.limits["max_gap"]["limit"],
        "lower": max(pg.values()) if pg else None,
        "upper": min(cg.values()) if cg else None,
        "program": pg, "program_correct_on": p_ok,
        "control": cg, "control_correct_on": c_ok}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
