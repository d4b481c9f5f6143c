"""Run one cell of the benchmark on the card this process starts on.

    python3 ecobench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints progress and the launch check on standard error, then the numbers
compared with their limits as its last lines there, and the result as the
last line of standard output: one JSON object with ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``checks`` last.  Exits with a code other than 0, and
prints no result, when there is no CUDA card or fewer than the cell asks
for, when ``repro_torch`` is missing, or when a module of JAX or of the
JAX package ``repro`` is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    os.environ.setdefault("USE_FLAX", "0")

    from ecobench import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        harness.log(f"{args.workload} needs {cell.chips} CUDA card(s); "
                    f"found {torch.cuda.device_count()}")
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), T_START)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"modules of {', '.join(found)} are loaded; the "
                    "benchmark runs the port alone")
        return 3
    for name, chk in result["checks"].items():
        harness.log(f"check {name} {chk['value']!r} limit {chk['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
