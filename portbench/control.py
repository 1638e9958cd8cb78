"""The control of `correct`, run on the chip at a cell's own size and
load; the benchmark's own runs never run it.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \
        --seconds 10

Runs the cell once a seed, in one process, with the control planted in
the program (faults.py "control": the search's SATDs rounded to bfloat16
before they are compared), and prints each run's compared numbers with
their limits as one JSON line a seed."""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    from .run import device_line, run_cell, set_cache_dirs
    from .spec import ROOT, Cell
    set_cache_dirs(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 3
    print(device_line(), file=sys.stderr, flush=True)
    cell = Cell(a.workload)
    for seed in (int(s) for s in a.seeds.split(",")):
        out = run_cell(cell, seed, a.seconds, False, fault="control")
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "fault": "control",
                          "correct": out["correct"],
                          "failed": out["failed"],
                          "attempted": out["attempted"],
                          "checks": out["checks"]}), flush=True)
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
