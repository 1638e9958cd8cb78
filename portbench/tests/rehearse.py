"""A CPU rehearsal of one run of a cell at a small size, with the port's
plain kernels, for the tests (run as a module, so that the reference's
worker processes can import it):

    python -m portbench.tests.rehearse <cell> <seed> <seconds> <trace> \
        [--fault NAME] [--root DIR] [--size WxH]

Prints the run's result line, with `forbidden` (the forbidden top-level
modules loaded once the run has ended) added, as its last line."""
from __future__ import annotations

import argparse
import json
import sys

# small enough for the CPU, large enough for three CTB columns and two
# rows; the profiled stretch of a batch shortened to fit its wavefront
SIZE = (192, 128)
CPU_PROFILE = {"skip_wave_steps": 4, "wave_steps": 8}


def rehearse(cell_name, seed, seconds, trace, fault=None, root=None,
             size=SIZE, bench=None, device="cpu"):
    import torch
    from portbench.run import forbidden_modules, run_cell
    from portbench.spec import ROOT, Cell
    torch.set_num_threads(1)
    cell = Cell(cell_name, bench=bench, root=root or ROOT)
    if "wave_steps" in cell.traffic.get("profile", {}):
        cell.traffic["profile"] = dict(CPU_PROFILE)
    out = run_cell(cell, seed, seconds, trace, device=device, size=size,
                   fault=fault, log=lambda *a: None)
    out["forbidden"] = forbidden_modules()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cell")
    ap.add_argument("seed", type=int)
    ap.add_argument("seconds", type=float)
    ap.add_argument("trace", type=int)
    ap.add_argument("--fault")
    ap.add_argument("--root")
    ap.add_argument("--size")
    a = ap.parse_args(argv)
    size = tuple(int(v) for v in a.size.split("x")) if a.size else SIZE
    print(json.dumps(rehearse(a.cell, a.seed, a.seconds, bool(a.trace),
                              a.fault, a.root, size)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
