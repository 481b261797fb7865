#!/usr/bin/env python3
"""Readings that set a docking cell's limits, on the card at the cell's own
size, all seeds in one process (control.py's readings over
drivers/docking.py):

    python3 h100_bench/dock_control.py --workload <cell> --seeds 1 2 3 ... [--out FILE]

For each seed the program's first steps are read as a run reads them, the
program is freed, and three readers are held to the float32 reference by
the run's comparison (reference/train.py compare): ``program`` (the lower
reading), ``control`` (the reference computed in fp8, the upper reading)
and ``half_batch`` (the reference with the second half of each batch left
out, a planted fault).  One JSON line per seed and reader, with the
parameter or step behind each number and the least Gaussian width of each
encoder's kernel, goes to standard output and to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

READERS = ("program", "control", "half_batch")


def readings(cell, seed: int, device: str = "cuda", readers=READERS) -> list:
    from h100_bench.drivers.docking import DockRun
    from h100_bench.reference import train as ref_train

    r = DockRun(cell, seed, device)
    r.setup()
    r.free()
    batches = r.reference_batches()
    ref = r.follow(batches)
    w = r.make_weights()
    std_min = {k: float(w[f"{k}_model.gbf.stds"].abs().min()) for k in ("mol", "pocket")}
    take = {"program": lambda: r.readings,
            "control": lambda: r.follow(batches, precision="fp8"),
            "half_batch": lambda: r.follow(batches, half_batch=True)}
    out = []
    for reader in readers:
        got = take[reader]()
        worst, leaves = {}, {}
        gaps = ref_train.compare(got, ref, worst=worst, leaves=leaves)
        out.append({"workload": cell.name, "seed": seed, "reader": reader, **gaps,
                    "worst": worst, "losses": got["losses"], "ref_losses": ref["losses"],
                    "gbf_std_min": std_min})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--readers", nargs="+", choices=READERS, default=list(READERS))
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    from h100_bench.run import pin_environment

    pin_environment()

    import torch

    from h100_bench.registry import Cell, Registry

    if not torch.cuda.is_available():
        print("dock_control.py reads on a CUDA card", file=sys.stderr)
        return 2
    cell = Cell(Registry(), args.workload)
    for seed in args.seeds:
        for line in readings(cell, seed, readers=args.readers):
            text = json.dumps(line)
            print(text, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
