"""Readings that set a cell's limits, many seeds in one process:

    python3 cardbench/readings.py --workload <cell> --seeds 11,12,13 \
        [--seconds 2] [--program] [--control] [--out <file.jsonl>]

``--program`` runs the cell (set-up, a short window, the check) on each
seed and prints what each number compared read: the lower readings.
``--control`` puts the reference one precision step below what the
configuration states in the program's place, at the cell's own size, and
prints the same numbers: the upper readings.  One JSON line per seed and
kind.  The benchmark's own runs never run this.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--program", action="store_true")
    p.add_argument("--control", action="store_true")
    p.add_argument("--out")
    args = p.parse_args(argv)

    from cardbench import harness

    cell = harness.Cell(harness.load_benchmark(), args.workload)
    harness.host_threads(cell)
    import torch

    harness.check_device(cell.chips)
    module = harness.config_module(cell.entry["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        lines = []
        if args.program:
            out = harness.run_cell(cell, seed, args.seconds, False,
                                   time.perf_counter())
            r = out["result"]
            lines.append({"cell": cell.name, "seed": seed, "kind": "program",
                          "correct": r["correct"], "checks": r["checks"],
                          "metrics": r["metrics"], "units": out["card"]["units"],
                          "launches": out["card"]["launches"]})
        if args.control:
            wl = module.Workload(cell.config, cell.traffic, seed, "cuda")
            wl.make_inputs()
            lines.append({"cell": cell.name, "seed": seed, "kind": "control",
                          "checks": wl.control()})
            del wl
        gc.collect()
        torch.cuda.empty_cache()
        for line in lines:
            text = json.dumps(line)
            print(text, flush=True)
            if args.out:
                with open(args.out, "a") as fh:
                    fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
