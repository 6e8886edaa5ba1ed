"""Readings for the limits of ``correct``: a cell's numbers over several
seeds in one process, with the control or a planted fault of
``plants.py`` installed, or none (the program as it is).

    python3 -m slam_bench.control --workload <cell> --plant <name in plants.NAMES|none> \\
        --seeds 11,12,13 [--seconds 0]

``--seconds 0`` runs one sequence in the window. Prints one JSON line
per seed: the seed, ``correct``, every number with its limit, and the
readings of every number the harness knows (``inf`` where the cell gives
it nothing to read). The
benchmark's own runs never install a plant.
"""

from __future__ import annotations

import argparse
import json
import sys

from slam_bench import checks, registry
from slam_bench.run import run_cell, set_cache_dirs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--plant", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("slam_bench.control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = registry.load_cell(args.workload)
    plant = None if args.plant == "none" else args.plant
    for seed in (int(s) for s in args.seeds.split(",")):
        run, numbers, result = run_cell(cell, seed, args.seconds, False,
                                        torch.device("cuda", 0), plant=plant)
        print(json.dumps({"workload": cell.name, "plant": args.plant, "seed": seed,
                          "correct": result["correct"], "failed": result["failed"],
                          "numbers": numbers,
                          "readings": {k: f(run) for k, f in checks.NUMBERS.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
