"""The readings that the limits of ``correct`` are set from, for one cell
on the card, several seeds in one process:

    python3 fluorobench/control.py --workload <cell> --seeds 1,2,3 --seconds 3 [--fault <name>]

For each seed it runs the cell as ``run.py`` does (at the cell's own
sizes, with a short window) and prints one JSON line: the program's
numbers against the float64 reference and ``correct`` and, without
``--fault``, the control's numbers and ``control_correct``: the reference
at the precision below the configuration's (float32 with TF32 on) put in
the program's place and held to the cell's limits by the same check.
With ``--fault`` a fault (``faults.py``'s, or the runner's own) is planted
under the timed path and the program's numbers are read with it. A cell of
several cards runs all its seeds in one launch of its ranks
(``ranks.py``), whose rank 0 prints each line. The benchmark's own runs
never run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault", default="none")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from fluorobench.run import cache_env

    cache_env(ROOT)
    import torch

    from fluorobench import faults, harness, ranks

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print("cell {} needs {} CUDA card(s)".format(cell.name, cell.chips), file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    runner = harness.load_runner(cell)
    if cell.chips > 1:
        ranks.launch(cell, seeds, args.seconds, False, time.time(), fault=args.fault, control=True,
                     timeout=ranks.DEADLINE_S + 120.0 * len(seeds))
        return 0
    for seed in seeds:
        run = harness.Run(cell=cell, seed=seed, seconds=args.seconds, trace=False, device=torch.device("cuda", 0))
        torch.cuda.reset_peak_memory_stats()
        with faults.planted(args.fault, runner):
            runner.main(run)
        print(json.dumps(harness.control_line(run, runner, args.fault)), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
