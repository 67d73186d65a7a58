"""The readings a cell's limits are set from, on the card at the cell's own
size: the program's numbers on many seeds, the control's (the reference
in the precision below the configuration's, in the program's place) and
each fault's (`unchanged`, `altered`), in one process. The benchmark's own
runs never run this.

    python3 portbench/calibrate.py --workload <cell> --seconds 3 \
        --seeds 11,12,... [--control-seeds 21,22,23] [--fault-seeds 31,32,33]

Prints one JSON line per run: what ran, the seed, each number compared,
the answers compared and those over the cell's current limit.
"""

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--fault-seeds", type=seeds, default=[])
    args = p.parse_args(argv)
    os.environ["NEPTUNE_TORCH_CACHE_DIR"] = str(ROOT / "portbench" / "_cache")
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    def control(system, driver, cell, reference):
        return driver.control(cell, reference)

    def fault(kind):
        return lambda system, driver, cell, reference: driver.faults(system)[kind]

    runs = [("program", s, None) for s in args.seeds]
    runs += [("control", s, control) for s in args.control_seeds]
    runs += [(f"fault {k}", s, fault(k))
             for s in args.fault_seeds for k in ("unchanged", "altered")]
    for what, seed, swap in runs:
        result, checks, _ = harness.run_cell(args.workload, seed, args.seconds, False,
                                             t0=time.perf_counter(), swap=swap)
        print(json.dumps({"cell": args.workload, "what": what, "seed": seed,
                          "correct": result["correct"], "attempted": result["attempted"],
                          "failed": result["failed"], "metrics": result["metrics"],
                          "checks": result["checks"]}), flush=True)
        del result
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
