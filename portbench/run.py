"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (`correct`, `attempted`, `failed`, `metrics`, `device`, with
--trace 1 `breakdown`, and last `checks`, each number compared beside its
limit); the last lines of standard error repeat the checks. Without the
CUDA devices the cell asks for, without the port beside it, or with JAX
or the JAX package loaded, it exits non-zero and prints no result.

The port's kernels build into `portbench/_cache/` (NEPTUNE_TORCH_CACHE_DIR),
so only a checkout's first run compiles.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    os.environ["NEPTUNE_TORCH_CACHE_DIR"] = str(ROOT / "portbench" / "_cache")
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    return harness.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())
