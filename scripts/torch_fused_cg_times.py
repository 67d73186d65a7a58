#!/usr/bin/env python3
"""Time kernel B (the fused CG solve) of a neptune_tpu_torch tree on a GPU.

    python3 scripts/torch_fused_cg_times.py [ROOT]          # ROOT's package, one JSON line
    python3 scripts/torch_fused_cg_times.py --abba PARENT   # PARENT, this tree, this tree, PARENT

ROOT (default: this checkout) is the root of a tree holding the
`neptune_tpu_torch` package, for example an earlier commit unpacked with
`git archive` into a directory that .gitignore lists. Each run solves this
checkout's chip_smoke.py phase-3 systems (its B_SYSTEMS), each with the
right-hand side of seed 0, through ROOT's own `solvers.fused.fused_cg`,
after a warm-up solve that builds the kernel, and times them with CUDA
events. `--abba` runs the two trees in turns, each in a process of its own,
on the same card, and prints every run's line and a summary line per
system. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def smoke():
    """This checkout's chip_smoke.py, as a module (whatever ROOT holds)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(root: Path) -> dict:
    cs = smoke()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from neptune_tpu_torch.solvers import fused
    from neptune_tpu_torch.solvers.precond import extract_diagonal, safe_inv_diag

    if not torch.cuda.is_available():
        raise SystemExit("torch_fused_cg_times: no CUDA device")
    dev = torch.device("cuda")
    out = {"root": str(root), "device": torch.cuda.get_device_name(0), "cases": {}}
    for label, system, name, tol, maxiter, jacobi in cs.B_SYSTEMS:
        module = cs.b_system(system)
        shape = module.lookup(name).ftype.inputs[0].bounds.shape
        rhs = np.random.default_rng(cs.SEED).standard_normal(shape, dtype=np.float32)
        b = torch.from_numpy(rhs).to(dev)
        inv = None
        if jacobi:
            matvec = fused.plain_matvec(fused.matvec_plan(module, name))
            diag = extract_diagonal(matvec, torch.zeros(shape, device=dev), ((1, 1), (1, 1)))
            inv = safe_inv_diag(diag)
        solve = fused.fused_cg(module, name, tol=tol, maxiter=maxiter, inv_diag=inv)
        _, iters, _ = solve(b)
        reps = 3 if int(iters) > 1000 else 20  # as phase 3 times them
        ms = cs.cuda_ms(lambda: solve(b), reps)
        out["cases"][label] = {"iters": int(iters), "ms": ms, "solves": reps,
                               "us_per_iter": ms * 1e3 / max(int(iters), 1)}
    return out


def abba(parent: Path) -> int:
    card = smoke().nvidia_smi()
    runs = []
    for root in (parent, HERE, HERE, parent):
        proc = subprocess.run([sys.executable, __file__, str(root)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    for label in runs[0]["cases"]:
        p = [runs[0]["cases"][label], runs[3]["cases"][label]]
        c = [runs[1]["cases"][label], runs[2]["cases"][label]]
        print(json.dumps({
            "case": label, "card": card,
            "parent": {"iters": p[0]["iters"], "ms": [r["ms"] for r in p],
                       "us_per_iter": sum(r["us_per_iter"] for r in p) / 2},
            "change": {"iters": c[0]["iters"], "ms": [r["ms"] for r in c],
                       "us_per_iter": sum(r["us_per_iter"] for r in c) / 2},
        }), flush=True)
    return 0


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--abba":
        return abba(Path(sys.argv[2]).resolve())
    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    print(json.dumps(run(root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
