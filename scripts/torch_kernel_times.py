#!/usr/bin/env python3
"""Time the port's kernels A-D of a neptune_tpu_torch tree on a GPU.

    python3 scripts/torch_kernel_times.py [--kernels ABCD] [ROOT]           # one JSON line
    python3 scripts/torch_kernel_times.py [--kernels ABCD] --abba PARENT    # PARENT, this, this, PARENT

ROOT (default: this checkout) is the root of a tree holding the
`neptune_tpu_torch` package, for example an earlier commit unpacked with
`git archive` into a directory that .gitignore lists. Each run builds this
checkout's chip_smoke.py cases with ROOT's own package and times, with CUDA
events after a warm-up call that builds the kernel:
  A: each phase-2 apply (a_cases) through `cuda_backend.try_execute_apply`,
     the host microseconds of one launch at 1024^2 (calls queued back to
     back, no sync), and the window form on 5-pt 4096^2 as one block;
  B: each phase-3 solve (B_SYSTEMS) through `solvers.fused.fused_cg`;
  C: each phase-5 case (c_cases) through `CompiledModule.sweeps`, the
     executor's route (k // depth launches of kernel C under that tree's
     plan, the rest kernel-A launches), the host microseconds of one call
     of the 1024^2 K=16 case, and the local form, K=8 on 5-pt 4096^2 as one
     block;
  D: each phase-6 composite (d_cases) through `CompiledModule.opdef`, the
     host microseconds of one launch of the 1024^2 composite
     (`chain.run_chain`, queued without a sync), and the origin form on the
     4096^2 composite as one block.
  V: generic CG's four vector steps on 322^3 float64 grids (HPCG's finest
     level), each as its kernel (`solvers.cg_vectors`, where ROOT has it)
     and as the eager steps it replaces (`utils.tree`'s tdot_f64 and taxpy,
     as the tuple loop runs them), beside its bound: the grids it reads and
     writes over 3.35 TB/s. Not in the default set.
`--abba` runs the two trees in turns, each in a process of its own, on the
same card, and prints every run's line and one summary line per case.
Needs a CUDA device and nvcc.
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


def host_us(cs, fn) -> float:
    """Median host microseconds of one call of fn, queued without a sync."""
    import torch

    us = 1e3 * cs.host_ms(fn, 50, lambda: None)[0]
    torch.cuda.synchronize()
    return us


def times_a(cs, dev, rng, out):
    import numpy as np
    import torch

    from neptune_tpu_torch import stencils
    from neptune_tpu_torch.config import config
    from neptune_tpu_torch.lowering import cuda_backend

    fold = config.fold_affine
    for label, module, fold_case, scalar in cs.a_cases():
        config.fold_affine = fold_case
        op = stencils.the_apply(module)
        args = cs.a_args(op, scalar, rng, dev)
        call = lambda: cuda_backend.try_execute_apply(op, args)  # noqa: E731
        out[f"A {label}"] = {"ms": cs.cuda_ms(call, 20)}
        if label.startswith("jacobi5 1024^2"):
            out["A host us per launch, jacobi5 1024^2"] = {"us": host_us(cs, call)}
    config.fold_affine = fold
    # the window form over the whole grid as one block (phase 8)
    op = stencils.the_apply(stencils.jacobi5((4096, 4096)))
    x = torch.from_numpy(rng.standard_normal((4096, 4096), dtype=np.float32)).to(dev)
    out["A window jacobi5 4096^2 f32, one block"] = {
        "ms": cs.cuda_ms(lambda: cuda_backend.apply_window(op, [x], [], (0, 0)), 20)}


def times_b(cs, dev, out):
    import numpy as np
    import torch

    from neptune_tpu_torch.solvers import fused
    from neptune_tpu_torch.solvers.precond import extract_diagonal, safe_inv_diag

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
        out[f"B {label}"] = {"iters": int(iters), "ms": ms, "solves": reps,
                             "us_per_iter": ms * 1e3 / max(int(iters), 1)}


def times_c(cs, dev, rng, out):
    import numpy as np
    import torch

    from neptune_tpu_torch import stencils
    from neptune_tpu_torch.lowering import sweeps
    from neptune_tpu_torch.lowering.executor import CompiledModule

    for label, module, name, k, sc, _ in cs.c_cases():
        shape = module.lookup(name).ftype.inputs[0].bounds.shape
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
        run = CompiledModule(module).sweeps(name, k)
        reps = 3 if x.numel() > 3e7 else 10  # as phase 5 times them
        out[f"C {label}"] = {"ms": cs.cuda_ms(lambda: run(x, *sc), reps)}
        if label.startswith("jacobi5 1024^2"):
            out["C host us per call, jacobi5 1024^2 K=16"] = {
                "us": host_us(cs, lambda: run(x, *sc))}
    # the local form, K=8 over the whole grid as one block (phase 8)
    op = stencils.the_apply(stencils.jacobi5((4096, 4096)))
    plan = sweeps.local_sweep_plan(op, (4096, 4096), 8)
    x = torch.from_numpy(rng.standard_normal((4096, 4096), dtype=np.float32)).to(dev)
    out["C local jacobi5 4096^2 K=8, one block"] = {
        "ms": cs.cuda_ms(lambda: sweeps.run_sweeps(plan, x, [], (0, 0)), 10)}


def times_d(cs, dev, rng, out):
    import numpy as np
    import torch

    from neptune_tpu_torch import stencils
    from neptune_tpu_torch.lowering import chain
    from neptune_tpu_torch.lowering.executor import CompiledModule

    for label, module, name, n_fields, sc in cs.d_cases():
        shape = module.lookup(name).ftype.inputs[0].bounds.shape
        fields = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
                  for _ in range(n_fields)]
        run = CompiledModule(module).opdef(name)
        reps = 5 if fields[0].numel() > 3e7 else 20  # as phase 6 times them
        out[f"D {label}"] = {"ms": cs.cuda_ms(lambda: run(*fields, *sc), reps)}
        if label.startswith("composite 1024^2"):
            plan = chain.chain_plan(module, name)
            out["D host us per launch, composite 1024^2"] = {
                "us": host_us(cs, lambda: chain.run_chain(plan, fields, []))}
    # the origin form over the whole grid as one block (phase 8)
    plan = chain.chain_plan(stencils.composite((4096, 4096)), "wrapped", (4096, 4096))
    x = torch.from_numpy(rng.standard_normal((4096, 4096), dtype=np.float32)).to(dev)
    out["D origin composite 4096^2, one block"] = {
        "ms": cs.cuda_ms(lambda: chain.run_chain(plan, [x], [], global_start=(0, 0)), 10)}


def times_v(cs, dev, out):
    import importlib.util

    import torch

    from neptune_tpu_torch.utils.tree import taxpy, tdot_f64

    def safe(d):  # the loop's division guard, also for trees older than utils.tree.safe
        return torch.where(d == 0, torch.ones_like(d), d)

    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    x, p, r, ap, z = (torch.randn((322,) * 3, dtype=torch.float64, device=dev, generator=gen)
                      for _ in range(5))
    rz, alpha, beta = tdot_f64(r, z), tdot_f64(p, p), tdot_f64(z, z)
    target, far = 0 * rz, torch.full_like(rz, 1e300)
    grid_ms = x.numel() * 8 / cs.HBM_BYTES_PER_S * 1e3

    def eager_update():
        taxpy(alpha, p, x), taxpy(-alpha, ap, r)
        rn = torch.sqrt(tdot_f64(r, r))
        return (rn > target) & (rn <= far)

    # step: (grids read and written, the eager steps)
    steps = {
        "dot_alpha": (2, lambda: rz / safe(tdot_f64(p, ap))),
        "update": (6, eager_update),
        "dot_beta": (2, lambda: tdot_f64(r, z) / safe(rz)),
        "direction": (3, lambda: taxpy(beta, p, z)),
    }
    kernels = {}
    if importlib.util.find_spec("neptune_tpu_torch.solvers.cg_vectors") is not None:
        from neptune_tpu_torch.solvers import cg_vectors as cv

        sc = cv.Scalars(x, rz, torch.sqrt(rz), target, far)
        kernels = {
            "dot_alpha": lambda: cv.dot_alpha(p, ap, sc),
            "update": lambda: cv.update(x, p, r, ap, sc, False),
            "dot_beta": lambda: cv.dot_beta(r, z, sc),
            "direction": lambda: cv.direction(p, z, sc),
        }
    total = {"bound_ms": 0.0, "eager_ms": 0.0, "ms": 0.0}
    for name, (grids, eager) in steps.items():
        row = {"bound_ms": grids * grid_ms, "eager_ms": cs.cuda_ms(eager, 20)}
        if name in kernels:
            row["ms"] = cs.cuda_ms(kernels[name], 20)
            row["bound_pct"] = 100 * row["bound_ms"] / row["ms"]
        out[f"V {name} 322^3 f64"] = row
        for k in total:
            total[k] += row.get(k, 0.0)
    if kernels:
        total["bound_pct"] = 100 * total["bound_ms"] / total["ms"]
    else:
        del total["ms"]
    out["V an iteration's four steps 322^3 f64"] = total


def run(root: Path, kernels: str) -> dict:
    cs = smoke()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_times: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED)
    out = {"root": str(root), "device": torch.cuda.get_device_name(0), "cases": {}}
    for kernel in kernels:
        if kernel == "A":
            times_a(cs, dev, rng, out["cases"])
        elif kernel == "B":
            times_b(cs, dev, out["cases"])
        elif kernel == "C":
            times_c(cs, dev, rng, out["cases"])
        elif kernel == "D":
            times_d(cs, dev, rng, out["cases"])
        elif kernel == "V":
            times_v(cs, dev, out["cases"])
    return out


def abba(parent: Path, kernels: str) -> int:
    card = smoke().nvidia_smi()
    runs = []
    for root in (parent, HERE, HERE, parent):
        proc = subprocess.run([sys.executable, __file__, "--kernels", kernels, str(root)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    for case in runs[0]["cases"]:
        p = [runs[0]["cases"][case], runs[3]["cases"][case]]
        c = [runs[1]["cases"][case], runs[2]["cases"][case]]
        key = "us" if "us" in p[0] else "ms" if "ms" in p[0] else "eager_ms"
        mean_p = sum(r[key] for r in p) / 2
        mean_c = sum(r[key] for r in c) / 2
        line = {"case": case, "card": card, "unit": key,
                "parent": [r[key] for r in p], "change": [r[key] for r in c],
                "parent_over_change": mean_p / mean_c}
        if "iters" in p[0]:
            line["iters"] = {"parent": p[0]["iters"], "change": c[0]["iters"]}
        print(json.dumps(line), flush=True)
    return 0


def main() -> int:
    args = sys.argv[1:]
    kernels = "ABCD"
    if len(args) > 1 and args[0] == "--kernels":
        kernels, args = args[1].upper(), args[2:]
    if len(args) > 1 and args[0] == "--abba":
        return abba(Path(args[1]).resolve(), kernels)
    root = Path(args[0]).resolve() if args else HERE
    print(json.dumps(run(root, kernels)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
