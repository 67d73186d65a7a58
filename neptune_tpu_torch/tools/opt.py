"""neptune-opt-torch — pass-inspection CLI.

The port of `neptune_tpu/tools/opt.py`, a rebuild of the reference's
`neptune-opt` (an mlir-opt clone, `src/neptuneOpt.cpp:38-47`, workflow
`README.md:33-55`): parse an IR file, run passes, print IR after each
requested stage. In place of the JAX package's jaxpr/HLO dumps it prints
the CUDA source of the kernels a function launches, and with --plan it
names the kernel (A-D) or the eager route each op takes.

Usage:
  neptune-opt-torch FILE.ntir                          # verify + print
  neptune-opt-torch FILE.ntir --pipeline               # all stages, final IR
  neptune-opt-torch FILE.ntir --dump-all               # IR after every stage
  neptune-opt-torch FILE.ntir --until high-level-convertion
  neptune-opt-torch FILE.ntir --source entry           # CUDA source of the
                                                       # kernels @entry launches
  neptune-opt-torch FILE.ntir --run entry --inputs a.npy b.npy   # execute on
                                                       # the card (--device cpu)
  neptune-opt-torch FILE.ntir --run entry --native     # execute on the C++ runtime
  neptune-opt-torch FILE.ntir --plan 4x2               # sharded plan and kernel
                                                       # route per opdef on a
                                                       # topology-only 4x2 mesh
  neptune-opt-torch FILE.py ...                        # run a python DSL script
                                                       # and use its traced module

(`python -m neptune_tpu_torch.tools.opt` is the same program.) Exits
non-zero with the verifier error on invalid IR (the contract the
reference's negative lit tests check, e.g.
test/mlir_tests/solve-linear-invalid-system.mlir).
"""

from __future__ import annotations

import argparse
import runpy
import sys

_KERNELS = {
    "A": "kernel A (stencil_apply)",
    "B": "kernel B (fused_cg)",
    "C": "kernel C (stencil_sweeps)",
    "D": "kernel D (stencil_chain)",
}


def load_module(path: str):
    from ..ir.parser import parse_module

    if path.endswith(".py"):
        from ..frontend.core import get_context, reset_context

        reset_context()
        runpy.run_path(path, run_name="__main__")
        return get_context().module
    with open(path) as f:
        return parse_module(f.read())


def _opdef_applies(module, name: str, seen=None) -> list:
    """The applies an opdef runs, through the opdefs it calls."""
    seen = set() if seen is None else seen
    if name in seen:
        return []
    seen.add(name)
    out = []
    for op in module.lookup(name).walk():
        if op.name == "neptune.apply":
            out.append(op)
        elif op.name in ("neptune.apply_linear", "neptune.apply_nonlinear"):
            out += _opdef_applies(module, op.attrs["symbol"], seen)
    return out


def _solve_symbol(op):
    """The opdef a solve_linear op's assembled matrix names, or None."""
    owner = op.operands[0].defining_op
    return owner.attrs.get("symbol") if owner is not None else None


def _fused_site(module, op) -> bool:
    """Whether a solve_linear op takes kernel B, under the executor's
    conditions (`CompiledModule._fused_site`)."""
    from ..solvers import fused

    sym = _solve_symbol(op)
    if sym is None or op.attrs.get("precision", "full") == "mixed":
        return False
    return (
        op.attrs.get("solver", "cg") == "cg"
        and not op.attrs.get("options")
        and op.attrs.get("precond", "none") in (None, "none", "jacobi")
        and fused.supported(module, sym, module.lookup(sym).ftype.inputs[0])
    )


def opdef_route(module, name: str) -> str:
    """The kernel route of a call of opdef @name on the card (backend
    "auto"): kernel D for a composite that `chain.chain_plan` takes, else
    kernel A for each apply that `cuda_backend.supported` takes, eager for
    the others; kernel C for `CompiledModule.sweeps` where
    `sweeps.sweep_plan` takes it."""
    from ..lowering import chain, cuda_backend, sweeps

    if chain.chain_plan(module, name) is not None:
        route = _KERNELS["D"]
    else:
        applies = _opdef_applies(module, name)
        ok = [cuda_backend.supported(op) for op in applies]
        if ok and all(ok):
            route = _KERNELS["A"]
        elif any(ok):
            route = f"{_KERNELS['A']} for {sum(ok)} of {len(ok)} applies, eager for the rest"
        else:
            route = "eager (no kernel takes its applies: rank 1 or mixed domains)"
    if sweeps.sweep_plan(module, name, 2) is not None:
        route += f"; sweeps: {_KERNELS['C']}"
    return route


def function_kernels(module, name: str) -> list:
    """(what, kernel letter, source) of each kernel that function or opdef
    @name launches on the card, from the generated sources."""
    from ..kernels import codegen
    from ..lowering import chain, cuda_backend
    from ..solvers import fused

    fn = module.lookup(name)
    out = []

    def opdef_sources(sym):
        plan = chain.chain_plan(module, sym)
        if plan is not None:
            out.append((f"@{sym}", "D", codegen.chain_source(plan)))
            return
        for i, op in enumerate(_opdef_applies(module, sym)):
            if cuda_backend.supported(op):
                out.append((f"@{sym} apply {i}", "A", cuda_backend.source(op)))

    if fn.is_opdef:
        opdef_sources(name)
        return out
    done = set()
    for op in fn.walk():
        if op.name == "neptune.apply" and cuda_backend.supported(op):
            out.append((f"@{name} apply", "A", cuda_backend.source(op)))
        elif op.name == "neptune.solve_linear" and _fused_site(module, op):
            sym = _solve_symbol(op)
            out.append((f"solve_linear @{sym}", "B",
                        codegen.fused_cg_source(fused.cg_plan(module, sym))))
        else:
            for key in ("symbol", "residual", "jacobian"):
                sym = op.attrs.get(key)
                if isinstance(sym, str) and sym in module.functions and sym not in done:
                    done.add(sym)
                    if module.lookup(sym).is_opdef:
                        opdef_sources(sym)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="neptune-opt-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("file", help="IR file (.ntir dump) or python DSL script")
    ap.add_argument(
        "--pipeline", action="store_true", help="run the full lowering pipeline"
    )
    ap.add_argument(
        "--dump-all", action="store_true", help="print IR after every stage"
    )
    ap.add_argument("--until", help="stop after the named stage")
    ap.add_argument(
        "--source", metavar="FUNC",
        help="print the CUDA source of each kernel FUNC launches on the card",
    )
    ap.add_argument("--run", metavar="FUNC", help="execute FUNC and print outputs")
    ap.add_argument(
        "--inputs", nargs="*", default=[],
        help=".npy files (or scalar literals) for --run; zeros when omitted",
    )
    ap.add_argument(
        "--native", action="store_true",
        help="execute --run on the native C++ runtime (host f64) instead of torch",
    )
    ap.add_argument(
        "--backend", default=None, choices=["auto", "torch", "cuda"],
        help="apply-executor backend for --run",
    )
    ap.add_argument(
        "--device", default=None,
        help="device of --run's inputs (default config.device: the card; 'cpu' to run there)",
    )
    ap.add_argument(
        "--plan",
        metavar="MESH",
        help="print the sharded execution plan and kernel route of every opdef over a "
        "process mesh, e.g. --plan 4x2 (topology-only: no processes needed)",
    )
    ap.add_argument("-o", "--output", help="write final IR to file")
    args = ap.parse_args(argv)

    from ..ir.ops import IRError
    from ..passes import run_pipeline

    try:
        module = load_module(args.file)
    except IRError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    try:
        until = args.until
        if not (args.pipeline or args.dump_all or until or args.source or args.run or args.plan):
            until = "verify-annotate"
        pr = run_pipeline(module, until=until)
    except IRError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    final = list(pr.dumps.values())[-1]
    if args.dump_all:
        for stage, dump in pr.dumps.items():
            print(f"// ----- IR after {stage} -----")
            print(dump)
    if args.output:
        with open(args.output, "w") as f:
            f.write(final)
    elif not args.dump_all and not args.plan:
        print(final)

    if args.run:
        import numpy as np
        import torch

        irfn = pr.module.lookup(args.run)
        example = []
        for i, a in enumerate(irfn.body.args):
            t = a.type
            if i < len(args.inputs):
                src = args.inputs[i]
                val = np.load(src) if src.endswith(".npy") else np.asarray(float(src))
            elif hasattr(t, "bounds"):
                val = np.zeros(t.bounds.shape, dtype=t.element)
            elif hasattr(t, "shape"):
                val = np.zeros(t.shape, dtype=t.element)
            else:
                val = np.zeros(())
            example.append(val)
        if args.native:
            from ..runtime import NativeCompiledModule

            # pr.module is already lowered; compile it directly rather than
            # re-running the pipeline through compile_native
            out = NativeCompiledModule(pr.module).function(args.run)(*example)
        else:
            from ..config import default_device

            device = default_device(args.device)
            out = pr.compiled(args.backend, device).function(args.run)(*example)
        outs = out if isinstance(out, tuple) else (out,)
        for j, o in enumerate(outs):
            if isinstance(o, torch.Tensor):
                o = o.detach().cpu().numpy()
            o = np.asarray(o)
            print(
                f"// output {j}: shape={o.shape} dtype={o.dtype} "
                f"checksum={float(o.sum()):.10g}"
            )
            with np.printoptions(threshold=64, precision=6):
                print(o)

    if args.plan:
        from ..parallel import GridMesh, plan_report

        try:
            mesh_shape = tuple(int(s) for s in args.plan.split("x"))
        except ValueError:
            print(f"error: bad --plan mesh '{args.plan}' (want e.g. 4x2)", file=sys.stderr)
            return 1
        gm = GridMesh(mesh_shape, abstract=True)
        cm = pr.compiled(args.backend, "cpu")
        for fn in pr.module.opdefs():
            print(f"// ----- sharded plan of @{fn.name} on mesh {args.plan} -----")
            try:
                print(plan_report(cm, fn.name, gm), end="")
            except ValueError as e:
                print(f"// no plan: {e}")
            print(f"// kernels on the whole grid: {opdef_route(pr.module, fn.name)}")
        for fn in pr.module.funcs():
            for op in fn.walk():
                if op.name == "neptune.solve_linear" and _fused_site(pr.module, op):
                    sym = _solve_symbol(op)
                    print(f"// @{fn.name}: solve_linear @{sym} on the whole grid: "
                          f"{_KERNELS['B']}")

    if args.source:
        kernels = function_kernels(pr.module, args.source)
        if not kernels:
            print(f"// @{args.source} launches no kernel (eager on every device)")
        for what, k, src in kernels:
            print(f"// ----- {_KERNELS[k]} source for {what} -----")
            print(src)
    return 0


if __name__ == "__main__":
    sys.exit(main())
