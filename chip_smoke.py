#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (neptune_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA device and nvcc.
It builds every kernel of the port's main paths from the sources in the
checkout, holds each against its plain PyTorch version at the main paths'
shapes, drives the main paths themselves (the implicit heat step of
`entry()`, the 3-D GMRES step, the 5-pt Jacobi headline apply; the DSL's
K-sweep and composite-operator rows of bench.py), checks that each path
went through its kernels, and prints CUDA-event timings. It exits non-zero,
printing no result, when there is no CUDA device, when the port is not
beside it, or when any phase fails.

Phases (one or more lines each, then the kernels' JSON line, the card's
nvidia-smi line, and the result line):
  1. device and build: versions, nvcc seconds per library;
  2. kernel A (stencil_apply) against its plain version: f32 bitwise, bf16
     within one bf16 ulp;
  3. kernel B (fused_cg) against its plain version: iterations within 1,
     true residual, solution within 1e-4;
  4. the first main path end to end, with launch counts, against plain runs;
  5. kernel C (stencil_sweeps) against its plain version and against the
     same sweeps as kernel-A launches, bitwise, with launch counts and
     times at other depths per launch;
  6. kernel D (stencil_chain) against the stages run one at a time, by the
     plain version and by kernel A, bitwise;
  7. the DSL path end to end: bench.py's K-sweep and composite rows built
     with `neptune_tpu_torch`'s decorators, with launch counts, against the
     per-stage route.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0


def say(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def require(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn() on the current stream, by CUDA
    events around `reps` calls, after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def abba(kernel, plain, reps: int) -> tuple[float, float]:
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def device_us(fn, reps: int, kernel: str):
    """Mean device microseconds per launch of the CUDA kernels whose name
    holds `kernel`, from a torch.profiler trace of `reps` calls; None when
    the trace shows no device time for them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(
        e.device_time_total for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key
    )
    return total / reps if total > 0 else None


def busy_share(fn, reps: int) -> tuple[float, float]:
    """(device milliseconds of all CUDA kernels per call, their share of the
    host wall time of the calls), from a torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernel rows only: the CPU-side ops' device totals would count them twice
    dev = sum(
        e.device_time_total for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    return dev / reps / 1e3, dev / wall_us


def copy_gbs(nbytes: int, reps: int = 20) -> float:
    """A same-moment device-to-device copy moving `nbytes` (read + write)."""
    import torch

    src = torch.empty(max(nbytes // 8, 1), dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src), reps)
    return 2 * src.numel() * 4 / ms / 1e6


def rand(rng, shape, dev):
    import torch

    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)


def counters():
    from neptune_tpu_torch.lowering import chain, cuda_backend, sweeps
    from neptune_tpu_torch.solvers import fused

    return {c.name: c for c in (cuda_backend.counter, fused.counter, sweeps.counter, chain.counter)}


def dsl_rows(ntt):
    """bench.py's temporal-blocking and composite rows, built with the
    port's DSL as bench.py builds them with the JAX package's: (label,
    compiled module, opdef, k or None for a composite, the row's callable)."""
    from neptune_tpu_torch.ir import Bounds, ScalarType, TempType

    def jacobi(n):
        ntt.reset_context()

        @ntt.linear_op_def(
            bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]), dtype="float32"
        )
        def jacobi(u):
            return 0.25 * (u[-1, 0] + u[1, 0] + u[0, -1] + u[0, 1])

        return jacobi

    rows = []
    op = jacobi(1024)
    cm = ntt.get_context().compiled()
    rows.append(("jacobi_2d_1024_temporal_k16", cm, "jacobi", 16, ntt.sweeps(op, 16)))
    jacobi(4096)
    cm = ntt.get_context().compiled()
    rows.append(("jacobi_2d_4096_temporal_k16", cm, "jacobi", 16, cm.sweeps("jacobi", 16)))

    ntt.reset_context()
    m = 256

    @ntt.linear_op_def(
        bounds=([0, 0, 0], [m, m, m]), interior=([1, 1, 1], [m - 1, m - 1, m - 1]),
        dtype="float32",
    )
    def heat(u):
        return u[0, 0, 0] + 0.1 * (
            u[-1, 0, 0] + u[1, 0, 0] + u[0, -1, 0]
            + u[0, 1, 0] + u[0, 0, -1] + u[0, 0, 1]
            - 6.0 * u[0, 0, 0]
        )

    cm = ntt.get_context().compiled()
    rows.append(("heat_3d_256_temporal_k8", cm, "heat", 8, cm.sweeps("heat", 8)))

    ntt.reset_context()
    n8 = 8192

    @ntt.nonlinear_op_def(
        bounds=([0, 0], [n8, n8]), interior=([2, 2], [n8 - 2, n8 - 2]), dtype="float32",
        name="adv4_wide",
    )
    def adv4_wide(u):
        dudx = (-u[2, 0] + 8.0 * u[1, 0] - 8.0 * u[-1, 0] + u[-2, 0]) / 12.0
        dudy = (-u[0, 2] + 8.0 * u[0, 1] - 8.0 * u[0, -1] + u[0, -2]) / 12.0
        return u[0, 0] - 0.1 * (0.7 * dudx + 0.3 * dudy)

    cm = ntt.get_context().compiled()
    rows.append(("advection4_2d_8192_twolevel_k16", cm, "adv4_wide", 16, cm.sweeps("adv4_wide", 16)))

    for n in (1024, 4096):
        ntt.reset_context()

        @ntt.linear_op_def(
            bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]), dtype="float32"
        )
        def lap2d(u):
            return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

        ctx = ntt.get_context()
        b = ctx.builder
        tt = TempType("float32", Bounds.of([0, 0], [n, n]))
        fn = b.make_opdef("wrapped", "linear_opdef", [tt], [tt])
        b.push_block(fn.body)
        lap2x = b.apply_linear("lap2d", [b.apply_linear("lap2d", [fn.body.args[0]])])
        ap, body = b.start_apply([fn.body.args[0], lap2x], tt.bounds)
        b.push_block(body)
        x0 = b.access(body.args[2], [0, 0])
        l0 = b.access(body.args[3], [0, 0])
        b.yield_(b.add(x0, b.mul(b.constant(0.01, ScalarType("float32")), l0)))
        b.pop_block()
        b.return_([b.finish_apply(ap)])
        b.pop_block()
        ctx.bump()
        cm = ctx.compiled()
        rows.append((f"composite_chain_{n}", cm, "wrapped", None, cm.opdef("wrapped")))
    ntt.reset_context()
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port's kernels need a CUDA device")
    if not (ROOT / "neptune_tpu_torch" / "csrc").is_dir():
        fail(f"no neptune_tpu_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import neptune_tpu_torch as ntt
    from neptune_tpu_torch import entry, stencils
    from neptune_tpu_torch.config import config
    from neptune_tpu_torch.kernels import codegen
    from neptune_tpu_torch.kernels.build import builder
    from neptune_tpu_torch.lowering import chain, cuda_backend, sweeps, torch_backend
    from neptune_tpu_torch.lowering.executor import CompiledModule
    from neptune_tpu_torch.solvers import fused
    from neptune_tpu_torch.solvers.precond import extract_diagonal, safe_inv_diag

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    card = nvidia_smi()

    # ---- the main path's operators, at the main path's shapes -----------
    # (label, module, affine folding): the last case runs every body op by op
    A_CASES = [
        ("jacobi5 1024^2 f32", stencils.jacobi5((1024, 1024)), True),
        ("jacobi5 4096^2 f32", stencils.jacobi5((4096, 4096)), True),
        ("jacobi5 4096^2 bf16", stencils.jacobi5((4096, 4096), "bfloat16"), True),
        ("heat7 256^3 f32", stencils.heat7((256, 256, 256)), True),
        ("heat7 256^3 bf16", stencils.heat7((256, 256, 256), "bfloat16"), True),
        ("heat7 periodic 256^3 f32", stencils.heat7((256, 256, 256), periodic=True), True),
        ("adv4 4096^2 f32 (h0=2)", stencils.advection4((4096, 4096)), True),
        ("adv4 4096^2 bf16 (h0=2)", stencils.advection4((4096, 4096), "bfloat16"), True),
        ("adv4 periodic 4096^2 f32", stencils.advection4((4096, 4096), periodic=True), True),
        ("u+dt*k 4096^2 f32", stencils.combination((4096, 4096)), True),
        ("two-result gradients 4096^2 f32", stencils.gradients((4096, 4096)), True),
        ("adv4 4096^2 f32 unfolded", stencils.advection4((4096, 4096)), False),
    ]
    heat_cm = entry.build_step(256, "float32", device=dev)
    poisson = stencils.poisson5(512)
    B_CASES = [
        ("heat_A 256^2 tol 1e-6", heat_cm.module, "heat_A", 1e-6, 200, False),
        ("poisson 512^2 jacobi tol 1e-4", poisson, "poisson", 1e-4, 5500, True),
    ]
    step3d_cm = entry.build_step_3d(256, "float32", device=dev)
    # kernel C: (label, module, opdef, k, scalars, other depths per launch to time)
    C_CASES = [
        ("jacobi5 1024^2 K=16", stencils.jacobi5((1024, 1024)), "jacobi", 16, (), ()),
        ("jacobi5 4096^2 K=16", stencils.jacobi5((4096, 4096)), "jacobi", 16, (), (8,)),
        ("heat7 256^3 K=8", stencils.heat7((256, 256, 256)), "heat", 8, (), (8, 4)),
        ("adv4 8192^2 K=16 (h0=2)", stencils.advection4((8192, 8192)), "adv4", 16, (), (16, 4)),
        ("adv4 periodic 4096^2 K=16", stencils.advection4((4096, 4096), periodic=True),
         "adv4", 16, (), ()),
        ("relax w=0.8 4096^2 K=16", stencils.damped_jacobi((4096, 4096)), "relax", 16, (0.8,), ()),
    ]
    # kernel D: (label, module, opdef, fields, scalars)
    D_CASES = [
        ("composite 1024^2", stencils.composite((1024, 1024)), "wrapped", 1, ()),
        ("composite 4096^2", stencils.composite((4096, 4096)), "wrapped", 1, ()),
        ("mixed periodic/bounded 4096^2", stencils.composite((4096, 4096), mixed=True),
         "wrapped", 1, ()),
        ("two fields + scalars 4096^2", stencils.coupled((4096, 4096)), "couple", 2, (0.7, -1.3)),
        ("composite 256^3", stencils.composite((256, 256, 256)), "wrapped", 1, ()),
    ]
    rows = dsl_rows(ntt)
    c_plans = []
    for _, module, name, k, _, depths in C_CASES:
        c_plans.append(sweeps.sweep_plan(module, name, k))
        c_plans += [sweeps.sweep_plan(module, name, k, depth=d) for d in depths]
    d_plans = [chain.chain_plan(module, name) for _, module, name, *_ in D_CASES]
    for _, cm, name, k, _ in rows:
        if k is None:
            d_plans.append(chain.chain_plan(cm.module, name))
        else:
            c_plans.append(sweeps.sweep_plan(cm.module, name, k))
    require(all(p is not None for p in c_plans + d_plans), "a kernel C or D case has no plan")

    # ---- phase 1: device and build -------------------------------------
    say(f"phase 1 device: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    sources, fold_default = [], config.fold_affine
    for _, m, fold in A_CASES:
        config.fold_affine = fold
        sources.append(codegen.apply_source(stencils.the_apply(m)))
    config.fold_affine = fold_default
    sources.append(codegen.apply_source(stencils.the_apply(step3d_cm.module)))
    cg_sources = [codegen.fused_cg_source(fused.matvec_plan(m, n)) for _, m, n, *_ in B_CASES]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=8) as pool:
        jobs = [pool.submit(builder.load, s, "stencil_apply") for s in sources]
        jobs += [pool.submit(builder.load, s, "fused_cg") for s in cg_sources]
        jobs += [pool.submit(builder.load, sweeps.source(p), "stencil_sweeps") for p in c_plans]
        jobs += [pool.submit(builder.load, codegen.chain_source(p), "stencil_chain") for p in d_plans]
        for j in jobs:
            j.result()
    say(f"phase 1 build: {len(builder.build_seconds)} libraries in "
        f"{time.perf_counter() - t0:.1f}s wall; nvcc seconds "
        + ", ".join(f"{k}={v:.1f}" for k, v in sorted(builder.build_seconds.items())))

    # ---- phase 2: kernel A against its plain version -------------------
    a_err, a_ms, a_plain_ms = 0.0, None, None
    for label, module, fold in A_CASES:
        config.fold_affine = fold
        op = stencils.the_apply(module)
        tt = op.results[0].type
        dtype = torch_backend.DTYPES[tt.element]
        n_in = op.attrs["num_inputs"]
        shape = tt.bounds.shape
        args = [
            torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)
            for _ in range(n_in)
        ] + [torch.tensor(0.1, dtype=dtype)] * (len(op.operands) - n_in)
        before = cuda_backend.counter.count
        gots = cuda_backend.try_execute_apply(op, args)
        torch.cuda.synchronize()
        launched = cuda_backend.counter.count - before
        refs = torch_backend.execute_apply(op, args)
        if len(op.results) == 1:
            gots, refs = (gots,), (refs,)
        err, ulps = 0.0, 0
        for got, ref in zip(gots, refs):
            e = (got.float() - ref.float()).abs().max().item()
            if tt.element == "float32":
                require(torch.equal(got, ref), f"{label}: kernel != plain (max err {e})")
            else:
                d = (got.view(torch.int16).int() - ref.view(torch.int16).int()).abs().max()
                ulps = max(ulps, int(d))
                require(ulps <= 1, f"{label}: kernel {ulps} bf16 ulps from plain")
            err = max(err, e)
        require(launched == 1, f"{label}: launch count rose by {launched}")
        a_err = max(a_err, err)
        k_ms, p_ms = abba(
            lambda: cuda_backend.try_execute_apply(op, args),
            lambda: torch_backend.execute_apply(op, args),
            reps=20,
        )
        dev_us = device_us(lambda: cuda_backend.try_execute_apply(op, args), 20, "nt_apply_kernel")
        cells = float(np.prod(shape))
        nbytes = (n_in + len(op.results)) * cells * gots[0].element_size()
        dev_txt = "not measured" if dev_us is None else (
            f"{dev_us:.1f} us ({cells / dev_us / 1e3:.2f} Gcell/s, {nbytes / dev_us / 1e3:.1f} GB/s)"
        )
        say(f"phase 2 stencil_apply {label}: max_abs_err={err!r} bf16_ulps={ulps} "
            f"launches+{launched}; kernel {k_ms:.4f} ms per call ({cells / k_ms / 1e6:.2f} Gcell/s, "
            f"{nbytes / k_ms / 1e6:.1f} GB/s), device time {dev_txt}; plain {p_ms:.4f} ms; "
            f"d2d copy of the same bytes {copy_gbs(int(nbytes)):.1f} GB/s")
        if label == "jacobi5 4096^2 f32":
            a_ms, a_plain_ms = k_ms, p_ms
    config.fold_affine = fold_default

    # ---- phase 3: kernel B against its plain version -------------------
    b_err, b_ms, b_plain_ms = 0.0, None, None
    for label, module, name, tol, maxiter, jacobi in B_CASES:
        n = module.lookup(name).ftype.inputs[0].bounds.shape
        stages = fused.matvec_plan(module, name)
        matvec = fused.plain_matvec(stages)
        # each solve's own rhs, so that its iterations can be held against
        # other runs of the same solve
        b = torch.from_numpy(np.random.default_rng(SEED).standard_normal(n, dtype=np.float32))
        b = b.to(dev)
        inv = None
        if jacobi:
            inv = safe_inv_diag(
                extract_diagonal(matvec, torch.zeros(n, device=dev), ((1, 1), (1, 1)))
            )
        solve = fused.fused_cg(module, name, tol=tol, maxiter=maxiter, inv_diag=inv)
        before = fused.counter.count
        x_k, it_k, rn_k = solve(b)
        torch.cuda.synchronize()
        launched = fused.counter.count - before
        x_p, it_p, rn_p = fused.fused_cg_plain(matvec, b, tol=tol, maxiter=maxiter, inv_diag=inv)
        bnorm = torch.linalg.norm(b).item()
        res_k = torch.linalg.norm(b - matvec(x_k)).item()
        res_p = torch.linalg.norm(b - matvec(x_p)).item()
        rel_x = (torch.linalg.norm(x_k - x_p) / torch.linalg.norm(x_p)).item()
        require(launched == 1, f"{label}: launch count rose by {launched}")
        require(abs(int(it_k) - int(it_p)) <= 1, f"{label}: iterations {int(it_k)} vs {int(it_p)}")
        require(res_k <= max(1.01 * tol * bnorm, 2 * res_p),
                f"{label}: true residual {res_k!r} (plain {res_p!r}, ||b|| {bnorm!r})")
        require(rel_x <= 1e-4, f"{label}: ||x_k - x_p|| / ||x_p|| = {rel_x!r}")
        err = (x_k - x_p).abs().max().item()
        b_err = max(b_err, err)
        k_ms = cuda_ms(lambda: solve(b), reps=3)
        k_dev = device_us(lambda: solve(b), 3, "nt_fused_cg_kernel")
        p_ms = cuda_ms(
            lambda: fused.fused_cg_plain(matvec, b, tol=tol, maxiter=maxiter, inv_diag=inv), reps=1
        )
        say(f"phase 3 fused_cg {label}: iters kernel {int(it_k)} plain {int(it_p)}; "
            f"recurrence resnorm {rn_k.item()!r}; true residual kernel {res_k!r} plain {res_p!r} "
            f"(tol*||b|| {tol * bnorm!r}); rel x diff {rel_x!r}; max_abs_err={err!r}; "
            f"launches+{launched}; kernel {k_ms:.3f} ms/solve ({int(it_k) / k_ms * 1e3:.0f} iters/s; "
            f"device time {'not measured' if k_dev is None else f'{k_dev / 1e3:.3f} ms'}) "
            f"plain {p_ms:.3f} ms/solve")
        if name == "poisson":
            b_ms, b_plain_ms = k_ms, p_ms

    # ---- phase 4: the main path end to end ------------------------------
    step, (u0,) = entry.entry(dev)
    step3d = step3d_cm.function("step3d")
    jac = stencils.jacobi5((4096, 4096))
    jac_cm = CompiledModule(jac, device=dev)
    jac_fn = jac_cm.opdef("jacobi")
    u3 = torch.from_numpy(rng.standard_normal((256,) * 3, dtype=np.float32)).to(dev)
    xj = torch.from_numpy(rng.standard_normal((4096, 4096), dtype=np.float32)).to(dev)
    # warm up: the first GMRES step allocates its 2 GB Krylov basis
    step(u0)
    step3d(u3)
    jac_fn(xj)
    torch.cuda.synchronize()

    cuda_backend.counter.reset()
    fused.counter.reset()
    t = time.perf_counter()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    u = u0
    for _ in range(10):
        u = step(u)
    e1.record()
    e1.synchronize()
    step_ms = e0.elapsed_time(e1) / 10
    steps_fused = fused.counter.count
    a_before_3d = cuda_backend.counter.count
    e0.record()
    v3 = step3d(u3)
    e1.record()
    e1.synchronize()
    step3d_ms = e0.elapsed_time(e1)
    a_in_3d = cuda_backend.counter.count - a_before_3d
    e0.record()
    xo = xj
    for _ in range(100):
        xo = jac_fn(xo)
    e1.record()
    e1.synchronize()
    jac_ms = e0.elapsed_time(e1) / 100
    launches = {"stencil_apply": cuda_backend.counter.count, "fused_cg": fused.counter.count}
    wall = time.perf_counter() - t

    require(tuple(u.shape) == (256, 256) and bool(torch.isfinite(u).all()), "entry output")
    require(steps_fused == 10, f"entry: fused_cg launched {steps_fused} times in 10 steps")
    require(a_in_3d > 0, "3-D GMRES step launched no stencil_apply")
    require(bool(torch.isfinite(v3).all()), "3-D step output not finite")
    require(all(v > 0 for v in launches.values()), f"main path launches {launches}")

    # the same path on the eager route (plain versions, generic CG) and on
    # the CPU: what the kernels give must agree
    plain_step = CompiledModule(heat_cm.module, backend="torch", device=dev).function("step")
    ref_u = u0
    for _ in range(10):
        ref_u = plain_step(ref_u)
    cpu_step = entry.build_step(256, "float32", device="cpu").function("step")
    cpu_u = cpu_step(u0.cpu())
    one = step(u0)
    step_rel = ((u - ref_u).abs().max() / ref_u.abs().max()).item()
    cpu_rel = ((one.cpu() - cpu_u).abs().max() / cpu_u.abs().max()).item()
    require(step_rel <= 1e-4, f"10 steps: kernel route vs eager route rel {step_rel!r}")
    require(cpu_rel <= 1e-5, f"1 step: GPU vs CPU rel {cpu_rel!r}")
    plain3d = CompiledModule(step3d_cm.module, backend="torch", device=dev).function("step3d")
    v3_ref = plain3d(u3)
    rel3 = ((v3 - v3_ref).abs().max() / v3_ref.abs().max()).item()
    require(rel3 <= 1e-6, f"3-D step: kernel route vs eager route rel {rel3!r}")
    jac_plain = CompiledModule(jac, backend="torch", device=dev).opdef("jacobi")
    xr = xj
    for _ in range(100):
        xr = jac_plain(xr)
    require(torch.equal(xo, xr), "100 Jacobi applies: kernel != plain")

    plain_step_ms = cuda_ms(lambda: plain_step(u0), reps=3)
    step_dev_ms, step_busy = busy_share(lambda: step(u0), 10)
    plain3d_ms = cuda_ms(lambda: plain3d(u3), reps=1)
    plain_jac_ms = cuda_ms(lambda: jac_plain(xj), reps=20)
    say(f"phase 4 main path: launches {json.dumps(launches)}; entry step {step_ms:.3f} ms "
        f"(eager route {plain_step_ms:.3f} ms; device {step_dev_ms:.3f} ms/step, busy share "
        f"{step_busy:.3f}), 10-step rel diff vs eager {step_rel!r}, "
        f"1-step rel diff vs CPU {cpu_rel!r}; 3-D GMRES step 256^3 {step3d_ms:.1f} ms with "
        f"{a_in_3d} stencil_apply launches (eager route {plain3d_ms:.1f} ms, rel {rel3!r}); "
        f"Jacobi 4096^2 opdef {jac_ms:.4f} ms/apply (eager {plain_jac_ms:.4f} ms, "
        f"{4096 * 4096 / jac_ms / 1e6:.2f} Gcell/s); wall {wall:.1f}s")

    # ---- phase 5: kernel C against its plain version and kernel A -------
    c_err, c_ms, c_plain_ms = 0.0, None, None
    for label, module, name, k, sc, depths in C_CASES:
        plan = sweeps.sweep_plan(module, name, k)
        shape = plan.op.results[0].type.bounds.shape
        cells = float(np.prod(shape))
        x = rand(rng, shape, dev)
        sv = [torch.tensor(v, dtype=torch.float32) for v in sc]
        before = sweeps.counter.count
        y1 = sweeps.run_sweeps(plan, x, sc)
        torch.cuda.synchronize()
        require(sweeps.counter.count - before == 1, f"{label}: one launch of kernel C")
        a1 = x
        for _ in range(plan.depth):
            a1 = cuda_backend.try_execute_apply(plan.op, [a1] + sv)
        require(torch.equal(y1, sweeps.sweeps_plain(plan, x, sc)), f"{label}: kernel C != plain")
        require(torch.equal(y1, a1), f"{label}: kernel C != {plan.depth} kernel-A launches")
        # the executor's route: k // depth launches, the rest single applies
        cm = CompiledModule(module)
        run, one = cm.sweeps(name, k), cm.opdef(name)
        before = (sweeps.counter.count, cuda_backend.counter.count)
        yk = run(x, *sc)
        torch.cuda.synchronize()
        got = (sweeps.counter.count - before[0], cuda_backend.counter.count - before[1])
        require(got == (k // plan.depth, k % plan.depth), f"{label}: launches {got}")

        def k_launches():
            u = x
            for _ in range(k):
                u = one(u, *sc)
            return u

        ak = k_launches()
        err = (yk - ak).abs().max().item()
        require(torch.equal(yk, ak) and bool(torch.isfinite(yk).all()),
                f"{label}: {k} sweeps != {k} kernel-A launches (max err {err})")
        c_err = max(c_err, err)
        plain = CompiledModule(module, backend="torch").sweeps(name, k)
        reps = 3 if cells > 3e7 else 10
        k_ms, p_ms = abba(lambda: run(x, *sc), lambda: plain(x, *sc), reps)
        a_ms = cuda_ms(k_launches, reps)
        dev_us = device_us(lambda: run(x, *sc), reps, "nt_sweeps_kernel")
        depth_txt = []
        for d in depths:
            pd = sweeps.sweep_plan(module, name, k, depth=d)

            def at_depth(pd=pd):
                u = x
                for _ in range(k // pd.depth):
                    u = sweeps.run_sweeps(pd, u, sc)
                return u

            require(torch.equal(at_depth(), ak), f"{label}: depth {d} != kernel A")
            depth_txt.append(f"depth {d} (tile {pd.tile}, {pd.smem_bytes} B smem, recompute "
                             f"{pd.recompute:.2f}) {cuda_ms(at_depth, reps):.4f} ms")
        dev_txt = "not measured" if dev_us is None else f"{dev_us:.1f} us"
        say(f"phase 5 stencil_sweeps {label}: depth {plan.depth} x{k // plan.depth} launches "
            f"(tile {plan.tile}, {plan.smem_bytes} B smem, recompute {plan.recompute:.2f}), "
            f"bitwise = plain = {k} kernel-A launches; kernel {k_ms:.4f} ms per call "
            f"({k_ms * 1e3 / k:.2f} us per sweep, {8 * cells * k / k_ms / 1e6:.1f} GB/s effective; "
            f"d2d copy {copy_gbs(int(8 * cells)):.1f} GB/s), device {dev_txt}; "
            f"plain {p_ms:.4f} ms; {k} kernel-A launches {a_ms:.4f} ms"
            + ("; " + "; ".join(depth_txt) if depth_txt else ""))
        if label == "jacobi5 4096^2 K=16":
            c_ms, c_plain_ms = k_ms, p_ms

    # ---- phase 6: kernel D against the stages one at a time -------------
    d_err, d_ms, d_plain_ms = 0.0, None, None
    for label, module, name, n_fields, sc in D_CASES:
        plan = chain.chain_plan(module, name)
        shape = plan.outer.shape
        cells = float(np.prod(shape))
        fields = [rand(rng, shape, dev) for _ in range(n_fields)]
        sv = [torch.tensor(v, dtype=torch.float32) for v in sc]
        cm = CompiledModule(module)
        run = cm.opdef(name)
        stages = cm._make_callable(module.lookup(name))
        before = (chain.counter.count, cuda_backend.counter.count)
        y = run(*fields, *sc)
        torch.cuda.synchronize()
        got = (chain.counter.count - before[0], cuda_backend.counter.count - before[1])
        require(got == (1, 0), f"{label}: launches (stencil_chain, stencil_apply) {got}")
        before = cuda_backend.counter.count
        per_stage = stages(*fields, *sc)
        require(cuda_backend.counter.count - before == len(plan.stages),
                f"{label}: the per-stage route launched kernel A "
                f"{cuda_backend.counter.count - before} times")
        err = (y - per_stage).abs().max().item()
        require(torch.equal(y, chain.chain_plain(plan, fields, sv)), f"{label}: kernel D != plain")
        require(torch.equal(y, per_stage) and bool(torch.isfinite(y).all()),
                f"{label}: kernel D != per-stage kernel A (max err {err})")
        d_err = max(d_err, err)
        reps = 5 if cells > 3e7 else 20
        k_ms, p_ms = abba(lambda: run(*fields, *sc), lambda: chain.chain_plain(plan, fields, sv), reps)
        a_ms = cuda_ms(lambda: stages(*fields, *sc), reps)
        dev_us = device_us(lambda: run(*fields, *sc), reps, "nt_chain_kernel")
        nbytes = (n_fields + 1) * 4 * cells
        dev_txt = "not measured" if dev_us is None else (
            f"{dev_us:.1f} us ({nbytes / dev_us / 1e3:.1f} GB/s)")
        say(f"phase 6 stencil_chain {label}: {len(plan.stages)} stages in 1 launch (tile "
            f"{plan.tile}, reach {plan.reach}, {plan.n_buffers} buffers, {plan.smem_bytes} B smem), "
            f"bitwise = plain = per-stage kernel A; kernel {k_ms:.4f} ms per call, device "
            f"{dev_txt}; d2d copy of (fields + result) {copy_gbs(int(nbytes)):.1f} GB/s; "
            f"plain {p_ms:.4f} ms; per-stage kernel A {a_ms:.4f} ms")
        if label == "composite 4096^2":
            d_ms, d_plain_ms = k_ms, p_ms

    # ---- phase 7: the DSL path end to end --------------------------------
    inputs = [
        [rand(rng, cm.module.lookup(name).ftype.inputs[0].bounds.shape, dev)]
        for _, cm, name, _, _ in rows
    ]
    for (_, _, _, _, fn), args in zip(rows, inputs):  # warm up
        fn(*args)
    torch.cuda.synchronize()
    for c in counters().values():
        c.reset()
    outs, per_row = [], []
    for (_, _, _, _, fn), args in zip(rows, inputs):
        before = {n: c.count for n, c in counters().items()}
        outs.append(fn(*args))
        torch.cuda.synchronize()
        per_row.append({n: c.count - before[n] for n, c in counters().items()})
    dsl_launches = {n: c.count for n, c in counters().items()}
    for (label, cm, name, k, fn), args, out, got in zip(rows, inputs, outs, per_row):
        if k is None:
            want = {"stencil_chain": 1, "stencil_apply": 0}
            route = cm._make_callable(cm.module.lookup(name))
        else:
            plan = sweeps.sweep_plan(cm.module, name, k)
            want = {"stencil_sweeps": k // plan.depth, "stencil_apply": k % plan.depth}
            one = cm.opdef(name)

            def route(u, one=one, k=k):
                for _ in range(k):
                    u = one(u)
                return u

        require(all(got[n] == v for n, v in want.items()), f"{label}: launches {got}, plan {want}")
        require(torch.equal(out, route(*args)) and bool(torch.isfinite(out).all()),
                f"{label}: the DSL route != the per-stage route")
        reps = 3 if args[0].numel() > 3e7 else 10
        r_ms, s_ms = abba(lambda: fn(*args), lambda: route(*args), reps)
        say(f"phase 7 DSL {label}: launches {json.dumps({n: v for n, v in got.items() if v})}; "
            f"{r_ms:.4f} ms per call, per-stage route {s_ms:.4f} ms, bitwise equal")
    require(dsl_launches["stencil_sweeps"] > 0 and dsl_launches["stencil_chain"] > 0,
            f"DSL path launches {dsl_launches}")
    say(f"phase 7 DSL path launches: {json.dumps(dsl_launches)}")

    kernels = [
        {
            "name": "stencil_apply", "route": "cuda",
            "source": "neptune_tpu_torch/csrc/nt_apply.cuh",
            "replaces": "neptune_tpu/lowering/pallas_backend.py:332",
            "also_replaces": ["neptune_tpu/lowering/pallas_backend.py:845",
                              "neptune_tpu/lowering/pallas_backend.py:1094"],
            "launches": launches["stencil_apply"], "max_abs_err": a_err,
            "ms": a_ms, "plain_ms": a_plain_ms, "shape": "jacobi5 4096^2 f32",
        },
        {
            "name": "fused_cg", "route": "cuda",
            "source": "neptune_tpu_torch/csrc/nt_fused_cg.cuh",
            "replaces": "neptune_tpu/solvers/fused.py:201",
            "launches": launches["fused_cg"], "max_abs_err": b_err,
            "ms": b_ms, "plain_ms": b_plain_ms, "shape": "poisson 512^2 jacobi tol 1e-4",
        },
        {
            "name": "stencil_sweeps", "route": "cuda",
            "source": "neptune_tpu_torch/csrc/nt_sweeps.cuh",
            "replaces": "neptune_tpu/lowering/pallas_multisweep.py:406",
            "also_replaces": ["neptune_tpu/lowering/pallas_multisweep.py:676",
                              "neptune_tpu/lowering/pallas_multisweep.py:904"],
            "launches": dsl_launches["stencil_sweeps"], "max_abs_err": c_err,
            "ms": c_ms, "plain_ms": c_plain_ms, "shape": "jacobi5 4096^2 f32, 16 sweeps",
        },
        {
            "name": "stencil_chain", "route": "cuda",
            "source": "neptune_tpu_torch/csrc/nt_chain.cuh",
            "replaces": "neptune_tpu/lowering/pallas_chain.py:516",
            "launches": dsl_launches["stencil_chain"], "max_abs_err": d_err,
            "ms": d_ms, "plain_ms": d_plain_ms, "shape": "u + 0.01 lap(lap u) 4096^2 f32",
        },
    ]
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
