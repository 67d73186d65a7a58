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

Phases (one or more lines each, then the total time, the kernels' JSON
line, the card's nvidia-smi line, and the result line):
  1. device and build: versions, nvcc seconds per library;
  2. kernel A (stencil_apply) against its plain version: f32 bitwise, bf16
     within one bf16 ulp, f64 bitwise (HPCG's 27-point operator at 322^3
     and 42^3, and its symgs colour pass at 322^3, out of place and in
     kernel A's colour form, in place);
  3. kernel B (fused_cg) against its plain version, both lifting the ring
     that the solve site finds (the composite case has none): iterations
     within 1, true residual, solution within 1e-4; per solve its time, time
     per iteration, tiling, and the barrier floor at its grid size;
     then (3b) generic CG's four vector kernels (cg_vectors) against their
     plain versions at 322^3 (HPCG's size) and 34^3 f64, with and without
     a preconditioner: x, r and p bitwise, the dot products within n eps
     sum|a b|, one launch each (no timing; scripts/torch_kernel_times.py
     --kernels V times them);
  4. the first main path end to end, with launch counts, against plain runs;
  5. kernel C (stencil_sweeps) against its plain version and against the
     same sweeps as kernel-A launches, bitwise, with launch counts and
     times at other depths per launch;
  6. kernel D (stencil_chain) against the stages run one at a time, by the
     plain version and by kernel A, bitwise, with each case's plan (tile,
     strips, loads, interior tiles, blocks per SM), times and host time per
     launch;
  7. the DSL path end to end: bench.py's K-sweep and composite rows built
     with `neptune_tpu_torch`'s decorators, with launch counts, against the
     per-stage route;
  8. the sharded path on a mesh of one process (`neptune_tpu_torch.parallel`):
     first the shard-local kernel forms (kernel A's window form, kernel C's
     local form, kernel D's origin form) against their plain versions on a
     block at a global start that is not 0, bitwise; then the JAX package's
     `shardmap_*` benchmark rows, each bitwise against the same route with
     the kernels off and against the whole-grid route, with launch counts
     and times;
  9. four processes on the one card, joined by gloo (NCCL refuses two
     processes on one GPU): the sharded routes on (2,2) and (4,1) meshes
     and a sharded GMRES solve, gathered and held against the one-process
     whole-grid result;
 10. the solver surface at full size: (a) fully implicit Allen–Cahn at
     4096^2 f32 (Newton–Krylov through the DSL's time_advance, the residual
     on kernel A, J v through the opdefs' derivative rule), with and
     without jacobian=, Newton and Krylov iterations held to the
     kernels-off route, ms per step and per Newton iteration, the device
     split of a step; (b) the rule's tangent and cotangent against the
     eager view, and a differentiable_root gradient against the
     kernels-off route; (c) bench.py's cg_poisson_512_mixed_1e10 (f32
     twin on kernel A, true f64 residual <= 1e-10); (d) its
     cg_512_ssor_vs_jacobi (SSOR fewer iterations than Jacobi);
 11. geometric multigrid and Chebyshev at full size, each case on the
     kernel route and the kernels-off route (equal iterations, bitwise-equal
     solutions, true residual under tol, kernel A launched on every level,
     counted per level shape): (a) CG + precond="mg" on phase 3's 512^2
     Poisson system through the IR executor (Jacobi and Chebyshev
     smoothing) and the DSL, beside kernel B's Jacobi-CG; (b) the same at
     4096^2 with its host/device split and launches per iteration by kind;
     (c) multigrid_solve with red-black smoothing on
     examples/multigrid_poisson.py's 512..16 hierarchy from a zero start
     and from fmg_start; (d) 7-pt 256^3 with precond="mg"; (e)
     solver="chebyshev" with Jacobi, check_every=10 and estimated bounds.
 12. the communication-avoiding solvers and sharded_function on bench.py's
     256^2 f32 CA system: (a) cg_sharded (s=8), gmres_sharded (s=8), both
     with the Chebyshev basis, bicgstab_sharded (s=2) and
     chebyshev_sharded (k_fuse=8, 1201 iterations) on a one-process mesh, each on the
     kernel route against the kernels-off route (equal iterations,
     bitwise-equal x, kernel A's window form launched), with ms per solve
     and iterations/s beside its per-iteration counterpart on the same
     mesh, and the host's coefficient space per block against the dense
     factors on the card; (b) the same four on a (2,2) mesh of phase 9's
     four processes, gathered and held to (a), with ring shifts, bytes and
     reductions per outer block; sharded_function of the 3-D GMRES step
     (256^3, (4,1)) and the 2-D CG heat step (256^2, (2,2)) against the
     one-process function.
 13. multigrid, Chebyshev and Newton over a process mesh, through
     sharded_function on a mesh of one process: (a) phase 11a's 512^2 and
     11b's 4096^2 precond="mg" systems, kernel route against kernels-off
     route (equal iterations, bitwise-equal x) and against phase 11's
     whole-grid iterations (within 1), kernel A's window form on every
     level; (b) build_ca_levels(k=2) on 11c's hierarchy, multigrid_solve
     with the CA smoothers against per-matvec "cheb" smoothing over the same
     matvecs (equal V-cycles, x within 1e-5 relative, fewer ring shifts);
     (c) 11e's Chebyshev + Jacobi; (d) 10a's Allen-Cahn step with and
     without jacobian= (Newton and GMRES iterations of the whole grid, state
     within 1e-5 relative); (e) (a) at 512^2, (b), and (d) at 1024^2 in
     phase 9's four processes on (2,2), held to the one-process runs, with
     ring shifts, bytes and reductions per PCG iteration.
 14. the rest of sharded_function, reverse mode and the dry run, each case
     on the kernel route against the whole grid and the kernels-off route
     (on (2,2), (a) and (b) on the kernel route only): (a) SSOR-CG 512^2;
     (b) mixed refinement (to the end at 512^2 on one process and at 32^2
     on (2,2), one round capped at P14_MIXED_CAP inner iterations at 512^2
     on each, kernel route); (c) 64^2 f64 dense SSOR and direct; (d) a
     512^2 differentiable_solve gradient, one process and (2,2); (e)
     dryrun_multichip(4) on the card.
 15. (a) precond="mg" where the blocks turn odd above the coarsest level:
     1800^2 f32 CG + precond="mg" (levels 1800..225) in phase 9's four
     processes, on (2,2) (whole grid from level 2) and (4,1) (from level
     1), kernel route against kernels-off route (equal iterations,
     bitwise-equal x) and against the one-process whole grid (iterations
     within 1, x within 1e-5 relative), kernel A's window form on the
     sharded levels and kernel A on the replicated ones, with ms, gathers
     and ring shifts per PCG iteration; (b) SimulationDriver over entry()'s
     implicit heat step, 40 steps with a checkpoint every 10, a run stopped
     by its walltime budget and resumed bitwise the uninterrupted one, one
     kernel-B launch per step; (c) bench.py's f64_*_vs_native rows, the
     port in f64 on the card against its native C++ runtime, and the 5-pt
     Jacobi 1024^2 f32 apply on kernel A against the native f64 apply;
     (d) profiling.trace around two driver steps (kernel B and an annotate
     span in the trace), and neptune-opt-torch --run (the in-process
     checksum) and --plan 2x2 (kernel A named), each in a process of its
     own (chip_smoke.py --phase15-trace DIR runs the first).
 16. pinned arithmetic (config.pinned_arithmetic) on the card: (a)
     tests/test_scale_stability.py's 256^2 f64 Poisson CG to 1e-8 over
     sharded_opdef with the mesh's layout, on the whole grid, a mesh of one
     process, and (2,2) and (4,1) in phase 9's four processes: equal
     iterations and bitwise-equal x everywhere, the default-arithmetic
     solves (whole grid, one process, (2,2)) and their max |diff| beside
     them; (b) its f32 adv4 operator at
     4096^2, 50 applies, bitwise on the same meshes and on the kernel route
     against the kernels-off route, kernel A's forms counted; (c) the cost:
     1024^2 f32 Poisson CG, 300 iterations, ms per iteration default
     against pinned, CUDA kernels per dot product, and 16a's gathers and ms
     per iteration on (2,2);
 17. random programs (tests/torch_fuzz_programs.py) through kernels A, C
     and D at working sizes, half in pinned arithmetic, each built in
     parallel and held bitwise against eager PyTorch (within 2 ulps where
     its body has tanh), with the number of programs and nvcc seconds.
 18. the port's programs of examples/ (neptune_tpu_torch/examples/), each
     in a process of its own (chip_smoke.py --phase18-example NAME PROCS
     ROUTES OUT), P18_WORKERS host processes at a time: all fourteen on the kernel route
     and then on the kernels-off route, each in a fresh context
     (navier_stokes, inverse_problem and black_scholes at a quarter or less
     of their steps, P18_MAIN_KWARGS; their own checks; results bitwise
     equal; the kernels of the TPU-kernel table launched; wall seconds on
     the card),
     the five whose opdefs name no dtype again with NEPTUNE_TORCH_DTYPE=
     float32 (main(), or where main() asserts an f64 tolerance the
     program's functions, with the residual reached), and multichip_poisson
     and comm_avoiding_jacobi on (2,2) in four processes sharing the card
     over gloo, held to the one-process run.

The kernels' JSON line gives, for each kernel, its time and its plain
version's at the main path's shape, the least time the card could take
(bound_ms: the larger of the bytes moved over 3.35 TB/s and the operations
over 67 TFLOP/s, f32 outside the tensor cores, or 34 TFLOP/s in f64), and
the time of one PyTorch call that computes the same function where there
is one. Kernel A's f64 row (stencil_apply_f64) is phase 2's HPCG apply at
322^3, its launches phase 2's f64 ones. Kernel
A's launches are phase 4's, phase 11's, phase 15's (15a rank 0's
replicated levels, 15c), phase 16's (16b, 16c) and phase 18's; its window
form's phase 8's, 12a's, 13a's, 14's, 15a rank 0's, 16b's (one process and
rank 0) and 18's; kernel B's phase 4's, 15b's and 18's; kernels C and D and
their local forms add phase 18's kernel routes. Phase 17's launches compare
kernels with their plain versions and are not counted.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0

# the H100 SXM's published peaks (NVIDIA's data sheet): device memory rate
# and f32 and f64 rates outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
# the phase-2 case of the kernels line's f64 row
A_F64_LABEL = "hpcg27 322^3 f64"


# kernel B's systems, (label, system, opdef, tol, maxiter, Jacobi): the entry
# step's and bench.py's cg_poisson_256 and cg_poisson_512 rows, whose
# operators copy a Dirichlet ring through (the site lifts it), and a
# composite of two Laplacians, which has no ring; phase 3 and
# scripts/torch_kernel_times.py solve these
B_SYSTEMS = [
    ("heat_A 256^2 tol 1e-6", "heat_A 256", "heat_A", 1e-6, 200, False),
    ("poisson 256^2 jacobi tol 1e-4", "poisson 256", "poisson", 1e-4, 3500, True),
    ("poisson 512^2 jacobi tol 1e-4", "poisson 512", "poisson", 1e-4, 5500, True),
    ("lap_lap 256^2 tol 1e-5", "composite 256", "wrapped", 1e-5, 2000, False),
]


def b_system(system: str):
    """The module of a B_SYSTEMS system, built by the neptune_tpu_torch
    package that comes first on sys.path."""
    from neptune_tpu_torch import entry, stencils

    kind, n = system.split()
    if kind == "heat_A":
        return entry.build_step(int(n), "float32").module
    if kind == "composite":
        return stencils.composite((int(n), int(n)))
    return stencils.poisson5(int(n))


def a_cases():
    """Kernel A's phase-2 cases, built by the neptune_tpu_torch package that
    comes first on sys.path: (label, module, affine folding, the value of
    each scalar); "adv4 4096^2 f32 unfolded" runs every body op by op. The
    f64 cases are HPCG's solve (portbench's hpcg320_mgcg_f64): its 27-point
    operator on the finest grid and the coarsest, and the symgs colour pass
    on the finest (x, b and 1/diag in, colour 5 relaxed)."""
    from neptune_tpu_torch import stencils
    from neptune_tpu_torch.passes.smoother import colour_pass

    return [
        ("jacobi5 1024^2 f32", stencils.jacobi5((1024, 1024)), True, 0.1),
        ("jacobi5 4096^2 f32", stencils.jacobi5((4096, 4096)), True, 0.1),
        ("jacobi5 4096^2 bf16", stencils.jacobi5((4096, 4096), "bfloat16"), True, 0.1),
        ("heat7 256^3 f32", stencils.heat7((256, 256, 256)), True, 0.1),
        ("heat7 256^3 bf16", stencils.heat7((256, 256, 256), "bfloat16"), True, 0.1),
        ("heat7 periodic 256^3 f32", stencils.heat7((256, 256, 256), periodic=True), True, 0.1),
        ("adv4 4096^2 f32 (h0=2)", stencils.advection4((4096, 4096)), True, 0.1),
        ("adv4 4096^2 bf16 (h0=2)", stencils.advection4((4096, 4096), "bfloat16"), True, 0.1),
        ("adv4 periodic 4096^2 f32", stencils.advection4((4096, 4096), periodic=True), True, 0.1),
        ("u+dt*k 4096^2 f32", stencils.combination((4096, 4096)), True, 0.1),
        ("two-result gradients 4096^2 f32", stencils.gradients((4096, 4096)), True, 0.1),
        ("adv4 4096^2 f32 unfolded", stencils.advection4((4096, 4096)), False, 0.1),
        (A_F64_LABEL, stencils.hpcg27((322, 322, 322)), True, 0.1),
        ("hpcg27 symgs colour pass 322^3 f64",
         colour_pass(stencils.hpcg27((322, 322, 322)), "hpcg27"), True, 5.0),
        ("hpcg27 42^3 f64 (coarsest level)", stencils.hpcg27((42, 42, 42)), True, 0.1),
    ]


def phase3_cg_vectors(dev) -> None:
    """Phase 3b: generic CG's four vector kernels against their plain
    versions on f64 grids of HPCG's size, 322^3 (a grid of the resident
    blocks, each thread over many groups of packs, the last block's sum
    over the partials in several strides), and 34^3 (one group a thread),
    each step from the same slots, with and without a preconditioner
    (without one the update takes dot_beta's scalar steps and dot_beta is
    not launched)."""
    import torch

    from neptune_tpu_torch.solvers import cg_vectors as cv

    worst = 0.0
    for n in (322, 34):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        x, p, r, ap, z = (torch.randn((n,) * 3, dtype=torch.float64, device=dev, generator=gen)
                          for _ in range(5))
        rz = torch.sum(r * z)
        far = torch.full((), 1e300, dtype=torch.float64, device=dev)
        for plain in (False, True):
            sk, sp = (cv.Scalars(x, rz, torch.sqrt(rz), 0 * rz, far) for _ in range(2))
            xk, rk, pk, xp, rp, pp = (v.clone() for v in (x, r, p, x, r, p))
            before = cv.counter.count
            dots = []
            cv.dot_alpha(p, ap, sk)
            cv.dot_alpha_plain(p, ap, sp)
            dots.append((cv.PAP, p, ap))
            sp.buf.copy_(sk.buf)
            cv.update(xk, p, rk, ap, sk, plain)
            cv.update_plain(xp, p, rp, ap, sp, plain)
            require(torch.equal(xk, xp) and torch.equal(rk, rp), f"phase 3b {n}^3: update != plain")
            dots.append((cv.RR, rk, rk))
            zz = rk if plain else z
            if not plain:
                cv.dot_beta(rk, z, sk)
                dots.append((cv.RZ, rk, z))
            sp.buf.copy_(sk.buf)
            cv.direction(pk, zz, sk)
            cv.direction_plain(pp, zz, sp)
            torch.cuda.synchronize()
            require(torch.equal(pk, pp), f"phase 3b {n}^3: direction != plain")
            require(cv.counter.count - before == (3 if plain else 4),
                    f"phase 3b {n}^3: {cv.counter.count - before} launches")
            for slot, a, b in dots:
                prods = (a * b).double()
                err = abs(sk.buf[slot].item() - prods.sum().item()) / prods.abs().sum().item()
                require(err <= a.numel() * 2.0**-52, f"phase 3b {n}^3: slot {slot} off by {err!r}")
                worst = max(worst, err)
            del sk, sp, xk, rk, pk, xp, rp, pp, dots
        del x, p, r, ap, z
    say(f"phase 3b cg_vectors 322^3 and 34^3 f64: x, r, p bitwise the plain versions', with "
        f"and without M; dot products within {worst!r} of sum|a b| (limit n eps); 4 and 3 "
        f"launches")


def phase2_colour_form(op, args) -> None:
    """Kernel A's colour form of a symgs colour pass (`args`: x, b, 1/diag,
    the colour), in place, against the out-of-place pass bitwise, with its
    launch count, times and bound."""
    import torch
    from neptune_tpu_torch.lowering import cuda_backend

    x, ins, sv = args[0], args[1:3], [float(a) for a in args[3:]]
    want = cuda_backend.try_execute_apply(op, args)
    got = x.clone()
    torch.cuda.synchronize()
    before = cuda_backend.counter.count
    cuda_backend.apply_colour(op, got, ins, sv)
    torch.cuda.synchronize()
    launched = cuda_backend.counter.count - before
    require(torch.equal(got, want), "colour form != the out-of-place colour pass")
    require(launched == 1, f"colour form: launch count rose by {launched}")
    k_ms, o_ms = abba(lambda: cuda_backend.apply_colour(op, got, ins, sv),
                      lambda: cuda_backend.try_execute_apply(op, args), reps=20)
    dev_us = device_us(lambda: cuda_backend.apply_colour(op, got, ins, sv), 20, "nt_apply")
    sizes = cuda_backend.colour_sizes(op, int(sv[-1]))
    b_ms = sizes["cells"] * sizes["grids"] * sizes["itemsize"] / HBM_BYTES_PER_S * 1e3
    say(f"phase 2 stencil_apply colour form, in place, colour {int(sv[-1])}: bitwise the "
        f"out-of-place pass, launches+{launched}; {k_ms:.4f} ms per call against {o_ms:.4f} ms "
        f"out of place; device time "
        f"{'not measured' if dev_us is None else f'{dev_us:.1f} us'}; bound {b_ms:.4f} ms "
        f"(bytes: {sizes['cells']} cells x {sizes['grids']} grids); plan "
        f"{cuda_backend.colour_plan(op)}")


def a_args(op, scalar: float, rng, dev) -> list:
    """A phase-2 case's arguments: standard normal inputs drawn in f32 (in
    f64 for an f64 apply) on dev, then each scalar `scalar`."""
    import torch
    from neptune_tpu_torch.lowering import torch_backend

    tt = op.results[0].type
    dtype = torch_backend.DTYPES[tt.element]
    draw = np.float64 if dtype == torch.float64 else np.float32
    n_in = op.attrs["num_inputs"]
    return [
        torch.from_numpy(rng.standard_normal(tt.bounds.shape, dtype=draw)).to(dev, dtype)
        for _ in range(n_in)
    ] + [torch.tensor(scalar, dtype=dtype)] * (len(op.operands) - n_in)


def c_cases():
    """Kernel C's phase-5 cases: (label, module, opdef, k, scalars, other
    depths per launch to time)."""
    from neptune_tpu_torch import stencils

    return [
        ("jacobi5 1024^2 K=16", stencils.jacobi5((1024, 1024)), "jacobi", 16, (), ()),
        ("jacobi5 4096^2 K=16", stencils.jacobi5((4096, 4096)), "jacobi", 16, (), (8,)),
        ("heat7 256^3 K=8", stencils.heat7((256, 256, 256)), "heat", 8, (), (4,)),
        ("adv4 8192^2 K=16 (h0=2)", stencils.advection4((8192, 8192)), "adv4", 16, (), (4,)),
        ("adv4 periodic 4096^2 K=16", stencils.advection4((4096, 4096), periodic=True),
         "adv4", 16, (), ()),
        ("relax w=0.8 4096^2 K=16", stencils.damped_jacobi((4096, 4096)), "relax", 16, (0.8,), ()),
    ]


def d_cases():
    """Kernel D's phase-6 cases: (label, module, opdef, fields, scalars)."""
    from neptune_tpu_torch import stencils

    return [
        ("composite 1024^2", stencils.composite((1024, 1024)), "wrapped", 1, ()),
        ("composite 4096^2", stencils.composite((4096, 4096)), "wrapped", 1, ()),
        ("mixed periodic/bounded 4096^2", stencils.composite((4096, 4096), mixed=True),
         "wrapped", 1, ()),
        ("two fields + scalars 4096^2", stencils.coupled((4096, 4096)), "couple", 2, (0.7, -1.3)),
        ("composite 256^3", stencils.composite((256, 256, 256)), "wrapped", 1, ()),
    ]


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
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
    total = sum(e.device_time_total for e in rows)
    # per launch the trace recorded: a long run's last record can be missing
    return total / sum(e.count for e in rows) if total > 0 else None


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


def op_profile(fn, reps: int) -> tuple[float, float, float]:
    """(host wall ms per call, device ms per call, device operations per
    call) of fn(), from a torch.profiler trace of `reps` calls: what a
    host-bound call spends beside its device work, and on how many
    launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return (wall_ms / reps, sum(e.device_time_total for e in dev) / reps / 1e3,
            sum(e.count for e in dev) / reps)


def host_ms(fn, reps: int, sync) -> tuple[float, float, float]:
    """(median, min, max) host milliseconds of single calls of fn(), each
    synchronised, after one warm-up call."""
    fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), min(times), max(times)


def copy_gbs(nbytes: int, reps: int = 20) -> float:
    """A same-moment device-to-device copy moving `nbytes` (read + write)."""
    import torch

    src = torch.empty(max(nbytes // 8, 1), dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src), reps)
    return 2 * src.numel() * 4 / ms / 1e6


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """(least milliseconds the card could take, what bounds it): each input
    byte read once and each output byte written once over the memory rate,
    against the operations over the f32 rate (or `ops_per_s`)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def impulse_weight(apply_at, rank: int, reach: int, start):
    """The coefficients of a linear constant-coefficient stencil, as a
    convolution weight: apply_at(block, start) on a unit impulse at the
    centre of a (4 reach + 1)^rank block whose cells all compute; None when
    the stencil is not linear (its response to 0 is not 0)."""
    import torch

    n = 4 * reach + 1
    delta = torch.zeros((n,) * rank, dtype=torch.float32)
    if bool(apply_at(delta, start).abs().max() > 0):
        return None
    delta[(2 * reach,) * rank] = 1.0
    y = apply_at(delta, start)
    # y[p - o] = c_o; a convolution reads w[k] at x[i + k - reach]
    w = torch.flip(y[(slice(reach, 3 * reach + 1),) * rank], dims=tuple(range(rank)))
    return w.float()


def conv_call(w, x):
    """One PyTorch convolution computing a stencil's interior."""
    import torch.nn.functional as F

    conv = F.conv2d if x.dim() == 2 else F.conv3d
    return lambda: conv(x[None, None], w.to(x.device, x.dtype)[None, None])


def _library(w, x, got, reach: int):
    """(ms, text) of the convolution with weight w on x, after checking
    that it computes got's interior (cells `reach` in from the edge)."""
    import torch

    call = conv_call(w, x)
    lib = call()[0, 0]
    inner = got[(slice(reach, -reach),) * got.dim()].float()
    rel = ((lib.float() - inner).abs().max() / inner.abs().max()).item()
    require(rel <= (1e-5 if x.dtype == torch.float32 else 3e-2),
            f"library convolution differs from the kernel by {rel!r}")
    ms = cuda_ms(call, 20)
    return ms, f"{ms:.4f} ms (conv{x.dim()}d {tuple(w.shape)}, interior rel diff {rel:.1e})"


def library_for_apply(op, args, got):
    """One PyTorch convolution computing a single-input, linear,
    constant-coefficient bounded f32 or bf16 apply's interior: (ms, text),
    or (None, "none")."""
    from neptune_tpu_torch.lowering import torch_backend

    n_in = op.attrs.get("num_inputs", len(op.operands))
    if n_in != 1 or len(op.operands) != 1 or len(op.results) != 1 or op.attrs.get("periodic"):
        return None, "none"
    if op.results[0].type.element == "float64":
        return None, "none (f64)"
    rank = op.results[0].type.bounds.rank
    reach = max(max(h) for h in op.attrs["shape"].halo())
    w = impulse_weight(
        lambda d, st: torch_backend.execute_apply_window(op, [d], [], st),
        rank, reach, op.attrs["bounds"].lb,
    )
    if w is None:
        return None, "none"
    return _library(w, args[0], got, reach)


def library_for_chain(plan, fields, got):
    """The same for a one-field linear chain (its composed stencil)."""
    from neptune_tpu_torch.lowering import chain

    reach = max(plan.reach)
    start = [lo + reach for lo in plan.outer.lb]
    w = impulse_weight(
        lambda d, st: chain.chain_plain(plan, [d], [], global_start=st), plan.rank, reach, start
    )
    if w is None:
        return None, "none"
    return _library(w, fields[0], got, reach)


def a_plan_text(op) -> str:
    """Kernel A's plan for an apply: tile, cells per thread, shared memory."""
    from neptune_tpu_torch.lowering import cuda_backend

    p = cuda_backend.apply_plan(op)
    if p is None:
        return "first design (one cell per thread)"
    return (f"tile {p.tile} x {p.planes} planes, {p.strip} cells per thread, "
            f"{p.threads} threads, {p.smem_bytes} B smem")


def c_plan_text(plan) -> str:
    """Kernel C's plan: depth, tile, cells per thread, shared memory."""
    return (f"depth {plan.depth}, tile {plan.tile}, {plan.strip} x {plan.cols} cells per thread, "
            f"{plan.warps} warps, {plan.smem_bytes} B smem, recompute {plan.recompute:.2f}")


def d_plan_text(plan, global_start=None, device: int = 0) -> str:
    """Kernel D's plan: tile, threads, strips, loads, interior share of the
    tiles, blocks per SM, shared memory."""
    from neptune_tpu_torch.lowering import chain

    n = (1,) * (3 - plan.rank) + tuple(plan.shape)
    tiles = [-(-m // t) for m, t in zip(n, plan.tile3)]
    boxes = chain.stage_boxes(plan, plan.shape, global_start)
    inner = sum(
        chain.tile_interior(plan, (a * plan.tile3[0], b * plan.tile3[1], c * plan.tile3[2]), n,
                            boxes)[0]
        for a in range(tiles[0]) for b in range(tiles[1]) for c in range(tiles[2]))
    loads = "16-byte" if n[2] % chain.VEC == 0 else "4-byte"
    walk = (f"persistent, {plan.ahead} tile(s) ahead in flight" if plan.ahead
            else "one tile per block")
    return (f"tile {plan.tile} + halo {plan.halo[3 - plan.rank:]}, {plan.threads} threads, {walk}, "
            f"strips {plan.strips}, {loads} loads, {inner}/{int(np.prod(tiles))} tiles interior, "
            f"{chain.blocks_per_sm(plan, device)} blocks per SM, {plan.smem_bytes} B smem")


def rand(rng, shape, dev):
    import torch

    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)


def counters():
    from neptune_tpu_torch.lowering import chain, cuda_backend, sweeps
    from neptune_tpu_torch.solvers import fused

    return {c.name: c for c in (
        cuda_backend.counter, fused.counter, sweeps.counter, chain.counter,
        cuda_backend.window_counter, sweeps.local_counter, chain.origin_counter,
    )}


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



def sharded_rows():
    """The JAX package's `shardmap_*` rows (bench.py, benchmarks/results.json)
    at their full sizes: (row, module, opdef, sweeps per call or None, the
    local form the row must launch)."""
    from neptune_tpu_torch import stencils

    return [
        ("shardmap_fused_1dev_4096", stencils.jacobi5((4096, 4096)), "jacobi", None,
         "stencil_apply_window"),
        ("shardmap_fused_1dev_4096_bf16", stencils.jacobi5((4096, 4096), "bfloat16"), "jacobi",
         None, "stencil_apply_window"),
        ("shardmap_fused_1dev_heat3d_256", stencils.heat7((256, 256, 256)), "heat", None,
         "stencil_apply_window"),
        ("shardmap_sweeps_k8_1dev_4096", stencils.jacobi5((4096, 4096)), "jacobi", 8,
         "stencil_sweeps_local"),
        ("shardmap_composite_1dev_1024", stencils.composite((1024, 1024)), "wrapped", None,
         "stencil_chain_origin"),
        ("shardmap_composite_1dev_4096", stencils.composite((4096, 4096)), "wrapped", None,
         "stencil_chain_origin"),
        ("shardmap_dma_1dev_adv4_4096", stencils.advection4((4096, 4096)), "adv4", None,
         "stencil_apply_window"),
        ("advection4_8192_twolevel_sharded_k16", stencils.advection4((8192, 8192)), "adv4", 16,
         "stencil_sweeps_local"),
    ]


# phase 9: (label, builder of the module, opdef, mesh, sweeps per call or
# None, the local form each rank must launch, or None for the eager route)
PHASE9 = [
    ("5-pt 4096^2 on (2,2)", "jacobi5", "jacobi", (2, 2), None, "stencil_apply_window"),
    ("7-pt 256^3 on (4,1)", "heat7", "heat", (4, 1), None, "stencil_apply_window"),
    ("K=8 sweeps 4096^2 on (2,2)", "jacobi5", "jacobi", (2, 2), 8, "stencil_sweeps_local"),
    ("composite 4096^2 on (2,2)", "composite", "wrapped", (2, 2), None, "stencil_chain_origin"),
    ("periodic adv4 4096^2 on (2,2)", "adv4_periodic", "adv4", (2, 2), None, None),
]


# single calls timed per phase-9 case, on each rank's host clock
PHASE9_REPS = 5


def phase9_module(kind: str, n: int, m: int):
    from neptune_tpu_torch import stencils

    return {
        "jacobi5": lambda: stencils.jacobi5((n, n)),
        "heat7": lambda: stencils.heat7((m, m, m)),
        "composite": lambda: stencils.composite((n, n)),
        "adv4_periodic": lambda: stencils.advection4((n, n), periodic=True),
    }[kind]()


def phase9_rank(argv) -> int:
    """One of phase 9's four processes: chip_smoke.py --phase9-rank RANK
    WORLD PORT OUT_DIR DEVICE N M runs the phase-9 cases at N^2 / M^3 on its
    blocks and writes OUT_DIR/rankRANK.json; rank 0 also runs the
    one-process whole-grid routes and compares."""
    import os

    import torch
    import torch.distributed as dist

    rank, world, port, out, device, n, m = argv
    rank, world, n, m = int(rank), int(world), int(n), int(m)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    sys.path.insert(0, str(ROOT))
    from neptune_tpu_torch import entry
    from neptune_tpu_torch.lowering.executor import CompiledModule
    from neptune_tpu_torch.parallel import (
        GridMesh, initialize_multihost, shardmap_opdef, shardmap_sweeps,
    )
    from neptune_tpu_torch.solvers import krylov

    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo")
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    report = {"rank": rank, "device": str(dev), "rows": []}
    for label, kind, name, mesh, k, form in PHASE9:
        module = phase9_module(kind, n, m)
        gm = GridMesh(mesh, ("x", "y"), device=dev)
        cm = CompiledModule(module)
        shape = module.lookup(name).ftype.inputs[0].bounds.shape
        x = np.random.default_rng(SEED).standard_normal(shape, dtype=np.float32)
        xl = gm.shard(x)
        f = shardmap_opdef(cm, name, gm) if k is None else shardmap_sweeps(cm, name, gm, k)
        f(xl)
        sync()
        for c in counters().values():
            c.reset()
        gm.staged_bytes = gm.sent_bytes = 0
        dist.barrier()
        y = f(xl)
        sync()
        row = {
            "label": label, "launches": {c.name: c.count for c in counters().values() if c.count},
            "form": form, "sent_bytes": gm.sent_bytes, "staged_bytes": gm.staged_bytes,
            "device": str(y.device),
        }
        dist.barrier()
        row["call_ms"] = host_ms(lambda: f(xl), PHASE9_REPS, sync)
        g = gm.gather(y)
        if rank == 0:
            xg = torch.from_numpy(x).to(dev)
            whole = cm.opdef(name) if k is None else cm.sweeps(name, k)
            ref = whole(xg)
            row["whole_ms"] = host_ms(lambda: whole(xg), PHASE9_REPS, sync)
            row["bitwise"] = bool(torch.equal(g, ref))
            row["max_abs_err"] = (g.float() - ref.float()).abs().max().item()
        report["rows"].append(row)
        del g, y, xl
        dist.barrier()

    # sharded GMRES on the 256^3 heat3d_A system of the 3-D entry step
    cm3 = entry.build_step_3d(m, "float32", device=dev)
    gm = GridMesh((4, 1), ("x", "y"), device=dev)
    b = np.random.default_rng(SEED + 1).standard_normal((m, m, m), dtype=np.float32)
    mv = shardmap_opdef(cm3, "heat3d_A", gm)
    t0 = time.perf_counter()
    xs, info = krylov.gmres(mv, gm.shard(b), tol=1e-6, maxiter=120, group=gm.group)
    sync()
    gm_ms = (time.perf_counter() - t0) * 1e3
    xg = gm.gather(xs)
    solve = {"iters": info.iters, "converged": info.converged, "ms": gm_ms}
    if rank == 0:
        bg = torch.from_numpy(b).to(dev)
        A = cm3.opdef("heat3d_A")
        t0 = time.perf_counter()
        _, winfo = krylov.gmres(A, bg, tol=1e-6, maxiter=120)
        sync()
        solve["whole_ms"] = (time.perf_counter() - t0) * 1e3
        solve["whole_iters"] = winfo.iters
        solve["true_rel_residual"] = (
            torch.linalg.vector_norm(bg - A(xg)) / torch.linalg.vector_norm(bg)
        ).item()
    report["gmres"] = solve
    # phase 12's and phase 13's four-process parts, in the same processes
    report["phase12"] = phase12_rank(rank, dev, sync)
    report["phase13"] = phase13_rank(rank, dev)
    report["phase14"] = phase14_rank(rank, dev)
    report["phase15"] = phase15_rank(rank, dev)
    report["phase16"] = phase16_rank(rank, dev)
    Path(out, f"rank{rank}.json").write_text(json.dumps(report))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase9(device: str, n: int, m: int, timeout: float) -> dict:
    """Spawn the four phase-9 processes (the kernels are built already),
    wait for them, and check their reports."""
    import os
    import socket
    import tempfile

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = str(sk.getsockname()[1])
    out = tempfile.mkdtemp(prefix="nt_phase9_")
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--phase9-rank", str(r), "4", port,
             out, device, str(n), str(m)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(4)
    ]
    logs = []
    try:
        deadline = time.perf_counter() + timeout
        for pr in procs:
            logs.append(pr.communicate(timeout=max(deadline - time.perf_counter(), 1))[0])
    except subprocess.TimeoutExpired:
        fail("phase 9: the four processes did not finish in time")
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for r, (pr, log) in enumerate(zip(procs, logs)):
        require(pr.returncode == 0, f"phase 9 rank {r} exited {pr.returncode}:\n{log[-4000:]}")
    reports = [json.loads(Path(out, f"rank{r}.json").read_text()) for r in range(4)]
    for r in range(4):
        Path(out, f"rank{r}.json").unlink()
    os.rmdir(out)
    return {"reports": reports}


def phase8_forms(dev, rng):
    """The shard-local kernel forms against their plain versions on a block
    at a global start that is not 0 (bitwise; bf16 within one ulp), and
    their times, bounds and library calls at the main path's shapes (the
    1-process mesh: the whole 4096^2 grid as one block)."""
    import torch

    from neptune_tpu_torch import stencils
    from neptune_tpu_torch.kernels import codegen
    from neptune_tpu_torch.lowering import chain, cuda_backend, sweeps, torch_backend

    checks = []
    errs = {"stencil_apply_window": 0.0, "stencil_sweeps_local": 0.0, "stencil_chain_origin": 0.0}

    def err_of(name, got, ref):
        errs[name] = max(errs[name], (got.float() - ref.float()).abs().max().item())

    for label, module, block, gstart in (
        ("jacobi5", stencils.jacobi5((4096, 4096)), (2048, 2048), (2048, 2048)),
        ("jacobi5 bf16", stencils.jacobi5((4096, 4096), "bfloat16"), (2048, 2048), (0, 2048)),
        ("adv4 (h0=2)", stencils.advection4((4096, 4096)), (2048, 4096), (2048, 0)),
        ("heat7 rank 3", stencils.heat7((256, 256, 256)), (64, 256, 256), (128, 0, 0)),
        ("graded index()", stencils.graded((4096, 4096), lb=(3, -5)), (2048, 2048), (2051, 2043)),
    ):
        op = stencils.the_apply(module)
        dtype = torch_backend.DTYPES[op.results[0].type.element]
        x = rand(rng, block, dev).to(dtype)
        got = cuda_backend.apply_window(op, [x], [], gstart)
        ref = torch_backend.execute_apply_window(op, [x], [], gstart)
        err_of("stencil_apply_window", got, ref)
        if dtype == torch.float32:
            require(torch.equal(got, ref), f"window form {label}: kernel != plain")
        else:
            ulps = int((got.view(torch.int16).int() - ref.view(torch.int16).int()).abs().max())
            require(ulps <= 1, f"window form {label}: {ulps} bf16 ulps from plain")
        checks.append(f"window {label} block {block} at {gstart}")
    for label, module, k, block, gstart in (
        ("jacobi5 K=8", stencils.jacobi5((4096, 4096)), 8, (2048, 2048), (2048, 0)),
        ("adv4 K=16", stencils.advection4((8192, 8192)), 16, (4096, 8192), (4096, 0)),
    ):
        op = stencils.the_apply(module)
        plan = sweeps.local_sweep_plan(op, block, k)
        x = rand(rng, block, dev)
        got = sweeps.run_sweeps(plan, x, [], gstart)
        ref = sweeps.sweeps_plain(plan, x, [], gstart)
        err_of("stencil_sweeps_local", got, ref)
        require(torch.equal(got, ref), f"local form {label}: kernel != plain")
        checks.append(f"local {label} (depth {plan.depth}) block {block} at {gstart}")
    for label, module, name, n_f, sc, block, gstart in (
        ("composite", stencils.composite((4096, 4096)), "wrapped", 1, (), (2048, 2048), (2048, 2048)),
        ("two fields + scalars", stencils.coupled((4096, 4096)), "couple", 2, (0.7, -1.3),
         (2048, 4096), (2048, 0)),
    ):
        plan = chain.chain_plan(module, name, block)
        fields = [rand(rng, block, dev) for _ in range(n_f)]
        sv = [torch.tensor(v, dtype=torch.float32) for v in sc]
        got = chain.run_chain(plan, fields, sv, global_start=gstart)
        ref = chain.chain_plain(plan, fields, sv, global_start=gstart)
        err_of("stencil_chain_origin", got, ref)
        require(torch.equal(got, ref), f"origin form {label}: kernel != plain")
        checks.append(f"origin {label} block {block} at {gstart}")
    torch.cuda.synchronize()
    say("phase 8 forms: bitwise equal to their plain versions (bf16 within 1 ulp): "
        + "; ".join(checks))

    # times at the main path's shapes: the 4096^2 grid as the 1-process block
    out = {}
    g0 = (0, 0)
    x = rand(rng, (4096, 4096), dev)
    cells = float(x.numel())
    op = stencils.the_apply(stencils.jacobi5((4096, 4096)))
    k_ms, p_ms = abba(lambda: cuda_backend.apply_window(op, [x], [], g0),
                      lambda: torch_backend.execute_apply_window(op, [x], [], g0), 20)
    lib_ms, lib_txt = library_for_apply(op, [x], cuda_backend.apply_window(op, [x], [], g0))
    out["stencil_apply_window"] = (k_ms, p_ms, bound(8 * cells, codegen.body_ops(op) * cells),
                                   lib_ms, "jacobi5 4096^2 f32, one block")
    extra = {"stencil_apply_window": (
        device_us(lambda: cuda_backend.apply_window(op, [x], [], g0), 20, "nt_apply"),
        a_plan_text(op))}
    plan = sweeps.local_sweep_plan(op, (4096, 4096), 8)
    k_ms, p_ms = abba(lambda: sweeps.run_sweeps(plan, x, [], g0),
                      lambda: sweeps.sweeps_plain(plan, x, [], g0), 3)
    out["stencil_sweeps_local"] = (
        k_ms, p_ms, bound(8 * cells, plan.depth * cells * codegen.body_ops(op)), None,
        f"jacobi5 4096^2 f32, {plan.depth} sweeps, one block")
    extra["stencil_sweeps_local"] = (
        device_us(lambda: sweeps.run_sweeps(plan, x, [], g0), 3, "nt_sweeps"), c_plan_text(plan))
    comp = stencils.composite((4096, 4096))
    cplan = chain.chain_plan(comp, "wrapped", (4096, 4096))
    k_ms, p_ms = abba(lambda: chain.run_chain(cplan, [x], [], global_start=g0),
                      lambda: chain.chain_plain(cplan, [x], [], global_start=g0), 10)
    y = chain.run_chain(cplan, [x], [], global_start=g0)
    lib_ms_d, lib_txt_d = library_for_chain(cplan, [x], y)
    out["stencil_chain_origin"] = (
        k_ms, p_ms, bound(8 * cells, cells * sum(codegen.body_ops(st.op) for st in cplan.stages)),
        lib_ms_d, "u + 0.01 lap(lap u) 4096^2 f32, one block")
    extra["stencil_chain_origin"] = (
        device_us(lambda: chain.run_chain(cplan, [x], [], global_start=g0), 10, "nt_chain"),
        d_plan_text(cplan, g0))
    copy = copy_gbs(int(8 * cells))
    for name, (k_ms, p_ms, (b_ms, b_by), lib, shape) in out.items():
        out[name] = (k_ms, p_ms, (b_ms, b_by), lib, shape, errs[name])
        dev, plan_txt = extra[name]
        say(f"phase 8 {name} at {shape}: max_abs_err={errs[name]!r}; kernel {k_ms:.4f} ms per "
            f"call, device {'not measured' if dev is None else f'{dev:.1f} us'}, plain "
            f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), d2d copy {copy:.1f} GB/s, plan "
            f"{plan_txt}, library "
            + (lib_txt if name == "stencil_apply_window" else
               lib_txt_d if name == "stencil_chain_origin" else "none"))
    return out


def phase8_rows(dev, rng, check_launches: bool = True) -> dict:
    """The JAX package's shardmap_* rows on a mesh of one process: each
    bitwise against the same route with the kernels off and against the
    whole-grid route, with its launches and times. Returns the launch
    counts of all rows together."""
    import torch

    from neptune_tpu_torch.lowering import sweeps
    from neptune_tpu_torch.lowering.executor import CompiledModule
    from neptune_tpu_torch.lowering.torch_backend import DTYPES
    from neptune_tpu_torch.parallel import GridMesh, shardmap_opdef, shardmap_sweeps

    gm = GridMesh((1,), ("x",), device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rows = []
    for label, module, name, k, form in sharded_rows():
        cm = CompiledModule(module)
        t = module.lookup(name).ftype.inputs[0]
        x = rand(rng, t.bounds.shape, dev).to(DTYPES[t.element])
        if k is None:
            f, plain, whole = (shardmap_opdef(cm, name, gm), shardmap_opdef(cm, name, gm, "torch"),
                               cm.opdef(name))
        else:
            f, plain, whole = (shardmap_sweeps(cm, name, gm, k),
                               shardmap_sweeps(cm, name, gm, k, "torch"), cm.sweeps(name, k))
        rows.append((label, x, f, plain, whole, k, form, module, name))
        f(x)  # warm up
    sync()
    for c in counters().values():
        c.reset()
    outs, per_row = [], []
    for label, x, f, *_ in rows:
        before = {n: c.count for n, c in counters().items()}
        outs.append(f(x))
        sync()
        per_row.append({n: c.count - before[n] for n, c in counters().items()})
    launches = {n: c.count for n, c in counters().items()}
    for (label, x, f, plain, whole, k, form, module, name), y, got in zip(rows, outs, per_row):
        if check_launches:
            require(got[form] > 0, f"phase 8 {label}: {form} not launched ({got})")
            if k is not None:
                plan = sweeps.local_sweep_plan(sweeps.find_sweep_apply(module, name), tuple(x.shape), k)
                require((got["stencil_sweeps_local"], got["stencil_apply_window"])
                        == (k // plan.depth, k % plan.depth), f"phase 8 {label}: launches {got}")
        p = plain(x)
        w = whole(x)
        if x.dtype == torch.float32:
            require(torch.equal(y, p), f"phase 8 {label}: kernels != kernels off "
                    f"(max err {(y - p).abs().max().item()})")
        else:
            ulps = int((y.view(torch.int16).int() - p.view(torch.int16).int()).abs().max())
            require(ulps <= 1, f"phase 8 {label}: {ulps} bf16 ulps from the kernels-off route")
        require(torch.equal(y, w) and bool(torch.isfinite(y.float()).all()),
                f"phase 8 {label}: sharded route != whole-grid route")
        if dev.type != "cuda":
            continue
        # timed in turns whole, sharded, sharded, whole; the two sharded
        # runs give the spread
        reps = 3 if x.numel() > 3e7 else 10
        w1, s1, s2, w2 = (cuda_ms(g, reps) for g in (lambda: whole(x), lambda: f(x),
                                                     lambda: f(x), lambda: whole(x)))
        wall, dev_ms, n_ops = op_profile(lambda: f(x), reps)
        say(f"phase 8 {label}: launches {json.dumps({n: v for n, v in got.items() if v})}; "
            f"bitwise = kernels off = whole-grid route; {(s1 + s2) / 2:.4f} ms per call "
            f"(runs of {reps}: {s1:.4f}, {s2:.4f}), whole-grid route {(w1 + w2) / 2:.4f} ms "
            f"({w1:.4f}, {w2:.4f}); traced: {n_ops:.0f} device ops per call, device busy "
            f"{dev_ms:.4f} of {wall:.4f} ms wall ({1e3 * (wall - dev_ms) / n_ops:.1f} us "
            f"idle per device op)")
    return launches


# ---- phase 10: the solver surface at full size ---------------------------
# 10a: fully implicit Allen–Cahn at 4096^2 f32. dt * k = 0.25 (k = eps^2/h^2)
# keeps the Newton Jacobian I + O(1), so Newton takes a few iterations with
# unpreconditioned GMRES; tolerances relative 1e-5 with an f32 atol of 1e-3.
AC_N, AC_GRAD_N, AC_STEPS, JV_REPS = 4096, 1024, 3, 3
AC_DT, AC_K, AC_TOL, AC_ATOL = 0.05, 5.0, 1e-5, 1e-3
# 10c and 10d: bench.py's cg_poisson_512_mixed_1e10 and cg_512_ssor_vs_jacobi
MIXED_N, MIXED_TOL, MIXED_INNER_TOL, MIXED_INNER_ITERS = 512, 1e-10, 1e-4, 6000
SSOR_N, SSOR_TOL, SSOR_MAXIT = 512, 1e-4, 5500


def allen_cahn(ntt, n: int):
    """The fully implicit Allen–Cahn step at n^2 f32, built with the port's
    DSL as examples/allen_cahn.py builds its 1-D one: the residual F =
    u - u_prev - dt (k lap(u) + u - u^3) with F = u - u_prev on the
    boundary rows, its Jacobian in the full (v, u, u_prev) form, and a
    @jit_class whose steps call time_advance(method="implicit_nonlinear")
    without and with jacobian=. Resets the DSL context."""
    ntt.reset_context()
    dt, k = AC_DT, AC_K

    def boundary():
        i, j = ntt.index(0), ntt.index(1)
        return (i == 0) | (i == n - 1) | (j == 0) | (j == n - 1)

    @ntt.nonlinear_op_def(bounds=([0, 0], [n, n]), dtype="float32", name="ac_res")
    def ac_res(u, up):
        lap = u[-1, 0] + u[1, 0] + u[0, -1] + u[0, 1] - 4.0 * u[0, 0]
        interior = u[0, 0] - up[0, 0] - dt * (k * lap + u[0, 0] - u[0, 0] * u[0, 0] * u[0, 0])
        return ntt.where(boundary(), u[0, 0] - up[0, 0], interior)

    @ntt.nonlinear_op_def(bounds=([0, 0], [n, n]), dtype="float32", name="ac_jac")
    def ac_jac(v, u, up):
        lap = v[-1, 0] + v[1, 0] + v[0, -1] + v[0, 1] - 4.0 * v[0, 0]
        interior = v[0, 0] - dt * (k * lap + v[0, 0] - 3.0 * u[0, 0] * u[0, 0] * v[0, 0])
        return ntt.where(boundary(), v[0, 0] + 0.0 * up[0, 0], interior)

    opts = {"atol": AC_ATOL}

    @ntt.jit_class
    class AC:
        def __init__(self):
            self.n = n

        def step(self, u):
            return ntt.time_advance(u, dt, "implicit_nonlinear", residual=ac_res, tol=AC_TOL,
                                    max_iters=20, options=opts)

        def step_jac(self, u):
            return ntt.time_advance(u, dt, "implicit_nonlinear", residual=ac_res,
                                    jacobian=ac_jac, tol=AC_TOL, max_iters=20, options=opts)

    return AC()


def poisson(ntt, n: int, dtype: str, name: str):
    """bench.py's 5-pt Poisson opdef at n^2, in a fresh DSL context."""
    ntt.reset_context()

    @ntt.linear_op_def(bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]), dtype=dtype,
                       name=name)
    def op(u):
        return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

    return op


def phase10_sources(ntt) -> list:
    """Kernel A's sources for phase 10's applies, for phase 1's parallel
    build: the Allen–Cahn residual and Jacobian at both sizes, the f32 twin
    of the f64 Poisson operator, and the f32 Poisson operator."""
    from neptune_tpu_torch.lowering import cuda_backend

    modules = []
    for n in (AC_N, AC_GRAD_N):
        allen_cahn(ntt, n)
        modules.append(ntt.get_context().compiled().module)
    poisson(ntt, MIXED_N, "float64", "poisson64")
    cm = ntt.get_context().compiled()
    cm.low_precision_opdef("poisson64")
    modules.append(cm._lo_cm.module)
    poisson(ntt, SSOR_N, "float32", "poisson")
    modules.append(ntt.get_context().compiled().module)
    ntt.reset_context()
    return [cuda_backend.source(op) for m in modules for op in m.walk()
            if op.name == "neptune.apply" and cuda_backend.supported(op)]


def split_profile(fn):
    """(host wall ms, device ms in kernel A, kernel-A launches the trace
    recorded, kernel-A launches counted, device ms in every other kernel,
    launches of other kernels) of one call of fn(), from a torch.profiler
    trace. The trace can miss a record, so both launch counts are given."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from neptune_tpu_torch.lowering import cuda_backend

    torch.cuda.synchronize()
    before = cuda_backend.counter.count
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    a = [e for e in dev if "nt_apply" in e.key]
    other = [e for e in dev if "nt_apply" not in e.key]
    return (wall, sum(e.device_time_total for e in a) / 1e3, sum(e.count for e in a),
            cuda_backend.counter.count - before,
            sum(e.device_time_total for e in other) / 1e3, sum(e.count for e in other))


def timed(fn):
    """(fn()'s result, host milliseconds to its end on the card)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase10(ntt, dev, rng) -> None:
    import torch
    from neptune_tpu_torch.lowering import cuda_backend, executor
    from neptune_tpu_torch.lowering.executor import CompiledModule
    from neptune_tpu_torch.solvers import krylov, precond
    from neptune_tpu_torch.solvers.diff import differentiable_root
    from neptune_tpu_torch.solvers.refine import refined_solve

    t10 = time.perf_counter()
    # ---- 10a: Newton on the kernel route against the kernels-off route
    infos = []
    newton = executor.newton_krylov

    def recording(*a, **k):
        x, info = newton(*a, **k)
        infos.append(info)
        return x, info

    executor.newton_krylov = recording
    try:
        ac = allen_cahn(ntt, AC_N)
        n = AC_N
        xs = torch.linspace(0.0, 1.0, n, device=dev)
        u0 = (0.9 * torch.sin(8 * np.pi * xs)[:, None] * torch.sin(8 * np.pi * xs)[None, :]
              + 0.05 * rand(rng, (n, n), dev))
        ac.step(u0)  # traces, compiles and warms up
        cm = ntt.get_context().compiled()
        off_step = CompiledModule(cm.module, "torch", dev).function("AC_step")
        off_step(u0)
        runs = {}
        for label, step in (("kernels", ac.step), ("off", off_step)):
            for c in counters().values():
                c.reset()
            executor.rule_counter.reset()
            infos.clear()
            states, u = [], u0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(AC_STEPS):
                u = step(u)
                states.append(u)
            torch.cuda.synchronize()
            runs[label] = (states, list(infos), (time.perf_counter() - t0) * 1e3,
                           cuda_backend.counter.count, executor.rule_counter.count)
        (s_on, i_on, ms_on, a_on, rule_on), (s_off, i_off, ms_off, a_off, _) = (
            runs["kernels"], runs["off"])
        require(a_on > 0 and a_off == 0, f"10a: kernel A launches {a_on} (off route {a_off})")
        # each J v through the rule is one forward (one kernel-A launch, whose
        # primal GMRES drops) and one tangent; the other launches are residuals
        residuals = a_on - rule_on
        require(rule_on > 0, "10a: Newton's J v did not go through the derivative rule")
        require(residuals > 0, f"10a: kernel A {a_on} launches for {rule_on} J v")
        require(all(i.converged for i in i_on), f"10a: Newton did not converge: {i_on}")
        require([(i.iters, i.krylov_iters) for i in i_on]
                == [(i.iters, i.krylov_iters) for i in i_off],
                f"10a: Newton/Krylov iterations {i_on} against the kernels-off route {i_off}")
        errs = [float((a - b).abs().max()) for a, b in zip(s_on, s_off)]
        newton_its = sum(i.iters for i in i_on)
        prof = split_profile(lambda: ac.step(s_on[0]))
        say(f"phase 10a Allen-Cahn {n}^2 f32 implicit, dt {AC_DT}, dt*k {AC_DT * AC_K}, "
            f"Newton tol {AC_TOL} atol {AC_ATOL}: {AC_STEPS} steps, Newton iterations "
            f"{[i.iters for i in i_on]}, Krylov {[i.krylov_iters for i in i_on]} (= kernels-off "
            f"route), final |F| {[f'{i.resnorm:.3e}' for i in i_on]} under target; states "
            f"{'bitwise equal' if max(errs) == 0 else f'max_abs_err {max(errs)!r}'} to the "
            f"kernels-off route; {ms_on / AC_STEPS:.1f} ms per step, {ms_on / newton_its:.1f} ms "
            f"per Newton iteration (kernels-off {ms_off / AC_STEPS:.1f} ms per step); kernel A "
            f"{a_on} launches: {rule_on} primals of J v through the derivative rule (one per "
            f"tangent, {rule_on / AC_STEPS:.1f} per step, unused by GMRES) and {residuals} "
            f"residual evaluations ({residuals / AC_STEPS:.1f} per step)")
        say(f"phase 10a split of one step (torch.profiler): host {prof[0]:.1f} ms, device "
            f"kernel A {prof[1]:.3f} ms ({prof[2]} of {prof[3]} launches recorded), other "
            f"kernels (eager tangent, GMRES, norms) {prof[4]:.3f} ms in {prof[5]} launches")
        # the same step with jacobian= in the full form (v, u, u_prev)
        ac.step_jac(u0)  # traces it into the module
        cm = ntt.get_context().compiled()
        off_jac = CompiledModule(cm.module, "torch", dev).function("AC_step_jac")
        infos.clear()
        before = cuda_backend.counter.count
        x_jac, ms_jac = timed(lambda: ac.step_jac(u0))
        jac_launches = cuda_backend.counter.count - before
        x_off = off_jac(u0)
        (i_jac, i_jac_off) = infos
        require(i_jac.converged and (i_jac.iters, i_jac.krylov_iters)
                == (i_jac_off.iters, i_jac_off.krylov_iters),
                f"10a jacobian=: {i_jac} against the kernels-off route {i_jac_off}")
        require(jac_launches > i_jac.krylov_iters, f"10a jacobian=: kernel A {jac_launches}")
        say(f"phase 10a solve_nonlinear with jacobian= (full form): Newton {i_jac.iters}, "
            f"Krylov {i_jac.krylov_iters} (= kernels-off route), |F| {i_jac.resnorm:.3e}; "
            f"kernel A {jac_launches} launches (J v on the card); {ms_jac:.1f} ms; max |x - "
            f"x(jvp)| {float((x_jac - s_on[0]).abs().max())!r}, max |x - kernels-off| "
            f"{float((x_jac - x_off).abs().max())!r}")
    finally:
        executor.newton_krylov = newton

    # ---- 10b: derivatives on the card
    res = cm.opdef("ac_res")
    view = cm.opdef("ac_res", differentiable=True)
    u, up = s_on[-1], s_on[-2]
    v = rand(rng, (n, n), dev)
    (_, tan), (_, tan_ref) = (torch.func.jvp(lambda x: f(x, up), (u,), (v,)) for f in (res, view))
    cots = []
    for f in (res, view):
        leaves = (u.clone().requires_grad_(True), up.clone().requires_grad_(True))
        cots.append(torch.autograd.grad(f(*leaves), leaves, v))
    jv_rule, jv_view = (lambda f=f: torch.func.jvp(lambda x: f(x, up), (u,), (v,))
                        for f in (res, view))
    jv_ms = abba(jv_rule, jv_view, 10)
    jv_prof = split_profile(lambda: [jv_rule() for _ in range(JV_REPS)])
    require(jv_prof[3] == JV_REPS, f"10b: {JV_REPS} J v through the rule launched kernel A "
            f"{jv_prof[3]} times")
    e_tan = float((tan - tan_ref).abs().max())
    e_cot = max(float((a - b).abs().max()) for a, b in zip(*cots))
    scale = float(tan_ref.abs().max())
    require(e_tan <= 1e-6 * scale and e_cot <= 1e-6 * scale,
            f"10b: rule against eager view: tangent {e_tan!r}, cotangent {e_cot!r}")
    allen_cahn(ntt, AC_GRAD_N)
    cm1 = ntt.get_context().compiled()
    up0 = (0.9 * torch.tanh(4 * rand(rng, (AC_GRAD_N, AC_GRAD_N), dev)))
    grads = []
    for f in (cm1.opdef("ac_res"), CompiledModule(cm1.module, "torch", dev).opdef("ac_res")):
        before = cuda_backend.counter.count
        upr = up0.clone().requires_grad_(True)
        x = differentiable_root(lambda w, f=f, upr=upr: f(w, upr), up0, tol=AC_TOL,
                                krylov_tol=AC_TOL)
        (g,) = torch.autograd.grad((x * x).sum(), upr)
        grads.append((g, cuda_backend.counter.count - before))
    (g_on, n_on), (g_off, n_off) = grads
    g_rel = float((g_on - g_off).abs().max() / g_off.abs().max())
    require(n_on > 0 and n_off == 0 and g_rel <= 1e-5,
            f"10b: differentiable_root gradient rel err {g_rel!r} (launches {n_on}, {n_off})")
    say(f"phase 10b derivative rule at {n}^2: tangent max_abs_err {e_tan!r}, cotangent "
        f"{e_cot!r} against the eager view (|tangent| max {scale:.3e}); "
        f"one J v through the rule {jv_ms[0]:.3f} ms, through the eager view alone "
        f"{jv_ms[1]:.3f} ms (CUDA events, 10 calls each, in turns); device time of "
        f"{JV_REPS} J v (torch.profiler): kernel A {jv_prof[1]:.3f} ms ({jv_prof[2]} of "
        f"{jv_prof[3]} launches recorded), the eager tangent {jv_prof[4]:.3f} ms in "
        f"{jv_prof[5]} launches; "
        f"differentiable_root d(sum u_next^2)/d u_prev at {AC_GRAD_N}^2 f32: relative "
        f"err {g_rel!r} against the kernels-off route (tolerance 1e-5), kernel A {n_on} launches")

    # ---- 10c: cg_poisson_512_mixed_1e10
    poisson(ntt, MIXED_N, "float64", "poisson64")
    cm = ntt.get_context().compiled()
    b = torch.from_numpy(np.random.default_rng(SEED).standard_normal((MIXED_N, MIXED_N))).to(dev)
    rows = []
    for c in (cm, CompiledModule(cm.module, "torch", dev)):
        H = ntt.assemble_matrix("poisson64")
        hi, lo = c.opdef("poisson64"), c.low_precision_opdef("poisson64")
        inv32 = precond.safe_inv_diag(precond.extract_diagonal(
            hi, torch.zeros_like(b), H.halo)).float()

        def solve(hi=hi, lo=lo, inv32=inv32):
            return refined_solve(hi, lo, b, solver="cg", tol=MIXED_TOL,
                                 inner_tol=MIXED_INNER_TOL, inner_iters=MIXED_INNER_ITERS,
                                 M_lo=lambda r: r * inv32)

        solve()  # warm-up
        before = cuda_backend.counter.count
        (x, info), ms = timed(solve)
        rel = float(torch.linalg.vector_norm(b - hi(x)) / torch.linalg.vector_norm(b))
        rows.append((info, ms, rel, cuda_backend.counter.count - before))
    (i_on, ms_on, rel_on, a_on), (i_off, ms_off, rel_off, a_off) = rows
    require(i_on.converged and rel_on <= MIXED_TOL, f"10c: true relative residual {rel_on!r}")
    require(i_on.rounds == i_off.rounds and abs(i_on.inner_iters - i_off.inner_iters) <= 1,
            f"10c: {i_on} against the kernels-off route {i_off}")
    require(a_on >= i_on.inner_iters and a_off == 0, f"10c: kernel A launches {a_on}, {a_off}")
    say(f"phase 10c cg_poisson_512_mixed_1e10 (f64 {MIXED_N}^2 Poisson, f32 Jacobi-CG inner "
        f"rounds at {MIXED_INNER_TOL}): {i_on.rounds} rounds, {i_on.inner_iters} inner "
        f"iterations (kernels-off {i_off.rounds}, {i_off.inner_iters}), true relative residual "
        f"{rel_on!r}; {ms_on:.1f} ms per solve (kernels-off {ms_off:.1f} ms); kernel A "
        f"{a_on} launches by the f32 twin")

    # ---- 10d: cg_512_ssor_vs_jacobi
    poisson(ntt, SSOR_N, "float32", "poisson")
    H = ntt.assemble_matrix("poisson")
    bb = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (SSOR_N, SSOR_N)).astype(np.float32)).to(dev)
    like = torch.zeros_like(bb)
    stats = {}
    for name in ("jacobi", "ssor"):
        M = precond.make_preconditioner(name, H.matvec, like, H.halo)

        def solve(M=M):
            return krylov.cg(H.matvec, bb, tol=SSOR_TOL, maxiter=SSOR_MAXIT, M=M)

        solve()
        before = cuda_backend.counter.count
        (x, info), ms = timed(solve)
        stats[name] = (info, ms, cuda_backend.counter.count - before)
        require(info.converged and stats[name][2] > 0, f"10d {name}: {info}, {stats[name][2]}")
    require(stats["ssor"][0].iters < stats["jacobi"][0].iters, f"10d: {stats}")
    say("phase 10d cg_512_ssor_vs_jacobi (512^2 Poisson f32 CG, tol 1e-4): " + "; ".join(
        f"{name} {info.iters} iterations, {ms:.1f} ms per solve, {info.iters / ms * 1e3:.0f} "
        f"iterations/s, kernel A {a} launches" for name, (info, ms, a) in stats.items())
        + f"; SSOR/Jacobi iterations {stats['ssor'][0].iters / stats['jacobi'][0].iters:.3f}; "
        f"phase wall {time.perf_counter() - t10:.1f} s")
    ntt.reset_context()


# ---- phase 11: geometric multigrid and Chebyshev at full size -------------
# 11a and 11e: phase 3's 5-pt 512^2 f32 Poisson system and rhs; 11b: the same
# operator at 4096^2 (64 MB per field); 11c: examples/multigrid_poisson.py's
# 1/h^2-scaled hierarchy 512..16; 11d: the 7-pt operator at 256^3. Every
# case runs on the kernel route and on the kernels-off route (backend
# "torch"), which must take the same iterations to a bitwise-equal result.
MG_N, MG_BIG_N, MG_3D_N, MG_TOL, MG_MAXIT, MG_EXAMPLE_MAXIT = 512, 4096, 256, 1e-4, 500, 60
MG_EXAMPLE_SIZES = [512, 256, 128, 64, 32, 16]
# tolerances above f32's floor of the true relative residual: at 4096^2 a
# white-noise rhs leaves it at 1.8e-4 once CG's recurrence reaches 1e-4 (an
# H100 80GB HBM3 at 700 W); the example's 1/h^2-scaled operator with
# b = A u* leaves it at 4.4e-5 (128^2) and 1.7e-4 (256^2), four times more
# per doubling (on a CPU), so its f32 tol of 1e-4 is out of reach at 512^2
MG_BIG_TOL, MG_EXAMPLE_TOL = 1e-3, 3e-3
# Chebyshev's bounds come from estimate_spectrum with Jacobi; power iteration
# on the reflected operator finds lam_min slowly, hence its long estimate
CHEB_CHECK, CHEB_EST_ITERS, CHEB_MAXIT = 10, 3000, 20000
# (label, operator builder, solve_linear options, MG levels by the default
# rule, tol)
MG_SYSTEMS = [
    ("11a cg_poisson_512 precond=mg", lambda s: s.poisson5(MG_N), None, 6, MG_TOL),
    ("11a cg_poisson_512 precond=mg mg_smoother=cheb", lambda s: s.poisson5(MG_N),
     {"mg_smoother": "cheb"}, 6, MG_TOL),
    (f"11b {MG_BIG_N}^2 f32 precond=mg", lambda s: s.poisson5(MG_BIG_N), None, 6, MG_BIG_TOL),
    (f"11d 7-pt {MG_3D_N}^3 f32 precond=mg", lambda s: s.poisson7(MG_3D_N), None, 5, MG_TOL),
]


def mg_module(build, options, tol):
    """An MG_SYSTEMS operator with @solve: CG + precond="mg" to tol."""
    from neptune_tpu_torch import stencils

    return stencils.with_solve(build(stencils), "poisson", solver="cg", tol=tol,
                               max_iters=MG_MAXIT, precond="mg", options=options)


def mg_example(ntt):
    """examples/multigrid_poisson.py's rediscretized Poisson opdefs at
    MG_EXAMPLE_SIZES in f32, in a fresh DSL context: its compiled module."""
    ntt.reset_context()

    def make(n):
        inv_h2 = float((n - 1) * (n - 1))

        @ntt.linear_op_def(bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]),
                           dtype="float32", name=f"poisson{n}")
        def op(u):
            return (4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]) * inv_h2

    for n in MG_EXAMPLE_SIZES:
        make(n)
    return ntt.get_context().compiled()


def phase11_sources(ntt) -> list:
    """Kernel A's sources for every level of phase 11's hierarchies, for
    phase 1's parallel build: each system's coarsened modules, the
    example's opdefs and the DSL's 512^2 operator with its coarsenings."""
    from neptune_tpu_torch.lowering import cuda_backend
    from neptune_tpu_torch.passes.coarsen import coarsen_opdef

    def hierarchy(module, levels):
        out = [module]
        for _ in range(levels - 1):
            out.append(coarsen_opdef(out[-1], "poisson"))
        return out

    modules = [mg_example(ntt).module]
    for _, build, options, levels, tol in MG_SYSTEMS:
        modules += hierarchy(mg_module(build, options, tol), levels)
    poisson(ntt, MG_N, "float32", "poisson")
    modules += hierarchy(ntt.get_context().compiled().module, MG_SYSTEMS[0][3])
    ntt.reset_context()
    return [cuda_backend.source(op) for m in modules for op in m.walk()
            if op.name == "neptune.apply" and cuda_backend.supported(op)]


class ShapeLaunches:
    """Kernel-A launches by output shape while in a `with` block: wraps
    `cuda_backend.stencil_apply`, whose own count stays the kernel's. With
    forms=True the key is "window N" for the window form (a block at a
    global start) or "whole N" for the whole grid, N the global extent."""

    def __init__(self, forms: bool = False):
        self.forms = forms

    def __enter__(self):
        from neptune_tpu_torch.lowering import cuda_backend

        self.by_shape, self.mod, real = {}, cuda_backend, cuda_backend.stencil_apply

        def counting(op, *a, **k):
            out = real(op, *a, **k)
            key = shape = op.results[0].type.bounds.shape
            if self.forms:
                window = (a[3] if len(a) > 3 else k.get("global_start")) is not None
                key = f"{'window' if window else 'whole'} {shape[0]}"
            self.by_shape[key] = self.by_shape.get(key, 0) + 1
            return out

        self.real, cuda_backend.stencil_apply = real, counting
        return self

    def __exit__(self, *exc):
        self.mod.stencil_apply = self.real

    def take(self) -> dict:
        got, self.by_shape = self.by_shape, {}
        return got


def kinds_profile(fn, iters: int) -> dict:
    """Device launches and ms per iteration of one call of fn(), by kind,
    from a torch.profiler trace (records the trace missed are not counted)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kinds: dict = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = e.key.lower()
        kind = ("kernel A" if "nt_apply" in key else "matmul" if "gemm" in key or "gemv" in key
                else "reduction" if "reduce" in key
                else "interpolation" if "upsample" in key or "interp" in key
                else "copy/fill" if "memcpy" in key or "memset" in key or "fill" in key
                else "elementwise/other")
        n, ms = kinds.get(kind, (0, 0.0))
        kinds[kind] = (n + e.count, ms + e.device_time_total / 1e3)
    return {k: (n / iters, ms / iters) for k, (n, ms) in kinds.items()}


def route_pair(label, runs, levels, true_rel, tol):
    """Hold a case's kernel route to its kernels-off route: equal
    iterations, bitwise-equal results, the true residual under tol, kernel
    A on every level (and on none with the kernels off)."""
    import torch

    (x_on, it_on, ms_on, shapes_on), (x_off, it_off, ms_off, shapes_off) = runs
    require(it_on == it_off, f"{label}: iterations {it_on} against the kernels-off route {it_off}")
    require(torch.equal(x_on, x_off), f"{label}: kernel route != kernels-off route (max err "
            f"{float((x_on - x_off).abs().max())!r})")
    require(true_rel <= 1.01 * tol, f"{label}: true relative residual {true_rel!r} (tol {tol})")
    require(len(shapes_on) == levels and all(v > 0 for v in shapes_on.values())
            and not shapes_off, f"{label}: kernel-A launches by level {shapes_on} "
            f"(kernels off {shapes_off}), {levels} levels expected")


def shapes_text(shapes: dict) -> str:
    return ", ".join(f"{'x'.join(map(str, s))}: {n}" for s, n in sorted(shapes.items(),
                                                                       reverse=True))


def phase11(ntt, dev, b_ref: tuple) -> dict:
    """Phase 11; b_ref is phase 3's kernel-B Jacobi-CG on 11a's system
    (ms per solve, iterations). Returns its kernel-A launches, the PCG
    iterations of each MG_SYSTEMS case, and 11e's (module, iterations,
    solution), for phase 13."""
    import torch
    from neptune_tpu_torch.lowering import cuda_backend
    from neptune_tpu_torch.lowering.executor import CompiledModule
    from neptune_tpu_torch.solvers import estimate_spectrum, fmg_start, krylov, multigrid_solve
    from neptune_tpu_torch.solvers import build_levels
    from neptune_tpu_torch.solvers.precond import safe_inv_diag

    cheb_mod = sys.modules["neptune_tpu_torch.solvers.chebyshev"]
    t11 = time.perf_counter()
    infos, reads = [], [0]
    whole = {}
    real_solve, real_test = krylov.solve, cheb_mod._unconverged

    def recording(*a, **k):
        x, info = real_solve(*a, **k)
        infos.append(info)
        return x, info

    def counting_test(*a):
        reads[0] += 1
        return real_test(*a)

    def rel_residual(A, x, b):
        return float(torch.linalg.vector_norm(b - A(x)) / torch.linalg.vector_norm(b))

    def routes(solve_of, b):
        """Per route, after a first solve (which builds the hierarchy), one
        timed solve: [(x, iterations, ms per solve, kernel-A launches by
        shape)] for the kernel route and the kernels-off route, and the
        kernel route's first solve in ms."""
        out, first = [], []
        for route in ("auto", "torch"):
            solve = solve_of(route)
            first.append(timed(lambda: solve(b))[1])
            shapes.take()
            infos.clear()
            x, ms = timed(lambda: solve(b))
            out.append((x, infos[-1].iters, ms, shapes.take()))
        return out, first[0]

    for c in counters().values():
        c.reset()
    krylov.solve, cheb_mod._unconverged = recording, counting_test
    try:
        with ShapeLaunches() as shapes:
            # ---- 11a, 11b, 11d: precond="mg" through the IR executor
            for label, build, options, levels, tol in MG_SYSTEMS:
                module = mg_module(build, options, tol)
                shape = module.lookup("poisson").ftype.inputs[0].bounds.shape
                b = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
                    shape, dtype=np.float32)).to(dev)
                runs, first_ms = routes(
                    lambda r, m=module: CompiledModule(m, r, dev).function("solve"), b)
                A = CompiledModule(module, "torch", dev).opdef("poisson")
                rel = rel_residual(A, runs[0][0], b)
                route_pair(label, runs, levels, rel, tol)
                (x, iters, ms, by_shape), (_, _, ms_off, _) = runs
                whole[label] = iters
                line = (f"phase 11 {label}, tol {tol}: {iters} PCG iterations (= kernels-off "
                        f"route), solutions bitwise equal, true relative residual {rel!r}; "
                        f"{ms:.2f} ms per solve, {ms / iters:.3f} ms per iteration (kernels-off "
                        f"{ms_off:.2f} ms, {ms_off / iters:.3f}); first solve with the hierarchy "
                        f"build {first_ms:.1f} ms; kernel A per level {shapes_text(by_shape)}")
                if label == MG_SYSTEMS[0][0]:
                    line += (f"; kernel B's fused Jacobi-CG on this system (phase 3): "
                             f"{b_ref[0]:.3f} ms per solve, {b_ref[1]} iterations")
                say(line)
                if label.startswith("11b"):
                    solve = CompiledModule(module, "auto", dev).function("solve")
                    prof = split_profile(lambda: solve(b))
                    kinds = kinds_profile(lambda: solve(b), iters)
                    shapes.take()
                    dev_ms = prof[1] + prof[4]
                    say(f"phase 11b split of one solve (torch.profiler): host {prof[0]:.1f} ms "
                        f"under the profiler, device {dev_ms:.3f} ms ({dev_ms / ms:.3f} of the "
                        f"{ms:.2f} ms solve without it); kernel A "
                        f"{prof[1]:.3f} ms ({prof[1] / dev_ms:.3f} of device time; {prof[2]} of "
                        f"{prof[3]} launches recorded), other kernels {prof[4]:.3f} ms in "
                        f"{prof[5]} launches; per PCG iteration: " + "; ".join(
                            f"{k} {n:.1f} launches, {m:.3f} ms" for k, (n, m) in
                            sorted(kinds.items())))

            # ---- 11a through the DSL, each route in its own context
            b = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
                (MG_N, MG_N), dtype=np.float32)).to(dev)
            runs, backend = [], ntt.config.backend
            try:
                for route in ("auto", "torch"):
                    ntt.config.backend = route
                    poisson(ntt, MG_N, "float32", "poisson")
                    H = ntt.assemble_matrix("poisson")

                    def solve(H=H):
                        return ntt.solve_linear(H, b, solver="cg", tol=MG_TOL,
                                                max_iters=MG_MAXIT, precond="mg")

                    solve()
                    shapes.take()
                    infos.clear()
                    x, ms = timed(solve)
                    runs.append((x, infos[-1].iters, ms, shapes.take()))
                    A = H.matvec
            finally:
                ntt.config.backend = backend
                ntt.reset_context()
            rel = rel_residual(A, runs[0][0], b)
            route_pair("11a DSL", runs, MG_SYSTEMS[0][3], rel, MG_TOL)
            say(f"phase 11a cg_poisson_512 precond=mg (DSL solve_linear): {runs[0][1]} PCG "
                f"iterations (= kernels-off route), bitwise equal, true relative residual "
                f"{rel!r}; {runs[0][2]:.2f} ms per solve (kernels-off {runs[1][2]:.2f} ms); "
                f"hierarchy cached in the context; kernel A per level {shapes_text(runs[0][3])}")

            # ---- 11c: multigrid_solve with red-black smoothing, two starts
            cm = mg_example(ntt)
            names = [f"poisson{n}" for n in MG_EXAMPLE_SIZES]
            xs = torch.linspace(0.0, 1.0, MG_N, device=dev)
            X, Y = xs[:, None], xs[None, :]
            u_star = torch.sin(np.pi * X) * torch.sin(2 * np.pi * Y) * (X * (1 - X))
            u_star[0, :] = u_star[-1, :] = u_star[:, 0] = u_star[:, -1] = 0.0
            b = cm.opdef(names[0])(u_star)
            rows = {}
            for route, c in (("auto", cm), ("torch", CompiledModule(cm.module, "torch", dev))):
                ops = [c._handle_for(n) for n in names]
                levels, build_ms = timed(lambda: build_levels(ops, b))
                for start in ("zero", "fmg"):
                    def run(ops=ops, levels=levels, start=start):
                        x0 = fmg_start(levels, b) if start == "fmg" else None
                        return multigrid_solve(ops, b, x0=x0, tol=MG_EXAMPLE_TOL,
                                               maxiter=MG_EXAMPLE_MAXIT, levels=levels)

                    run()
                    shapes.take()
                    (x, info), ms = timed(run)
                    require(info.converged, f"11c {start} start ({route}): {info}")
                    rows[route, start] = (x, info.iters, ms, shapes.take(), build_ms)
            for start in ("zero", "fmg"):
                on, off = rows["auto", start], rows["torch", start]
                rel = rel_residual(cm.opdef(names[0]), on[0], b)
                route_pair(f"11c {start} start", (on[:4], off[:4]), len(names), rel,
                           MG_EXAMPLE_TOL)
                err = float((on[0] - u_star).abs().max())
                say(f"phase 11c multigrid_solve rb, examples/multigrid_poisson.py {MG_N}.."
                    f"{MG_EXAMPLE_SIZES[-1]} f32, "
                    f"tol {MG_EXAMPLE_TOL}, {start} start: {on[1]} V-cycles (= kernels-off route), "
                    f"bitwise equal, true relative residual {rel!r}, max |x - u*| {err:.3e}; "
                    f"{on[2]:.2f} ms per solve{' with fmg_start' if start == 'fmg' else ''}, "
                    f"{on[2] / max(on[1], 1):.3f} ms per cycle{' (fmg_start included)' if start == 'fmg' else ''} "
                    f"(kernels-off {off[2]:.2f} ms); "
                    f"build_levels {on[4]:.1f} ms; kernel A per level {shapes_text(on[3])}")
            ntt.reset_context()

            # ---- 11e: solver="chebyshev", Jacobi, check_every, estimated bounds
            from neptune_tpu_torch import stencils

            op = stencils.poisson5(MG_N)
            b = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
                (MG_N, MG_N), dtype=np.float32)).to(dev)
            H = CompiledModule(op, "auto", dev)._handle_for("poisson")
            inv = safe_inv_diag(H.diagonal(dev))
            est, est_ms = timed(lambda: estimate_spectrum(H.matvec, b, iters=CHEB_EST_ITERS,
                                                          M=lambda v: inv * v))
            lam = {"lam_min": float(est.lam_min), "lam_max": float(est.lam_max)}
            module = stencils.with_solve(op, "poisson", solver="chebyshev", tol=MG_TOL,
                                         max_iters=CHEB_MAXIT, precond="jacobi",
                                         options={**lam, "check_every": CHEB_CHECK})
            reads[0] = 0
            runs, _ = routes(lambda r: CompiledModule(module, r, dev).function("solve"), b)
            iters = runs[0][1]
            # four solves ran (a warm-up and a timed one per route): each read
            # once before its loop and once per check
            per_solve = reads[0] / 4
            require(iters < CHEB_MAXIT and per_solve == (iters - 1) // CHEB_CHECK + 1,
                    f"11e: {iters} iterations, {per_solve} host reads per solve")
            rel = rel_residual(CompiledModule(module, "torch", dev).opdef("poisson"), runs[0][0], b)
            route_pair("11e chebyshev", runs, 1, rel, MG_TOL)
            (x_cheb, _, ms, by_shape), (_, _, ms_off, _) = runs
            cheb = (module, iters, x_cheb)
            say(f"phase 11e solver=chebyshev + Jacobi on cg_poisson_512 (IR executor), tol "
                f"{MG_TOL}, check_every {CHEB_CHECK}, bounds [{lam['lam_min']:.4e}, "
                f"{lam['lam_max']:.4e}] from estimate_spectrum ({CHEB_EST_ITERS} iterations, "
                f"{est_ms:.1f} ms): {iters} iterations (= kernels-off route), bitwise equal, "
                f"true relative residual {rel!r}; {per_solve:.0f} host reads of the residual "
                f"per solve (one per {CHEB_CHECK} iterations, and one before the loop); "
                f"{ms:.1f} ms per solve, {ms / iters * 1e3:.1f} us per iteration (kernels-off "
                f"{ms_off:.1f} ms); kernel A {shapes_text(by_shape)}")
    finally:
        krylov.solve, cheb_mod._unconverged = real_solve, real_test
    a_launches = cuda_backend.counter.count
    say(f"phase 11 kernel-A launches {a_launches}; phase wall {time.perf_counter() - t11:.1f} s")
    return {"launches": a_launches, "whole": whole, "cheb": cheb}


# ---- phase 12: the communication-avoiding solvers and sharded_function -----
# bench.py's CA system (`_ca_poisson_256`): the 256^2 f32 5-pt Poisson
# operator with a Dirichlet ring, the rhs from default_rng(0) on the
# interior, lam_min = 2(2 - 2cos(pi/257)), lam_max = 8, tol 1e-4; each CA
# row beside its per-iteration counterpart on the same mesh, as bench.py
# pairs them (CG and GMRES(8) with maxiter 3500, BiCGStab, and Chebyshev
# with the CA row's iterations). Chebyshev runs 1201 iterations, not the
# bench row's 3200: its f32 true residual reaches tol at ~790 iterations
# and f32's floor, ~3.4e-5, by 1000 (3201 iterations end at 3.48e-5 on the
# card), so the last 2000 iterations only cost time.
CA_N = 256
CA_CHEB_ITERS = 1201
# the case whose solve phase 12a also traces, for where its time goes
CA_PROFILED = "cg_sharded s=8 chebyshev basis"
CA_PROFILED_ITERS = 64
CA_TOL = 1e-4
# sharded_function on four processes: (label, entry builder, function, mesh,
# grid size)
PHASE12_FUNCTIONS = [
    ("3-D GMRES step 256^3 on (4,1)", "build_step_3d", "step3d", (4, 1), 256),
    ("2-D CG heat step 256^2 on (2,2)", "build_step", "step", (2, 2), 256),
]
# the solves' tol is 1e-6 in both steps: the sharded and the whole-grid
# results may differ by what two solves to that tol leave (I - c lap has a
# condition number under 2 here), so the gathered result is held to 10 tol
# in the relative 2-norm
PHASE12_FN_TOL = 1e-5


def ca_system():
    """(module, rhs, lam_min, lam_max) of bench.py's `_ca_poisson_256`."""
    from neptune_tpu_torch import stencils

    b = np.zeros((CA_N, CA_N), np.float32)
    b[1:-1, 1:-1] = np.random.default_rng(0).standard_normal((CA_N - 2, CA_N - 2))
    lmin = 2.0 * (2.0 - 2.0 * np.cos(np.pi / (CA_N + 1)))
    return stencils.poisson5(CA_N), b, lmin, 8.0


# In f32 the iteration counts of CA-GMRES(8) and CA-BiCGStab(2) on this
# system follow roundoff: the JAX package itself, on the CPU, took 600
# (stalled at 1.9e-4), 928, 760 and 832 GMRES iterations and 578, 406, 525
# and 516 BiCGStab iterations on its (1,), (2,2), (4,1) and (1,4) meshes;
# CG took 473 on every mesh. So CG and Chebyshev ("steady") are held to
# converge and to one outer block between meshes; GMRES and BiCGStab to a
# true residual under CA_GROSS * tol, their iterations and convergence
# printed.
CA_GROSS = 10


def ca_cases(lmin: float, lmax: float) -> dict:
    """label -> (CA solve of (cm, gmesh), per-iteration counterpart of
    (matvec, b, group), iterations per outer block, steady)."""
    from neptune_tpu_torch import parallel as par
    from neptune_tpu_torch.solvers import krylov

    cheb = sys.modules["neptune_tpu_torch.solvers.chebyshev"]
    lam = dict(lam_min=lmin, lam_max=lmax)
    return {
        "cg_sharded s=8 chebyshev basis": (
            lambda cm, gm, maxiter=2000: par.cg_sharded(cm, "poisson", gm, s=8, basis="chebyshev",
                                                        maxiter=maxiter, tol=CA_TOL, **lam),
            lambda mv, b, g: krylov.cg(mv, b, tol=CA_TOL, maxiter=3500, group=g), 8, True),
        "gmres_sharded s=8 chebyshev basis": (
            lambda cm, gm: par.gmres_sharded(cm, "poisson", gm, s=8, basis="chebyshev",
                                             maxiter=2000, tol=CA_TOL, **lam),
            lambda mv, b, g: krylov.gmres(mv, b, tol=CA_TOL, maxiter=3500, restart=8, group=g),
            8, False),
        "bicgstab_sharded s=2": (
            lambda cm, gm: par.bicgstab_sharded(cm, "poisson", gm, s=2, maxiter=2000,
                                                tol=CA_TOL),
            lambda mv, b, g: krylov.bicgstab(mv, b, tol=CA_TOL, maxiter=3500, group=g), 2, False),
        "chebyshev_sharded k_fuse=8": (
            lambda cm, gm: par.chebyshev_sharded(cm, "poisson", gm, k_fuse=8,
                                                 maxiter=CA_CHEB_ITERS, tol=CA_TOL, **lam),
            # the group-free Chebyshev runs on a mesh of one process only
            (lambda mv, b, g: cheb.chebyshev(mv, b, tol=CA_TOL, maxiter=CA_CHEB_ITERS, **lam)
             if g is None else None), 8, True),
    }


def phase12_rank(rank: int, dev, sync) -> dict:
    """Phase 12 on one of phase 9's four processes: every CA case on a (2,2)
    mesh, and sharded_function on PHASE12_FUNCTIONS, each gathered."""
    import torch
    import torch.distributed as dist
    from neptune_tpu_torch import entry
    from neptune_tpu_torch.lowering.executor import CompiledModule
    from neptune_tpu_torch.parallel import GridMesh, sharded_function

    module, b, lmin, lmax = ca_system()
    gm = GridMesh((2, 2), ("x", "y"), device=dev)
    bl = gm.shard(b)
    # host milliseconds inside the mesh's communication, each call ending
    # with its received data on the card
    comm_ms = {"ring_shift": 0.0, "allreduce": 0.0}

    def timed(name):
        real = getattr(gm, name)

        def run(*a, **k):
            t0 = time.perf_counter()
            out = real(*a, **k)
            sync()
            comm_ms[name] += (time.perf_counter() - t0) * 1e3
            return out

        setattr(gm, name, run)

    timed("ring_shift")
    timed("allreduce")
    out = {"ca": [], "functions": []}
    for label, (make, *_) in ca_cases(lmin, lmax).items():
        solve = make(CompiledModule(module, "auto", dev), gm)
        for c in counters().values():
            c.reset()
        gm.sent_bytes = gm.staged_bytes = gm.shifts = gm.reductions = 0
        comm_ms.update(ring_shift=0.0, allreduce=0.0)
        dist.barrier()
        t0 = time.perf_counter()
        x, info = solve(bl)
        sync()
        row = {"label": label, "ms": (time.perf_counter() - t0) * 1e3, "iters": info.iters,
               "converged": info.converged, "shifts": gm.shifts, "reductions": gm.reductions,
               "sent_bytes": gm.sent_bytes, "staged_bytes": gm.staged_bytes,
               "launches": {c.name: c.count for c in counters().values() if c.count},
               "device": str(x.device), "shift_ms": comm_ms["ring_shift"],
               "reduce_ms": comm_ms["allreduce"]}
        xg = gm.gather(x)
        if rank == 0:
            A = CompiledModule(module, "torch", dev).opdef("poisson")
            bg = torch.from_numpy(b).to(dev)
            row["true_rel_residual"] = (
                torch.linalg.vector_norm(bg - A(xg)) / torch.linalg.vector_norm(bg)).item()
        out["ca"].append(row)
        dist.barrier()
    for label, builder, fname, mesh, n in PHASE12_FUNCTIONS:
        cm = getattr(entry, builder)(n, "float32", device=dev)
        gmf = GridMesh(mesh, ("x", "y"), device=dev)
        shape = cm.module.lookup(fname).ftype.inputs[0].shape
        u = np.random.default_rng(SEED + 2).standard_normal(shape, dtype=np.float32)
        f = sharded_function(cm, fname, gmf)
        ul = gmf.shard(u)
        dist.barrier()
        row = {"label": label, "ms": host_ms(lambda: f(ul), 3, sync)}
        y = f(ul)
        g = gmf.gather(y)
        if rank == 0:
            ug = torch.from_numpy(u).to(dev)
            whole = cm.function(fname)
            ref = whole(ug)
            row["whole_ms"] = host_ms(lambda: whole(ug), 3, sync)
            row["max_abs_err"] = (g - ref).abs().max().item()
            row["rel_err"] = (torch.linalg.vector_norm(g - ref)
                              / torch.linalg.vector_norm(ref)).item()
        out["functions"].append(row)
        del g, y, ul
        dist.barrier()
    return out


def card_dense_us(dev, s: int = 8) -> dict:
    """Microseconds per call of the coefficient space's dense factors on
    the card instead of the host: eigh, qr and a triangular solve of CA-CG's
    (2s+1)^2 and CA-GMRES's (s+1)^2 f32 Gram matrices, each call
    synchronised (the solver reads its result), and the read of such a Gram
    matrix from the card."""
    import torch

    rng = np.random.default_rng(SEED + 3)
    out = {}

    def per_call_us(fn, reps):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e6

    for m in (2 * s + 1, s + 1):
        V = rng.standard_normal((m, 4096)).astype(np.float32)
        Gd = torch.from_numpy(V @ V.T).to(dev)

        def card():
            _, Q = torch.linalg.eigh(Gd)
            q, r = torch.linalg.qr(Q[:, :s])
            y = torch.linalg.solve_triangular(r, q.T[:, :1], upper=True)
            torch.cuda.synchronize()
            return y

        out[f"dense_{m}"] = per_call_us(card, 50)
        out[f"read_{m}"] = per_call_us(lambda: Gd.cpu().numpy(), 200)
    return out


def phase12a(dev, module, b, lmin, lmax, gm, A):
    """Phase 12a: each CA case on the one-process mesh `gm`, kernel route
    against kernels-off route, beside its per-iteration counterpart.
    Returns ({label: iterations}, kernel-A window launches)."""
    import torch
    from neptune_tpu_torch.lowering import cuda_backend
    from neptune_tpu_torch.lowering.executor import CompiledModule
    from neptune_tpu_torch.parallel import shardmap_opdef

    bnorm = torch.linalg.vector_norm(b)
    launches, one = 0, {}
    for label, (make, counterpart, block, steady) in ca_cases(lmin, lmax).items():
        solve = make(CompiledModule(module, "auto", dev), gm)
        solve_off = make(CompiledModule(module, "torch", dev), gm)
        # single solves, not warmed: a solve lasts tenths of a second to
        # seconds, and kernel A's library is loaded by phase 1
        torch.cuda.synchronize()
        for c in counters().values():
            c.reset()
        t0 = time.perf_counter()
        x, info = solve(b)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n_win = cuda_backend.window_counter.count
        require(n_win > 0, f"phase 12a {label}: kernel A's window form not launched")
        launches += n_win
        x_off, info_off = solve_off(b)
        require(info.iters == info_off.iters and torch.equal(x, x_off),
                f"phase 12a {label}: kernel route {info.iters} iterations against kernels-off "
                f"{info_off.iters}, bitwise {torch.equal(x, x_off)}")
        rel = (torch.linalg.vector_norm(b - A(x)) / bnorm).item()
        require((info.converged and rel <= CA_TOL) if steady else rel <= CA_GROSS * CA_TOL,
                f"phase 12a {label}: converged {info.converged}, true relative residual {rel!r}")
        mv = shardmap_opdef(CompiledModule(module, "auto", dev), "poisson", gm)
        t0 = time.perf_counter()
        _, cinfo = counterpart(mv, b, None)
        torch.cuda.synchronize()
        c_ms = (time.perf_counter() - t0) * 1e3
        one[label] = info.iters
        if label == CA_PROFILED:
            # a trace of the solve's first CA_PROFILED_ITERS iterations:
            # the whole solve's trace takes tens of seconds to read
            short = make(CompiledModule(module, "auto", dev), gm, maxiter=CA_PROFILED_ITERS)
            kinds = kinds_profile(lambda: short(b), CA_PROFILED_ITERS)
            say(f"phase 12a {label} split of its first {CA_PROFILED_ITERS} iterations "
                "(torch.profiler), per iteration: " + "; ".join(
                    f"{k} {n:.1f} launches {k_ms:.4f} ms" for k, (n, k_ms) in sorted(kinds.items()))
                + f"; host wall of the whole solve {ms / info.iters:.3f} ms")
        say(f"phase 12a {label}, one process, tol {CA_TOL}: {info.iters} iterations (= kernels-off "
            f"route, bitwise equal), converged {info.converged}, true relative residual {rel!r}; "
            f"{ms:.1f} ms per solve, "
            f"{info.iters / ms * 1e3:.0f} iterations/s; kernel A's window form {n_win} launches "
            f"({n_win / info.iters:.2f} per iteration); per-iteration counterpart on the same "
            f"mesh {cinfo.iters} iterations in {c_ms:.1f} ms, {cinfo.iters / c_ms * 1e3:.0f} "
            f"iterations/s (CA/counterpart {info.iters / ms / (cinfo.iters / c_ms):.3f})")
    return one, launches


def phase12(dev, reports) -> int:
    """Phase 12: (a) each CA case on a one-process mesh on the card, on the
    kernel route against the kernels-off route, beside its per-iteration
    counterpart; (b) the four-process (2,2) runs made by phase 9's
    processes (`phase12_rank`), held to (a); sharded_function against the
    whole-grid function. Returns (a)'s kernel-A window-form launches."""
    import torch
    from neptune_tpu_torch.lowering.executor import CompiledModule
    from neptune_tpu_torch.parallel import GridMesh, ca_cg, ca_gmres

    t12 = time.perf_counter()
    module, b_np, lmin, lmax = ca_system()
    gm = GridMesh((1,), ("x",), device=dev)
    b = torch.from_numpy(b_np).to(dev)
    A = CompiledModule(module, "torch", dev).opdef("poisson")
    # the host's coefficient space, timed inside the solves: CA-CG's s
    # inner iterations and CA-GMRES's factor and least squares per block
    host_us = {"cg": [], "gmres": []}
    real = {"cg": ca_cg._cg_block, "gmres": ca_gmres._ls_update}

    def timed(key):
        def run(*a):
            t0 = time.perf_counter()
            out = real[key](*a)
            host_us[key].append((time.perf_counter() - t0) * 1e6)
            return out

        return run

    ca_cg._cg_block, ca_gmres._ls_update = timed("cg"), timed("gmres")
    try:
        one, launches = phase12a(dev, module, b, lmin, lmax, gm, A)
    finally:
        ca_cg._cg_block, ca_gmres._ls_update = real["cg"], real["gmres"]
    cs = card_dense_us(dev)
    say("phase 12 coefficient space per outer block (s=8, f32): on the host (NumPy, timed in "
        f"12a's solves) CA-CG {np.median(host_us['cg']):.1f} us, CA-GMRES "
        f"{np.median(host_us['gmres']):.1f} us (medians of {len(host_us['cg'])} and "
        f"{len(host_us['gmres'])} blocks); on the card eigh + qr + triangular solve alone "
        f"{cs['dense_17']:.1f} us (17^2), {cs['dense_9']:.1f} us (9^2), reading the Gram "
        f"matrix {cs['read_17']:.1f} us (17^2), {cs['read_9']:.1f} us (9^2)")

    rows = [r["phase12"] for r in reports]
    for i, (label, (_, _, block, steady)) in enumerate(ca_cases(lmin, lmax).items()):
        r = [row["ca"][i] for row in rows]
        r0 = r[0]
        iters = one[label]
        require(all(x["iters"] == r0["iters"] for x in r), f"phase 12b {label}: ranks disagree")
        require(all(x["device"].startswith("cuda") for x in r),
                f"phase 12b {label}: a result is not on the card")
        require(all(x["launches"].get("stencil_apply_window", 0) > 0 for x in r),
                f"phase 12b {label}: kernel A's window form not launched on every rank")
        rel = r0["true_rel_residual"]
        if steady:
            require(abs(r0["iters"] - iters) <= block,
                    f"phase 12b {label}: {r0['iters']} iterations against {iters} in one process")
        require((r0["converged"] and rel <= CA_TOL) if steady else rel <= CA_GROSS * CA_TOL,
                f"phase 12b {label}: converged {r0['converged']}, true relative residual {rel!r}")
        blocks = -(-r0["iters"] // block)
        say(f"phase 12b {label}, four processes (2,2): {r0['iters']} iterations (one process "
            f"{iters}), converged {r0['converged']}, true relative residual {rel!r}; "
            f"{r0['ms']:.1f} ms per "
            f"solve, {r0['iters'] / r0['ms'] * 1e3:.0f} iterations/s (rank 0, single solve), of "
            f"which {r0['shift_ms']:.1f} ms in ring shifts and {r0['reduce_ms']:.1f} ms in "
            f"reductions (host clock, each synchronised); per "
            f"outer block of {block}: {r0['shifts'] / blocks:.1f} ring shifts, "
            f"{r0['sent_bytes'] / blocks:.0f} B sent ({r0['staged_bytes'] / blocks:.0f} B "
            f"through host memory), {r0['reductions'] / blocks:.2f} reductions; rank-0 launches "
            f"{json.dumps(r0['launches'])}")
    for i, (label, *_rest) in enumerate(PHASE12_FUNCTIONS):
        r0 = rows[0]["functions"][i]
        require(r0["rel_err"] <= PHASE12_FN_TOL,
                f"phase 12b sharded_function {label}: relative error {r0['rel_err']!r}")
        say(f"phase 12b sharded_function {label}: gathered against the one-process "
            f"cm.function, max_abs_err {r0['max_abs_err']!r}, relative 2-norm error "
            f"{r0['rel_err']!r} (tolerance {PHASE12_FN_TOL}); per call (host clock, rank 0, "
            f"median [min, max] of 3) {r0['ms'][0]:.1f} [{r0['ms'][1]:.1f}, {r0['ms'][2]:.1f}] "
            f"ms, whole grid in one process {r0['whole_ms'][0]:.1f} [{r0['whole_ms'][1]:.1f}, "
            f"{r0['whole_ms'][2]:.1f}] ms")
    say(f"phase 12 kernel-A window-form launches (12a) {launches}; phase wall "
        f"{time.perf_counter() - t12:.1f} s")
    return launches


# ---- phase 13: multigrid, Chebyshev and Newton over a process mesh ---------
# Through `sharded_function` on a mesh of one process: (a) phase 11a's and
# 11b's CG + precond="mg" systems, each level's matvec kernel A's window form
# on its block; (b) build_ca_levels(k=2) on phase 11c's 512..16 hierarchy,
# multigrid_solve with the CA smoothers against per-matvec "cheb" smoothing
# over the same shardmap_opdef matvecs; (c) phase 11e's Chebyshev + Jacobi;
# (d) phase 10a's implicit Allen-Cahn step, with and without jacobian=. (e)
# runs (a) at 512^2, (b), and (d) at P13_AC_N4^2 in phase 9's four
# processes on (2,2).
P13_SYSTEMS = [s for s in MG_SYSTEMS if not s[0].startswith("11d")]
P13_CA_K, P13_AC_N4, P13_X_TOL = 2, 1024, 1e-5


class Recorded:
    """The infos that `getattr(module, name)`, a solver returning (x, info),
    returns while in a `with` block."""

    def __init__(self, module, name: str):
        self.module, self.name, self.infos = module, name, []

    def __enter__(self):
        self.real = real = getattr(self.module, self.name)

        def recording(*a, **k):
            x, info = real(*a, **k)
            self.infos.append(info)
            return x, info

        setattr(self.module, self.name, recording)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


class TreeReductions:
    """Calls of `utils.tree.allreduce`, through which every solver norm and
    inner product reduces (over a group or not), while in a `with` block."""

    def __enter__(self):
        from neptune_tpu_torch.utils import tree

        self.tree, self.real, self.count = tree, tree.allreduce, 0

        def counting(t, group=None):
            self.count += 1
            return self.real(t, group)

        tree.allreduce = counting
        return self

    def __exit__(self, *exc):
        self.tree.allreduce = self.real


def p13_mg_case(label, build, options, tol, dev, gm, routes=("auto", "torch")):
    """One precond="mg" system through sharded_function on `gm`: per route,
    after a first solve (which builds the hierarchy), one timed solve:
    {route: (x block, PCG iterations, ms, first ms, kernel-A launches by
    level shape, ring shifts, bytes sent, reductions)}."""
    import torch
    from neptune_tpu_torch.lowering.executor import CompiledModule
    from neptune_tpu_torch.parallel import sharded_function
    from neptune_tpu_torch.solvers import krylov

    module = mg_module(build, options, tol)
    shape = module.lookup("poisson").ftype.inputs[0].bounds.shape
    b = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        shape, dtype=np.float32))
    bl = gm.shard(b)
    out = {}
    with Recorded(krylov, "solve") as solves, ShapeLaunches() as shapes, \
            TreeReductions() as reductions:
        for route in routes:
            f = sharded_function(CompiledModule(module, route, dev), "solve", gm)
            _, first_ms = timed(lambda: f(bl))
            shapes.take()
            gm.shifts = gm.sent_bytes = reductions.count = 0
            x, ms = timed(lambda: f(bl))
            out[route] = (x, solves.infos[-1].iters, ms, first_ms, shapes.take(), gm.shifts,
                          gm.sent_bytes, reductions.count)
    return out, module, b


def p13_true_rel(module, x, b, dev) -> float:
    """||b - A x|| / ||b|| of a gathered solution, A on the kernels-off route."""
    import torch
    from neptune_tpu_torch.lowering.executor import CompiledModule

    A = CompiledModule(module, "torch", dev).opdef("poisson")
    return float(torch.linalg.vector_norm(b - A(x)) / torch.linalg.vector_norm(b))


def p13_example(ntt, dev, gm):
    """(b)'s system: phase 11c's hierarchy and rhs, this process's blocks:
    (compiled module, opdef names, b block, u* block)."""
    import torch

    cm = mg_example(ntt)
    names = [f"poisson{n}" for n in MG_EXAMPLE_SIZES]
    xs = torch.linspace(0.0, 1.0, MG_N, device=dev)
    X, Y = xs[:, None], xs[None, :]
    u_star = torch.sin(np.pi * X) * torch.sin(2 * np.pi * Y) * (X * (1 - X))
    u_star[0, :] = u_star[-1, :] = u_star[:, 0] = u_star[:, -1] = 0.0
    b = cm.opdef(names[0])(u_star)
    return cm, names, gm.shard(b), gm.shard(u_star)


def p13_ca_case(cm, names, bl, gm):
    """build_ca_levels(k=P13_CA_K) and multigrid_solve with its CA smoothers
    against per-matvec "cheb" smoothing over the same matvecs: (CA
    eligibility per level, {route: (x block, V-cycles, ms, ring shifts per
    cycle, reductions per cycle)})."""
    import torch
    from neptune_tpu_torch.parallel import build_ca_levels
    from neptune_tpu_torch.solvers import multigrid_solve

    lv = build_ca_levels(cm, names, gm, torch.zeros_like(bl), k=P13_CA_K)
    plain = [lvl._replace(ca_smooth=None, ca_smooth_zero=None, ca_k=0) for lvl in lv]
    out = {}
    for route, levels in (("ca", lv), ("per_matvec", plain)):
        # one solve each, not warmed: the kernels are built and loaded, and a
        # solve takes seconds
        gm.shifts = 0
        with TreeReductions() as reductions:
            (x, info), ms = timed(lambda levels=levels: multigrid_solve(
                [None] * len(names), bl, tol=MG_EXAMPLE_TOL, maxiter=MG_EXAMPLE_MAXIT,
                levels=levels, smoother="cheb", pre=P13_CA_K, post=P13_CA_K))
        require(info.converged, f"phase 13b {route}: {info}")
        out[route] = (x, info.iters, ms, gm.shifts / info.iters, reductions.count / info.iters)
    return [lvl.ca_smooth is not None for lvl in lv], out


def p13_allen_cahn(ntt, n, dev, gm, u0):
    """(d): phase 10a's Allen-Cahn step through sharded_function on gm,
    without and with jacobian=, beside the whole-grid function: {variant:
    (state block, Newton/GMRES iterations on the mesh, ms, whole-grid state,
    its iterations, its ms)}."""
    from neptune_tpu_torch.lowering import executor
    from neptune_tpu_torch.parallel import sharded_function

    ac = allen_cahn(ntt, n)
    ac.step(u0)
    ac.step_jac(u0)  # trace both functions into the module
    cm = ntt.get_context().compiled()
    ul = gm.shard(u0)
    out = {}
    with Recorded(executor, "newton_krylov") as newton:
        for variant in ("AC_step", "AC_step_jac"):
            f, whole = sharded_function(cm, variant, gm), cm.function(variant)
            f(ul)  # warm-up
            newton.infos.clear()
            x, ms = timed(lambda: f(ul))
            mesh_its = [(i.iters, i.krylov_iters) for i in newton.infos]
            newton.infos.clear()
            xw, w_ms = timed(lambda: whole(u0))
            w_its = [(i.iters, i.krylov_iters) for i in newton.infos]
            out[variant] = (x, mesh_its, ms, xw, w_its, w_ms)
    return out


def p13_ac_state(n, dev):
    """Phase 10a's initial state at n^2."""
    import torch

    xs = torch.linspace(0.0, 1.0, n, device=dev)
    noise = torch.from_numpy(np.random.default_rng(SEED + 4).standard_normal(
        (n, n), dtype=np.float32)).to(dev)
    return 0.9 * torch.sin(8 * np.pi * xs)[:, None] * torch.sin(8 * np.pi * xs)[None, :] \
        + 0.05 * noise


def phase13_rank(rank: int, dev) -> dict:
    """Phase 13e on one of phase 9's four processes, mesh (2,2): (a) at
    512^2, (b), and (d) at P13_AC_N4^2, each gathered."""
    import torch
    import torch.distributed as dist
    import neptune_tpu_torch as ntt
    from neptune_tpu_torch.parallel import GridMesh

    gm = GridMesh((2, 2), ("x", "y"), device=dev)
    out = {"mg": [], "ca": None, "ac": {}}
    for label, build, options, levels, tol in P13_SYSTEMS[:2]:
        dist.barrier()
        runs, module, b = p13_mg_case(label, build, options, tol, dev, gm, routes=("auto",))
        x, iters, ms, first_ms, by_shape, shifts, sent, reductions = runs["auto"]
        row = {"label": label, "iters": iters, "ms": ms, "first_ms": first_ms,
               "levels": len(by_shape), "shifts": shifts, "sent_bytes": sent,
               "reductions": reductions, "device": str(x.device)}
        xg = gm.gather(x)
        if rank == 0:
            row["true_rel"] = p13_true_rel(module, xg, b.to(dev), dev)
        out["mg"].append(row)
    dist.barrier()
    cm, names, bl, _ = p13_example(ntt, dev, gm)
    eligible, ca = p13_ca_case(cm, names, bl, gm)
    out["ca"] = {"eligible": eligible, **{
        route: {"iters": r[1], "ms": r[2], "shifts_per_cycle": r[3],
                "reductions_per_cycle": r[4]} for route, r in ca.items()}}
    xca, xpm = gm.gather(ca["ca"][0]), gm.gather(ca["per_matvec"][0])
    out["ca"]["rel_x"] = float(torch.linalg.vector_norm(xca - xpm) / torch.linalg.vector_norm(xpm))
    ntt.reset_context()
    dist.barrier()
    u0 = p13_ac_state(P13_AC_N4, dev)
    for variant, (x, its, ms, xw, w_its, w_ms) in p13_allen_cahn(
            ntt, P13_AC_N4, dev, gm, u0).items():
        xg = gm.gather(x)
        out["ac"][variant] = {
            "its": its, "ms": ms, "whole_its": w_its, "whole_ms": w_ms,
            "rel": float(torch.linalg.vector_norm(xg - xw) / torch.linalg.vector_norm(xw)),
        }
    ntt.reset_context()
    dist.barrier()
    return out


def phase13(ntt, dev, reports, p11) -> int:
    """Phase 13 on a mesh of one process, then (e) from phase 9's four
    processes (`phase13_rank`); p11 holds phase 11's whole-grid results.
    Returns the kernel-A window-form launches of (a)'s kernel routes."""
    import torch
    from neptune_tpu_torch.lowering import cuda_backend
    from neptune_tpu_torch.lowering.executor import CompiledModule
    from neptune_tpu_torch.parallel import GridMesh, sharded_function
    from neptune_tpu_torch.solvers import krylov

    t13 = time.perf_counter()
    gm = GridMesh((1,), ("x",), device=dev)
    launches = 0
    one = {}

    # ---- (a): precond="mg" through sharded_function, both routes
    for label, build, options, levels, tol in P13_SYSTEMS:
        before = cuda_backend.window_counter.count
        runs, module, b = p13_mg_case(label, build, options, tol, dev, gm)
        launches += cuda_backend.window_counter.count - before
        b = b.to(dev)
        on, off = runs["auto"], runs["torch"]
        rel = p13_true_rel(module, on[0], b, dev)
        route_pair(f"13a {label}", ((on[0], on[1], on[2], on[4]), (off[0], off[1], off[2], off[4])),
                   levels, rel, tol)
        whole = p11["whole"][label]
        require(abs(on[1] - whole) <= 1,
                f"13a {label}: {on[1]} PCG iterations against the whole grid's {whole}")
        one[label] = on[1]
        say(f"phase 13a sharded_function {label} on a mesh of one process, tol {tol}: {on[1]} "
            f"PCG iterations (= kernels-off route; whole-grid function, phase 11: {whole}), "
            f"bitwise equal to the kernels-off route, true relative residual {rel!r}; "
            f"{on[2]:.2f} ms per solve, {on[2] / on[1]:.3f} ms per PCG iteration (kernels-off "
            f"{off[2]:.2f} ms); first solve with the hierarchy build {on[3]:.1f} ms; kernel A's "
            f"window form per level {shapes_text(on[4])}")

    # ---- (b): the CA smoothers on 11c's hierarchy
    cm, names, bl, u_star = p13_example(ntt, dev, gm)
    eligible, ca = p13_ca_case(cm, names, bl, gm)
    ntt.reset_context()
    (x_ca, it_ca, ms_ca, sh_ca, red_ca), (x_pm, it_pm, ms_pm, sh_pm, red_pm) = (
        ca["ca"], ca["per_matvec"])
    rel_x = float(torch.linalg.vector_norm(x_ca - x_pm) / torch.linalg.vector_norm(x_pm))
    require(it_ca == it_pm and rel_x <= P13_X_TOL,
            f"13b: CA {it_ca} V-cycles against per-matvec {it_pm}, relative x difference {rel_x!r}")
    require(sh_ca < sh_pm, f"13b: ring shifts per cycle CA {sh_ca} against per-matvec {sh_pm}")
    say(f"phase 13b build_ca_levels(k={P13_CA_K}) on 11c's {MG_N}..{MG_EXAMPLE_SIZES[-1]} "
        f"hierarchy, one process: CA levels {eligible}; multigrid_solve cheb, tol "
        f"{MG_EXAMPLE_TOL}: CA {it_ca} V-cycles, per-matvec {it_pm}, relative x difference "
        f"{rel_x!r}; per cycle ring shifts CA {sh_ca:.1f}, per-matvec {sh_pm:.1f}, reductions "
        f"{red_ca:.1f} and {red_pm:.1f}; {ms_ca:.1f} ms per solve against {ms_pm:.1f} ms (max |x - u*| "
        f"{float((x_ca - u_star).abs().max()):.3e})")

    # ---- (c): 11e's Chebyshev through sharded_function
    module, whole_iters, x_whole = p11["cheb"]
    b = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (MG_N, MG_N), dtype=np.float32)).to(dev)
    rows = {}
    with Recorded(krylov, "solve") as solves:
        for route in ("auto", "torch"):
            f = sharded_function(CompiledModule(module, route, dev), "solve", gm)
            x, ms = timed(lambda: f(b))
            rows[route] = (x, solves.infos[-1].iters, ms)
    (x, iters, ms), (x_off, it_off, ms_off) = rows["auto"], rows["torch"]
    rel = p13_true_rel(module, x, b, dev)
    require(iters == it_off and torch.equal(x, x_off),
            f"13c: {iters} iterations against the kernels-off route's {it_off}")
    require(iters == whole_iters and rel <= 1.01 * MG_TOL,
            f"13c: {iters} iterations against the whole grid's {whole_iters}, true relative "
            f"residual {rel!r}")
    say(f"phase 13c sharded_function solver=chebyshev + Jacobi (11e's system), one process: "
        f"{iters} iterations (= kernels-off route, bitwise; whole grid {whole_iters}), true "
        f"relative residual {rel!r}, max |x - whole grid| "
        f"{float((x - x_whole).abs().max())!r}; {ms:.1f} ms per solve (kernels-off "
        f"{ms_off:.1f} ms)")

    # ---- (d): 10a's Allen-Cahn step through sharded_function
    u0 = p13_ac_state(AC_N, dev)
    for variant, (x, its, ms, xw, w_its, w_ms) in p13_allen_cahn(ntt, AC_N, dev, gm, u0).items():
        rel = float(torch.linalg.vector_norm(x - xw) / torch.linalg.vector_norm(xw))
        require(its == w_its and rel <= P13_X_TOL,
                f"13d {variant}: Newton/GMRES {its} against the whole grid's {w_its}, relative "
                f"state difference {rel!r}")
        newton_its = sum(i for i, _ in its)
        say(f"phase 13d sharded_function {variant} Allen-Cahn {AC_N}^2 f32, one process: Newton "
            f"and GMRES iterations {its} (= whole grid), relative state difference {rel!r}; "
            f"{ms:.1f} ms per step, {ms / newton_its:.1f} ms per Newton iteration (whole grid "
            f"{w_ms:.1f} ms per step)")
    ntt.reset_context()

    # ---- (e): four processes on (2,2)
    rows = [r["phase13"] for r in reports]
    r0 = rows[0]
    for i, (label, _, _, levels, tol) in enumerate(P13_SYSTEMS[:2]):
        r = [row["mg"][i] for row in rows]
        m = r[0]
        require(all(x["iters"] == m["iters"] for x in r), f"13e {label}: ranks disagree")
        require(all(x["device"].startswith("cuda") and x["levels"] == levels for x in r),
                f"13e {label}: kernel A's window form not on every level of every rank")
        require(abs(m["iters"] - one[label]) <= 1 and m["true_rel"] <= 1.01 * tol,
                f"13e {label}: {m['iters']} PCG iterations against {one[label]} on one process, "
                f"true relative residual {m['true_rel']!r}")
        say(f"phase 13e {label}, four processes (2,2): {m['iters']} PCG iterations (one process "
            f"{one[label]}), true relative residual {m['true_rel']!r}; {m['ms']:.1f} ms per "
            f"solve (rank 0), {m['ms'] / m['iters']:.2f} ms per PCG iteration; per PCG "
            f"iteration {m['shifts'] / m['iters']:.1f} ring shifts, "
            f"{m['sent_bytes'] / m['iters']:.0f} B sent, {m['reductions'] / m['iters']:.1f} "
            f"reductions; first solve with the hierarchy build {m['first_ms']:.1f} ms")
    c = r0["ca"]
    require(all(row["ca"]["eligible"] == eligible for row in rows),
            f"13e CA eligibility {[row['ca']['eligible'] for row in rows]} against {eligible}")
    require(c["ca"]["iters"] == c["per_matvec"]["iters"] and c["rel_x"] <= P13_X_TOL
            and abs(c["ca"]["iters"] - it_ca) <= 1,
            f"13e CA multigrid: {c}; one process {it_ca} V-cycles")
    say(f"phase 13e build_ca_levels(k={P13_CA_K}), four processes (2,2): CA levels "
        f"{c['eligible']} (= one process); CA {c['ca']['iters']} V-cycles, per-matvec "
        f"{c['per_matvec']['iters']} (one process {it_ca}), relative x difference {c['rel_x']!r}; "
        f"per cycle ring shifts CA {c['ca']['shifts_per_cycle']:.1f} against per-matvec "
        f"{c['per_matvec']['shifts_per_cycle']:.1f}, reductions {c['ca']['reductions_per_cycle']:.1f} "
        f"and {c['per_matvec']['reductions_per_cycle']:.1f}; {c['ca']['ms']:.1f} against "
        f"{c['per_matvec']['ms']:.1f} ms per solve (rank 0)")
    for variant, a in r0["ac"].items():
        require(a["its"] == a["whole_its"] and a["rel"] <= P13_X_TOL,
                f"13e {variant}: {a['its']} against the whole grid's {a['whole_its']}, relative "
                f"state difference {a['rel']!r}")
        say(f"phase 13e sharded_function {variant} Allen-Cahn {P13_AC_N4}^2, four processes "
            f"(2,2): Newton and GMRES iterations {a['its']} (= whole grid), relative state "
            f"difference {a['rel']!r}; {a['ms']:.1f} ms per step (whole grid {a['whole_ms']:.1f} "
            "ms)")
    say(f"phase 13 kernel-A window-form launches (13a) {launches}; phase wall "
        f"{time.perf_counter() - t13:.1f} s")
    return launches


# ---- phase 14: the rest of sharded_function, reverse mode and the dry run --
# Through sharded_function, each case on the kernel route and the kernels-off
# route, on a mesh of one process and (phase14_rank) on (2,2) in phase 9's
# four processes, where (a) and (b) take the kernel route only (the script's
# time budget): (a) phase 3's 512^2 f32 Poisson system with CG +
# precond="ssor" (phase 10d's tolerance); (b) bench.py's
# cg_poisson_512_mixed_1e10 (f64 Poisson, precision="mixed": f32 Jacobi-CG
# inner solves on the twin's sharded matvec; (2,2) runs it to the end at
# P14_MIXED_N4^2, and at 512^2 one refinement round whose inner CG stops at
# P14_MIXED_CAP iterations, on the kernel route, as the gloo round trips
# (15-26 ms per inner iteration) make the whole solve's 7929 take two
# minutes; one process runs that round too); (c) ssor_dense and direct at 64^2 f64, which
# the dense matrix limits; (d) the gradient of sum(w x) through
# differentiable_solve of the entry's heat_A + theta I at 512^2 (CG, the
# transposed solve through the sharded opdef's reverse rule); (e)
# dryrun_multichip(4) on the card.
P14_MIXED_N4, P14_MIXED_CAP, P14_DENSE_N, P14_DENSE_TOL = 32, 250, 64, 1e-10
P14_GRAD_N, P14_GRAD_TOL, P14_THETA = 512, 1e-6, 0.25


def p14_module(kind: str, n: int, inner_iters: int = MIXED_INNER_ITERS):
    """(a)-(c)'s program: @solve(b) on the 5-pt Poisson operator at n^2
    (mixed: inner solves of at most inner_iters iterations)."""
    from neptune_tpu_torch import stencils

    if kind == "ssor":
        return stencils.with_solve(stencils.poisson5(n), "poisson", solver="cg", tol=SSOR_TOL,
                                   max_iters=SSOR_MAXIT, precond="ssor")
    if kind == "mixed":
        return stencils.with_solve(stencils.poisson5(n, "float64"), "poisson", solver="cg",
                                   tol=MIXED_TOL, max_iters=inner_iters, precond="jacobi",
                                   precision="mixed")
    solve = dict(solver="direct") if kind == "direct" else dict(
        solver="cg", tol=P14_DENSE_TOL, max_iters=500, precond="ssor_dense")
    return stencils.with_solve(stencils.poisson5(n, "float64"), "poisson", **solve)


class OneRound:
    """`refine.refined_solve` capped at one refinement round while in a
    `with` block (the executor's mixed solve looks it up at each call)."""

    def __enter__(self):
        from neptune_tpu_torch.solvers import refine

        self.refine, self.real = refine, refine.refined_solve
        refine.refined_solve = lambda *a, **k: self.real(*a, **dict(k, max_rounds=1))
        return self

    def __exit__(self, *exc):
        self.refine.refined_solve = self.real


def p14_capped(dev, gm) -> tuple:
    """(b)'s 512^2 system, one refinement round whose inner CG stops at
    P14_MIXED_CAP iterations, on the kernel route, one unwarmed solve:
    ((x block, (rounds, inner iterations), ms, ring shifts, gathers,
    reductions, window-form launches), the true f64 relative residual of
    the gathered x, the whole grid's)."""
    with OneRound():
        runs, module, b = p14_solve_case("mixed", MIXED_N, dev, gm, routes=("auto",), warm=False,
                                         inner_iters=P14_MIXED_CAP)
        xw = p14_whole(module, b, dev)[0]
    bd = b.to(dev)
    x = runs["auto"][0]
    return runs["auto"], p13_true_rel(module, gm.gather(x), bd, dev), p13_true_rel(module, xw, bd,
                                                                                  dev)


def p14_solve_case(kind: str, n: int, dev, gm, routes=("auto", "torch"), warm=True,
                   inner_iters: int = MIXED_INNER_ITERS) -> dict:
    """One of (a)-(c) through sharded_function on gm: {route: (x block,
    iterations (Krylov iterations, or refinement rounds and inner
    iterations), ms, ring shifts, gathers, reductions, window-form
    launches)}, each route timed once (after one warm-up solve where warm),
    and the global rhs."""
    import torch
    from neptune_tpu_torch.lowering import cuda_backend
    from neptune_tpu_torch.lowering.executor import CompiledModule
    from neptune_tpu_torch.parallel import sharded_function
    from neptune_tpu_torch.solvers import krylov, refine

    module = p14_module(kind, n, inner_iters)
    dtype = np.float64 if kind in ("mixed", "ssor_dense", "direct") else np.float32
    b = torch.from_numpy(np.random.default_rng(SEED).standard_normal((n, n)).astype(dtype))
    bl = gm.shard(b)
    out = {}
    with Recorded(krylov, "solve") as solves, Recorded(refine, "refined_solve") as rounds, \
            TreeReductions() as reductions:
        for route in routes:
            f = sharded_function(CompiledModule(module, route, dev), "solve", gm)
            if warm:
                f(bl)
            solves.infos.clear()
            rounds.infos.clear()
            gm.shifts = gm.gathers = reductions.count = 0
            before = cuda_backend.window_counter.count
            x, ms = timed(lambda: f(bl))
            if kind == "mixed":
                its = (rounds.infos[-1].rounds, rounds.infos[-1].inner_iters)
            else:
                its = solves.infos[-1].iters if solves.infos else 1
            out[route] = (x, its, ms, gm.shifts, gm.gathers, reductions.count,
                          cuda_backend.window_counter.count - before)
    return out, module, b


def p14_whole(module, b, dev):
    """The whole-grid function on the kernel route, timed after a warm-up:
    (x, Krylov iterations or refinement info, ms)."""
    from neptune_tpu_torch.lowering.executor import CompiledModule
    from neptune_tpu_torch.solvers import krylov, refine

    f = CompiledModule(module, "auto", dev).function("solve")
    bd = b.to(dev)
    f(bd)
    with Recorded(krylov, "solve") as solves, Recorded(refine, "refined_solve") as rounds:
        x, ms = timed(lambda: f(bd))
    its = (rounds.infos[-1].rounds, rounds.infos[-1].inner_iters) if rounds.infos else (
        solves.infos[-1].iters if solves.infos else 1)
    return x, its, ms


def p14_grad(n: int, dev, gm, routes=("auto", "torch")) -> dict:
    """(d): the gradient of sum(w x), x = (heat_A + theta I)^-1 b by
    differentiable_solve over gm's group, in b and theta: {route: (b's
    gradient block, theta's gradient summed over the mesh, ms, window-form
    launches, rule calls)}; "whole": the whole grid's, kernel route."""
    import torch
    from neptune_tpu_torch import entry
    from neptune_tpu_torch.lowering import cuda_backend
    from neptune_tpu_torch.lowering.executor import CompiledModule, rule_counter
    from neptune_tpu_torch.parallel import shardmap_opdef
    from neptune_tpu_torch.solvers import differentiable_solve

    module = entry.build_step(n, "float32", device=dev).module
    rng = np.random.default_rng(SEED + 7)
    b, w = (torch.from_numpy(a) for a in rng.standard_normal((2, n, n), dtype=np.float32))
    out = {}
    for route in (*routes, "whole"):
        if route == "whole":
            mv, bb, ww, group = CompiledModule(module, "auto", dev).opdef("heat_A"), b.to(dev), \
                w.to(dev), None
        else:
            mv = shardmap_opdef(CompiledModule(module, route, dev), "heat_A", gm)
            bb, ww, group = gm.shard(b), gm.shard(w), gm.sum_group(2)

        def grad(mv=mv, bb=bb, ww=ww, group=group):
            bl = bb.clone().requires_grad_(True)
            theta = torch.tensor(P14_THETA, device=dev, requires_grad=True)
            x = differentiable_solve(lambda v: mv(v) + theta * v, bl, solver="cg",
                                     tol=P14_GRAD_TOL, maxiter=200, group=group)
            (ww * x).sum().backward()
            tg = theta.grad if group is None else gm.allreduce(theta.grad, 2)
            return bl.grad, tg

        grad()  # warm-up
        before = (cuda_backend.window_counter.count, rule_counter.count)
        (gb, gt), ms = timed(grad)
        out[route] = (gb, float(gt), ms, cuda_backend.window_counter.count - before[0],
                      rule_counter.count - before[1])
    return out


def p14_rel(a, b) -> float:
    import torch

    return float(torch.linalg.vector_norm(a.double() - b.double()) / torch.linalg.vector_norm(
        b.double()))


def phase14_rank(rank: int, dev) -> dict:
    """Phase 14 on one of phase 9's four processes, mesh (2,2): (a)-(d),
    each route's result gathered; rank 0 holds the whole grid's."""
    import torch
    import torch.distributed as dist
    from neptune_tpu_torch.parallel import GridMesh

    gm = GridMesh((2, 2), ("x", "y"), device=dev)
    out = {}
    for label, kind, n in (("a", "ssor", SSOR_N), ("b", "mixed", P14_MIXED_N4),
                           ("c ssor_dense", "ssor_dense", P14_DENSE_N),
                           ("c direct", "direct", P14_DENSE_N)):
        dist.barrier()
        # (a) and (b) on the kernel route only: the one-process part holds
        # their kernels-off routes (the script's time budget)
        routes = ("auto",) if label in ("a", "b") else ("auto", "torch")
        runs, module, b = p14_solve_case(kind, n, dev, gm, routes=routes, warm=False)
        (x, its, ms, sh, ga, red, win), off = runs["auto"], runs.get("torch")
        row = {"iters": its, "ms": ms, "shifts": sh, "gathers": ga, "reductions": red,
               "window": win, "off_iters": off and off[1], "off_ms": off and off[2],
               "bitwise": off and bool(torch.equal(x, off[0])), "device": str(x.device), "n": n}
        xg = gm.gather(x)
        if rank == 0:
            xw, w_its, w_ms = p14_whole(module, b, dev)
            row.update(whole_iters=w_its, whole_ms=w_ms, rel_whole=p14_rel(xg, xw))
            if kind == "mixed":
                row["true_rel"] = p13_true_rel(module, xg, b.to(dev), dev)
        out[label] = row
    dist.barrier()
    (x, its, ms, sh, ga, red, win), true_rel, whole_rel = p14_capped(dev, gm)
    out["b capped"] = {"iters": its, "ms": ms, "shifts": sh, "gathers": ga, "reductions": red,
                       "window": win, "device": str(x.device), "true_rel": true_rel,
                       "whole_rel": whole_rel}
    dist.barrier()
    g = p14_grad(P14_GRAD_N, dev, gm, routes=("auto", "torch"))
    (gb, gt, ms, win, rule), off = g["auto"], g["torch"]
    gbg = gm.gather(gb)
    row = {"ms": ms, "window": win, "rule": rule, "off_ms": off[2],
           "bitwise": bool(torch.equal(gb, off[0])) and gt == off[1]}
    if rank == 0:
        whole = g["whole"]
        row.update(rel_b=p14_rel(gbg, whole[0]), rel_theta=abs(gt - whole[1]) / abs(whole[1]),
                   whole_ms=whole[2])
    out["d"] = row
    dist.barrier()
    return out


def phase14(dev, reports) -> int:
    """Phase 14 on a mesh of one process, then (a)-(d) from phase 9's four
    processes (`phase14_rank`) and (e) the dry run. Returns the kernel-A
    window-form launches of the one-process kernel routes."""
    import torch
    from neptune_tpu_torch import entry
    from neptune_tpu_torch.parallel import GridMesh

    t14 = time.perf_counter()
    gm = GridMesh((1,), ("x",), device=dev)
    launches = 0
    one = {}
    for label, kind, n in (("a SSOR", "ssor", SSOR_N), ("b mixed", "mixed", MIXED_N),
                           ("c ssor_dense", "ssor_dense", P14_DENSE_N),
                           ("c direct", "direct", P14_DENSE_N)):
        # the mixed solve takes seconds: timed once, not warmed (the kernels
        # are built and loaded)
        runs, module, b = p14_solve_case(kind, n, dev, gm, warm=kind != "mixed")
        (x, its, ms, sh, ga, red, win), (x_off, its_off, ms_off, *_r) = runs["auto"], runs["torch"]
        launches += win
        xw, w_its, w_ms = p14_whole(module, b, dev)
        rel = p14_rel(x, xw)
        one[kind] = its
        require(torch.equal(x, x_off) and its == its_off,
                f"14{label}: kernel route {its} against the kernels-off route's {its_off}, "
                f"bitwise {torch.equal(x, x_off)}")
        txt = (f"phase 14{label} sharded_function {n}^2 on a mesh of one process: "
               f"{its} (= kernels-off route, bitwise; whole grid {w_its}), ")
        if kind == "ssor":
            require(abs(its - w_its) <= 1 and win > 0,
                    f"14a: {its} iterations against the whole grid's {w_its}, window form {win}")
            txt += f"true relative residual {p13_true_rel(module, x, b.to(dev), dev)!r}; "
        elif kind == "mixed":
            true_rel = p13_true_rel(module, x, b.to(dev), dev)
            require(its[0] == w_its[0] and true_rel <= MIXED_TOL and win >= its[1],
                    f"14b: rounds {its} against the whole grid's {w_its}, true relative residual "
                    f"{true_rel!r}, the f32 twin's window form {win} launches")
            txt += f"true f64 relative residual {true_rel!r}; "
        else:
            require(rel <= 1e-10, f"14{label}: relative difference from the whole grid {rel!r}")
        txt += (f"relative difference from the whole grid {rel!r}; {ms:.1f} ms per solve "
                f"(kernels-off {ms_off:.1f} ms, whole grid {w_ms:.1f} ms); per solve {sh} ring "
                f"shifts, {ga} gathers, {red} reductions; kernel A's window form {win} launches")
        say(txt)
    # (b) capped, as (2,2) runs it at 512^2
    (x, its1, ms, sh, ga, red, win), true1, whole1 = p14_capped(dev, gm)
    launches += win
    require(its1 == (1, P14_MIXED_CAP) and win >= its1[1],
            f"14b capped: {its1}, window form {win}")
    say(f"phase 14b capped {MIXED_N}^2 on a mesh of one process (one round, inner CG stopped at "
        f"{P14_MIXED_CAP}; kernel route, one unwarmed solve): {its1}, true f64 relative "
        f"residual {true1!r} (whole grid {whole1!r}); {ms:.1f} ms; {sh} ring shifts, {red} "
        f"reductions; kernel A's window form {win} launches")
    g = p14_grad(P14_GRAD_N, dev, gm)
    (gb, gt, ms, win, rule), (gb_off, gt_off, ms_off, *_r), whole = g["auto"], g["torch"], \
        g["whole"]
    launches += win
    rel_b, rel_t = p14_rel(gb, whole[0]), abs(gt - whole[1]) / abs(whole[1])
    require(torch.equal(gb, gb_off) and gt == gt_off and win > 0 and rule > 0,
            f"14d: kernel route against kernels-off route bitwise {torch.equal(gb, gb_off)}, "
            f"window form {win}, rule {rule}")
    require(rel_b <= 1e-5 and rel_t <= 1e-5, f"14d: relative gradient error {rel_b!r}, {rel_t!r}")
    say(f"phase 14d differentiable_solve gradient at {P14_GRAD_N}^2 f32 on a mesh of one process: "
        f"= kernels-off route bitwise; relative difference from the whole grid's gradient in b "
        f"{rel_b!r}, in theta {rel_t!r}; {ms:.1f} ms per gradient (kernels-off {ms_off:.1f} ms, "
        f"whole grid {whole[2]:.1f} ms); {rule} reverse/forward rule calls, kernel A's window "
        f"form {win} launches")

    # ---- (2,2), from phase 9's processes
    rows = [r["phase14"] for r in reports]
    r0 = rows[0]
    for label in ("a", "b", "c ssor_dense", "c direct"):
        r = [row[label] for row in rows]
        m = r0[label]
        require(all(x["iters"] == m["iters"] and x["device"].startswith("cuda")
                    and (m["off_ms"] is None or x["bitwise"] and x["off_iters"] == m["iters"])
                    for x in r),
                f"14{label} (2,2): ranks or routes disagree: {r}")
        if label == "a":
            require(all(x["window"] > 0 for x in r), f"14a (2,2): window form {r}")
            require(abs(m["iters"] - one["ssor"]) <= 1, f"14a (2,2): {m['iters']} against "
                    f"{one['ssor']} on one process")
        elif label == "b":
            require(all(x["window"] > 0 for x in r) and m["iters"][0] == m["whole_iters"][0]
                    and m["true_rel"] <= MIXED_TOL, f"14b (2,2): {m}")
        else:
            require(m["rel_whole"] <= 1e-10, f"14{label} (2,2): {m}")
        off_txt = ("kernel route only" if m["off_ms"] is None
                   else "= kernels-off route, bitwise")
        say(f"phase 14{label} four processes (2,2), {m['n']}^2: {m['iters']} ({off_txt}, every "
            f"rank; whole grid {m['whole_iters']}), relative difference "
            f"from the whole grid {m['rel_whole']!r}"
            + (f", true f64 relative residual {m['true_rel']!r}" if "true_rel" in m else "")
            + f"; {m['ms']:.1f} ms per solve (rank 0, one solve"
            + ("" if m["off_ms"] is None else f"; kernels-off {m['off_ms']:.1f} ms")
            + f"; whole grid {m['whole_ms']:.1f} ms); per solve {m['shifts']} ring shifts, "
            f"{m['gathers']} gathers, {m['reductions']} reductions; window form per rank "
            f"{[x['window'] for x in r]}")
    r = [row["b capped"] for row in rows]
    m = r0["b capped"]
    # the f32 inner CG's dot products sum over (2,2)'s blocks in another
    # order than over the whole grid: its residual after the same count of
    # iterations agrees to 1%
    require(all(x["iters"] == [1, P14_MIXED_CAP] and x["window"] >= P14_MIXED_CAP
                and x["device"].startswith("cuda") for x in r)
            and abs(m["true_rel"] - m["whole_rel"]) <= 0.01 * m["whole_rel"],
            f"14b capped (2,2): {r}")
    say(f"phase 14b capped four processes (2,2), {MIXED_N}^2 (one round, inner CG stopped at "
        f"{P14_MIXED_CAP}; kernel route, one unwarmed solve): {m['iters']} on every rank, true "
        f"f64 relative residual {m['true_rel']!r} (whole grid {m['whole_rel']!r}, one process "
        f"{true1!r}); {m['ms']:.1f} ms (rank 0), "
        f"{m['ms'] / m['iters'][1]:.2f} ms per inner iteration; {m['shifts']} ring shifts, "
        f"{m['reductions']} reductions; window form per rank {[x['window'] for x in r]}")
    d = [row["d"] for row in rows]
    d0 = d[0]
    require(all(x["bitwise"] and x["window"] > 0 and x["rule"] > 0 for x in d)
            and d0["rel_b"] <= 1e-5 and d0["rel_theta"] <= 1e-5, f"14d (2,2): {d}")
    say(f"phase 14d differentiable_solve gradient at {P14_GRAD_N}^2, four processes (2,2): = "
        f"kernels-off route bitwise on every rank; relative difference from the whole grid's "
        f"gradient in b {d0['rel_b']!r}, in theta {d0['rel_theta']!r}; {d0['ms']:.1f} ms per "
        f"gradient (rank 0; kernels-off {d0['off_ms']:.1f} ms, whole grid {d0['whole_ms']:.1f} "
        f"ms); window form per rank {[x['window'] for x in d]}")

    # ---- (e): the dry run on the card
    dry = entry.dryrun_multichip(4, dev.type)
    say(f"phase 14e dryrun_multichip(4) on the card: mesh {dry['mesh']}, {dry['backend']} on "
        f"{dry['device']}, all seven parts passed in {dry['wall_s']:.1f} s wall; rank 0 per part "
        + ", ".join(f"{k} {v:.2f} s" for k, v in dry["seconds"].items()))
    say(f"phase 14 kernel-A window-form launches (one process) {launches}; phase wall "
        f"{time.perf_counter() - t14:.1f} s")
    return launches


# ---- phase 15: odd blocks, the driver, the native oracle, profiling, the CLI -
# (a) precond="mg" where the blocks turn odd above the coarsest level, in
# phase 9's four processes: 1800^2 has levels 1800..225; on (2,2) the blocks
# of level 2 are 225 rows, on (4,1) those of level 1, so from there on every
# level runs on the whole grid, replicated on every process
P15_N, P15_TOL, P15_MAXIT, P15_X_TOL = 1800, 1e-3, 200, 1e-5
P15_MESHES = {(2, 2): 2, (4, 1): 1}  # mesh -> the first whole-grid level
P15_LEVELS = 4
# (b) the driver over entry()'s step
P15_STEPS, P15_EVERY = 40, 10
# (c) bench.py's native-oracle rows: (row, builder, inputs, bench.py's bound)
P15_NATIVE_ROWS = [
    ("f64_accuracy_vs_native", "heat_gmres_f64",
     lambda: [np.zeros((48, 48)), np.sin(np.linspace(0, np.pi, 48))[:, None]
              * np.cos(np.linspace(0, np.pi, 48))[None, :]], 1e-10),
    ("f64_bs_vs_native", "black_scholes",
     lambda: [np.zeros(32), np.maximum(np.linspace(0, 3.1, 32) - 1.0, 0.0)], 1e-10),
    ("f64_jfnk_vs_native", "allen_cahn_jfnk",
     lambda: [np.zeros(16), 0.9 * np.sin(np.linspace(0, 2 * np.pi, 16))], 1e-10),
]
P15_HEADLINE_N, P15_HEADLINE_TOL = 1024, 1e-6
# (d) the annotate span around the traced driver steps
P15_SPAN = "neptune_driver_two_steps"


def phase15_trace(argv) -> int:
    """chip_smoke.py --phase15-trace DIR: profiling.trace around two
    SimulationDriver steps of entry()'s step, after one warm-up step,
    writing DIR/trace/trace.json and kernel B's launches in the two steps
    to DIR/launches.json. Phase 15d runs it in a process of its own: late
    in a long process torch.profiler can miss launches (PERF.md, open
    questions)."""
    import torch

    sys.path.insert(0, str(ROOT))
    from neptune_tpu_torch import entry
    from neptune_tpu_torch.solvers import fused
    from neptune_tpu_torch.utils import profiling
    from neptune_tpu_torch.utils.driver import SimulationDriver

    out = Path(argv[0])
    dev = torch.device("cuda")
    fn = entry.build_step(256, "float32", device=dev).function("step")
    u0 = torch.from_numpy(entry.gaussian(256)).to(dev)

    def step(s):
        return {"u": fn(s["u"])}

    fn(u0)
    before = fused.counter.count
    with profiling.trace(out / "trace"):
        with profiling.annotate(P15_SPAN):
            SimulationDriver(step, out / "c.npz", 2).run({"u": u0}, 2)
        torch.cuda.synchronize()
    (out / "launches.json").write_text(json.dumps(fused.counter.count - before))
    return 0


def p15_module():
    from neptune_tpu_torch import stencils

    return stencils.with_solve(stencils.poisson5(P15_N), "poisson", solver="cg", tol=P15_TOL,
                               max_iters=P15_MAXIT, precond="mg")


def phase15_rank(rank: int, dev) -> dict:
    """Phase 15a on one of phase 9's four processes: the 1800^2 MG-PCG
    through sharded_function on each mesh of P15_MESHES, the kernel route
    (a first solve builds the hierarchy, a second is timed) and the
    kernels-off route; rank 0 also solves on the whole grid in one process
    and compares the gathered x."""
    import torch
    import torch.distributed as dist
    from neptune_tpu_torch.lowering.executor import CompiledModule
    from neptune_tpu_torch.parallel import GridMesh, sharded_function
    from neptune_tpu_torch.solvers import krylov

    module = p15_module()
    b = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (P15_N, P15_N), dtype=np.float32))
    out = {"whole": None, "meshes": []}
    with Recorded(krylov, "solve") as solves, ShapeLaunches(forms=True) as forms, \
            TreeReductions() as reductions:
        if rank == 0:
            f = CompiledModule(module, "auto", dev).function("solve")
            f(b.to(dev))
            x_whole, ms = timed(lambda: f(b.to(dev)))
            out["whole"] = {"iters": solves.infos[-1].iters, "ms": ms}
        dist.barrier()
        for mesh in P15_MESHES:
            gm = GridMesh(mesh, ("x", "y"), device=dev)
            bl = gm.shard(b)
            row, xs = {"mesh": list(mesh)}, {}
            for route in ("auto", "torch"):
                dist.barrier()
                f = sharded_function(CompiledModule(module, route, dev), "solve", gm)
                _, first_ms = timed(lambda: f(bl)) if route == "auto" else (None, None)
                forms.take()
                gm.shifts = gm.gathers = reductions.count = 0
                xs[route], ms = timed(lambda: f(bl))
                row[route] = {
                    "iters": solves.infos[-1].iters, "ms": ms, "first_ms": first_ms,
                    "launches": forms.take(), "shifts": gm.shifts, "gathers": gm.gathers,
                    "reductions": reductions.count, "device": str(xs[route].device),
                }
            row["bitwise"] = bool(torch.equal(xs["auto"], xs["torch"]))
            xg = gm.gather(xs["auto"])
            if rank == 0:
                row["rel_whole"] = float(torch.linalg.vector_norm(xg - x_whole)
                                         / torch.linalg.vector_norm(x_whole))
                row["true_rel"] = p13_true_rel(module, xg, b.to(dev), dev)
            out["meshes"].append(row)
            del xg, xs
            dist.barrier()
    return out


def phase15(dev, reports, heat_cm, step_ms: float) -> dict:
    """Phase 15: (a) from phase 9's four processes (`phase15_rank`); (b) the
    simulation driver; (c) the native oracle; (d) profiling and the CLI.
    Returns the kernels' launches in (a) rank 0, (b) and (c)."""
    import shutil
    import tempfile

    import torch
    from neptune_tpu_torch import entry, stencils
    from neptune_tpu_torch.ir import print_module
    from neptune_tpu_torch.lowering import cuda_backend
    from neptune_tpu_torch.lowering.executor import CompiledModule
    from neptune_tpu_torch.passes import compile_ir
    from neptune_tpu_torch.runtime import compile_native
    from neptune_tpu_torch.solvers import fused
    from neptune_tpu_torch.utils.driver import SimulationDriver

    t15 = time.perf_counter()
    launches = {"stencil_apply": 0, "stencil_apply_window": 0, "fused_cg": 0}

    # ---- (a): odd blocks, four processes
    rows = [r["phase15"] for r in reports]
    whole = rows[0]["whole"]
    for i, (mesh, first_whole) in enumerate(P15_MESHES.items()):
        r = [row["meshes"][i] for row in rows]
        m = r[0]
        on, off = m["auto"], m["torch"]
        sharded = {f"window {P15_N >> lvl}" for lvl in range(first_whole)}
        replicated = {f"whole {P15_N >> lvl}" for lvl in range(first_whole, P15_LEVELS)}
        for x in r:
            require(x["bitwise"] and x["auto"]["iters"] == x["torch"]["iters"] == on["iters"],
                    f"15a {mesh}: routes or ranks disagree: {r}")
            require(x["auto"]["device"].startswith("cuda") and not x["torch"]["launches"],
                    f"15a {mesh}: {x}")
            require(set(x["auto"]["launches"]) == sharded | replicated,
                    f"15a {mesh}: kernel A's forms by level {x['auto']['launches']}, want "
                    f"the window form on {sorted(sharded)} and the whole grid on "
                    f"{sorted(replicated)}")
        require(abs(on["iters"] - whole["iters"]) <= 1 and m["rel_whole"] <= P15_X_TOL
                and m["true_rel"] <= 1.01 * P15_TOL,
                f"15a {mesh}: {on['iters']} PCG iterations against the whole grid's "
                f"{whole['iters']}, x within {m['rel_whole']!r}, true relative residual "
                f"{m['true_rel']!r}")
        launches["stencil_apply_window"] += sum(
            v for k, v in on["launches"].items() if k.startswith("window"))
        launches["stencil_apply"] += sum(
            v for k, v in on["launches"].items() if k.startswith("whole"))
        its = on["iters"]
        say(f"phase 15a sharded_function {P15_N}^2 f32 CG + precond=mg, tol {P15_TOL}, four "
            f"processes {mesh}, whole grid from level {first_whole}: {its} PCG iterations "
            f"(= kernels-off route, bitwise, on every rank; one process, whole grid: "
            f"{whole['iters']}), x within {m['rel_whole']!r} of the whole grid's, true "
            f"relative residual {m['true_rel']!r}; {on['ms']:.1f} ms per solve (rank 0), "
            f"{on['ms'] / its:.2f} ms per PCG iteration (kernels-off {off['ms'] / its:.2f}; "
            f"whole grid {whole['ms'] / whole['iters']:.2f}); per PCG iteration "
            f"{on['gathers'] / its:.2f} gathers, {on['shifts'] / its:.1f} ring shifts, "
            f"{on['reductions'] / its:.1f} reductions; kernel A per level (rank 0) "
            f"{json.dumps(on['launches'], sort_keys=True)}; first solve with the hierarchy "
            f"build {on['first_ms']:.1f} ms")

    work = Path(tempfile.mkdtemp(prefix="nt_phase15_"))
    try:
        # ---- (b): the driver over entry()'s implicit heat step
        fn = heat_cm.function("step")
        u0 = torch.from_numpy(entry.gaussian(256)).to(dev)

        def step(s):
            return {"u": fn(s["u"])}

        fn(u0)
        before = fused.counter.count
        (whole_run, n), ms = timed(lambda: SimulationDriver(step, work / "a.npz", P15_EVERY).run(
            {"u": u0}, P15_STEPS))
        b_launches = fused.counter.count - before
        _, stopped = SimulationDriver(step, work / "b.npz", P15_EVERY).run(
            {"u": u0}, P15_STEPS, walltime_budget_s=1e-9)
        resumed, n2 = SimulationDriver(step, work / "b.npz", P15_EVERY).run({"u": u0}, P15_STEPS)
        require(n == n2 == P15_STEPS and stopped == P15_EVERY and b_launches == P15_STEPS,
                f"15b: steps {n}, {stopped} then {n2}; kernel B launched {b_launches} times")
        require(resumed["u"].is_cuda and torch.equal(resumed["u"], whole_run["u"]),
                "15b: the resumed run is not bitwise the uninterrupted one")
        launches["fused_cg"] += b_launches
        say(f"phase 15b SimulationDriver over entry()'s step (256^2 f32): {P15_STEPS} steps, a "
            f"checkpoint every {P15_EVERY}; kernel B {b_launches} launches; {ms / n:.3f} ms per "
            f"step with checkpoints (entry() step, phase 4: {step_ms:.3f} ms); stopped by "
            f"walltime_budget_s after step {stopped}, resumed to {n2}: bitwise the "
            "uninterrupted run")

        # ---- (c): the native oracle
        for row, builder, inputs, bound in P15_NATIVE_ROWS:
            module = getattr(stencils, builder)()
            args = inputs()
            f = compile_ir(module, device=dev).function("entry")
            got, card_ms = timed(lambda: f(*[torch.from_numpy(a).to(dev) for a in args]))
            t0 = time.perf_counter()
            native = compile_native(module)
            build_s = time.perf_counter() - t0
            want = native.function("entry")(*args)
            d = float((got.cpu() - want).abs().max())
            require(got.is_cuda and got.dtype == torch.float64 and d <= bound,
                    f"15c {row}: max |diff| {d!r} against the native runtime")
            say(f"phase 15c {row}: the port in f64 on the card (kernel A for its rank-2 and "
                f"rank-3 applies) against compile_native, "
                f"max |diff| {d!r} (bound {bound}); card {card_ms:.1f} ms, native build "
                f"{build_s:.1f} s")
        n = P15_HEADLINE_N
        m32 = stencils.with_entry(stencils.jacobi5((n, n)), "jacobi")
        m64 = stencils.with_entry(stencils.jacobi5((n, n), "float64"), "jacobi")
        x = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
            (n, n), dtype=np.float32)).to(dev)
        before = cuda_backend.counter.count
        y = CompiledModule(m32, "auto", dev).function("entry")(x)
        a_launches = cuda_backend.counter.count - before
        ref = compile_native(m64).function("entry")(x)
        rel = float((y.cpu().double() - ref).abs().max() / ref.abs().max())
        require(a_launches == 1 and rel <= P15_HEADLINE_TOL,
                f"15c headline: {a_launches} kernel-A launches, relative error {rel!r}")
        launches["stencil_apply"] += a_launches
        say(f"phase 15c headline 5-pt Jacobi {n}^2 f32 on kernel A against the native f64 "
            f"apply: max relative error {rel!r} (bound {P15_HEADLINE_TOL})")

        # ---- (d): profiling and the CLI, each in a process of its own
        t0 = time.perf_counter()
        traced = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--phase15-trace", str(work)],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
        )
        trace_s = time.perf_counter() - t0
        require(traced.returncode == 0, f"15d trace process exited {traced.returncode}:\n"
                f"{traced.stderr[-3000:]}")
        events = json.loads((work / "trace" / "trace.json").read_text())["traceEvents"]
        names = {str(e.get("name", "")) for e in events}
        kernel_b = [nm for nm in names if "nt_fused_cg_kernel" in nm]
        b_traced = json.loads((work / "launches.json").read_text())
        require(b_traced == 2 and kernel_b and P15_SPAN in names,
                f"15d: kernel B launched {b_traced} times; the trace holds {len(events)} "
                f"events, kernel B's {kernel_b}, the span: {P15_SPAN in names}")
        say(f"phase 15d profiling.trace around two driver steps (a process of its own, "
            f"{trace_s:.1f} s): {len(events)} events, kernel B as {kernel_b[0]!r}, the "
            "annotate span present")
        ntir, xin = work / "jacobi5.ntir", work / "x.npy"
        ntir.write_text(print_module(m32))
        np.save(xin, x.cpu().numpy())
        want = f"checksum={float(y.cpu().numpy().sum()):.10g}"
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "neptune_tpu_torch.tools.opt", str(ntir), "--run", "entry",
             "--inputs", str(xin), "--plan", "2x2"],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=str(ROOT)),
        )
        cli_s = time.perf_counter() - t0
        require(cli.returncode == 0, f"15d neptune-opt-torch exited {cli.returncode}:\n"
                f"{cli.stderr[-3000:]}")
        got = [ln.split()[-1] for ln in cli.stdout.splitlines() if "checksum=" in ln]
        require(got == [want] and "kernels on the whole grid: kernel A (stencil_apply)"
                in cli.stdout and "local block=512x512" in cli.stdout,
                f"15d neptune-opt-torch: {got} against the in-process {want}:\n"
                f"{cli.stdout[-2000:]}")
        say(f"phase 15d neptune-opt-torch --run entry (5-pt {n}^2 f32, on the card) --plan 2x2: "
            f"{got[0]} (= the in-process call's), the plan names kernel A; {cli_s:.1f} s "
            "with the process start")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say(f"phase 15 launches {json.dumps(launches)}; phase wall {time.perf_counter() - t15:.1f} s")
    return launches


# ---- phase 16: pinned arithmetic on the card --------------------------------
# (a) tests/test_scale_stability.py's system, 256^2 f64 5-pt Poisson, CG to
# 1e-8 over sharded_opdef with the mesh's layout (GridMesh.mesh_group), in
# pinned arithmetic: on the whole grid in one process, on a mesh of one
# process, and on (2,2) and (4,1) in phase 9's four processes; the same
# solves in default arithmetic beside them. (b) its f32 adv4 operator at
# 4096^2, 50 applies, on the same meshes, and on the kernel route against
# the kernels-off route. (c) the cost: 1024^2 f32 Poisson CG, 300 iterations
# (tol 0), default against pinned, in one process.
P16_N, P16_TOL, P16_MAXIT = 256, 1e-8, 3000
P16_MESHES = ((2, 2), (4, 1))
P16_ADV_N, P16_STEPS = 4096, 50
P16_COST_N, P16_COST_ITERS = 1024, 300


def p16_rhs(n: int):
    """test_scale_stability._rhs: standard normal, zero on the ring."""
    b = np.random.default_rng(7).standard_normal((n, n))
    b[0, :] = b[-1, :] = b[:, 0] = b[:, -1] = 0.0
    return b


def digest(t) -> str:
    """A short hash of a tensor's bytes: equal digests, equal bits."""
    import hashlib

    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()[:16]


class Arithmetic:
    """`config.pinned_arithmetic` set to `pinned` while in a `with` block."""

    def __init__(self, pinned: bool):
        self.pinned = pinned

    def __enter__(self):
        from neptune_tpu_torch.config import config

        self.config, self.old = config, config.pinned_arithmetic
        config.pinned_arithmetic = self.pinned
        return self

    def __exit__(self, *exc):
        self.config.pinned_arithmetic = self.old


def p16_cg(dev, gm, pinned: bool) -> tuple:
    """(16a's x, gathered whole, and its row) on mesh gm (None: the whole
    grid in this process) in pinned or default arithmetic."""
    import torch
    from neptune_tpu_torch import stencils
    from neptune_tpu_torch.lowering.executor import CompiledModule
    from neptune_tpu_torch.parallel import sharded_opdef
    from neptune_tpu_torch.solvers import krylov

    cm = CompiledModule(stencils.poisson5(P16_N, "float64"), "auto", dev)
    b = torch.from_numpy(p16_rhs(P16_N)).to(dev)
    with Arithmetic(pinned):
        if gm is None:
            (x, info), ms = timed(lambda: krylov.cg(cm.opdef("poisson"), b, tol=P16_TOL,
                                                    maxiter=P16_MAXIT))
            gathers = 0
        else:
            mv, bl = sharded_opdef(cm, "poisson", gm), gm.shard(b)
            gm.gathers = 0
            (x, info), ms = timed(lambda: krylov.cg(mv, bl, tol=P16_TOL, maxiter=P16_MAXIT,
                                                    group=gm.mesh_group(2)))
            gathers = gm.gathers
            x = gm.gather(x)
    return x, {"iters": info.iters, "converged": info.converged, "ms": ms, "gathers": gathers,
               "digest": digest(x), "device": str(x.device)}


def p16_adv(dev, gm, route: str = "auto") -> tuple:
    """(16b's result after P16_STEPS pinned applies, and its row with kernel
    A's launches by form) on mesh gm (None: the whole grid). On a mesh the
    result is this process's block, its digest the block's."""
    import torch
    from neptune_tpu_torch import stencils
    from neptune_tpu_torch.lowering import cuda_backend
    from neptune_tpu_torch.lowering.executor import CompiledModule
    from neptune_tpu_torch.parallel import sharded_opdef

    n = P16_ADV_N
    cm = CompiledModule(stencils.advection4((n, n)), route, dev)
    u = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (n, n), dtype=np.float32)).to(dev)
    with Arithmetic(True):
        f = cm.opdef("adv4") if gm is None else sharded_opdef(cm, "adv4", gm)
        if gm is not None:
            u = gm.shard(u)
        f(u)  # warm-up: builds or loads the kernel
        before = (cuda_backend.counter.count, cuda_backend.window_counter.count)

        def run(v=u):
            for _ in range(P16_STEPS):
                v = f(v)
            return v

        u, ms = timed(run)
        launches = {"stencil_apply": cuda_backend.counter.count - before[0],
                    "stencil_apply_window": cuda_backend.window_counter.count - before[1]}
    return u, {"digest": digest(u), "ms": ms, "launches": launches, "device": str(u.device)}


def phase16_rank(rank: int, dev) -> dict:
    """Phase 16 (a) and (b) on one of phase 9's four processes, on each mesh
    of P16_MESHES; rank 0 also solves on the whole grid in default
    arithmetic, for the default solutions' difference across meshes."""
    import torch
    import torch.distributed as dist
    from neptune_tpu_torch.parallel import GridMesh

    out = {"meshes": []}
    xd_whole = p16_cg(dev, None, False)[0] if rank == 0 else None
    # the adv4 result on the whole grid, whose block each mesh's must equal
    u_whole, adv_whole = p16_adv(dev, None)
    for mesh in P16_MESHES:
        gm = GridMesh(mesh, ("x", "y"), device=dev)
        walls = {}
        dist.barrier()
        t0 = time.perf_counter()
        _, pinned = p16_cg(dev, gm, True)
        walls["pinned"] = time.perf_counter() - t0
        rec = {"mesh": list(mesh)}
        if mesh == P16_MESHES[0]:  # default arithmetic on one mesh (the time budget)
            dist.barrier()
            t0 = time.perf_counter()
            x_def, rec["default"] = p16_cg(dev, gm, False)
            walls["default"] = time.perf_counter() - t0
            if rank == 0:
                rec["default"]["diff_whole"] = float((x_def - xd_whole).abs().max())
        dist.barrier()
        t0 = time.perf_counter()
        u, adv = p16_adv(dev, gm)
        adv["whole_digest"] = adv_whole["digest"]
        adv["bitwise"] = bool(torch.equal(u, u_whole[gm.block_slices(tuple(u_whole.shape))]))
        walls["adv4"] = time.perf_counter() - t0
        out["meshes"].append(rec | {"pinned": pinned, "adv4": adv, "walls": walls})
        dist.barrier()
    return out


def phase16_dots(argv) -> int:
    """chip_smoke.py --phase16-dots: print `pinned_dot_launches` as JSON.
    Phase 16c runs it in a process of its own: late in a long process
    torch.profiler can miss launches (PERF.md, open questions)."""
    import torch

    sys.path.insert(0, str(ROOT))
    print(json.dumps(pinned_dot_launches(torch.device("cuda"))))
    return 0


def pinned_dot_launches(dev) -> dict:
    """CUDA kernels one 1024^2 f32 `tdot` launches, default and pinned, from
    a torch.profiler trace (None where the trace holds no device event)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from neptune_tpu_torch.utils import tree

    g = torch.Generator(device=dev).manual_seed(SEED)
    a = torch.randn(P16_COST_N, P16_COST_N, device=dev, generator=g)
    b = torch.randn(P16_COST_N, P16_COST_N, device=dev, generator=g)
    out = {}
    for pinned in (False, True):
        with Arithmetic(pinned):
            tree.tdot_f64(a, b)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                tree.tdot_f64(a, b)
                torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
        out["pinned" if pinned else "default"] = n or None
    return out


def phase16(dev, reports) -> dict:
    """Phase 16: (a) and (b) in this process and from phase 9's four
    (`phase16_rank`), (c) in this process. Returns kernel A's launches by
    form on the main path's runs (this process and rank 0)."""
    import torch
    from neptune_tpu_torch import stencils
    from neptune_tpu_torch.lowering import cuda_backend
    from neptune_tpu_torch.lowering.executor import CompiledModule
    from neptune_tpu_torch.parallel import GridMesh
    from neptune_tpu_torch.solvers import krylov

    t16 = time.perf_counter()
    launches = {"stencil_apply": 0, "stencil_apply_window": 0}
    rows = [r["phase16"] for r in reports]
    one = GridMesh((1, 1), ("x", "y"), device=dev)

    # ---- (a): CG, pinned and default, on every mesh
    x_whole, whole = p16_cg(dev, None, True)
    x_one, on_one = p16_cg(dev, one, True)
    xd_whole, whole_d = p16_cg(dev, None, False)
    xd_one, one_d = p16_cg(dev, one, False)
    runs = {"whole grid": whole, "(1,1)": on_one}
    for i, mesh in enumerate(P16_MESHES):
        for r, row in enumerate(rows):
            m = row["meshes"][i]
            runs[f"{tuple(mesh)} rank {r}"] = m["pinned"]
    for label, run in runs.items():
        require(run["converged"] and run["iters"] == whole["iters"]
                and run["digest"] == whole["digest"] and run["device"].startswith("cuda"),
                f"16a {label}: {run['iters']} iterations, x {run['digest']} against the whole "
                f"grid's {whole['iters']}, {whole['digest']}")
    d_diff = max([float((xd_whole - xd_one).abs().max())]
                 + [m["default"]["diff_whole"] for m in rows[0]["meshes"] if "default" in m])
    d_iters = [whole_d["iters"], one_d["iters"]] + [
        m["default"]["iters"] for m in rows[0]["meshes"] if "default" in m]
    m22 = rows[0]["meshes"][0]
    p22, d22 = m22["pinned"], m22["default"]
    say(f"phase 16a pinned CG 256^2 f64 Poisson, tol {P16_TOL}: {whole['iters']} iterations and "
        f"x bitwise equal (sha256 {whole['digest']}) on the whole grid, on a mesh of one "
        f"process and on {', '.join(map(str, P16_MESHES))} on every rank; default arithmetic "
        f"beside it: iterations {d_iters} (whole, (1,1), {P16_MESHES[0]}), max |x diff| against "
        f"the whole grid {d_diff!r}; whole grid {whole['ms']:.1f} ms pinned, "
        f"{whole_d['ms']:.1f} ms default ({whole['ms'] / whole['iters']:.3f} and "
        f"{whole_d['ms'] / whole_d['iters']:.3f} ms per iteration); (2,2) rank 0 "
        f"{p22['ms'] / p22['iters']:.2f} ms per iteration pinned with "
        f"{p22['gathers'] / p22['iters']:.2f} gathers per iteration, "
        f"{d22['ms'] / d22['iters']:.2f} ms default; rank 0's wall per mesh (s) "
        + ", ".join(f"{tuple(m['mesh'])}: {json.dumps({k: round(v, 1) for k, v in m['walls'].items()})}"
                    for m in rows[0]["meshes"]))

    # ---- (b): 50 pinned applies of adv4 at 4096^2
    u_whole, adv_whole = p16_adv(dev, None)
    u_off, adv_off = p16_adv(dev, None, "torch")
    u_one, adv_one = p16_adv(dev, one)
    require(torch.equal(u_whole, u_off) and adv_off["launches"] == {
        "stencil_apply": 0, "stencil_apply_window": 0},
        f"16b: kernel route != kernels-off route, or the kernels-off route launched {adv_off}")
    require(adv_whole["launches"]["stencil_apply"] == P16_STEPS
            and adv_one["launches"]["stencil_apply_window"] == P16_STEPS
            and adv_one["digest"] == adv_whole["digest"],
            f"16b: whole grid {adv_whole}, mesh of one {adv_one}")
    launches["stencil_apply"] += P16_STEPS
    launches["stencil_apply_window"] += P16_STEPS
    for i, mesh in enumerate(P16_MESHES):
        for r, row in enumerate(rows):
            a = row["meshes"][i]["adv4"]
            require(a["bitwise"] and a["whole_digest"] == adv_whole["digest"]
                    and a["launches"]["stencil_apply_window"] > 0,
                    f"16b {mesh} rank {r}: {a}, the whole grid here {adv_whole['digest']}")
        launches["stencil_apply_window"] += rows[0]["meshes"][i]["adv4"]["launches"][
            "stencil_apply_window"]
    say(f"phase 16b pinned adv4 {P16_ADV_N}^2 f32, {P16_STEPS} applies: bitwise equal (sha256 "
        f"{adv_whole['digest']}) on the kernel route, the kernels-off route, a mesh of one "
        f"process and {', '.join(map(str, P16_MESHES))} (every rank's block against the whole "
        f"grid's, which every rank computed to this digest too); kernel A "
        f"{adv_whole['launches']['stencil_apply']} launches on the whole grid, its window form "
        f"{adv_one['launches']['stencil_apply_window']} on the mesh of one and per rank "
        + ", ".join(f"{tuple(m)}: {[r['meshes'][i]['adv4']['launches']['stencil_apply_window'] for r in rows]}"
                    for i, m in enumerate(P16_MESHES))
        + f"; {adv_whole['ms'] / P16_STEPS:.4f} ms per apply on the kernel route, "
        f"{adv_off['ms'] / P16_STEPS:.4f} kernels off, (2,2) rank 0 "
        f"{rows[0]['meshes'][0]['adv4']['ms'] / P16_STEPS:.3f}")

    # ---- (c): the cost of pinned CG in one process
    n = P16_COST_N
    cm = CompiledModule(stencils.poisson5(n), "auto", dev)
    mv = cm.opdef("poisson")
    b = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (n, n), dtype=np.float32)).to(dev)

    def solve(pinned):
        with Arithmetic(pinned):
            return krylov.cg(mv, b, tol=0.0, maxiter=P16_COST_ITERS)

    ms = {False: [], True: []}
    for pinned in (False, True):
        solve(pinned)  # warm-up: builds or loads the kernels of the mode
    for pinned in (False, True, True, False):
        before = cuda_backend.counter.count
        (x, info), t = timed(lambda: solve(pinned))
        require(info.iters == P16_COST_ITERS
                and cuda_backend.counter.count - before == P16_COST_ITERS + 1,
                f"16c: {info.iters} iterations, {cuda_backend.counter.count - before} kernel-A "
                "launches")
        launches["stencil_apply"] += P16_COST_ITERS + 1
        ms[pinned].append(t / P16_COST_ITERS)
    counted = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--phase16-dots"],
                             cwd=ROOT, capture_output=True, text=True, timeout=300)
    require(counted.returncode == 0, f"16c dot-product process exited {counted.returncode}:\n"
            f"{counted.stderr[-3000:]}")
    dots = json.loads(counted.stdout.strip().splitlines()[-1])
    rounds = (n * n - 1).bit_length()
    say(f"phase 16c cost: {n}^2 f32 Poisson CG, {P16_COST_ITERS} iterations, one process: "
        f"{np.mean(ms[False]):.4f} ms per iteration default ({ms[False]}), "
        f"{np.mean(ms[True]):.4f} pinned ({ms[True]}), x{np.mean(ms[True]) / np.mean(ms[False]):.2f}; "
        f"CUDA kernels per dot product (torch.profiler, a process of its own) default "
        f"{dots['default']}, pinned {dots['pinned']} ({rounds} pairwise rounds); 16a on (2,2): "
        f"{p22['gathers'] / p22['iters']:.2f} gathers and {p22['ms'] / p22['iters']:.2f} ms per "
        f"iteration pinned, {d22['ms'] / d22['iters']:.2f} ms default")
    say(f"phase 16 launches {json.dumps(launches)}; phase wall {time.perf_counter() - t16:.1f} s")
    return launches


# ---- phase 17: random programs through kernels A, C and D ------------------
# tests/torch_fuzz_programs.py's generators at working sizes, each program
# from its own seed: kernel A (rank 2 at 1024^2 to 4096^2 and rank 3 at
# 128^3; bounded and periodic; dim-0 reach 0-2; one or two inputs; whole
# grid and window form), kernel C (bounded bodies, 2-9 sweeps, whole grid
# and local form; and test_fuzz.py's two-level programs), kernel D
# (two-stage chains, whole grid and origin form); every other program in
# pinned arithmetic. Each is held bitwise against eager PyTorch on the card,
# or within P17_TANH_ULPS where its body has tanh.
P17_SEED = 17000
P17_COUNTS = {"A": 16, "C": 10, "C2": 4, "D": 10}
P17_TANH_ULPS = 2


def p17_programs() -> list:
    """Phase 17's programs: dicts of the seed, the kernel, the module, the
    opdef, the sweeps, the block's global start (None: the whole grid), the
    arithmetic and whether the body has tanh."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_fuzz_programs as fp
    from neptune_tpu_torch import ir

    progs = []

    def shape_of(rng, rank):
        if rank == 3:
            return (128, 128, 128)
        return tuple(int(rng.choice([1024, 2048, 4096])) for _ in range(2))

    def start_of(shape, on):
        return tuple(n // 4 for n in shape) if on else None

    for i in range(P17_COUNTS["A"]):
        seed = P17_SEED + i
        rng = np.random.default_rng(seed)
        shape = shape_of(rng, 3 if i % 4 == 3 else 2)
        window, tanh = i % 4 == 2, i % 5 == 4
        m = fp.kernel_opdef(ir, rng, shape, periodic=i % 4 == 1, h0=i % 3,
                            n_in=1 + (i // 2) % 2, tanh=tanh)
        progs.append(dict(seed=seed, kernel="A", module=m, name="kf", k=None,
                          start=start_of(shape, window), pinned=i % 2 == 1, tanh=tanh))
    for i in range(P17_COUNTS["C"]):
        seed = P17_SEED + 100 + i
        rng = np.random.default_rng(seed)
        shape = shape_of(rng, 3 if i % 5 == 3 else 2)
        local, tanh = i % 4 == 2, i % 3 == 0
        m = fp.kernel_opdef(ir, rng, shape, periodic=i % 4 == 1, h0=1 + i % 2, tanh=tanh,
                            bounded=True)
        progs.append(dict(seed=seed, kernel="C", module=m, name="kf",
                          k=int(rng.integers(2, 10)), start=start_of(shape, local),
                          pinned=i % 2 == 1, tanh=tanh))
    for i in range(P17_COUNTS["C2"]):
        seed = 5000 + i  # test_fuzz.py's two-level programs
        m, shape, k, _, _ = fp.two_level_opdef(ir, np.random.default_rng(seed))
        progs.append(dict(seed=seed, kernel="C", module=m, name="tl", k=k, start=None,
                          pinned=i % 2 == 1, tanh=True))
    for i in range(P17_COUNTS["D"]):
        seed = P17_SEED + 200 + i
        rng = np.random.default_rng(seed)
        shape = (128, 128, 128) if i % 5 == 3 else (2048, 2048)
        origin, tanh = i % 4 == 2, i % 3 == 0
        m = fp.chain_opdef(ir, rng, shape, n_in=1 + i % 2, tanh=tanh)
        progs.append(dict(seed=seed, kernel="D", module=m, name="kd", k=None,
                          start=start_of(shape, origin), pinned=i % 2 == 1, tanh=tanh))
    return progs


def p17_plan(prog):
    """(the program's plan or apply op, the block shape it runs on, its
    kernel's generated source)."""
    from neptune_tpu_torch import stencils
    from neptune_tpu_torch.kernels import codegen
    from neptune_tpu_torch.lowering import chain, cuda_backend, sweeps

    module, name, start = prog["module"], prog["name"], prog["start"]
    shape = tuple(module.lookup(name).ftype.inputs[0].bounds.shape)
    block = shape if start is None else tuple(n // 2 for n in shape)
    if prog["kernel"] == "A":
        op = stencils.the_apply(module)
        return op, block, cuda_backend.source(op)
    if prog["kernel"] == "C":
        k = prog["k"]
        if start is None:
            plan = sweeps.sweep_plan(module, name, k) or sweeps.sweep_plan(module, name, k, depth=2)
        else:
            plan = sweeps.local_sweep_plan(stencils.the_apply(module), block, k)
        require(plan is not None, f"17 seed {prog['seed']}: kernel C takes no plan")
        return plan, block, sweeps.source(plan)
    plan = chain.chain_plan(module, name, None if start is None else block)
    require(plan is not None, f"17 seed {prog['seed']}: kernel D takes no plan")
    return plan, block, codegen.chain_source(plan)


def ulps(a, b) -> int:
    """Largest distance in f32 steps between a and b (NaN where both are)."""
    import torch

    def ordered(t):
        i = t.view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return 1 << 31
    return int((ordered(a[~nan]) - ordered(b[~nan])).abs().max()) if (~nan).any() else 0


def p17_run(prog, plan, block, dev) -> tuple:
    """(kernel result, eager result, kernel launches) of one program."""
    import torch
    from neptune_tpu_torch.lowering import chain, cuda_backend, sweeps, torch_backend

    g = torch.Generator(device=dev).manual_seed(prog["seed"])
    start = prog["start"]
    if prog["kernel"] == "A":
        op = plan
        xs = [torch.randn(block, device=dev, generator=g) for _ in range(op.attrs["num_inputs"])]
        counter = cuda_backend.counter if start is None else cuda_backend.window_counter
        before = counter.count
        if start is None:
            got = cuda_backend.try_execute_apply(op, xs)
            ref = torch_backend.execute_apply(op, xs)
        else:
            got = cuda_backend.apply_window(op, xs, [], start)
            ref = torch_backend.execute_apply_window(op, xs, [], start)
        return got, ref, counter.count - before
    if prog["kernel"] == "C":
        x = torch.randn(block, device=dev, generator=g)
        counter = sweeps.counter if start is None else sweeps.local_counter
        before = counter.count
        got = sweeps.run_sweeps(plan, x, [], start)
        return got, sweeps.sweeps_plain(plan, x, [], start), counter.count - before
    fields = [torch.randn(block, device=dev, generator=g) for _ in range(plan.n_fields)]
    counter = chain.counter if start is None else chain.origin_counter
    before = counter.count
    got = chain.run_chain(plan, fields, [], start)
    return got, chain.chain_plain(plan, fields, [], start), counter.count - before


def phase17(dev) -> None:
    """Phase 17: every program of `p17_programs`, its kernel built in
    parallel and held against eager PyTorch on the card."""
    import torch
    from neptune_tpu_torch.kernels.build import builder

    t17 = time.perf_counter()
    progs = p17_programs()
    plans = []
    for prog in progs:
        with Arithmetic(prog["pinned"]):
            plans.append(p17_plan(prog))
    built_before = set(builder.build_seconds)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=8) as pool:
        jobs = [pool.submit(builder.load, src, f"fuzz_{p['kernel']}")
                for p, (_, _, src) in zip(progs, plans)]
        for j in jobs:
            j.result()
    nvcc = {k: v for k, v in builder.build_seconds.items() if k not in built_before}
    build_wall = time.perf_counter() - t0
    failed, tanh_ulps, by_kernel = [], {}, {}
    for prog, (plan, block, _) in zip(progs, plans):
        with Arithmetic(prog["pinned"]):
            got, ref, launched = p17_run(prog, plan, block, dev)
        torch.cuda.synchronize()
        d = ulps(got, ref)
        ok = launched == 1 and got.is_cuda and (
            d <= P17_TANH_ULPS if prog["tanh"] else d == 0)
        if prog["tanh"] and d:
            tanh_ulps[prog["seed"]] = d
        if not ok:
            failed.append((prog["seed"], prog["kernel"], launched, d))
        by_kernel[prog["kernel"]] = by_kernel.get(prog["kernel"], 0) + 1
        del got, ref
    require(not failed, f"17: programs that failed (seed, kernel, launches, ulps): {failed}")
    say(f"phase 17 random programs: {len(progs)} ({json.dumps(by_kernel)}; "
        f"{sum(p['pinned'] for p in progs)} in pinned arithmetic, {sum(p['tanh'] for p in progs)} "
        f"with tanh), each bitwise equal to eager PyTorch on the card"
        f"{'' if not tanh_ulps else f' but tanh programs within {P17_TANH_ULPS} ulps'}; "
        f"ulp differences found {json.dumps(tanh_ulps) if tanh_ulps else 'none'}; "
        f"{len(nvcc)} libraries, {sum(nvcc.values()):.1f} nvcc seconds, {build_wall:.1f} s "
        f"wall; phase wall {time.perf_counter() - t17:.1f} s")



# ---- phase 18: the examples on the card ---------------------------------------
# Each of the port's programs of examples/ (neptune_tpu_torch/examples/) runs
# in a process of its own (a fresh context) on each route: "auto" (the
# kernels) and "torch" (config.backend = "torch", kernels off). name ->
# the kernels its kernel route must launch (the TPU-kernel table's rows: A on
# gray_scott's periodic lap_t and two-input react, wave_leapfrog, the rank-3
# heat3d_explicit; A's window form on ca_krylov_poisson)
P18_EXAMPLES = {
    "allen_cahn": (), "black_scholes": (), "ca_krylov_poisson": ("stencil_apply_window",),
    "comm_avoiding_jacobi": (), "gray_scott": ("stencil_apply",),
    "heat3d_explicit": ("stencil_apply",), "heat_implicit": (), "inverse_problem": (),
    "multichip_poisson": (), "multigrid_poisson": (), "navier_stokes": (),
    "preconditioned_poisson": (), "swe_implicit": (), "wave_leapfrog": ("stencil_apply",),
}
# the five programs whose opdefs name no dtype also run with
# NEPTUNE_TORCH_DTYPE=float32 (what the JAX examples compute on a TPU, x64
# off): name -> the kernels that run must launch (A's window form and C's
# local form on the mesh examples, A on inverse_problem's 48^2 operator and
# preconditioned_poisson's matvecs: its eager solve_linear calls take generic
# CG, as the JAX package's do, so kernel B is on no example's path)
P18_F32 = {
    "heat_implicit": (), "inverse_problem": ("stencil_apply",),
    "multichip_poisson": ("stencil_apply_window",),
    "comm_avoiding_jacobi": ("stencil_apply_window", "stencil_sweeps_local"),
    "preconditioned_poisson": ("stencil_apply",),
}
# the mesh examples also run once on (2,2), four processes sharing the card
# over gloo (`--procs 4`), held to the one-process run
P18_FOUR = ("multichip_poisson", "comm_avoiding_jacobi")
# roughly longest first, so that the pool's lanes finish together (wall on
# the card beside the other runs: inverse_problem, navier_stokes and
# black_scholes 45-62 s per route, the others 1-18 s)
P18_ORDER = ("inverse_problem", "navier_stokes", "black_scholes", "multichip_poisson",
             "preconditioned_poisson", "comm_avoiding_jacobi", "allen_cahn", "multigrid_poisson",
             "swe_implicit", "ca_krylov_poisson", "heat_implicit", "wave_leapfrog",
             "heat3d_explicit", "gray_scott")
# depth cuts for the script's time budget, in the three programs whose runs
# are longest (host-bound f64 loops that no kernel takes; on an H100 at
# 700 W beside the other runs): navier_stokes's 1200 steps, each an f64 CG
# solve of ~210 iterations, took 353.5 s per route (here 50 steps and a
# resume to 60); inverse_problem's 200 gradient steps 65.9 s (here 50);
# black_scholes's 100 Newton steps 52.9 s (here 25)
P18_MAIN_KWARGS = {"navier_stokes": {"steps": 50, "resume_to": 60},
                   "inverse_problem": {"iters": 50}, "black_scholes": {"steps": 25}}
P18_WORKERS = 8
P18_TIMEOUT = 600


def p18_preconditioned_f32(ns) -> dict:
    """preconditioned_poisson's four rows in f32: x, the true relative
    residual reached and the iterations (the verbose KSP line); main()
    asserts a true residual of 1e-10, which f32 cannot reach (its
    recurrence residual does, so each row stops)."""
    import contextlib
    import io
    import re

    b, out = ns["rhs"](), {}
    for pc, opts in ns["ROWS"]:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            x, rel, _ = ns["solve"](b, pc, opts)
        print(buf.getvalue(), end="")
        out |= {pc: x, f"{pc}_rel": rel,
                f"{pc}_iters": int(re.findall(r"iters=(\d+)", buf.getvalue())[-1])}
    return out


def p18_inverse_f32(ns) -> dict:
    """inverse_problem's functions in f32: one gradient (a forward and an
    adjoint CG solve to 1e-12, which f32 stops at its 3000 iterations) and
    the relative residual the forward solve reaches; main()'s 200 steps
    would take ~600 such solves."""
    import torch

    import neptune_tpu_torch as ntt

    mv = ntt.get_context().compiled().opdef("A")
    f_true = torch.as_tensor(ns["source"](), dtype=torch.float32, device="cuda")
    u_obs = ns["observe"](mv, f_true)
    g = ns["grad"](mv, torch.zeros_like(f_true), u_obs)
    x = ns["forward"](mv, f_true).detach()
    rel = float(torch.linalg.norm(mv(x) - f_true) / torch.linalg.norm(f_true))
    return {"grad": g.cpu().numpy(), "u_obs": u_obs.cpu().numpy(), "forward_rel_residual": rel}


P18_F32_FUNCTIONS = {"preconditioned_poisson": p18_preconditioned_f32,
                     "inverse_problem": p18_inverse_f32}


def phase18_example(argv) -> int:
    """chip_smoke.py --phase18-example NAME PROCS ROUTES OUT: run one example
    in the dtype of the environment (NEPTUNE_TORCH_DTYPE) once per route of
    ROUTES ("auto,torch": config.backend), each in a fresh DSL context: its
    main() or, in f32, the functions of P18_F32_FUNCTIONS; write
    OUT-ROUTE.npz (its result) and OUT-ROUTE.json (wall seconds, nvcc
    seconds, launches by kernel)."""
    import runpy

    import torch

    name, procs, routes, out = argv
    sys.path.insert(0, str(ROOT))
    import neptune_tpu_torch as ntt
    from neptune_tpu_torch.config import config
    from neptune_tpu_torch.examples import _cli
    from neptune_tpu_torch.kernels.build import builder

    sys.argv = [name] + (["--procs", procs] if int(procs) > 1 else [])
    for route in routes.split(","):
        _cli.device()  # the card, as main() asks for it
        config.backend = route
        ntt.reset_context()
        for c in counters().values():
            c.reset()
        built = sum(builder.build_seconds.values())
        t0 = time.perf_counter()
        ns = runpy.run_module(f"neptune_tpu_torch.examples.{name}")
        run = P18_F32_FUNCTIONS.get(name) if config.default_dtype == "float32" else None
        result = run(ns) if run else ns["main"](**P18_MAIN_KWARGS.get(name, {}))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _cli.save(result, f"{out}-{route}.npz")
        Path(f"{out}-{route}.json").write_text(json.dumps({
            "wall": wall, "nvcc": sum(builder.build_seconds.values()) - built,
            "launches": {n: c.count for n, c in counters().items()},
            "backend": config.backend, "dtype": config.default_dtype, "device": config.device,
            "card": torch.cuda.get_device_name(0)}))
    return 0


def p18_job(job, out_dir) -> dict:
    """One example, each of its routes, in a process of its own: {"ok",
    route: {"result", "info"} for each route, "log"}."""
    from neptune_tpu_torch.examples import _cli

    name, dtype, procs = job
    routes = ("auto", "torch") if procs == 1 else ("auto",)
    out = str(Path(out_dir, f"{name}-{dtype or 'default'}-{procs}"))
    # one host thread each: the runs share the host's cores
    env = dict(os.environ, OMP_NUM_THREADS="1")
    if dtype:
        env["NEPTUNE_TORCH_DTYPE"] = dtype
    try:
        r = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--phase18-example",
                            name, str(procs), ",".join(routes), out], env=env,
                           capture_output=True, text=True, timeout=P18_TIMEOUT)
    except subprocess.TimeoutExpired as e:
        return {"ok": False, "log": f"timed out after {P18_TIMEOUT} s\n{e.stdout or ''}"}
    if r.returncode:
        return {"ok": False, "log": (r.stdout + r.stderr)[-3000:]}
    got = {"ok": True, "log": r.stdout}
    for route in routes:
        got[route] = {"result": _cli.load(f"{out}-{route}.npz"),
                      "info": json.loads(Path(f"{out}-{route}.json").read_text())}
    return got


def p18_mismatches(a: dict, b: dict) -> list:
    """Where two routes' results differ, every entry held bitwise (kernel B,
    whose f64 dot sums would allow less, is on no example's path): [(key,
    kernel route's, kernels-off route's or the max |diff|)]."""
    bad = []
    for k, va in a.items():
        vb = b[k]
        if isinstance(va, np.ndarray) and va.dtype.kind == "f":
            d = float(np.abs(va.astype(np.float64) - vb).max()) if va.shape == vb.shape else np.inf
            if d > 0.0 or va.dtype != vb.dtype:
                bad.append((k, "max |diff|", d))
        elif not np.array_equal(va, vb):
            bad.append((k, va, vb))
    return bad


def p18_scalars(result: dict) -> str:
    return json.dumps({k: v for k, v in result.items() if not isinstance(v, np.ndarray)
                       and (not isinstance(v, str) or len(v) < 80)})


def phase18() -> dict:
    """Phase 18: every run of P18_*, P18_WORKERS host processes at a time;
    each example's routes held against each other, its kernels counted,
    its wall seconds printed. Returns the kernel routes' launches by
    kernel."""
    import tempfile

    import threading

    t18 = time.perf_counter()
    four = [(n, None, 4) for n in P18_FOUR]
    jobs = [(n, None, 1) for n in P18_ORDER]
    jobs += [(n, "float32", 1) for n in P18_ORDER if n in P18_F32]
    # P18_WORKERS host processes at a time: the four-process runs one after
    # the other, holding four of them, the one-process runs in the rest
    # (gloo ranks that share cores with more runs than that slow down most)
    free = threading.Semaphore(P18_WORKERS - 4)

    def single(job, out_dir):
        with free:
            return p18_job(job, out_dir)

    def four_then_release(out_dir):
        try:
            return {job: p18_job(job, out_dir) for job in four}
        finally:
            for _ in range(4):
                free.release()

    with tempfile.TemporaryDirectory(prefix="nt_phase18_") as out_dir, \
            ThreadPoolExecutor(max_workers=P18_WORKERS + 1) as pool:
        first = pool.submit(four_then_release, out_dir)
        futures = {job: pool.submit(single, job, out_dir) for job in jobs}
        res = {job: f.result() for job, f in futures.items()} | first.result()
    jobs += four
    failed = [(job, r["log"]) for job, r in res.items() if not r["ok"]]
    require(not failed, "18: runs that failed:\n" + "\n".join(
        f"{job}:\n{log}" for job, log in failed))
    launches = {}
    for dtype, table in ((None, P18_EXAMPLES), ("float32", P18_F32)):
        for name in P18_ORDER:
            if name not in table:
                continue
            k, p = res[(name, dtype, 1)]["auto"], res[(name, dtype, 1)]["torch"]
            lk, lp = k["info"]["launches"], p["info"]["launches"]
            require(k["info"]["device"] == "cuda" and p["info"]["backend"] == "torch",
                    f"18 {name} {dtype}: {k['info']} {p['info']}")
            require(not any(lp.values()), f"18 {name} {dtype}: the kernels-off route launched {lp}")
            missing = [kn for kn in table[name] if not lk[kn]]
            require(not missing, f"18 {name} {dtype or ''}: {missing} not launched ({lk})")
            bad = p18_mismatches(k["result"], p["result"])
            require(not bad, f"18 {name} {dtype or ''}: the routes differ: {bad}")
            for kn, v in lk.items():
                launches[kn] = launches.get(kn, 0) + v
            say(f"phase 18 {name}{' f32' if dtype else ''}: kernel route {k['info']['wall']:.1f} s "
                f"(nvcc {k['info']['nvcc']:.1f} s), kernels-off route {p['info']['wall']:.1f} s "
                f"wall on the card; launches {json.dumps({n: v for n, v in lk.items() if v})}; "
                f"bitwise equal; {p18_scalars(k['result'])}")
    for name in P18_FOUR:
        four, one = res[(name, None, 4)]["auto"], res[(name, None, 1)]["auto"]["result"]
        wall, four = four["info"]["wall"], four["result"]
        if name == "multichip_poisson":
            rel = float(np.abs(four["x"] - one["x"]).max() / np.abs(one["x"]).max())
            require(abs(four["iters"] - one["iters"]) <= 1 and rel <= 1e-8,
                    f"18 {name} (2,2): {four['iters']} iterations against {one['iters']}, "
                    f"x {rel!r}")
            txt = f"{four['iters']} CG iterations (one process {one['iters']}), x within {rel!r}"
        else:
            rel = max(float(np.abs(four[k] - one[k]).max() / np.abs(one[k]).max())
                      for k in ("naive", "ca", "xs"))
            require(four["dev"] < 1e-10 and four["cheb_iters"] == one["cheb_iters"]
                    and rel <= 1e-8, f"18 {name} (2,2): {p18_scalars(four)} {rel!r}")
            txt = (f"|naive - comm-avoiding| {four['dev']!r} (< 1e-10), {four['cheb_iters']} "
                   f"Chebyshev iterations, fields within {rel!r} of one process")
        say(f"phase 18 {name} four processes (2,2) over gloo on the card: {txt}; "
            f"{wall:.1f} s wall")
    say(f"phase 18 kernel launches (kernel routes): {json.dumps(launches)}; {len(jobs)} "
        f"runs (a process running both routes, or a four-process run), {P18_WORKERS} host "
        f"processes at a time; phase wall {time.perf_counter() - t18:.1f} s")
    return launches


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--phase9-rank":
        return phase9_rank(sys.argv[2:])
    if len(sys.argv) > 1 and sys.argv[1] == "--phase15-trace":
        return phase15_trace(sys.argv[2:])
    if len(sys.argv) > 1 and sys.argv[1] == "--phase16-dots":
        return phase16_dots(sys.argv[2:])
    if len(sys.argv) > 1 and sys.argv[1] == "--phase18-example":
        return phase18_example(sys.argv[2:])
    t_start = time.perf_counter()
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
    # one cache directory in the checkout (config.cache_dir): the kernels
    # build into its kernels/, the native runtime into it; the child
    # processes inherit it
    os.environ.setdefault("NEPTUNE_TORCH_CACHE_DIR", str(ROOT / "neptune_tpu_torch" / "_build"))

    import neptune_tpu_torch as ntt
    from neptune_tpu_torch import entry, stencils
    from neptune_tpu_torch.config import config
    from neptune_tpu_torch.kernels import codegen
    from neptune_tpu_torch.kernels.build import builder
    from neptune_tpu_torch.lowering import chain, cuda_backend, sweeps, torch_backend
    from neptune_tpu_torch.lowering.executor import CompiledModule
    from neptune_tpu_torch.solvers import cg_vectors, fused
    from neptune_tpu_torch.solvers.precond import extract_diagonal, safe_inv_diag

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    card = nvidia_smi()

    # ---- the main path's operators, at the main path's shapes -----------
    A_CASES = a_cases()
    heat_cm = entry.build_step(256, "float32", device=dev)
    B_CASES = [(label, b_system(system), *rest) for label, system, *rest in B_SYSTEMS]
    step3d_cm = entry.build_step_3d(256, "float32", device=dev)
    C_CASES = c_cases()
    D_CASES = d_cases()
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
    # phases 8 and 9: the local forms' plans at their block shapes, and the
    # applies they reach (the window form builds kernel A's source)
    for module, k, blocks in (
        (stencils.jacobi5((4096, 4096)), 8, ((4096, 4096), (2048, 2048))),
        (stencils.advection4((8192, 8192)), 16, ((8192, 8192), (4096, 8192))),
    ):
        op = stencils.the_apply(module)
        c_plans += [sweeps.local_sweep_plan(op, b, k) for b in blocks]
    for module, name, blocks in (
        (stencils.composite((4096, 4096)), "wrapped", ((4096, 4096), (2048, 2048))),
        (stencils.composite((1024, 1024)), "wrapped", ((1024, 1024),)),
        (stencils.coupled((4096, 4096)), "couple", ((2048, 4096),)),
    ):
        d_plans += [chain.chain_plan(module, name, b) for b in blocks]
    require(all(p is not None for p in c_plans + d_plans), "a kernel C or D case has no plan")

    # ---- phase 1: device and build -------------------------------------
    say(f"phase 1 device: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    sources, fold_default = [], config.fold_affine
    for _, m, fold, _ in A_CASES:
        config.fold_affine = fold
        sources.append(cuda_backend.source(stencils.the_apply(m)))
    config.fold_affine = fold_default
    sources.append(cuda_backend.source(stencils.the_apply(step3d_cm.module)))
    sources.append(cuda_backend.source(stencils.the_apply(stencils.graded((4096, 4096), lb=(3, -5)))))
    sources += phase10_sources(ntt)
    sources += phase11_sources(ntt)
    sources.append(cuda_backend.source(stencils.the_apply(ca_system()[0])))
    # phase 16: 1024^2 Poisson in both arithmetics, adv4 4096^2 pinned
    p16_ops = [stencils.the_apply(stencils.poisson5(P16_COST_N)),
               stencils.the_apply(stencils.advection4((P16_ADV_N, P16_ADV_N)))]
    sources.append(cuda_backend.source(p16_ops[0]))
    with Arithmetic(True):
        sources += [cuda_backend.source(op) for op in p16_ops]
    cg_sources = [codegen.fused_cg_source(fused.cg_plan(m, n)) for _, m, n, *_ in B_CASES]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=8) as pool:
        jobs = [pool.submit(builder.load, s, "stencil_apply") for s in sources]
        jobs += [pool.submit(builder.load, s, "fused_cg") for s in cg_sources]
        jobs.append(pool.submit(builder.load, cg_vectors.SOURCE, "cg_vectors"))
        jobs += [pool.submit(builder.load, sweeps.source(p), "stencil_sweeps") for p in c_plans]
        jobs += [pool.submit(builder.load, codegen.chain_source(p), "stencil_chain") for p in d_plans]
        for j in jobs:
            j.result()
    say(f"phase 1 build: {len(builder.build_seconds)} libraries in "
        f"{time.perf_counter() - t0:.1f}s wall; nvcc seconds "
        + ", ".join(f"{k}={v:.1f}" for k, v in sorted(builder.build_seconds.items())))

    # ---- phase 2: kernel A against its plain version -------------------
    a_err, a_ms, a_plain_ms, a_bound, a_lib = 0.0, None, None, None, None
    a64_err, a64_launches, a64 = 0.0, 0, None
    for label, module, fold, scalar in A_CASES:
        config.fold_affine = fold
        op = stencils.the_apply(module)
        tt = op.results[0].type
        n_in = op.attrs["num_inputs"]
        shape = tt.bounds.shape
        args = a_args(op, scalar, rng, dev)
        torch.cuda.synchronize()
        before = cuda_backend.counter.count
        gots = cuda_backend.try_execute_apply(op, args)
        torch.cuda.synchronize()
        launched = cuda_backend.counter.count - before
        refs = torch_backend.execute_apply(op, args)
        if len(op.results) == 1:
            gots, refs = (gots,), (refs,)
        err, ulps = 0.0, 0
        for got, ref in zip(gots, refs):
            e = (got.double() - ref.double()).abs().max().item()
            if tt.element != "bfloat16":
                require(got.dtype == ref.dtype and torch.equal(got, ref),
                        f"{label}: kernel != plain (max err {e})")
            else:
                d = (got.view(torch.int16).int() - ref.view(torch.int16).int()).abs().max()
                ulps = max(ulps, int(d))
                require(ulps <= 1, f"{label}: kernel {ulps} bf16 ulps from plain")
            err = max(err, e)
        require(launched == 1, f"{label}: launch count rose by {launched}")
        if tt.element == "float64":
            a64_err, a64_launches = max(a64_err, err), a64_launches + launched
        else:
            a_err = max(a_err, err)
        k_ms, p_ms = abba(
            lambda: cuda_backend.try_execute_apply(op, args),
            lambda: torch_backend.execute_apply(op, args),
            reps=20,
        )
        dev_us = device_us(lambda: cuda_backend.try_execute_apply(op, args), 20, "nt_apply")
        cells = float(np.prod(shape))
        nbytes = (n_in + len(op.results)) * cells * gots[0].element_size()
        b_ms, b_by = bound(nbytes, codegen.body_ops(op) * cells,
                           F64_OPS_PER_S if tt.element == "float64" else F32_OPS_PER_S)
        lib_ms, lib_txt = library_for_apply(op, args, gots[0])
        dev_txt = "not measured" if dev_us is None else (
            f"{dev_us:.1f} us ({cells / dev_us / 1e3:.2f} Gcell/s, {nbytes / dev_us / 1e3:.1f} GB/s)"
        )
        # host time of one launch: calls queued back to back, no sync
        host_us = 1e3 * host_ms(lambda: cuda_backend.try_execute_apply(op, args), 50,
                                lambda: None)[0]
        torch.cuda.synchronize()
        say(f"phase 2 stencil_apply {label}: max_abs_err={err!r} bf16_ulps={ulps} "
            f"launches+{launched}; kernel {k_ms:.4f} ms per call ({cells / k_ms / 1e6:.2f} Gcell/s, "
            f"{nbytes / k_ms / 1e6:.1f} GB/s), device time {dev_txt}; host {host_us:.1f} us per "
            f"launch; plain {p_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}); library {lib_txt}; "
            f"d2d copy of the same bytes {copy_gbs(int(nbytes)):.1f} GB/s; plan {a_plan_text(op)}")
        if label == "jacobi5 4096^2 f32":
            a_ms, a_plain_ms, a_bound, a_lib = k_ms, p_ms, (b_ms, b_by), lib_ms
        if label == A_F64_LABEL:
            a64 = (k_ms, p_ms, (b_ms, b_by), lib_ms)
        if cuda_backend.colour_form(op):
            phase2_colour_form(op, args)
    config.fold_affine = fold_default

    # ---- phase 3: kernel B against its plain version -------------------
    b_err, b_ms, b_plain_ms, b_bound, b_extra = 0.0, None, None, None, {}
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
        lift = solve.lift  # the site's ring lift, as the executor's solve site runs it
        x_p, it_p, rn_p = fused.fused_cg_plain(matvec, b, tol=tol, maxiter=maxiter, inv_diag=inv,
                                               lift=lift)
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
        iters = int(it_k)
        k_ms = cuda_ms(lambda: solve(b), reps=3 if iters > 1000 else 20)
        k_dev = device_us(lambda: solve(b), 3, "nt_fused_cg_kernel")
        p_ms = cuda_ms(
            lambda: fused.fused_cg_plain(matvec, b, tol=tol, maxiter=maxiter, inv_diag=inv,
                                         lift=lift),
            reps=1,
        )
        cells = float(np.prod(n))
        # per iteration: the matvec's stages, then 13 vector operations per
        # cell (two dot products, three axpys, the Jacobi scaling, the norm)
        ops = iters * cells * (sum(codegen.body_ops(st.op) for st in stages) + 13)
        b_ms_cg, b_by_cg = bound((3 if jacobi else 2) * 4 * cells, ops)
        # the barrier floor at the kernel's grid size: the two barriers and
        # the three-value reduction of an iteration and nothing else
        site = solve.site(dev)
        plan = site.plan
        floor = site.barrier_floor_us(2000)
        us_it = k_ms * 1e3 / max(iters, 1)
        say(f"phase 3 fused_cg {label}: lift {lift}; bound {b_ms_cg:.4f} ms ({b_by_cg}), "
            f"library none; "
            f"barrier floor {floor:.3f} us/iter; "
            f"{plan.blocks} blocks of tile {plan.tile} + halo {plan.halo}, "
            f"{plan.smem_bytes} B smem; iters kernel {iters} plain {int(it_p)}; "
            f"recurrence resnorm {rn_k.item()!r}; true residual kernel {res_k!r} plain {res_p!r} "
            f"(tol*||b|| {tol * bnorm!r}); rel x diff {rel_x!r}; max_abs_err={err!r}; "
            f"launches+{launched}; kernel {k_ms:.4f} ms/solve, {us_it:.3f} us/iter "
            f"({iters / k_ms * 1e3:.0f} iters/s; "
            f"device time {'not measured' if k_dev is None else f'{k_dev / 1e3:.4f} ms'}) "
            f"plain {p_ms:.3f} ms/solve")
        if label.startswith("poisson 512^2"):
            b_ms, b_plain_ms, b_bound = k_ms, p_ms, (b_ms_cg, b_by_cg)
            b_extra = {"iters": iters, "us_per_iter": us_it, "barrier_floor_us_per_iter": floor,
                       "blocks": plan.blocks, "tile": list(plan.tile),
                       "smem_bytes": plan.smem_bytes}

    phase3_cg_vectors(dev)

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
    c_err, c_ms, c_plain_ms, c_bound = 0.0, None, None, None
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
        ka_ms = cuda_ms(k_launches, reps)
        dev_us = device_us(lambda: run(x, *sc), reps, "nt_sweeps")
        depth_txt = []
        for d in depths:
            pd = sweeps.sweep_plan(module, name, k, depth=d)

            def at_depth(pd=pd):
                u = x
                for _ in range(k // pd.depth):
                    u = sweeps.run_sweeps(pd, u, sc)
                return u

            require(torch.equal(at_depth(), ak), f"{label}: depth {d} != kernel A")
            depth_txt.append(f"{c_plan_text(pd)}: {cuda_ms(at_depth, reps):.4f} ms")
        dev_txt = "not measured" if dev_us is None else f"{dev_us:.1f} us"
        b_ms_c, b_by_c = bound(8 * cells, k * cells * codegen.body_ops(plan.op))
        say(f"phase 5 stencil_sweeps {label}: bound {b_ms_c:.4f} ms ({b_by_c}), library none; "
            f"{k // plan.depth} launches of {c_plan_text(plan)}, "
            f"bitwise = plain = {k} kernel-A launches; kernel {k_ms:.4f} ms per call "
            f"({k_ms * 1e3 / k:.2f} us per sweep, {8 * cells * k / k_ms / 1e6:.1f} GB/s effective; "
            f"d2d copy {copy_gbs(int(8 * cells)):.1f} GB/s), device {dev_txt}; "
            f"plain {p_ms:.4f} ms; {k} kernel-A launches {ka_ms:.4f} ms"
            + ("; " + "; ".join(depth_txt) if depth_txt else ""))
        if label == "jacobi5 4096^2 K=16":
            c_ms, c_plain_ms, c_bound = k_ms, p_ms, (b_ms_c, b_by_c)

    # ---- phase 6: kernel D against the stages one at a time -------------
    d_err, d_ms, d_plain_ms, d_bound, d_lib = 0.0, None, None, None, None
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
        ka_ms = cuda_ms(lambda: stages(*fields, *sc), reps)
        dev_us = device_us(lambda: run(*fields, *sc), reps, "nt_chain_kernel")
        nbytes = (n_fields + 1) * 4 * cells
        dev_txt = "not measured" if dev_us is None else (
            f"{dev_us:.1f} us ({nbytes / dev_us / 1e3:.1f} GB/s)")
        b_ms_d, b_by_d = bound(nbytes, cells * sum(codegen.body_ops(st.op) for st in plan.stages))
        lib_ms_d, lib_txt_d = library_for_chain(plan, fields, y) if n_fields == 1 else (None, "none")
        # host time of one launch: calls queued back to back, no sync
        host_us = 1e3 * host_ms(lambda: chain.run_chain(plan, fields, sv), 50, lambda: None)[0]
        torch.cuda.synchronize()
        say(f"phase 6 stencil_chain {label}: bound {b_ms_d:.4f} ms ({b_by_d}), library {lib_txt_d}; "
            f"{len(plan.stages)} stages in 1 launch (reach {plan.reach}, {plan.n_buffers} "
            f"buffers; plan {d_plan_text(plan)}), "
            f"bitwise = plain = per-stage kernel A; kernel {k_ms:.4f} ms per call, device "
            f"{dev_txt}; host {host_us:.1f} us per launch; d2d copy of (fields + result) "
            f"{copy_gbs(int(nbytes)):.1f} GB/s; plain {p_ms:.4f} ms; per-stage kernel A "
            f"{ka_ms:.4f} ms")
        if label == "composite 4096^2":
            d_ms, d_plain_ms, d_bound, d_lib = k_ms, p_ms, (b_ms_d, b_by_d), lib_ms_d

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

    # ---- phase 8: the sharded path on a mesh of one process ---------------
    forms = phase8_forms(dev, rng)
    sh_launches = phase8_rows(dev, rng)
    say(f"phase 8 sharded path launches: {json.dumps({n: v for n, v in sh_launches.items() if v})}")

    # ---- phase 9: four processes on the one card --------------------------
    t9 = time.perf_counter()
    reports = phase9("cuda:0", 4096, 256, timeout=600)["reports"]
    for i, (label, _, _, mesh, k, form) in enumerate(PHASE9):
        rows = [r["rows"][i] for r in reports]
        require(all(row["device"].startswith("cuda") for row in rows),
                f"phase 9 {label}: a result is not on the card")
        if form is not None:
            require(all(row["launches"].get(form, 0) > 0 for row in rows),
                    f"phase 9 {label}: {form} not launched on every rank: "
                    f"{[row['launches'] for row in rows]}")
        r0 = rows[0]
        require(r0["bitwise"], f"phase 9 {label}: gathered != whole grid (max err {r0['max_abs_err']})")
        say(f"phase 9 {label}: gathered result bitwise = one-process whole-grid route; rank-0 "
            f"launches {json.dumps(r0['launches'])}; strips sent per rank "
            f"{max(row['sent_bytes'] for row in rows)} B, of which through host memory "
            f"{max(row['staged_bytes'] for row in rows)} B; per call (host clock, rank 0, "
            f"median [min, max] of {PHASE9_REPS}) {r0['call_ms'][0]:.3f} "
            f"[{r0['call_ms'][1]:.3f}, {r0['call_ms'][2]:.3f}] ms, whole grid in one process "
            f"{r0['whole_ms'][0]:.3f} [{r0['whole_ms'][1]:.3f}, {r0['whole_ms'][2]:.3f}] ms")
    g = [r["gmres"] for r in reports]
    g0 = g[0]
    require(all(x["iters"] == g0["iters"] for x in g), f"phase 9 GMRES: ranks disagree {g}")
    require(abs(g0["iters"] - g0["whole_iters"]) <= 1,
            f"phase 9 GMRES: {g0['iters']} iterations against {g0['whole_iters']} in one process")
    require(g0["converged"] and g0["true_rel_residual"] <= 1e-6,
            f"phase 9 GMRES: true relative residual {g0['true_rel_residual']!r}")
    say(f"phase 9 sharded GMRES heat3d_A 256^3 on (4,1), tol 1e-6: {g0['iters']} iterations "
        f"(one process {g0['whole_iters']}), true relative residual {g0['true_rel_residual']!r}; "
        f"{g0['ms']:.1f} ms (one process {g0['whole_ms']:.1f} ms; single solves); phase wall "
        f"{time.perf_counter() - t9:.1f} s")

    # ---- phase 10: the solver surface at full size ------------------------
    phase10(ntt, dev, rng)

    # ---- phase 11: multigrid and Chebyshev at full size ---------------------
    p11 = phase11(ntt, dev, (b_ms, b_extra["iters"]))
    mg_launches = p11["launches"]

    # ---- phase 12: the CA solvers and sharded_function ---------------------
    ca_launches = phase12(dev, reports)

    # ---- phase 13: multigrid, Chebyshev and Newton over a process mesh -----
    ca_launches += phase13(ntt, dev, reports, p11)

    # ---- phase 14: the rest of sharded_function, reverse mode, the dry run -
    ca_launches += phase14(dev, reports)

    # ---- phase 15: odd blocks, the driver, the native oracle, profiling, CLI -
    p15 = phase15(dev, reports, heat_cm, step_ms)

    # ---- phase 16: pinned arithmetic on the card -----------------------------
    p16 = phase16(dev, reports)

    # ---- phase 17: random programs through kernels A, C and D --------------
    phase17(dev)

    # ---- phase 18: the examples on the card, each in a process of its own ---
    p18 = phase18()

    def entry_of(name, source, replaces, launches_n, err, ms, plain_ms, bnd, lib, shape, also=None):
        e = {"name": name, "route": "cuda", "source": source, "replaces": replaces}
        if also:
            e["also_replaces"] = also
        e.update({
            "launches": launches_n, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib, "shape": shape,
        })
        return e

    kernels = [
        entry_of("stencil_apply", "neptune_tpu_torch/csrc/nt_apply.cuh",
                 "neptune_tpu/lowering/pallas_backend.py:332",
                 launches["stencil_apply"] + mg_launches + p15["stencil_apply"]
                 + p16["stencil_apply"] + p18["stencil_apply"], a_err,
                 a_ms, a_plain_ms, a_bound, a_lib, "jacobi5 4096^2 f32",
                 ["neptune_tpu/lowering/pallas_backend.py:845",
                  "neptune_tpu/lowering/pallas_backend.py:1094"]),
        entry_of("stencil_apply_f64", "neptune_tpu_torch/csrc/nt_apply.cuh",
                 "neptune_tpu/lowering/pallas_backend.py:845", a64_launches, a64_err, *a64,
                 A_F64_LABEL),
        entry_of("fused_cg", "neptune_tpu_torch/csrc/nt_fused_cg.cuh",
                 "neptune_tpu/solvers/fused.py:201",
                 launches["fused_cg"] + p15["fused_cg"] + p18["fused_cg"],
                 b_err, b_ms,
                 b_plain_ms, b_bound, None, "poisson 512^2 jacobi tol 1e-4") | b_extra,
        entry_of("stencil_sweeps", "neptune_tpu_torch/csrc/nt_sweeps.cuh",
                 "neptune_tpu/lowering/pallas_multisweep.py:406",
                 dsl_launches["stencil_sweeps"] + p18["stencil_sweeps"],
                 c_err, c_ms, c_plain_ms, c_bound, None, "jacobi5 4096^2 f32, 16 sweeps",
                 ["neptune_tpu/lowering/pallas_multisweep.py:676",
                  "neptune_tpu/lowering/pallas_multisweep.py:904"]),
        entry_of("stencil_chain", "neptune_tpu_torch/csrc/nt_chain.cuh",
                 "neptune_tpu/lowering/pallas_chain.py:516",
                 dsl_launches["stencil_chain"] + p18["stencil_chain"], d_err,
                 d_ms, d_plain_ms, d_bound, d_lib, "u + 0.01 lap(lap u) 4096^2 f32"),
    ]
    for name, source, replaces, also in (
        ("stencil_apply_window", "neptune_tpu_torch/csrc/nt_apply.cuh",
         "neptune_tpu/lowering/pallas_backend.py:1310",
         ["neptune_tpu/lowering/pallas_backend.py:845 (global_start)",
          "neptune_tpu/lowering/pallas_backend.py:1094 (global_start)"]),
        ("stencil_sweeps_local", "neptune_tpu_torch/csrc/nt_sweeps.cuh",
         "neptune_tpu/lowering/pallas_multisweep.py:959",
         ["neptune_tpu/lowering/pallas_multisweep.py:676 (global_start)",
          "neptune_tpu/lowering/pallas_multisweep.py:904 (global_start)"]),
        ("stencil_chain_origin", "neptune_tpu_torch/csrc/nt_chain.cuh",
         "neptune_tpu/lowering/pallas_chain.py:516 (global_start)", None),
    ):
        k_ms, p_ms, bnd, lib, shape, err = forms[name]
        n = sh_launches[name] + p18[name] + (
            ca_launches + p15[name] + p16[name] if name == "stencil_apply_window" else 0)
        kernels.append(entry_of(name, source, replaces, n, err, k_ms, p_ms, bnd, lib, shape, also))
    say(f"all phases passed in {time.perf_counter() - t_start:.1f} s, builds included")
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
