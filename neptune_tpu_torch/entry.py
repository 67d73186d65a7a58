"""The flagship programs, built with the port's `NeptuneBuilder`.

The port of `__graft_entry__.py`: one implicit heat time step, entirely in
IR (`build_step`), and its 3-D twin with a GMRES solve (`build_step_3d`).
`entry(device)` returns the compiled step and an example state on `device`,
the card unless the caller asks for the CPU. `dryrun_multichip(n)` runs the
JAX package's multi-chip dry run over n processes joined by
`torch.distributed`, each of them this module run as
`python -m neptune_tpu_torch.entry --dryrun-rank ...`.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from .config import default_device
from .ir import F32, F64, Bounds, NeptuneBuilder, TempType
from .lowering.executor import CompiledModule
from .parallel.distributed import local_ranks, mesh_shape_2d, spawn_ranks
from .passes import compile_ir


def build_step(n: int, dtype: str, device=None) -> CompiledModule:
    """One implicit heat step on an n x n grid: A = I - 0.1 lap on the
    interior (copy-through ring), solved by unpreconditioned CG."""
    S = F32 if dtype == "float32" else F64
    b = NeptuneBuilder()
    bounds = Bounds.of([0, 0], [n, n])
    interior = Bounds.of([1, 1], [n - 1, n - 1])
    tt = TempType(dtype, bounds)

    fn = b.make_opdef("heat_A", "linear_opdef", [tt], [tt])
    b.push_block(fn.body)
    op, body = b.start_apply([fn.body.args[0]], interior)
    b.push_block(body)
    c = b.access(body.args[2], [0, 0])
    nb = [b.access(body.args[2], o) for o in ([-1, 0], [1, 0], [0, -1], [0, 1])]
    s = nb[0]
    for x in nb[1:]:
        s = b.add(s, x)
    lap = b.sub(s, b.mul(b.constant(4.0, S), c))
    b.yield_(b.sub(c, b.mul(b.constant(0.1, S), lap)))
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()

    entry_fn = b.make_function("step", "func", [tt], [tt])
    b.push_block(entry_fn.body)
    u1 = b.time_advance(
        entry_fn.body.args[0],
        0.1,
        2,  # implicit_linear
        system="heat_A",
        solver="cg",
        tol=1e-6,
        max_iters=200,
        precond="none",
    )
    b.return_([u1])
    b.pop_block()
    return compile_ir(b.module, device=device)


def build_step_3d(n: int, dtype: str, device=None) -> CompiledModule:
    """One implicit 3-D heat step (7-pt stencil system, GMRES solve)."""
    S = F32 if dtype == "float32" else F64
    b = NeptuneBuilder()
    bounds = Bounds.of([0, 0, 0], [n, n, n])
    interior = Bounds.of([1, 1, 1], [n - 1, n - 1, n - 1])
    tt = TempType(dtype, bounds)

    fn = b.make_opdef("heat3d_A", "linear_opdef", [tt], [tt])
    b.push_block(fn.body)
    op, body = b.start_apply([fn.body.args[0]], interior)
    b.push_block(body)
    u = body.args[3]
    c = b.access(u, [0, 0, 0])
    offsets = ([-1, 0, 0], [1, 0, 0], [0, -1, 0], [0, 1, 0], [0, 0, -1], [0, 0, 1])
    nb = [b.access(u, o) for o in offsets]
    s = nb[0]
    for x in nb[1:]:
        s = b.add(s, x)
    lap = b.sub(s, b.mul(b.constant(6.0, S), c))
    b.yield_(b.sub(c, b.mul(b.constant(0.05, S), lap)))
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()

    entry_fn = b.make_function("step3d", "func", [tt], [tt])
    b.push_block(entry_fn.body)
    u1 = b.time_advance(
        entry_fn.body.args[0],
        0.05,
        2,  # implicit_linear
        system="heat3d_A",
        solver="gmres",
        tol=1e-6,
        max_iters=120,
        precond="none",
    )
    b.return_([u1])
    b.pop_block()
    return compile_ir(b.module, device=device)


def gaussian(n: int, dtype: str = "float32") -> np.ndarray:
    """The entry's initial state: exp(-(x^2 + y^2)) on [-3, 3]^2."""
    x = np.linspace(-3, 3, n)
    return np.exp(-(x[:, None] ** 2 + x[None, :] ** 2)).astype(dtype)


def entry(device="cuda") -> tuple:
    """(step_fn, example_args): the 256^2 f32 implicit heat step on `device`."""
    dtype = "float32"
    n = 256
    device = default_device(device)
    cm = build_step(n, dtype, device=device)
    u0 = torch.from_numpy(gaussian(n, dtype)).to(device)
    return cm.function("step"), (u0,)


# ---- the multi-process dry run -----------------------------------------------


def _close(a, b, atol) -> bool:
    return bool(torch.allclose(a, b, rtol=1e-5, atol=atol))


def _part_3d_gmres(gm, dev, rng, ctx):
    """The sharded 3-D 7-pt implicit step (GMRES) through sharded_function;
    the sharded matvec on the kernel and kernels-off routes against the
    whole grid's; two sweeps per exchange against two matvecs; GMRES over
    the sharded matvec and the mesh's group."""
    from .parallel import sharded_function, shardmap_opdef, shardmap_sweeps
    from .solvers import krylov

    n3 = 48
    cm3 = build_step_3d(n3, "float32", device=dev)
    u3 = gm.shard(rng.standard_normal((n3, n3, n3)).astype("float32"))
    out = sharded_function(cm3, "step3d", gm)(u3)
    assert bool(torch.isfinite(gm.allreduce(out.sum(), 3))), "3-D sharded step not finite"
    whole = cm3.opdef("heat3d_A")(gm.gather(u3))
    ref = whole[gm.block_slices(tuple(whole.shape))]
    mv_off = shardmap_opdef(cm3, "heat3d_A", gm, backend="torch")
    mv = shardmap_opdef(cm3, "heat3d_A", gm)
    assert _close(mv_off(u3), ref, 1e-5), "sharded matvec (kernels off) != whole grid"
    assert _close(mv(u3), ref, 1e-4), "sharded matvec (kernels) != whole grid"
    two = shardmap_sweeps(cm3, "heat3d_A", gm, 2)(u3)
    assert _close(two, mv_off(mv_off(u3)), 1e-4), "shardmap_sweeps(k=2) != two matvecs"
    x3, info = krylov.gmres(mv, u3, tol=1e-5, maxiter=60, restart=20, group=gm.mesh_group(3))
    assert info.converged, f"sharded GMRES did not converge: {info}"
    assert bool(torch.isfinite(x3).all())


def _part_2d_step(gm, dev, rng, ctx):
    """The 2-D implicit CG heat step through sharded_function."""
    from .parallel import sharded_function

    out = sharded_function(ctx["cm2"], "step", gm)(ctx["u2"])
    assert bool(torch.isfinite(gm.allreduce(out.sum(), 2))), "2-D sharded step not finite"


def _part_sharded_stencil(gm, dev, rng, ctx):
    """A raw halo exchange: sharded_stencil of a 5-pt average."""
    from .parallel import sharded_stencil

    def local_sweep(ext, info):
        return 0.25 * (ext[:-2, 1:-1] + ext[2:, 1:-1] + ext[1:-1, :-2] + ext[1:-1, 2:])

    out = sharded_stencil(local_sweep, gm, ((1, 1), (1, 1)), 2)(ctx["u2"])
    assert bool(torch.isfinite(gm.allreduce(out.sum(), 2))), "sharded_stencil not finite"


def _true_rel(mv, x, b, group) -> float:
    from .utils.tree import tnorm

    return float(tnorm(b - mv(x), group) / tnorm(b, group))


def _part_ca_krylov(gm, dev, rng, ctx):
    """CA-CG and CA-GMRES (s=3) and CA-BiCGStab (s=1) on heat_A; monomial
    CA-GMRES at s=3 in f32 warns, as the JAX package's does off a TPU."""
    import warnings

    from .parallel import bicgstab_sharded, cg_sharded, gmres_sharded

    cm2, b2, mv2, group = ctx["cm2"], ctx["u2"], ctx["mv2"], ctx["group"]
    for label, make, s in (("CA-CG", cg_sharded, 3), ("CA-GMRES", gmres_sharded, 3),
                           ("CA-BiCGStab", bicgstab_sharded, 1)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            solve = make(cm2, "heat_A", gm, s=s, maxiter=120, tol=1e-6)
        if make is gmres_sharded and not os.environ.get("NEPTUNE_ALLOW_MONOMIAL_SMALL_S"):
            assert any("monomial" in str(w.message) for w in caught), "no small-s warning"
        x, info = solve(b2)
        assert info.converged, f"{label} did not converge: {info}"
        rel = _true_rel(mv2, x, b2, group)
        assert rel <= 1e-5, f"{label} true relative residual {rel:.3e}"


def _part_jfnk(gm, dev, rng, ctx):
    """Newton-Krylov over the sharded residual mv(u) + 0.1 u^3 - b."""
    from .solvers import newton_krylov
    from .utils.tree import tnorm

    b2, mv2, group = ctx["u2"], ctx["mv2"], ctx["group"]

    def F(u):
        return mv2(u) + 0.1 * u * u * u - b2

    x, info = newton_krylov(F, torch.zeros_like(b2), tol=1e-6, group=group)
    assert info.converged, f"sharded JFNK did not converge: {info}"
    rel = float(tnorm(F(x), group) / tnorm(b2, group))
    assert rel <= 1e-5, f"sharded JFNK residual {rel:.3e}"


def _part_mg_pcg(gm, dev, rng, ctx):
    """CG preconditioned by the auto-coarsened V-cycle (two levels) over the
    mesh: every level's matvec sharded, the cycle on blocks."""
    from .lowering.executor import auto_mg_preconditioner
    from .solvers import krylov
    from .solvers.assemble import MatrixHandle

    cm2, b2, mv2, group = ctx["cm2"], ctx["u2"], ctx["mv2"], ctx["group"]
    fn2 = cm2.module.lookup("heat_A")
    handle = MatrixHandle(symbol="heat_A", matvec=mv2, temp_type=fn2.ftype.inputs[0],
                          structure_key_hash=fn2.attrs.get("structure_key_hash", 0),
                          halo=fn2.attrs.get("halo", ()))
    M = auto_mg_preconditioner(cm2.module, handle, cm2.backend, mg_levels=2, device=dev,
                               gmesh=gm)
    x, info = krylov.cg(mv2, b2, tol=1e-6, maxiter=120, M=M, group=group)
    assert info.converged, f"MG-preconditioned sharded CG did not converge: {info}"
    rel = _true_rel(mv2, x, b2, group)
    assert rel <= 1e-5, f"MG-CG true relative residual {rel:.3e}"


def _part_wide(gm, dev, rng, ctx):
    """The h0=2 wide stencil (4th-order advection, 256^2) over the mesh,
    against the whole grid; on the card kernel A's window form must have
    run."""
    from . import frontend as ntt
    from .lowering import cuda_backend
    from .parallel import shardmap_opdef

    nw = 256
    ntt.reset_context()

    @ntt.nonlinear_op_def(bounds=([0, 0], [nw, nw]), interior=([2, 2], [nw - 2, nw - 2]),
                          dtype="float32", name="adv4_dry")
    def adv4_dry(u):
        dudx = (-u[2, 0] + 8.0 * u[1, 0] - 8.0 * u[-1, 0] + u[-2, 0]) / 12.0
        dudy = (-u[0, 2] + 8.0 * u[0, 1] - 8.0 * u[0, -1] + u[0, -2]) / 12.0
        return u[0, 0] - 0.1 * (0.7 * dudx + 0.3 * dudy)

    cmw = ntt.get_context().compiled()
    xw = gm.shard(rng.standard_normal((nw, nw)).astype("float32"))
    before = cuda_backend.window_counter.count
    got = shardmap_opdef(cmw, "adv4_dry", gm)(xw)
    launched = cuda_backend.window_counter.count - before
    whole = cmw.opdef("adv4_dry")(gm.gather(xw))
    ref = whole[gm.block_slices(tuple(whole.shape))]
    assert _close(got, ref, 1e-4), "sharded wide stencil != whole grid"
    if xw.is_cuda:
        assert launched > 0, "the wide stencil did not run kernel A's window form"
    ntt.reset_context()


# (name, part(gm, dev, rng, ctx)), in the JAX package's order
_PARTS = (
    ("sharded 3-D GMRES step", _part_3d_gmres),
    ("2-D implicit CG step", _part_2d_step),
    ("sharded_stencil sweep", _part_sharded_stencil),
    ("CA-Krylov", _part_ca_krylov),
    ("sharded JFNK", _part_jfnk),
    ("MG-PCG over the mesh", _part_mg_pcg),
    ("wide stencil", _part_wide),
)


def _dryrun_rank(rank: int, n: int, port: str, device: str, backend: str, out: str) -> int:
    """One process of `dryrun_multichip`: join the group, run the parts on
    this process's blocks, write OUT/rankRANK.json."""
    import torch.distributed as dist

    from .parallel import GridMesh, initialize_multihost, shardmap_opdef

    torch.set_num_threads(1)
    initialize_multihost(f"127.0.0.1:{port}", n, rank, backend=backend)
    dev = torch.device(device)
    gm = GridMesh(mesh_shape_2d(n), ("x", "y"), device=dev)
    rng = np.random.default_rng(0)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    report = {"rank": rank, "device": str(dev), "seconds": {}, "failed": None}
    n2 = 8 * max(gm.shape)
    cm2 = build_step(n2, "float32", device=dev)
    ctx = {"cm2": cm2, "u2": gm.shard(gaussian(n2)), "group": gm.mesh_group(2),
           "mv2": shardmap_opdef(cm2, "heat_A", gm)}
    for i, (name, run) in enumerate(_PARTS, 1):
        t0 = time.perf_counter()
        try:
            run(gm, dev, rng, ctx)
            sync()
        except Exception:  # noqa: BLE001 -- reported to the parent, which raises
            report["failed"] = {"part": i, "name": name, "error": traceback.format_exc()}
            break
        report["seconds"][name] = time.perf_counter() - t0
    Path(out, f"rank{rank}.json").write_text(json.dumps(report))
    if report["failed"] is None:
        dist.barrier()
        dist.destroy_process_group()
    return 0 if report["failed"] is None else 1


# seconds the dry run's processes may take together
DRYRUN_TIMEOUT = 900


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The JAX package's multi-chip dry run (`__graft_entry__.dryrun_multichip`)
    over n_devices processes joined by `torch.distributed`, on the squarest
    2-D mesh, with its tiny f32 shapes and its seven parts: the sharded 3-D
    GMRES step, the 2-D CG step through sharded_function, a raw
    sharded_stencil sweep, CA-Krylov, sharded JFNK, MG-PCG over the mesh,
    and the h0=2 wide stencil.

    device: "cuda" (default `config.device`) or "cpu". On the CPU the
    processes join by gloo; with at least n_devices cards, process r takes
    card r and NCCL carries CUDA tensors; with fewer cards every process
    shares card 0 over gloo (NCCL refuses two processes on one card).
    Returns {"mesh", "backend", "device", "wall_s", "seconds": per part,
    rank 0's}; raises RuntimeError naming the part when a process fails in
    one."""
    backend, devices = local_ranks(n_devices, default_device(device))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="nt_dryrun_") as out:
        ranks = spawn_ranks(lambda r, port: [
            "-m", "neptune_tpu_torch.entry", "--dryrun-rank", str(r), str(n_devices), port,
            devices[r], backend, out], n_devices, DRYRUN_TIMEOUT)
        reports = [json.loads(Path(out, f"rank{r}.json").read_text())
                   if Path(out, f"rank{r}.json").exists() else None for r in range(n_devices)]
    wall = time.perf_counter() - t0
    failed = [(r, rep["failed"]) for r, rep in enumerate(reports) if rep and rep["failed"]]
    if failed:
        r, f = min(failed, key=lambda rf: rf[1]["part"])
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) part {f['part']} ({f['name']}) failed on rank {r} "
            f"of mesh {mesh_shape_2d(n_devices)}:\n{f['error']}")
    bad = [r for r, ((code, _), rep) in enumerate(zip(ranks, reports)) if code or rep is None]
    if bad:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}): ranks {bad} exited "
            f"{[ranks[r][0] for r in bad]}:\n" + "\n".join(ranks[r][1][-4000:] for r in bad))
    return {"mesh": mesh_shape_2d(n_devices), "backend": backend, "device": devices[0],
            "wall_s": wall, "seconds": reports[0]["seconds"]}


if __name__ == "__main__" and sys.argv[1:2] == ["--dryrun-rank"]:
    _rank, _n, _port, _device, _backend, _out = sys.argv[2:8]
    sys.exit(_dryrun_rank(int(_rank), int(_n), _port, _device, _backend, _out))
