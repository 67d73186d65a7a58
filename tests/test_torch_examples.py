"""The port's programs of `examples/` (`neptune_tpu_torch/examples/`) on the
CPU, against the JAX package's run of the same examples, in f64.

The examples import the JAX package and are not edited: each reference
comes from the example's own namespace (`runpy.run_path`); where only its
main() holds the program, the test repeats main()'s lines with the JAX
package's functions, at reduced steps. The port's modules run afresh
(`runpy.run_module`) in a fresh DSL context, with `--cpu` on the command
line as the examples read it. Tolerances: states within 1e-10 relative
(TOL), solver iterations within 1, solutions within 1e-8 relative at tol
1e-10. The mesh examples run on a mesh of one process here and on (2,2) in
the file's one spawn of four gloo processes (`torch_ca_worker.py
examples`), against the JAX package's GridMesh((2,2)) on four virtual
devices.
"""

import os
import re
import runpy
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import neptune_tpu as ntp  # noqa: E402
import neptune_tpu_torch as ntt  # noqa: E402
import torch_ca_cases as cases  # noqa: E402
import torch_ca_worker as worker  # noqa: E402
import torch_examples  # noqa: E402
from neptune_tpu_torch.config import config as torch_config  # noqa: E402
from neptune_tpu_torch.examples import _cli  # noqa: E402
from neptune_tpu_torch.parallel import GridMesh  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
PORT_EXAMPLES = ROOT / "neptune_tpu_torch" / "examples"
TOL = 1e-10


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    monkeypatch.setattr(torch_config, "device", "cpu")
    # what `python examples/X.py --cpu` and `python -m ... X --cpu` see
    monkeypatch.setattr(sys, "argv", ["example", "--cpu"])


@pytest.fixture(autouse=True)
def fresh_contexts():
    ntp.reset_context()
    ntt.reset_context()
    yield
    ntp.reset_context()
    ntt.reset_context()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's eager f64 loops, one thread each: the CPU is shared with
    the other test workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _rel(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max() / max(np.abs(ref).max(), 1.0)


def _pair(name):
    """(the JAX example's namespace, the port module's), both run afresh."""
    return runpy.run_path(str(EXAMPLES / f"{name}.py")), torch_examples.port_example(name)


def test_allen_cahn_three_integrators():
    ex = runpy.run_path(str(EXAMPLES / "allen_cahn.py"))  # defines its opdefs
    x = np.linspace(-1, 1, ex["N"])
    u0 = 0.9 * np.sign(np.sin(4 * np.pi * x)) + 0.05 * np.cos(2 * np.pi * x)
    ref = []
    for step in (
        ex["imex_step"],
        ex["newton_step"],
        lambda u: ntp.time_advance(u, ex["DT"], "explicit", rhs=ex["ac_rhs"], scheme="rk4"),
    ):
        u = u0.copy()
        for _ in range(20):
            u = np.asarray(step(u))
        ref.append((float(np.sum(u**2)), u))
    got = torch_examples.allen_cahn_energies(u0, 20)
    for (e_ref, u_ref), (e, u) in zip(ref, got):
        assert abs(e - e_ref) <= TOL * abs(e_ref)
        assert _rel(u, u_ref) <= TOL


def test_swe_implicit_ten_steps():
    ex = runpy.run_path(str(EXAMPLES / "swe_implicit.py"))
    solver = ex["ImplicitSWESolver"](dt=0.1, dx=1.0, nx=100)
    h = np.ones(100)
    h[:50] = 2.0
    q = np.zeros(100)
    ref_rows = []
    for _ in range(10):
        h, q = (np.asarray(a) for a in solver.step(h, q))
        ref_rows.append((h.mean(), np.abs(q).max()))
    rows, (h_got, q_got) = torch_examples.swe_run(10)
    for (hm_ref, qm_ref), (hm, qm) in zip(ref_rows, rows):
        assert abs(hm - hm_ref) <= TOL and abs(qm - qm_ref) <= TOL * max(qm_ref, 1.0)
    assert _rel(h_got, h) <= TOL and _rel(q_got, q) <= TOL


def test_multigrid_poisson_128():
    """examples/multigrid_poisson.py's main() at 128^2 in f64: V-cycles, plain
    CG and MG-preconditioned CG iterations within 1 of the JAX package's,
    the error against u* within 1e-8 of its."""
    ex = runpy.run_path(str(EXAMPLES / "multigrid_poisson.py"))
    tol = torch_examples.MG_TOL
    ops = [ntp.assemble_matrix(ex["poisson"](n, "float64")) for n in torch_examples.MG_SIZES]
    u_star = torch_examples.mg_manufactured()
    b = ops[0].matvec(jnp.asarray(u_star))
    x, info = ex["multigrid_solve"](ops, b, tol=tol, maxiter=60)
    _, plain = ex["cg"](ops[0].matvec, b, tol=tol, maxiter=20000)
    _, pre = ex["cg"](ops[0].matvec, b, tol=tol, maxiter=200, M=ex["mg_preconditioner"](ops, b))
    err_ref = float(np.abs(np.asarray(x) - u_star).max())
    got = torch_examples.multigrid_poisson_run()
    assert all(got["converged"])
    for key, ref in (("cycles", info.iters), ("cg", plain.iters), ("pcg", pre.iters)):
        assert abs(got[key] - int(ref)) <= 1, (key, got[key], int(ref))
    assert got["resnorm"] <= tol * float(np.linalg.norm(np.asarray(b)))
    assert abs(got["err"] - err_ref) <= 1e-8, (got["err"], err_ref)


def test_preconditioned_poisson_mg_row(capsys):
    """examples/preconditioned_poisson.py's ("mg", {"mg_levels": 4}) row: CG
    iterations (each package's verbose KSP line) within 1, the relative
    residual under 1e-10, the solution within 1e-8 of the example's."""
    capsys.readouterr()
    ex = runpy.run_path(str(EXAMPLES / "preconditioned_poisson.py"))
    ref_it = int(re.findall(r"KSP\(cg\) poisson: iters=(\d+)", capsys.readouterr().out)[-1])
    x_ref = ex["x"]  # the last row's solution
    x, rel = torch_examples.preconditioned_poisson_mg()
    (it,) = re.findall(r"KSP\(cg\) poisson: iters=(\d+)", capsys.readouterr().out)
    assert abs(int(it) - ref_it) <= 1, (it, ref_it)
    assert rel <= torch_examples.PC_TOL and ex["results"]["mg"][1] <= ex["TOL"] * 1.01
    assert np.abs(x - np.asarray(x_ref)).max() <= 1e-8 * np.abs(np.asarray(x_ref)).max()


# ---- the ten programs ported in full --------------------------------------


def test_heat_implicit_ten_steps():
    """Ten @jit_class CG steps: the state within TOL, and the traced IR that
    main() prints is the JAX package's, character for character."""
    ref, port = _pair("heat_implicit")
    solver = ref["HeatSolver"](dt=ref["DT"])
    u = np.exp(-(np.linspace(-3, 3, ref["N"]) ** 2))
    for _ in range(10):
        u = np.asarray(solver.step(u))
    got = port["main"]()
    assert _rel(got["u"], u) <= TOL
    u0 = np.exp(-(np.linspace(-3, 3, ref["N"]) ** 2))
    assert abs(got["sum"] - u.sum()) <= TOL * u.sum() and got["max0"] == u0.max()
    assert got["ir"] == ntp.get_compiler().dump()


def test_heat3d_explicit_20_steps():
    ref, port = _pair("heat3d_explicit")
    n, dt, kappa = ref["N"], ref["DT"], ref["KAPPA"]
    xs = np.linspace(0.0, 1.0, n)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    mode = np.sin(np.pi * X) * np.sin(np.pi * Y) * np.sin(np.pi * Z)
    ring = np.ones((n, n, n), bool)
    ring[1:-1, 1:-1, 1:-1] = False
    interior = jnp.asarray(~ring)
    u = ref["simulate"](
        lambda u: jnp.where(interior, u + dt * kappa * ref["lap3"](u), 0.0), jnp.asarray(mode), 20)
    got = port["main"](steps=20)
    assert _rel(got["u"], u) <= TOL and got["err"] < 1e-10


def test_gray_scott_20_steps():
    ref, port = _pair("gray_scott")
    n, dt, du, dv, f, k = (ref[c] for c in ("N", "DT", "DU", "DV", "F", "K"))
    rng = np.random.default_rng(0)
    u0, v0 = np.ones((n, n)), np.zeros((n, n))
    c = n // 2
    u0[c - 8 : c + 8, c - 8 : c + 8] = 0.50
    v0[c - 8 : c + 8, c - 8 : c + 8] = 0.25
    u0 += 0.02 * rng.standard_normal((n, n))
    v0 += 0.02 * rng.standard_normal((n, n))

    def step(state):
        u, v = state
        r = ref["react"](u, v)
        return (u + dt * (du * ref["lap_t"](u) - r + f * (1.0 - u)),
                v + dt * (dv * ref["lap_t"](v) + r - (f + k) * v))

    u, v = ref["simulate"](step, (jnp.asarray(u0), jnp.asarray(v0)), 20)
    got = port["main"](steps=20)
    assert _rel(got["u"], u) <= TOL and _rel(got["v"], v) <= TOL
    assert got["err"] < 1e-10 and got["var0"] == float(np.var(v0))


def test_wave_leapfrog_20_steps():
    ref, port = _pair("wave_leapfrog")
    n, dt, c = ref["N"], ref["DT"], ref["C"]
    xs = np.linspace(0.0, 1.0, n)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    u0 = np.sin(np.pi * X) * np.sin(np.pi * Y)
    omega = np.sqrt(2.0) * np.pi * c
    v0 = u0 * omega * np.sin(omega * (0.5 * dt))
    ring = np.ones((n, n), bool)
    ring[1:-1, 1:-1] = False
    interior = jnp.asarray(~ring)

    def step(state):
        u, v = state
        v = jnp.where(interior, v + dt * (c * c) * ref["lap"](u), 0.0)
        return (u + dt * v, v)

    u, v = ref["simulate"](step, (jnp.asarray(u0), jnp.asarray(v0)), 20)
    got = port["main"](steps=20)
    assert _rel(got["u"], u) <= TOL and _rel(got["v"], v) <= TOL


def test_black_scholes_five_steps():
    """Five steps of the backward induction: Newton on a residual whose
    coefficients depend on `index`, with a `temp` capture."""
    ref, port = _pair("black_scholes")
    n, ds, dt, r_, sigma = (ref[c] for c in ("N", "DS", "DT", "R", "SIGMA"))

    def residual_factory(v_prev_arr):
        v_prev = ntp.temp(v_prev_arr)

        def residual(v):
            i = ntp.index(0)
            boundary = (i == 0) | (i == n - 1)
            Sg = (i * 1.0) * ds
            a = 0.5 * sigma * sigma * Sg * Sg
            b = r_ * Sg
            vxx = (v[-1] - 2.0 * v[0] + v[1]) / (ds * ds)
            vx = (v[1] - v[-1]) / (2.0 * ds)
            L = a * vxx + b * vx - r_ * v[0]
            return ntp.where(boundary, v[0] - v_prev[0], v[0] - dt * L - v_prev[0])

        return residual

    S = np.linspace(0, ref["S_MAX"], n)
    v = np.maximum(S - ref["K"], 0.0)
    for _ in range(5):
        v = np.asarray(ntp.solve_nonlinear(residual_factory(v), v, tol=1e-10, max_iters=20))
    got = port["main"](steps=5)
    assert _rel(got["v"], v) <= TOL
    idx = np.searchsorted(S, 100.0)
    assert abs(got["price"] - v[idx]) <= TOL * v[idx]


def test_navier_stokes_driver_resume(tmp_path):
    """main() at 10 steps and a resume to 20 (a checkpoint at step 10),
    through each package's SimulationDriver: the states, the step counts and
    the diagnostics of the converged streamfunction."""
    ref, port = _pair("navier_stokes")
    n = ref["N"]
    driver = ref["SimulationDriver"](ref["make_step"](), tmp_path / "jax.npz",
                                     checkpoint_every=200, dt=ref["DT"])
    init = {"w": np.zeros((n, n))}
    state, steps = driver.run(init, 10)
    u, _, psi = ref["velocities"](jnp.asarray(state["w"]))
    state2, steps2 = driver.run(init, 20)
    got = port["main"](tmp_path / "port.npz", steps=10, resume_to=20)
    assert (got["n"], got["n2"]) == (steps, steps2) == (10, 20)
    assert _rel(got["w"], state["w"]) <= TOL and _rel(got["w2"], state2["w"]) <= TOL
    assert abs(got["center_u"] - u[n // 2, n // 2]) <= TOL
    assert abs(got["min_psi"] - psi.min()) <= TOL * abs(psi.min())


def test_inverse_problem_three_gradient_steps():
    """Three steps of gradient descent, each gradient one forward and one
    adjoint CG solve (jax.grad against torch.autograd through
    differentiable_solve), fed the same NumPy noise."""
    ref, port = _pair("inverse_problem")
    n = ref["N"]
    eps = 1e-4 * np.random.default_rng(0).standard_normal((n, n))
    mv = ntp.get_context().compiled().opdef("A")
    xx, yy = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    f_true = jnp.asarray(np.exp(-((xx - 15) ** 2 + (yy - 15) ** 2) / 20.0) - 0.7 * np.exp(
        -((xx - 32) ** 2 + (yy - 30) ** 2) / 30.0))

    def forward(f):
        return ntp.differentiable_solve(mv, f, solver="cg", symmetric=True, tol=1e-12,
                                        maxiter=3000)

    u_obs = forward(f_true) + eps
    grad = jax.jit(jax.grad(lambda f: jnp.mean((forward(f) - u_obs) ** 2)))
    f = jnp.zeros((n, n))
    for _ in range(3):
        f = f - 10.0 * grad(f)
    got = port["main"](iters=3, eps=eps)
    assert _rel(got["f"], f) <= TOL
    assert abs(got["err"] - float(jnp.abs(f - f_true).max())) <= TOL


# ---- the mesh examples: one process here, (2,2) in four -------------------


def _jax_mesh():
    from neptune_tpu.parallel import GridMesh as JaxGridMesh

    return JaxGridMesh((2, 2), ("x", "y"), devices=jax.devices()[:4])


def _jax_multichip(gm):
    from neptune_tpu.solvers import cg

    ex = runpy.run_path(str(EXAMPLES / "multichip_poisson.py"))
    cm = ntp.get_context().compiled()
    b = np.random.default_rng(0).standard_normal((ex["N"], ex["N"]))
    x, info = jax.jit(lambda bb: cg(cm.opdef("poisson"), bb, tol=1e-10, maxiter=3000))(
        gm.shard(jnp.asarray(b)))
    return {"x": np.asarray(x), "iters": int(info.iters)}


def _jax_comm_avoiding(gm):
    from neptune_tpu.parallel import chebyshev_sharded, shardmap_opdef, shardmap_sweeps

    ex = runpy.run_path(str(EXAMPLES / "comm_avoiding_jacobi.py"))
    n, k, rounds = ex["N"], ex["K"], ex["ROUNDS"]
    cm = ntp.get_context().compiled()
    ii = np.arange(n)
    mode = np.sin(np.pi * ii[:, None] / (n - 1)) * np.sin(np.pi * ii[None, :] / (n - 1))
    mode[0, :] = mode[-1, :] = mode[:, 0] = mode[:, -1] = 0.0
    u0 = gm.shard(jnp.asarray(mode))
    mv = shardmap_opdef(cm, "jacobi_sweep", gm)
    fk = shardmap_sweeps(cm, "jacobi_sweep", gm, k)
    naive = jax.jit(lambda u: jax.lax.fori_loop(0, k * rounds, lambda i, v: mv(v), u))(u0)
    ca = jax.jit(lambda u: jax.lax.fori_loop(0, rounds, lambda i, v: fk(v), u))(u0)

    @ntp.linear_op_def(bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]),
                       name="poisson_ca")
    def poisson_ca(u):
        return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

    lmin = 2.0 * (2.0 - 2.0 * np.cos(np.pi / (n + 1)))
    b = np.zeros((n, n))
    b[1:-1, 1:-1] = np.random.default_rng(3).standard_normal((n - 2, n - 2))
    solve = jax.jit(chebyshev_sharded(ntp.get_context().compiled(), "poisson_ca", gm,
                                      lam_min=lmin, lam_max=8.0, k_fuse=k, maxiter=4000,
                                      tol=1e-8))
    xs, info = solve(gm.shard(jnp.asarray(b)))
    return {"naive": np.asarray(naive), "ca": np.asarray(ca), "xs": np.asarray(xs),
            "cheb_iters": int(info.iters)}


def _jax_ca_krylov(gm):
    """The example's baseline, per-iteration CG over the shard_map matvec
    (its CA solvers' f32 counts follow roundoff: they are held to their
    true residuals), and its CA-BiCGStab(2), whose numbers are printed."""
    from neptune_tpu.parallel import bicgstab_sharded, shardmap_opdef
    from neptune_tpu.solvers import cg

    ex = runpy.run_path(str(EXAMPLES / "ca_krylov_poisson.py"))
    n = ex["N"]
    b = np.zeros((n, n), np.float32)
    b[1:-1, 1:-1] = np.random.default_rng(0).standard_normal((n - 2, n - 2)).astype(np.float32)
    cm = ntp.get_context().compiled()
    mv = jax.jit(shardmap_opdef(cm, "poisson", gm))
    bs = gm.shard(jnp.asarray(b))
    _, info = jax.jit(lambda bb: cg(mv, bb, tol=1e-4, maxiter=4000))(bs)
    x, bi = jax.jit(bicgstab_sharded(cm, "poisson", gm, s=2, maxiter=4000, tol=1e-4))(bs)
    return {"cg_iters": int(info.iters), "bicgstab_iters": int(bi.iters),
            "bicgstab_converged": bool(bi.converged),
            "bicgstab_rel": float(jnp.linalg.norm(bs - mv(x)) / jnp.linalg.norm(bs))}


def _jax_bicgstab64(gm):
    """The example's CA-BiCGStab(2) on its system in f64 (the worker's
    `bicgstab_float64_0`)."""
    from neptune_tpu.parallel import bicgstab_sharded, shardmap_opdef

    n, tol = 128, 1e-4

    @ntp.linear_op_def(bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]),
                       dtype="float64")
    def poisson(u):
        return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

    cm = ntp.get_context().compiled()
    bs = gm.shard(jnp.asarray(worker.bicgstab_rhs(n, "float64", 0)))
    x, info = jax.jit(bicgstab_sharded(cm, "poisson", gm, s=2, maxiter=4000, tol=tol))(bs)
    true = float(jnp.linalg.norm(bs - jax.jit(shardmap_opdef(cm, "poisson", gm))(x)))
    return {"x": np.asarray(x), "iters": int(info.iters), "converged": bool(info.converged),
            "true": true}


JAX_MESH = {"multichip_poisson": _jax_multichip, "comm_avoiding_jacobi": _jax_comm_avoiding,
            "ca_krylov_poisson": _jax_ca_krylov, "bicgstab_float64_0": _jax_bicgstab64}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The four ranks' runs of the mesh examples on (2,2), and meanwhile the
    JAX references on GridMesh((2,2)): ({name: rank 0's result}, {name:
    the reference})."""
    spawn = cases.Spawn("examples", tmp_path_factory.mktemp("examples"))
    refs = {}
    try:
        gm = _jax_mesh()
        for name, run in JAX_MESH.items():
            ntp.reset_context()
            refs[name] = run(gm)
        ntp.reset_context()
    finally:
        results, infos = spawn.results(timeout=600)
    four = {}
    for key, v in list(results.items()) + list(infos.items()):
        name, k = key.split("/")
        four.setdefault(name, {})[k] = v
    return four, refs


def _one_process(name):
    """The port module's main() on a mesh of one process, here."""
    gm = GridMesh((1, 1), ("x", "y"), device="cpu")
    return torch_examples.port_example(name)["main"](gm)


def test_multichip_poisson_meshes(mesh_runs):
    four, refs = mesh_runs
    ref = refs["multichip_poisson"]
    for got in (_one_process("multichip_poisson"), four["multichip_poisson"]):
        assert got["converged"] and abs(got["iters"] - ref["iters"]) <= 1, (got["iters"], ref)
        assert np.abs(got["x"] - ref["x"]).max() <= 1e-8 * np.abs(ref["x"]).max()
        assert got["matvec_dev"] == 0.0 and got["max_residual"] <= 1e-8


def test_comm_avoiding_jacobi_meshes(mesh_runs):
    four, refs = mesh_runs
    ref = refs["comm_avoiding_jacobi"]
    for got in (_one_process("comm_avoiding_jacobi"), four["comm_avoiding_jacobi"]):
        assert got["dev"] < 1e-10 and abs(got["measured"] - got["predicted"]) < 5e-3
        assert _rel(got["naive"], ref["naive"]) <= TOL and _rel(got["ca"], ref["ca"]) <= TOL
        assert got["cheb_iters"] == ref["cheb_iters"] and got["cheb_rel"] < 1e-6
        assert np.abs(got["xs"] - ref["xs"]).max() <= 1e-8 * np.abs(ref["xs"]).max()


def test_ca_krylov_poisson_meshes(mesh_runs):
    """On one process main()'s own checks hold: every solve converged, its
    true residual under 1.6 tol, the reported one within 30% of it. On
    (2,2) every reported residual is still the true one, and per-iteration
    CG, CA-CG and CA-GMRES converge under 1.6 tol; CA-BiCGStab(2) in f32
    stops at its stall exit there, where the JAX package's converges
    (ROADMAP queue 3, open), so it is held to its honest report, as it is
    on the right-hand sides of seeds 1 and 2; both packages' numbers are
    printed. In f64 on (2,2) it converges under 1.6 tol, as the JAX
    package's does there (s-step counts follow roundoff in f64 too).
    Per-iteration CG takes the JAX package's iterations within 1 on both
    meshes."""
    four, refs = mesh_runs
    one = _one_process("ca_krylov_poisson")
    cg_iters = refs["ca_krylov_poisson"]["cg_iters"]
    for got in (one, four["ca_krylov_poisson"]):
        bn = got["bnorm"]
        for name in ("cg", "ca_cg", "ca_gmres", "ca_bicgstab"):
            true, rep = got[f"{name}_true"], got[f"{name}_resnorm"]
            assert abs(rep - true) <= 0.3 * true + 1e-6 * bn, (name, rep, true)
            if got is one or name != "ca_bicgstab":
                assert got[f"{name}_converged"] and true <= 1.6e-4 * bn, (name, true / bn)
        assert abs(got["cg_iters"] - cg_iters) <= 1, (got["cg_iters"], cg_iters)
    got, ref = four["ca_krylov_poisson"], refs["ca_krylov_poisson"]
    print(f"f32 CA-BiCGStab(2) on (2,2), the example's right-hand side: {got['ca_bicgstab_iters']} "
          f"iterations, converged {got['ca_bicgstab_converged']}, true relative residual "
          f"{got['ca_bicgstab_true'] / got['bnorm']!r}; JAX package {ref['bicgstab_iters']}, "
          f"{ref['bicgstab_converged']}, {ref['bicgstab_rel']!r}")
    for seed in (1, 2):
        got = four[f"bicgstab_float32_{seed}"]
        bn, true, rep = got["bnorm"], got["true"], got["resnorm"]
        print(f"f32 CA-BiCGStab(2) on (2,2), right-hand side of seed {seed}: {got['iters']} "
              f"iterations, converged {got['converged']}, true relative residual {true / bn!r}")
        assert abs(rep - true) <= 0.3 * true + 1e-6 * bn, (seed, rep, true)
    got, ref = four["bicgstab_float64_0"], refs["bicgstab_float64_0"]
    print(f"f64 CA-BiCGStab(2) on (2,2): {got['iters']} iterations (JAX package {ref['iters']}), "
          f"true relative residual {got['true'] / got['bnorm']!r}")
    for run in (got, ref):
        assert run["converged"] and run["true"] <= 1.6e-4 * got["bnorm"], run["true"]


# ---- coverage and the command line -----------------------------------------


def test_every_example_has_a_port():
    names = sorted(p.stem for p in EXAMPLES.glob("*.py"))
    ported = sorted(p.stem for p in PORT_EXAMPLES.glob("*.py") if not p.stem.startswith("_"))
    assert len(names) >= 9 and ported == names


def test_port_examples_import_no_jax():
    """Every port example, imported in a fresh process, leaves neither JAX
    nor the JAX package in sys.modules."""
    names = sorted(p.stem for p in PORT_EXAMPLES.glob("*.py") if not p.stem.startswith("_"))
    code = (
        "import importlib, sys\n"
        "import neptune_tpu_torch as ntt\n"
        f"for name in {names!r}:\n"
        "    ntt.reset_context()\n"
        "    importlib.import_module('neptune_tpu_torch.examples.' + name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'neptune_tpu'))\n"
        "print(sum(m.startswith('neptune_tpu_torch.examples.') for m in sys.modules))\n"
        "sys.exit(f'imported {bad}' if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[-1]) == len(names) + 1  # and _cli


@pytest.mark.parametrize("name", ["heat_implicit", "gray_scott"])
def test_cheap_examples_run_with_cpu_flag(name):
    """`python -m neptune_tpu_torch.examples.NAME --cpu` exits 0; its wall
    seconds go to the test's output."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", f"neptune_tpu_torch.examples.{name}", "--cpu"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    print(f"{name} --cpu: {time.perf_counter() - t0:.1f} s")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "nan" not in r.stdout.lower().split()


def test_cli_needs_a_card_without_cpu_flag(monkeypatch):
    """No fallback: without --cpu the examples ask for the card, and raise
    where there is none; --procs N takes a positive count."""
    monkeypatch.setattr(sys, "argv", ["example"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _cli.device()
    monkeypatch.setattr(sys, "argv", ["example", "--cpu", "--procs", "4"])
    assert _cli.device() == torch.device("cpu") and _cli.procs_requested() == 4
    monkeypatch.setattr(sys, "argv", ["example", "--procs", "0"])
    with pytest.raises(ValueError, match="--procs"):
        _cli.procs_requested()
