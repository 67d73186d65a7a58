"""The port's communication-avoiding solvers on four processes against the
JAX package's.

One spawn for the whole file (`ranks` fixture): four CPU processes join a
gloo group on localhost (`torch_ca_worker.py ca`) and run every case of
`torch_ca_cases` on their own blocks. Here, in the parent, the JAX package
runs the same printed IR through its own `cg_sharded` / `gmres_sharded` /
`bicgstab_sharded` / `chebyshev_sharded` on four of the eight virtual CPU
devices, with the same mesh shape, and the tests compare: at fixed
iteration counts (f64, tol=0) the same iterations, x within 1e-10
relative and the residual norm within 1e-8 relative (the Gram reductions
sum in another order than `lax.psum`); converged solves within one outer
block of the JAX package's iterations, with the true residual under
1.5·tol·||b||.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_ca_cases as cases  # noqa: E402
from neptune_tpu.ir import verify_and_annotate as jax_verify  # noqa: E402
from neptune_tpu.ir.parser import parse_module as jax_parse  # noqa: E402
from neptune_tpu.lowering.executor import CompiledModule as JaxCompiledModule  # noqa: E402
from neptune_tpu.parallel import GridMesh as JaxGridMesh  # noqa: E402
from neptune_tpu.parallel import bicgstab_sharded as jax_bicgstab_sharded  # noqa: E402
from neptune_tpu.parallel import cg_sharded as jax_cg_sharded  # noqa: E402
from neptune_tpu.parallel import chebyshev_sharded as jax_chebyshev_sharded  # noqa: E402
from neptune_tpu.parallel import gmres_sharded as jax_gmres_sharded  # noqa: E402
from neptune_tpu_torch import stencils  # noqa: E402
from neptune_tpu_torch.config import config as torch_config  # noqa: E402
from neptune_tpu_torch.ir import print_module  # noqa: E402
from neptune_tpu_torch.lowering import cuda_backend  # noqa: E402
from neptune_tpu_torch.lowering.executor import CompiledModule  # noqa: E402
from neptune_tpu_torch.parallel import (  # noqa: E402
    GridMesh,
    bicgstab_sharded,
    cg_sharded,
    chebyshev_sharded,
    gmres_sharded,
)

WORLD = 4
JAX_SOLVERS = {
    "cg": jax_cg_sharded,
    "gmres": jax_gmres_sharded,
    "bicgstab": jax_bicgstab_sharded,
    "chebyshev": jax_chebyshev_sharded,
}
PORT_SOLVERS = {
    "cg": cg_sharded,
    "gmres": gmres_sharded,
    "bicgstab": bicgstab_sharded,
    "chebyshev": chebyshev_sharded,
}


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The port puts NumPy inputs on `config.device`, the card by default:
    these CPU tests ask for the CPU."""
    monkeypatch.setattr(torch_config, "device", "cpu")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the four ranks once, and meanwhile every JAX reference: (their
    gathered results, their infos, the references by case name)."""
    spawn = cases.Spawn("ca", tmp_path_factory.mktemp("ca"))
    refs = {}
    try:
        for name, (op_name, mesh, solver, kw, jacobi, seed) in cases.FIXED.items():
            refs[f"fixed/{name}"] = _jax_solve(op_name, mesh, solver, dict(kw, tol=0.0), seed, jacobi)
        for name, (op_name, mesh, solver, kw, seed) in cases.CONVERGED.items():
            refs[f"converged/{name}"] = _jax_solve(op_name, mesh, solver, kw, seed)
    finally:
        results, infos = spawn.results()
    return results, infos, refs


def _jax_solve(op_name, mesh, solver, kw, seed, jacobi=False):
    """The JAX package's solve of the same printed operator on the same
    mesh shape over four virtual devices: (x, info, module, opdef, b)."""
    build, opdef, centre = cases.OPERATORS[op_name]
    module = build()
    jcm = JaxCompiledModule(jax_verify(jax_parse(print_module(module))), "jnp")
    gm = JaxGridMesh(mesh, cases.AXES[: len(mesh)], devices=jax.devices()[:WORLD])
    if jacobi:
        kw = dict(kw, inv_diag=jnp.asarray(cases.jacobi_inv_diag(module, opdef, centre)))
    b = cases.rhs(module, opdef, seed)
    x, info = jax.jit(JAX_SOLVERS[solver](jcm, opdef, gm, **kw))(gm.shard(jnp.asarray(b)))
    return np.asarray(x), info, module, opdef, b


def _true_residual(module, opdef, x, b):
    A = CompiledModule(module, backend="torch").opdef(opdef)
    return float(np.linalg.norm(b - A(torch.from_numpy(x)).numpy()))


def _block(solver, kw) -> int:
    """Iterations per outer block (per check, for Chebyshev)."""
    if solver == "chebyshev":
        return kw["k_fuse"] * max(kw.get("check_every", 1), 1)
    return kw["s"]


@pytest.mark.parametrize("name", cases.FIXED)
def test_fixed_iterations_match_jax(ranks, name):
    results, infos, refs = ranks
    _, _, _, _, jacobi, _ = cases.FIXED[name]
    ref, rinfo, module, opdef, b = refs[f"fixed/{name}"]
    got, info = results[f"fixed/{name}"], infos[f"fixed/{name}"]
    assert info["iters"] == int(rinfo.iters)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= 1e-10, err
    rn = float(rinfo.resnorm)
    assert abs(info["resnorm"] - rn) <= 1e-8 * rn, (info["resnorm"], rn)
    if not jacobi:
        # the reported norm is the true one over the whole grid: a field of
        # fewer dims than the mesh (rank 1 on (2,2)) is summed once, not
        # once per replica
        true = _true_residual(module, opdef, got, b)
        assert abs(info["resnorm"] - true) <= 1e-8 * true, (info["resnorm"], true)


@pytest.mark.parametrize("name", cases.CONVERGED)
def test_converged_match_jax(ranks, name):
    results, infos, refs = ranks
    _, _, solver, kw, _ = cases.CONVERGED[name]
    _, rinfo, module, opdef, b = refs[f"converged/{name}"]
    got, info = results[f"converged/{name}"], infos[f"converged/{name}"]
    assert info["converged"] and bool(rinfo.converged)
    assert abs(info["iters"] - int(rinfo.iters)) <= _block(solver, kw)
    assert _true_residual(module, opdef, got, b) <= kw["tol"] * np.linalg.norm(b) * 1.5


@pytest.mark.parametrize("name", cases.ORACLE)
def test_matches_per_iteration_cg_in_port(ranks, name):
    """CA-CG at fixed iterations equals per-iteration CG over the sharded
    matvec with the mesh's group (the JAX package's own check)."""
    results = ranks[0]
    ca, pi = results[f"fixed/{name}"], results[f"oracle/{name}"]
    assert np.abs(ca - pi).max() / np.abs(pi).max() < 1e-10


def test_communication_structure(ranks):
    """CA-CG at s=8: one exchange round of two fields (8 ring shifts on a
    (2,2) mesh) and one Gram reduction per outer block, plus the one-off
    ones (the constants' strips and ||b|| before the loop, the final true
    residual's strips and norm); per-iteration CG exchanges on every
    iteration and reduces at least twice per iteration."""
    c = cases.COMM
    comm = ranks[1]["comm"]
    blocks = c["iters"] // c["s"]
    assert comm["ca_iters"] == comm["pi_iters"] == c["iters"]
    assert comm["ca_shifts"] == 8 * blocks + 4 + 4
    assert comm["ca_reductions"] == blocks + 2
    assert comm["pi_shifts"] >= 4 * c["iters"]
    assert comm["pi_reductions"] >= 2 * c["iters"]


@pytest.mark.parametrize(
    "kw, match",
    [
        (dict(s=20), "not eligible"),
        (dict(basis="newton"), "basis"),
        (dict(basis="chebyshev"), "lam_min"),
    ],
)
@pytest.mark.parametrize("solver", ["cg", "gmres", "bicgstab"])
def test_eligibility_errors_match_jax(solver, kw, match):
    module = stencils.poisson5(64, "float64")
    jcm = JaxCompiledModule(jax_verify(jax_parse(print_module(module))), "jnp")
    with pytest.raises(ValueError, match=match) as want:
        JAX_SOLVERS[solver](jcm, "poisson", JaxGridMesh((4, 2), ("x", "y")), **kw)
    with pytest.raises(ValueError, match=match) as got:
        PORT_SOLVERS[solver](
            CompiledModule(module), "poisson", GridMesh((4, 2), ("x", "y"), abstract=True), **kw
        )
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("solver", ["cg", "gmres", "bicgstab", "chebyshev"])
def test_kernel_route_takes_window_form(monkeypatch, solver):
    """On a kernel backend every chain's core matvec goes to kernel A's
    window form (its plain version on the CPU) and nothing else does; the
    kernels-off module ("torch") never calls it; both give the same
    iterations and bitwise the same x."""
    calls = []
    window = cuda_backend.apply_window

    def counted(op, inputs, scalars, global_start):
        calls.append(tuple(inputs[0].shape))
        return window(op, inputs, scalars, global_start)

    monkeypatch.setattr(cuda_backend, "apply_window", counted)
    module = stencils.poisson5(32)
    gm = GridMesh((1,), ("x",), device="cpu")
    b = cases.rhs(module, "poisson", 0).astype(np.float32)
    kw = dict(maxiter=24, tol=0.0)
    kw.update(
        dict(lam_min=cases.lam_min(32), lam_max=8.0, k_fuse=4)
        if solver == "chebyshev"
        else dict(s=4 if solver == "cg" else 2, basis="chebyshev", lam_min=0.01, lam_max=8.0)
    )
    runs = []
    for backend in ("auto", "torch"):
        calls.clear()
        solve = PORT_SOLVERS[solver](CompiledModule(module, backend), "poisson", gm, **kw)
        x, info = solve(b)
        runs.append((x, info.iters, len(calls)))
        assert all(shape == (32, 32) for shape in calls)
    (x_k, it_k, n_k), (x_t, it_t, n_t) = runs
    assert n_k > 0 and n_t == 0
    assert it_k == it_t
    assert torch.equal(x_k, x_t)


def test_gmres_monomial_small_s_warns(monkeypatch):
    """The JAX package's guard: f32 monomial CA-GMRES at s <= 4 warns (off
    a TPU), without stating a TPU measurement as this port's, and the
    override silences it."""
    module = stencils.poisson5(32)
    gm = GridMesh((1,), ("x",), device="cpu")
    monkeypatch.delenv("NEPTUNE_ALLOW_MONOMIAL_SMALL_S", raising=False)
    with pytest.warns(UserWarning, match="not measured on this port"):
        gmres_sharded(CompiledModule(module), "poisson", gm, s=4)
    monkeypatch.setenv("NEPTUNE_ALLOW_MONOMIAL_SMALL_S", "1")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        gmres_sharded(CompiledModule(module), "poisson", gm, s=4)


def test_bicgstab_repins_the_shadow_on_a_fresh_block(monkeypatch):
    """After a breakdown the next block is fresh: its Gram takes the shadow
    r~0 as that block's own seed residual; other blocks carry the shadow
    over. f32 32^2 at s=3 breaks down several times before it stalls."""
    from neptune_tpu_torch.parallel import ca_bicgstab, ca_common

    s = 3
    seed_at = 2 * s + 2  # the R-chain's seed, the block's true residual
    shadows, breakdowns = [], []
    real_gram, real_block = ca_common.MatrixPowers.gram, ca_bicgstab._bicgstab_block

    def gram(self, vectors):
        shadows.append((vectors[-1], vectors[seed_at]))
        return real_gram(self, vectors)

    def block(*args):
        out = real_block(*args)
        breakdowns.append(out[5])
        return out

    monkeypatch.setattr(ca_common.MatrixPowers, "gram", gram)
    monkeypatch.setattr(ca_bicgstab, "_bicgstab_block", block)
    module = stencils.poisson5(32)
    b = cases.rhs(module, "poisson", 1).astype(np.float32)
    solve = bicgstab_sharded(CompiledModule(module), "poisson", GridMesh((1,), ("x",), device="cpu"),
                             s=s, maxiter=2000, tol=1e-6)
    solve(b)
    assert sum(breakdowns[:-1]) >= 2
    fresh, carried = True, None
    for (shadow, seed), broke in zip(shadows, breakdowns):
        assert torch.equal(shadow, seed if fresh else carried)
        carried, fresh = shadow, broke
