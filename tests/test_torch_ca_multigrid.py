"""The port's multigrid over a process mesh (`solvers/multigrid.py` on
blocks, `parallel/ca_multigrid.py`) and Newton over a sharded residual,
on four processes against the JAX package.

One spawn for the whole file (`ranks` fixture): four CPU processes join a
gloo group on localhost (`torch_ca_worker.py mg`) and run on their own
blocks, f64, on the (2,2) and (4,1) meshes (`torch_ca_cases.MG_SOLVES`
says which solve runs where). Here, in the parent, the JAX package runs
the same hierarchy (`torch_ca_cases.poisson_hierarchy`, built by either
package's DSL) on four of its eight virtual devices with the same mesh
shapes: its V-cycle under GSPMD (its `TestShardedMultigrid` form),
`build_ca_levels` and its CA cycle over `shard_map`, and its Newton over
its `sharded_opdef`. Compared:

  * the levels: inverse diagonal, lam_max, CA eligibility per level;
  * `multigrid_solve` (red-black) and MG-PCG (Chebyshev-smoothed) over
    `shardmap_opdef` on 128..16: iterations within 1, x within 1e-10
    relative;
  * the CA cycle: the port's CA-smoothed `multigrid_solve` takes its
    per-matvec route's iterations, and the JAX package's;
  * the CA smoother against `chebyshev(maxiter=k)` from zero and from a
    live guess; its ring shifts per pass, constant in k; CA-MG
    preconditioning CG;
  * the wide stencil's probed diagonal;
  * `prolong` on blocks, at block corners and the domain edge, against the
    whole-grid `prolong`, bitwise;
  * Newton-Krylov on F = A u + 0.1 u^3 - b: Newton iterations equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import neptune_tpu as ntp  # noqa: E402
import torch_ca_cases as cases  # noqa: E402
from neptune_tpu.ir import verify_and_annotate as jax_verify  # noqa: E402
from neptune_tpu.ir.parser import parse_module as jax_parse  # noqa: E402
from neptune_tpu.lowering.executor import CompiledModule as JaxCompiledModule  # noqa: E402
from neptune_tpu.parallel import GridMesh as JaxGridMesh  # noqa: E402
from neptune_tpu.parallel import build_ca_levels as jax_build_ca_levels  # noqa: E402
from neptune_tpu.parallel import sharded_opdef as jax_sharded_opdef  # noqa: E402
from neptune_tpu.solvers import cg as jax_cg  # noqa: E402
from neptune_tpu.solvers import multigrid as jmg  # noqa: E402
from neptune_tpu.solvers import newton_krylov as jax_newton_krylov  # noqa: E402
from neptune_tpu_torch import stencils  # noqa: E402
from neptune_tpu_torch.config import config as torch_config  # noqa: E402
from neptune_tpu_torch.ir import print_module  # noqa: E402
from neptune_tpu_torch.solvers import multigrid as tmg  # noqa: E402

WORLD = 4
TOL = 1e-10  # x, relative to its largest |value|


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The port puts NumPy inputs on `config.device`, the card by default:
    these CPU tests ask for the CPU."""
    monkeypatch.setattr(torch_config, "device", "cpu")


def _tag(mesh) -> str:
    return "x".join(map(str, mesh))


def _info(info) -> dict:
    return {"iters": int(info.iters), "converged": bool(info.converged)}


def _jax_references() -> dict:
    """Every JAX reference, on the meshes the port's runs use."""
    refs = {}
    handles = cases.poisson_hierarchy(ntp)
    jcm = ntp.get_context().compiled()
    b = cases.rhs(jcm.module, cases.MG_NAMES[0], 0)
    mvs = [h.matvec for h in handles]
    for mesh in cases.MG_MESHES:
        tag = _tag(mesh)
        gm = JaxGridMesh(mesh, cases.AXES[:2], devices=jax.devices()[:WORLD])
        bs = gm.shard(jnp.asarray(b))
        lv = jmg.build_levels(handles, bs)
        refs[f"levels/{tag}"] = (np.asarray(lv[0].inv_diag), [float(lvl.cheb_lmax) for lvl in lv])
        ca = jax_build_ca_levels(jcm, cases.MG_NAMES, gm, jnp.zeros(b.shape), k=3, matvecs=mvs)
        refs[f"eligible/{tag}"] = [lvl.ca_smooth is not None for lvl in ca]
        runs = {name for name, on in cases.MG_SOLVES.items() if mesh in on}
        if "rb" in runs:
            x, info = jmg.multigrid_solve(handles, bs, tol=1e-9, maxiter=60, levels=lv)
            refs[f"rb/{tag}"] = (np.asarray(x), _info(info))
        if "pcg" in runs:
            M = jmg.mg_preconditioner(handles, bs, smoother="cheb", levels=lv)
            x, info = jax.jit(lambda bb: jax_cg(mvs[0], bb, M=M, tol=1e-8, maxiter=200))(bs)
            refs[f"pcg/{tag}"] = (np.asarray(x), _info(info))
        if "ca" in runs:
            x, info = jmg.multigrid_solve(
                [None] * 4, bs, tol=1e-9, maxiter=60, levels=ca, smoother="cheb", pre=3, post=3
            )
            refs[f"ca/{tag}"] = (np.asarray(x), _info(info))
        if "newton" in runs:
            module = stencils.poisson5(64, "float64")
            jcm64 = JaxCompiledModule(jax_verify(jax_parse(print_module(module))))
            mv = jax_sharded_opdef(jcm64, "poisson", gm)
            b64 = gm.shard(jnp.asarray(cases.rhs(module, "poisson", 2)))
            x, info = jax.jit(lambda: jax_newton_krylov(
                lambda u: mv(u) + 0.1 * u * u * u - b64, jnp.zeros((64, 64))))()
            refs[f"newton/{tag}"] = (np.asarray(x), {
                "iters": int(info.iters), "krylov_iters": int(info.krylov_iters)})
        if mesh == (2, 2):
            ca2 = jax_build_ca_levels(jcm, cases.MG_NAMES, gm, jnp.zeros(b.shape), k=2,
                                      matvecs=mvs)
            M = jmg.mg_preconditioner([None], bs, smoother="cheb", levels=ca2)
            x, info = jax.jit(lambda bb: jax_cg(mvs[0], bb, M=M, tol=1e-8, maxiter=200))(bs)
            refs["ca_pcg"] = (np.asarray(x), _info(info))
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the four ranks once, and meanwhile every JAX reference."""
    spawn = cases.Spawn("mg", tmp_path_factory.mktemp("mg"))
    try:
        refs = _jax_references()
    finally:
        results, infos = spawn.results(timeout=600)
    return results, infos, refs


def _rel(got, ref) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _solve_cases(kind):
    return [pytest.param(m, id=_tag(m)) for m in cases.MG_SOLVES[kind]]


@pytest.mark.parametrize("mesh", [pytest.param(m, id=_tag(m)) for m in cases.MG_MESHES])
def test_levels_match_jax(ranks, mesh):
    """Diagonal probes and power iterations in global coordinates give the
    whole grid's levels: the JAX package's inverse diagonal, lam_max per
    level to roundoff."""
    results, infos, refs = ranks
    inv, lmax = refs[f"levels/{_tag(mesh)}"]
    np.testing.assert_array_equal(results[f"inv_diag/{_tag(mesh)}"], inv)
    got = infos[f"levels/{_tag(mesh)}"]["lmax"]
    np.testing.assert_allclose(got, lmax, rtol=1e-12)


@pytest.mark.parametrize(
    "mesh, want",
    [pytest.param((2, 2), [True] * 4, id="2x2"),
     # 16^2 over (4,1): a 4-row block, and k·reach = 6 rows exceed it
     pytest.param((4, 1), [True, True, True, False], id="4x1")],
)
def test_ca_eligibility_matches_jax(ranks, mesh, want):
    results, infos, refs = ranks
    assert infos[f"levels/{_tag(mesh)}"]["eligible"] == refs[f"eligible/{_tag(mesh)}"] == want


@pytest.mark.parametrize("kind, mesh", [
    *[pytest.param("rb", m, id=f"rb-{_tag(m)}") for m in cases.MG_SOLVES["rb"]],
    *[pytest.param("pcg", m, id=f"pcg-{_tag(m)}") for m in cases.MG_SOLVES["pcg"]],
])
def test_vcycle_over_shardmap_matches_jax(ranks, kind, mesh):
    """multigrid_solve (red-black) and MG-PCG (Chebyshev cycle) over
    shardmap_opdef converge at multigrid rate to the JAX package's x."""
    results, infos, refs = ranks
    ref, rinfo = refs[f"{kind}/{_tag(mesh)}"]
    info = infos[f"{kind}/{_tag(mesh)}"]
    assert info["converged"] and rinfo["converged"]
    assert abs(info["iters"] - rinfo["iters"]) <= 1, (info, rinfo)
    assert info["iters"] < (30 if kind == "rb" else 40)
    assert _rel(results[f"{kind}/{_tag(mesh)}"], ref) <= TOL


@pytest.mark.parametrize("mesh", _solve_cases("ca"))
def test_ca_convergence_unchanged(ranks, mesh):
    """The CA cycle is the per-matvec "cheb" cycle's math: the same
    iterations to the same x, and the JAX package's CA iterations; its
    smoothing takes fewer ring shifts."""
    results, infos, refs = ranks
    tag = _tag(mesh)
    ca, pm = infos[f"ca/{tag}"], infos[f"per_matvec/{tag}"]
    ref, rinfo = refs[f"ca/{tag}"]
    assert ca["converged"] and pm["converged"] and rinfo["converged"]
    assert ca["iters"] == pm["iters"]
    assert abs(ca["iters"] - rinfo["iters"]) <= 1, (ca, rinfo)
    assert _rel(results[f"ca/{tag}"], results[f"per_matvec/{tag}"]) <= TOL
    assert _rel(results[f"ca/{tag}"], ref) <= TOL
    assert ca["shifts"] < pm["shifts"]


@pytest.mark.parametrize("start", ["zero", "live"])
def test_ca_smoother_matches_chebyshev(ranks, start):
    """k fused CA iterations are chebyshev(maxiter=k) over the shardmap
    matvec, and the returned residual is the true b - A x'."""
    results, _, _ = ranks
    x = results[f"smoother/{start}"]
    np.testing.assert_allclose(x, results[f"smoother_oracle/{start}"], atol=1e-12 * np.abs(x).max())
    r = results[f"smoother_r/{start}"]
    np.testing.assert_allclose(r, results[f"smoother_true_r/{start}"], atol=1e-9 * np.abs(r).max())


def test_ca_exchange_rounds_constant_in_k(ranks):
    """One smoothing pass exchanges once (smooth_zero: (x, r) strips, 2
    fields x 2 sharded dims x 2 sides = 8 ring shifts on (2,2); smooth: 4
    more for its residual matvec), whatever k; k per-matvec applications
    take 4 each."""
    rounds = ranks[1]["rounds"]
    assert rounds["zero_2"] == rounds["zero_6"] == 8, rounds
    assert rounds["live_2"] == rounds["live_6"] == 12, rounds
    assert rounds["naive_2"] == 8 and rounds["naive_6"] == 24, rounds


def test_ca_mg_preconditions_cg(ranks):
    """The CA cycle stays a fixed linear, D-self-adjoint operator: CG with
    it converges at multigrid rate, in the JAX package's iterations."""
    results, infos, refs = ranks
    ref, rinfo = refs["ca_pcg"]
    info = infos["ca_pcg"]
    assert info["converged"] and info["iters"] < 40
    assert abs(info["iters"] - rinfo["iters"]) <= 1, (info, rinfo)
    assert _rel(results["ca_pcg"], ref) <= TOL


def test_wide_stencil_diagonal_probe(ranks):
    """build_ca_levels probes with the verifier's halo (period 3 for reach
    2), on the global lattice: 1/6 inside, identity rows on the ring."""
    d = ranks[0]["wide5_inv_diag"]
    np.testing.assert_allclose(d[2:-2, 2:-2], 1.0 / 6.0, atol=1e-12)
    np.testing.assert_allclose(d[:2, :], 1.0, atol=1e-12)
    np.testing.assert_allclose(d[:, -2:], 1.0, atol=1e-12)


@pytest.mark.parametrize("mesh", [pytest.param(m, id=_tag(m)) for m in cases.MG_MESHES])
@pytest.mark.parametrize("case", list(cases.PROLONG))
def test_prolong_on_blocks_is_bitwise(ranks, mesh, case):
    rank, shape = cases.PROLONG[case]
    e = torch.from_numpy(np.random.default_rng(rank).standard_normal(shape))
    want = tmg.prolong(e, tuple(2 * n for n in shape)).numpy()
    np.testing.assert_array_equal(ranks[0][f"prolong/{case}/{_tag(mesh)}"], want)


@pytest.mark.parametrize("mesh", _solve_cases("newton"))
def test_sharded_newton_krylov(ranks, mesh):
    """JFNK on blocks: J·v through the sharded opdef's derivative rule,
    every norm over the mesh's group; the JAX package's Newton iterations."""
    results, infos, refs = ranks
    ref, rinfo = refs[f"newton/{_tag(mesh)}"]
    info = infos[f"newton/{_tag(mesh)}"]
    assert info["converged"] and info["fnorm"] < 1e-7
    assert info["iters"] == rinfo["iters"]
    assert _rel(results[f"newton/{_tag(mesh)}"], ref) <= TOL
