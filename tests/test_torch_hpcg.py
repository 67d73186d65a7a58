"""HPCG's problem on the port, on the CPU: the 27-point float64 operator
solved by 50 iterations of CG preconditioned with HPCG's V-cycle (four
levels of vertex coarsening, injection, unscaled coarse operators, one
symmetric multicolour Gauss-Seidel sweep before and after and one on the
coarsest level), through the port's normal path (`portbench/programs/
hpcg27.py`: a `jit_class` calling `solve_linear`), held against the plain
reference `portbench/reference/hpcg27.py`; the cycle's symmetry, the
transfers, the hierarchy's bounds, and today's `precond="mg"` defaults."""

import re

import numpy as np
import pytest
import torch

import neptune_tpu as ntp
import neptune_tpu_torch as ntt
from neptune_tpu_torch import config, stencils
from neptune_tpu_torch.lowering.executor import CompiledModule, auto_mg_preconditioner
from neptune_tpu_torch.passes.coarsen import coarsen_opdef
from neptune_tpu_torch.passes.smoother import SUFFIX, colour_pass
from neptune_tpu_torch.solvers import multigrid
from neptune_tpu_torch.utils import profiling
from neptune_tpu_torch.utils.options import split_precond_options
from portbench.programs import hpcg27 as program
from portbench.reference import hpcg27 as reference

HPCG = {"mg_levels": 4, "mg_smoother": "symgs", "mg_coarsen": "vertex", "mg_coarse_sweeps": 1}


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def _cfg(n, iters, rank=3):
    return {"bounds": [[0] * rank, [n + 2] * rank], "interior": [[1] * rank, [n + 1] * rank],
            "dtype": "float64", "solver": "cg", "tol": 0.0, "max_iters": iters}


def _interior(n, rank=3):
    return ((1,) * rank, (n + 1,) * rank)


def _rhs(n, seed, rank=3):
    gen = torch.Generator().manual_seed(seed)
    return reference.random_rhs((n + 2,) * rank, _interior(n, rank), gen)


# (unknowns a side, iterations, right-hand side): the first iterates and
# the whole solve of HPCG's own b at 16^3, the first iterates at 32^3
@pytest.mark.parametrize("n, iters, rhs", [(16, 1, "random"), (16, 2, "random"),
                                           (16, 50, "hpcg"), (32, 1, "random"),
                                           (32, 3, "random")])
def test_iterates_match_the_reference(n, iters, rhs):
    """The port's k-th CG iterate (a solve of max_iters=k) equals the
    reference's, in float64, to 1e-12 relative; HPCG's own b (x* = 1) is
    solved in 50 iterations."""
    if rhs == "hpcg":
        b = reference.hpcg_rhs((n + 2,) * 3, _interior(n))
    else:
        b = _rhs(n, 1000 + n + iters)
    history = []
    reference.pcg(b, _interior(n), iters, history=history)
    x = program.solver(_cfg(n, iters), HPCG)(b)
    assert x.dtype == torch.float64
    assert reference.rel_diffs(x[None], history[-1][None]).item() <= 1e-12
    if rhs == "hpcg":
        ones = reference.unknowns(b.shape, _interior(n), torch.float64, "cpu")
        assert reference.rel_residuals(x[None], b[None], _interior(n)).item() <= 1e-12
        assert reference.rel_diffs(x[None], ones[None]).item() <= 1e-12


def _hpcg_M(n, rank=3):
    cm = CompiledModule(stencils.hpcg27((n + 2,) * rank), "auto", "cpu")
    return auto_mg_preconditioner(cm.module, cm._handle_for("hpcg27"), "auto", device="cpu",
                                  **HPCG)


@pytest.mark.parametrize("rank, n", [(3, 16), (2, 40)])
def test_v_cycle_is_symmetric(rank, n):
    """<M u, v> = <u, M v> to 1e-12, and <M u, u> > 0: the symgs cycle is a
    fixed symmetric positive preconditioner, as CG needs."""
    M = _hpcg_M(n, rank)
    ring = reference.unknowns((n + 2,) * rank, _interior(n, rank), torch.float64, "cpu")
    gen = torch.Generator().manual_seed(7)
    u, v = (torch.randn((n + 2,) * rank, generator=gen, dtype=torch.float64) * ring
            for _ in range(2))
    muv, umv = torch.sum(M(u) * v).item(), torch.sum(u * M(v)).item()
    assert abs(muv - umv) <= 1e-12 * abs(muv)
    assert torch.sum(M(u) * u).item() > 0


def test_v_cycle_equals_the_reference_cycle():
    n = 16
    r = _rhs(n, 5)
    got = _hpcg_M(n)(r)
    want = reference.v_cycle(r, _interior(n), 4)
    assert reference.rel_diffs(got[None], want[None]).item() <= 1e-13


def _levels(fine, coarse):
    """Two MGLevels with just what the transfers read: boxes and grids."""
    def level(n):
        return multigrid.MGLevel(None, torch.zeros((n + 2,) * 3, dtype=torch.float64), None,
                                 box=((1, n + 1),) * 3)
    return level(fine), level(coarse)


def test_injection_restriction_is_prolongation_transposed():
    L, Lc = _levels(10, 5)
    gen = torch.Generator().manual_seed(3)
    u = torch.randn((12,) * 3, generator=gen, dtype=torch.float64)
    w = torch.zeros((7,) * 3, dtype=torch.float64)
    w[1:6, 1:6, 1:6] = torch.randn((5,) * 3, generator=gen, dtype=torch.float64)
    ru = multigrid._down(u, L, Lc, "injection")
    pw = multigrid._add_injected(torch.zeros_like(u), w, L, Lc)
    assert torch.sum(ru * w).item() == pytest.approx(torch.sum(u * pw).item(), rel=1e-14)
    # coarse unknown (i, j, k) is fine unknown (2i, 2j, 2k); both rings stay 0
    assert ru[1, 2, 3] == u[1, 3, 5] and ru[0].abs().sum() == 0
    assert pw[1, 3, 5] == w[1, 2, 3] and pw[2].abs().sum() == 0


@pytest.mark.parametrize("n, want", [(322, [162, 82, 42]), (34, [18, 10, 6])])
def test_vertex_hierarchy_keeps_the_ring(n, want):
    """Vertex coarsening halves the unknowns and keeps the one-cell ring:
    322 -> 162 -> 82 -> 42 for HPCG's 320 -> 160 -> 80 -> 40."""
    mod = stencils.hpcg27((n, n, n))
    for m in want:
        mod = coarsen_opdef(mod, "hpcg27", mode="vertex")
        fn = mod.lookup("hpcg27")
        assert fn.ftype.inputs[0].bounds.shape == (m, m, m)
        (ap,) = [op for op in fn.walk() if op.name == "neptune.apply"]
        assert ap.attrs["bounds"].lb == (1, 1, 1) and ap.attrs["bounds"].ub == (m - 1,) * 3
    # cell-centred coarsening, the default, halves the whole grid
    cell = coarsen_opdef(stencils.hpcg27((n, n, n)), "hpcg27")
    assert cell.lookup("hpcg27").ftype.inputs[0].bounds.shape == (n // 2,) * 3
    with pytest.raises(ValueError, match="not 2:1-coarsenable"):
        coarsen_opdef(stencils.hpcg27((9, 9, 9)), "hpcg27", mode="vertex")


@pytest.mark.parametrize("rank", [2, 3])
def test_colour_pass_relaxes_one_colour(rank):
    """@hpcg27__colour(x, b, d, c) updates exactly the unknowns of colour c
    (parity of the unknown's index, dim 0 highest) by x + d (b - A x)."""
    n = 6
    mod = stencils.hpcg27((n + 2,) * rank)
    cm = CompiledModule(colour_pass(mod, "hpcg27"), "auto", "cpu")
    gen = torch.Generator().manual_seed(rank)
    x, b = (torch.randn((n + 2,) * rank, generator=gen, dtype=torch.float64) for _ in range(2))
    d = torch.full_like(x, 1 / (3**rank - 1))
    ax = CompiledModule(mod, "auto", "cpu").opdef("hpcg27")(x)
    for c in range(2**rank):
        y = cm.opdef("hpcg27" + SUFFIX)(x, b, d, float(c))
        want = x.clone()
        for idx in np.ndindex(*(n,) * rank):
            if sum((i % 2) << (rank - 1 - k) for k, i in enumerate(idx)) == c:
                cell = tuple(i + 1 for i in idx)
                want[cell] = x[cell] + d[cell] * (b[cell] - ax[cell])
        assert torch.allclose(y, want, rtol=0, atol=1e-13)
        assert torch.equal(y[0], x[0])  # the ring copies through


def test_cycle_spans():
    """While a profiler runs, each V-cycle is one `nt.mg.cycle` span and
    each smoother call one `nt.mg.smooth` span with its level, smoother,
    colours and sweeps."""
    n = 8
    solve = program.solver(_cfg(n, 2), HPCG)
    b = _rhs(n, 9)
    solve(b)
    profiling.clear()
    with torch.profiler.profile():
        solve(b)
    spans = profiling.spans()
    cycles = [s for s in spans if s["name"] == "nt.mg.cycle"]
    smooths = [s["attrs"] for s in spans if s["name"] == "nt.mg.smooth"]
    (solve_span,) = [s["attrs"] for s in spans if s["name"] == "nt.solve"]
    assert solve_span["route"] == "generic" and solve_span["iters"] == 2
    assert len(cycles) == 3 and all(s["attrs"] == {"levels": 4} for s in cycles)
    assert len(smooths) == 3 * 7
    assert smooths[:4] == [{"level": lvl, "smoother": "symgs", "colours": 8, "sweeps": 1}
                           for lvl in range(4)]


def test_hpcg_options_are_checked():
    n = 8
    b = _rhs(n, 1)
    with pytest.raises(ValueError, match="mg_coarsen must be 'cell' or 'vertex'"):
        program.solver(_cfg(n, 1), dict(HPCG, mg_coarsen="nodal"))(b)
    with pytest.raises(ValueError, match="needs mg_coarsen='vertex'"):
        program.solver(_cfg(n, 1), dict(HPCG, mg_coarsen="cell"))(b)
    with pytest.raises(ValueError, match="only applies to precond='mg'"):
        split_precond_options({"mg_coarsen": "vertex"}, "jacobi")


def _ksp_iters(text):
    return [int(m) for m in re.findall(r"KSP\([^)]*\) \S+: iters=(\d+)", text)]


def test_default_mg_options_are_unchanged(capsys):
    """precond="mg" with no options, with today's defaults spelled out, and
    the JAX package's: the same hierarchy and cycle (bitwise the same
    answer in the port) and the same iterations (the pin of
    tests/test_torch_multigrid.py's DSL case)."""
    n = 64
    bb = np.random.default_rng(0).standard_normal((n, n))
    defaults = {"mg_coarsen": "cell", "mg_coarse_sweeps": 32, "mg_smoother": "jacobi"}
    xs, its = [], []
    for nt, name, opts in ((ntt, "p_none", None), (ntt, "p_spelled", defaults),
                           (ntp, "p_jax", None)):
        H = nt.assemble_matrix(nt.linear_op_def(
            bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]), dtype="float64",
            name=name)(lambda u: 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]))
        capsys.readouterr()
        xs.append(nt.solve_linear(H, bb, solver="cg", tol=1e-10, max_iters=60, precond="mg",
                                  verbose=True, options=opts))
        its += _ksp_iters(capsys.readouterr().out)
    assert torch.equal(xs[0], xs[1])
    assert its[0] == its[1] and abs(its[0] - its[2]) <= 1 and its[0] < 40, its
