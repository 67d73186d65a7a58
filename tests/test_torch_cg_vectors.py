"""CG on one tensor (`krylov.cg`'s loop over `solvers/cg_vectors.py`'s
steps) on the CPU, where each step runs its plain version: bitwise the same
solve as the tuple loop's with b as a 1-tuple (x, iterations and residual
norm), in float32 and float64, with and without a preconditioner and a
start; b, x0 and the preconditioner's output are never written; and only
a single tensor outside a mesh group and pinned arithmetic takes the loop."""

import numpy as np
import pytest
import torch

from neptune_tpu_torch import stencils
from neptune_tpu_torch.config import config
from neptune_tpu_torch.lowering.executor import CompiledModule
from neptune_tpu_torch.solvers import cg_vectors, krylov

N = 48


def _system(dtype, seed=3):
    """A 5-pt Poisson matvec on N^2 (the port's CPU route), a Jacobi-like
    preconditioner that varies over the grid, and a right-hand side that is
    0 on the operator's copy-through ring (CG stays on the SPD interior)."""
    element = {torch.float32: "float32", torch.float64: "float64"}[dtype]
    matvec = CompiledModule(stencils.poisson5(N, element), device="cpu").opdef("poisson")
    scale = torch.linspace(0.15, 0.35, N * N, dtype=dtype).reshape(N, N)
    b = torch.zeros(N, N, dtype=dtype)
    b[1:-1, 1:-1] = torch.from_numpy(np.random.default_rng(seed).standard_normal((N - 2, N - 2)))
    return matvec, (lambda r: scale * r), b


def _tupled(f):
    return None if f is None else (lambda t: (f(t[0]),))


CASES = [(dtype, precond, start) for dtype in (torch.float32, torch.float64)
         for precond in (False, True) for start in (False, True)]


@pytest.mark.parametrize("dtype, precond, start", CASES,
                         ids=[f"{str(d)[6:]}-{'M' if m else 'noM'}-{'x0' if s else '0'}"
                              for d, m, s in CASES])
def test_one_tensor_is_bitwise_the_tuple_loop(dtype, precond, start):
    matvec, M, b = _system(dtype)
    M = M if precond else None
    x0 = 0.1 * b if start else None
    kw = dict(tol=1e-4 if dtype == torch.float32 else 1e-9, maxiter=300)
    b_copy, x0_copy = b.clone(), None if x0 is None else x0.clone()
    x, info = krylov.cg(matvec, b, x0, M=M, **kw)
    (xt,), tinfo = krylov.cg(_tupled(matvec), (b,), None if x0 is None else (x0,),
                             M=_tupled(M), **kw)
    assert info.converged and 10 < info.iters < 300
    assert (info.iters, info.resnorm, info.converged) == (tinfo.iters, tinfo.resnorm,
                                                           tinfo.converged)
    assert x.dtype == dtype and torch.equal(x, xt)
    assert torch.equal(b, b_copy)
    assert x0 is None or torch.equal(x0, x0_copy)


@pytest.mark.parametrize("precond", [False, True], ids=["noM", "M"])
def test_one_tensor_takes_a_permuted_right_hand_side(precond):
    """A dense but non-contiguous b and x0 (transposed grids): on the CPU
    the loop keeps their layout, as the tuple loop does, and is bitwise it."""
    matvec, M, b = _system(torch.float64, seed=7)
    M = M if precond else None
    b, x0 = b.t(), (0.1 * b).t()
    assert not b.is_contiguous()
    x, info = krylov.cg(matvec, b, x0, M=M, tol=1e-9, maxiter=300)
    (xt,), tinfo = krylov.cg(_tupled(matvec), (b,), (x0,), M=_tupled(M), tol=1e-9, maxiter=300)
    assert info.converged and info == tinfo and torch.equal(x, xt)


@pytest.mark.parametrize("maxiter", [0, 1, 7])
def test_one_tensor_capped_iterations(maxiter):
    """A capped solve stops where the tuple loop stops, with its x and norm."""
    matvec, M, b = _system(torch.float64, seed=5)
    x, info = krylov.cg(matvec, b, M=M, tol=0.0, maxiter=maxiter)
    (xt,), tinfo = krylov.cg(_tupled(matvec), (b,), M=_tupled(M), tol=0.0, maxiter=maxiter)
    assert info == tinfo and info.iters == maxiter and torch.equal(x, xt)


def test_the_preconditioners_output_is_not_written():
    """M's returned tensors keep their values: the loop copies z into p."""
    matvec, M, b = _system(torch.float64)
    given = []

    def keeping(r):
        z = M(r)
        given.append((z, z.clone()))
        return z

    krylov.cg(matvec, b, M=keeping, tol=1e-6, maxiter=40)
    assert len(given) > 5 and all(torch.equal(z, kept) for z, kept in given)


@pytest.fixture
def loops(monkeypatch):
    """The solves that reached the one-tensor loop."""
    seen = []
    real = krylov._cg_one_tensor

    def spy(*a, **k):
        seen.append(a[1])
        return real(*a, **k)

    monkeypatch.setattr(krylov, "_cg_one_tensor", spy)
    return seen


def test_only_one_tensor_reaches_the_loop(loops, monkeypatch):
    matvec, _, b = _system(torch.float64)
    krylov.cg(matvec, b, tol=1e-3, maxiter=20)
    assert len(loops) == 1
    krylov.cg(_tupled(matvec), (b,), tol=1e-3, maxiter=20)
    monkeypatch.setattr(config, "pinned_arithmetic", True)
    krylov.cg(matvec, b, tol=1e-3, maxiter=20)
    assert len(loops) == 1


@pytest.mark.parametrize("case", ["group", "pinned", "tuple", "bfloat16", "x0 dtype",
                                  "x0 shape", "requires grad"])
def test_the_gate_keeps_the_tuple_loop(case, monkeypatch):
    b = torch.ones(4, 4, dtype=torch.float64)
    args = {"b": b, "x0": None, "group": None}
    assert cg_vectors.engages(**args)
    change = {"group": {"group": object()}, "pinned": {}, "tuple": {"b": (b,)},
              "bfloat16": {"b": b.to(torch.bfloat16)}, "x0 dtype": {"x0": b.float()},
              "x0 shape": {"x0": b[:2]}, "requires grad": {"b": b.clone().requires_grad_()}}
    monkeypatch.setattr(config, "pinned_arithmetic", case == "pinned")
    assert not cg_vectors.engages(**{**args, **change[case]})


def test_the_plain_steps_keep_their_slots():
    """One iteration by hand: each step writes its slots as the loop reads
    them, and without M the update takes dot_beta's scalar steps."""
    gen = torch.Generator().manual_seed(0)
    p, Ap, r = (torch.randn(33 * 65, dtype=torch.float64, generator=gen) for _ in range(3))
    x = torch.zeros_like(p)
    rz = torch.dot(r, r)
    sc = cg_vectors.Scalars(p, rz, torch.sqrt(rz), torch.tensor(0.0, dtype=torch.float64),
                            torch.tensor(1e300, dtype=torch.float64))
    cg_vectors.dot_alpha(p, Ap, sc)
    alpha = rz / torch.sum(p * Ap)
    assert torch.allclose(sc.buf[cg_vectors.ALPHA], alpha, rtol=1e-14)
    r0 = r.clone()
    cg_vectors.update(x, p, r, Ap, sc, plain=True)
    assert torch.equal(x, sc.buf[cg_vectors.ALPHA] * p)
    assert torch.equal(r, r0 + (-sc.buf[cg_vectors.ALPHA]) * Ap)
    rr = torch.sum(r * r)
    assert torch.allclose(sc.buf[cg_vectors.RR], rr, rtol=1e-14)
    assert torch.equal(sc.buf[cg_vectors.RZ], sc.buf[cg_vectors.RR])
    assert torch.equal(sc.buf[cg_vectors.BETA], sc.buf[cg_vectors.RR] / rz)
    assert sc.running()
    p0 = p.clone()
    cg_vectors.direction(p, r, sc)
    assert torch.equal(p, r + sc.buf[cg_vectors.BETA] * p0)
