"""The flagship programs, built with the port's `NeptuneBuilder`.

The port of `__graft_entry__.py`'s single-device entry: one implicit heat
time step, entirely in IR (`build_step`), and its 3-D twin with a GMRES solve
(`build_step_3d`). `entry(device)` returns the compiled step and an example
state on `device`, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import default_device
from .ir import F32, F64, Bounds, NeptuneBuilder, TempType
from .lowering.executor import CompiledModule
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
