"""The port's sharded routes on four processes against the JAX package.

One spawn for the whole file (`ranks` fixture): four CPU processes join a
gloo group on localhost (`torch_sharded_worker.py`) and run every case of
`torch_sharded_cases` on the meshes (4,1), (2,2) and (1,4), each on its own
blocks, and gather the results. Here, in the parent, the JAX package runs
the same printed IR through its own `shardmap_opdef` / `shardmap_sweeps`
on four of the eight virtual CPU devices, and the tests compare: f64
within 1e-12 relative, f32 within a few ulps, copy-through cells bit-equal,
solvers within one iteration of JAX with the true residual under tol.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_sharded_cases as cases  # noqa: E402
from neptune_tpu.ir import verify_and_annotate as jax_verify  # noqa: E402
from neptune_tpu.ir.parser import parse_module as jax_parse  # noqa: E402
from neptune_tpu.lowering.executor import CompiledModule as JaxCompiledModule  # noqa: E402
from neptune_tpu.parallel import GridMesh as JaxGridMesh  # noqa: E402
from neptune_tpu.parallel import shardmap_opdef as jax_shardmap_opdef  # noqa: E402
from neptune_tpu.parallel import shardmap_sweeps as jax_shardmap_sweeps  # noqa: E402
from neptune_tpu.solvers import krylov as jax_krylov  # noqa: E402
from neptune_tpu_torch.config import config as torch_config  # noqa: E402
from neptune_tpu_torch.ir import print_module  # noqa: E402
from neptune_tpu_torch.lowering.executor import CompiledModule  # noqa: E402
from test_torch_apply import TOL  # noqa: E402


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The port puts NumPy inputs on `config.device`, the card by default:
    these CPU tests ask for the CPU."""
    monkeypatch.setattr(torch_config, "device", "cpu")


HERE = Path(__file__).resolve().parent
WORLD = 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the four ranks once; their gathered results and iterations."""
    out = tmp_path_factory.mktemp("sharded")
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    env["PYTHONPATH"] = os.pathsep.join([str(HERE.parent), env.get("PYTHONPATH", "")])
    procs = [
        subprocess.Popen(
            [sys.executable, str(HERE / "torch_sharded_worker.py"), str(r), str(WORLD), port, str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(WORLD)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    with np.load(out / "results.npz") as z:
        results = {k: z[k] for k in z.files}
    return results, json.loads((out / "solvers.json").read_text())


def _tag(mesh):
    return "x".join(map(str, mesh))


def _jax_mesh(mesh):
    return JaxGridMesh(mesh, cases.AXES, devices=jax.devices()[:WORLD])


def _jax_module(module):
    return jax_verify(jax_parse(print_module(module)))


def _copy_through(module, opdef):
    """Cells outside a single-apply opdef's bounds (None for composites)."""
    applies = [op for op in module.lookup(opdef).body.ops if op.name == "neptune.apply"]
    if len(applies) != 1:
        return None
    op = applies[0]
    outer = op.results[0].type.bounds
    inside = np.zeros(outer.shape, bool)
    inside[op.attrs["bounds"].rel_slices(outer)] = True
    return ~inside


def _close(got, ref, dtype, scale=1):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max()
    assert err <= scale * TOL[dtype] * max(np.abs(ref).max(), 1.0), err


@pytest.mark.parametrize("mesh", cases.MESHES, ids=_tag)
@pytest.mark.parametrize("name", cases.OPDEFS)
def test_shardmap_opdef_matches_jax(ranks, name, mesh):
    build, opdef, _, scalars, backend = cases.OPDEFS[name]
    module = build()
    xs = cases.inputs(module, opdef)
    gm = _jax_mesh(mesh)
    jcm = JaxCompiledModule(_jax_module(module), "jnp")
    f = jax.jit(jax_shardmap_opdef(jcm, opdef, gm, backend={"cuda": "pallas"}.get(backend, "jnp")))
    ref = np.asarray(f(*[gm.shard(jnp.asarray(x)) for x in xs], *map(jnp.asarray, scalars)))
    got = ranks[0][f"opdef/{name}/{_tag(mesh)}"]
    dtype = module.lookup(opdef).ftype.results[0].element
    _close(got, ref, dtype)
    ring = _copy_through(module, opdef)
    if ring is not None:
        np.testing.assert_array_equal(got[ring], ref[ring])
    # and bitwise the port's own whole-grid route
    whole = CompiledModule(module, backend="torch").opdef(opdef)(*xs, *scalars)
    np.testing.assert_array_equal(got, whole.numpy())


@pytest.mark.parametrize("mesh", cases.MESHES, ids=_tag)
@pytest.mark.parametrize("name", cases.SWEEPS)
def test_shardmap_sweeps_matches_jax(ranks, name, mesh):
    build, opdef, k = cases.SWEEPS[name]
    module = build()
    (x,) = cases.inputs(module, opdef)
    gm = _jax_mesh(mesh)
    jcm = JaxCompiledModule(_jax_module(module), "jnp")
    ref = np.asarray(jax.jit(jax_shardmap_sweeps(jcm, opdef, gm, k))(gm.shard(jnp.asarray(x))))
    got = ranks[0][f"sweeps/{name}/{_tag(mesh)}"]
    _close(got, ref, module.lookup(opdef).ftype.results[0].element, scale=k)
    ring = _copy_through(module, opdef)
    np.testing.assert_array_equal(got[ring], ref[ring])


@pytest.mark.parametrize("mesh", cases.MESHES, ids=_tag)
def test_halo_pad_local(ranks, mesh):
    results = ranks[0]
    g = np.arange(32 * 32, dtype=np.float64).reshape(32, 32)
    np.testing.assert_array_equal(results[f"halo_pad/{_tag(mesh)}"], g)
    assert np.all(results[f"halo_ghosts_ok/{_tag(mesh)}"] == 1.0)


@pytest.mark.parametrize("mesh", cases.MESHES, ids=_tag)
def test_sharded_stencil_torus(ranks, mesh):
    x = np.random.default_rng(3).standard_normal((32, 32))
    want = (
        4 * x - np.roll(x, 1, 0) - np.roll(x, -1, 0) - np.roll(x, 1, 1) - np.roll(x, -1, 1)
    )
    _close(ranks[0][f"stencil_torus/{_tag(mesh)}"], want, "float64")


@pytest.mark.parametrize("mesh", cases.MESHES, ids=_tag)
@pytest.mark.parametrize("solver", cases.SOLVERS)
def test_sharded_solver_matches_jax(ranks, solver, mesh):
    results, iters = ranks
    module, opdef, b = cases.solver_system()
    tol = cases.SOLVERS[solver]
    gm = _jax_mesh(mesh)
    mv = jax_shardmap_opdef(JaxCompiledModule(_jax_module(module), "jnp"), opdef, gm)
    solve = getattr(jax_krylov, solver)
    _, info = jax.jit(lambda bb: solve(mv, bb, tol=tol, maxiter=500))(gm.shard(jnp.asarray(b)))
    assert abs(iters[f"{solver}/{_tag(mesh)}"] - int(info.iters)) <= 1
    x = torch.from_numpy(results[f"solve/{solver}/{_tag(mesh)}"])
    r = torch.from_numpy(b) - CompiledModule(module, backend="torch").opdef(opdef)(x)
    assert float(torch.linalg.norm(r)) <= tol * float(np.linalg.norm(b))
