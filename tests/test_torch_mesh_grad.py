"""Reverse-mode derivatives over a process mesh, against the JAX package's
`jax.grad` of the same program on the whole grid.

One spawn for the file (`ranks` fixture): four CPU processes join a gloo
group on localhost (`torch_ca_worker.py grad`) and, on each mesh of
`torch_ca_cases.GRAD_MESHES` ((2,2) and (4,1)), take the gradient of a loss
through a sharded opdef call (`shardmap_opdef`: its reverse rule sends each
ghost zone's cotangent back to its owner), through `differentiable_solve`
(the transposed GMRES solve over the mesh's group, through the same rule)
and through `differentiable_root`, for a bounded and a periodic operator
each, and through sharded opdefs that reach 9 rows, deeper than a block
of (4,1) (their cotangents go back over two hops). Every process
backpropagates its own part of the loss; the gathered
gradient blocks, and the sum of every process's part of a scalar's
gradient, must equal `jax.grad` of the whole-grid loss, which the parent
computes meanwhile from the same printed IR, f64 within 1e-10 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_ca_cases as cases  # noqa: E402
from neptune_tpu.ir import verify_and_annotate as jax_verify  # noqa: E402
from neptune_tpu.ir.parser import parse_module as jax_parse  # noqa: E402
from neptune_tpu.lowering.executor import CompiledModule as JaxCompiledModule  # noqa: E402
from neptune_tpu.solvers.diff import differentiable_root as jax_root  # noqa: E402
from neptune_tpu.solvers.diff import differentiable_solve as jax_solve  # noqa: E402
from neptune_tpu_torch.ir import print_module  # noqa: E402

GRAD_TOL = 1e-10


def _jax_grads(cm, name):
    """{leaf: jax.grad of the whole-grid loss} for one case of GRADS."""
    kind, opdef = cases.GRADS[name]
    data = {k: jnp.asarray(v) for k, v in cases.grad_data().items()}
    op, w = cm.opdef(opdef), data["w"]
    if kind == "opdef":
        leaves = ("x", "up") if opdef == "cubic" else ("x",)

        def loss(*xs):
            return jnp.sum(w * op(*xs))

    else:
        leaves = ("b", "theta")

        def loss(b, theta):
            if kind == "solve":
                y = jax_solve(lambda v: op(v) + theta * v, b, solver="gmres", **cases.GRAD_SOLVE)
            else:
                y = jax_root(lambda u: op(u) + 0.1 * u * u * u - theta * b, jnp.zeros_like(b),
                             **cases.GRAD_ROOT)
            return jnp.sum(w * y)

    grads = jax.grad(loss, argnums=tuple(range(len(leaves))))(*(data[k] for k in leaves))
    return {k: np.asarray(g) for k, g in zip(leaves, grads)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the four ranks once, and meanwhile every JAX reference."""
    spawn = cases.Spawn("grad", tmp_path_factory.mktemp("grad"))
    try:
        cm = JaxCompiledModule(jax_verify(jax_parse(print_module(cases.grad_module()))))
        refs = {name: _jax_grads(cm, name) for name in cases.GRADS}
    finally:
        results, infos = spawn.results()
    return results, infos, refs


@pytest.mark.parametrize("mesh", cases.GRAD_MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("name", cases.GRADS)
def test_mesh_gradient_matches_jax_grad(ranks, name, mesh):
    results, infos, refs = ranks
    tag = "x".join(map(str, mesh))
    for leaf, ref in refs[name].items():
        got = results[f"{name}/{tag}/{leaf}"]
        assert got.shape == ref.shape
        err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0)
        assert err <= GRAD_TOL, (leaf, err)
    # the cotangent went through the sharded opdef's rule
    assert infos[f"{name}/{tag}"]["rule"] > 0
