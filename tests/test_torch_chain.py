"""Kernel D's route and plain version against the JAX package's fused chain
TPU kernel (`pallas_chain.execute_chain`), run in interpret mode.

The composite operator is built once (`neptune_tpu_torch.stencils`),
printed, and parsed by the JAX package, whose `opdef` takes its chain kernel
wherever `pallas_chain.chain_plan` holds. The port's `opdef` takes kernel
D's route, which runs its plain version (the stages one eager apply at a
time) on the CPU. The port's flattened stages, peak live values and
composed reach are held against JAX's `_flatten` and dim-0 creep.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from neptune_tpu.config import config  # noqa: E402
from neptune_tpu.ir import verify_and_annotate as jax_verify  # noqa: E402
from neptune_tpu.ir.parser import parse_module as jax_parse  # noqa: E402
from neptune_tpu.lowering import pallas_chain  # noqa: E402
from neptune_tpu.lowering.executor import CompiledModule as JaxCompiledModule  # noqa: E402
from neptune_tpu_torch import stencils  # noqa: E402
from neptune_tpu_torch.config import config as torch_config  # noqa: E402
from neptune_tpu_torch.ir import print_module  # noqa: E402
from neptune_tpu_torch.kernels import codegen  # noqa: E402
from neptune_tpu_torch.lowering import chain  # noqa: E402
from neptune_tpu_torch.lowering.executor import CompiledModule  # noqa: E402
from test_torch_apply import TOL  # noqa: E402


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The port puts NumPy inputs on `config.device`, the card by default:
    these CPU tests ask for the CPU."""
    monkeypatch.setattr(torch_config, "device", "cpu")


# name -> (module, opdef, field count, scalars, composed reach per dim)
CASES = {
    "composite": (lambda: stencils.composite((64, 128)), "wrapped", 1, (), (2, 2)),
    "mixed_periodic_bounded": (
        lambda: stencils.composite((64, 128), mixed=True), "wrapped", 1, (), (2, 2)
    ),
    "two_fields_scalars": (lambda: stencils.coupled((64, 128)), "couple", 2, (0.7, -1.3), (2, 2)),
    "composite_3d": (lambda: stencils.composite((32, 8, 128)), "wrapped", 1, (), (2, 2, 2)),
    # an index() body in the periodic stage of a mixed chain, logical origin not 0
    "graded_mixed": (lambda: stencils.graded_chain((64, 128), lb=(3, -5)), "wrapped", 1, (), (2, 2)),
}


@pytest.fixture
def jax_interpret(monkeypatch):
    monkeypatch.setattr(config, "pallas_interpret", True)


def _both(case):
    build, name, *_ = CASES[case]
    module = build()
    jm = jax_verify(jax_parse(print_module(module)))
    return module, jm, name


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_chain(case, jax_interpret):
    module, jm, name = _both(case)
    _, _, n_fields, scalars, _ = CASES[case]
    assert pallas_chain.chain_plan(jm, name) is not None  # JAX takes its chain kernel
    plan = chain.chain_plan(module, name)
    rng = np.random.default_rng(0)
    fields = [rng.standard_normal(plan.outer.shape).astype(np.float32) for _ in range(n_fields)]
    ref = np.asarray(JaxCompiledModule(jm, "auto").opdef(name)(*fields, *map(np.float32, scalars)))
    run = CompiledModule(module).opdef(name)
    assert run.__name__ == f"neptune_chain_{name}"
    got = run(*fields, *scalars).numpy()
    err = np.abs(got.astype(np.float64) - ref).max()
    assert err <= len(plan.stages) * TOL["float32"] * np.abs(ref).max(), err


@pytest.mark.parametrize("case", CASES)
def test_flattening_and_reach_match_jax(case):
    module, jm, name = _both(case)
    plan = chain.chain_plan(module, name)
    jplan = pallas_chain.chain_plan(jm, name)

    def binds(stages):
        return [
            (
                st.in_slots,
                tuple(b if b[0] == "arg" else (b[0], b[1], b[2].name) for b in st.scalars),
                st.out_slot,
                (st.op.attrs["bounds"].lb, st.op.attrs["bounds"].ub),
                bool(st.op.attrs.get("periodic")),
            )
            for st in stages
        ]

    assert binds(plan.stages) == binds(jplan["stages"])
    assert (plan.final_slot, plan.peak, plan.last_use) == (
        jplan["final_slot"], jplan["peak"], jplan["last_use"]
    )
    # JAX's dim-0 creep, recomputed from its stages
    creep = {s: 0 for s in range(jplan["n_fields"])}
    for st in jplan["stages"]:
        h0 = max(st.op.attrs["shape"].halo()[0])
        creep[st.out_slot] = max(creep[s] for s in st.in_slots) + h0
    assert {s: c[0] for s, c in plan.creep.items()} == creep
    assert jplan["hp"] == -(-plan.reach[0] // 8) * 8
    assert plan.reach == CASES[case][4]
    assert plan.periodic == jplan["periodic"]


def test_buffers_are_reused():
    plan = chain.chain_plan(stencils.coupled((64, 128)), "couple")
    # u, v, the first stage; the lap reuses v's buffer once v is dead; the
    # last stage writes to device memory
    assert plan.buffer == {0: 0, 1: 1, 2: 2, 3: 1} and plan.n_buffers == 3
    # two sets of the two fields (the next tile's in flight), the first
    # stage's buffer, the wrapped-cell table; the column halo widened to 4
    assert plan.smem_bytes == 4 * ((2 * 2 + 1) * 36 * 72 + (1 + 36 + 72)) <= chain.SMEM_MAX


def test_refused_opdefs_run_stage_at_a_time():
    assert chain.chain_plan(stencils.jacobi5((64, 128)), "jacobi") is None  # one stage
    assert chain.chain_plan(stencils.gradients((64, 128)), "grad") is None  # two results
    module = stencils.composite((64, 128))
    run = CompiledModule(module, backend="torch").opdef("wrapped")
    assert run.__name__ == "neptune_wrapped"


def test_chain_callable_checks_its_arguments():
    module = stencils.coupled((32, 48))
    cm = CompiledModule(module)
    run = cm.chain_callable("couple")
    x = np.zeros((32, 48), np.float32)
    with pytest.raises(TypeError, match="expects 4 args"):
        run(x, x, 1.0)
    with pytest.raises(TypeError, match="shape"):
        run(x, np.zeros((32, 47), np.float32), 1.0, 2.0)
    assert cm.chain_callable("lap") is None
    rng = np.random.default_rng(1)
    u, v = (torch.from_numpy(rng.standard_normal((32, 48)).astype(np.float32)) for _ in range(2))
    stage_at_a_time = cm._make_callable(module.lookup("couple"))
    assert torch.equal(run(u, v, 0.5, 2.0), stage_at_a_time(u, v, 0.5, 2.0))


def test_generated_source():
    plan = chain.chain_plan(stencils.composite((64, 128), mixed=True), "wrapped")
    src = codegen.chain_source(plan)
    assert src.startswith('#include "nt_chain.cuh"')
    assert src.rstrip().endswith("NT_DEFINE_CHAIN(NtChain)")
    assert src.count("struct NtStage") == len(plan.stages) == 3
    assert src.count("nt_chain_stage<") == 2 and src.count("nt_chain_last<") == 1
    assert "kWrap = true;" in src and "kBuffers = 3;" in src
    assert "using Tile = NtTile<1, 32, 64, 0, 2, 4>;" in src
