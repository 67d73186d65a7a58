"""The port's one way of running processes joined by torch.distributed on
one host (`parallel.distributed.spawn_ranks`), which `entry.dryrun_multichip`
and the examples' `--procs N` share: a rank that fails is reported within
seconds while the others wait on it in a collective, and ranks that print
more than a pipe holds still finish."""

import os
import sys
import time

import pytest

pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from neptune_tpu_torch.examples import _cli  # noqa: E402
from neptune_tpu_torch.parallel.distributed import (  # noqa: E402
    local_ranks, mesh_shape_2d, spawn_ranks,
)

RANK = """
import sys
import torch.distributed as dist
from neptune_tpu_torch.parallel import initialize_multihost
rank, world, port, mode = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
initialize_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo")
if mode == "raise" and rank == 1:
    raise ValueError("rank one fails")
if mode == "print":
    sys.stdout.write("x" * (1 << 20))
dist.barrier()
dist.destroy_process_group()
"""


def _run(mode: str, world: int):
    t0 = time.perf_counter()
    ranks = spawn_ranks(lambda r, port: ["-c", RANK, str(r), str(world), port, mode], world,
                        timeout=300)
    return ranks, time.perf_counter() - t0


def test_a_failing_rank_is_reported_while_the_others_wait():
    """Rank 1 raises; ranks 0 and 2 sit in a barrier that never completes.
    The call returns a few seconds later, long before its timeout,
    with rank 1's traceback and every rank stopped."""
    ranks, wall = _run("raise", 3)
    assert wall < 120, wall
    assert ranks[1][0] not in (None, 0) and "rank one fails" in ranks[1][1]
    assert all(code is not None for code, _ in ranks)


def test_ranks_that_print_more_than_a_pipe_holds_finish():
    ranks, _ = _run("print", 2)
    assert [code for code, _ in ranks] == [0, 0]
    assert all(out.count("x") >= 1 << 20 for _, out in ranks)


def test_a_procs_run_names_its_failed_ranks():
    """`--procs 2` of a module that cannot be imported: `_cli.spmd`'s
    spawner raises, naming the ranks and their output."""
    import torch

    with pytest.raises(RuntimeError, match=r"--procs 2: ranks \[0, 1\] exited") as e:
        _cli._spawn("neptune_tpu_torch.examples.no_such_example", 2, torch.device("cpu"))
    assert "ModuleNotFoundError" in str(e.value)


@pytest.mark.parametrize("n, mesh", [(1, (1, 1)), (2, (2, 1)), (4, (2, 2)), (6, (3, 2)),
                                     (8, (4, 2))])
def test_the_squarest_mesh(n, mesh):
    assert mesh_shape_2d(n) == mesh
    assert local_ranks(n, "cpu") == ("gloo", ["cpu"] * n)
