"""What the examples share: the device they run on and the mesh they run over.

    python -m neptune_tpu_torch.examples.<name> [--cpu] [--procs N]

--cpu runs on the CPU, where an example that picks its dtype picks f64, as
the JAX examples' --cpu does. Without it the examples run on the card and
raise where there is none: nothing falls back to the CPU.

--procs N (the mesh examples: multichip_poisson, comm_avoiding_jacobi,
ca_krylov_poisson) runs N processes joined by `torch.distributed`, each
holding its blocks, on the squarest 2-D mesh of N positions, as the JAX
examples factor their device count: gloo on the CPU or where the processes
share one card (NCCL refuses two processes on one card), NCCL when there are
N cards. Rank 0's output is printed and its result returned. Without
--procs the mesh is one process.

The examples read --cpu where the JAX examples do, when they are imported:
an example that picks f32 on the card defines its opdefs with that dtype.
"""

from __future__ import annotations

import importlib
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..config import config, default_device
from ..parallel.distributed import local_ranks, mesh_shape_2d, spawn_ranks

# seconds the processes of one --procs run may take together
SPAWN_TIMEOUT = 1800


def cpu_requested() -> bool:
    """Whether the command line asks for the CPU."""
    return "--cpu" in sys.argv[1:]


def procs_requested() -> int:
    """N of `--procs N` on the command line (1 without it)."""
    argv = sys.argv[1:]
    if "--procs" not in argv:
        return 1
    i = argv.index("--procs")
    if i + 1 >= len(argv) or not argv[i + 1].isdigit() or int(argv[i + 1]) < 1:
        raise ValueError("--procs takes a positive count of processes")
    return int(argv[i + 1])


def device() -> torch.device:
    """The examples' device: the CPU under --cpu, the card otherwise (which
    raises without one). NumPy inputs of DSL calls go there too."""
    config.device = "cpu" if cpu_requested() else "cuda"
    return default_device()


def save(result: dict, path) -> None:
    """An example's result (numbers, strings, arrays) as an .npz file."""
    np.savez(path, **{k: np.asarray(v) for k, v in result.items()})


def load(path) -> dict:
    """`save`'s result back: 0-d entries as Python numbers or strings."""
    with np.load(path) as z:
        return {k: (z[k].item() if z[k].ndim == 0 else z[k]) for k in z.files}


def spmd(module: str, main) -> dict:
    """Run the mesh example `module`'s main(gm): on a mesh of one process
    here, or under --procs N in N processes, returning rank 0's result."""
    from ..parallel import GridMesh

    dev = device()
    n = procs_requested()
    if n == 1:
        return main(GridMesh((1, 1), ("x", "y"), device=dev))
    return _spawn(module, n, dev)


def _spawn(module: str, n: int, dev: torch.device) -> dict:
    backend, devices = local_ranks(n, dev)
    with tempfile.TemporaryDirectory(prefix="nt_example_") as out:
        ranks = spawn_ranks(lambda r, port: [
            "-m", "neptune_tpu_torch.examples._cli", "--rank", module, str(r), str(n), port,
            devices[r], backend, out], n, SPAWN_TIMEOUT)
        bad = [r for r, (code, _) in enumerate(ranks) if code]
        if bad:
            raise RuntimeError(
                f"{module} --procs {n}: ranks {bad} exited {[ranks[r][0] for r in bad]}:\n"
                + "\n".join(ranks[r][1][-4000:] for r in bad))
        print(ranks[0][1], end="")
        return load(Path(out, "rank0.npz"))


def _rank(module: str, rank: int, n: int, port: str, device_name: str, backend: str,
          out: str) -> int:
    """One process of `spmd`'s --procs run: join the group, run main on
    this process's blocks, and (rank 0) save the result."""
    import torch.distributed as dist

    from ..parallel import GridMesh, initialize_multihost

    torch.set_num_threads(1)
    initialize_multihost(f"127.0.0.1:{port}", n, rank, backend=backend)
    config.device = torch.device(device_name).type
    gm = GridMesh(mesh_shape_2d(n), ("x", "y"), device=device_name)
    result = importlib.import_module(module).main(gm)
    if rank == 0:
        save(result, Path(out, "rank0.npz"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] != ["--rank"] or len(sys.argv) != 9:
        sys.exit("usage: python -m neptune_tpu_torch.examples._cli --rank MODULE RANK N PORT "
                 "DEVICE BACKEND OUT")
    m, r, n_, p, d, be, o = sys.argv[2:]
    sys.exit(_rank(m, int(r), int(n_), p, d, be, o))
