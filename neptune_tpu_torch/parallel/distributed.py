"""Joining a multi-process run.

The port of `neptune_tpu/parallel/distributed.py`. Where the JAX package
joins a multi-host runtime with `jax.distributed.initialize`, the port runs
one process per mesh position and joins them with
`torch.distributed.init_process_group`: explicit arguments, or the
`env://` variables a launcher such as `torchrun` sets. `spawn_ranks`
starts such processes on this host and waits for them; `mesh_shape_2d`
and `local_ranks` say what mesh and devices they take.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.distributed as dist

# the variables of an env:// rendezvous
_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def default_backend() -> str:
    """NCCL for CUDA tensors and gloo for CPU tensors where the card is
    there, gloo alone otherwise."""
    return "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> int:
    """Join (or bootstrap) the default process group; returns its size.

    coordinator_address ("host:port"), num_processes and process_id name
    the rendezvous explicitly; without them the `env://` variables are read
    when all are set, and a single process stays alone (a no-op returning
    1). A second call is a no-op. An error other than "already
    initialized" -- a bad address, a port clash -- propagates. backend:
    default `default_backend()`; "gloo" where several processes share one
    card, which NCCL refuses.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    backend = backend or default_backend()
    try:
        if coordinator_address or num_processes:
            dist.init_process_group(
                backend=backend,
                init_method=f"tcp://{coordinator_address}" if coordinator_address else "env://",
                world_size=-1 if num_processes is None else int(num_processes),
                rank=-1 if process_id is None else int(process_id),
            )
        elif all(k in os.environ for k in _ENV):
            dist.init_process_group(backend=backend, init_method="env://")
    except RuntimeError as e:
        if "already initialized" not in str(e).lower():
            raise
    return dist.get_world_size() if dist.is_initialized() else 1


def mesh_shape_2d(n: int) -> tuple:
    """Factor n into the squarest 2-D mesh (a, b), a >= b, as the JAX
    package factors its device count."""
    b = next(c for c in range(int(n**0.5), 0, -1) if n % c == 0)
    return (n // b, b)


def local_ranks(n: int, device) -> tuple:
    """The backend and each rank's device for n processes on this host:
    with at least n cards, process r takes card r and NCCL carries CUDA
    tensors; otherwise gloo, on the CPU or with every process sharing
    card 0 (NCCL refuses two processes on one card). device: a
    torch.device, "cpu" or "cuda"."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n:
        return "cpu:gloo,cuda:nccl", [f"cuda:{r}" for r in range(n)]
    return "gloo", ["cpu" if dev.type == "cpu" else "cuda:0"] * n


# seconds the other processes get once one has failed
_GRACE = 10.0


def spawn_ranks(args: Callable[[int, str], list], n: int, timeout: float) -> list:
    """Run n processes of this Python on this host, process r with the
    arguments args(r, port), where port is a free localhost port for their
    rendezvous (gloo over the loopback, one host thread each, this package
    importable), and wait for them. Once one has failed, the others get a
    few seconds (their collectives may wait on it) and are stopped.
    Each one's output goes to a file, so none can block on a full pipe.
    Returns [(exit code, output)] by rank; raises TimeoutError, with the
    outputs' ends, when they have not finished in `timeout` seconds."""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = str(sk.getsockname()[1])
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([root, env.get("PYTHONPATH", "")])
    with tempfile.TemporaryDirectory(prefix="nt_ranks_") as logs:
        files = [open(Path(logs, f"rank{r}.log"), "w+") for r in range(n)]
        procs = []
        timed_out = False
        try:
            for r in range(n):
                procs.append(subprocess.Popen([sys.executable, *args(r, port)], env=env,
                                              stdout=files[r], stderr=subprocess.STDOUT))
            deadline = time.perf_counter() + timeout
            failed_at = None
            while any(p.poll() is None for p in procs):
                now = time.perf_counter()
                if now > deadline:
                    timed_out = True
                    break
                if failed_at is None and any(p.poll() not in (None, 0) for p in procs):
                    failed_at = now
                if failed_at is not None and now - failed_at > _GRACE:
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            outs = []
            for f in files:
                f.seek(0)
                outs.append(f.read())
                f.close()
    if timed_out:
        raise TimeoutError(f"{n} processes did not finish in {timeout} s:\n"
                           + "\n".join(o[-2000:] for o in outs))
    return [(p.returncode, o) for p, o in zip(procs, outs)]
