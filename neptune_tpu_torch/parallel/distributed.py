"""Joining a multi-process run.

The port of `neptune_tpu/parallel/distributed.py`. Where the JAX package
joins a multi-host runtime with `jax.distributed.initialize`, the port runs
one process per mesh position and joins them with
`torch.distributed.init_process_group`: explicit arguments, or the
`env://` variables a launcher such as `torchrun` sets.
"""

from __future__ import annotations

import os
from typing import Optional

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
