"""Whole-simulation time loops.

The port of `neptune_tpu/solvers/time.py`. The JAX package rolls the step
into `lax.fori_loop` / `lax.scan` under one `jax.jit`; here the loop runs on
the host and each step runs as it is written (its kernels, its solves).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch


def _stack(states: list, like):
    """The recorded states on a leading axis, leaf by leaf."""
    if isinstance(like, (tuple, list)):
        return tuple(_stack([s[i] for s in states], leaf) for i, leaf in enumerate(like))
    if not states:
        return like.new_empty((0, *like.shape))
    return torch.stack(states)


def simulate(
    step: Callable,
    state0,
    n_steps: int,
    *,
    record_every: Optional[int] = None,
    jit: bool = True,
    differentiable: bool = False,
):
    """Run `state = step(state)` n_steps times.

    record_every=k also returns the state every k steps, stacked on a
    leading axis; the n_steps % k steps after the last record run
    unrecorded. The state may be a tensor or a tuple of tensors.

    differentiable=False runs the loop under `torch.no_grad()`;
    differentiable=True keeps the graph, so reverse mode runs through the
    whole simulation (adjoint time integration). `jit` is accepted for the
    JAX package's signature and has no effect here.
    """
    del jit
    with contextlib.nullcontext() if differentiable else torch.no_grad():
        s = state0
        if record_every is None:
            for _ in range(n_steps):
                s = step(s)
            return s
        outer, remainder = divmod(n_steps, record_every)
        traj = []
        for _ in range(outer):
            for _ in range(record_every):
                s = step(s)
            traj.append(s)
        traj = _stack(traj, s)
        for _ in range(remainder):
            s = step(s)
        return s, traj
