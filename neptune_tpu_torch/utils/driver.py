"""Long-simulation driver: periodic checkpointing + crash resume.

The port of `neptune_tpu/utils/driver.py`. The reference has no failure
handling at all (it aborts on any error and persists nothing — SURVEY.md
§5). This driver gives long simulations the standard recovery loop: run
`checkpoint_every` steps at a time, checkpoint atomically after each chunk,
and resume from the last checkpoint after a crash or a restart.

A chunk is a plain loop of `step` calls. The JAX package compiles it as one
`jax.jit` of a `fori_loop`; here the solvers test convergence on the host,
so there is no graph to capture.
"""

from __future__ import annotations

import time as _time
from pathlib import Path
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from ..config import default_device
from .checkpoint import host_fields, load_checkpoint, save_checkpoint


class SimulationDriver:
    """Runs `state = step(state)` with periodic checkpoints.

    state is a dict of named field tensors (or arrays), which is what the
    checkpoint format stores.
    """

    def __init__(
        self,
        step: Callable[[dict], dict],
        checkpoint_path: str | Path,
        checkpoint_every: int = 100,
        dt: float = 0.0,
    ):
        if int(checkpoint_every) < 1:
            raise ValueError("checkpoint_every must be >= 1")
        self.step = step
        self.path = Path(checkpoint_path)
        self.every = int(checkpoint_every)
        self.dt = float(dt)

    def _chunk_runner(self, n: int):
        def run(state):
            for _ in range(n):
                state = self.step(state)
            return state

        return run

    def resume_or_init(self, init_state: Mapping[str, object]):
        """Returns (state, start_step): the checkpointed state if one exists,
        the initial state otherwise, as tensors. A field goes to the device
        of `init_state`'s tensor of that name, in its dtype; a field given
        as an array goes to `config.device`."""
        step, fields = 0, dict(init_state)
        if self.path.exists():
            fields, meta = load_checkpoint(self.path)
            step = int(meta["step"])
        state = {}
        for k, v in fields.items():
            like = init_state.get(k)
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
            if isinstance(like, torch.Tensor):
                t = t.to(device=like.device, dtype=like.dtype)
            else:
                t = t.to(default_device())
            state[k] = t
        return state, step

    def run(
        self,
        init_state: Mapping[str, object],
        n_steps: int,
        *,
        walltime_budget_s: Optional[float] = None,
        on_checkpoint: Optional[Callable[[int, dict], None]] = None,
    ) -> tuple[dict, int]:
        """Advance to n_steps total (counting any resumed progress). Returns
        (state, step), the state as the step function left it.

        Stops early (after a checkpoint) when the walltime budget is spent —
        rerunning the same call later resumes where it left off.
        on_checkpoint(step, host_state) sees each checkpoint's NumPy fields.
        """
        state, step0 = self.resume_or_init(init_state)
        t0 = _time.time()
        step = step0
        while step < n_steps:
            chunk = min(self.every, n_steps - step)
            state = self._chunk_runner(chunk)(state)
            step += chunk
            host_state = host_fields(state)
            save_checkpoint(self.path, host_state, step=step, time=step * self.dt)
            if on_checkpoint:
                on_checkpoint(step, host_state)
            if walltime_budget_s and _time.time() - t0 > walltime_budget_s:
                break
        return state, step
