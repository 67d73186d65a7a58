"""The JAX package's GSPMD entry points, on the port's one distributed mode.

`neptune_tpu/parallel/sharded.py` jits the whole-array executor with mesh
shardings and leaves the communication to XLA's partitioner. PyTorch has
no such partitioner, so the port runs one distributed mode, the explicit
halo exchange of `sharded_apply`: `sharded_opdef` is `shardmap_opdef`.
"""

from __future__ import annotations

from typing import Callable

from .mesh import GridMesh
from .sharded_apply import shardmap_opdef


def sharded_opdef(cm, name: str, gmesh: GridMesh) -> Callable:
    """An opdef's matvec over this process's blocks (for distributed
    Krylov solves: pass the mesh's group to the solver)."""
    return shardmap_opdef(cm, name, gmesh)


def sharded_function(cm, name: str, gmesh: GridMesh, arg_ranks=None) -> Callable:
    raise NotImplementedError(
        "sharded_function (a whole compiled function over a mesh) is not ported "
        "to neptune_tpu_torch yet: ROADMAP.md, queue 1, item 9"
    )
