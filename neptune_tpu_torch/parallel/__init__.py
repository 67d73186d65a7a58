"""Domain decomposition over a mesh of processes (`torch.distributed`).

The port of `neptune_tpu/parallel/`'s explicit-communication path: one
process per mesh position, each holding its block of every field on its
own device. The communication-avoiding solvers (`ca_*`) and
`sharded_function` are not ported yet (ROADMAP.md, queue 1, item 9).
"""

from .distributed import initialize_multihost
from .halo import allreduce_sum, halo_pad_local, sharded_stencil
from .mesh import GridMesh, single_device_mesh
from .sharded import sharded_function, sharded_opdef
from .sharded_apply import plan_opdef, plan_report, shardmap_opdef, shardmap_sweeps

__all__ = [
    "initialize_multihost",
    "allreduce_sum",
    "halo_pad_local",
    "sharded_stencil",
    "GridMesh",
    "single_device_mesh",
    "sharded_function",
    "sharded_opdef",
    "plan_opdef",
    "plan_report",
    "shardmap_opdef",
    "shardmap_sweeps",
]
