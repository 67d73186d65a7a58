"""Domain decomposition over a mesh of processes (`torch.distributed`).

The port of `neptune_tpu/parallel/`'s explicit-communication path: one
process per mesh position, each holding its block of every field on its
own device. `shardmap_opdef` / `shardmap_sweeps` run an operator on the
blocks; the communication-avoiding solvers (`cg_sharded`, `gmres_sharded`,
`bicgstab_sharded`, `chebyshev_sharded`) solve with one exchange and one
reduction per outer block; `sharded_function` runs a whole compiled
function on the blocks; `build_ca_levels` and `ca_smoother` give the
multigrid V-cycle communication-avoiding smoothers on the blocks.
"""

from .distributed import initialize_multihost
from .halo import allreduce_sum, halo_pad_local, sharded_stencil
from .mesh import GridMesh, single_device_mesh
from .sharded import sharded_function, sharded_opdef
from .ca_bicgstab import bicgstab_sharded
from .ca_cg import cg_sharded
from .ca_gmres import gmres_sharded
from .ca_multigrid import build_ca_levels, ca_smoother
from .ca_chebyshev import chebyshev_sharded
from .sharded_apply import plan_opdef, plan_report, shardmap_opdef, shardmap_sweeps

__all__ = [
    "bicgstab_sharded",
    "build_ca_levels",
    "ca_smoother",
    "cg_sharded",
    "chebyshev_sharded",
    "gmres_sharded",
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
