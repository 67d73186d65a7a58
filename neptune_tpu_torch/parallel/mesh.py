"""Process meshes for domain decomposition.

The port of `neptune_tpu/parallel/mesh.py`. The JAX package lays a grid
over a `jax.sharding.Mesh` of devices and runs per-shard code under
`shard_map`. Here the mesh is a grid of processes (SPMD): mesh position p
is the process of rank p of the default `torch.distributed` group, in C
order over the mesh shape, and each process holds its own block of every
field as an ordinary tensor on its device. Grid dim d is split over mesh
axis d; trailing grid dims beyond the mesh's rank stay whole.

`ring_shift` takes the place of `lax.ppermute` over one axis and sends to
the neighbour's global rank, computed from the mesh coordinates, so no
per-axis groups are needed. `allreduce` takes the place of `lax.psum` over
the axes that shard a field: a field of fewer dims than the mesh is
replicated along the remaining axes, so its sums run over a subgroup
(built with the mesh, on every process in the same order). A mesh of one
position needs no process group.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import default_device
from ..utils.tree import MeshGroup


def _default_device(rank: int) -> torch.device:
    dev = default_device()
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device(f"cuda:{local % torch.cuda.device_count()}")


class GridMesh:
    """A mesh of processes aligned with the leading grid dims.

    abstract=True gives a topology-only mesh, enough for `plan_opdef` and
    `plan_report` without a process group. Otherwise the default process
    group must hold exactly n_devices processes (any number for a mesh of
    one position). device: where this process keeps its blocks; default
    `config.device`, on CUDA `cuda:{LOCAL_RANK % device_count()}`.
    """

    def __init__(
        self,
        shape: Sequence[int],
        axis_names: Optional[Sequence[str]] = None,
        abstract: bool = False,
        device=None,
    ):
        shape = tuple(int(s) for s in shape)
        if axis_names is None:
            axis_names = tuple(f"d{i}" for i in range(len(shape)))
        axis_names = tuple(axis_names)
        if len(axis_names) != len(shape):
            raise ValueError("axis_names / mesh shape rank mismatch")
        self.shape = shape
        self.axis_names = axis_names
        self.abstract = abstract
        self.group = None
        self.rank = None
        self.coords = None
        self.device = None
        # bytes this process sent to its neighbours, and the part of them
        # that went through host memory (a gloo group with CUDA blocks);
        # ring_shift calls, allreduce calls and gather calls
        self.sent_bytes = 0
        self.staged_bytes = 0
        self.shifts = 0
        self.reductions = 0
        self.gathers = 0
        # grid rank -> the group that sums a field of that rank (None: the
        # field is whole on this process)
        self._sum_groups: dict = {}
        if abstract:
            return
        if self.n_devices == 1:
            self.rank = 0
        else:
            if not dist.is_initialized():
                raise RuntimeError(
                    f"mesh {shape} needs {self.n_devices} processes: join them with "
                    "initialize_multihost first"
                )
            if dist.get_world_size() != self.n_devices:
                raise ValueError(
                    f"mesh {shape} needs {self.n_devices} processes, the process group "
                    f"has {dist.get_world_size()}"
                )
            self.rank = dist.get_rank()
            self.group = dist.group.WORLD
        self.coords = self.coords_of(self.rank)
        self._build_sum_groups()
        self.device = _default_device(self.rank) if device is None else torch.device(device)
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)

    # ------------------------------------------------------------------
    # topology
    # ------------------------------------------------------------------

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape)

    def pspec(self, grid_rank: int) -> tuple:
        """The mesh axis splitting each of the first grid_rank dims (None:
        whole), as the JAX package's PartitionSpec."""
        entries = list(self.axis_names[:grid_rank])
        return tuple(entries + [None] * (grid_rank - len(entries)))

    def check_divisible(self, grid_shape: Sequence[int]):
        for d, (g, m) in enumerate(zip(grid_shape, self.shape)):
            if g % m != 0:
                raise ValueError(
                    f"grid dim {d} extent {g} not divisible by mesh axis "
                    f"{self.axis_names[d]} size {m}"
                )

    def coords_of(self, rank: int) -> tuple:
        return tuple(int(c) for c in np.unravel_index(rank, self.shape))

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def axis_index(self, name: str) -> int:
        return self.coords[self.axis_names.index(name)]

    def neighbor(self, name: str, shift: int) -> int:
        """Global rank of the position `shift` steps along axis `name`,
        around the ring."""
        a = self.axis_names.index(name)
        c = list(self.coords)
        c[a] = (c[a] + shift) % self.shape[a]
        return int(np.ravel_multi_index(c, self.shape))

    def block_slices(self, global_shape: Sequence[int], coords=None) -> tuple:
        coords = self.coords if coords is None else coords
        self.check_divisible(global_shape)
        out = []
        for d, g in enumerate(global_shape):
            if d < len(self.shape):
                n = g // self.shape[d]
                out.append(slice(coords[d] * n, (coords[d] + 1) * n))
            else:
                out.append(slice(None))
        return tuple(out)

    def _build_sum_groups(self):
        """The group of each grid rank r up to the mesh's rank: the
        processes that differ only in the first r mesh coordinates (a new
        group where that is neither this process alone nor all of them).
        `dist.new_group` is collective, so every process builds every
        group, in one order."""
        for r in range(1, len(self.shape) + 1):
            size = math.prod(self.shape[:r])
            if size == 1 or self.group is None:
                self._sum_groups[r] = None
            elif size == self.n_devices:
                self._sum_groups[r] = self.group
            else:
                mine = None
                for rest in np.ndindex(*self.shape[r:]):
                    ranks = [
                        int(np.ravel_multi_index(tuple(c) + rest, self.shape))
                        for c in np.ndindex(*self.shape[:r])
                    ]
                    g = dist.new_group(ranks)
                    if rest == self.coords[r:]:
                        mine = g
                self._sum_groups[r] = mine

    def sum_group(self, grid_rank: int):
        """The process group over which a field of `grid_rank` dims is
        sharded (None: every process holds it whole)."""
        return self._sum_groups[min(grid_rank, len(self.shape))]

    def mesh_group(self, grid_rank: int) -> MeshGroup:
        """What the solvers' and `utils.tree`'s `group=` take for a field of
        `grid_rank` dims: its `sum_group` with this mesh's layout, which
        pinned arithmetic needs to sum over the global vector."""
        return MeshGroup(self, grid_rank)

    # ------------------------------------------------------------------
    # data
    # ------------------------------------------------------------------

    def allreduce(self, t: torch.Tensor, grid_rank: int, op: str = "sum") -> torch.Tensor:
        """t ("sum", "max" or "min") over the processes that shard a field
        of `grid_rank` dims: `lax.psum` over exactly those mesh axes, since
        the other axes hold replicas. Counted in `reductions`."""
        self.reductions += 1
        group = self.sum_group(grid_rank)
        if group is None:
            return t
        staged = self._staged(t)
        buf = t.detach().to("cpu", copy=True) if staged else t.detach().clone()
        dist.all_reduce(buf, op=getattr(dist.ReduceOp, op.upper()), group=group)
        return buf.to(t.device) if staged else buf

    def shard(self, array) -> torch.Tensor:
        """This process's block of a global array (a tensor or NumPy array
        every process holds), on the mesh's device."""
        t = array if isinstance(array, torch.Tensor) else torch.as_tensor(np.asarray(array))
        return t[self.block_slices(t.shape)].to(self.device).contiguous()

    def _staged(self, t: torch.Tensor) -> bool:
        return t.is_cuda and "nccl" not in str(dist.get_backend(self.group))

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The global array, on every process, from each one's block.
        Counted in `gathers`."""
        self.gathers += 1
        if self.group is None:
            return local
        src = local.detach().contiguous()
        staged = self._staged(src)
        if staged:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.n_devices)]
        dist.all_gather(parts, src, group=self.group)
        gshape = [
            n * self.shape[d] if d < len(self.shape) else n for d, n in enumerate(src.shape)
        ]
        out = torch.empty(gshape, dtype=src.dtype, device=src.device)
        for r, p in enumerate(parts):
            out[self.block_slices(gshape, self.coords_of(r))] = p
        return out.to(local.device)

    def ring_shift(self, t: torch.Tensor, name: str, shift: int) -> torch.Tensor:
        """What the position `shift` steps back along axis `name` holds in
        `t`, while `t` goes `shift` steps forward: `lax.ppermute` over a
        ring. On an axis of size 1 the ring is this process: a copy. A gloo
        group takes CUDA tensors through host memory; the kernels still run
        on the card."""
        self.shifts += 1
        if self.axis_size(name) == 1:
            return t.clone()
        send = t.contiguous()
        staged = self._staged(send)
        if staged:
            send = send.cpu()
        recv = torch.empty_like(send)
        ops = [
            dist.P2POp(dist.isend, send, self.neighbor(name, shift), self.group),
            dist.P2POp(dist.irecv, recv, self.neighbor(name, -shift), self.group),
        ]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        nbytes = send.numel() * send.element_size()
        self.sent_bytes += nbytes
        if staged:
            self.staged_bytes += nbytes
            return recv.to(t.device)
        return recv


def single_device_mesh(device=None) -> GridMesh:
    """A mesh of one position: this process holds every grid whole."""
    return GridMesh((1,), ("x",), device=device)
