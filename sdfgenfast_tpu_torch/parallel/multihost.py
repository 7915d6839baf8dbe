"""Multi-process execution of the sharded pipeline over ``torch.distributed``.

Counterpart of ``sdfgenfast_tpu/parallel/multihost.py``. The shards of a
device mesh are spread over several processes (one card a process, or
several processes sharing a card or the CPU); each process runs the
stages of ``parallel/sharded.py`` on the shards it owns, and the shards
reach each other through a :class:`DistributedTransport`:

- a halo exchange is one ``batch_isend_irecv`` per exchange phase: all of
  this process's sends and receives of one axis are posted together, so no
  order of the processes can deadlock; neighbours in the same process copy
  directly;
- the pyramid's coarsest level, and a result that every process wants
  (:func:`fetch_global`), are an ``all_gather`` of the blocks;
- under NCCL a device tensor is sent as it is; under gloo, whose send and
  receive take CPU tensors, a CUDA block is staged through host memory
  before the send and after the receive. The process group's backend picks
  the branch; nothing switches backend on its own.

The binning stays replicated: every process runs the same host binning
(``bin_mesh_sharded``) on the same mesh and uploads only its shards' slices
of it (:func:`make_global_array`), so no host data crosses processes.
``far_field="propagate"`` is rejected, as the JAX package rejects it, and
no vertex gradient is computed (JAX's ``skip_recompute=True``).

Start every process with :func:`initialize` (the caller names the
address, the world size, its rank and the backend: ``"gloo"`` on the CPU
and for several processes on one card, ``"nccl"`` for one card a process),
then build the mesh with :func:`global_device_mesh` and pass it as
``generate_sdf_batch(device_mesh=...)``, which returns the same grids on
every process.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..platform import require_cuda
from ..upload import to_host
from . import sharded as sh

__all__ = ["initialize", "global_device_mesh", "make_global_array",
           "fetch_global", "sharded_sdf_multihost", "assemble_blocks",
           "DistributedTransport"]


def initialize(init_method: str, world_size: int, rank: int,
               backend: str) -> None:
    """Join the process group (``torch.distributed.init_process_group``);
    a second call in the same process does nothing. `init_method` is
    e.g. ``"tcp://localhost:29500"``; `backend` ``"gloo"`` or ``"nccl"``."""
    if dist.is_initialized():
        return
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=int(world_size), rank=int(rank))


def global_device_mesh(local_devices=None,
                       shape: Optional[Tuple[int, int]] = None
                       ) -> sh.DeviceMesh:
    """A (j, k) mesh over every process's devices, the same on every
    process: each process gives its `local_devices` (default: its CUDA
    device, ``cuda:{rank % device count}``), gathered in rank order and
    shaped like ``make_device_mesh`` shapes them (`shape`, default the most
    square factoring). ``ranks`` names each shard's process. Every process
    must give as many devices."""
    if not dist.is_initialized():
        raise RuntimeError("call multihost.initialize first")
    if local_devices is None:
        require_cuda()
        local_devices = [f"cuda:{dist.get_rank() % torch.cuda.device_count()}"]
    local = [torch.device(d) for d in local_devices]
    if local and local[0].type == "cuda":
        # the process's collectives run on its first card
        torch.cuda.set_device(local[0])
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, [str(d) for d in local])
    if len({len(part) for part in every}) != 1:
        raise ValueError("every process must give as many devices, got "
                         f"{[len(part) for part in every]}")
    mesh = sh.make_device_mesh([d for part in every for d in part], shape)
    ranks = np.asarray([r for r, part in enumerate(every) for _ in part])
    return dataclasses.replace(mesh, ranks=ranks.reshape(mesh.devices.shape))


def _mine(device_mesh) -> np.ndarray:
    """The (Dj, Dk) mask of the shards this process owns."""
    if not sh.spans_processes(device_mesh):
        return np.ones(device_mesh.devices.shape, bool)
    return device_mesh.ranks == dist.get_rank()


def make_global_array(host_array: np.ndarray, device_mesh):
    """This process's blocks of a replicated (Dj, Dk, ...) host array: the
    grid with ``host_array[dj, dk]`` on shard (dj, dk)'s device where this
    process owns it, None elsewhere. Every process holds the whole array,
    so nothing crosses processes."""
    mine = _mine(device_mesh)
    return [[sh._upload(host_array[dj, dk], device_mesh.devices[dj, dk])
             if mine[dj, dk] else None for dk in range(mine.shape[1])]
            for dj in range(mine.shape[0])]


class DistributedTransport(sh.LocalTransport):
    """The shards' exchanges when processes share the mesh
    (``DeviceMesh.ranks``): halo planes between processes by
    point-to-point sends, one ``batch_isend_irecv`` a phase; whole levels
    by ``all_gather``; under gloo CUDA tensors staged through host
    memory."""

    def __init__(self, device_mesh):
        super().__init__(device_mesh.devices)
        self.ranks = device_mesh.ranks
        self.rank = dist.get_rank()
        self.mine = self.ranks == self.rank
        counts = np.bincount(self.ranks.ravel(),
                             minlength=dist.get_world_size())
        if counts.min() != counts.max():
            raise ValueError("every process must own as many shards, got "
                             f"{counts.tolist()}")
        backend = dist.get_backend()
        local = [d for d, m in zip(self.devices.flat, self.mine.flat) if m]
        if backend == "nccl" and any(d.type != "cuda" for d in local):
            raise ValueError("the nccl backend sends CUDA tensors only: "
                             "give CPU shards the gloo backend")
        # gloo's send and receive take CPU tensors
        self.staged = backend == "gloo"

    def _wire(self, x):
        """`x` as the backend sends it: contiguous, on the host if
        staged."""
        return (x.cpu() if self.staged else x).contiguous()

    def _remote_halos(self, grid, axis_name, axis, depth):
        """Post every send and receive of this phase in one
        ``batch_isend_irecv``: a message for each (block, neighbour)
        pair that two processes own, in one global order (the tag is its
        place in it), so both ends list each pair's messages alike."""
        dims = self.ranks.shape
        if (len(grid), len(grid[0])) != dims:
            raise ValueError("a halo exchange between processes takes the "
                             "whole mesh's grid")
        ops, recv = [], {}
        tag = 0
        for dj, dk in np.ndindex(dims):
            for step in (-1, 1):
                nb = sh._neighbour(dj, dk, axis_name, step, dims)
                if nb is None:
                    continue
                tag += 1
                src, dst = int(self.ranks[nb]), int(self.ranks[dj, dk])
                if src == dst:
                    continue
                if dst == self.rank:
                    x = grid[dj][dk]
                    shape = list(x.shape)
                    shape[axis] = depth
                    buf = torch.empty(shape, dtype=x.dtype, device=(
                        "cpu" if self.staged else x.device))
                    recv[dj, dk, step] = buf
                    ops.append(dist.P2POp(dist.irecv, buf, src, tag=tag))
                elif src == self.rank:
                    plane = sh._halo_plane(grid[nb[0]][nb[1]], axis, depth,
                                           step)
                    ops.append(dist.P2POp(dist.isend, self._wire(plane), dst,
                                          tag=tag))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return recv

    def all_blocks(self, grid):
        """Every block of `grid`, row-major, on every process: one
        ``all_gather`` of each process's blocks (on the host if staged)."""
        local = torch.stack([self._wire(x) for x in self.flat(grid)])
        parts = [torch.empty_like(local)
                 for _ in range(dist.get_world_size())]
        dist.all_gather(parts, local)
        taken = [0] * len(parts)
        out = []
        for r in self.ranks.flat:
            out.append(parts[r][taken[r]])
            taken[r] += 1
        return out

    def gather(self, grid, axis: int, device):
        Dk = self.ranks.shape[1]
        blocks = self.all_blocks(grid)
        return super().gather([blocks[r:r + Dk]
                               for r in range(0, len(blocks), Dk)],
                              axis, device)

    def any(self, flags) -> bool:
        raise NotImplementedError("the plane scans do not run across "
                                  "processes")

    def carry(self, plane, device):
        raise NotImplementedError("the plane scans do not run across "
                                  "processes")


def sharded_sdf_multihost(binned: sh.ShardedBinned, device_mesh, verts):
    """Run the sharded pipeline over a mesh whose shards live in several
    processes (every process calls it with the same binning and vertices).
    Returns this process's blocks: the (Dj, Dk) grid of (ni, nj_l, nk_l)
    signed fields, None where another process owns the shard; pass it to
    :func:`fetch_global` and :func:`assemble_blocks` for the whole grid."""
    cfg = binned.config
    if cfg.far_field not in ("exact", "eikonal"):
        raise NotImplementedError(
            "sharded pipeline supports far_field='exact' and 'eikonal'")
    if torch.is_tensor(verts) and verts.requires_grad:
        raise ValueError("sharded_sdf_multihost computes no vertex "
                         "gradient: pass verts that do not require grad")
    sh.check_device_mesh(device_mesh)
    tr = (DistributedTransport(device_mesh)
          if sh.spans_processes(device_mesh)
          else sh.LocalTransport(device_mesh.devices))
    out, _ = sh.sharded_fields(binned, device_mesh, verts, tr)
    return out


def fetch_global(blocks, device_mesh) -> np.ndarray:
    """Every block of a sharded result on every process: the (Dj, Dk, ni,
    nj_l, nk_l) NumPy array (an ``all_gather`` when processes share the
    mesh)."""
    if sh.spans_processes(device_mesh):
        flat = DistributedTransport(device_mesh).all_blocks(blocks)
    else:
        flat = [b for row in blocks for b in row]
    Dj, Dk = device_mesh.devices.shape
    out = np.empty((Dj * Dk, *flat[0].shape), np.float32)
    for b, o in zip(flat, out):
        to_host(b, out=o)
    return out.reshape(Dj, Dk, *flat[0].shape)


def assemble_blocks(blocks: np.ndarray) -> np.ndarray:
    """(Dj, Dk, ni, nj_l, nk_l) -> (ni, nj, nk)."""
    Dj, Dk, ni, nj_l, nk_l = blocks.shape
    return np.transpose(blocks, (2, 0, 3, 1, 4)).reshape(
        ni, Dj * nj_l, Dk * nk_l)
