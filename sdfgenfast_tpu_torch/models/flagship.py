"""Flagship model: the differentiable mesh -> SDF generator as a trainable
step.

Counterpart of ``sdfgenfast_tpu/models/flagship.py``: parameters are the
vertex positions (a float32 ``torch.Tensor`` on an explicit device), the
forward is the SDF grid (``pipeline.make_level_set3(..., verts=...)``, whose
gradient comes from the recompute kernels R1/R1b), and a training step is
gradient descent on an SDF-space loss. The binning is static state, redone
by :meth:`SDFGenerator.refresh` when the vertices move across cells: it
uploads the binning and the vertices as one blob (``upload.py``), so a
training step uploads nothing until the next :meth:`SDFGenerator.commit`.
With ``far_field="eikonal"`` the gradient flows through the seeded band only
(the far field is an estimate that carries none).
With a ``device_mesh`` (``parallel.make_device_mesh``; every
``far_field`` mode) the forward is ``parallel.sharded_sdf``: each shard
evaluates its block from ``verts.to(its device)``, and autograd sums the
shards' vertex gradients. The shards must live in this process: the
multi-process path computes no gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..grid import GridSpec
from ..mesh import Mesh
from ..parallel.sharded import (DeviceMesh, ShardedBinned, bin_mesh_sharded,
                                check_device_mesh, sharded_sdf,
                                spans_processes)
from ..pipeline import Binned, SDFConfig, bin_mesh, make_level_set3
from ..upload import pack_device_blob, to_host

__all__ = ["SDFGenerator", "sgd_step"]


@dataclasses.dataclass
class SDFGenerator:
    """verts are the trainable parameters; topology and binning are static
    state on the host. `device` is where the grid is computed; with a
    `device_mesh` the grid is sharded over its devices and `device`
    (default: the mesh's first device, where the grid is assembled) holds
    the parameters."""

    mesh: Mesh
    grid: GridSpec
    config: SDFConfig = dataclasses.field(default_factory=SDFConfig)
    device: Optional[Union[str, torch.device]] = dataclasses.field(
        default=None, kw_only=True)
    device_mesh: Optional[DeviceMesh] = None
    binned: Optional[Binned] = None
    sharded_binned: Optional[ShardedBinned] = None

    def __post_init__(self):
        if self.device_mesh is not None:
            check_device_mesh(self.device_mesh)
            if spans_processes(self.device_mesh):
                raise ValueError("SDFGenerator's device_mesh must be one "
                                 "process's (parallel.make_device_mesh): the "
                                 "multi-process path computes no gradient")
            if self.device is None:
                self.device = self.device_mesh.devices[0, 0]
        elif self.device is None:
            raise TypeError("SDFGenerator needs a device (or a device_mesh)")
        self.device = torch.device(self.device)
        if self.binned is None and self.sharded_binned is None:
            self.refresh()

    def refresh(self):
        if self.device_mesh is not None:
            self.sharded_binned = bin_mesh_sharded(
                self.mesh, self.grid, self.device_mesh.devices.shape,
                self.config)
        else:
            self.binned = bin_mesh(self.mesh, self.grid, self.config,
                                   device=self.device)

    @property
    def params(self) -> torch.Tensor:
        """The vertices on `device`, a fresh tensor (one upload)."""
        return pack_device_blob({"verts": self.mesh.verts},
                                self.device).arrays["verts"]

    def forward(self, verts: torch.Tensor) -> torch.Tensor:
        """SDF grid from vertex positions (differentiable)."""
        if self.device_mesh is not None:
            return sharded_sdf(self.sharded_binned, self.device_mesh,
                               verts=verts)
        return make_level_set3(self.mesh, self.grid, self.config,
                               binned=self.binned, device=self.device,
                               verts=verts)

    def loss(self, verts: torch.Tensor, target_phi: torch.Tensor
             ) -> torch.Tensor:
        """Mean squared SDF mismatch, the canonical grid-space objective."""
        phi = self.forward(verts)
        return torch.mean((phi - target_phi) ** 2)

    def train_step(self, verts, target_phi, lr=1e-2):
        """One SGD step on vertex positions: (new verts, loss)."""
        return sgd_step(self, verts, target_phi, lr)

    def commit(self, verts: torch.Tensor):
        """Adopt new vertex positions and rebin."""
        self.mesh = Mesh(to_host(verts), self.mesh.tris)
        self.refresh()


def sgd_step(model: SDFGenerator, verts, target_phi, lr):
    verts = verts.detach().requires_grad_(True)
    loss = model.loss(verts, target_phi)
    (grad,) = torch.autograd.grad(loss, verts)
    return (verts - float(np.float32(lr)) * grad).detach(), loss.detach()
