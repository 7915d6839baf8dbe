"""Flagship model: the differentiable mesh -> SDF generator as a trainable
step.

Counterpart of ``sdfgenfast_tpu/models/flagship.py``: parameters are the
vertex positions (a float32 ``torch.Tensor`` on an explicit device), the
forward is the SDF grid (``pipeline.make_level_set3(..., verts=...)``, whose
gradient comes from the recompute kernels R1/R1b), and a training step is
gradient descent on an SDF-space loss. The binning is static state, redone
by :meth:`SDFGenerator.refresh` when the vertices move across cells.
Multi-GPU (``device_mesh``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..grid import GridSpec
from ..mesh import Mesh
from ..pipeline import Binned, SDFConfig, bin_mesh, make_level_set3

__all__ = ["SDFGenerator", "sgd_step"]


@dataclasses.dataclass
class SDFGenerator:
    """verts are the trainable parameters; topology and binning are static
    state on the host. `device` is where the grid is computed."""

    mesh: Mesh
    grid: GridSpec
    config: SDFConfig = dataclasses.field(default_factory=SDFConfig)
    device: Union[str, torch.device] = dataclasses.field(kw_only=True)
    device_mesh: Optional[object] = None
    binned: Optional[Binned] = None

    def __post_init__(self):
        if self.device_mesh is not None:
            raise NotImplementedError(
                "device_mesh (multi-GPU sharding) is not ported yet")
        self.device = torch.device(self.device)
        if self.binned is None:
            self.refresh()

    def refresh(self):
        self.binned = bin_mesh(self.mesh, self.grid, self.config)

    @property
    def params(self) -> torch.Tensor:
        return torch.from_numpy(np.array(self.mesh.verts, np.float32)).to(
            self.device)

    def forward(self, verts: torch.Tensor) -> torch.Tensor:
        """SDF grid from vertex positions (differentiable)."""
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
        self.mesh = Mesh(verts.detach().cpu().numpy(), self.mesh.tris)
        self.refresh()


def sgd_step(model: SDFGenerator, verts, target_phi, lr):
    verts = verts.detach().requires_grad_(True)
    loss = model.loss(verts, target_phi)
    (grad,) = torch.autograd.grad(loss, verts)
    return (verts - float(np.float32(lr)) * grad).detach(), loss.detach()
