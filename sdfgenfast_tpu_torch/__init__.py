"""sdfgenfast_tpu_torch — the PyTorch + CUDA port of ``sdfgenfast_tpu``.

The binned exact path of the mesh -> signed-distance-field generator
(meshes above the dense-path cap, default ``SDFConfig()``), with its three
device kernels hand-written in CUDA for Hopper (``csrc/*.cu``, built on first
use by ``kernels/build.py``) and plain-torch twins that run on CPU tensors.
The JAX package ``sdfgenfast_tpu`` is the reference it is tested against;
this package imports neither it nor JAX.

Public surface, as the reference's ``sdfgen`` package: ``load_mesh,
generate_sdf, save_sdf, load_sdf, is_gpu_available, generate_from_mesh,
generate_from_file``, plus ``pipeline.make_level_set3``.
"""

__version__ = "0.1.0"

from .api import (  # noqa: F401
    generate_from_file,
    generate_from_mesh,
    generate_sdf,
    is_gpu_available,
    load_mesh,
    load_sdf,
    save_sdf,
)
from .grid import GridSpec  # noqa: F401
from .mesh import Mesh, box_mesh, icosphere, torus_mesh  # noqa: F401
from .pipeline import SDFConfig, bin_mesh, make_level_set3  # noqa: F401
from .platform import require_cuda  # noqa: F401

__all__ = [
    "load_mesh",
    "generate_sdf",
    "save_sdf",
    "load_sdf",
    "is_gpu_available",
    "generate_from_mesh",
    "generate_from_file",
    "GridSpec",
    "Mesh",
    "box_mesh",
    "icosphere",
    "torus_mesh",
    "SDFConfig",
    "bin_mesh",
    "make_level_set3",
    "require_cuda",
]
