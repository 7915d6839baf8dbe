"""sdfgenfast_tpu_torch — the PyTorch + CUDA port of ``sdfgenfast_tpu``.

The mesh -> signed-distance-field generator: the default ``SDFConfig()``
path, both halves (the dense path, meshes with at most 1024 triangles,
kernel K1; the binned exact path, larger meshes, kernels K2, K3 and K4),
the flat and capped jump-flood ladders, any band tile shape, the
``"propagate"`` and ``"eikonal"`` far fields (R1 from the closest-triangle
ids), and both sign modes (``sign_mode="host"``, the x-ray parity computed
on the host; ``"device"``, its float64 predicates in torch on the device,
``ops/sign.py``). The kernels are hand-written in CUDA for Hopper (``csrc/*.cu``,
built on first use by ``kernels/build.py``), each with a plain-torch twin
that runs on CPU tensors. The JAX package ``sdfgenfast_tpu`` is the
reference it is tested against; this package imports neither it nor JAX.

Public surface, as the reference's ``sdfgen`` package: ``load_mesh,
generate_sdf, save_sdf, load_sdf, is_gpu_available, generate_from_mesh,
generate_from_file``, plus ``generate_sdf_batch``, the differentiable
pipeline (``pipeline.make_level_set3(..., verts=...)``, vertex gradients
through the recompute kernels R1/R1b), the trainable generator
``models.SDFGenerator``, the sharded pipeline over a (j, k) mesh of
devices (``parallel``: ``make_device_mesh``, ``bin_mesh_sharded``,
``sharded_sdf``; ``generate_sdf_batch(device_mesh=...)`` and
``SDFGenerator(device_mesh=...)``) and the CLI (``python -m sdfgenfast_tpu_torch.cli``,
the ``sdfgen-torch`` script). ``tools.micro_bench`` probes the card's
ceilings (kernels P1-P4); ``tools.bench``, ``tools.profile_stages`` (the
stages of one call, from its spans), ``tools.batch_bench``,
``tools.stress_256``, ``tools.kernel_bench`` and ``tools.scaling_bench``
are the counterparts of ``bench.py`` and the JAX package's tools.
"""

__version__ = "0.1.0"

from .api import (  # noqa: F401
    generate_from_file,
    generate_sdf_batch,
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
    "generate_sdf_batch",
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
