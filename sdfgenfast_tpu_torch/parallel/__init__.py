from .sharded import (  # noqa: F401
    DeviceMesh,
    ShardedBinned,
    bin_mesh_sharded,
    make_device_mesh,
    sharded_sdf,
)
