"""Sharded execution of the kernel tier over a device mesh (one
controller, owner-computes row partition)."""

from .mesh import Mesh, all_gather, local_mesh, make_mesh, psum
from .mxu_shard import (
    ShardedMXU,
    build_sharded_mxu,
    build_sharded_template,
    sharded_mxu_spmm,
    sharded_template_dual_apply,
)
from .sharded import (
    replicate,
    shard_dual,
    shard_magnet_laplacian,
    shard_propagator,
)

__all__ = ["Mesh", "ShardedMXU", "all_gather", "build_sharded_mxu",
           "build_sharded_template", "local_mesh", "make_mesh", "psum",
           "replicate", "shard_dual", "shard_magnet_laplacian",
           "shard_propagator", "sharded_mxu_spmm",
           "sharded_template_dual_apply"]
