"""Sharded execution over a device mesh (owner-computes row partition):
one controller running every shard, or one process a group of shards
(parallel/distributed.py)."""

from .attn_shard import (
    ShardedAttnGraph,
    shard_attention_graph,
    shard_attention_graphs,
    sharded_attention_apply,
)
from .distributed import init_process_mesh
from .edge_spmm import PartitionedCOO, partition_coo, place, sharded_spmm
from .mesh import Mesh, all_gather, local_mesh, make_mesh, psum, shard_input
from .mxu_shard import (
    ShardedMXU,
    build_sharded_mxu,
    build_sharded_template,
    sharded_mxu_spmm,
    sharded_template_dual_apply,
)
from .sharded import (
    ShardedBSR,
    ShardedDense,
    ShardedSegment,
    replicate,
    shard_dual,
    shard_magnet_laplacian,
    shard_propagator,
)

__all__ = [
    # the JAX package's names
    "ShardedAttnGraph", "shard_attention_graph", "shard_attention_graphs",
    "sharded_attention_apply", "ShardedMXU", "build_sharded_mxu",
    "sharded_mxu_spmm", "make_mesh", "local_mesh", "replicate",
    "shard_dual", "shard_propagator", "shard_magnet_laplacian",
    "PartitionedCOO", "partition_coo", "place", "sharded_spmm",
    # the port's own
    "Mesh", "ShardedBSR", "ShardedDense", "ShardedSegment", "all_gather",
    "build_sharded_template", "init_process_mesh", "psum", "shard_input",
    "sharded_template_dual_apply",
]
