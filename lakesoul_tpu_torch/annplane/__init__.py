"""Sharded ANN plane (the port of ``lakesoul_tpu/annplane/``): memory-bounded
multi-shard build (from any vector stream, or from a table's column),
ragged query batching into the ``ragged_score`` CUDA kernel (the host path
on the CPU), a micro-batching endpoint with per-request ``nprobe``, and its binding to
the Flight gateway's ``ann_search`` action."""

from lakesoul_tpu_torch.annplane.build import (
    ShardedAnnBuilder,
    build_table_ann_plane,
    iter_table_vectors,
)
from lakesoul_tpu_torch.annplane.config import AnnPlaneConfig
from lakesoul_tpu_torch.annplane.manifest import PlaneManifestStore
from lakesoul_tpu_torch.annplane.search import AnnPlane
from lakesoul_tpu_torch.annplane.serving import AnnPlaneBinding, ShardedAnnEndpoint

__all__ = [
    "AnnPlane",
    "AnnPlaneBinding",
    "AnnPlaneConfig",
    "PlaneManifestStore",
    "ShardedAnnBuilder",
    "ShardedAnnEndpoint",
    "build_table_ann_plane",
    "iter_table_vectors",
]
