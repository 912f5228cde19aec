"""Sharded ANN plane (the port of ``lakesoul_tpu/annplane/``): memory-bounded
multi-shard build, ragged query batching into the ``ragged_score`` CUDA
kernel, and a micro-batching endpoint with per-request ``nprobe``."""

from lakesoul_tpu_torch.annplane.build import ShardedAnnBuilder
from lakesoul_tpu_torch.annplane.config import AnnPlaneConfig
from lakesoul_tpu_torch.annplane.manifest import PlaneManifestStore
from lakesoul_tpu_torch.annplane.search import AnnPlane
from lakesoul_tpu_torch.annplane.serving import ShardedAnnEndpoint

__all__ = [
    "AnnPlane",
    "AnnPlaneConfig",
    "PlaneManifestStore",
    "ShardedAnnBuilder",
    "ShardedAnnEndpoint",
]
