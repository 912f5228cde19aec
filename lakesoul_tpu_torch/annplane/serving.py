"""Fleet-scale ANN serving over a sharded plane (the port of
``lakesoul_tpu/annplane/serving.py``).

Same micro-batching discipline as the single-index ``AnnEndpoint`` (collect
concurrent requests for up to ``max_wait_ms``, run ONE fused dispatch, fan
results out), but the dispatch is the ragged multi-shard search: requests in
one window may carry different ``nprobe`` values and still ride one scoring
pass per shard.  The pending queue is bounded (``LAKESOUL_ANN_MAX_PENDING``
when the constructor does not say); beyond it ``submit`` raises a typed
``OverloadedError``.  Latency lands in the same
``lakesoul_ann_request_seconds`` histogram, so ``stats()`` has the same
keys as the single-index endpoint."""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from lakesoul_tpu_torch.errors import VectorIndexError
from lakesoul_tpu_torch.vector.index import SearchParams
from lakesoul_tpu_torch.vector.serving import AnnEndpoint

ENV_MAX_PENDING = "LAKESOUL_ANN_MAX_PENDING"


def _env_max_pending() -> int | None:
    raw = os.environ.get(ENV_MAX_PENDING)
    if raw is None:
        return None
    try:
        v = int(raw)
    except ValueError:
        raise VectorIndexError(f"{ENV_MAX_PENDING} must be an integer, got {raw!r}")
    if v < 1:
        raise VectorIndexError(f"{ENV_MAX_PENDING} must be >= 1, got {v}")
    return v


class ShardedAnnEndpoint(AnnEndpoint):
    """Micro-batching front end over an :class:`AnnPlane`."""

    def __init__(
        self,
        plane,
        params: SearchParams | None = None,
        *,
        max_batch: int = 256,
        max_wait_ms: float = 2.0,
        max_pending: int | None = None,
        name: str = "default",
    ):
        if max_pending is None:
            max_pending = _env_max_pending()
        self.plane = plane
        super().__init__(
            plane, params,
            max_batch=max_batch, max_wait_ms=max_wait_ms,
            max_pending=max_pending, name=name,
        )

    def submit(self, query: np.ndarray, *, nprobe: int | None = None):
        """Enqueue one query; ``nprobe`` overrides the endpoint default for
        THIS request only — mixed probe depths fuse into the same ragged
        dispatch.  Raises ``OverloadedError`` past the pending bound."""
        if nprobe is not None and nprobe < 1:
            raise ValueError(f"nprobe must be >= 1, got {nprobe}")
        return self._submit(query, nprobe)

    def search(self, query: np.ndarray, timeout: float | None = None,
               *, nprobe: int | None = None):
        return self.submit(query, nprobe=nprobe).result(timeout)

    def _execute(self, queries, extras):
        nprobes = np.array(
            [self.params.nprobe if e is None else int(e) for e in extras], np.int64
        )
        return self.plane.batch_search(np.stack(queries), self.params, nprobes=nprobes)


@dataclass(frozen=True)
class AnnPlaneBinding:
    """A served plane's registration with the Flight gateway: requests pass
    the gateway's JWT auth, then RBAC-check against the TABLE the plane
    indexes — the plane inherits exactly the table's access story."""

    endpoint: ShardedAnnEndpoint
    namespace: str
    table: str
