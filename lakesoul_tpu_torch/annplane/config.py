"""ANN-plane configuration: memory-bounded shard sizing (the port's copy of
``lakesoul_tpu/annplane/config.py``; ``digest()`` equals the reference's
for the same config, so a plane built by one package resumes in the other).

A plane is a sequence of IVF-RaBitQ shards over one vector stream; each
shard is sized so the BUILD of that shard (streamed raw buffer + quantized
arrays + the index's raw copy) fits ``shard_budget_bytes`` — the builder
never holds more than one shard's working set, so a 10M x 128d corpus
builds inside a laptop-sized RSS.  Shard row ranges derive from the budget,
which makes them part of the plane's identity: the config digest covers the
index config, raw retention, and the derived rows-per-shard, so a restarted
builder either resumes shard-exact or (on any mismatch) rebuilds from row 0
under a bumped generation."""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field

from lakesoul_tpu_torch.errors import VectorIndexError
from lakesoul_tpu_torch.vector.config import VectorIndexConfig
from lakesoul_tpu_torch.vector.rabitq import next_pow2

ENV_SHARD_BUDGET = "LAKESOUL_ANN_SHARD_BUDGET_BYTES"
DEFAULT_SHARD_BUDGET = 512 << 20


def _env_budget() -> int:
    raw = os.environ.get(ENV_SHARD_BUDGET)
    if raw is None:
        return DEFAULT_SHARD_BUDGET
    try:
        v = int(raw)
    except ValueError:
        raise VectorIndexError(f"{ENV_SHARD_BUDGET} must be an integer, got {raw!r}")
    if v <= 0:
        raise VectorIndexError(f"{ENV_SHARD_BUDGET} must be positive, got {v}")
    return v


@dataclass(frozen=True)
class AnnPlaneConfig:
    """One plane's build/search contract.

    ``shard_budget_bytes`` None resolves from ``LAKESOUL_ANN_SHARD_BUDGET_BYTES``
    (default 512 MiB) at construction time, so the frozen instance — and its
    digest — never depends on later environment changes."""

    index: VectorIndexConfig
    shard_budget_bytes: int | None = None
    keep_raw: bool = True
    train_sample_rows: int = 200_000
    kmeans_iters: int = 10
    # resolved at __post_init__; field so dataclass repr/eq include it
    _budget: int = field(default=0, repr=False)

    def __post_init__(self):
        budget = (
            _env_budget() if self.shard_budget_bytes is None
            else int(self.shard_budget_bytes)
        )
        if budget <= 0:
            raise VectorIndexError(f"shard budget must be positive, got {budget}")
        object.__setattr__(self, "_budget", budget)
        if budget < self.bytes_per_vector():
            raise VectorIndexError(
                f"shard budget {budget} bytes cannot hold even one"
                f" {self.index.dim}-d vector ({self.bytes_per_vector()} B/row)"
            )

    @property
    def budget_bytes(self) -> int:
        return self._budget

    def padded_dim(self) -> int:
        return (
            next_pow2(self.index.dim) if self.index.rotator == "fht" else self.index.dim
        )

    def bytes_per_vector(self) -> int:
        """Build-time working-set bytes per row: the streamed f32 buffer, the
        quantized arrays, per-row scalars + id, and (when kept) the index's
        raw copy — what one shard actually costs while it is being built."""
        d, dpad = self.index.dim, self.padded_dim()
        buffered_raw = d * 4
        if self.index.total_bits == 1:
            codes = dpad // 8
            scalars = 3 * 4  # norms, factors, code_dot_c
        else:
            codes = dpad * (1 if self.index.total_bits <= 8 else 2)
            scalars = 4 * 4  # + scales
        indexed_raw = d * 4 if self.keep_raw else 0
        return buffered_raw + codes + scalars + 8 + indexed_raw

    def rows_per_shard(self) -> int:
        return max(1, self._budget // self.bytes_per_vector())

    def digest(self) -> str:
        """Identity of the plane layout: anything that changes shard contents
        or row ranges changes the digest (and forces a fresh generation)."""
        key = "|".join(
            [
                self.index.encode(),
                str(self.keep_raw),
                str(self.rows_per_shard()),
                str(self.train_sample_rows),
                str(self.kmeans_iters),
            ]
        )
        return hashlib.sha256(key.encode()).hexdigest()[:16]
