"""Vector index configuration (the port's copy of
``lakesoul_tpu/vector/config.py``).

String format compatible with the reference's
``VectorIndexConfig::parse_multiple`` (rust/lakesoul-vector/src/config.rs:68):
``col:dim:nlist:total_bits:metric:rotator:seed:faster`` with trailing fields
optional, multiple configs separated by ``;``.
"""

from __future__ import annotations

from dataclasses import dataclass

from lakesoul_tpu_torch.errors import VectorIndexError

METRICS = {"l2", "ip"}
ROTATORS = {"fht", "matrix", "identity"}


@dataclass(frozen=True)
class VectorIndexConfig:
    column: str
    dim: int
    nlist: int = 16
    total_bits: int = 1
    metric: str = "l2"
    rotator: str = "fht"
    seed: int = 42
    faster: bool = False

    def __post_init__(self):
        if self.dim <= 0:
            raise VectorIndexError(f"invalid dim {self.dim}")
        if self.nlist <= 0:
            raise VectorIndexError(f"invalid nlist {self.nlist}")
        if not 1 <= self.total_bits <= 16:
            raise VectorIndexError(f"total_bits must be in [1,16], got {self.total_bits}")
        if self.metric not in METRICS:
            raise VectorIndexError(f"unknown metric {self.metric}")
        if self.rotator not in ROTATORS:
            raise VectorIndexError(f"unknown rotator {self.rotator}")

    @classmethod
    def parse(cls, s: str) -> "VectorIndexConfig":
        parts = s.strip().split(":")
        if len(parts) < 2:
            raise VectorIndexError(f"invalid vector index config {s!r}")
        kwargs = {"column": parts[0], "dim": int(parts[1])}
        if len(parts) > 2:
            kwargs["nlist"] = int(parts[2])
        if len(parts) > 3:
            kwargs["total_bits"] = int(parts[3])
        if len(parts) > 4:
            kwargs["metric"] = parts[4]
        if len(parts) > 5:
            kwargs["rotator"] = parts[5]
        if len(parts) > 6:
            kwargs["seed"] = int(parts[6])
        if len(parts) > 7:
            kwargs["faster"] = parts[7].lower() in ("1", "true")
        return cls(**kwargs)

    @classmethod
    def parse_multiple(cls, s: str) -> list["VectorIndexConfig"]:
        return [cls.parse(p) for p in s.split(";") if p.strip()]

    def encode(self) -> str:
        return (
            f"{self.column}:{self.dim}:{self.nlist}:{self.total_bits}:"
            f"{self.metric}:{self.rotator}:{self.seed}:{str(self.faster).lower()}"
        )
