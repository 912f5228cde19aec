from lakesoul_tpu_torch.vector.config import VectorIndexConfig
from lakesoul_tpu_torch.vector.index import IvfRabitqIndex, SearchParams
from lakesoul_tpu_torch.vector.serving import AnnEndpoint

__all__ = ["VectorIndexConfig", "IvfRabitqIndex", "SearchParams", "AnnEndpoint"]
