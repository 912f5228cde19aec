from lakesoul_tpu_torch.utils.spark_hash import HASH_SEED, hash_columns, hash_scalar, bucket_ids

__all__ = ["HASH_SEED", "hash_columns", "hash_scalar", "bucket_ids"]
