from lakesoul_tpu_torch.data.torch_iter import LoaderCheckpoint, TorchBatchIterator, to_torch_iter

__all__ = ["LoaderCheckpoint", "TorchBatchIterator", "to_torch_iter"]
