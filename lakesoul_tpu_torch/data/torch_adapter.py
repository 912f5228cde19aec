"""PyTorch adapter (parity with python/src/lakesoul/torch/dataset.py:15).

Batches come through the batch-source seam
(:mod:`lakesoul_tpu_torch.data.batch_source`), so a scan bound to a scan-plane
fleet would stream remotely with the same iterator contract (the scan
plane is not ported yet)."""

from __future__ import annotations


def _require_torch():
    try:
        import torch.utils.data as tud
    except ImportError as e:  # pragma: no cover
        raise ImportError("torch is required for to_torch()") from e
    return tud


class TorchIterableDataset:
    """Lazy torch IterableDataset over a LakeSoulScan, yielding Arrow record
    batches (same contract as the reference's Dataset)."""

    def __new__(cls, scan):
        tud = _require_torch()

        class _DS(tud.IterableDataset):
            def __init__(self, scan):
                self._scan = scan

            def __iter__(self):
                from lakesoul_tpu_torch.data.batch_source import batch_source_for

                yield from batch_source_for(self._scan).iter_batches()

        return _DS(scan)
