"""The batch-source seam: ONE place adapters get their Arrow batches.

Every delivery adapter (``to_torch_iter``, ``to_torch``) used to
call ``scan.to_batches()`` directly, which hard-wired them to in-process
decode.  The seam splits "which batches" (the scan) from "who produces
them" (this process, or a scan-plane fleet): a scan carries an optional
source FACTORY (set by :meth:`LakeSoulScan.via_scanplane`), and
:func:`batch_source_for` resolves it to an object with one method —

    ``iter_batches(*, num_threads=None, skip_rows=0) -> Iterator[RecordBatch]``

with ``to_batches``-identical semantics (limit applied, deterministic
order, generators close cleanly on abandonment).  Local scans resolve to
:class:`ScanBatchSource` (a thin ``to_batches`` wrapper).  The remote
scans (``scan.via_scanplane(...)``) resolve to
:class:`lakesoul_tpu_torch.scanplane.client.RemoteBatchSource`.  The
continuous source (``follow=``, the freshness follower) is not ported yet: a
``follow`` raises :class:`ConfigError`.
"""

from __future__ import annotations


class ScanBatchSource:
    """In-process batch source: the scan's own ``to_batches``."""

    remote = False

    def __init__(self, scan):
        self._scan = scan

    def iter_batches(self, *, num_threads=None, skip_rows: int = 0):
        return self._scan.to_batches(num_threads=num_threads, skip_rows=skip_rows)


def batch_source_for(scan, follow=None):
    """Resolve a scan to its batch source.

    ``follow`` (a continuous source over the table's commit log) is not
    ported yet and raises.  Otherwise the remote factory
    (``via_scanplane``) wins, then in-process decode."""
    if follow is not None and follow is not False:
        from lakesoul_tpu_torch.errors import ConfigError

        raise ConfigError("follow (the freshness layer) is not ported yet")
    factory = getattr(scan, "_batch_source_factory", None)
    if factory is not None:
        return factory(scan)
    return ScanBatchSource(scan)
