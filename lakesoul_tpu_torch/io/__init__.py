from lakesoul_tpu_torch.io.config import IOConfig
from lakesoul_tpu_torch.io.filters import Filter, col
from lakesoul_tpu_torch.io.formats import PhysicalFormat, format_by_name, format_for, register_format
from lakesoul_tpu_torch.io.page_cache import DiskPageCache
from lakesoul_tpu_torch.io.reader import iter_scan_unit_batches, read_scan_unit
from lakesoul_tpu_torch.io.streaming_merge import iter_merged_windows
from lakesoul_tpu_torch.io.writer import FlushOutput, TableWriter

__all__ = [
    "IOConfig",
    "TableWriter",
    "FlushOutput",
    "read_scan_unit",
    "iter_scan_unit_batches",
    "iter_merged_windows",
    "Filter",
    "col",
    "PhysicalFormat",
    "format_for",
    "format_by_name",
    "register_format",
    "DiskPageCache",
]
