"""HuggingFace datasets adapter, a copy of ``lakesoul_tpu/data/hf_adapter.py``
(parity with
python/src/lakesoul/huggingface/from_lakesoul.py:17-39)."""

from __future__ import annotations


def _generate_rows(units: list[dict]):
    """Module-level generator so `datasets` can pickle/fingerprint it; the
    scan plan is passed as plain picklable kwargs, not live catalog objects."""
    from lakesoul_tpu_torch.io.reader import read_scan_unit

    for u in units:
        # no mutation: datasets re-invokes the generator every epoch with the
        # same gen_kwargs dicts
        kwargs = {k: v for k, v in u.items() if k not in ("data_files", "primary_keys")}
        table = read_scan_unit(u["data_files"], u["primary_keys"], **kwargs)
        yield from table.to_pylist()


def to_hf_dataset(scan, streaming: bool = True):
    """Expose a LakeSoulScan as a datasets.IterableDataset (streaming) or an
    in-memory datasets.Dataset."""
    try:
        import datasets
    except ImportError as e:  # pragma: no cover
        raise ImportError("the 'datasets' package is required for to_huggingface()") from e

    if streaming:
        units = [
            {"data_files": u.data_files, "primary_keys": u.primary_keys, **scan._unit_kwargs(u)}
            for u in scan.scan_plan()
        ]
        return datasets.IterableDataset.from_generator(
            _generate_rows, gen_kwargs={"units": units}
        )
    return datasets.Dataset.from_list(scan.to_arrow().to_pylist())
