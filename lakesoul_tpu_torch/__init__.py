"""lakesoul_tpu_torch — the PyTorch / CUDA port of lakesoul_tpu.

A package of its own beside ``lakesoul_tpu``: it imports ``torch``, ``numpy``
and the standard library, never ``jax`` and nothing of ``lakesoul_tpu``
(the modules it needs from there are kept as its own copies).  The layout
mirrors the JAX package, so ``lakesoul_tpu_torch/vector/index.py`` is the
counterpart of ``lakesoul_tpu/vector/index.py``.

Ported so far: the single-index IVF-RaBitQ ANN serving path
(:mod:`lakesoul_tpu_torch.vector`) and the sharded ANN plane
(:mod:`lakesoul_tpu_torch.annplane`), with every kernel the JAX package
wrote in Pallas as a CUDA kernel written for Hopper (``csrc/``); and the
training side (:mod:`lakesoul_tpu_torch.models`): the MLP, ResNet-50 and
BERT MLM train steps on one device, a checkpointer and weight converters
to and from the JAX package's param trees; and the storage core and
loader: :class:`LakeSoulCatalog` / :class:`LakeSoulTable` /
:class:`LakeSoulScan` (catalog → metadata on SQLite → writer and
merge-on-read reader, parquet and LSF, with the native C++ merge and hash
core built by ``g++`` at first use), and
``LakeSoulScan.to_torch_iter()``, which delivers fixed-size batches to the
card through pinned buffers and a side stream.  A table written by either
package opens and scans the same in the other.

Entry points take ``device=None`` to mean the CUDA card and raise when there
is none; the CPU is used only when a caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy: `import lakesoul_tpu_torch` does not load pyarrow or the catalog
    if name in ("LakeSoulCatalog", "LakeSoulTable", "LakeSoulScan"):
        from lakesoul_tpu_torch import catalog

        return getattr(catalog, name)
    raise AttributeError(name)


__all__ = ["LakeSoulCatalog", "LakeSoulTable", "LakeSoulScan", "__version__"]
