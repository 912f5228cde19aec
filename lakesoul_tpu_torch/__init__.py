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
to and from the JAX package's param trees.

Entry points take ``device=None`` to mean the CUDA card and raise when there
is none; the CPU is used only when a caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
