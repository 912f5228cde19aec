"""The parallel layer, the port of ``lakesoul_tpu/parallel/``: the
(dp, tp, sp, pp, ep) mesh over ``torch.distributed`` (``mesh``), the
differentiable collectives ``shard_map`` gave the reference
(``collectives``), ring and Ulysses attention, the GPipe pipeline and the
expert-parallel MoE FFN.  The reference's ``_compat.py`` is a jax shim with
nothing to carry over.  ``launch.run_ranks`` runs a function on gloo CPU
ranks, as the tests and ``entry.dryrun_multichip`` do.

No Pallas kernel lies here in the reference (its block products are jnp
ops), so the port computes with torch ops and collectives: no hand kernel.
"""

from lakesoul_tpu_torch.parallel.mesh import MeshPlan, make_mesh
from lakesoul_tpu_torch.parallel.ring_attention import make_ring_attention, ring_attention
from lakesoul_tpu_torch.parallel.ulysses import make_ulysses_attention, ulysses_attention

__all__ = [
    "MeshPlan",
    "make_mesh",
    "make_ring_attention",
    "ring_attention",
    "make_ulysses_attention",
    "ulysses_attention",
]
