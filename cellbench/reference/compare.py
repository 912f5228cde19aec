"""The numbers that decide ``correct``: each a gap between what the program
produced and what the plain reference works out, read one way for every
run, so a limit set from one set of runs holds for the next."""

from __future__ import annotations

import statistics

# a leaf whose reference gradient is under this share of the median leaf's
# is moved by round-off alone under Adam; its change is not compared
STILL_LEAF = 1e-3


def loss_gap(prog: list, ref: list) -> float:
    """The widest relative gap of a step's loss."""
    if len(prog) != len(ref):
        raise ValueError(f"{len(prog)} program losses against {len(ref)} reference losses")
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def moved_leaves(ref_grad_norms: dict) -> set:
    med = statistics.median(ref_grad_norms.values())
    return {k for k, g in ref_grad_norms.items() if g >= STILL_LEAF * med}


def worst_leaf_gap(prog: dict, ref: dict, leaves=None) -> tuple[float, str]:
    """The gap between the program's norm of a leaf and the reference's,
    over the reference's norm of that leaf or of the median leaf, whichever
    is larger, at the worst leaf: (gap, leaf)."""
    leaves = sorted(ref if leaves is None else leaves)
    if set(prog) != set(ref):
        raise ValueError(f"leaves differ: {sorted(set(prog) ^ set(ref))[:5]}")
    med = statistics.median(ref[k] for k in leaves)
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst
