"""The least time ``ls_ragged_score`` needs for the batches a window ran.

A copy of ``chip_smoke.py``'s ``ragged_bound`` (``:806``), amended in two
ways.  The probe set is worked out here, by plain code, from the plane's
centroids (read as data) and the window's queries, not taken from the
program's item tables.  And the codes are counted at the configuration's
bits a dimension, ``d · bits / 8`` bytes a row, plus two float32 factors a
row (the estimator's ``a`` and ``b``), not at the program's float32 resident
layout: a program that packs its layout cannot read above its roofline.

For one shard and one batch, each input byte is read once and each output
byte written once:

- every row of every cluster that some query probes: codes and factors;
- each query that probes the shard: its rotated row, float32;
- each probed (query, cluster) pair: query, cluster and csq, 12 bytes;
- each probed (query, row): one float32 score written;

and 2·d FLOP a probed (query, row).  The bound is the larger of bytes over
the card's bandwidth and FLOP over its float32 rate.
"""

from __future__ import annotations

import numpy as np

PAIR_BYTES = 12
FACTOR_BYTES = 8


def shard_bound(probed_clusters: np.ndarray, rows: np.ndarray, n_queries: int, *, dim: int,
                bits: int) -> tuple[float, float]:
    """(bytes, FLOP) of one shard's scoring of one batch.

    ``probed_clusters`` [pairs] are the local cluster ids of the shard's
    probed (query, cluster) pairs, ``rows`` [nlist] the shard's rows a
    cluster, ``n_queries`` the queries with at least one pair here."""
    probed_clusters = np.asarray(probed_clusters, np.int64)
    rows = np.asarray(rows, np.int64)
    distinct = np.unique(probed_clusters)
    scored = float(rows[probed_clusters].sum())
    n_bytes = (float(rows[distinct].sum()) * (dim * bits / 8 + FACTOR_BYTES)
               + n_queries * dim * 4.0 + len(probed_clusters) * PAIR_BYTES + scored * 4.0)
    return n_bytes, scored * 2.0 * dim


def bound_seconds(n_bytes: float, flops: float, peaks: dict) -> float:
    return max(n_bytes / float(peaks["hbm_bytes_s"]), flops / float(peaks["f32_flop_s"]))
