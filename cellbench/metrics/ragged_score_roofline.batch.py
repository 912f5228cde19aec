"""``ragged_score_roofline.batch``: the least time ``ls_ragged_score``
needs for the window's batches (``counts/ragged_bound.py``, the probe
worked out here from the plane's centroids and the window's queries) over
its device time in the trace, in percent."""

import json
from pathlib import Path

import numpy as np
import torch

from counts.ragged_bound import bound_seconds, shard_bound

PEAKS = json.loads((Path(__file__).resolve().parent.parent / "counts" / "peaks.json").read_text())
KERNEL = "ragged_score"


def probe(q64, cent64, cent_sq, nprobes):
    """Each query's ``nprobe`` nearest global clusters, float64: → (query,
    global cluster) pairs on the host."""
    cd = cent_sq[None, :] - 2.0 * q64 @ cent64.T
    sel = torch.topk(cd, int(nprobes.max()), dim=1, largest=False).indices.cpu().numpy()
    keep = np.arange(sel.shape[1])[None, :] < nprobes[:, None]
    return np.repeat(np.arange(len(sel)), keep.sum(1)), sel[keep]


def read(run):
    trace, c = run.get("trace"), run["counters"]
    if not trace or "window_queries" not in c:
        return None
    kernel_s = sum(v for k, v in trace["kernel_s"].items() if KERNEL in k)
    if kernel_s <= 0:
        return None
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    cents = c["plane"]["centroids"]
    rows = c["plane"]["row_counts"]
    cent64 = torch.as_tensor(np.concatenate(cents), device=dev).double()
    cent_sq = (cent64 * cent64).sum(1)
    shard_of = np.concatenate([np.full(len(x), i) for i, x in enumerate(cents)])
    local = np.concatenate([np.arange(len(x)) for x in cents])
    bound = 0.0
    for queries, nprobes in zip(c["window_queries"], c["window_nprobes"]):
        pq, pgc = probe(torch.as_tensor(queries, device=dev).double(), cent64, cent_sq,
                        np.asarray(nprobes))
        for si in range(len(cents)):
            m = shard_of[pgc] == si
            if m.any():
                n_bytes, flops = shard_bound(local[pgc[m]], rows[si], len(np.unique(pq[m])),
                                             dim=c["dim"], bits=c["bits"])
                bound += bound_seconds(n_bytes, flops, PEAKS)
    return 100.0 * bound / kernel_s
