"""The benchmark's inputs, made from ``--seed``: the token table's documents
and their masking, BERT's weights, and the ANN corpus and queries.

Both sides read these, the program and the plain reference; neither makes
them.  The same seed gives the same inputs: numpy's PCG64 on the host, and
``torch.Generator`` on the card, each seeded from ``derive_seed`` so that
any part can be made again alone (a chunk of the corpus, one epoch's
masks) without making what comes before it.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one named part of the inputs of run ``seed`` (any
    whole number, however large)."""
    h = hashlib.blake2b(repr((int(seed),) + tags).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


# ------------------------------------------------------------ token table
def token_docs(seed: int, table: dict, vocab: int, seq: int):
    """The table's documents: ``rows`` documents of ``seq`` token ids drawn
    uniformly from [first_token_id, vocab), then one upsert wave that
    rewrites ``upsert_fraction`` of them with fresh draws.  Returns
    (base [rows, seq] int32, upsert_ids sorted int64, upsert_tokens)."""
    rng = np.random.Generator(np.random.PCG64(derive_seed(seed, "docs")))
    rows, lo = int(table["rows"]), int(table["first_token_id"])
    base = rng.integers(lo, vocab, (rows, seq), dtype=np.int32)
    n_up = int(rows * float(table["upsert_fraction"]))
    up_ids = np.sort(rng.choice(rows, n_up, replace=False)).astype(np.int64)
    up_tok = rng.integers(lo, vocab, (n_up, seq), dtype=np.int32)
    return base, up_ids, up_tok


def merged_docs(base, up_ids, up_tok):
    """What the table holds after the upsert: the last write of each key."""
    out = base.copy()
    out[up_ids] = up_tok
    return out


def _splitmix64(x: np.ndarray) -> np.ndarray:
    z = x + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def mask_positions(seed: int, epoch: int, doc_ids, seq: int, prob: float) -> np.ndarray:
    """Which positions of each document are masked in ``epoch``: a hash of
    (seed, epoch, doc_id, position), so a row's masks do not depend on the
    batch it rides in or on the order of the stream."""
    key = np.uint64(derive_seed(seed, "mask", int(epoch)))
    doc = np.asarray(doc_ids, np.int64).astype(np.uint64)
    x = doc[:, None] * np.uint64(seq) + np.arange(seq, dtype=np.uint64)[None, :]
    with np.errstate(over="ignore"):
        u = (_splitmix64(x ^ key) >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))
    return u < prob


def mlm_inputs(tokens, masked, mask_id: int):
    """``examples/bert_mlm_from_table.py``'s transform: masked positions are
    labelled with their token and replaced by [MASK]; labels -100 elsewhere;
    every position attends."""
    labels = np.where(masked, tokens, -100).astype(np.int32)
    ids = np.where(masked, mask_id, tokens).astype(np.int32)
    return ids, labels, np.ones(tokens.shape, dtype=bool)


# ---------------------------------------------------------------- weights
def bert_weights(seed: int, shapes: dict, init_std: float, device) -> dict:
    """Every leaf of BERT from the seed, on ``device``, in float32 (the
    program's master weights): matrices and embeddings normal × init_std in
    ONE draw of a card generator, layer-norm scales 1, biases 0."""
    g = torch.Generator(device=device).manual_seed(derive_seed(seed, "bert_weights"))
    drawn = [k for k, (_, kind) in shapes.items() if kind == "normal"]
    total = sum(int(np.prod(shapes[k][0])) for k in drawn)
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32).mul_(init_std)
    out, off = {}, 0
    for name, (shape, kind) in shapes.items():
        if kind == "normal":
            n = int(np.prod(shape))
            out[name] = flat[off:off + n].view(shape)
            off += n
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


# ------------------------------------------------------------- ANN corpus
def corpus_centers(seed: int, corpus: dict, dim: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(derive_seed(seed, "centers"))
    return torch.randn(int(corpus["centers"]), dim, generator=g, device=device) \
        * float(corpus["center_scale"])


def _mixture(g, centers, n: int, noise: float) -> torch.Tensor:
    comp = torch.randint(0, len(centers), (n,), generator=g, device=centers.device)
    return centers[comp] + noise * torch.randn(n, centers.shape[1], generator=g,
                                               device=centers.device)


def corpus_rows(seed: int, corpus: dict, centers: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Rows [lo, hi) of the corpus, on the centres' device: the clustered
    mixture of the reference's ANN scale leg, each chunk of ``chunk_rows``
    drawn by its own generator."""
    chunk = int(corpus["chunk_rows"])
    parts = []
    for k in range(lo // chunk, (hi - 1) // chunk + 1):
        c0 = k * chunk
        g = torch.Generator(device=centers.device).manual_seed(derive_seed(seed, "corpus", k))
        rows = _mixture(g, centers, chunk, float(corpus["noise"]))
        parts.append(rows[max(lo, c0) - c0:min(hi, c0 + chunk) - c0])
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def query_rows(seed: int, corpus: dict, centers: torch.Tensor, n: int, tag: str) -> torch.Tensor:
    """``n`` fresh draws of the corpus's mixture, on the centres' device."""
    g = torch.Generator(device=centers.device).manual_seed(derive_seed(seed, "queries", tag))
    return _mixture(g, centers, n, float(corpus["noise"]))
