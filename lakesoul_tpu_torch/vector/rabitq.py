"""RaBitQ quantization in PyTorch: rotation + 1-bit sign codes + unbiased
distance estimation factors (the port of ``lakesoul_tpu/vector/rabitq.py``).

For a vector v in cluster c:  r = P(v - c)  (P = random rotation)
  norm      = ||r||
  b         = sign(r) ∈ {-1,+1}^D,  stored packed (D/8 uint8, MSB-first)
  o_bar     = b / √D  (the quantized unit vector)
  factor    = <o_bar, r/||r||>  (quantization quality of this vector)

At query time with rotated residual q = P(query - c):
  <r, q> ≈ norm * <o_bar, q> / factor
  ||v - query||² = norm² + ||q||² - 2<r, q>
and <o_bar, q> needs only the {0,1} product:  b·q = 2·(bits·q) - sum(q).
Ex-codes (``total_bits`` 2-16, :meth:`RabitqQuantizer.quantize_ex`) keep
symmetric integer codes and a scale a row in place of the sign bits.

Rotation and quantization run on the rotator's device: ``device=None``
is the CUDA card, as at every entry point (``device.resolve_device``).  The rotator's
parameters come from the same numpy draws as the JAX package's (signs for
"fht", the QR of a gaussian matrix for "matrix"), so one seed gives one
rotation in both packages.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lakesoul_tpu_torch.device import resolve_device
from lakesoul_tpu_torch.errors import VectorIndexError

_MSB_FIRST = (7, 6, 5, 4, 3, 2, 1, 0)


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class Rotator:
    """Orthonormal rotation P applied to (possibly zero-padded) vectors:
    ``"fht"`` = random sign flips + fast Hadamard transform (FhtKac),
    ``"matrix"`` = dense random orthonormal matrix, ``"identity"``."""

    def __init__(self, dim: int, kind: str = "fht", seed: int = 42, rounds: int = 3,
                 *, device: torch.device | str | None = None):
        self.dim = dim
        self.kind = kind
        self.device = resolve_device(device)
        self.padded_dim = next_pow2(dim) if kind == "fht" else dim
        rng = np.random.default_rng(seed)
        if kind == "fht":
            signs = rng.choice([-1.0, 1.0], size=(rounds, self.padded_dim)).astype(np.float32)
            self.signs = torch.from_numpy(signs).to(self.device)
            # the reference scales by an np.float32; keep the same f32 value
            self.scale = float(np.float32(1.0 / np.sqrt(self.padded_dim)))
        elif kind == "matrix":
            a = rng.normal(size=(dim, dim)).astype(np.float32)
            q, _ = np.linalg.qr(a)
            self.matrix = torch.from_numpy(q.astype(np.float32)).to(self.device)
        elif kind != "identity":
            raise VectorIndexError(f"unknown rotator {kind}")

    def __call__(self, x) -> torch.Tensor:
        """x [..., dim] → rotated [..., padded_dim] f32 on the rotator's device."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if self.kind == "identity":
            return x
        if self.kind == "matrix":
            return x @ self.matrix
        pad = self.padded_dim - self.dim
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
        for r in range(self.signs.shape[0]):
            x = _fht(x * self.signs[r]) * self.scale
        return x


def _fht(x: torch.Tensor) -> torch.Tensor:
    """Fast Hadamard transform along the last axis (power-of-two length),
    the same butterfly order as the reference's numpy loop."""
    d = x.shape[-1]
    lead = x.shape[:-1]
    h = 1
    while h < d:
        y = x.reshape(*lead, d // (2 * h), 2, h)
        a, b = y[..., 0, :], y[..., 1, :]
        x = torch.stack((a + b, a - b), dim=-2).reshape(*lead, d)
        h *= 2
    return x


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[N, D] {0,1} → [N, ceil(D/8)] uint8, MSB-first: bit-identical to
    ``np.packbits(bits, axis=-1)``."""
    n, d = bits.shape
    d8 = (d + 7) // 8
    b = bits.to(torch.int32)
    if d8 * 8 != d:
        b = torch.nn.functional.pad(b, (0, d8 * 8 - d))
    shifts = torch.tensor(_MSB_FIRST, dtype=torch.int32, device=bits.device)
    return (b.view(n, d8, 8) << shifts).sum(-1).to(torch.uint8)


def unpack_bits(packed: torch.Tensor, d: int) -> torch.Tensor:
    """[N, D/8] uint8 → [N, d] {0,1} float32 (MSB-first like np.packbits)."""
    shifts = torch.tensor(_MSB_FIRST, dtype=torch.uint8, device=packed.device)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(packed.shape[0], packed.shape[1] * 8)[:, :d].to(torch.float32)


class RabitqQuantizer:
    """Quantize cluster residuals → packed codes + per-vector factors."""

    def __init__(self, dim: int, *, rotator: str = "fht", seed: int = 42,
                 device: torch.device | str | None = None):
        self.dim = dim
        self.rotator = Rotator(dim, rotator, seed, device=device)
        self.padded_dim = self.rotator.padded_dim
        self.device = self.rotator.device

    def quantize(self, vectors: torch.Tensor, centroid: torch.Tensor):
        """vectors [N, dim], centroid [dim] (or one per row, [N, dim]) →
        (codes [N, padded/8] uint8, norms [N] f32, factors [N] f32,
         code_dot_c [N] f32), all on the quantizer's device.

        ``code_dot_c`` = bits · P(centroid), precomputed so multi-cluster
        searches can use ONE globally-rotated query (rotation is linear).
        Every output row depends only on its own vector and centroid, so a
        whole build quantizes in one call with per-row centroids."""
        vectors = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
        centroid = torch.as_tensor(centroid, dtype=torch.float32, device=self.device)
        r = self.rotator(vectors - centroid)
        norms = torch.linalg.vector_norm(r, dim=1)
        unit = r / norms.clamp_min(1e-20)[:, None]
        bits = r > 0
        o_bar = (bits.to(torch.float32) * 2.0 - 1.0) / math.sqrt(self.padded_dim)
        # the reference sums this product in float64
        factors = torch.sum(o_bar * unit, dim=1, dtype=torch.float64).to(torch.float32)
        # guard: zero/degenerate vectors get factor 1 (estimator returns norm²)
        factors = torch.where(factors.abs() < 1e-6, torch.ones_like(factors), factors)
        c_rot = self.rotator(centroid)
        code_dot_c = (bits.to(torch.float32) * c_rot).sum(-1)
        return pack_bits(bits), norms, factors, code_dot_c

    def quantize_ex(self, vectors: torch.Tensor, centroid: torch.Tensor, total_bits: int):
        """Multi-bit quantization (``total_bits`` in [2, 16]) → (codes
        [N, padded] int8 up to 8 bits, int16 for 9-16; scales, norms,
        factors, code_dot_c [N] f32), on the quantizer's device.

        Codes are symmetric integers in [-qmax, qmax], qmax = 2^(bits-1) - 1,
        of the unit residual u over its largest |coordinate|; the scale folds
        qmax in, so u_hat = codes · scales, and factor = <u_hat, u> as in the
        1-bit path.  ``torch.round`` rounds half to even, as ``np.rint``
        does; a rotation that differs from numpy's in its last bits may put a
        code that sits on a .5 boundary one level apart."""
        if not 2 <= total_bits <= 16:
            raise VectorIndexError(f"ex-code total_bits must be in [2, 16], got {total_bits}")
        code_dtype = torch.int8 if total_bits <= 8 else torch.int16
        qmax = float(2 ** (total_bits - 1) - 1)
        vectors = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
        centroid = torch.as_tensor(centroid, dtype=torch.float32, device=self.device)
        r = self.rotator(vectors - centroid)
        norms = torch.linalg.vector_norm(r, dim=1)
        u = r / norms.clamp_min(1e-20)[:, None]
        amax = u.abs().amax(dim=1).clamp_min(1e-20)
        codes = torch.round(u / amax[:, None] * qmax).clamp_(-qmax, qmax).to(code_dtype)
        scales = amax / qmax
        u_hat = codes.to(torch.float32) * scales[:, None]
        factors = (u_hat * u).sum(1)
        factors = torch.where(factors.abs() < 1e-6, torch.ones_like(factors), factors)
        code_dot_c = (u_hat * self.rotator(centroid)).sum(-1)
        return codes, scales, norms, factors, code_dot_c

    def rotate(self, x) -> torch.Tensor:
        return self.rotator(x)

    def rotate_query(self, query, centroid) -> torch.Tensor:
        q = torch.as_tensor(query, dtype=torch.float32, device=self.device)
        return self.rotator(q - torch.as_tensor(centroid, dtype=torch.float32, device=self.device))


def estimate_distances(packed_codes: torch.Tensor, norms: torch.Tensor,
                       factors: torch.Tensor, q_rot: torch.Tensor, *, d: int) -> torch.Tensor:
    """Estimated squared L2 distances of one cluster's codes to the rotated
    query residual ``q_rot`` [d]: one bits·q product after unpacking.  A
    shorter ``q_rot`` reads as zero-padded to d, as the reference's packed
    scan pads it."""
    bq = unpack_bits(packed_codes, q_rot.shape[0]) @ q_rot
    dot_obar_q = (2.0 * bq - q_rot.sum()) / math.sqrt(d)
    est_rq = norms * dot_obar_q / factors
    return norms * norms + (q_rot * q_rot).sum() - 2.0 * est_rq
