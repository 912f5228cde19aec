"""The port's RaBitQ quantizer and k-means against the JAX package's, on the
CPU, from the same numpy-seeded inputs.

Tolerances, each from what differs between the two computations:
- fht / identity rotations and packed codes: exact.  The port runs the same
  float32 butterfly in the same order, with the same sign draws.
- matrix rotation: atol 1e-5 — one float32 matmul of ~N(0,1) rows against an
  orthonormal matrix, summed in another order (outputs ~N(0,1)).
- norms / factors / code_dot_c: rtol 1e-5, atol 1e-5 — float32 reductions in
  another order (the reference sums factors in float64; so does the port).
- estimated distances: rtol 1e-5, atol 1e-3 — terms of ~1e2 that cancel.
- k-means: centroids rtol/atol 1e-4 after 10 Lloyd iterations of float32
  sums in another order; assignments equal on well-separated blobs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lakesoul_tpu.vector import kmeans as jax_kmeans
from lakesoul_tpu.vector import rabitq as R
from lakesoul_tpu_torch.vector import kmeans as port_kmeans
from lakesoul_tpu_torch.vector import rabitq as T


@pytest.mark.parametrize("dim", [64, 100, 512])
@pytest.mark.parametrize("kind", ["fht", "identity"])
def test_rotator_is_bit_identical(kind, dim):
    x = np.random.default_rng(dim).normal(size=(40, dim)).astype(np.float32)
    ref, port = R.Rotator(dim, kind, seed=7), T.Rotator(dim, kind, seed=7, device="cpu")
    assert port.padded_dim == ref.padded_dim
    np.testing.assert_array_equal(port(x).numpy(), ref(x))
    np.testing.assert_array_equal(port(x[3]).numpy(), ref(x[3]))  # 1-D input


@pytest.mark.parametrize("dim", [64, 100])
def test_matrix_rotator(dim):
    x = np.random.default_rng(dim).normal(size=(40, dim)).astype(np.float32)
    ref, port = R.Rotator(dim, "matrix", seed=7), T.Rotator(dim, "matrix", seed=7, device="cpu")
    np.testing.assert_array_equal(port.matrix.numpy(), ref.matrix)  # the same QR draw
    np.testing.assert_allclose(port(x).numpy(), ref(x), atol=1e-5)


def test_fht_preserves_norm_and_unknown_rotator_raises():
    x = torch.randn(8, 256, generator=torch.Generator().manual_seed(0))
    y = T.Rotator(256, "fht", seed=1, device="cpu")(x)
    torch.testing.assert_close(y.norm(dim=1), x.norm(dim=1), rtol=1e-5, atol=1e-5)
    from lakesoul_tpu_torch.errors import VectorIndexError

    with pytest.raises(VectorIndexError):
        T.Rotator(8, "nope", device="cpu")


@pytest.mark.parametrize("d", [1, 7, 64, 100, 512])
def test_pack_bits_matches_np_packbits(d):
    bits = np.random.default_rng(d).integers(0, 2, size=(33, d)).astype(np.uint8)
    packed = T.pack_bits(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(packed, np.packbits(bits, axis=-1))
    np.testing.assert_array_equal(packed, R.pack_bits(bits))
    unpacked = T.unpack_bits(torch.from_numpy(packed), d).numpy()
    np.testing.assert_array_equal(unpacked, np.asarray(R.unpack_bits_jnp(jnp.asarray(packed), d)))
    np.testing.assert_array_equal(unpacked, bits.astype(np.float32))


@pytest.mark.parametrize("kind,dim", [("fht", 100), ("fht", 512), ("matrix", 100)])
def test_quantize_matches_reference(kind, dim):
    rng = np.random.default_rng(dim)
    v = rng.normal(size=(300, dim)).astype(np.float32)
    c = rng.normal(size=dim).astype(np.float32)
    ref = R.RabitqQuantizer(dim, rotator=kind, seed=3).quantize(v, c)
    port = T.RabitqQuantizer(dim, rotator=kind, seed=3, device="cpu").quantize(torch.from_numpy(v), torch.from_numpy(c))
    codes, norms, factors, cdc = (t.numpy() for t in port)
    if kind == "fht":
        np.testing.assert_array_equal(codes, ref[0])
    else:
        # a coordinate within rounding of 0 may take the other sign
        assert (np.unpackbits(codes ^ ref[0]).sum()) <= 2
    np.testing.assert_allclose(norms, ref[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(factors, ref[2], rtol=1e-5, atol=1e-5)
    if kind == "fht":
        np.testing.assert_allclose(cdc, ref[3], rtol=1e-5, atol=1e-5)


def test_quantize_per_row_centroids_equals_per_cluster_calls():
    """train quantizes every row against its own centroid in one call."""
    rng = np.random.default_rng(1)
    v = torch.from_numpy(rng.normal(size=(60, 100)).astype(np.float32))
    cents = torch.from_numpy(rng.normal(size=(3, 100)).astype(np.float32))
    assign = torch.from_numpy(rng.integers(0, 3, 60))
    q = T.RabitqQuantizer(100, seed=2, device="cpu")
    whole = q.quantize(v, cents[assign])
    for c in range(3):
        m = assign == c
        part = q.quantize(v[m], cents[c])
        for a, b in zip(whole, part):
            torch.testing.assert_close(a[m], b, rtol=1e-6, atol=1e-5)


def test_zero_residual_gets_factor_one():
    q = T.RabitqQuantizer(64, seed=0, device="cpu")
    c = torch.ones(64)
    _, norms, factors, _ = q.quantize(c[None, :].clone(), c)
    assert norms.item() == 0.0 and factors.item() == 1.0


def test_estimate_distances_matches_reference():
    rng = np.random.default_rng(5)
    dim = 128
    v = rng.normal(size=(400, dim)).astype(np.float32) * 3
    c = rng.normal(size=dim).astype(np.float32)
    query = rng.normal(size=dim).astype(np.float32) * 3
    rq = R.RabitqQuantizer(dim, seed=4)
    codes, norms, factors, _ = rq.quantize(v, c)
    q_rot = rq.rotate_query(query, c)
    want = np.asarray(R.estimate_distances(jnp.asarray(codes), jnp.asarray(norms),
                                           jnp.asarray(factors), jnp.asarray(q_rot), d=dim))
    port_q = T.RabitqQuantizer(dim, seed=4, device="cpu")
    q_rot_port = port_q.rotate_query(query, c)
    np.testing.assert_array_equal(q_rot_port.numpy(), q_rot)
    got = T.estimate_distances(torch.from_numpy(codes), torch.from_numpy(norms),
                               torch.from_numpy(factors), q_rot_port, d=dim).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("k,seed", [(4, 0), (8, 3)])
def test_kmeans_matches_reference_on_separated_blobs(k, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, 32)).astype(np.float32) * 10
    x = (centers[rng.integers(0, k, 2000)] + rng.normal(size=(2000, 32))).astype(np.float32)
    ref_c, ref_a = jax_kmeans.kmeans(x, k, iters=10, seed=seed)
    c, a = port_kmeans.kmeans(torch.from_numpy(x), k, iters=10, seed=seed)
    np.testing.assert_allclose(c.numpy(), ref_c, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(a.numpy(), ref_a)


def test_kmeans_tiny_input_repeats_points():
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    c, a = port_kmeans.kmeans(x, 5, iters=2, seed=0)
    ref_c, ref_a = jax_kmeans.kmeans(x.numpy(), 5, iters=2, seed=0)
    assert c.shape == (5, 2)
    np.testing.assert_allclose(c.numpy(), ref_c, atol=1e-6)
    np.testing.assert_array_equal(a.numpy(), ref_a)


def test_kmeans_assign_chunks_cover_every_row(monkeypatch):
    monkeypatch.setattr(port_kmeans, "_ASSIGN_CHUNK", 7)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(50, 4)).astype(np.float32))
    cents = x[:3]
    a = port_kmeans._assign(x, (x * x).sum(1, keepdim=True), cents)
    want = torch.cdist(x, cents).argmin(1)
    torch.testing.assert_close(a, want)
