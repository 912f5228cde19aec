"""Spark-compatible Murmur3 (x86_32, seed 42) row hashing, vectorized with numpy.

Byte-compatibility with the reference implementation
(rust/lakesoul-io/src/utils/hash/{mod.rs,spark_murmur3.rs}) is a hard
requirement: hash-bucket assignment decides which file a primary key lives in,
so a framework that hashes differently cannot read reference-written tables and
its bucket pruning (reader.rs:164-225) would be wrong.

Semantics reproduced (verified against the reference's behavior):

- Core is Murmur3 x86 32-bit, but the tail (< 4 remaining bytes) is processed
  **one byte at a time, each byte as a full mixed block** (Spark's
  ``hashUnsafeBytes`` quirk), with the total byte count in the finalizer.
- Integer types up to 32 bits (bool, i8, i16, i32, u8, u16, u32) hash as the
  value **sign-extended to u32**, little-endian, one block.
- 64-bit ints hash as 8 LE bytes (two blocks); 128-bit as 16 bytes.
- Floats bitcast to their unsigned int of the same width, except ``-0.0``
  which hashes as ``0``; f32 → one block, f64 → two blocks.
- Strings/binary hash their raw bytes (UTF-8 for strings).
- Null rows do **not** update the hash buffer (first column → hash 0).
- Multi-column hashing chains: column *i*'s per-row hash value seeds column
  *i+1* (``rehash`` in the reference).

The vectorized numpy implementation processes whole columns at once; an
optional C++ kernel (lakesoul_tpu/native) accelerates string columns.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

HASH_SEED = 42

_C1 = np.uint32(0xCC9E2D51)
_C2 = np.uint32(0x1B873593)
_FMIX1 = np.uint32(0x85EBCA6B)
_FMIX2 = np.uint32(0xC2B2AE35)
_M = np.uint32(5)
_N = np.uint32(0xE6546B64)


def _rotl32(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _mix_k(k: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        k = (k * _C1).astype(np.uint32)
        k = _rotl32(k, 15)
        return (k * _C2).astype(np.uint32)


def _mix_h(h: np.ndarray, k: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = h ^ _mix_k(k)
        h = _rotl32(h, 13)
        return (h * _M + _N).astype(np.uint32)


def _fmix(h: np.ndarray, length: np.ndarray | int) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = h ^ np.uint32(length) if np.isscalar(length) else h ^ length.astype(np.uint32)
        h = h ^ (h >> np.uint32(16))
        h = (h * _FMIX1).astype(np.uint32)
        h = h ^ (h >> np.uint32(13))
        h = (h * _FMIX2).astype(np.uint32)
        return h ^ (h >> np.uint32(16))


def murmur3_bytes(data: bytes, seed: int = HASH_SEED) -> int:
    """Scalar Spark-variant Murmur3 over raw bytes (byte-wise tail)."""
    h = np.uint32(seed)
    n = len(data)
    nblocks = n // 4
    if nblocks:
        blocks = np.frombuffer(data[: nblocks * 4], dtype="<u4")
        for k in blocks:
            h = _mix_h(h, np.uint32(k))
    for b in data[nblocks * 4 :]:
        h = _mix_h(h, np.uint32(b))
    return int(_fmix(h, n))


def _hash_u32_blocks(blocks: np.ndarray, seeds: np.ndarray, nbytes: int) -> np.ndarray:
    """Vectorized hash of fixed-width rows. blocks: (n, nblocks) uint32 LE."""
    h = seeds.astype(np.uint32, copy=True)
    for j in range(blocks.shape[1]):
        h = _mix_h(h, blocks[:, j])
    return _fmix(h, nbytes)


def _seed_array(n: int, seeds) -> np.ndarray:
    if seeds is None:
        return np.full(n, HASH_SEED, dtype=np.uint32)
    return np.asarray(seeds, dtype=np.uint32)


def hash_int_array(values: np.ndarray, seeds=None) -> np.ndarray:
    """Hash ≤32-bit integers / bools: sign-extend to u32, one LE block."""
    v = np.asarray(values)
    if v.dtype == np.bool_:
        v = v.astype(np.int32)
    from lakesoul_tpu_torch import native

    if native.available() and len(v):
        # int32 cast sign-extends smaller ints; the kernel wraps to u32 —
        # identical to the numpy sign-extend-then-wrap below
        out = np.empty(len(v), dtype=np.uint32)
        seeds_arr = None if seeds is None else np.ascontiguousarray(seeds, np.uint32)
        native.hash_i32(v.astype(np.int32, copy=False), seeds_arr, None, out, HASH_SEED)
        return out
    u = v.astype(np.int64).astype(np.uint32).reshape(-1, 1)  # sign-extend then wrap
    return _hash_u32_blocks(u, _seed_array(len(u), seeds), 4)


def hash_long_array(values: np.ndarray, seeds=None) -> np.ndarray:
    """Hash 64-bit integers: 8 LE bytes = two u32 blocks (low then high)."""
    raw = np.asarray(values)
    from lakesoul_tpu_torch import native

    if native.available() and len(raw):
        i64 = raw.view(np.int64) if raw.dtype == np.uint64 else np.ascontiguousarray(raw, np.int64)
        out = np.empty(len(raw), dtype=np.uint32)
        seeds_arr = None if seeds is None else np.ascontiguousarray(seeds, np.uint32)
        native.hash_i64(i64, seeds_arr, None, out, HASH_SEED)
        return out
    u = raw.astype(np.uint64)
    lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (u >> np.uint64(32)).astype(np.uint32)
    return _hash_u32_blocks(np.stack([lo, hi], axis=1), _seed_array(len(u), seeds), 8)


def hash_float_array(values: np.ndarray, seeds=None) -> np.ndarray:
    v = np.asarray(values)
    if v.dtype == np.float32:
        # -0.0 hashes as integer 0 in the reference
        neg_zero = np.signbit(v) & (v == 0)
        bits = np.where(neg_zero, np.uint32(0), v.view(np.uint32))
        return _hash_u32_blocks(bits.reshape(-1, 1), _seed_array(len(v), seeds), 4)
    elif v.dtype == np.float64:
        neg_zero = np.signbit(v) & (v == 0)
        bits = np.where(neg_zero, np.uint64(0), v.view(np.uint64))
        lo = (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (bits >> np.uint64(32)).astype(np.uint32)
        return _hash_u32_blocks(np.stack([lo, hi], axis=1), _seed_array(len(v), seeds), 8)
    raise TypeError(f"unsupported float dtype {v.dtype}")


def hash_bytes_list(values, seeds=None) -> np.ndarray:
    """Hash variable-length byte strings.  Rows are grouped by length so each
    group vectorizes (full LE words, then byte-wise tail)."""
    n = len(values)
    seeds = _seed_array(n, seeds)
    out = np.zeros(n, dtype=np.uint32)
    lengths = np.fromiter((len(v) for v in values), dtype=np.int64, count=n)
    for length in np.unique(lengths):
        idx = np.nonzero(lengths == length)[0]
        L = int(length)
        if L == 0:
            out[idx] = _fmix(seeds[idx].copy(), 0)
            continue
        buf = np.empty((len(idx), L), dtype=np.uint8)
        for row, i in enumerate(idx):
            buf[row] = np.frombuffer(values[i], dtype=np.uint8)
        h = seeds[idx].astype(np.uint32, copy=True)
        nblocks = L // 4
        if nblocks:
            words = buf[:, : nblocks * 4].view("<u4")
            for j in range(nblocks):
                h = _mix_h(h, words[:, j])
        for j in range(nblocks * 4, L):
            h = _mix_h(h, buf[:, j].astype(np.uint32))
        out[idx] = _fmix(h, L)
    return out


def hash_array(arr: pa.Array, seeds=None, *, null_values: np.ndarray | None = None) -> np.ndarray:
    """Hash one Arrow array; null rows keep their hash-buffer value unchanged
    (0 for the first column — the reference zero-initializes the buffer,
    repartition/mod.rs:246), matching hash_array_primitive in the reference.
    ``seeds`` seeds the hash of valid rows; ``null_values`` supplies the
    passthrough value for null rows (defaults to ``seeds``)."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    n = len(arr)
    seeds_arr = _seed_array(n, seeds)
    null_arr = seeds_arr if null_values is None else np.asarray(null_values, dtype=np.uint32)
    t = arr.type
    valid = np.ones(n, dtype=bool)
    if arr.null_count:
        valid = np.asarray(arr.is_valid())
        # hash only valid rows; null rows pass their incoming buffer through
        filled = arr.drop_null()
    else:
        filled = arr

    if pa.types.is_dictionary(t):
        # hash the decoded values (same logical value → same hash)
        return hash_array(arr.cast(t.value_type), seeds, null_values=null_values)

    def _dispatch(a: pa.Array, s: np.ndarray) -> np.ndarray:
        ty = a.type
        if pa.types.is_boolean(ty):
            return hash_int_array(np.asarray(a.cast(pa.int32())), s)
        if pa.types.is_integer(ty):
            if ty.bit_width <= 32:
                return hash_int_array(np.asarray(a), s)
            return hash_long_array(np.asarray(a), s)
        if pa.types.is_floating(ty):
            if ty.bit_width == 16:
                v16 = np.asarray(a).astype(np.float16)
                neg_zero = np.signbit(v16) & (v16 == 0)
                bits = np.where(neg_zero, np.uint16(0), v16.view(np.uint16))
                return hash_int_array(bits.astype(np.uint32), s)
            return hash_float_array(np.asarray(a), s)
        if pa.types.is_decimal(ty):
            # hash the raw unscaled storage (i128/i256 LE bytes), like the
            # reference's Decimal128/256 HashValue impls — NOT the rounded
            # Python value
            width = ty.byte_width  # 16 for decimal128, 32 for decimal256
            raw = np.frombuffer(a.buffers()[1], dtype=np.uint8)
            start = a.offset * width
            bufs = [
                raw[start + i * width : start + (i + 1) * width].tobytes()
                for i in range(len(a))
            ]
            return hash_bytes_list(bufs, s)
        if (
            pa.types.is_string(ty)
            or pa.types.is_large_string(ty)
            or pa.types.is_binary(ty)
            or pa.types.is_large_binary(ty)
        ):
            from lakesoul_tpu_torch import native

            if native.available() and len(a) > 0:
                # zero-copy over the Arrow buffers (validity handled upstream)
                bufs = a.buffers()
                off_dtype = np.int64 if (
                    pa.types.is_large_string(ty) or pa.types.is_large_binary(ty)
                ) else np.int32
                offsets = np.frombuffer(bufs[1], dtype=off_dtype)[
                    a.offset : a.offset + len(a) + 1
                ].copy()
                data = np.frombuffer(bufs[2], dtype=np.uint8) if bufs[2] else np.zeros(0, np.uint8)
                out = np.empty(len(a), dtype=np.uint32)
                native.hash_string_array(data, offsets, s, None, out, HASH_SEED)
                return out
            pylist = a.to_pylist()
            bufs = [v.encode("utf-8") if isinstance(v, str) else v for v in pylist]
            return hash_bytes_list(bufs, s)
        if pa.types.is_fixed_size_binary(ty):
            return hash_bytes_list(a.to_pylist(), s)
        if pa.types.is_date(ty) or pa.types.is_time(ty) or pa.types.is_timestamp(ty):
            # 32-bit storage (date32/time32) hashes as one 4-byte block, like
            # the reference's i32-native Date32/Time32 arrays; 64-bit storage
            # as two blocks
            if ty.bit_width == 32:
                return hash_int_array(np.asarray(a.view(pa.int32())), s)
            return hash_long_array(np.asarray(a.view(pa.int64())), s)
        raise TypeError(f"Unsupported data type in hasher: {ty}")

    if arr.null_count:
        out = null_arr.copy()
        out[valid] = _dispatch(filled, seeds_arr[valid])
        return out
    return _dispatch(filled, seeds_arr)


def hash_columns(columns, num_rows: int | None = None) -> np.ndarray:
    """Hash one row-hash per row across columns, chaining like the reference's
    create_hashes (utils/hash/mod.rs:304): column 0 seeds valid rows with 42,
    column i>0 seeds each row with the running hash.  Null rows pass the
    buffer through unchanged, so a first-column null hashes to 0 (the
    reference zero-initializes the buffer)."""
    cols = list(columns)
    if not cols:
        raise ValueError("hash_columns needs at least one column")
    n = num_rows if num_rows is not None else len(cols[0])
    h = hash_array(cols[0], None, null_values=np.zeros(n, dtype=np.uint32))
    for col in cols[1:]:
        h = hash_array(col, h)
    return h


def hash_scalar(value, dtype: pa.DataType | None = None) -> int:
    """Hash a single Python scalar the way compute_scalar_hash does
    (helpers/mod.rs:1059) — used for bucket pruning on PK equality filters."""
    if value is None:
        return HASH_SEED
    if isinstance(value, bool):
        return int(hash_int_array(np.array([value]))[0])
    if isinstance(value, int):
        if dtype is not None and pa.types.is_integer(dtype) and dtype.bit_width <= 32:
            return int(hash_int_array(np.array([value], dtype=np.int64))[0])
        if dtype is None and -(2**31) <= value < 2**31:
            return int(hash_int_array(np.array([value], dtype=np.int64))[0])
        return int(hash_long_array(np.array([value], dtype=np.int64))[0])
    if isinstance(value, float):
        if dtype is not None and pa.types.is_float32(dtype):
            return int(hash_float_array(np.array([value], dtype=np.float32))[0])
        return int(hash_float_array(np.array([value], dtype=np.float64))[0])
    if isinstance(value, str):
        return murmur3_bytes(value.encode("utf-8"))
    if isinstance(value, (bytes, bytearray)):
        return murmur3_bytes(bytes(value))
    raise TypeError(f"unsupported scalar type {type(value)}")


def bucket_ids(hashes: np.ndarray, num_buckets: int) -> np.ndarray:
    """Bucket assignment: unsigned u32 hash % num_buckets
    (repartition/mod.rs:259 uses `*hash % *partitions as u32`)."""
    return (hashes.astype(np.uint32) % np.uint32(num_buckets)).astype(np.int64)


def bucket_id_for_scalar(value, num_buckets: int, dtype: pa.DataType | None = None) -> int:
    return int(np.uint32(hash_scalar(value, dtype)) % np.uint32(num_buckets))
