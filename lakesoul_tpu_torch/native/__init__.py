"""Native C++ core loader.

Builds (once, cached) and loads ``liblakesoul_native.so`` via ctypes; every
consumer has a pure-numpy fallback, so the package works without a compiler
(set ``LAKESOUL_TPU_DISABLE_NATIVE=1`` to force fallbacks).

The port builds its own copy of the source (``native/src/``) with ``g++`` at
first use into the git-ignored ``lakesoul_tpu_torch/_build/``
(``LAKESOUL_TPU_TORCH_BUILD_DIR`` overrides it), under a file name keyed by a
hash of the source and flags, so an edited source is rebuilt and a stale
library is never loaded.  The compiler writes to a temporary name in that
directory which is then ``os.replace``-d onto the final path: processes that
build at once each publish a whole library, and none ever ``dlopen``-s a
file another compiler is still writing."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "lakesoul_native.cc")
# no -march=native: the .so may travel with the package tree to a different
# CPU (container image, shared venv) where native ISA extensions would
# SIGILL; these kernels vectorize fine at -O3
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False


def build_dir() -> str:
    """Where the library is built: ``LAKESOUL_TPU_TORCH_BUILD_DIR`` or the
    package's ``_build/``."""
    return os.environ.get("LAKESOUL_TPU_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(_HERE), "_build"
    )


def library_path() -> str:
    """The library's path, keyed by a hash of the source and the flags."""
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(_FLAGS).encode())
    return os.path.join(build_dir(), f"liblakesoul_native-{h.hexdigest()[:16]}.so")


def _build(out: str) -> bool:
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        subprocess.run(
            ["g++", *_FLAGS, _SRC, "-o", tmp],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        return True
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ls_hash_i32.argtypes = [i32p, u8p, u32p, ctypes.c_int64, u32p, ctypes.c_uint32]
    lib.ls_hash_i64.argtypes = [i64p, u8p, u32p, ctypes.c_int64, u32p, ctypes.c_uint32]
    lib.ls_hash_bytes32.argtypes = [u8p, i32p, u8p, u32p, ctypes.c_int64, u32p, ctypes.c_uint32]
    lib.ls_hash_bytes64.argtypes = [u8p, i64p, u8p, u32p, ctypes.c_int64, u32p, ctypes.c_uint32]
    lib.ls_bucket_ids.argtypes = [u32p, i64p, ctypes.c_int64, ctypes.c_uint32]
    lib.ls_merge_i64.argtypes = [i64p, i64p, ctypes.c_int32, i64p, u8p]
    lib.ls_merge_i64.restype = ctypes.c_int64
    lib.ls_merge_bytes.argtypes = [u8p, i64p, i64p, ctypes.c_int32, i64p, u8p]
    lib.ls_merge_bytes.restype = ctypes.c_int64
    lib.ls_pack_bits.argtypes = [u8p, u8p, ctypes.c_int64, ctypes.c_int64]
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.ls_gather_fixed.argtypes = [u8p, ctypes.c_int64, i64p, ctypes.c_int64, u8p]
    lib.ls_gather_valid_bits.argtypes = [u8p, ctypes.c_int64, i64p, ctypes.c_int64, u8p]
    lib.ls_gather_valid_bits.restype = ctypes.c_int64
    lib.ls_gather_multi_chunked.argtypes = [
        u64p, i32p, i64p, ctypes.c_int32, i32p, i64p, ctypes.c_int64, u64p,
    ]
    lib.ls_bitpack64.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, u8p]
    lib.ls_bitunpack64.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, i64p]
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.ls_ann_ragged_topk.argtypes = [
        f32p, f32p, f32p, f32p, i64p, i64p, f32p,
        ctypes.c_int64, ctypes.c_int64,
        i32p, i64p, ctypes.c_int64, i32p, f32p, f32p,
        ctypes.c_int64, f32p, i64p,
    ]
    lib.ls_ann_exact_rerank.argtypes = [
        f32p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int64, f32p, f32p,
    ]


def get_lib():
    """The loaded native library, or None when unavailable/disabled.  The
    kill switch is honored even after the library has loaded."""
    global _lib, _tried
    if os.environ.get("LAKESOUL_TPU_DISABLE_NATIVE") == "1":
        return None
    if _lib is not None:
        return _lib
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SRC):
            return None
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
            _bind(lib)
            _lib = lib
        except (OSError, AttributeError):
            # AttributeError: a library missing a symbol the binding
            # expects — fall back to numpy rather than crash the first
            # hash/merge call
            _lib = None
    return _lib


def available() -> bool:
    return get_lib() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def hash_i64(vals: np.ndarray, seeds: np.ndarray | None, valid: np.ndarray | None,
             out: np.ndarray, seed: int) -> None:
    lib = get_lib()
    lib.ls_hash_i64(
        _ptr(np.ascontiguousarray(vals, np.int64), ctypes.c_int64),
        _ptr(valid, ctypes.c_uint8) if valid is not None else None,
        _ptr(out, ctypes.c_uint32),
        len(vals),
        _ptr(seeds, ctypes.c_uint32) if seeds is not None else None,
        seed,
    )


def hash_i32(vals: np.ndarray, seeds: np.ndarray | None, valid: np.ndarray | None,
             out: np.ndarray, seed: int) -> None:
    lib = get_lib()
    lib.ls_hash_i32(
        _ptr(np.ascontiguousarray(vals, np.int32), ctypes.c_int32),
        _ptr(valid, ctypes.c_uint8) if valid is not None else None,
        _ptr(out, ctypes.c_uint32),
        len(vals),
        _ptr(seeds, ctypes.c_uint32) if seeds is not None else None,
        seed,
    )


def hash_string_array(data: np.ndarray, offsets: np.ndarray, seeds: np.ndarray | None,
                      valid: np.ndarray | None, out: np.ndarray, seed: int) -> None:
    """Arrow string layout: data uint8 buffer + offsets (i32 or i64)."""
    lib = get_lib()
    n = len(offsets) - 1
    if offsets.dtype == np.int32:
        lib.ls_hash_bytes32(
            _ptr(data, ctypes.c_uint8),
            _ptr(offsets, ctypes.c_int32),
            _ptr(valid, ctypes.c_uint8) if valid is not None else None,
            _ptr(out, ctypes.c_uint32), n,
            _ptr(seeds, ctypes.c_uint32) if seeds is not None else None, seed,
        )
    else:
        lib.ls_hash_bytes64(
            _ptr(data, ctypes.c_uint8),
            _ptr(np.ascontiguousarray(offsets, np.int64), ctypes.c_int64),
            _ptr(valid, ctypes.c_uint8) if valid is not None else None,
            _ptr(out, ctypes.c_uint32), n,
            _ptr(seeds, ctypes.c_uint32) if seeds is not None else None, seed,
        )


def merge_sorted_runs_i64(keys: np.ndarray, run_offsets: np.ndarray):
    """Loser-tree merge of k sorted int64 runs → (order, group_tail, n_groups)."""
    lib = get_lib()
    n = int(run_offsets[-1])
    order = np.empty(n, dtype=np.int64)
    tail = np.empty(n, dtype=np.uint8)
    groups = lib.ls_merge_i64(
        _ptr(np.ascontiguousarray(keys, np.int64), ctypes.c_int64),
        _ptr(np.ascontiguousarray(run_offsets, np.int64), ctypes.c_int64),
        len(run_offsets) - 1,
        _ptr(order, ctypes.c_int64),
        _ptr(tail, ctypes.c_uint8),
    )
    return order, tail.astype(bool), int(groups)


def merge_sorted_runs_bytes(data: np.ndarray, offsets: np.ndarray, run_offsets: np.ndarray):
    """Loser-tree merge of k sorted byte-string runs (Arrow string layout:
    uint8 data + int64 offsets[n+1]) → (order, group_tail, n_groups)."""
    lib = get_lib()
    n = int(run_offsets[-1])
    order = np.empty(n, dtype=np.int64)
    tail = np.empty(n, dtype=np.uint8)
    groups = lib.ls_merge_bytes(
        _ptr(np.ascontiguousarray(data, np.uint8), ctypes.c_uint8),
        _ptr(np.ascontiguousarray(offsets, np.int64), ctypes.c_int64),
        _ptr(np.ascontiguousarray(run_offsets, np.int64), ctypes.c_int64),
        len(run_offsets) - 1,
        _ptr(order, ctypes.c_int64),
        _ptr(tail, ctypes.c_uint8),
    )
    return order, tail.astype(bool), int(groups)


def gather_fixed(src: np.ndarray, idx: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """Gather ``src[idx]`` for fixed-width values (the MOR merge-apply /
    null-fill hot path).  A negative index writes zero bytes — the caller
    marks those rows null via :func:`gather_valid_bits`.  ``out`` may be a
    reusable buffer of the right length/dtype."""
    lib = get_lib()
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    n = len(idx)
    if out is None:
        out = np.empty(n, dtype=src.dtype)
    lib.ls_gather_fixed(
        src.view(np.uint8).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        src.dtype.itemsize,
        _ptr(idx, ctypes.c_int64),
        n,
        out.view(np.uint8).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out


def gather_multi_chunked(
    chunk_addrs: np.ndarray,
    chunk_counts: np.ndarray,
    widths: np.ndarray,
    chunk_of: np.ndarray,
    local_idx: np.ndarray,
    out_addrs: np.ndarray,
) -> None:
    """Whole-table gather in ONE native call over possibly-chunked,
    null-free fixed-width columns (the merge-apply hot path gathers straight
    from the concatenated runs — no combine_chunks copy, no per-column
    ctypes round-trips).  ``chunk_of``/``local_idx`` are the pre-resolved
    per-row (chunk, offset) pairs — one vectorized searchsorted in the
    caller, shared by every column with the same chunking (see
    io/merge.take_indices); the caller guarantees contiguity and dtypes."""
    lib = get_lib()
    lib.ls_gather_multi_chunked(
        _ptr(chunk_addrs, ctypes.c_uint64),
        _ptr(chunk_counts, ctypes.c_int32),
        _ptr(widths, ctypes.c_int64),
        len(widths),
        _ptr(chunk_of, ctypes.c_int32),
        _ptr(local_idx, ctypes.c_int64),
        len(local_idx),
        _ptr(out_addrs, ctypes.c_uint64),
    )


def gather_valid_bits(
    bits: np.ndarray | None, bit_offset: int, idx: np.ndarray
) -> tuple[np.ndarray, int]:
    """Gather an Arrow validity bitmap by row index → (packed LSB-first
    bitmap of ``len(idx)`` bits, null count).  ``bits=None`` = all-valid
    source; negative indices emit null (the fill half of gather+fill)."""
    lib = get_lib()
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    n = len(idx)
    out = np.empty((n + 7) // 8, dtype=np.uint8)
    nulls = lib.ls_gather_valid_bits(
        _ptr(np.ascontiguousarray(bits, np.uint8), ctypes.c_uint8)
        if bits is not None
        else None,
        bit_offset,
        _ptr(idx, ctypes.c_int64),
        n,
        _ptr(out, ctypes.c_uint8),
    )
    return out, int(nulls)


def bitpack64(vals: np.ndarray, base: int, width: int) -> np.ndarray:
    """Frame-of-reference bit-pack int64 values into an LSB-first bitstream
    (LSF columnar format).  Returns the packed bytes INCLUDING 8 padding
    bytes the decoder's word-wide loads require."""
    n = len(vals)
    nbytes = (n * width + 7) // 8 + 8
    out = np.zeros(nbytes, dtype=np.uint8)
    lib = get_lib()
    if lib is not None and width > 0:
        lib.ls_bitpack64(
            _ptr(np.ascontiguousarray(vals, np.int64), ctypes.c_int64),
            n, base, width, _ptr(out, ctypes.c_uint8),
        )
        return out
    if width <= 0 or n == 0:
        return out
    # numpy fallback: build the [n, width] bit matrix and packbits it
    deltas = (vals.astype(np.int64) - np.int64(base)).view(np.uint64)
    shifts = np.arange(width, dtype=np.uint64)
    bits = ((deltas[:, None] >> shifts[None, :]) & np.uint64(1)).astype(np.uint8)
    packed = np.packbits(bits.reshape(-1), bitorder="little")
    out[: len(packed)] = packed
    return out


def bitunpack64(buf: np.ndarray, n: int, base: int, width: int) -> np.ndarray:
    """Inverse of :func:`bitpack64` → int64 array of n values."""
    out = np.empty(n, dtype=np.int64)
    if width <= 0:
        out.fill(base)
        return out
    lib = get_lib()
    if lib is not None:
        lib.ls_bitunpack64(
            _ptr(np.ascontiguousarray(buf, np.uint8), ctypes.c_uint8),
            n, base, width, _ptr(out, ctypes.c_int64),
        )
        return out
    if n == 0:
        return out
    nbits = n * width
    bits = np.unpackbits(buf[: (nbits + 7) // 8], bitorder="little")[:nbits]
    bits = bits.reshape(n, width).astype(np.uint64)
    shifts = np.arange(width, dtype=np.uint64)
    deltas = (bits << shifts[None, :]).sum(axis=1, dtype=np.uint64)
    base_u = np.uint64(base & 0xFFFFFFFFFFFFFFFF)  # two's complement bits
    return (deltas + base_u).view(np.int64).copy()


def ann_ragged_topk(
    codes: np.ndarray, a: np.ndarray, b: np.ndarray, h: np.ndarray | None,
    row_start: np.ndarray, row_count: np.ndarray, q_glob: np.ndarray,
    grp_cluster: np.ndarray, grp_off: np.ndarray,
    pair_query: np.ndarray, pair_csq: np.ndarray, pair_csum: np.ndarray | None,
    s: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Ragged ANN estimator scan + per-query top-``s`` (annplane hot path).
    One GIL-released call per shard; returns (rows [m, s] with -1 holes,
    est [m, s] with +inf holes), shortlist order unspecified."""
    lib = get_lib()
    m = len(q_glob)
    d = q_glob.shape[1]
    out_est = np.full((m, s), np.inf, np.float32)
    out_rows = np.full((m, s), -1, np.int64)
    f32 = ctypes.c_float
    lib.ls_ann_ragged_topk(
        _ptr(codes, f32), _ptr(a, f32), _ptr(b, f32),
        _ptr(h, f32) if h is not None else None,
        _ptr(row_start, ctypes.c_int64), _ptr(row_count, ctypes.c_int64),
        _ptr(q_glob, f32), m, d,
        _ptr(grp_cluster, ctypes.c_int32), _ptr(grp_off, ctypes.c_int64),
        len(grp_cluster),
        _ptr(pair_query, ctypes.c_int32), _ptr(pair_csq, f32),
        _ptr(pair_csum, f32) if pair_csum is not None else None,
        s, _ptr(out_est, f32), _ptr(out_rows, ctypes.c_int64),
    )
    return out_rows, out_est


def ann_exact_rerank(
    raw: np.ndarray, rows: np.ndarray, queries: np.ndarray
) -> np.ndarray:
    """Exact squared-L2 re-rank of shortlisted rows (rows < 0 → +inf)."""
    lib = get_lib()
    m, s = rows.shape
    out = np.empty((m, s), np.float32)
    lib.ls_ann_exact_rerank(
        _ptr(raw, ctypes.c_float), raw.shape[1],
        _ptr(rows, ctypes.c_int64), m, s,
        _ptr(queries, ctypes.c_float), _ptr(out, ctypes.c_float),
    )
    return out


def pack_bits(bits: np.ndarray) -> np.ndarray:
    lib = get_lib()
    n, d = bits.shape
    out = np.empty((n, (d + 7) // 8), dtype=np.uint8)
    lib.ls_pack_bits(
        _ptr(np.ascontiguousarray(bits, np.uint8), ctypes.c_uint8),
        _ptr(out, ctypes.c_uint8), n, d,
    )
    return out
