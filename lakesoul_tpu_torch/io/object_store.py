"""Object-store abstraction.

The reference registers per-table object stores (S3/HDFS/local) behind the
``object_store`` crate (rust/lakesoul-io/src/object_store.rs:185).  Here the
same role is played by fsspec: local paths, ``gs://`` (gcsfs), ``s3://``,
``memory://``, ``hdfs://`` — whatever fsspec resolves — handed directly to
pyarrow, which understands fsspec filesystems natively.

``hdfs://namenode:port/path`` resolves through fsspec's arrow wrapper over
``pyarrow.fs.HadoopFileSystem`` (the role of the reference's hdrs-backed
store, rust/lakesoul-io/src/hdfs/mod.rs:37-640); host/port come from the
URL, while extras ride protocol-scoped storage options — ``hdfs.user``,
``hdfs.kerb_ticket``, ``hdfs.replication`` — which are stripped of their
prefix and passed only when the path IS hdfs.  The same scoping works for
every protocol fsspec knows (``s3.endpoint_url``, ``gs.token``,
``sftp.username``, …), so one option dict can serve a multi-store catalog
without leaking kwargs across backends.

Remote READS go through the framework's own bounded disk page cache
(io/page_cache.py, the role of rust/lakesoul-io/src/cache/disk_cache.rs)
when ``lakesoul.cache_dir`` is set; writes always bypass it.

Remote stores are additionally wrapped in :class:`ResilientFileSystem`:
every GET-shaped call (``cat_file``, ``open`` for read, metadata lookups)
is a fault-injection point (``object_store.cat_file`` etc. — see
runtime/faults.py) and is retried under the shared
:class:`~lakesoul_tpu_torch.runtime.resilience.RetryPolicy` when the failure is
transient.  Truncated responses (the ``truncate`` chaos kind, or a real
short read) are detected by length and retried like any other transient
fault.  Local filesystems are never wrapped — the wrapper exists for the
network.
"""

from __future__ import annotations

import os

import fsspec
from fsspec.spec import AbstractFileSystem

from lakesoul_tpu_torch.runtime import faults
from lakesoul_tpu_torch.runtime.resilience import RetryPolicy

# storage_options keys consumed by the framework itself (not passed to fsspec)
OPTION_CACHE_DIR = "lakesoul.cache_dir"
OPTION_CACHE_MAX_BYTES = "lakesoul.cache_max_bytes"
OPTION_CACHE_PAGE_BYTES = "lakesoul.cache_page_bytes"
OPTION_CACHE_READAHEAD = "lakesoul.cache_readahead_pages"
OPTION_CACHE_DISABLED_PROTOCOLS = ("file", "local")

_OWN_OPTIONS = (
    OPTION_CACHE_DIR,
    OPTION_CACHE_MAX_BYTES,
    OPTION_CACHE_PAGE_BYTES,
    OPTION_CACHE_READAHEAD,
)

# aliased schemes normalize to one canonical scope so either spelling works
# on either path form (`gs.token` on a gcs:// path and vice versa)
_PROTOCOL_ALIASES = {
    "local": "file", "s3a": "s3", "gcs": "gs", "az": "abfs", "https": "http",
}


def _known_protocols() -> set[str]:
    """Every scheme fsspec knows about (plus our aliases): a dotted option
    key starting with any of these is a protocol scope, anything else is an
    ordinary kwarg that happens to contain a dot."""
    from fsspec.registry import known_implementations

    return set(known_implementations) | set(_PROTOCOL_ALIASES) | {"file"}


def _split_options(storage_options: dict | None) -> tuple[dict, dict]:
    opts = dict(storage_options or {})
    own = {k: opts.pop(k) for k in _OWN_OPTIONS if k in opts}
    return own, opts


def _scope_options(opts: dict, protocol: str) -> dict:
    """Apply protocol-scoped keys for ANY fsspec-known protocol:
    ``<protocol>.<kwarg>`` is unwrapped when the prefix names the current
    protocol (directly or via an alias), dropped when it names a different
    one, and unscoped keys pass through untouched."""
    out = {}
    known = _known_protocols()
    canon = _PROTOCOL_ALIASES.get(protocol, protocol)
    for k, v in opts.items():
        pfx, dot, rest = k.partition(".")
        if dot and pfx in known:
            if pfx == protocol or _PROTOCOL_ALIASES.get(pfx, pfx) == canon:
                out[rest] = v
            continue
        out[k] = v
    return out


class ResilientFileSystem(AbstractFileSystem):
    """fsspec wrapper adding fault points + transient-failure retries to a
    remote store (the role the reference delegates to object_store crate
    retry config).  Read-shaped calls retry under the shared policy;
    mutating calls delegate untouched (a half-applied PUT/DELETE replay is
    the caller's protocol to own — the commit layer is already idempotent).

    Chaos: ``object_store.cat_file`` / ``object_store.open`` /
    ``object_store.info`` are the injection points; ``truncate`` faults on
    ``cat_file`` are detected by length (the Content-Length check every
    real HTTP client performs) and surface as a retryable short read."""

    protocol = "lsresilient"

    def __init__(self, target_fs, policy: RetryPolicy, **kwargs):
        super().__init__(**kwargs)
        self.target = target_fs
        self.policy = policy

    def __getattr__(self, name):
        # backend-specific attributes (hdfs user, s3 endpoint, custom
        # methods) read through to the wrapped filesystem
        target = self.__dict__.get("target")
        if target is None:
            raise AttributeError(name)
        return getattr(target, name)

    def _retried(self, op: str, fn):
        return self.policy.run(fn, op=op)

    # ---------------------------------------------------------------- reads
    def cat_file(self, path, start=None, end=None, **kwargs):
        def attempt():
            faults.maybe_inject("object_store.cat_file")
            out = self.target.cat_file(path, start=start, end=end, **kwargs)
            filtered = faults.filter_bytes("object_store.cat_file", out)
            if len(filtered) < len(out):
                # injected truncation: detectable exactly like a
                # Content-Length mismatch, and just as retryable
                raise ConnectionError(
                    f"short read for {path}: got {len(filtered)} of {len(out)} bytes"
                )
            if start is not None and end is not None and len(out) < end - start:
                # a REAL short read: a ranged GET may only legitimately come
                # back short when the range overruns EOF — anything else is a
                # body cut mid-flight (the Content-Length check every real
                # HTTP client performs).  size() costs one metadata call and
                # runs only on short results, i.e. tail reads and failures.
                if end <= self.target.size(path):
                    raise ConnectionError(
                        f"short read for {path}: got {len(out)}"
                        f" of {end - start} bytes"
                    )
            return out

        return self._retried("object_store.cat_file", attempt)

    def open(self, path, mode="rb", **kwargs):
        if "r" in mode and "w" not in mode and "a" not in mode:
            def attempt():
                faults.maybe_inject("object_store.open")
                return self.target.open(path, mode, **kwargs)

            return self._retried("object_store.open", attempt)
        return self.target.open(path, mode, **kwargs)

    def _open(self, path, mode="rb", **kwargs):
        return self.target.open(path, mode, **kwargs)

    def info(self, path, **kwargs):
        def attempt():
            faults.maybe_inject("object_store.info")
            return self.target.info(path, **kwargs)

        return self._retried("object_store.info", attempt)

    def ls(self, path, detail=True, **kwargs):
        return self._retried(
            "object_store.ls", lambda: self.target.ls(path, detail=detail, **kwargs)
        )

    def exists(self, path, **kwargs):
        return self._retried(
            "object_store.info", lambda: self.target.exists(path, **kwargs)
        )

    def size(self, path):
        return self._retried("object_store.info", lambda: self.target.size(path))

    def isfile(self, path):
        return self._retried("object_store.info", lambda: self.target.isfile(path))

    def isdir(self, path):
        return self._retried("object_store.info", lambda: self.target.isdir(path))

    def glob(self, path, **kwargs):
        return self._retried("object_store.ls", lambda: self.target.glob(path, **kwargs))

    def find(self, path, **kwargs):
        return self._retried("object_store.ls", lambda: self.target.find(path, **kwargs))

    # ------------------------------------------------------------ mutations
    def pipe_file(self, path, value, **kwargs):
        # full-buffer upload: replayable, so transient failures retry
        return self._retried(
            "object_store.put", lambda: self.target.pipe_file(path, value, **kwargs)
        )

    def rm_file(self, path):
        return self.target.rm_file(path)

    def rm(self, path, recursive=False, **kwargs):
        return self.target.rm(path, recursive=recursive, **kwargs)

    def makedirs(self, path, exist_ok=False):
        return self.target.makedirs(path, exist_ok=exist_ok)

    def mkdir(self, path, **kwargs):
        return self.target.mkdir(path, **kwargs)

    def mv(self, path1, path2, **kwargs):
        return self.target.mv(path1, path2, **kwargs)

    def touch(self, path, **kwargs):
        return self.target.touch(path, **kwargs)


def _store_retry_policy() -> RetryPolicy:
    """The object-store read policy: ``LAKESOUL_RETRY_*`` env family with a
    store-appropriate default shape (3 attempts, 50 ms base, 2 s cap)."""
    return RetryPolicy.from_env()


def filesystem_for(path: str, storage_options: dict | None = None, *, write: bool = False):
    """Resolve (fs, normalized_path) for a file or directory path.

    Remote paths are wrapped in :class:`ResilientFileSystem` (transient
    failures retried, chaos fault points armed).  When
    ``storage_options['lakesoul.cache_dir']`` is set and the path is
    remote, reads are additionally served through the bounded read-through
    page cache — stacked ABOVE the retry wrapper, so cache misses and
    readahead fetches inherit the retries.  Optional knobs:
    ``lakesoul.cache_max_bytes`` (default 10 GiB) and
    ``lakesoul.cache_page_bytes`` (default 4 MiB)."""
    own, opts = _split_options(storage_options)
    cache_dir = own.get(OPTION_CACHE_DIR)
    protocol = fsspec.core.split_protocol(path)[0] or "file"
    fs, p = fsspec.core.url_to_fs(path, **_scope_options(opts, protocol))
    if protocol not in OPTION_CACHE_DISABLED_PROTOCOLS:
        policy = _store_retry_policy()
        if policy.max_attempts > 1 or faults.active():
            fs = ResilientFileSystem(fs, policy)
    elif faults.active():
        # LOCAL filesystems stay unwrapped in production (no network to
        # retry), but a chaos run on a shared local warehouse — the
        # multi-process freshness harness — must exercise the REAL
        # object_store.* fault points and the real retry path, so the
        # wrapper arms whenever faults are installed
        fs = ResilientFileSystem(fs, _store_retry_policy())
    if cache_dir and not write and protocol not in OPTION_CACHE_DISABLED_PROTOCOLS:
        from lakesoul_tpu_torch.io.page_cache import CachedReadFileSystem, get_cache

        cache = get_cache(
            cache_dir,
            own.get(OPTION_CACHE_MAX_BYTES),
            own.get(OPTION_CACHE_PAGE_BYTES),
            readahead_pages=own.get(OPTION_CACHE_READAHEAD),
        )
        return CachedReadFileSystem(fs, cache), p
    return fs, p


def cache_stats(storage_options: dict | None = None) -> dict:
    """Page-cache statistics: hits/misses/bytes/evictions/hit_rate plus the
    current footprint (reference: cache/stats.rs)."""
    own, _ = _split_options(storage_options)
    cache_dir = own.get(OPTION_CACHE_DIR)
    if not cache_dir:
        # same shape as an enabled cache so monitoring code never branches
        return {
            "hits": 0,
            "misses": 0,
            "hit_bytes": 0,
            "miss_bytes": 0,
            "evictions": 0,
            "hit_rate": 0.0,
            "pages": 0,
            "bytes": 0,
            "max_bytes": 0,
        }
    from lakesoul_tpu_torch.io.page_cache import get_cache

    cache = get_cache(
        cache_dir,
        own.get(OPTION_CACHE_MAX_BYTES),
        own.get(OPTION_CACHE_PAGE_BYTES),
    )
    return cache.snapshot()


def ensure_dir(path: str, storage_options: dict | None = None) -> None:
    fs, p = filesystem_for(path, storage_options, write=True)
    if isinstance(fs, fsspec.implementations.local.LocalFileSystem):
        os.makedirs(p, exist_ok=True)
    else:
        try:
            fs.makedirs(p, exist_ok=True)
        except Exception:
            pass  # object stores have no real directories


def delete_file(path: str, storage_options: dict | None = None, missing_ok: bool = True) -> None:
    fs, p = filesystem_for(path, storage_options, write=True)
    try:
        fs.rm_file(p)
    except FileNotFoundError:
        if not missing_ok:
            raise


def file_size(path: str, storage_options: dict | None = None) -> int:
    fs, p = filesystem_for(path, storage_options)
    return fs.size(p)


def exists(path: str, storage_options: dict | None = None) -> bool:
    fs, p = filesystem_for(path, storage_options)
    return fs.exists(p)
