"""Owned disk page cache: bounded, read-through, instrumented.

The reference caches remote objects on local disk in 16 KiB pages behind a
moka-managed weight/eviction policy with hit/miss statistics
(rust/lakesoul-io/src/cache/disk_cache.rs:92, cache/read_through.rs:23,
cache/stats.rs).  This is the same design owned end-to-end in the framework
(in place of fsspec's blockcache pass-through): ranged reads are served
page-by-page from a local directory, misses fetch coalesced page runs from
the backing store with ONE ranged GET, and an LRU index bounded by
``max_bytes`` evicts page files.  Lakehouse data files are immutable (every
commit writes new names), so pages never need invalidation.

Pages default to 4 MiB — object-store GET latency dominates at 16 KiB; the
reference's page size tunes for local SSD pread, ours for GCS/S3 range
requests feeding parquet column chunks.

Readahead: ``LAKESOUL_CACHE_READAHEAD_PAGES=N`` (or the ``readahead_pages``
constructor knob) prefetches the N pages following every ranged read on the
shared runtime worker pool — sequential parquet column-chunk scans then find
page k+1 already local when they ask for it.  Prefetches are best-effort
(failures are swallowed), deduplicated while in flight, and counted in the
``readahead_pages`` stat instead of hits/misses.  A failed prefetch backs
the object off for ``LAKESOUL_RETRY_READAHEAD_BACKOFF_S`` (default 30 s —
part of the shared resilience policy config, runtime/resilience.py; the
``readahead_backoff_s`` constructor knob overrides per cache).

Miss fetches ride the object-store retry policy: when ``filesystem_for``
handed us a :class:`~lakesoul_tpu_torch.io.object_store.ResilientFileSystem`
target the retries live there; a raw target gets the same policy applied
here, so direct constructions (tests, embedders) behave identically.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field

from fsspec.spec import AbstractBufferedFile, AbstractFileSystem

from lakesoul_tpu_torch.obs import registry

logger = logging.getLogger(__name__)

DEFAULT_PAGE_BYTES = 4 << 20
DEFAULT_MAX_BYTES = 10 << 30


def _default_readahead() -> int:
    raw = os.environ.get("LAKESOUL_CACHE_READAHEAD_PAGES", "").strip()
    try:
        return max(0, int(raw)) if raw else 0
    except ValueError:
        return 0

# every live cache instance, aggregated into the shared obs registry as
# lakesoul_cache_* series (one process = one cache fleet; per-dir splits stay
# available via DiskPageCache.snapshot())
_INSTANCES: "weakref.WeakSet[DiskPageCache]" = weakref.WeakSet()

_CACHE_SERIES = (
    ("lakesoul_cache_hits_total", "counter", "hits"),
    ("lakesoul_cache_misses_total", "counter", "misses"),
    ("lakesoul_cache_hit_bytes_total", "counter", "hit_bytes"),
    ("lakesoul_cache_miss_bytes_total", "counter", "miss_bytes"),
    ("lakesoul_cache_evictions_total", "counter", "evictions"),
    ("lakesoul_cache_readahead_pages_total", "counter", "readahead_pages"),
    ("lakesoul_cache_pages", "gauge", "pages"),
    ("lakesoul_cache_bytes", "gauge", "bytes"),
    ("lakesoul_cache_max_bytes", "gauge", "max_bytes"),
)

_COUNTER_FIELDS = tuple(f for _, kind, f in _CACHE_SERIES if kind == "counter")

# lifetime counters of GC'd caches: the exposed *_total series must stay
# monotonic across cache churn (gauges correctly drop with the instance)
_RETIRED: dict[str, int] = {}
_RETIRED_LOCK = threading.Lock()


def _retire_cache(stats: "CacheStats") -> None:
    snap = stats.snapshot()
    with _RETIRED_LOCK:
        for k in _COUNTER_FIELDS:
            _RETIRED[k] = _RETIRED.get(k, 0) + snap.get(k, 0)


def registry_cache_stats() -> dict:
    """Aggregate page-cache counters across every cache in the process
    (live + retired), in the same shape as ``DiskPageCache.snapshot()`` —
    the registry-backed source for console ``cache-stats`` and
    ``/metrics``."""
    agg = dict.fromkeys((field for _, _, field in _CACHE_SERIES), 0)
    with _RETIRED_LOCK:
        for k in _COUNTER_FIELDS:
            agg[k] += _RETIRED.get(k, 0)
    for cache in list(_INSTANCES):
        snap = cache.snapshot()
        for k in agg:
            agg[k] += snap.get(k, 0)
    total = agg["hits"] + agg["misses"]
    agg["hit_rate"] = (agg["hits"] / total) if total else 0.0
    return agg


def _collect_caches() -> list:
    agg = registry_cache_stats()
    return [(name, kind, agg[field], {}) for name, kind, field in _CACHE_SERIES]


@dataclass
class CacheStats:
    """Counters surfaced via cache_stats() (reference: cache/stats.rs)."""

    hits: int = 0
    misses: int = 0
    hit_bytes: int = 0
    miss_bytes: int = 0
    evictions: int = 0
    readahead_pages: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record_hit(self, nbytes: int) -> None:
        with self._lock:
            self.hits += 1
            self.hit_bytes += nbytes

    def record_miss(self, nbytes: int) -> None:
        with self._lock:
            self.misses += 1
            self.miss_bytes += nbytes

    def record_eviction(self, n: int = 1) -> None:
        with self._lock:
            self.evictions += n

    def record_readahead(self, n: int = 1) -> None:
        with self._lock:
            self.readahead_pages += n

    def snapshot(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "hits": self.hits,
                "misses": self.misses,
                "hit_bytes": self.hit_bytes,
                "miss_bytes": self.miss_bytes,
                "evictions": self.evictions,
                "readahead_pages": self.readahead_pages,
                "hit_rate": (self.hits / total) if total else 0.0,
            }


class DiskPageCache:
    """Page-granular LRU cache of remote object ranges on local disk.

    One file per page under ``cache_dir/<sha1(path)>/<page_index>``; an
    in-memory LRU index enforces ``max_bytes`` (rebuilt from disk mtimes on
    restart, so a long-lived cache survives process churn).  The directory
    records its page size in a ``.page_bytes`` marker: reopening with a
    different configured page size adopts the on-disk value — page indices
    are only meaningful at the size the pages were written with.

    Sharing one directory across processes is safe for correctness (pages
    are immutable, written atomically, and a file deleted under us is a
    clean miss) but the byte bound is accounted per process — prefer a
    per-process cache_dir when several loaders run on one host."""

    def __init__(
        self,
        cache_dir: str,
        *,
        max_bytes: int = DEFAULT_MAX_BYTES,
        page_bytes: int = DEFAULT_PAGE_BYTES,
        readahead_pages: int | None = None,
        readahead_backoff_s: float | None = None,
    ):
        from lakesoul_tpu_torch.runtime.resilience import default_readahead_backoff_s

        self.cache_dir = str(cache_dir)
        self.max_bytes = int(max_bytes)
        self.readahead_pages = (
            _default_readahead() if readahead_pages is None else max(0, int(readahead_pages))
        )
        self.readahead_backoff_s = (
            default_readahead_backoff_s()
            if readahead_backoff_s is None
            else max(0.0, float(readahead_backoff_s))
        )
        self.stats = CacheStats()
        self._lock = threading.Lock()
        self._index: OrderedDict[tuple[str, int], int] = OrderedDict()
        self._inflight: set[tuple[str, int]] = set()  # readahead dedup
        # first page index known to be at/past EOF per object: readahead
        # clamps to it so a file's tail doesn't trigger a doomed past-EOF
        # GET on every read.  LRU-bounded — a long-lived server scanning
        # millions of objects must not grow it forever.
        self._eof_page: "OrderedDict[str, int]" = OrderedDict()
        # transient readahead failures back off per object (monotonic
        # retry-after) instead of permanently disabling the feature
        self._ra_backoff: dict[str, float] = {}
        self._bytes = 0
        os.makedirs(self.cache_dir, exist_ok=True)
        self.page_bytes = self._pin_page_bytes(int(page_bytes))
        self._rebuild_index()
        from lakesoul_tpu_torch.obs import registry

        _INSTANCES.add(self)
        # finalizer holds only the stats object, not the cache: final
        # counter totals survive this instance's GC
        weakref.finalize(self, _retire_cache, self.stats)
        registry().register_collector(_collect_caches)  # idempotent

    def _pin_page_bytes(self, requested: int) -> int:
        """First opener writes the marker; later openers must use the on-disk
        page size or indices would map to wrong byte ranges (silent
        corruption)."""
        marker = os.path.join(self.cache_dir, ".page_bytes")
        try:
            with open(marker, "x") as f:
                f.write(str(requested))
            return requested
        except FileExistsError:
            with open(marker) as f:
                on_disk = int(f.read().strip() or requested)
            if on_disk != requested:
                logger.warning(
                    "cache dir %s holds %d-byte pages; ignoring requested page size %d",
                    self.cache_dir,
                    on_disk,
                    requested,
                )
            return on_disk

    # ------------------------------------------------------------------ index
    def _rebuild_index(self) -> None:
        entries = []
        for key_dir in os.listdir(self.cache_dir):
            d = os.path.join(self.cache_dir, key_dir)
            if not os.path.isdir(d):
                continue
            for name in os.listdir(d):
                try:
                    idx = int(name)
                except ValueError:
                    continue
                p = os.path.join(d, name)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                entries.append((st.st_mtime, key_dir, idx, st.st_size))
        entries.sort()  # oldest first → least recently used at the front
        with self._lock:
            # only ever called during __init__ today, but the index/byte
            # accounting invariant is "mutated under _lock" everywhere else;
            # holding it here keeps that machine-checkable (shared-state-race)
            for _, key, idx, size in entries:
                self._index[(key, idx)] = size
                self._bytes += size

    @staticmethod
    def _key(path: str) -> str:
        return hashlib.sha1(path.encode()).hexdigest()

    def _page_path(self, key: str, idx: int) -> str:
        return os.path.join(self.cache_dir, key, str(idx))

    # ------------------------------------------------------------------- read
    def read_range(self, target_fs, path: str, start: int, end: int) -> bytes:
        """Bytes [start, end) of ``path``, read through the cache.  Misses on
        consecutive pages coalesce into one ranged GET against the target."""
        if end <= start:
            return b""
        pb = self.page_bytes
        key = self._key(path)
        first, last = start // pb, (end - 1) // pb
        pages: dict[int, bytes] = {}
        missing: list[int] = []
        for idx in range(first, last + 1):
            data = self._load_page(key, idx)
            if data is None:
                missing.append(idx)
            else:
                pages[idx] = data
                self.stats.record_hit(len(data))
        # coalesce runs of consecutive missing pages → one GET each
        run: list[int] = []
        for idx in missing + [None]:  # type: ignore[list-item]
            if run and (idx is None or idx != run[-1] + 1):
                blob = self._fetch(target_fs, path, run[0] * pb, (run[-1] + 1) * pb)
                self.stats.record_miss(len(blob))
                for j, pidx in enumerate(run):
                    page = blob[j * pb : (j + 1) * pb]
                    pages[pidx] = page
                    self._store_page(key, pidx, page)
                run = []
            if idx is not None:
                run.append(idx)
        if logger.isEnabledFor(logging.DEBUG):
            logger.debug(
                "page cache read %s [%d,%d): %d hit / %d miss pages",
                path,
                start,
                end,
                (last - first + 1) - len(missing),
                len(missing),
            )
        if self.readahead_pages:
            self._schedule_readahead(target_fs, path, key, last + 1)
        blob = b"".join(pages[i] for i in range(first, last + 1))
        lo = start - first * pb
        return blob[lo : lo + (end - start)]

    def _fetch(self, target_fs, path: str, start: int, end: int) -> bytes:
        """One coalesced miss GET, armed as the ``page_cache.fetch`` chaos
        point.  A :class:`~lakesoul_tpu_torch.io.object_store.ResilientFileSystem`
        target already retries transients itself; a raw target gets the
        same shared policy here so both constructions behave identically."""
        from lakesoul_tpu_torch.io.object_store import ResilientFileSystem
        from lakesoul_tpu_torch.runtime import faults
        from lakesoul_tpu_torch.runtime.resilience import RetryPolicy

        if isinstance(target_fs, ResilientFileSystem):
            # the wrapped fs owns retries for real I/O; only the cache's own
            # chaos point needs policy cover here (never stacked, so a
            # `page_cache.fetch` fault is absorbed identically either way)
            RetryPolicy.from_env().run(
                lambda: faults.maybe_inject("page_cache.fetch"),
                op="page_cache.fetch",
            )
            return target_fs.cat_file(path, start=start, end=end)

        def attempt():
            faults.maybe_inject("page_cache.fetch")
            return target_fs.cat_file(path, start=start, end=end)

        return RetryPolicy.from_env().run(attempt, op="page_cache.fetch")

    # -------------------------------------------------------------- readahead
    def _schedule_readahead(self, target_fs, path: str, key: str, first: int) -> None:
        """Queue the ``readahead_pages`` pages after a read onto the shared
        runtime pool (best-effort, deduped while in flight) so a sequential
        scan's next request is already local."""
        want: list[int] = []
        with self._lock:
            if self._ra_backoff.get(key, 0.0) > time.monotonic():
                return  # recent fetch failure: give this object a breather
            stop = min(
                first + self.readahead_pages, self._eof_page.get(key, 1 << 62)
            )
            for idx in range(first, stop):
                k = (key, idx)
                if k in self._index or k in self._inflight:
                    # stop at the first already-covered page: `want` must be
                    # CONSECUTIVE — _readahead_run slices its single
                    # coalesced GET by position, so a gap would store the
                    # wrong bytes under later page indexes
                    break
                self._inflight.add(k)
                want.append(idx)
        if not want:
            return
        from lakesoul_tpu_torch.runtime import get_pool

        registry().gauge("lakesoul_cache_readahead_inflight").inc(len(want))
        try:
            fut = get_pool().submit(self._readahead_run, target_fs, path, key, want)
        except RuntimeError:
            # raced a pool shutdown: the read itself must still succeed
            # ("a failed prefetch must never surface") and the dedup
            # entries must be released or these pages never prefetch again
            with self._lock:
                self._inflight.difference_update((key, i) for i in want)
            registry().gauge("lakesoul_cache_readahead_inflight").dec(len(want))
            return

        def _cleanup_if_cancelled(f) -> None:
            # a pool shutdown (shutdown_pool between bench legs, tests) can
            # cancel the task before it runs: its finally never fires, so
            # the dedup entries and gauge must be released here or these
            # pages would never prefetch again
            if f.cancelled():
                with self._lock:
                    self._inflight.difference_update((key, i) for i in want)
                registry().gauge("lakesoul_cache_readahead_inflight").dec(len(want))

        fut.add_done_callback(_cleanup_if_cancelled)

    def _note_eof(self, key: str, idx: int) -> None:
        with self._lock:
            self._eof_page[key] = idx
            self._eof_page.move_to_end(key)
            while len(self._eof_page) > 4096:
                self._eof_page.popitem(last=False)

    def _readahead_run(self, target_fs, path: str, key: str, pages: list[int]) -> None:
        pb = self.page_bytes
        fetched = 0
        try:
            # pages are consecutive by construction: one coalesced GET
            blob = target_fs.cat_file(
                path, start=pages[0] * pb, end=(pages[-1] + 1) * pb
            )
            for j, idx in enumerate(pages):
                page = blob[j * pb : (j + 1) * pb]
                if page:  # a read past EOF yields nothing to store
                    self._store_page(key, idx, page)
                    fetched += 1
                if len(page) < pb:
                    # short/empty page = EOF reached: remember it so later
                    # reads near the tail stop scheduling doomed GETs
                    self._note_eof(key, idx + 1 if page else idx)
                    break
            with self._lock:
                self._ra_backoff.pop(key, None)
        except Exception:
            # best-effort: a failed prefetch must never surface.  The
            # failure may be transient (503, timeout) OR a store that
            # RAISES on past-EOF ranges — back off this object for a while
            # instead of retrying on every tail read or permanently
            # disabling readahead for it (direct reads are unaffected)
            with self._lock:
                self._ra_backoff[key] = time.monotonic() + self.readahead_backoff_s
                if len(self._ra_backoff) > 4096:
                    now = time.monotonic()
                    for k in [k for k, ts in self._ra_backoff.items() if ts <= now]:
                        del self._ra_backoff[k]
        finally:
            with self._lock:
                self._inflight.difference_update((key, i) for i in pages)
            registry().gauge("lakesoul_cache_readahead_inflight").dec(len(pages))
            if fetched:
                self.stats.record_readahead(fetched)

    def _load_page(self, key: str, idx: int) -> bytes | None:
        with self._lock:
            known = (key, idx) in self._index
            if known:
                self._index.move_to_end((key, idx))
        if not known:
            return None
        try:
            with open(self._page_path(key, idx), "rb") as f:
                return f.read()
        except OSError:
            with self._lock:
                size = self._index.pop((key, idx), 0)
                self._bytes -= size
            return None

    def _store_page(self, key: str, idx: int, data: bytes) -> None:
        d = os.path.join(self.cache_dir, key)
        os.makedirs(d, exist_ok=True)
        tmp = self._page_path(key, idx) + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, self._page_path(key, idx))
        except OSError:
            return  # cache write failure must never fail the read
        with self._lock:
            prev = self._index.pop((key, idx), 0)
            self._bytes -= prev
            self._index[(key, idx)] = len(data)
            self._bytes += len(data)
            evict = []
            while self._bytes > self.max_bytes and self._index:
                k, size = self._index.popitem(last=False)
                self._bytes -= size
                evict.append(k)
        for k in evict:
            try:
                os.remove(self._page_path(*k))
            except OSError:
                pass
        if evict:
            self.stats.record_eviction(len(evict))
            logger.debug(
                "page cache evicted %d pages (bound %d bytes)", len(evict), self.max_bytes
            )

    # ------------------------------------------------------------------ admin
    def current_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def snapshot(self) -> dict:
        out = self.stats.snapshot()
        with self._lock:
            out["pages"] = len(self._index)
            out["bytes"] = self._bytes
            out["max_bytes"] = self.max_bytes
        return out


# ONE cache instance per directory: two instances over the same pages would
# run independent LRU accounting (evicting files the other still counts) and
# split the stats.  First caller's knobs win; later different knobs only
# retune max_bytes (page size must match the files already on disk).
_CACHES: dict[str, DiskPageCache] = {}
_CACHES_LOCK = threading.Lock()


def get_cache(
    cache_dir: str,
    max_bytes: int | None = None,
    page_bytes: int | None = None,
    *,
    readahead_pages: int | None = None,
) -> DiskPageCache:
    """max_bytes/page_bytes apply on first construction; an explicit
    max_bytes or readahead_pages on a later call retunes the knob (None
    leaves it alone)."""
    key = str(cache_dir)
    with _CACHES_LOCK:
        cache = _CACHES.get(key)
        if cache is None:
            # construction must stay under _CACHES_LOCK: the one-instance-
            # per-directory invariant is load-bearing (a racing throwaway
            # instance would register in _INSTANCES and double-count the
            # metrics collector until GC).  The work inside is a bounded
            # local-disk scan + marker open — it never touches the worker
            # pool, so the nested-pool deadlock class does not apply.
            cache = DiskPageCache(  # lakelint: ignore[transitive-lock-held-call] singleton construction: bounded local-disk scan under the registry lock, no pool interaction
                key,
                max_bytes=int(max_bytes) if max_bytes is not None else DEFAULT_MAX_BYTES,
                page_bytes=int(page_bytes) if page_bytes is not None else DEFAULT_PAGE_BYTES,
                readahead_pages=readahead_pages,
            )
            _CACHES[key] = cache
        else:
            if max_bytes is not None:
                cache.max_bytes = int(max_bytes)
            if readahead_pages is not None:
                cache.readahead_pages = max(0, int(readahead_pages))
        return cache


class _CachedFile(AbstractBufferedFile):
    def _fetch_range(self, start: int, end: int) -> bytes:
        fs: CachedReadFileSystem = self.fs
        return fs.cache.read_range(fs.target, self.path, start, min(end, self.size))


class CachedReadFileSystem(AbstractFileSystem):
    """Read-only fsspec filesystem routing ranged reads of an inner
    filesystem through a DiskPageCache (reference: ReadThroughCache,
    cache/read_through.rs:23).  Metadata ops delegate to the target."""

    protocol = "lscache"

    def __init__(self, target_fs, cache: DiskPageCache, **kwargs):
        super().__init__(**kwargs)
        self.target = target_fs
        self.cache = cache

    # ---------------------------------------------------------- delegation
    def info(self, path, **kwargs):
        return self.target.info(path, **kwargs)

    def ls(self, path, detail=True, **kwargs):
        return self.target.ls(path, detail=detail, **kwargs)

    def exists(self, path, **kwargs):
        return self.target.exists(path, **kwargs)

    def size(self, path):
        return self.target.size(path)

    def isfile(self, path):
        return self.target.isfile(path)

    def isdir(self, path):
        return self.target.isdir(path)

    def glob(self, path, **kwargs):
        return self.target.glob(path, **kwargs)

    def _open(self, path, mode="rb", block_size=None, **kwargs):
        if mode != "rb":
            raise NotImplementedError("CachedReadFileSystem is read-only")
        # cache_type="none": AbstractBufferedFile's own readahead cache would
        # double-buffer what the page cache already holds
        return _CachedFile(
            self,
            path,
            mode=mode,
            block_size=self.cache.page_bytes,
            cache_type="none",
            size=self.target.size(path),
            **kwargs,
        )
