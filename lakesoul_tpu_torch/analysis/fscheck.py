"""Runtime crash-prefix replay for publications (opt-in: ``LAKESOUL_FSCHECK=1``).

The port of ``lakesoul_tpu/analysis/fscheck.py``: the same artifact
patterns and protocol checks, with this package's readers.

The static durability rules (rules/durability.py) prove every publication
*routes through* runtime/atomicio; this half proves the protocol itself is
crash-safe.  :func:`enable` interposes ``builtins.open`` (write modes),
``os.fsync``, ``os.replace``/``os.rename``, ``os.unlink``/``os.remove``
and ``os.open`` (directory fsync tracking) and records a per-artifact
persisted-ops trace for every warehouse/spool publication path — spool
segments + sidecars, session manifests, obs fleet docs, spill segments +
CRC sidecars, vector/plane store blobs and pointers, oracle docs.  Paths
are classified by artifact *shape* (basename patterns, tmp suffixes
stripped), not by watched roots, so unrelated IO (sqlite journals, test
scratch) stays untraced.

:func:`replay` is the ALICE-style harness (Pillai et al., OSDI'14): for
every prefix of the recorded op sequence it materializes the crashed
filesystem state in a scratch dir — only fsynced bytes survive; a rename
applies atomically in order; bytes written but never fsynced materialize
as missing/empty/half-written variants — then runs the REAL readers
(session manifest parse, spool range consistency, obs aggregator merge,
manifest-store pointer chase, ``AnnPlane.open``, spill CRC verification)
and asserts each sees an old-complete or new-complete state, never a torn
one.  ``AnnPlane.open`` loads a plane onto a device, so :func:`replay`
takes an explicit ``device`` and passes it on: ``None`` is the card, as
everywhere in this package, and a replay that must open a plane raises
:class:`~lakesoul_tpu_torch.errors.ConfigError` without one instead of
falling back to the CPU.  Two online checks mirror the static rules under real dynamics:
a rename of a never-fsynced artifact, and a CRC sidecar landing before
its data is durable.

Violations are *recorded* (the producing op's stack + the failing reader
+ the offending prefix), never raised — the data path must not change
behavior under instrumentation; the armed suite's fixture
(:func:`analysis.arm.armed`) fails the test at teardown, exactly like
lockgraph/racecheck.
"""

from __future__ import annotations

import builtins
import json
import os
import re
import shutil
import tempfile
import threading
import traceback
import zlib
from dataclasses import dataclass, field

__all__ = [
    "Artifact",
    "FsOp",
    "Violation",
    "classify",
    "enable",
    "disable",
    "reset",
    "violations",
    "enabled",
    "env_requested",
    "ops",
    "replay",
    "untraced",
    "watch",
]

_ENV = "LAKESOUL_FSCHECK"

# originals captured at import: the detector's own IO must never recurse
# through the wrappers
_REAL_OPEN = builtins.open
_REAL_OS_OPEN = os.open
_REAL_FSYNC = os.fsync
_REAL_REPLACE = os.replace
_REAL_RENAME = os.rename
_REAL_UNLINK = os.unlink
_REAL_REMOVE = os.remove

# ``<name>.tmp-<holder>`` (atomicio/spool/obs) and bare ``<name>.tmp``
_TMP_RE = re.compile(r"\.tmp(-[^/]*)?$")

# artifact shapes, matched against the tmp-stripped basename.  Order
# matters: first match wins (the spill CRC must beat the generic json).
_PATTERNS: "tuple[tuple[str, re.Pattern], ...]" = (
    ("spill-crc", re.compile(r"^range-\d+\.arrow\.crc$")),
    ("range-segment", re.compile(r"^range-\d+\.arrow$")),
    ("range-sidecar", re.compile(r"^range-\d+\.json$")),
    ("session-manifest", re.compile(r"^manifest\.json$")),
    ("obs-doc", re.compile(r"^(member|recorder)-.+\.json$")),
    ("store-pointer", re.compile(r"^(LATEST|PLANE)$")),
    ("store-record", re.compile(r"^(manifest-\d+[^/]*\.json|plane-\d+-\d+c?\.json)$")),
    ("store-segment", re.compile(r"^cluster_\d+[^/]*\.seg$")),
    ("spill-probe", re.compile(r"^probe-.+\.json$")),
    ("json-doc", re.compile(r"^(oracle|follower)[^/]*\.json$")),
)

# store blobs live one level under the store root (manifests/, plane/,
# segments/); everything else replays against its own directory
_NESTED_DIRS = {"manifests", "plane", "segments"}


@dataclass(frozen=True)
class Artifact:
    kind: str
    path: str  # final (tmp-stripped) absolute path
    root: str  # the directory the replay readers run against


@dataclass(frozen=True)
class FsOp:
    kind: str  # "write" | "fsync" | "replace" | "unlink" | "fsyncdir"
    path: str  # as-issued absolute path (tmp names retained)
    dst: "str | None"  # replace/rename target
    data: "bytes | None"  # durable (fsync) or rename-time content
    stack: str


@dataclass
class Violation:
    kind: str  # "torn-state" | "unfsynced-rename" | "barrier-before-data"
    message: str
    stacks: "tuple[str, ...]" = ()
    prefix: int = 0  # offending op index (1-based; 0 = online check)

    def render(self) -> str:
        out = [f"[{self.kind}] {self.message}"]
        for s in self.stacks:
            out.append(s.rstrip())
        return "\n".join(out)


def strip_tmp(path: str) -> "tuple[str, bool]":
    final, n = _TMP_RE.subn("", path)
    return final, bool(n)


def classify(path: str) -> "Artifact | None":
    """The publication artifact a path belongs to, or None for unrelated
    IO.  Tmp suffixes are stripped first, so staged files trace to their
    final artifact."""
    final, _ = strip_tmp(os.path.abspath(path))
    base = os.path.basename(final)
    for kind, pat in _PATTERNS:
        if pat.match(base):
            parent = os.path.dirname(final)
            root = parent
            if kind in ("store-record", "store-segment") and (
                os.path.basename(parent) in _NESTED_DIRS
            ):
                root = os.path.dirname(parent)
            return Artifact(kind, final, root)
    return None


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.enabled = False
        self.ops: list[FsOp] = []
        self.fd_paths: dict[int, str] = {}  # write fds of traced files
        self.dir_fds: dict[int, str] = {}  # os.open'd directories
        self.pre: dict[str, "bytes | None"] = {}  # first-touch snapshots
        self.violations: list[Violation] = []
        self.reported: set = set()


_STATE = _State()
_TLS = threading.local()


def _suppressed() -> bool:
    return bool(getattr(_TLS, "suppress", False))


class _suppress:
    def __enter__(self):
        self._prev = getattr(_TLS, "suppress", False)
        _TLS.suppress = True
        return self

    def __exit__(self, *exc):
        _TLS.suppress = self._prev
        return False


def untraced():
    """``with untraced():`` — this thread's IO inside is not traced.  For a
    test's deliberately torn fixtures, written to prove a reader skips
    them: they are not publications, and replaying them would only report
    the garbage the test wrote on purpose."""
    return _suppress()


def _stack_summary() -> str:
    frames = [
        fr
        for fr in traceback.extract_stack()
        if "lakesoul_tpu_torch/analysis/fscheck" not in fr.filename.replace("\\", "/")
    ]
    return "\n".join(
        f"  {fr.filename}:{fr.lineno} in {fr.name}" for fr in frames[-8:]
    )


def _read_disk(path: str) -> "bytes | None":
    try:
        with _REAL_OPEN(path, "rb") as f:
            return f.read()
    except OSError:
        return None


def _snapshot_pre(path: str) -> None:
    final, _ = strip_tmp(path)
    if final not in _STATE.pre:
        _STATE.pre[final] = _read_disk(final)


def _record(op: FsOp) -> None:
    with _STATE.lock:
        _STATE.ops.append(op)


def _tracing(path) -> "str | None":
    """abspath(path) when tracing should record it, else None."""
    if not _STATE.enabled or _suppressed():
        return None
    if not isinstance(path, (str, os.PathLike)):
        return None
    try:
        p = os.path.abspath(os.fspath(path))
    except (TypeError, ValueError):
        return None
    return p if classify(p) is not None else None


def _add_violation(kind: str, message: str, stacks: tuple, key, prefix: int = 0) -> None:
    with _STATE.lock:
        if key in _STATE.reported:
            return
        _STATE.reported.add(key)
        _STATE.violations.append(Violation(kind, message, stacks, prefix))


# ------------------------------------------------------------ interposition


def _mode_writes(mode) -> bool:
    return isinstance(mode, str) and any(c in mode for c in "wxa")


def _wrapped_open(file, *args, **kwargs):
    mode = kwargs.get("mode", args[0] if args else "r")
    if _mode_writes(mode):
        p = _tracing(file)
        if p is not None:
            try:
                _snapshot_pre(p)
            except Exception:
                pass
            f = _REAL_OPEN(file, *args, **kwargs)
            try:
                _STATE.fd_paths[f.fileno()] = p
                _record(FsOp("write", p, None, None, _stack_summary()))
            except Exception:
                pass
            return f
    return _REAL_OPEN(file, *args, **kwargs)


def _fd_matches(fd: int, path: str) -> bool:
    try:
        return os.fstat(fd).st_ino == os.stat(path).st_ino
    except OSError:
        return False


def _wrapped_fsync(fd):
    _REAL_FSYNC(fd)
    if not _STATE.enabled or _suppressed():
        return
    try:
        p = _STATE.fd_paths.get(fd)
        if p is not None:
            if _fd_matches(fd, p):
                _record(FsOp("fsync", p, None, _read_disk(p), _stack_summary()))
                return
            _STATE.fd_paths.pop(fd, None)  # stale entry: the fd was reused
        d = _STATE.dir_fds.get(fd)
        if d is not None:
            if _fd_matches(fd, d):
                _record(FsOp("fsyncdir", d, None, None, _stack_summary()))
            else:
                _STATE.dir_fds.pop(fd, None)
    except Exception:
        pass


def _durable_in_trace(path: str) -> bool:
    """Does the trace (or the pre-existing tree) make ``path``'s bytes
    durable-or-published: an fsync on it, a rename landing on it, or no
    trace ops at all while the file exists on disk."""
    touched = False
    ok = False
    with _STATE.lock:
        snapshot = list(_STATE.ops)
    for op in snapshot:
        if op.path == path or op.dst == path:
            touched = True
            if op.kind == "fsync" and op.path == path:
                ok = True
            elif op.kind == "replace" and op.dst == path:
                ok = True
            elif op.kind in ("write", "unlink") and op.path == path:
                ok = False
    if not touched:
        return os.path.exists(path)
    return ok


def _rename_common(src, dst, real):
    psrc = _tracing(src)
    pdst = _tracing(dst)
    if psrc is None and pdst is None:
        return real(src, dst)
    try:
        if pdst is not None:
            _snapshot_pre(pdst)
        rp = psrc or os.path.abspath(os.fspath(src))
        data = _read_disk(rp)
        # online check 1: renaming bytes this trace wrote but never fsynced
        wrote = fsynced = False
        with _STATE.lock:
            for op in _STATE.ops:
                if op.path == rp:
                    if op.kind == "write":
                        wrote = True
                    elif op.kind == "fsync":
                        fsynced = True
        stack = _stack_summary()
    except Exception:
        real(src, dst)
        return
    real(src, dst)
    try:
        rdst = pdst or os.path.abspath(os.fspath(dst))
        _record(FsOp("replace", rp, rdst, data, stack))
        if wrote and not fsynced:
            _add_violation(
                "unfsynced-rename",
                f"rename of {rp} published bytes the producing flow never "
                "fsynced — a host crash can land the final name on an "
                "empty inode",
                (stack,),
                ("unfsynced", rp, rdst),
            )
        # online check 2: a CRC sidecar is a barrier — its data must be
        # durable before the sidecar name exists
        art = classify(rdst)
        if art is not None and art.kind == "spill-crc":
            data_path = art.path[: -len(".crc")]
            if not _durable_in_trace(data_path):
                _add_violation(
                    "barrier-before-data",
                    f"CRC sidecar {rdst} published before its data "
                    f"{data_path} is durable — a crash between the two "
                    "leaves a barrier naming bytes that never landed",
                    (stack,),
                    ("barrier", rdst),
                )
    except Exception:
        pass


def _wrapped_replace(src, dst, *, src_dir_fd=None, dst_dir_fd=None):
    if src_dir_fd is not None or dst_dir_fd is not None:
        return _REAL_REPLACE(src, dst, src_dir_fd=src_dir_fd, dst_dir_fd=dst_dir_fd)
    return _rename_common(src, dst, _REAL_REPLACE)


def _wrapped_rename(src, dst, *, src_dir_fd=None, dst_dir_fd=None):
    if src_dir_fd is not None or dst_dir_fd is not None:
        return _REAL_RENAME(src, dst, src_dir_fd=src_dir_fd, dst_dir_fd=dst_dir_fd)
    return _rename_common(src, dst, _REAL_RENAME)


def _unlink_common(path, real):
    p = _tracing(path)
    if p is None:
        return real(path)
    try:
        _snapshot_pre(p)
        stack = _stack_summary()
    except Exception:
        return real(path)
    real(path)
    _record(FsOp("unlink", p, None, None, stack))


def _wrapped_unlink(path, *, dir_fd=None):
    if dir_fd is not None:
        return _REAL_UNLINK(path, dir_fd=dir_fd)
    return _unlink_common(path, _REAL_UNLINK)


def _wrapped_remove(path, *, dir_fd=None):
    if dir_fd is not None:
        return _REAL_REMOVE(path, dir_fd=dir_fd)
    return _unlink_common(path, _REAL_REMOVE)


def _wrapped_os_open(path, flags, mode=0o777, *, dir_fd=None):
    if dir_fd is not None:
        return _REAL_OS_OPEN(path, flags, mode, dir_fd=dir_fd)
    fd = _REAL_OS_OPEN(path, flags, mode)
    if _STATE.enabled and not _suppressed():
        try:
            p = os.path.abspath(os.fspath(path))
            if os.path.isdir(p):
                _STATE.dir_fds[fd] = p
        except Exception:
            pass
    return fd


# ----------------------------------------------------------------- control


def enabled() -> bool:
    return _STATE.enabled


def env_requested() -> bool:
    return os.environ.get(_ENV, "").strip() == "1"


def violations() -> list[Violation]:
    with _STATE.lock:
        return list(_STATE.violations)


def ops() -> list[FsOp]:
    with _STATE.lock:
        return list(_STATE.ops)


def reset() -> None:
    with _STATE.lock:
        _STATE.ops.clear()
        _STATE.fd_paths.clear()
        _STATE.dir_fds.clear()
        _STATE.pre.clear()
        _STATE.violations.clear()
        _STATE.reported.clear()


def enable() -> None:
    """Interpose the filesystem surface.  Idempotent."""
    if _STATE.enabled:
        return
    builtins.open = _wrapped_open
    os.fsync = _wrapped_fsync
    os.replace = _wrapped_replace
    os.rename = _wrapped_rename
    os.unlink = _wrapped_unlink
    os.remove = _wrapped_remove
    os.open = _wrapped_os_open
    _STATE.enabled = True


def disable() -> None:
    """Restore the real filesystem surface.  Recorded state stays for
    inspection/replay until :func:`reset`."""
    if not _STATE.enabled:
        return
    builtins.open = _REAL_OPEN
    os.fsync = _REAL_FSYNC
    os.replace = _REAL_REPLACE
    os.rename = _REAL_RENAME
    os.unlink = _REAL_UNLINK
    os.remove = _REAL_REMOVE
    os.open = _REAL_OS_OPEN
    _STATE.enabled = False


class Watch:
    def __init__(self, mark: int):
        self._mark = mark

    @property
    def violations(self) -> list[Violation]:
        return violations()[self._mark:]


class watch:
    """``with watch() as w:`` — enable for the block; call :func:`replay`
    (before or after exit) and inspect ``w.violations``."""

    def __enter__(self) -> Watch:
        self._was_enabled = _STATE.enabled
        enable()
        return Watch(len(violations()))

    def __exit__(self, *exc):
        if not self._was_enabled:
            disable()
        return False


# ------------------------------------------------------------------- replay

# crash-state entries: ("durable", bytes) | ("torn", bytes|None) | ("absent",)
_ABSENT = ("absent", None)


def _simulate(ops_prefix: "list[FsOp]") -> "dict[str, tuple]":
    """Persisted state after a crash at the end of ``ops_prefix``: only
    fsynced bytes are guaranteed; metadata ops (rename/unlink) apply in
    order; written-but-unfsynced content is torn."""
    state: dict[str, tuple] = {}
    for path, pre in _STATE.pre.items():
        state[path] = ("durable", pre) if pre is not None else _ABSENT
    for op in ops_prefix:
        if op.kind == "write":
            state[op.path] = ("torn", None)
        elif op.kind == "fsync":
            state[op.path] = ("durable", op.data)
        elif op.kind == "replace":
            entry = state.pop(op.path, None)
            if entry is None or entry[0] == "absent":
                # pre-existing source outside the trace: its bytes were
                # already durable, captured at rename time
                entry = ("durable", op.data)
            elif entry[0] == "torn":
                entry = ("torn", op.data)
            state[op.dst] = entry
        elif op.kind == "unlink":
            state[op.path] = _ABSENT
    return state


def _torn_variant(data: "bytes | None", mode: str) -> "bytes | None":
    if mode == "missing":
        return None
    if mode == "empty":
        return b""
    return (data or b"")[: max(0, len(data or b"") // 2)] or b""


def _materialize(scratch: str, root: str, state: "dict[str, tuple]", mode: str) -> None:
    """Write the crash state for every traced path under ``root`` into the
    scratch mirror (untouched live files were copied once as context)."""
    for path, entry in state.items():
        if not path.startswith(root + os.sep) and path != root:
            continue
        dst = os.path.join(scratch, os.path.relpath(path, root))
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        if os.path.lexists(dst):
            _REAL_UNLINK(dst)
        kind, data = entry[0], entry[1]
        if kind == "torn":
            data = _torn_variant(data, mode)
        if kind == "absent" or data is None:
            continue
        with _REAL_OPEN(dst, "wb") as f:
            f.write(data)


def _copy_context(root: str, scratch: str, touched: "set[str]") -> None:
    """Mirror the live tree under ``root`` minus traced paths — the stable
    context (other sessions' files, shard stores built before the watch)
    the readers may legitimately depend on."""
    for dirpath, _dirnames, filenames in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        out_dir = scratch if rel == "." else os.path.join(scratch, rel)
        os.makedirs(out_dir, exist_ok=True)
        for name in filenames:
            src = os.path.join(dirpath, name)
            if src in touched or strip_tmp(src)[0] in touched:
                continue
            dst = os.path.join(out_dir, name)
            try:
                os.link(src, dst)
            except OSError:
                try:
                    shutil.copy2(src, dst)
                except OSError:
                    pass


# ------------------------------------------------------------------ readers


def _check_json_doc(path: str) -> None:
    data = _read_disk(path)
    if data is None:
        return  # absent = old-complete
    doc = json.loads(data.decode("utf-8"))
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: torn doc (not an object)")


def _check_session_manifest(path: str) -> None:
    data = _read_disk(path)
    if data is None:
        return
    from lakesoul_tpu_torch.scanplane.session import ScanSession

    ScanSession.from_json(data.decode("utf-8"))


def _check_obs_spool(scratch: str, path: str) -> None:
    _check_json_doc(path)
    from lakesoul_tpu_torch.obs.fleet import FleetAggregator

    agg = FleetAggregator(scratch)
    agg.members()
    agg.recorders()


def _check_ranges(scratch: str, spill: bool = False) -> None:
    """Spool/spill range consistency over the whole scratch dir: a visible
    segment name implies a parseable sidecar and decodable batches; a
    visible CRC sidecar implies fully-landed, checksum-exact data.  In a
    spill prefix (``spill=True``) segments have no JSON sidecar — the CRC
    doc published LAST is their only contract, so a bare segment is just
    an unfinished upload nobody reads yet."""
    import pyarrow as pa

    for name in sorted(os.listdir(scratch)):
        full = os.path.join(scratch, name)
        if _TMP_RE.search(name):
            continue  # tmp debris: swept by the next producer, never read
        if name.endswith(".arrow.crc"):
            doc = json.loads(_read_disk(full).decode("utf-8"))
            seg = os.path.join(scratch, os.path.basename(doc["path"]))
            payload = _read_disk(seg)
            if payload is None:
                raise ValueError(f"{name}: CRC sidecar without its segment")
            if (
                zlib.crc32(payload) & 0xFFFFFFFF != int(doc["crc32"])
                or len(payload) != int(doc["nbytes"])
            ):
                raise ValueError(f"{name}: CRC mismatch on spilled segment")
        elif name.endswith(".arrow"):
            payload = _read_disk(full)
            with pa.ipc.open_file(pa.BufferReader(payload)) as reader:
                rows = sum(
                    reader.get_batch(i).num_rows
                    for i in range(reader.num_record_batches)
                )
            if spill or os.path.exists(full + ".crc"):
                continue  # spill rung: the CRC doc above is its contract
            sidecar = os.path.join(scratch, name[: -len(".arrow")] + ".json")
            side_raw = _read_disk(sidecar)
            if side_raw is None:
                raise ValueError(f"{name}: published segment without sidecar")
            side = json.loads(side_raw.decode("utf-8"))
            if int(side["rows"]) != rows:
                raise ValueError(
                    f"{name}: sidecar rows {side['rows']} != segment rows {rows}"
                )


def _check_store(scratch: str, device) -> None:
    """Pointer-chase the manifest store(s) in scratch with the real
    readers: a visible pointer must name a complete, CRC-exact record; a
    complete plane must open on ``device``."""
    from lakesoul_tpu_torch.errors import VectorIndexError
    from lakesoul_tpu_torch.vector.manifest import ManifestStore, _crc_unwrap

    if os.path.exists(os.path.join(scratch, "PLANE")):
        from lakesoul_tpu_torch.annplane.manifest import PlaneManifestStore

        manifest = PlaneManifestStore(scratch).read()
        if manifest is not None and manifest.get("complete"):
            from lakesoul_tpu_torch.annplane.search import AnnPlane

            try:
                AnnPlane.open(scratch, device=device)
            except VectorIndexError as exc:
                if "mid-build" not in str(exc) and "no ANN plane" not in str(exc):
                    raise
    if os.path.exists(os.path.join(scratch, "LATEST")):
        store = ManifestStore(scratch)
        manifest = store.read_manifest()
        for rel in manifest.get("base_segments", []):
            _crc_unwrap(store._read_blob(rel), rel)
        for entry in manifest.get("delta_segments", []):
            _crc_unwrap(store._read_blob(entry["path"]), entry["path"])


# ``kinds`` is every artifact kind the trace touched under the same replay
# root — a segment in a spill prefix (kinds include spill-crc, never
# range-sidecar) plays by the CRC-doc contract, not the spool sidecar one
_READERS = {
    "session-manifest": lambda scratch, art, kinds, device: _check_session_manifest(
        os.path.join(scratch, os.path.basename(art.path))
    ),
    "range-segment": lambda scratch, art, kinds, device: _check_ranges(
        scratch, spill="spill-crc" in kinds and "range-sidecar" not in kinds
    ),
    "range-sidecar": lambda scratch, art, kinds, device: _check_ranges(scratch),
    "spill-crc": lambda scratch, art, kinds, device: _check_ranges(scratch, spill=True),
    "obs-doc": lambda scratch, art, kinds, device: _check_obs_spool(
        scratch, os.path.join(scratch, os.path.basename(art.path))
    ),
    "store-pointer": lambda scratch, art, kinds, device: _check_store(scratch, device),
    "store-record": lambda scratch, art, kinds, device: _check_store(scratch, device),
    "store-segment": lambda scratch, art, kinds, device: _check_store(scratch, device),
    "spill-probe": lambda scratch, art, kinds, device: _check_json_doc(
        os.path.join(scratch, os.path.basename(art.path))
    ),
    "json-doc": lambda scratch, art, kinds, device: _check_json_doc(
        os.path.join(scratch, os.path.basename(art.path))
    ),
}


def _opens_a_plane(trace: "list[FsOp]") -> bool:
    """Does the replay run ``AnnPlane.open``: did the trace touch a plane
    record's pointer or record (``PLANE``, ``plane/plane-*.json``)?"""
    for op in trace:
        for p in (op.path, op.dst):
            art = classify(p) if p else None
            if art is not None and art.kind in ("store-pointer", "store-record") and \
                    os.path.basename(art.path).startswith(("PLANE", "plane-")):
                return True
    return False


def replay(tmp_root: "str | None" = None, *, device=None) -> list[Violation]:
    """Crash-prefix replay over every recorded publication: for each op
    prefix, materialize the crash state in a scratch mirror and run the
    affected artifact's real reader.  New violations are recorded (and
    returned) — never raised.  ``device`` is where ``AnnPlane.open`` loads
    a replayed plane (``None``: the card; without one a trace that touched
    a plane raises :class:`~lakesoul_tpu_torch.errors.ConfigError`)."""
    with _STATE.lock:
        trace = list(_STATE.ops)
    if not trace:
        return []
    dev = None
    if _opens_a_plane(trace):
        from lakesoul_tpu_torch.device import resolve_device

        dev = resolve_device(device)
    mark = len(violations())
    with _suppress():
        base = tempfile.mkdtemp(prefix="fscheck-", dir=tmp_root)
        try:
            _replay_into(trace, base, dev)
        finally:
            shutil.rmtree(base, ignore_errors=True)
    return violations()[mark:]


def _replay_into(trace: "list[FsOp]", base: str, device) -> None:
    # every traced path, final AND tmp form, per replay root — excluded
    # from the context mirror, defined purely by simulation
    touched: dict[str, set] = {}
    root_kinds: dict[str, set] = {}
    roots: dict[str, str] = {}  # root -> scratch dir
    for op in trace:
        for p in (op.path, op.dst):
            if p is None:
                continue
            art = classify(p)
            if art is None:
                continue
            touched.setdefault(art.root, set()).update((p, art.path))
            root_kinds.setdefault(art.root, set()).add(art.kind)
    for i, root in enumerate(sorted(touched)):
        scratch = os.path.join(base, f"root-{i:02d}")
        _copy_context(root, scratch, touched[root])
        roots[root] = scratch

    # not a retry loop: every prefix is replayed exactly once and every
    # reader failure is recorded as a violation, not retried away
    for k in range(1, len(trace) + 1):  # lakelint: ignore[ad-hoc-retry] replay
        op = trace[k - 1]
        anchor = op.dst if op.kind == "replace" else op.path
        art = classify(anchor) if anchor else None
        if art is None or art.root not in roots:
            continue
        reader = _READERS.get(art.kind)
        if reader is None:
            continue
        state = _simulate(trace[:k])
        has_torn = any(
            e[0] == "torn"
            for p, e in state.items()
            if p.startswith(art.root + os.sep)
        )
        modes = ("missing", "empty", "half") if has_torn else ("exact",)
        for mode in modes:  # lakelint: ignore[ad-hoc-retry] torn fan-out
            scratch = roots[art.root]
            _materialize(scratch, art.root, state, mode)
            try:
                reader(scratch, art, root_kinds.get(art.root, set()), device)
            except Exception as exc:
                _add_violation(
                    "torn-state",
                    f"crash at prefix {k}/{len(trace)} (op {op.kind} "
                    f"{os.path.basename(anchor)}, torn-mode {mode}) leaves "
                    f"{art.kind} at {art.path} neither old-complete nor "
                    f"new-complete: reader failed with "
                    f"{type(exc).__name__}: {exc}",
                    (
                        f"publishing op:\n{op.stack}",
                        "reader:\n" + "".join(
                            traceback.format_exception(
                                type(exc), exc, exc.__traceback__, limit=6
                            )
                        ),
                    ),
                    ("torn", art.path, k, mode, type(exc).__name__),
                    prefix=k,
                )
