"""Runtime transaction-interleaving replay (opt-in: ``LAKESOUL_TXNCHECK=1``).

The port of ``lakesoul_tpu/analysis/txncheck.py``, over this package's
metadata store (``meta/store.py``) and its SQL parser (:mod:`sqlinfo`).
The static isolation rules (rules/isolation.py) prove store writes are
CAS-*shaped*; this half proves the committed protocols actually survive a
READ COMMITTED backend.  :func:`enable` interposes the metadata store's
two seams — ``SqlMetadataStore._exec`` (every statement) and each class's
``transaction`` contextmanager (the store's one write-transaction
boundary) — and
records, per committed transaction, the parsed statement trace with
bound parameter values (:mod:`lakesoul_tpu_torch.analysis.sqlinfo`).  Aborted
transactions record nothing; autocommit writes outside any transaction
become their own single-statement transactions.

:func:`replay` then asks, for every committed transaction T1 that read a
row and later wrote it WITHOUT holding a row lock (``ROW_LOCK``) on the
read: *if a concurrent peer's committed write to the same row had landed
between T1's read and T1's write — which READ COMMITTED permits — would
T1 have silently overwritten it?*  T1's write survives the interleaving
only when it is CAS-shaped (its WHERE re-checks a column the peer
wrote, so the peer's commit makes it match zero rows), self-relative
(``SET x = x + 1`` re-reads inside the statement), or value-idempotent
(both wrote the same values).  Everything else is a lost update, and is
recorded with both transactions' statement traces and the offending
interleaving spelled out.  Peers are transactions on the same store from
a DIFFERENT thread — same-thread transactions are program-ordered and
cannot interleave.  A second pass checks fencing-token monotonicity: the
sequence of token values written per (store, lease_key) must never
decrease across the whole committed history (the leases' invariant — a
regressing token re-arms a zombie's commit guard).

Violations are *recorded* (never raised — the store must not change
behavior under instrumentation); :func:`analysis.arm.armed` calls
:func:`replay` at teardown for the suites that name it (the port's
compaction and streaming suites) and their fixture fails the test on any
finding, exactly like lockgraph/fscheck.

Known limits, on purpose: the replay is symbolic (column/value-level over
recorded statements, not a re-execution), DELETE is never treated as the
clobbering write (delete-after-read flows carry range predicates the
model would misjudge), and writes whose values the binder cannot resolve
are assumed idempotent — unknowns must not manufacture alarms.
"""

from __future__ import annotations

import contextlib
import os
import threading
import traceback
from dataclasses import dataclass, field

from lakesoul_tpu_torch.analysis.lockgraph import real_lock
from lakesoul_tpu_torch.analysis.sqlinfo import Statement, bind_values, parse_statement

__all__ = [
    "Txn",
    "TxnStmt",
    "Violation",
    "enable",
    "disable",
    "reset",
    "violations",
    "enabled",
    "env_requested",
    "transactions",
    "replay",
    "watch",
]

_ENV = "LAKESOUL_TXNCHECK"

# per-table row identity: the columns whose bound values decide whether two
# statements can touch the same row(s); a key column a statement leaves
# unconstrained means "all rows" for that column
_KEY_COLS = {
    "lease": ("lease_key",),
    "global_config": ("key",),
    "partition_info": ("table_id", "partition_desc", "version"),
    "data_commit_info": ("table_id", "partition_desc", "commit_id"),
    "table_info": ("table_id",),
    "table_name_id": ("table_name",),
    "table_path_id": ("table_path",),
    "namespace": ("namespace",),
    "discard_compressed_file_info": ("file_path",),
}


@dataclass(frozen=True)
class TxnStmt:
    """One recorded statement: parsed shape + bound values + origin."""

    stmt: Statement
    binds: dict  # {"where": {col: {vals}}, "write": {col: {vals}}}
    stack: str

    def key_vals(self, col: str) -> "set | None":
        """Bound values identifying this statement's rows on ``col`` —
        WHERE bindings for select/update/delete, inserted values for
        insert; None = unconstrained (all rows)."""
        if self.stmt.op == "insert":
            return self.binds["write"].get(col)
        return self.binds["where"].get(col)

    def written_cols(self) -> frozenset:
        """Columns whose stored value this statement overwrites.  Upsert
        conflict targets and insert key columns identify the row rather
        than changing it."""
        if self.stmt.op == "update":
            return self.stmt.set_cols
        if self.stmt.op == "insert":
            keys = frozenset(_KEY_COLS.get(self.stmt.table or "", ()))
            return self.stmt.set_cols - self.stmt.conflict_cols - keys
        return frozenset()


@dataclass
class Txn:
    """One committed transaction in commit order."""

    store_id: int
    thread_id: int
    thread_name: str
    seq: int = 0  # commit order, assigned at commit
    autocommit: bool = False
    stmts: "list[TxnStmt]" = field(default_factory=list)

    def describe(self) -> str:
        ops = ", ".join(
            f"{s.stmt.op.upper()} {s.stmt.table or '?'}" for s in self.stmts
        )
        return (f"txn #{self.seq} (thread {self.thread_name}"
                f"{', autocommit' if self.autocommit else ''}): {ops}")


@dataclass
class Violation:
    kind: str  # "lost-update" | "fencing-regression"
    message: str
    stacks: "tuple[str, ...]" = ()

    def render(self) -> str:
        out = [f"[{self.kind}] {self.message}"]
        for s in self.stacks:
            out.append(s.rstrip())
        return "\n".join(out)


class _State:
    def __init__(self):
        self.lock = real_lock()
        self.enabled = False
        self.txns: list[Txn] = []
        self.seq = 0
        self.violations: list[Violation] = []
        self.reported: set = set()
        self.patched: list = []  # (cls, attr, original) for disable()


_STATE = _State()
_TLS = threading.local()


def _stack_summary() -> str:
    frames = [
        fr
        for fr in traceback.extract_stack()
        if "lakesoul_tpu_torch/analysis/txncheck" not in fr.filename.replace("\\", "/")
    ]
    return "\n".join(
        f"  {fr.filename}:{fr.lineno} in {fr.name}" for fr in frames[-8:]
    )


_PARSE_CACHE: dict = {}


def _parse_cached(sql: str) -> "Statement | None":
    stmt = _PARSE_CACHE.get(sql, False)
    if stmt is False:
        stmt = parse_statement(sql)
        _PARSE_CACHE[sql] = stmt
    return stmt


def _commit(txn: Txn) -> None:
    with _STATE.lock:
        _STATE.seq += 1
        txn.seq = _STATE.seq
        _STATE.txns.append(txn)


def _record_stmt(store, sql: str, params) -> None:
    stmt = _parse_cached(sql)
    if stmt is None or stmt.op in ("pragma", "other"):
        return
    try:
        bound = bind_values(stmt, tuple(params or ()))
    except Exception:
        bound = {"where": {}, "write": {}}
    entry = TxnStmt(stmt, bound, _stack_summary())
    stack = getattr(_TLS, "txns", None)
    if stack:
        for open_txn in reversed(stack):
            if open_txn.store_id == id(store):
                open_txn.stmts.append(entry)
                return
    if stmt.op == "select":
        return  # autocommit reads cannot anchor a read-then-write
    _commit(Txn(
        id(store), threading.get_ident(), threading.current_thread().name,
        autocommit=True, stmts=[entry],
    ))


# ------------------------------------------------------------ interposition


def _traced_exec(orig):
    def _exec(self, conn, sql, params=()):
        if _STATE.enabled:
            try:
                _record_stmt(self, sql, params)
            except Exception:
                pass
        return orig(self, conn, sql, params)

    _exec._txncheck_orig = orig
    return _exec


def _traced_transaction(orig):
    @contextlib.contextmanager
    def _cm(self):
        if not _STATE.enabled:
            with orig(self) as conn:
                yield conn
            return
        txn = Txn(id(self), threading.get_ident(),
                  threading.current_thread().name)
        stack = getattr(_TLS, "txns", None)
        if stack is None:
            stack = _TLS.txns = []
        stack.append(txn)
        try:
            with orig(self) as conn:
                yield conn
        except BaseException:
            stack.remove(txn)  # aborted: its statements never happened
            raise
        else:
            stack.remove(txn)
            _commit(txn)

    def transaction(self):
        return _cm(self)

    transaction._txncheck_orig = orig
    return transaction


def _store_classes():
    from lakesoul_tpu_torch.meta.store import SqlMetadataStore

    out = [SqlMetadataStore]
    pending = list(SqlMetadataStore.__subclasses__())
    while pending:
        cls = pending.pop()
        out.append(cls)
        pending.extend(cls.__subclasses__())
    return out


def enable() -> None:
    """Interpose the store seams.  Idempotent.  ``SqliteMetadataStore``'s
    ``_exec`` override funnels through ``super()._exec``, so patching the
    base records each statement exactly once; ``transaction`` is patched
    on every class that defines it so the most-derived override is the
    one wrapped."""
    if _STATE.enabled:
        return
    for cls in _store_classes():
        if "_exec" in cls.__dict__ and cls.__name__ == "SqlMetadataStore":
            orig = cls.__dict__["_exec"]
            cls._exec = _traced_exec(orig)
            _STATE.patched.append((cls, "_exec", orig))
        if "transaction" in cls.__dict__:
            orig = cls.__dict__["transaction"]
            cls.transaction = _traced_transaction(orig)
            _STATE.patched.append((cls, "transaction", orig))
    _STATE.enabled = True


def disable() -> None:
    """Restore the real seams.  Recorded history stays for inspection and
    :func:`replay` until :func:`reset`."""
    if not _STATE.enabled:
        return
    for cls, attr, orig in _STATE.patched:
        setattr(cls, attr, orig)
    _STATE.patched.clear()
    _STATE.enabled = False


def enabled() -> bool:
    return _STATE.enabled


def env_requested() -> bool:
    return os.environ.get(_ENV, "").strip() == "1"


def violations() -> list[Violation]:
    with _STATE.lock:
        return list(_STATE.violations)


def transactions() -> list[Txn]:
    with _STATE.lock:
        return list(_STATE.txns)


def reset() -> None:
    with _STATE.lock:
        _STATE.txns.clear()
        _STATE.seq = 0
        _STATE.violations.clear()
        _STATE.reported.clear()


class Watch:
    def __init__(self, mark: int):
        self._mark = mark

    @property
    def violations(self) -> list[Violation]:
        return violations()[self._mark:]


class watch:
    """``with watch() as w:`` — enable for the block; call :func:`replay`
    (inside or after) and inspect ``w.violations``."""

    def __enter__(self) -> Watch:
        self._was_enabled = _STATE.enabled
        enable()
        return Watch(len(violations()))

    def __exit__(self, *exc):
        if not self._was_enabled:
            disable()
        return False


# ------------------------------------------------------------------- replay


def _rows_may_overlap(table: str, a: TxnStmt, b: TxnStmt) -> bool:
    """False only when some key column is bound by BOTH statements to
    provably disjoint value sets."""
    for col in _KEY_COLS.get(table, ()):
        va, vb = a.key_vals(col), b.key_vals(col)
        if va is not None and vb is not None and not (va & vb):
            return False
    return True


def _row_desc(table: str, s: TxnStmt) -> str:
    parts = []
    for col in _KEY_COLS.get(table, ()):
        vals = s.key_vals(col)
        if vals is not None:
            parts.append(f"{col}={sorted(map(repr, vals))[0] if len(vals) == 1 else sorted(map(repr, vals))}")
    return f"{table}[{', '.join(parts) or '*'}]"


def _values_differ(w: TxnStmt, peer: TxnStmt, cols) -> bool:
    """True only when some overlapping column has KNOWN, different values
    on both sides — unknowns must not manufacture alarms."""
    for col in cols:
        va = w.binds["write"].get(col)
        vb = peer.binds["write"].get(col)
        if va and vb and not (va & vb):
            return True
    return False


def _add_violation(kind: str, message: str, stacks: tuple, key) -> None:
    with _STATE.lock:
        if key in _STATE.reported:
            return
        _STATE.reported.add(key)
        _STATE.violations.append(Violation(kind, message, stacks))


def _check_lost_updates(txns: "list[Txn]") -> None:
    for t1 in txns:
        if t1.autocommit:
            continue  # a single statement cannot straddle a peer's commit
        for wi, w in enumerate(t1.stmts):
            if w.stmt.op != "update":
                continue
            table = w.stmt.table
            if table not in _KEY_COLS:
                continue
            if w.stmt.set_cols and w.stmt.set_cols <= w.stmt.relative_cols:
                continue  # SET x = f(x): the statement re-reads atomically
            reads = [
                r for r in t1.stmts[:wi]
                if r.stmt.op == "select" and r.stmt.table == table
                and not r.stmt.row_locked and _rows_may_overlap(table, r, w)
            ]
            if not reads:
                continue  # no splittable read-then-write in this txn
            for t2 in txns:
                if (t2 is t1 or t2.store_id != t1.store_id
                        or t2.thread_id == t1.thread_id):
                    continue
                for w2 in t2.stmts:
                    if w2.stmt.op not in ("update", "insert"):
                        continue
                    if w2.stmt.table != table:
                        continue
                    if not _rows_may_overlap(table, w, w2):
                        continue
                    peer_set = w2.written_cols()
                    if w.stmt.where_cols & peer_set:
                        continue  # CAS: the peer's write voids our WHERE
                    clobbered = (
                        (w.stmt.set_cols - w.stmt.relative_cols) & peer_set
                    )
                    if not clobbered:
                        continue
                    if not _values_differ(w, w2, clobbered):
                        continue  # idempotent (or unknowable) writes
                    row = _row_desc(table, w)
                    _add_violation(
                        "lost-update",
                        f"{t1.describe()} reads {row} without ROW_LOCK, "
                        f"then writes {sorted(clobbered)} re-checking only "
                        f"{sorted(w.stmt.where_cols)} — under READ "
                        f"COMMITTED the peer {t2.describe()} can commit "
                        "between the read and the write, and this UPDATE "
                        "silently overwrites it.  Offending interleaving: "
                        f"txn #{t1.seq} SELECT {row} -> txn #{t2.seq} "
                        f"commits {w2.stmt.op.upper()} {row} -> txn "
                        f"#{t1.seq} UPDATE {row} (matches anyway: WHERE "
                        "re-checks none of the peer's written columns)",
                        (
                            f"txn #{t1.seq} read:\n{reads[-1].stack}",
                            f"txn #{t1.seq} write:\n{w.stack}",
                            f"txn #{t2.seq} peer write:\n{w2.stack}",
                        ),
                        ("lost-update", t1.seq, t2.seq, w.stmt.text),
                    )


def _check_fencing(txns: "list[Txn]") -> None:
    """Token values written per (store, lease_key) must be non-decreasing
    in commit order.  A DELETE that could have removed lease rows (table
    resolved to lease, or unresolvable — ``clean_all_for_test``'s dynamic
    table names) resets that store's sequences: the row's history ended."""
    high: dict = {}
    for txn in txns:
        for s in txn.stmts:
            if s.stmt.op == "delete" and s.stmt.table in ("lease", None):
                high = {k: v for k, v in high.items() if k[0] != txn.store_id}
                continue
            if s.stmt.table != "lease" or "fencing_token" not in s.binds["write"]:
                continue
            keys = s.key_vals("lease_key")
            tokens = s.binds["write"]["fencing_token"]
            if not keys or not tokens:
                continue
            token = max(t for t in tokens if isinstance(t, int))
            for key in keys:
                prev = high.get((txn.store_id, key))
                if prev is not None and token < prev[0]:
                    _add_violation(
                        "fencing-regression",
                        f"lease[{key!r}] fencing token regressed "
                        f"{prev[0]} -> {token} (txn #{prev[1]} then txn "
                        f"#{txn.seq}) — a zombie ex-holder's stale token "
                        "would pass the commit guard again; tokens must "
                        "be monotonic per key for the table's lifetime",
                        (f"txn #{txn.seq} write:\n{s.stack}",),
                        ("fencing", txn.store_id, key, token),
                    )
                if prev is None or token > prev[0]:
                    high[(txn.store_id, key)] = (token, txn.seq)


def replay() -> list[Violation]:
    """Replay the committed history under READ COMMITTED interleavings.
    New violations are recorded (and returned) — never raised.  Idempotent
    over the same history: findings dedupe by identity."""
    with _STATE.lock:
        txns = list(_STATE.txns)
    if not txns:
        return []
    mark = len(violations())
    _check_lost_updates(txns)
    _check_fencing(txns)
    return violations()[mark:]
