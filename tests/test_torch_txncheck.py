"""Transaction-interleaving replay in the port
(``lakesoul_tpu_torch/analysis/txncheck.py``), case for case the
reference's ``tests/test_txncheck.py``, over the port's metadata store and
its SQL parser (``analysis/sqlinfo.py``): the real lease protocol —
acquire, holder refresh, expiry takeover, renew, tombstone release — must
replay clean under READ COMMITTED interleavings on both backends, while a
seeded unlocked read-then-blind-write is caught as a lost update with both
transactions' statement stacks and the offending interleaving, and a
regressing fencing token is caught per key.  Also pins the detector's
control surface (env gate, enable/disable restoring the store seams,
aborted transactions recording nothing, autocommit reads staying
untraced, idempotent replay)."""

import sys
import threading

import pytest

import fake_psycopg2

from lakesoul_tpu_torch.analysis import txncheck
from lakesoul_tpu_torch.meta.store import SqliteMetadataStore, SqlMetadataStore


@pytest.fixture(autouse=True)
def _pristine_detector():
    """Every test starts and ends with the real store seams."""
    assert not txncheck.enabled()
    yield
    txncheck.disable()
    txncheck.reset()


@pytest.fixture()
def store(tmp_path):
    return SqliteMetadataStore(str(tmp_path / "meta.db"))


# ------------------------------------------------------------ control plane


def test_env_gate(monkeypatch):
    monkeypatch.delenv("LAKESOUL_TXNCHECK", raising=False)
    assert not txncheck.env_requested()
    monkeypatch.setenv("LAKESOUL_TXNCHECK", "1")
    assert txncheck.env_requested()
    monkeypatch.setenv("LAKESOUL_TXNCHECK", "0")
    assert not txncheck.env_requested()


def test_enable_disable_restores_seams():
    real_exec = SqlMetadataStore.__dict__["_exec"]
    real_base_txn = SqlMetadataStore.__dict__["transaction"]
    real_sqlite_txn = SqliteMetadataStore.__dict__["transaction"]
    txncheck.enable()
    txncheck.enable()  # idempotent
    assert SqlMetadataStore.__dict__["_exec"] is not real_exec
    assert SqliteMetadataStore.__dict__["transaction"] is not real_sqlite_txn
    txncheck.disable()
    txncheck.disable()
    assert SqlMetadataStore.__dict__["_exec"] is real_exec
    assert SqlMetadataStore.__dict__["transaction"] is real_base_txn
    assert SqliteMetadataStore.__dict__["transaction"] is real_sqlite_txn


def test_autocommit_reads_stay_untraced(store):
    with txncheck.watch():
        assert store.get_lease("nobody-here") is None
        assert txncheck.transactions() == []


def test_aborted_transaction_records_nothing(store):
    with txncheck.watch():
        with pytest.raises(RuntimeError):
            with store.transaction() as conn:
                store._exec(
                    conn, "UPDATE global_config SET value=? WHERE key=?",
                    ("v", "k"),
                )
                raise RuntimeError("abort before commit")
        assert txncheck.transactions() == []
        assert txncheck.replay() == []


# ------------------------------------------------- real protocols stay clean


def test_lease_protocol_replays_clean(store):
    with txncheck.watch():
        def contender(name):
            got = store.acquire_lease("part-1", name, ttl_ms=60_000)
            if got:
                assert store.renew_lease(
                    "part-1", name, got.fencing_token, ttl_ms=60_000
                )
                assert store.release_lease("part-1", name, got.fencing_token)

        threads = [
            threading.Thread(target=contender, args=(f"h{i}",), name=f"h{i}")
            for i in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert txncheck.transactions(), "the seam was not traced"
        assert txncheck.replay() == []


def test_expiry_takeover_replays_clean(store):
    with txncheck.watch():
        first = store.acquire_lease("p", "a", ttl_ms=10, now_ms=1_000)
        assert first is not None and first.fencing_token == 1
        took = store.acquire_lease("p", "b", ttl_ms=10_000, now_ms=5_000)
        assert took is not None and took.fencing_token == 2 and took.taken_over
        assert store.release_lease("p", "b", took.fencing_token)
        # a released tombstone re-acquires with the NEXT token — the
        # sequence stays monotonic for the table's lifetime
        again = store.acquire_lease("p", "c", ttl_ms=10_000, now_ms=6_000)
        assert again is not None and again.fencing_token == 3
        assert txncheck.replay() == []


def test_pg_store_lease_protocol_replays_clean(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "psycopg2", fake_psycopg2)
    from lakesoul_tpu_torch.meta.store import PostgresMetadataStore

    dsn = f"postgresql://fake/{tmp_path.name}-txncheck"
    store = PostgresMetadataStore(dsn)
    try:
        with txncheck.watch():
            got = store.acquire_lease("part-7", "pg-holder", ttl_ms=60_000)
            assert got is not None
            assert store.renew_lease(
                "part-7", "pg-holder", got.fencing_token, ttl_ms=60_000
            )
            assert store.release_lease("part-7", "pg-holder", got.fencing_token)
            assert txncheck.transactions(), "the PG seam was not traced"
            assert txncheck.replay() == []
    finally:
        fake_psycopg2.reset(dsn)


def test_cas_guarded_write_replays_clean(store):
    """A write whose WHERE re-checks a column the peer wrote survives the
    interleaving: the peer's commit makes it match zero rows."""
    store.acquire_lease("part-9", "holder", ttl_ms=60_000)
    with txncheck.watch():
        def holder():
            with store.transaction() as conn:
                row = store._exec(
                    conn,
                    "SELECT fencing_token FROM lease WHERE lease_key=?",
                    ("part-9",),
                ).fetchone()
                store._exec(
                    conn,
                    "UPDATE lease SET expires_at_ms=?"
                    " WHERE lease_key=? AND fencing_token=?",
                    (999, "part-9", row[0]),
                )

        t = threading.Thread(target=holder, name="holder-thread")
        t.start()
        t.join()
        with store.transaction() as conn:
            store._exec(
                conn,
                "UPDATE lease SET expires_at_ms=?, fencing_token=?"
                " WHERE lease_key=?",
                (111, 7, "part-9"),
            )
        assert txncheck.replay() == []


# ------------------------------------------------------ seeded bugs caught


def test_unlocked_read_then_blind_write_caught(store):
    store.acquire_lease("part-9", "victim", ttl_ms=60_000)
    with txncheck.watch() as w:
        def victim():
            with store.transaction() as conn:
                store._exec(
                    conn,
                    "SELECT expires_at_ms FROM lease WHERE lease_key=?",
                    ("part-9",),
                ).fetchone()
                store._exec(
                    conn,
                    "UPDATE lease SET expires_at_ms=? WHERE lease_key=?",
                    (999, "part-9"),
                )

        t = threading.Thread(target=victim, name="victim-thread")
        t.start()
        t.join()
        with store.transaction() as conn:
            store._exec(
                conn,
                "UPDATE lease SET expires_at_ms=?, holder_id=?"
                " WHERE lease_key=?",
                (111, "thief", "part-9"),
            )
        found = txncheck.replay()
        assert [v.kind for v in found] == ["lost-update"]
        assert found == w.violations
    rendered = found[0].render()
    assert "Offending interleaving" in rendered
    assert "victim-thread" in rendered
    assert "lease[lease_key='part-9']" in rendered
    # both transactions' statement stacks ride along: read, write, peer
    assert len(found[0].stacks) == 3
    assert "test_torch_txncheck.py" in found[0].stacks[0]
    # replay is idempotent over the same history
    assert txncheck.replay() == []


def test_fencing_regression_caught(store):
    with txncheck.watch():
        with store.transaction() as conn:
            store._exec(
                conn,
                "INSERT INTO lease(lease_key, holder_id, fencing_token,"
                " expires_at_ms, acquired_at_ms) VALUES (?,?,?,?,?)",
                ("k", "a", 5, 10, 1),
            )
        with store.transaction() as conn:
            store._exec(
                conn,
                "UPDATE lease SET fencing_token=?, holder_id=?"
                " WHERE lease_key=?",
                (3, "b", "k"),
            )
        found = txncheck.replay()
    assert [v.kind for v in found] == ["fencing-regression"]
    assert "5 -> 3" in found[0].message


def test_fencing_sequence_resets_after_delete(store):
    """DELETE ends the row's history (clean_all_for_test): a fresh token 1
    afterwards is a new sequence, not a regression."""
    with txncheck.watch():
        with store.transaction() as conn:
            store._exec(
                conn,
                "INSERT INTO lease(lease_key, holder_id, fencing_token,"
                " expires_at_ms, acquired_at_ms) VALUES (?,?,?,?,?)",
                ("k", "a", 5, 10, 1),
            )
        store.clean_all_for_test()
        with store.transaction() as conn:
            store._exec(
                conn,
                "INSERT INTO lease(lease_key, holder_id, fencing_token,"
                " expires_at_ms, acquired_at_ms) VALUES (?,?,?,?,?)",
                ("k", "b", 1, 20, 2),
            )
        assert txncheck.replay() == []
