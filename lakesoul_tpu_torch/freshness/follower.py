"""The bounded-staleness follower: ``scan.follow()`` made crash-proof,
retry-hardened and exactly-once resumable (the port's copy of
``lakesoul_tpu/freshness/follower.py``; a :class:`FollowerState` JSON written
by either package resumes the other's follower).

Three layers on top of ``MetaDataClient.poll_scan_plan``'s version-cursor
polling:

**Resilience.**  Every store/meta touch (the poll) and every unit decode
runs under the shared :class:`~lakesoul_tpu_torch.runtime.resilience.RetryPolicy`
(seeded schedule, ``lakesoul_retry_*`` counters): a transient fault —
an object-store blip, an injected ``LAKESOUL_FAULTS`` chaos error, a
flaky metadata read — backs off and retries instead of killing the
stream; permanent failures raise their native typed error.  A decode
fault MID-unit re-opens the unit and re-skips the rows already yielded
(unit decode is deterministic, so the re-skip is byte-exact — the same
invariant the scan plane's exactly-once story rests on).

**Exactly-once position.**  The follower's position is a
:class:`FollowerState`: the per-partition version cursors, the FIFO of
*enumerated-but-undelivered* scan units, and the row offset into the unit
currently streaming.  Polling is the ONLY nondeterministic step (two
polls may batch the same commits into different unit groupings — a PK
bucket's merge over two commits differs from two single-commit merges),
so the state records the *outcome* of each poll verbatim: replaying a
persisted state re-decodes the exact recorded units and therefore the
exact recorded rows.  ``state_json()`` between pulls is yield-aligned —
serialize it next to your checkpoint and a restarted follower continues
with no duplicated and no lost row, even across a compaction that
rewrote the files the cursors point at (compaction commits add no new
data, and the pre-compaction files a pending unit references stay on
disk until the cleaner runs).

**Freshness.**  Each unit carries the visibility instant of its earliest
commit (``ScanPlanPartition.commit_timestamp_ms``); when the unit's
first batch is handed over, the gap to now lands in the
``lakesoul_freshness_seconds`` histogram via the attached
:class:`~lakesoul_tpu_torch.freshness.slo.SloMonitor` — THE measurement the
ingest-to-train SLO is evaluated on.

:class:`FollowBatchSource` adapts the follower to the batch-source seam,
which is how ``scan.to_torch_iter(follow=...)`` turns a table into a
continuous training source with loader-side resume
(``TorchBatchIterator.follow_state_json``).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import threading
from collections import deque
from typing import Iterator

import pyarrow as pa

from lakesoul_tpu_torch.errors import ConfigError
from lakesoul_tpu_torch.meta.client import PartitionCursor, ScanPlanPartition
from lakesoul_tpu_torch.obs import registry

ENV_FOLLOW_POLL_S = "LAKESOUL_FOLLOW_POLL_S"


def default_follow_poll_s() -> float:
    raw = os.environ.get(ENV_FOLLOW_POLL_S, "").strip()
    try:
        return float(raw) if raw else 1.0
    except ValueError:
        return 1.0


def _skip_batches(batches, skip: int):
    """Drop the first ``skip`` rows of a batch stream (slicing the
    straddling batch).  Deterministic streams make this an exact resume
    primitive — THE shared skip loop for unit re-opens and seam-level
    ``skip_rows``."""
    remaining = skip
    for b in batches:
        if remaining >= len(b):
            remaining -= len(b)
            continue
        if remaining:
            b = b.slice(remaining)
            remaining = 0
        yield b


def _cursors_to_jsonable(cursors: dict[str, PartitionCursor]) -> dict:
    return {
        desc: {"version": c.version, "snapshot": sorted(c.snapshot)}
        for desc, c in cursors.items()
    }


def _cursors_from_jsonable(d: dict) -> dict[str, PartitionCursor]:
    return {
        desc: PartitionCursor(version=v["version"], snapshot=set(v["snapshot"]))
        for desc, v in d.items()
    }


@dataclasses.dataclass
class FollowerState:
    """One exactly-once follow position (see module docstring).

    ``cursors`` may be the caller's own dict (``scan.follow(cursors=...)``
    mutates it in place for the legacy coarse-grained resume);
    :meth:`clone` deep-copies everything so a persisted snapshot can never
    be corrupted by the live stream advancing."""

    cursors: dict[str, PartitionCursor] = dataclasses.field(default_factory=dict)
    pending: list[ScanPlanPartition] = dataclasses.field(default_factory=list)
    rows_into_current: int = 0

    def clone(self) -> "FollowerState":
        return FollowerState(
            cursors={
                desc: PartitionCursor(c.version, set(c.snapshot))
                for desc, c in self.cursors.items()
            },
            pending=[copy.copy(u) for u in self.pending],
            rows_into_current=self.rows_into_current,
        )

    def to_json(self) -> str:
        return json.dumps(
            {
                "cursors": _cursors_to_jsonable(self.cursors),
                "pending": [dataclasses.asdict(u) for u in self.pending],
                "rows_into_current": self.rows_into_current,
            },
            sort_keys=True,
        )

    @classmethod
    def from_json(cls, raw: str) -> "FollowerState":
        d = json.loads(raw)
        return cls(
            cursors=_cursors_from_jsonable(d["cursors"]),
            pending=[ScanPlanPartition(**u) for u in d["pending"]],
            rows_into_current=int(d.get("rows_into_current", 0)),
        )


class FreshFollower:
    """Unbounded incremental batch stream over one scan (see module
    docstring).  Iterate with :meth:`iter_batches`; persist position with
    :meth:`state_json` (yield-aligned) or :meth:`resume_state` (for a
    consumer lagging behind the stream by buffered rows, e.g. the loader
    pipeline's prefetch queue)."""

    # how many boundary state snapshots are retained for resume_state():
    # one per delivered UNIT (+ one per poll), with intra-unit positions
    # reconstructed from the row residual — the loader's bounded prefetch
    # window (a few batches) spans at most a couple of units, far under this
    SNAPSHOTS = 512

    def __init__(
        self,
        scan,
        *,
        start_timestamp_ms: int | None = None,
        state: FollowerState | None = None,
        cursors: dict[str, PartitionCursor] | None = None,
        poll_interval: float | None = None,
        stop_event: threading.Event | None = None,
        retry_policy=None,
        slo=None,
        max_polls: int | None = None,
    ):
        from lakesoul_tpu_torch.runtime.resilience import RetryPolicy

        if state is not None and cursors is not None:
            raise ConfigError("pass either a FollowerState or a cursors dict, not both")
        self._scan = scan
        self._table = scan._table
        self._client = self._table.catalog.client
        self._budget = self._table.io_config().memory_budget_bytes
        self.poll_interval = (
            default_follow_poll_s() if poll_interval is None else float(poll_interval)
        )
        self.stop_event = stop_event
        self.slo = slo
        self._policy = retry_policy or RetryPolicy.from_env()
        self._max_polls = max_polls
        if state is None:
            state = FollowerState(cursors=cursors if cursors is not None else {})
            if cursors is None:
                from lakesoul_tpu_torch.meta.entity import now_millis

                start = (
                    start_timestamp_ms
                    if start_timestamp_ms is not None
                    else now_millis()
                )
                info = self._table.info
                state.cursors.update(
                    self._client.init_follow_cursors(
                        info.table_name, start, info.table_namespace
                    )
                )
        self._state = state
        self._rows_total = 0
        # (source rows delivered, yield-aligned state clone) ring — the
        # resume_state() lookup table; guarded: the pipeline's source pump
        # yields on its thread while the trainer snapshots on its own
        self._snap_lock = threading.Lock()
        self._snapshots: deque[tuple[int, FollowerState]] = deque(maxlen=self.SNAPSHOTS)
        reg = registry()
        self._c_polls = reg.counter("lakesoul_follow_polls_total")
        self._c_units = reg.counter("lakesoul_follow_units_total")
        # delivered source rows: the follower's contribution to the fleet
        # aggregate-rows/s north star
        self._c_rows = reg.counter("lakesoul_follow_rows_total")

    # ----------------------------------------------------------------- state
    def _stopped(self) -> bool:
        return self.stop_event is not None and self.stop_event.is_set()

    def state_json(self) -> str:
        """Yield-aligned position: between two pulls of the iterator this
        is EXACTLY the boundary after the last returned batch."""
        return self._state.to_json()

    def resume_state(self, rows_total: int) -> FollowerState:
        """The exact :class:`FollowerState` positioned after ``rows_total``
        source rows — for consumers whose delivered-row count lags the
        stream by buffered rows.  Snapshots live at unit/poll boundaries;
        an intra-unit position is the preceding boundary plus a row
        residual into its first pending unit (unit decode is
        deterministic, so the residual is exact).  Raises
        :class:`ConfigError` when the position has rotated out of the
        snapshot ring (a consumer lagging by more than ~``SNAPSHOTS``
        units is holding the whole window in memory anyway)."""
        with self._snap_lock:
            best: tuple[int, FollowerState] | None = None
            for rows, st in self._snapshots:
                # >= : among equal-row snapshots (a unit boundary followed
                # by a poll) the LATEST reflects the recorded poll outcome
                if rows <= rows_total and (best is None or rows >= best[0]):
                    best = (rows, st)
        if best is None:
            raise ConfigError(
                f"no follower snapshot at or before row {rows_total}: the"
                " position expired from the snapshot ring"
            )
        rows, st = best
        out = st.clone()
        out.rows_into_current += rows_total - rows
        return out

    def _push_snapshot(self) -> None:
        with self._snap_lock:
            self._snapshots.append((self._rows_total, self._state.clone()))

    # ------------------------------------------------------------------ poll
    def _poll_units(self) -> list[ScanPlanPartition]:
        """One cursor poll → restricted, per-file-exploded units, through
        the retry policy (the ``follow.poll`` fault point makes the meta
        read chaos-targetable)."""
        from lakesoul_tpu_torch.runtime import faults

        info = self._table.info
        scan = self._scan

        def attempt():
            faults.maybe_inject("follow.poll")
            return self._client.poll_scan_plan(
                info.table_name, self._state.cursors, info.table_namespace
            )

        units = self._policy.run(attempt, op="follow.poll")
        self._c_polls.inc()
        units = scan._filter_partitions(units)
        # non-PK units must shard per FILE: each rank's polls batch commits
        # differently, so a multi-file unit's identity (first file) is
        # timing-dependent — per-file units are not
        exploded: list[ScanPlanPartition] = []
        for u in units:
            if u.primary_keys:
                exploded.append(u)
                continue
            sizes = (
                u.file_sizes
                if len(u.file_sizes) == len(u.data_files)
                else [0] * len(u.data_files)
            )
            for f, sz in zip(u.data_files, sizes):
                exploded.append(
                    ScanPlanPartition(
                        data_files=[f],
                        primary_keys=[],
                        bucket_id=u.bucket_id,
                        partition_desc=u.partition_desc,
                        partition_values=u.partition_values,
                        file_sizes=[sz],
                        commit_timestamp_ms=u.commit_timestamp_ms,
                    )
                )
        return scan._restrict_units(exploded, stable_shard=True)

    def _open_unit(self, unit: ScanPlanPartition, skip_rows: int):
        """Batch iterator over one unit, the first ``skip_rows`` rows
        dropped (deterministic decode makes the skip exact on a retry or a
        resume)."""
        from lakesoul_tpu_torch.io.reader import iter_scan_unit_batches

        inner = iter_scan_unit_batches(
            unit.data_files,
            unit.primary_keys,
            batch_size=self._scan._batch_size,
            memory_budget_bytes=self._budget,
            file_sizes=unit.file_sizes,
            **self._scan._unit_kwargs(unit),
        )
        if not skip_rows:
            return inner
        return _skip_batches(inner, skip_rows)

    # -------------------------------------------------------------- delivery
    def iter_batches(self) -> Iterator[pa.RecordBatch]:
        """The stream.  Runs until ``stop_event`` is set (checked every
        poll tick AND between delivered batches, so shutdown latency is
        bounded by one ``poll_interval`` even mid-backlog) or, for tests,
        until ``max_polls`` empty-handed polls."""
        state = self._state
        self._push_snapshot()  # position 0 = the initial state
        polls = 0
        while not self._stopped():
            if not state.pending:
                new_units = self._poll_units()
                polls += 1
                if new_units:
                    state.pending.extend(new_units)
                    self._c_units.inc(len(new_units))
                    # boundary snapshot: replay from here re-decodes the
                    # RECORDED poll outcome instead of re-polling (two
                    # polls may group the same commits differently)
                    self._push_snapshot()
                else:
                    if self._max_polls is not None and polls >= self._max_polls:
                        return
                    if self._stopped():
                        return
                    # shutdown within one poll tick: wait ON the stop event,
                    # never a blind sleep
                    if self.stop_event is not None:
                        self.stop_event.wait(self.poll_interval)
                    else:
                        import time as _time

                        _time.sleep(self.poll_interval)
                    continue
            unit = state.pending[0]
            first = state.rows_into_current == 0  # fresh start = SLO point
            rows_done = state.rows_into_current
            it = None

            def pull():
                nonlocal it
                if it is None:
                    # (re)open at the exact delivered offset: a transient
                    # decode fault mid-unit resumes byte-identically
                    it = self._open_unit(unit, rows_done)
                try:
                    return next(it, None)
                except Exception:
                    it = None
                    raise

            # one-batch lookahead: the position published with batch k must
            # already know whether k ends its unit — otherwise a persisted
            # state can point AT a unit's end and a resume residual (a
            # consumer a few rows past that boundary) would overshoot into
            # dropped rows.  With the lookahead, every published position
            # points INTO the unit that produces the next batch, and all
            # updates happen BEFORE the yield (code after a yield only runs
            # on the next pull — updating there would lag the persisted
            # position one batch and replay a delivered batch on resume).
            buffered: pa.RecordBatch | None = None
            while True:
                nxt = self._policy.run(pull, op="follow.decode")
                if nxt is not None:
                    rows_done += len(nxt)
                if buffered is not None:
                    boundary = nxt is None
                    if boundary:
                        state.pending.pop(0)
                        state.rows_into_current = 0
                    else:
                        state.rows_into_current = rows_done - len(nxt)
                    self._rows_total += len(buffered)
                    self._c_rows.inc(len(buffered))
                    if boundary:
                        # snapshot per unit boundary, not per batch: the
                        # clone is O(cursors + pending), and intra-unit
                        # positions reconstruct exactly from the residual
                        self._push_snapshot()
                    if first and self.slo is not None:
                        # commit-to-visible: the instant the commit's first
                        # batch reaches the consumer (THE SLO measurement
                        # point)
                        self.slo.observe_commit(unit.commit_timestamp_ms)
                    first = False
                    yield buffered
                    if self._stopped():
                        return
                if nxt is None:
                    if buffered is None:
                        # zero-batch unit (a resume skip consumed it, or a
                        # delete-only CDC commit filtered to nothing)
                        state.pending.pop(0)
                        state.rows_into_current = 0
                        self._push_snapshot()
                    break
                buffered = nxt

    def __iter__(self) -> Iterator[pa.RecordBatch]:
        return self.iter_batches()


class FollowBatchSource:
    """Batch-source-seam adapter (data/batch_source.py contract): hands a
    :class:`FreshFollower` to any delivery adapter.  ``skip_rows``
    replays the deterministic recorded units and drops the first rows —
    the loader-resume path always pairs it with :meth:`resume_state`, so
    the skip never crosses a (nondeterministic) poll boundary."""

    remote = False

    def __init__(self, scan, **follow_kwargs):
        self._scan = scan
        self._kwargs = follow_kwargs
        # the initial state is cloned per iteration so re-iterating (or a
        # retry after a dead pipeline) replays from the SAME position
        state = follow_kwargs.get("state")
        if isinstance(state, str):
            state = FollowerState.from_json(state)
            self._kwargs["state"] = state
        self._initial = state.clone() if state is not None else None
        self.follower: FreshFollower | None = None

    def iter_batches(self, *, num_threads=None, skip_rows: int = 0):
        # num_threads is accepted for seam parity; follow decode is
        # sequential per unit (ordering IS the exactly-once contract)
        kwargs = dict(self._kwargs)
        if self._initial is not None:
            kwargs["state"] = self._initial.clone()
        self.follower = FreshFollower(self._scan, **kwargs)
        inner = self.follower.iter_batches()
        if skip_rows:
            inner = _skip_batches(inner, skip_rows)
        yield from inner

    def resume_state(self, rows_delivered: int) -> FollowerState:
        """Resume-ready state after ``rows_delivered`` consumer rows (see
        :meth:`FreshFollower.resume_state`)."""
        if self.follower is None:
            if self._initial is not None and rows_delivered == 0:
                return self._initial.clone()
            raise ConfigError("follow source has not started streaming yet")
        return self.follower.resume_state(rows_delivered)
