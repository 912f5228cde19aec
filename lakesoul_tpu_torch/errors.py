"""Framework-wide error types.

Mirrors the error surface of the reference's ``LakeSoulMetaDataError`` /
``LakeSoulError`` enums (rust/lakesoul-metadata/src/error.rs,
rust/lakesoul-io/src/lakesoul_io_config.rs) with idiomatic Python exceptions.
"""


class LakeSoulError(Exception):
    """Base class for all lakesoul_tpu_torch errors."""


class MetadataError(LakeSoulError):
    """Metadata-layer failure (DAO op, schema, store IO)."""


class CommitConflictError(MetadataError):
    """Optimistic-concurrency conflict: another writer committed the same
    (table_id, partition_desc, version) first.  Callers re-read the current
    partition version and retry (the reference delegates this to a PG primary
    key conflict; see metadata_client.rs:467 and meta_init.sql:95-99)."""


class TableNotFoundError(MetadataError):
    pass


class LeaseFencedError(MetadataError):
    """A commit (or renewal) presented a lease that is no longer valid: the
    holder's TTL expired and a peer re-acquired the lease with a higher
    fencing token.  The presenter is a *zombie* — it must abandon the job,
    never retry it: the work has been (or will be) redone by the new
    holder, and retrying would double-apply it.  Deliberately permanent in
    the resilience taxonomy (MetadataError → not transient)."""


class TableAlreadyExistsError(MetadataError):
    pass


class IOError_(LakeSoulError):
    """Data-plane IO failure (read/write/merge)."""


class ConfigError(LakeSoulError):
    pass


class RBACError(LakeSoulError):
    """Permission denied by domain-based RBAC."""


class VectorIndexError(LakeSoulError):
    pass


class TensorColumnError(LakeSoulError):
    """A declared fixed-shape tensor column received data that violates its
    declaration (wrong element dtype, wrong flattened width, nulls in the
    list or its children, or the column missing entirely).  Raised at WRITE
    time by the tensor-plane validation (tensorplane/columns.py) so a
    malformed batch dies at the table boundary with the column named,
    instead of three stages into a training run as a shape error."""


class ScanPlaneWaitTimeout(LakeSoulError):
    """A ``scan_stream`` exchange exhausted ``LAKESOUL_SCANPLANE_WAIT_S``
    waiting for a worker to produce a range.  Carries the session id and
    the range index so an operator can tell WHICH shard starved (no
    workers against the spool, or a fleet too small for the backlog) —
    the generic Flight error this used to surface said neither.  The
    message format is part of the wire contract: the client re-raises the
    typed form from the marker the gateway's error string carries."""

    MARKER = "scanplane wait exhausted"

    def __init__(self, session: str, range_index: int, wait_s: float):
        self.session = session
        self.range_index = int(range_index)
        self.wait_s = float(wait_s)
        super().__init__(
            f"{self.MARKER}: session={session} range={range_index} after"
            f" {wait_s:.0f}s — are scanplane workers running against this"
            " spool?"
        )

    @classmethod
    def from_message(cls, message: str) -> "ScanPlaneWaitTimeout | None":
        """Re-raise surface for the client: recover the typed error from a
        Flight error string that carries the marker (gateway errors cross
        the wire as text).  Returns ``None`` for unrelated messages."""
        import re

        m = re.search(
            r"scanplane wait exhausted: session=(\S+) range=(\d+) after"
            r" (\d+)s",
            message,
        )
        if m is None:
            return None
        return cls(m.group(1), int(m.group(2)), float(m.group(3)))


class TransientError(LakeSoulError):
    """Marker base for failures that are expected to clear on their own
    (network blips, 5xx, races): the resilience layer
    (runtime/resilience.py) retries these and only these.  Raising a
    subclass is how a layer declares "try me again"."""


class OverloadedError(TransientError):
    """Admission control rejected the request: the in-flight bound and the
    bounded queue are both full (or the queue wait timed out).  Serving
    surfaces map this to Flight UNAVAILABLE — the client may back off and
    retry, which is why it is transient."""


class CircuitOpenError(TransientError):
    """A circuit breaker is open: recent failures crossed the threshold and
    the protected dependency is being given time to recover.  Calls fail
    fast instead of queueing behind a dead backend."""
