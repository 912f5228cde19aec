"""Error types of the port (the subset of ``lakesoul_tpu/errors.py`` that
the ported layers raise, kept as the port's own copy)."""


class LakeSoulError(Exception):
    """Base class for all lakesoul_tpu_torch errors."""


class ConfigError(LakeSoulError):
    pass


class VectorIndexError(LakeSoulError):
    pass


class TransientError(LakeSoulError):
    """Marker base for failures that are expected to clear on their own:
    a caller may retry these and only these."""


class OverloadedError(TransientError):
    """Admission control rejected the request: the bounded queue is full.
    The client may back off and retry, which is why it is transient."""
