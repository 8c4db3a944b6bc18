"""Common runtime of the port (``alink_tpu.common``): the epoch-based
exactly-once stream recovery runtime is re-exported here, as the reference
does; the other modules are imported by their own names."""

from .recovery import (  # noqa: F401
    CheckpointCoordinator,
    RecoverableStreamJob,
    SnapshotStore,
    TransactionalSink,
    is_restartable,
    recovery_summary,
    run_with_recovery,
)
