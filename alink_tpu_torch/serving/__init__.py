"""Online serving tier — concurrent request router with dynamic
micro-batching (port of ``alink_tpu.serving``).

The front end over :class:`~alink_tpu_torch.pipeline.LocalPredictor`:
concurrent predict requests are queued per loaded model and a batcher thread
coalesces them into micro-batches sized onto the shape-bucket ladder
(``common/jitcache.py``); per-row results scatter back to callers under
per-request deadlines. Admission control sheds load past a bounded queue's
high-water mark, a per-model circuit breaker degrades a failing model to
fast rejects, and the whole path is instrumented with ``serving.*`` spans,
histograms, and counters exported at ``GET /metrics``.

Above the single-process server sits the fault-tolerant fleet
(:mod:`.fleet`): N worker processes, each running a ModelServer on its own
CUDA context behind a real socket, a failover load balancer
(:mod:`.fleet_frontend`) that re-dispatches requests off dead replicas,
health-driven respawn with zero-trace sidecar warmup, graceful drain,
fleet-wide hot-swap, and backpressure autoscaling — results bit-identical
to the single-process server.
"""

from .router import (  # noqa: F401
    ModelServer,
    PredictFuture,
    ServingConfig,
    default_server,
    serving_bucket_ladder,
    serving_summary,
)
from .fleet_frontend import (  # noqa: F401
    FleetFrontend,
    FrontendListener,
    ReplicaClient,
)
from .warmup_store import (  # noqa: F401
    load_warmup_spec,
    save_warmup_spec,
    warmup_sidecar_path,
)

from ..common.exceptions import (  # noqa: F401
    AkDeadlineExceededException,
    AkServingOverloadException,
)

_FLEET_NAMES = ("FleetConfig", "ServingFleet", "active_fleet_summary")


def __getattr__(name):
    # the fleet's names resolve on first use: a replica runs
    # ``python -m alink_tpu_torch.serving.fleet``, and importing the module
    # here first would make that run a second copy of it
    if name in _FLEET_NAMES:
        from . import fleet

        return getattr(fleet, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
