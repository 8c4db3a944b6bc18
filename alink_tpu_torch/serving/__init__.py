"""Online serving tier — concurrent request router with dynamic
micro-batching (port of ``alink_tpu.serving``, without the fleet, which
waits for ROADMAP A9).

The front end over :class:`~alink_tpu_torch.pipeline.LocalPredictor`:
concurrent predict requests are queued per loaded model and a batcher thread
coalesces them into micro-batches sized onto the shape-bucket ladder
(``common/jitcache.py``); per-row results scatter back to callers under
per-request deadlines. Admission control sheds load past a bounded queue's
high-water mark, a per-model circuit breaker degrades a failing model to
fast rejects, and the whole path is instrumented with ``serving.*`` spans,
histograms, and counters exported at ``GET /metrics``.
"""

from .router import (  # noqa: F401
    ModelServer,
    PredictFuture,
    ServingConfig,
    default_server,
    serving_bucket_ladder,
    serving_summary,
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
