"""Serving of the port (counterpart of ``repro.serve``): the batched
engine, its per-token reference and the fault-tolerant server."""
from repro_torch.serve.engine import (  # noqa: F401
    BatchedServer, ReferenceServer, Request, RequestRejected, bucket_length,
    greedy_decode,
)
from repro_torch.serve.resilience import (  # noqa: F401
    HealthMonitor, HealthVerdict, ResilienceConfig, ResilientServer,
)
