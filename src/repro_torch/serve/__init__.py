"""Serving of the port (this slice: the batched engine)."""
from repro_torch.serve.engine import (  # noqa: F401
    BatchedServer, Request, RequestRejected, bucket_length, greedy_decode,
)
