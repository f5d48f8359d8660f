"""Continuous-batching serving of the PyTorch port (see the matching
flashy_tpu.serve): a slot engine over a dense, paged or SSD cache with
captured CUDA-graph steps, speculative decoding with n-gram or model
drafts, and the scheduler that feeds it, with request tracing, the
`serve.json` status file and the chaos fault points. `serve.fleet` puts
several engines behind a router (quotas, the disaggregated handoff,
engine-death re-routing, the request WAL).

`python -m flashy_tpu_torch.serve` runs the serving demo's legs, `python
-m flashy_tpu_torch.serve.fleet` the fleet's."""

from ..utils import percentile  # noqa
from .compile_cache import CompileCache, bucket_length  # noqa
from .draft import DraftProvider, ModelDraft, NGramDraft  # noqa
from .engine import DecodeEngine, SlotAllocator  # noqa
from .metrics import ServeMetrics  # noqa
from .paged import (BlockPool, POOL_FAULT_SITE, PoolExhausted,  # noqa
                    PrefixIndex)
from .scheduler import ContinuousBatchingScheduler, QueueFull, Request  # noqa
from .tracing import RequestTracer  # noqa

__all__ = [
    "DecodeEngine", "SlotAllocator", "ContinuousBatchingScheduler",
    "Request", "QueueFull", "CompileCache", "bucket_length", "ServeMetrics",
    "DraftProvider", "NGramDraft", "ModelDraft",
    "BlockPool", "PoolExhausted", "PrefixIndex", "POOL_FAULT_SITE",
    "RequestTracer", "percentile",
]
