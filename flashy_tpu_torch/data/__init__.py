"""Data loading of the PyTorch port (the port of flashy_tpu.data):
per-process sharded batching with numpy collation on host threads, and
`prefetch_to_device`, which keeps batches in flight to the card."""
from .loader import (DataLoader, ShardedSampler, StridedShard,  # noqa: F401
                     default_collate, masked_mean, prefetch_to_device)
