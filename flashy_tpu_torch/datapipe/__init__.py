"""The streaming data pipeline of the PyTorch port (the port of
flashy_tpu.datapipe): stream -> mix -> pack -> prefetch.

  * ShardedTextStream  disjoint per-process file shards -> documents
  * MixtureStream      counter-keyed weighted sampling over N sources
  * SequencePacker     greedy packing into static [B, L] numpy batches
                       with `segment_ids` and `positions`
  * prefetch           a background thread a few batches ahead
  * resplit_*_states   re-partition per-rank cursors N -> M;
                       ElasticCursorGroup checkpoints N pipes as one unit

Every stage implements the CheckpointableIterator protocol, so the
outermost stage registered through `BaseSolver.register_stateful` makes
`commit()` persist the exact input cursor and a preempted run resumes
token-exact mid-epoch; `python -m flashy_tpu_torch.datapipe` is the
drill that proves it. The numerics-audit registry (`datapipe/audit.py`)
waits for ROADMAP.md queue A item 12.

Importing this package touches no CUDA device.
"""

from .elastic import (  # noqa
    ElasticCursorGroup, resplit_mixture_states, resplit_packer_states,
    resplit_prefetch_states, resplit_states, resplit_stream_states,
)
from .iterator import CheckpointableIterator, PipelineStage  # noqa
from .mixture import MixtureStream  # noqa
from .packing import SequencePacker  # noqa
from .prefetch import PrefetchIterator, prefetch  # noqa
from .stream import ShardedTextStream  # noqa

__all__ = [
    "CheckpointableIterator", "PipelineStage", "ShardedTextStream",
    "MixtureStream", "SequencePacker", "PrefetchIterator", "prefetch",
    "ElasticCursorGroup", "resplit_states", "resplit_stream_states",
    "resplit_mixture_states", "resplit_packer_states",
    "resplit_prefetch_states",
]
