"""flashy_tpu_torch: the PyTorch/CUDA port of flashy_tpu.

These slices of the JAX package run here, on an NVIDIA H100:

* training: the solver harness (`BaseSolver`, XP folders and
  signatures, single-file checkpoints, logging) and the TransformerLM
  trained by `examples.lm.solver`, whose attention runs the hand-written
  Hopper flash kernels of `csrc/flash_attention.cu` (`ops.attention`),
  whose dropless MoE experts (`models.MoEMLP`) run the grouped-GEMM
  kernels of `csrc/grouped_matmul.cu` (`ops.grouped_matmul`), and whose
  sequence-parallel attention (`attention='ring_fused'`, `mesh.seq > 1`)
  runs the ring kernel of `csrc/ring_attention.cu` (`parallel.ring_fused`)
  over ranks that share one card;
  The LM trainer's switches: selective remat (`remat_policy`), dropout,
  a parameter EMA (`ema`), SSD training (the scan kernel's forward, the
  plain chunked form's backward); TensorBoard and wandb backends
  (`loggers`); `python -m flashy_tpu_torch.info` lists the XPs;
* serving: the TransformerLM behind a paged KV cache and a continuous-
  batching scheduler, every paged-attention read through the kernel of
  `csrc/paged_decode.cu` (`ops.paged_decode`);
* fault tolerance (`resilience`): the preemption guard, retried IO,
  checkpoint manifests with A/B slots and asynchronous saves, the hang
  watchdog, the chaos drill (`python -m flashy_tpu_torch.resilience`)
  and the chaos campaign (`--campaign`);
* streaming input (`datapipe`): sharded streams, weighted mixtures,
  packing into static [B, L] batches with segment ids, a prefetch
  thread, cursors committed with the state (`python -m
  flashy_tpu_torch.datapipe` is the kill/resume drill); `launch` and
  `sweep` plan multi-host commands and grid sweeps.

Entry points run on `cuda` unless the caller passes `device="cpu"`; the
package imports torch, numpy and yaml, never JAX or the JAX package.
"""

__version__ = "0.2.0"

from . import distrib  # noqa: F401
from .formatter import Formatter  # noqa: F401
from .logging import LogProgressBar, ResultLogger, bold, setup_logging  # noqa: F401
from .resilience import enable_preemption_guard  # noqa: F401
from .solver import BaseSolver  # noqa: F401
from .utils import averager  # noqa: F401
from .xp import get_xp, main  # noqa: F401
