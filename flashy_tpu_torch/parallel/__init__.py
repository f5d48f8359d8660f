"""parallel of the PyTorch port (see the matching flashy_tpu.parallel):
device meshes (`mesh`), the port's layout records (`sharding`: `P`,
`NamedSharding`), data parallelism across processes and its sharded
forms (`data_parallel`: `wrap` as DistributedDataParallel, FSDP or a
declared ZeRO layout, `shard_batch`, `with_grad_accumulation`, the leaf
rule), the ZeRO-1 weight update (`zero`), the count of a step's
collectives (`accounting`), Megatron tensor parallelism over the
'tensor' process axis (`tensor`), pipeline parallelism over the 'pipe'
process axis (`pipeline`: GPipe, 1F1B, interleaved and packed, over the
host-side tables of `schedules`), sequence-parallel ring attention
(`ring`, and the single-kernel forward of `ring_fused`) and the expert
layer's grouped MLP and its expert-parallel exchange over the 'expert'
process axis (`moe_ep`)."""
from .mesh import (default_mesh, make_mesh, mesh_shape_from_devices,  # noqa: F401
                   set_default_mesh)
from .sharding import NamedSharding, P  # noqa: F401
from .data_parallel import (axis_leaf_sharding, batch_spec,  # noqa: F401
                            fsdp_sharding, replicate, shard_batch,
                            shard_params, with_grad_accumulation, wrap)
from .ring import ring_attention, ring_self_attention  # noqa: F401
from .ring_fused import fused_ring_attention  # noqa: F401
from .accounting import (collective_stats,  # noqa: F401
                         compare_collective_stats, count_collectives,
                         memory_stats, total_collective_bytes)
from .schedules import (PipelineSchedule, bubble_fraction,  # noqa: F401
                        build_1f1b_schedule, gpipe_bubble_fraction,
                        packed_bubble_fraction, packed_ticks, schedule_stats,
                        validate_pipeline_args)
# eager, as in the JAX package: `from flashy_tpu_torch.parallel import
# pipeline` must stay the GPipe entry point (once the submodule is
# imported, a lazy attribute would lose to the module object); `python -m
# flashy_tpu_torch.parallel.pipeline` pays runpy's double-import warning
from .pipeline import default_overlap, pipeline, pipeline_1f1b  # noqa: F401

# ZeRO and tensor-parallel exports resolve lazily (PEP 562), as in the
# JAX package: `python -m flashy_tpu_torch.parallel.zero` and
# `... .parallel.tensor` are CLI entry points, and an eager import here
# would put the module in sys.modules before runpy executes it (a
# double-execution RuntimeWarning on every run).
_LAZY_EXPORTS = {
    "zero_sharding": "zero", "zero_update": "zero",
    "per_device_bytes": "zero", "describe_state_sharding": "zero",
    "audit_expectations": "zero", "run_zero_bench": "zero",
    "model_state": "zero",
    "tensor_state_sharding": "tensor", "validate_tensor_args": "tensor",
    "flash_bwd_parity": "tensor", "run_tp_bench": "tensor",
    "run_pipeline_bench": "pipeline",
}


def __getattr__(name):
    module = _LAZY_EXPORTS.get(name)
    if module is not None:
        import importlib
        return getattr(importlib.import_module(f".{module}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY_EXPORTS))
