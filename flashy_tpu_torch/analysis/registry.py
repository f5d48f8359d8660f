"""Registry of the fault-injection sites that the framework's
`fault_point` calls declare (see `flashy_tpu_torch.resilience.chaos`):
the universe the chaos campaign (`resilience.campaign`) sweeps.
`FAULT_SITE_PREFIXES` covers dynamic sites such as ``logger.<backend>``.

A copy of flashy_tpu/analysis/registry.py, kept as data: the port has no
AST scan of its own yet. ROADMAP.md queue A item 12 ports the scan
(`python -m flashy_tpu_torch.analysis --write-registry`), which will
regenerate this file from the port's own `fault_point` calls. Sites the
port does not reach yet (the fleet's, the pipeline's, the tensor step's,
the elastic drill's) are listed all the same: the campaign's scenarios
for them raise, naming their ROADMAP items.
"""

FAULT_SITES = frozenset({
    'campaign.run',
    'ckpt.load',
    'ckpt.manifest',
    'ckpt.pointer',
    'ckpt.reshard',
    'ckpt.write',
    'datapipe.batch',
    'datapipe.resplit',
    'drill.elastic_step',
    'drill.step',
    'fleet.engine_step',
    'fleet.status',
    'fleet.wal_append',
    'fleet.wal_replay',
    'history.write',
    'pipeline.packed_tick',
    'pipeline.tick',
    'serve.pool',
    'serve.step',
    'tensor.step',
})

FAULT_SITE_PREFIXES = (
    'logger.',
)
