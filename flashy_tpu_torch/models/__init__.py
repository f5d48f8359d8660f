"""models of the PyTorch port (see the matching flashy_tpu.models)."""
from .moe import MoEMLP, moe_aux_loss  # noqa: F401
