"""parallel of the PyTorch port (see the matching flashy_tpu.parallel):
device meshes (`mesh`), sequence-parallel ring attention (`ring`, and the
single-kernel forward of `ring_fused`) and the single-device half of the
expert layer's grouped MLP (`moe_ep`)."""
from .mesh import (default_mesh, make_mesh, mesh_shape_from_devices,  # noqa: F401
                   set_default_mesh)
from .ring import ring_attention, ring_self_attention  # noqa: F401
from .ring_fused import fused_ring_attention  # noqa: F401
