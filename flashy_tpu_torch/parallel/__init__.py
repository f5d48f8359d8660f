"""parallel of the PyTorch port (see the matching flashy_tpu.parallel):
the single-device half of the expert layer's grouped MLP (`moe_ep`)."""
