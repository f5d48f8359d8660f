"""ops of the PyTorch port (see the matching flashy_tpu.ops)."""
