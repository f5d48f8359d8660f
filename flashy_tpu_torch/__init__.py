"""flashy_tpu_torch: the PyTorch/CUDA port of flashy_tpu's serving path.

Serves the TransformerLM through a paged KV cache and a continuous-
batching scheduler; every paged-attention read on a CUDA tensor goes
through the hand-written Hopper kernel in `csrc/paged_decode.cu`
(`ops.paged_decode`). Entry points run on `cuda` unless the caller
passes `device="cpu"`; the package imports torch and numpy only.
"""

__version__ = "0.1.0"
