"""Prompt-length bucketing (port of flashy_tpu/serve/compile_cache.py's
`bucket_length`). The JAX package's `CompileCache` pins one compiled
executable per shape; PyTorch runs eagerly, and its counterpart here is
a set of captured CUDA graphs: ROADMAP.md queue A item 3, L3.
"""
import typing as tp


def bucket_length(n: int, *, minimum: int = 4,
                  maximum: tp.Optional[int] = None) -> int:
    """Round `n` up to the next power of two (>= `minimum`), capped at
    `maximum`; `n` beyond `maximum` raises (the request cannot fit)."""
    if n < 1:
        raise ValueError(f"cannot bucket a length < 1, got {n}")
    bucket = minimum
    while bucket < n:
        bucket *= 2
    if maximum is not None:
        if n > maximum:
            raise ValueError(f"length {n} exceeds the bucket cap {maximum}")
        bucket = min(bucket, maximum)
    return bucket
