"""Plain attention over [B, T, H, D] tensors (port of ops/attention.py's
`dot_product_attention` and its `_guarded_probs` convention).

The flash-attention kernels of the JAX package belong to the training
slice (ROADMAP queue B rows 1-4); only the plain path exists here.
"""
import math
import typing as tp

import numpy as np
import torch

NEG_INF = -1e30


def score_scale(head_dim: int) -> float:
    """1/sqrt(head_dim) in f32 arithmetic, as the JAX package's cached
    and paged reads compute it (`1 / jnp.sqrt(jnp.float32(head_dim))`)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(head_dim)))


def _guarded_probs(scores: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """exp(scores - ref) with fully-masked rows forced to zero.

    `ref` is a per-row statistic that sits at ~NEG_INF when the row saw
    no visible key; there exp(scores - ref) would be exp(0) = 1 for
    every masked key. A query with no visible key attends to nothing.
    """
    return torch.where(ref > NEG_INF * 0.5, torch.exp(scores - ref),
                       torch.zeros((), dtype=scores.dtype,
                                   device=scores.device))


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False,
                          mask: tp.Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain attention over [B, T, H, D] tensors; scores in f32.

    Queries with no visible key produce zero output rather than
    softmax's uniform average over masked keys. Causal masks align
    bottom-right (`offset = t_k - t_q`).
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        t_q, t_k = q.shape[1], k.shape[1]
        causal_mask = torch.ones((t_q, t_k), dtype=torch.bool,
                                 device=q.device).tril(t_k - t_q)
        scores = scores.masked_fill(~causal_mask[None, None], NEG_INF)
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    probs = _guarded_probs(scores, m)
    denom = probs.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    probs = probs / denom
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
