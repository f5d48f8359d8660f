"""Int8 KV-cache quantization (port of flashy_tpu/models/quantize.py's
KV half). Symmetric absmax over head_dim, one f32 scale per cache row
per head; `torch.round` rounds half to even like `jnp.round`, so the
payloads come out bit-equal to the JAX package's.

Weight quantization (`quantize_lm_params`) is ROADMAP.md queue A
item 3, L8.
"""
import typing as tp

import torch

# Symmetric int8 range: values land in [-QMAX, QMAX].
QMAX = 127.0


def is_quantized(leaf: tp.Any) -> bool:
    """True for a {"q", "scale"} quantized-tensor dict."""
    return (isinstance(leaf, dict) and set(leaf) == {"q", "scale"}
            and getattr(leaf.get("q"), "dtype", None) == torch.int8)


def _safe_scale(absmax: torch.Tensor) -> torch.Tensor:
    """absmax -> quant scale; an all-zero row gets a unit scale so q == 0
    and the dequantized row is exactly zero."""
    return torch.where(absmax > 0, absmax.clamp_min(1e-12),
                       torch.full_like(absmax, QMAX)) / QMAX


def quantize_kv(x: torch.Tensor) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """K or V rows [..., head_dim] -> (int8 payload, f32 scale [...])."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = _safe_scale(absmax)
    q = torch.round(xf / scale).clamp(-QMAX, QMAX).to(torch.int8)
    return q, scale[..., 0]


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of `quantize_kv`: int8 rows + per-row scales -> `dtype`."""
    return (q.float() * scale[..., None]).to(dtype)
