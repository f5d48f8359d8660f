"""Int8 quantization (port of flashy_tpu/models/quantize.py): weights
for decoding and K/V rows for the paged cache. Symmetric absmax, values
in [-QMAX, QMAX], scale = absmax / QMAX; `torch.round` rounds half to
even like `jnp.round`, so on the same f32 input the payloads and scales
come out bit-equal to the JAX package's.

Weights (`quantize_lm_params`): each matmul kernel leaf W of a
JAX-shaped parameter tree (`models.decoding.lm_params`) becomes
{"q": int8, "scale": f32}, the absmax taken over the kernel's
contraction axes, so the scale is per output channel and applies to the
product's output (`models.decoding._kernel`, `_postscale`). Norms, SSD
`dt_bias` and kernels, and MoE routers stay dense.

K/V rows (`quantize_kv`): absmax over head_dim, one f32 scale per cache
row per head.
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


def _quantize(w: torch.Tensor, contract_axes: tp.Sequence[int]
              ) -> tp.Dict[str, torch.Tensor]:
    """Symmetric absmax int8 over `contract_axes` (scale per out-channel,
    the contracted axes kept at size 1)."""
    w = w.float()
    absmax = w.abs().amax(dim=tuple(contract_axes), keepdim=True)
    scale = _safe_scale(absmax)
    q = torch.round(w / scale).clamp(-QMAX, QMAX).to(torch.int8)
    return {"q": q, "scale": scale}


def dequantize(leaf: tp.Any, dtype: torch.dtype = torch.float32
               ) -> tp.Any:
    """{"q", "scale"} -> a dense tensor in `dtype`; other leaves as they
    are."""
    if not is_quantized(leaf):
        return leaf
    return (leaf["q"].float() * leaf["scale"]).to(dtype)


# Kernel -> contraction axes of its decode product (models/decoding.py):
# the scale is constant over exactly these. The SSD kernels have no
# entry: they stay dense.
_CONTRACT_AXES = {
    "embed": (1,),                # the head "btd,vd->btv" contracts d
    ("attn", "qkv"): (0,),        # "btd,dchk->btchk"
    ("attn", "out"): (0, 1),      # "bqhd,hdD->bqD"
    ("mlp", "up"): (0,),          # "btd,df->btf"
    ("mlp", "down"): (0,),        # "btf,fd->btd"
    ("moe", "w_up"): (1,),        # [E, D, F]: contracts D per expert
    ("moe", "w_down"): (1,),      # [E, F, D]: contracts F per expert
}


def quantize_lm_params(params: tp.Any, *,
                       keep_embed_dense: bool = False) -> tp.Any:
    """Quantize a TransformerLM parameter tree's matmul kernels to int8.

    Takes the JAX-shaped tree of f32 tensors (`models.decoding.
    lm_params`), or the variables dict around it ({"params": ...}), and
    returns the same structure with each large kernel replaced by
    {"q": int8, "scale": f32}. In the scan-stacked layout (`blocks`)
    every leaf has a leading [L] dim, so the contraction axes shift by
    one and the scales stay per (layer, out-channel).
    `keep_embed_dense=True` leaves the tied embedding and head table in
    full precision. `generate(..., params=...)` and the serving engine
    decode the result; `dequantize_lm_params` recovers dense weights.
    """
    wrapped = isinstance(params, dict) and set(params) == {"params"}
    tree = params["params"] if wrapped else params

    def walk(node, path):
        if not isinstance(node, dict) or is_quantized(node):
            return node
        shift = 1 if "blocks" in path else 0

        def axes(key):
            return tuple(a + shift for a in _CONTRACT_AXES[key])

        out = {}
        for name, child in node.items():
            if name == "embed" and not isinstance(child, dict):
                out[name] = (child if keep_embed_dense
                             else _quantize(child, _CONTRACT_AXES["embed"]))
            elif name == "kernel" and len(path) >= 2 \
                    and (path[-2], path[-1]) in _CONTRACT_AXES:
                out[name] = _quantize(child, axes((path[-2], path[-1])))
            elif name in ("w_up", "w_down") and path \
                    and path[-1] == "moe" and not isinstance(child, dict):
                out[name] = _quantize(child, axes(("moe", name)))
            else:
                out[name] = walk(child, path + (name,))
        return out

    result = walk(tree, ())
    return {"params": result} if wrapped else result


def dequantize_lm_params(params: tp.Any,
                         dtype: torch.dtype = torch.float32) -> tp.Any:
    """Inverse of `quantize_lm_params` (up to rounding error)."""
    if is_quantized(params):
        return dequantize(params, dtype)
    if isinstance(params, dict):
        return {k: dequantize_lm_params(v, dtype) for k, v in params.items()}
    return params


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
