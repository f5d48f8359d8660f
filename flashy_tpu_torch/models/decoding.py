"""KV-cache decoding for the port's TransformerLM (port of
flashy_tpu/models/decoding.py): every layout the JAX package decodes,
per-layer models (attention, SSD and hybrid stacks) and scan-stacked
ones, with dense or MoE MLPs and dense or int8 weights.

`generate` is the oracle the serving engine is held to, on the CPU and
on the card: it reads its dense `[B, max_len, H, Dh]` cache with plain
einsums, no kernel, as the engine's dense layout does. Its sampling
takes `top_k` and `top_p` (`nucleus_filter`); `speculative_acceptance`
turns a verify step's logits into emitted tokens. PyTorch runs eagerly,
so the JAX package's `lax.scan` token loop becomes a Python loop, and
cache writes update the cache tensors in place instead of returning
fresh arrays (one cache allocation per call instead of one per step).
SSD layers keep one [B, H, Dh, N] f32 state instead of K/V slabs: a
multi-token call runs the chunked scan (the Hopper SSD kernel on CUDA),
a one-token call the recurrence. MoE blocks decode dropless
(`_moe_forward`, plain PyTorch: the JAX package has no kernel there).
A scan-stacked model's cache is stacked too ([L, ...] leaves) and its
layer loop runs the same layer functions on per-layer views of the
stacked parameters and cache (`_blocks`, `cache_entries`): nothing
moves between layers but the activations.

The step functions read a nested parameter dict shaped like the JAX
tree (`decode_params`), with the dense matmul kernels already cast to
the compute dtype — bitwise the same as the JAX package's cast at use.
Int8 kernels (`models.quantize.quantize_lm_params`) stay resident as
{"q": int8, "scale": f32} and are converted at use (`_kernel`), their
scale applied to the product's output (`_postscale`), as the JAX
package does.
"""
import numbers
import typing as tp

import numpy as np
import torch

from ..ops.attention import score_scale
from ..ops.losses import head_matmul
from ..ops.ssd_scan import ssd_chunked_scan, ssd_recurrent_scan
from ..parallel.moe_ep import _gelu
from ..utils import check_same_device, resolve_device
from .quantize import is_quantized
from .ssd import ssd_projections
from .transformer import (TransformerConfig, TransformerLM, _rotary,
                          check_supported, mixer_pattern,
                          rmsnorm as _rmsnorm)

Params = tp.Dict[str, tp.Any]


def lm_params(model: TransformerLM) -> Params:
    """The model's f32 weights (detached, shared) in the JAX package's
    tree shape: `embed`, `norm_f/scale` and `block_i/...`, or a stacked
    model's `blocks/block/...` with a leading [L] on every leaf. The
    input of `models.quantize.quantize_lm_params`."""
    tree: Params = {}
    for name, param in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = param.detach()
    return tree


# leaves that stay f32 in decoding: the norms (rmsnorm multiplies in
# f32), the router (applied to f32 activations) and the SSD dt bias
_DENSE_F32 = ("scale", "dt_bias")


def decode_params(model: TransformerLM, *,
                  params: tp.Optional[Params] = None) -> Params:
    """The weights the decode steps read: `params` (a JAX-shaped tree,
    per-layer or stacked, dense or quantized by `quantize_lm_params`;
    the variables dict around it is accepted) or, by default, the
    model's own (`lm_params`). `model` gives the config.

    Dense matmul kernels and the embedding are cast to `config.dtype`
    once, so the row lookup and the tied head (`ops.losses.head_matmul`,
    f32 accumulation) see exactly the operands the JAX package's
    cast-at-use gives them. Norm scales, routers and `dt_bias` stay f32.
    Quantized leaves stay {"q": int8, "scale": f32}, resident as int8.
    """
    cfg = model.config
    check_supported(cfg)
    if params is None:
        params = lm_params(model)
    elif isinstance(params, dict) and set(params) == {"params"}:
        params = params["params"]

    def walk(node, path):
        if is_quantized(node):
            return node
        if isinstance(node, dict):
            return {key: walk(child, path + (key,))
                    for key, child in node.items()}
        if path[-1] in _DENSE_F32 or "router" in path:
            return node.detach()
        return node.detach().to(cfg.dtype)

    with torch.no_grad():
        return walk(params, ())


def _blocks(cfg: TransformerConfig, params: Params) -> tp.List[Params]:
    """Each layer's parameter dict: a per-layer tree's `block_i`, or
    views of a stacked tree's `blocks/block` leaves at layer i."""
    if not cfg.scan_layers:
        return [params[f"block_{i}"] for i in range(cfg.num_layers)]

    def take(node, i):
        if isinstance(node, dict):
            return {key: take(child, i) for key, child in node.items()}
        return node[i]

    return [take(params["blocks"]["block"], i)
            for i in range(cfg.num_layers)]


def cache_entries(cfg: TransformerConfig, cache: tp.Dict
                  ) -> tp.List[tp.Dict[str, torch.Tensor]]:
    """Each layer's cache entry ({'k', 'v'} or {'ssd'}): a per-layer
    cache's `block_i`, or views of a stacked cache's leaves at layer i.
    Writing into an entry writes into the cache."""
    if not cfg.scan_layers:
        return [cache[f"block_{i}"] for i in range(cfg.num_layers)]
    return [{leaf: t[i] for leaf, t in cache.items()}
            for i in range(cfg.num_layers)]


def cache_leaves(cache: tp.Dict) -> tp.List[tp.Tuple[str, torch.Tensor]]:
    """(leaf name, tensor) of every leaf of a cache, per-layer or stacked
    ([L, ...] leaves), in a fixed order. Every leaf keeps its slot dim at
    position -4."""
    return [(leaf, t) for name, node in cache.items()
            for leaf, t in (node.items() if isinstance(node, dict)
                            else ((name, node),))]


def _kernel(w: tp.Any, dtype: torch.dtype
            ) -> tp.Tuple[torch.Tensor, tp.Optional[torch.Tensor]]:
    """A kernel leaf's matmul operand and output scale: an int8 leaf's
    payload converted to `dtype` at use and its per-output-channel
    scale; a dense leaf as it is (cast once by `decode_params`) and
    None."""
    if is_quantized(w):
        return w["q"].to(dtype), w["scale"]
    return w, None


def _postscale(out: torch.Tensor, scale: tp.Optional[torch.Tensor]
               ) -> torch.Tensor:
    """Apply a kernel's output scale (broadcast over leading dims)."""
    if scale is None:
        return out
    return out * scale.to(out.dtype)


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device: tp.Any) -> tp.Dict[str, tp.Any]:
    """Zeroed dense cache: one {'k', 'v'} [B, max_len, H, Dh] slab pair
    per attention layer, in the compute dtype, and one {'ssd'} f32 state
    [B, H, Dh, N] per SSD layer (no max_len dimension). A scan-stacked
    model (uniform mixers) gets single stacked leaves instead: {'k', 'v'}
    [L, B, max_len, H, Dh], or {'ssd'} [L, B, H, Dh, N]. Every leaf keeps
    the slot dim at position -4.

    Each slab is a view of a [..., B, max_len + 1, H, Dh] tensor: the row
    past its end is where a per-row write that falls past the cache lands
    (`_cache_write`). Attention reads the view only, and the view is what
    the engine's byte accounting counts.
    """
    check_supported(cfg)
    lead = (cfg.num_layers,) if cfg.scan_layers else ()
    shape = lead + (batch, max_len + 1, cfg.num_heads, cfg.head_dim)
    sshape = lead + (batch, cfg.num_heads, cfg.head_dim, cfg.ssd_state_dim)

    def entry(mixer):
        if mixer == "ssd":
            return {"ssd": torch.zeros(sshape, dtype=torch.float32,
                                       device=device)}
        return {leaf: torch.zeros(shape, dtype=cfg.dtype,
                                  device=device)[..., :max_len, :, :]
                for leaf in ("k", "v")}

    pattern = mixer_pattern(cfg)
    if cfg.scan_layers:
        return entry(pattern[0])
    return {f"block_{i}": entry(mixer) for i, mixer in enumerate(pattern)}


def with_spare_row(slab: torch.Tensor) -> torch.Tensor:
    """The [..., B, max_len + 1, H, Dh] tensor under an `init_cache` slab
    view [..., B, max_len, H, Dh] (the same storage, its spare row
    included)."""
    length = slab.shape[-3]
    if slab.stride(-4) != (length + 1) * slab.stride(-3):
        raise ValueError("a per-row cache write needs the slab's spare row: "
                         "allocate the cache with init_cache")
    shape = slab.shape[:-3] + (length + 1,) + slab.shape[-2:]
    return slab.as_strided(shape, slab.stride(), slab.storage_offset())


def _cache_write(cache: torch.Tensor, new: torch.Tensor,
                 cache_index: tp.Union[int, torch.Tensor]) -> torch.Tensor:
    """Write `new` [B, S, H, Dh] into `cache` at `cache_index`, in place.

    An int writes the same offset for every row. A [B] tensor writes each
    row at its own offset, and rows that fall past the cache (a parked
    slot at max_len; a verify step's rows past the end) are dropped, not
    clamped: a clamp would overwrite the last real position.

    The per-row form is one scatter with no data-dependent shape and no
    host sync, so a CUDA graph can capture it. Its design: every dropped
    row is sent to the slab's spare row past its end (`init_cache`), which
    attention never reads. A real row's index is its own (row, position),
    distinct from every other write's, and only dropped rows share an
    index, the spare row, so the scatter's unspecified order among
    duplicate indices never decides what a real row holds.
    """
    if not torch.is_tensor(cache_index):
        cache[:, cache_index:cache_index + new.shape[1]] = new
        return cache
    batch, seq = new.shape[:2]
    max_len = cache.shape[1]
    rows = torch.arange(batch, device=cache.device)[:, None].expand(batch, seq)
    cols = cache_index[:, None] + torch.arange(seq, device=cache.device)
    cols = torch.where(cols < max_len, cols, max_len)
    with_spare_row(cache).index_put_((rows, cols), new)
    return cache


def _cached_self_attention(cfg: TransformerConfig, bp: tp.Dict,
                           x: torch.Tensor, positions: torch.Tensor,
                           k_cache: torch.Tensor, v_cache: torch.Tensor,
                           cache_index: tp.Union[int, torch.Tensor]):
    """Pre-norm causal self-attention against the K/V cache.

    Returns (x + attn_out, k_cache, v_cache); the mask derives from
    `positions`, so rows at different lengths attend their own prefix.
    """
    normed = _rmsnorm(x, bp["norm1"]["scale"], cfg.dtype)
    qkv_w, qkv_s = _kernel(bp["attn"]["qkv"]["kernel"], cfg.dtype)
    qkv = _postscale(torch.einsum("btd,dchk->btchk", normed, qkv_w), qkv_s)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    q = _rotary(q, positions)
    k = _rotary(k, positions)
    k_cache = _cache_write(k_cache, k.to(cfg.dtype), cache_index)
    v_cache = _cache_write(v_cache, v.to(cfg.dtype), cache_index)

    max_len = k_cache.shape[1]
    scale = score_scale(cfg.head_dim)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k_cache.float()) * scale
    key_pos = torch.arange(max_len, device=x.device)
    mask = key_pos[None, None, :] <= positions[:, :, None]   # [B, S, L]
    scores = scores.masked_fill(~mask[:, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    attn = torch.einsum("bhqk,bkhd->bqhd", probs.to(cfg.dtype), v_cache)
    return x + _attention_out(cfg, bp, attn), k_cache, v_cache


def _attention_out(cfg: TransformerConfig, bp: tp.Dict,
                   attn: torch.Tensor) -> torch.Tensor:
    """The attention output projection [B, T, H, Dh] -> [B, T, D]."""
    out_w, out_s = _kernel(bp["attn"]["out"]["kernel"], cfg.dtype)
    return _postscale(torch.einsum("bqhd,hdD->bqD", attn, out_w), out_s)


def _gated_mlp(bp_mlp: tp.Dict, normed: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """SwiGLU MLP on pre-normed input (int8 kernels supported)."""
    up_w, up_s = _kernel(bp_mlp["up"]["kernel"], dtype)
    gate, value = _postscale(normed @ up_w, up_s).chunk(2, dim=-1)
    down_w, down_s = _kernel(bp_mlp["down"]["kernel"], dtype)
    return _postscale((torch.nn.functional.silu(gate) * value) @ down_w,
                      down_s)


# Above this many tokens, per-token expert-weight gathers ([N, D, F]
# buffers) dominate memory; switch to streaming over experts instead.
_MOE_GATHER_MAX_TOKENS = 64


def _take_expert(w: tp.Any, index: torch.Tensor, dtype: torch.dtype
                 ) -> tp.Tuple[torch.Tensor, tp.Optional[torch.Tensor]]:
    """Per-token expert slabs [N, in, out] in `dtype` and, for an int8
    leaf, their output scales [N, out] (only the gathered slabs are
    converted)."""
    if is_quantized(w):
        return w["q"][index].to(dtype), w["scale"][index][:, 0, :]
    return w[index], None


def _moe_forward(cfg: TransformerConfig, mp: tp.Dict,
                 x: torch.Tensor) -> torch.Tensor:
    """Dropless routed MoE for decoding: [B, S, D] -> [B, S, D].

    MoEMLP's routing (f32 softmax router, raw-probability gates,
    sequential top-k argmax) without capacity buffers, in one of two
    equivalent evaluation orders picked by N = B * S, as in the JAX
    package: up to `_MOE_GATHER_MAX_TOKENS` tokens (decode steps) gather
    each token's expert slabs; more (a prefill) stream over the experts,
    every token against one expert at a time, weighted by its combine
    gate (zero for unrouted pairs). Int8 expert slabs apply their scales
    to each product's output, before the nonlinearity.
    """
    batch, seq, dim = x.shape
    n_tokens = batch * seq
    x_flat = x.reshape(n_tokens, dim)
    probs = torch.softmax(x_flat.float() @ mp["router"]["kernel"].float(),
                          dim=-1)                                  # [N, E]
    num_experts = probs.shape[-1]
    experts = torch.arange(num_experts, device=x.device)
    x_c = x_flat.to(cfg.dtype)
    out = torch.zeros((n_tokens, dim), dtype=torch.float32, device=x.device)
    combine = torch.zeros_like(probs)
    remaining = probs
    for _ in range(cfg.moe_top_k):
        expert_index = torch.argmax(remaining, dim=-1)
        gate = torch.gather(remaining, -1, expert_index[:, None])[:, 0]
        onehot = (expert_index[:, None] == experts).to(probs.dtype)
        if n_tokens <= _MOE_GATHER_MAX_TOKENS:
            up, up_s = _take_expert(mp["w_up"], expert_index, cfg.dtype)
            down, down_s = _take_expert(mp["w_down"], expert_index,
                                        cfg.dtype)
            h = _gelu(_postscale(torch.einsum("nd,ndf->nf", x_c, up), up_s))
            y = _postscale(torch.einsum("nf,nfd->nd", h, down), down_s)
            out = out + gate[:, None] * y.float()
        combine = combine + gate[:, None] * onehot
        remaining = remaining * (1.0 - onehot)
    if n_tokens > _MOE_GATHER_MAX_TOKENS:
        for e in range(num_experts):
            up_w, up_s = _kernel(_expert(mp["w_up"], e), cfg.dtype)
            down_w, down_s = _kernel(_expert(mp["w_down"], e), cfg.dtype)
            h = _gelu(_postscale(x_c @ up_w, up_s))
            y = _postscale(h @ down_w, down_s)
            out = out + combine[:, e:e + 1] * y.float()
    return out.reshape(batch, seq, dim).to(cfg.dtype)


def _expert(w: tp.Any, e: int) -> tp.Any:
    """Expert e's slab of an [E, ...] leaf (int8: payload and scale)."""
    if is_quantized(w):
        return {"q": w["q"][e], "scale": w["scale"][e]}
    return w[e]


def _mlp_forward(cfg: TransformerConfig, bp: tp.Dict,
                 normed: torch.Tensor) -> torch.Tensor:
    """The block's MLP on pre-normed input: routed experts or SwiGLU."""
    if "moe" in bp:
        return _moe_forward(cfg, bp["moe"], normed)
    return _gated_mlp(bp["mlp"], normed, cfg.dtype)


def _ssd_mixer_forward(cfg: TransformerConfig, bp: tp.Dict, x: torch.Tensor,
                       state: torch.Tensor,
                       token_mask: tp.Optional[torch.Tensor],
                       state_mask: tp.Optional[torch.Tensor]):
    """Pre-norm SSD mixer against the resident [B, H, Dh, N] f32 state.

    Returns (x + mixer_out, new_state). A one-token call (a decode tick)
    advances the recurrence; a multi-token call (a prefill slice) runs
    the chunked form, whose fixed chunk tiling makes any chunk-aligned
    split of a stream bit-identical to one call. `token_mask` [B, S]
    keeps right-padded tokens out of the state; `state_mask` [B] False
    freezes a row's state (the engine's inactive slots).
    """
    normed = _rmsnorm(x, bp["norm1"]["scale"], cfg.dtype)
    cbv_w, cbv_s = _kernel(bp["ssd"]["cbv"]["kernel"], cfg.dtype)
    c, b, v, log_a = ssd_projections(cfg, normed, cbv_w,
                                     bp["ssd"]["dt_bias"], cbv_s)
    if x.shape[1] == 1:
        y, new_state = ssd_recurrent_scan(c, b, v, log_a, state)
    else:
        y, new_state = ssd_chunked_scan(
            c, b, v, log_a, state=state, chunk=cfg.ssd_chunk or None,
            token_mask=token_mask, kernel=cfg.ssd_kernel)
    if state_mask is not None:
        new_state = torch.where(state_mask[:, None, None, None], new_state,
                                state)
    out_w, out_s = _kernel(bp["ssd"]["out"]["kernel"], cfg.dtype)
    out = _postscale(torch.einsum("bthd,hdD->btD", y, out_w), out_s)
    return x + out, new_state


def _ssd_layer_forward(cfg: TransformerConfig, bp: tp.Dict, x: torch.Tensor,
                       state: torch.Tensor,
                       token_mask: tp.Optional[torch.Tensor] = None,
                       state_mask: tp.Optional[torch.Tensor] = None):
    """One SSD block against the resident state: returns (x, state)."""
    x, state = _ssd_mixer_forward(cfg, bp, x, state, token_mask,
                                  state_mask)
    normed = _rmsnorm(x, bp["norm2"]["scale"], cfg.dtype)
    return x + _mlp_forward(cfg, bp, normed), state


def _layer_forward(cfg: TransformerConfig, bp: tp.Dict, x: torch.Tensor,
                   positions: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor,
                   cache_index: tp.Union[int, torch.Tensor]):
    """One block against cached K/V: returns (x, k_cache, v_cache)."""
    x, k_cache, v_cache = _cached_self_attention(
        cfg, bp, x, positions, k_cache, v_cache, cache_index)
    normed = _rmsnorm(x, bp["norm2"]["scale"], cfg.dtype)
    return x + _mlp_forward(cfg, bp, normed), k_cache, v_cache


def _embed_tokens(p: tp.Dict, tokens: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Token ids [B, S] -> embeddings [B, S, D] in `dtype`; an int8 table
    gathers int8 rows and dequantizes only those."""
    tokens = tokens.long()
    if is_quantized(p["embed"]):
        return (p["embed"]["q"][tokens].to(dtype)
                * p["embed"]["scale"][tokens].to(dtype))
    return p["embed"][tokens].to(dtype)


def _head_logits(p: tp.Dict, x: torch.Tensor,
                 cfg: TransformerConfig) -> torch.Tensor:
    """Final norm + tied head: [B, S, D] -> f32 logits [B, S, V], through
    the forward's head product (`ops.losses.head_matmul`: operands in the
    compute dtype, f32 accumulation), so that a decode step's logits equal
    the uncached forward's on the same hidden states. An int8 table's
    per-vocab-row scale applies to the f32 logits."""
    x = _rmsnorm(x, p["norm_f"]["scale"], cfg.dtype)
    table, scale = _kernel(p["embed"], cfg.dtype)
    logits = head_matmul(x, table.t())
    return logits if scale is None else logits * scale[:, 0]


def _apply_step(params: tp.Dict, cfg: TransformerConfig,
                tokens: torch.Tensor, positions: torch.Tensor,
                cache: tp.Dict, cache_index: tp.Union[int, torch.Tensor], *,
                token_mask: tp.Optional[torch.Tensor] = None,
                state_mask: tp.Optional[torch.Tensor] = None):
    """Forward `tokens` [B, S] at `positions` [B, S], reading and writing
    the cache in place; returns (f32 logits [B, S, V], cache).

    SSD layers, recognized by their {'ssd'} cache entry, advance their
    state instead (`_ssd_mixer_forward`); the new state is copied into
    the entry's tensor, so a cache of views into a larger one (the
    engine's slot rows, a stacked cache's layer) is updated where it
    lies. `token_mask` and `state_mask` apply to SSD layers only:
    attention layers ignore padded and parked rows through their
    positions. A scan-stacked model runs the same layers over per-layer
    views of its stacked parameters and cache.
    """
    x = _embed_tokens(params, tokens, cfg.dtype)
    for bp, entry in zip(_blocks(cfg, params), cache_entries(cfg, cache)):
        if "ssd" in entry:
            x, state = _ssd_layer_forward(cfg, bp, x, entry["ssd"],
                                          token_mask, state_mask)
            entry["ssd"].copy_(state)
        else:
            x, _, _ = _layer_forward(cfg, bp, x, positions, entry["k"],
                                     entry["v"], cache_index)
    return _head_logits(params, x, cfg), cache


def sample_tokens(logits: torch.Tensor, temperature: float,
                  generator: tp.Optional[torch.Generator],
                  top_k: tp.Optional[int] = None,
                  top_p: tp.Optional[float] = None) -> torch.Tensor:
    """[B, V] logits -> [B] next tokens: argmax at temperature 0, else a
    categorical draw on `generator` from the softmax of `filter_logits`
    (logits / temperature, then the optional top-k and top-p filters)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filter_logits(logits.float(), temperature, top_k,
                                        top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def speculative_acceptance(draft_tokens: torch.Tensor, logits: torch.Tensor,
                           *, temperature: float = 0.0,
                           draft_probs: tp.Optional[torch.Tensor] = None,
                           generator: tp.Optional[torch.Generator] = None,
                           pad_token: int = 0
                           ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Longest-prefix acceptance of drafted tokens against target logits.

    The verify forward scores a slot's last emitted token and its k
    drafts in one [B, k+1] call: `logits[:, i]` is the target's
    distribution for draft i, `logits[:, k]` the bonus position.

    * Greedy (`temperature == 0`): draft i is accepted iff it equals
      `argmax(logits[:, i])` and every earlier draft was accepted. The
      emitted tokens are exactly the target's greedy tokens, whatever
      the draft proposed.
    * Sampling: rejection sampling. Draft x_i, with proposal probability
      q_i(x_i) (one-hot when `draft_probs` is None), is accepted with
      probability min(1, p_i(x_i) / q_i(x_i)), `u` drawn by `torch.rand`
      on `generator`; the first rejection draws from the residual
      norm(max(0, p_i - q_i)), full acceptance from the bonus p_k, by
      `torch.multinomial` on `generator`. The emitted tokens are a sample
      of the target distribution.

    Fixed shapes and no host sync (`accepted` is data), so a CUDA graph
    can capture it.

    Args:
        draft_tokens: [B, k] int drafted tokens.
        logits: [B, k+1, V] target logits from the verify forward.
        temperature: the engine's sampling temperature (0 = greedy).
        draft_probs: optional [B, k, V] proposal distribution.
        generator: the `torch.Generator` to draw from; required when
            temperature > 0.
        pad_token: fills the out-token tail beyond the emitted span.

    Returns (out_tokens [B, k+1], accepted [B]): the emitted tokens at
    indices 0..accepted (index `accepted` is the bonus or resampled
    token), `pad_token` beyond; `accepted` counts the kept drafts.
    """
    batch, k = draft_tokens.shape
    draft_tokens = draft_tokens.long()
    idx = torch.arange(k + 1, device=logits.device)[None]
    pad = torch.full_like(draft_tokens[:, :1], pad_token)
    if temperature <= 0.0:
        target = torch.argmax(logits, dim=-1)                 # [B, k+1]
        match = draft_tokens == target[:, :k]
        accepted = torch.cumprod(match.long(), dim=-1).sum(-1)
        out = torch.where(idx <= accepted[:, None], target, pad)
        return out, accepted
    if generator is None:
        raise ValueError("speculative_acceptance(temperature>0) resamples "
                         "rejected positions and needs an explicit "
                         "torch.Generator")
    probs = torch.softmax(logits[:, :k].float() / temperature, dim=-1)
    p_x = torch.gather(probs, -1, draft_tokens[..., None])[..., 0]   # [B, k]
    if draft_probs is None:
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        q_full = (draft_tokens[..., None] == vocab).to(probs.dtype)
        q_x = torch.ones_like(p_x)
    else:
        q_full = draft_probs.to(probs.dtype)
        q_x = torch.gather(q_full, -1, draft_tokens[..., None])[..., 0]
    u = torch.rand(draft_tokens.shape, generator=generator,
                   device=logits.device, dtype=probs.dtype)
    # u < min(1, p/q)  <=>  u * q < p  (no division, q == 0 safe)
    accepted = torch.cumprod((u * q_x < p_x).long(), dim=-1).sum(-1)
    # the residual at the first rejected index (a rejection implies
    # q(x) > p(x) there, so it has mass), or the bonus distribution
    rows = torch.arange(batch, device=logits.device)
    at = accepted.clamp(0, k - 1)
    residual = (probs[rows, at] - q_full[rows, at]).clamp_min(0.0)
    residual = residual / residual.sum(-1, keepdim=True).clamp_min(1e-20)
    bonus = torch.softmax(logits[:, k].float() / temperature, dim=-1)
    dist = torch.where((accepted < k)[:, None], residual, bonus)
    final = torch.multinomial(dist, 1, generator=generator)
    padded_draft = torch.cat([draft_tokens, pad], dim=1)
    acc = accepted[:, None]
    out = torch.where(idx < acc, padded_draft,
                      torch.where(idx == acc, final, pad))
    return out, accepted


def _check_top_p(top_p: tp.Any) -> None:
    # top_p <= 0 would leave every token ineligible
    if (isinstance(top_p, (numbers.Real, np.number))
            and not 0.0 < float(top_p) <= 1.0):
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


def nucleus_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Top-p (nucleus) logit filter, sort-once formulation.

    A token stays eligible iff the cumulative probability of strictly
    more likely tokens is < `top_p`, so the argmax always survives, and
    every token tied with the cutoff logit stays eligible. Ineligible
    logits are masked to -1e30; `logits` is [..., vocab]. `top_p` must be
    in (0, 1].
    """
    _check_top_p(top_p)
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    eligible = cum_before < top_p
    eligible[..., 0] = True
    # the cutoff: the smallest sorted logit still eligible, per row
    cutoff = torch.where(eligible, sorted_logits,
                         torch.full_like(sorted_logits, float("inf"))
                         ).amin(dim=-1, keepdim=True)
    return torch.where(logits < cutoff, torch.full_like(logits, -1e30),
                       logits)


def filter_logits(logits: torch.Tensor, temperature: float,
                  top_k: tp.Optional[int] = None,
                  top_p: tp.Optional[float] = None) -> torch.Tensor:
    """`generate`'s sampling logits: scaled by 1 / temperature, then the
    top-k filter (logits under the k-th largest masked to -1e30; ties
    with it stay), then `nucleus_filter`."""
    logits = logits / temperature
    if top_k is not None:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30),
                             logits)
    if top_p is not None:
        logits = nucleus_filter(logits, top_p)
    return logits


@torch.no_grad()
def generate(model: TransformerLM, prompt: tp.Any, *, max_new_tokens: int,
             temperature: float = 0.0, top_k: tp.Optional[int] = None,
             top_p: tp.Optional[float] = None,
             eos_token: tp.Optional[int] = None,
             generator: tp.Optional[torch.Generator] = None,
             params: tp.Optional[Params] = None,
             device: tp.Any = None) -> torch.Tensor:
    """Autoregressive generation with a dense KV cache (and SSD states).
    A pure-SSD stack may run past `config.max_seq_len`: none of its
    state grows with the context.

    Args:
        model: a TransformerLM living on `device`; every layout decodes
            (per-layer or scan-stacked, dense or MoE MLPs).
        prompt: [B, P] int tokens (numpy or tensor).
        max_new_tokens: tokens to append.
        temperature: 0 -> greedy; > 0 -> sampling on `generator`.
        top_k: sample among the k most likely tokens only.
        top_p: nucleus sampling (`nucleus_filter`; the most likely token
            always stays eligible); composes with top_k, applied first.
        eos_token: a row that emits it is done; later tokens of that row
            are pinned to `eos_token` (the loop still runs every step).
        generator: the `torch.Generator` sampling draws from (on
            `device`); required when temperature > 0.
        params: the weights to decode with instead of the model's own:
            a JAX-shaped tree on `device` (`lm_params`), e.g. int8 from
            `models.quantize.quantize_lm_params` (`decode_params`).
        device: `cuda` by default; the CPU only when asked for.

    Returns [B, P + max_new_tokens] tokens on `device`.
    """
    device = resolve_device(device)
    check_same_device("model", model.embed, device)
    cfg = model.config
    if not cfg.causal:
        raise ValueError("generate() implements causal KV-cache decoding; "
                         "a config.causal=False model has no decode")
    if temperature > 0.0 and generator is None:
        raise ValueError("generate(temperature>0) samples and needs an "
                         "explicit torch.Generator (greedy needs none)")
    if top_p is not None:
        _check_top_p(top_p)
    prompt = torch.as_tensor(np.asarray(prompt) if not torch.is_tensor(prompt)
                             else prompt, device=device)
    batch, prompt_len = prompt.shape
    total = prompt_len + max_new_tokens
    if total > cfg.max_seq_len and "attention" in mixer_pattern(cfg):
        # a pure-SSD stack has no length-dependent state: nothing caps T
        raise ValueError(f"prompt + new tokens {total} > max_seq_len "
                         f"{cfg.max_seq_len}")
    params = decode_params(model, params=params)
    cache = init_cache(cfg, batch, total, device)
    positions = torch.arange(prompt_len, device=device).expand(batch,
                                                               prompt_len)
    logits, cache = _apply_step(params, cfg, prompt, positions, cache, 0)
    last_logits = logits[:, -1]
    done = torch.zeros(batch, dtype=torch.bool, device=device)
    out = [prompt]
    for t in range(max_new_tokens):
        token = sample_tokens(last_logits, temperature, generator, top_k,
                              top_p)
        if eos_token is not None:
            token = torch.where(done, torch.full_like(token, eos_token),
                                token)
            done = done | (token == eos_token)
        token = token.to(prompt.dtype)[:, None]
        out.append(token)
        position = torch.full((batch, 1), prompt_len + t, device=device)
        logits, cache = _apply_step(params, cfg, token, position, cache,
                                    prompt_len + t)
        last_logits = logits[:, -1]
    return torch.cat(out, dim=1)
