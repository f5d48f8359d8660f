"""KV-cache decoding for the port's TransformerLM (port of
flashy_tpu/models/decoding.py, per-layer models: attention, SSD and
hybrid stacks, with dense or MoE MLPs).

`generate` is the oracle the paged serving engine is held to, on the
CPU and on the card: it reads its dense `[B, max_len, H, Dh]` cache with
plain einsums, no kernel. PyTorch runs eagerly, so the JAX package's
`lax.scan` token loop becomes a Python loop, and cache writes update
the cache tensors in place instead of returning fresh arrays (one cache
allocation per call instead of one per step). SSD layers keep one
[B, H, Dh, N] f32 state instead of K/V slabs: a multi-token call runs
the chunked scan (the Hopper SSD kernel on CUDA), a one-token call the
recurrence. MoE blocks decode dropless (`_moe_forward`, plain PyTorch:
the JAX package has no kernel there).

The step functions read a nested parameter dict shaped like the JAX
tree (`decode_params`), with the matmul kernels already cast to the
compute dtype — bitwise the same as the JAX package's cast at use.
"""
import typing as tp

import numpy as np
import torch

from ..ops.attention import score_scale
from ..ops.losses import head_matmul
from ..ops.ssd_scan import ssd_chunked_scan, ssd_recurrent_scan
from ..parallel.moe_ep import _gelu
from ..utils import check_same_device, resolve_device
from .ssd import ssd_projections
from .transformer import (TransformerConfig, TransformerLM, _rotary,
                          check_supported, mixer_pattern,
                          rmsnorm as _rmsnorm)


def decode_params(model: TransformerLM) -> tp.Dict[str, tp.Any]:
    """The model's weights as a JAX-shaped dict, cast once for decoding.

    Matmul kernels and the embedding are cast to `config.dtype`, so the
    row lookup and the tied head (`ops.losses.head_matmul`, f32
    accumulation) see exactly the operands the JAX package's cast-at-use
    gives them. Norm scales stay f32 (rmsnorm multiplies in f32).
    """
    cfg = model.config
    check_supported(cfg)
    dtype = cfg.dtype

    def kernel(module):
        return {"kernel": module.kernel.detach().to(dtype)}

    with torch.no_grad():
        p: tp.Dict[str, tp.Any] = {
            "embed": model.embed.detach().to(dtype),
            "norm_f": {"scale": model.norm_f.scale.detach()}}
        for i in range(cfg.num_layers):
            block = getattr(model, f"block_{i}")
            p[f"block_{i}"] = {
                "norm1": {"scale": block.norm1.scale.detach()},
                "norm2": {"scale": block.norm2.scale.detach()}}
            if hasattr(block, "moe"):
                # the router multiplies in f32; expert slabs are cast
                p[f"block_{i}"]["moe"] = {
                    "router": {"kernel": block.moe.router.kernel.detach()},
                    "w_up": block.moe.w_up.detach().to(dtype),
                    "w_down": block.moe.w_down.detach().to(dtype)}
            else:
                p[f"block_{i}"]["mlp"] = {"up": kernel(block.mlp.up),
                                          "down": kernel(block.mlp.down)}
            if block.mixer == "ssd":
                p[f"block_{i}"]["ssd"] = {
                    "cbv": kernel(block.ssd.cbv),
                    "dt_bias": block.ssd.dt_bias.detach(),
                    "out": kernel(block.ssd.out)}
            else:
                p[f"block_{i}"]["attn"] = {"qkv": kernel(block.attn.qkv),
                                           "out": kernel(block.attn.out)}
    return p


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device: tp.Any) -> tp.Dict[str, tp.Dict[str, torch.Tensor]]:
    """Zeroed dense cache: one {'k', 'v'} [B, max_len, H, Dh] slab pair
    per attention layer, in the compute dtype, and one {'ssd'} f32
    state [B, H, Dh, N] per SSD layer (no max_len dimension)."""
    check_supported(cfg)
    shape = (batch, max_len, cfg.num_heads, cfg.head_dim)
    sshape = (batch, cfg.num_heads, cfg.head_dim, cfg.ssd_state_dim)

    def entry(mixer):
        if mixer == "ssd":
            return {"ssd": torch.zeros(sshape, dtype=torch.float32,
                                       device=device)}
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}

    return {f"block_{i}": entry(mixer)
            for i, mixer in enumerate(mixer_pattern(cfg))}


def _cache_write(cache: torch.Tensor, new: torch.Tensor,
                 cache_index: tp.Union[int, torch.Tensor]) -> torch.Tensor:
    """Write `new` [B, S, H, Dh] into `cache` at `cache_index`, in place.

    An int writes the same offset for every row; a [B] tensor writes
    each row at its own offset, and rows that fall past the cache (a
    parked slot at max_len) are dropped, not clamped.
    """
    if not torch.is_tensor(cache_index):
        cache[:, cache_index:cache_index + new.shape[1]] = new
        return cache
    batch, seq = new.shape[:2]
    rows = torch.arange(batch, device=cache.device)[:, None].expand(batch, seq)
    cols = cache_index[:, None] + torch.arange(seq, device=cache.device)
    keep = cols < cache.shape[1]
    cache[rows[keep], cols[keep]] = new[keep]
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
    qkv = torch.einsum("btd,dchk->btchk", normed, bp["attn"]["qkv"]["kernel"])
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
    attn_out = torch.einsum("bqhd,hdD->bqD", attn,
                            bp["attn"]["out"]["kernel"])
    return x + attn_out, k_cache, v_cache


def _gated_mlp(bp_mlp: tp.Dict, normed: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """SwiGLU MLP on pre-normed input."""
    gate, value = (normed @ bp_mlp["up"]["kernel"]).chunk(2, dim=-1)
    return (torch.nn.functional.silu(gate) * value) \
        @ bp_mlp["down"]["kernel"]


# Above this many tokens, per-token expert-weight gathers ([N, D, F]
# buffers) dominate memory; switch to streaming over experts instead.
_MOE_GATHER_MAX_TOKENS = 64


def _moe_forward(cfg: TransformerConfig, mp: tp.Dict,
                 x: torch.Tensor) -> torch.Tensor:
    """Dropless routed MoE for decoding: [B, S, D] -> [B, S, D].

    MoEMLP's routing (f32 softmax router, raw-probability gates,
    sequential top-k argmax) without capacity buffers, in one of two
    equivalent evaluation orders: up to `_MOE_GATHER_MAX_TOKENS` tokens
    (decode steps) gather each token's expert slabs; more (a prefill)
    stream over the experts, every token against one expert at a time,
    weighted by its combine gate (zero for unrouted pairs).
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
            up = mp["w_up"][expert_index]                        # [N, D, F]
            down = mp["w_down"][expert_index]                    # [N, F, D]
            h = _gelu(torch.einsum("nd,ndf->nf", x_c, up))
            y = torch.einsum("nf,nfd->nd", h, down)
            out = out + gate[:, None] * y.float()
        combine = combine + gate[:, None] * onehot
        remaining = remaining * (1.0 - onehot)
    if n_tokens > _MOE_GATHER_MAX_TOKENS:
        for e in range(num_experts):
            h = _gelu(x_c @ mp["w_up"][e])
            y = h @ mp["w_down"][e]
            out = out + combine[:, e:e + 1] * y.float()
    return out.reshape(batch, seq, dim).to(cfg.dtype)


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
    c, b, v, log_a = ssd_projections(cfg, normed, bp["ssd"]["cbv"]["kernel"],
                                     bp["ssd"]["dt_bias"])
    if x.shape[1] == 1:
        y, new_state = ssd_recurrent_scan(c, b, v, log_a, state)
    else:
        y, new_state = ssd_chunked_scan(
            c, b, v, log_a, state=state, chunk=cfg.ssd_chunk or None,
            token_mask=token_mask, kernel=cfg.ssd_kernel)
    if state_mask is not None:
        new_state = torch.where(state_mask[:, None, None, None], new_state,
                                state)
    out = torch.einsum("bthd,hdD->btD", y, bp["ssd"]["out"]["kernel"])
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
    """Token ids [B, S] -> embeddings [B, S, D] in `dtype`."""
    return p["embed"][tokens.long()].to(dtype)


def _head_logits(p: tp.Dict, x: torch.Tensor,
                 cfg: TransformerConfig) -> torch.Tensor:
    """Final norm + tied head: [B, S, D] -> f32 logits [B, S, V], through
    the forward's head product (`ops.losses.head_matmul`: operands in the
    compute dtype, f32 accumulation), so that a decode step's logits equal
    the uncached forward's on the same hidden states."""
    x = _rmsnorm(x, p["norm_f"]["scale"], cfg.dtype)
    return head_matmul(x, p["embed"].t())


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
    engine's slot rows) is updated where it lies. `token_mask` and
    `state_mask` apply to SSD layers only: attention layers ignore
    padded and parked rows through their positions.
    """
    x = _embed_tokens(params, tokens, cfg.dtype)
    for layer in range(cfg.num_layers):
        name = f"block_{layer}"
        entry = cache[name]
        if "ssd" in entry:
            x, state = _ssd_layer_forward(cfg, params[name], x, entry["ssd"],
                                          token_mask, state_mask)
            entry["ssd"].copy_(state)
            continue
        x, k_cache, v_cache = _layer_forward(
            cfg, params[name], x, positions, entry["k"], entry["v"],
            cache_index)
        cache[name] = {"k": k_cache, "v": v_cache}
    return _head_logits(params, x, cfg), cache


def sample_tokens(logits: torch.Tensor, temperature: float,
                  generator: tp.Optional[torch.Generator]) -> torch.Tensor:
    """[B, V] logits -> [B] next tokens: argmax at temperature 0, else a
    categorical draw from softmax(logits / temperature) on `generator`."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(model: TransformerLM, prompt: tp.Any, *, max_new_tokens: int,
             temperature: float = 0.0, eos_token: tp.Optional[int] = None,
             generator: tp.Optional[torch.Generator] = None,
             device: tp.Any = None) -> torch.Tensor:
    """Autoregressive generation with a dense KV cache (and SSD states).
    A pure-SSD stack may run past `config.max_seq_len`: none of its
    state grows with the context.

    Args:
        model: a TransformerLM living on `device`.
        prompt: [B, P] int tokens (numpy or tensor).
        max_new_tokens: tokens to append.
        temperature: 0 -> greedy; > 0 -> sampling on `generator`.
        eos_token: a row that emits it is done; later tokens of that row
            are pinned to `eos_token` (the loop still runs every step).
        generator: the `torch.Generator` sampling draws from (on
            `device`); required when temperature > 0.
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
    prompt = torch.as_tensor(np.asarray(prompt) if not torch.is_tensor(prompt)
                             else prompt, device=device)
    batch, prompt_len = prompt.shape
    total = prompt_len + max_new_tokens
    if total > cfg.max_seq_len and "attention" in mixer_pattern(cfg):
        # a pure-SSD stack has no length-dependent state: nothing caps T
        raise ValueError(f"prompt + new tokens {total} > max_seq_len "
                         f"{cfg.max_seq_len}")
    params = decode_params(model)
    cache = init_cache(cfg, batch, total, device)
    positions = torch.arange(prompt_len, device=device).expand(batch,
                                                               prompt_len)
    logits, cache = _apply_step(params, cfg, prompt, positions, cache, 0)
    last_logits = logits[:, -1]
    done = torch.zeros(batch, dtype=torch.bool, device=device)
    out = [prompt]
    for t in range(max_new_tokens):
        token = sample_tokens(last_logits, temperature, generator)
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
