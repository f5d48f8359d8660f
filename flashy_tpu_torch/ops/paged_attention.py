"""Paged KV attention over a block-pool cache (port of
flashy_tpu/ops/paged_attention.py).

K and V live in one global pool of fixed-size blocks
`[num_blocks, block_size, heads, head_dim]` per layer; each slot owns a
block table `[max_blocks]` of pool indices, so logical position p of a
slot maps to physical row `(table[p // block_size], p % block_size)`.
Physical block 0 is the sentinel: never handed out, target of every
write past a slot's coverage, and only ever reached by reads at logical
positions beyond the causal horizon, so its content is never attended.

`paged_attention` here is the PLAIN version of the paged-decode kernel
(`ops/paged_decode.py`, `csrc/paged_decode.cu`): it gathers each slot's
logical view and attends it under the causal mask. The CPU tests and
`kernel='gather'` engines run it; `chip_smoke.py` holds the kernel
against it on the card. Writes update the pool tensors in place (the
JAX package returns fresh arrays; here one pool allocation serves the
engine's lifetime).
"""
import math
import typing as tp

import torch

from ..models.quantize import dequantize_kv, quantize_kv
from .attention import score_scale

SENTINEL_BLOCK = 0

Entry = tp.Dict[str, torch.Tensor]


def pool_spec(num_blocks: int, block_size: int, num_heads: int,
              head_dim: int, dtype: torch.dtype, kv_dtype: str
              ) -> tp.Dict[str, tp.Tuple[tp.Tuple[int, ...], torch.dtype]]:
    """Leaf name -> (shape, dtype) of ONE layer's pool entry.

    `kv_dtype='int8'` stores int8 payloads plus per-(row, head) f32
    scales; any other value stores K/V in the model's compute dtype.
    """
    shape = (num_blocks, block_size, num_heads, head_dim)
    if kv_dtype == "int8":
        return {"k": (shape, torch.int8), "v": (shape, torch.int8),
                "k_scale": (shape[:-1], torch.float32),
                "v_scale": (shape[:-1], torch.float32)}
    return {"k": (shape, dtype), "v": (shape, dtype)}


def init_pool(cfg, num_blocks: int, block_size: int,
              kv_dtype: str = "model", *, device: tp.Any
              ) -> tp.Dict[str, tp.Any]:
    """Zeroed block pool for a TransformerLM config, shaped like
    `models.decoding.init_cache`: one entry per `block_i`, or for a
    scan-stacked model single stacked leaves ([L, N, bs, H, Dh] payloads,
    [L, N, bs, H] int8 scales). Block 0 is the sentinel."""
    spec = pool_spec(num_blocks, block_size, cfg.num_heads, cfg.head_dim,
                     cfg.dtype, kv_dtype)
    if cfg.scan_layers:
        return {name: torch.zeros((cfg.num_layers,) + shape, dtype=dt,
                                  device=device)
                for name, (shape, dt) in spec.items()}
    return {f"block_{i}": {name: torch.zeros(shape, dtype=dt, device=device)
                           for name, (shape, dt) in spec.items()}
            for i in range(cfg.num_layers)}


def _physical(table: torch.Tensor, positions: torch.Tensor, block_size: int
              ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Logical positions [B, T] -> (pool block [B, T], offset [B, T]).

    Positions past the table's coverage (a parked slot, an overshoot
    row) redirect to the SENTINEL block rather than clamp onto a real
    block's last row.
    """
    positions = positions.long()
    index = torch.div(positions, block_size, rounding_mode="floor")
    entries = table.shape[-1]
    block = torch.gather(table.long(), -1, index.clamp_max(entries - 1))
    block = torch.where(index >= entries,
                        torch.full_like(block, SENTINEL_BLOCK), block)
    return block, positions % block_size


def paged_write(entry: Entry, new_k: torch.Tensor, new_v: torch.Tensor,
                table: torch.Tensor, positions: torch.Tensor) -> Entry:
    """Write fresh K/V rows [B, T, H, Dh] through the block tables, in
    place: every row lands at its own physical (block, offset). int8
    pools quantize at the write (per-row absmax)."""
    block, offset = _physical(table, positions, entry["k"].shape[-3])
    for name, new in (("k", new_k), ("v", new_v)):
        if f"{name}_scale" in entry:
            q, scale = quantize_kv(new)
            entry[name][block, offset] = q
            entry[f"{name}_scale"][block, offset] = scale
        else:
            entry[name][block, offset] = new.to(entry[name].dtype)
    return entry


def gather_kv(entry: Entry, table: torch.Tensor, dtype: torch.dtype
              ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """One layer's logical K/V views [B, max_blocks * bs, H, Dh] in
    `dtype` (sentinel entries included; int8 pools dequantized)."""
    batch, entries = table.shape
    index = table.long()

    def view(name):
        g = entry[name][index]                  # [B, E, bs, H, Dh]
        if f"{name}_scale" in entry:
            g = dequantize_kv(g, entry[f"{name}_scale"][index], dtype)
        return g.to(dtype).reshape(batch, entries * g.shape[2],
                                   *g.shape[3:])

    return view("k"), view("v")


def paged_attention(q: torch.Tensor, entry: Entry, table: torch.Tensor,
                    positions: torch.Tensor, *, head_dim: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """Causal attention of queries against a slot-paged KV pool.

    Args:
        q: [B, T, H, Dh] queries (rotary applied).
        entry: one layer's pool dict, this step's rows already written.
        table: [B, max_blocks] int block tables.
        positions: [B, T] absolute query positions; key logical position
            <= query position is the one mask, which also hides every
            sentinel entry.
        head_dim: scales the scores.
        dtype: compute dtype of the gathered K/V and of probs @ V.

    Returns [B, T, H, Dh] in `dtype`, f32 scores (f64 when `dtype` is
    float64: the exact reference of the kernel checks). int8 pools fold the
    K scales into the scores before the softmax and the V scales into
    the probs after it, each exactly once — the placement the kernel
    keeps too.
    """
    batch, entries = table.shape
    index = table.long()

    def view(name):
        g = entry[name][index]                  # [B, E, bs, H, Dh]
        g = g.reshape(batch, entries * g.shape[2], *g.shape[3:])
        s = entry.get(f"{name}_scale")
        if s is not None:
            # [B, E, bs, H] -> [B, H, 1, L] to broadcast over scores
            s = s[index].reshape(batch, g.shape[1], g.shape[2])
            s = s.permute(0, 2, 1)[:, :, None, :]
        return g.to(dtype), s

    k_view, k_scale = view("k")
    v_view, v_scale = view("v")
    wide = torch.float64 if dtype == torch.float64 else torch.float32
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(wide),
                          k_view.to(wide)) * score_scale(head_dim)
    if k_scale is not None:
        scores = scores * k_scale
    key_pos = torch.arange(k_view.shape[1], device=q.device)
    mask = key_pos[None, None, :] <= positions[:, :, None]
    scores = scores.masked_fill(~mask[:, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(dtype), v_view)


def slot_kv(entry: Entry, table_row: tp.Any, length: int,
            dtype: torch.dtype = torch.float32
            ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Read back one slot's logical K/V rows [length, H, Dh]."""
    row = torch.as_tensor(table_row, device=entry["k"].device)[None]
    k, v = gather_kv(entry, row, dtype)
    return k[0, :length], v[0, :length]


def pool_bytes(cfg, num_blocks: int, block_size: int,
               kv_dtype: str = "model") -> int:
    """Total device bytes of the pool across layers (host arithmetic)."""
    spec = pool_spec(num_blocks, block_size, cfg.num_heads, cfg.head_dim,
                     cfg.dtype, kv_dtype)
    per_layer = sum(dt.itemsize * math.prod(shape)
                    for shape, dt in spec.values())
    return per_layer * cfg.num_layers


def block_bytes(cfg, block_size: int, kv_dtype: str = "model") -> int:
    """Device bytes ONE block costs across layers (admission accounting)."""
    return pool_bytes(cfg, 1, block_size, kv_dtype)
