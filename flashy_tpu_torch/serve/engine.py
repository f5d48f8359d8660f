"""Slot-based decode engine over a paged KV pool (port of
flashy_tpu/serve/engine.py, `cache_layout='paged'`).

S slots share one block pool; ONE decode step of shape [S, 1] advances
every live slot together, an active mask (not a shape) expressing
liveness. Prompts prefill in fixed `[1, chunk]` slices that the
scheduler interleaves with decode steps, and attend earlier (possibly
prefix-shared) blocks through the slot's table row. Every paged read
goes through `serve.paged.paged_apply_step`, which on CUDA launches the
Hopper paged-decode kernel (`kernel='fused'`, the default there).

PyTorch runs eagerly, so the JAX package's compiled-step cache has no
counterpart yet (CUDA graphs: ROADMAP.md queue A item 3, L3); the
pool is updated in place.
"""
import logging
import typing as tp

import numpy as np
import torch

from ..models.decoding import decode_params, sample_tokens
from ..models.transformer import check_supported
from ..ops.paged_attention import block_bytes, init_pool
from ..ops.paged_decode import default_kernel
from ..utils import check_same_device, resolve_device
from .compile_cache import bucket_length
from .paged import BlockPool, CacheBox, copy_block_fn, paged_apply_step

logger = logging.getLogger(__name__)

TODO_LAYOUTS = "ROADMAP.md queue A item 3, L1 (dense / ssd layouts)"
TODO_SPECULATIVE = ("ROADMAP.md queue A item 3, L2 (speculative decode + "
                    "serve/draft.py)")


def state_bytes_per_slot(cfg: tp.Any, max_seq_len: int, cache_layout: str,
                         *, kv_dtype: str = "model",
                         block_size: int = 16) -> int:
    """Decode-state bytes ONE slot reserves at `max_seq_len` (host
    arithmetic): the dense layout's per-layer [max_seq_len, H, Dh] K+V
    slabs, or the paged layout's full block budget at `block_bytes`
    (int8 pools count payload + scales)."""
    if cache_layout == "dense":
        return (2 * max_seq_len * cfg.num_heads * cfg.head_dim
                * cfg.dtype.itemsize * cfg.num_layers)
    if cache_layout == "paged":
        if max_seq_len % block_size:
            raise ValueError(f"block_size {block_size} must divide "
                             f"max_seq_len {max_seq_len}")
        return (max_seq_len // block_size) * block_bytes(cfg, block_size,
                                                         kv_dtype)
    if cache_layout == "ssd":
        raise NotImplementedError(f"the ssd layout: {TODO_LAYOUTS}")
    raise ValueError(f"unknown cache_layout {cache_layout!r}")


class SlotAllocator:
    """Free-list over the S cache slots: `acquire()` hands out the lowest
    free slot (or None), `release()` returns one; double release raises."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"need at least one slot, got {capacity}")
        self.capacity = capacity
        self._free = list(range(capacity - 1, -1, -1))  # pop() -> lowest
        self._live: tp.Set[int] = set()

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def live_count(self) -> int:
        return len(self._live)

    @property
    def live(self) -> tp.FrozenSet[int]:
        return frozenset(self._live)

    def acquire(self) -> tp.Optional[int]:
        """Claim the lowest free slot (None when every slot is live)."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._live.add(slot)
        return slot

    def release(self, slot: int) -> None:
        if slot not in self._live:
            raise ValueError(f"slot {slot} is not live (free: double "
                             f"release?) — live set: {sorted(self._live)}")
        self._live.discard(slot)
        self._free.append(slot)
        self._free.sort(reverse=True)  # keep lowest-first hand-out


class DecodeEngine:
    """S-slot paged KV pool + the prefill-chunk and decode steps over it.

    Args:
        model: a port `TransformerLM`; its weights are cast once to the
            compute dtype (`models.decoding.decode_params`).
        slots: S, the number of concurrent requests.
        max_seq_len: per-slot cap; defaults to (and is capped by) the
            model's `config.max_seq_len`.
        temperature: 0 -> greedy (token-exact against `generate()`);
            > 0 -> categorical sampling on `generator`.
        generator: the `torch.Generator` sampling draws from.
        pad_token: emitted for inactive slots; pads prompt slices.
        min_bucket: default `tail_bucket` and the smallest prompt bucket.
        chunk: prefill slice size; defaults to `block_size`, must divide
            `max_seq_len`.
        tail_bucket: the smaller slice used when the remaining prompt
            fits it; <= chunk.
        spec_k: speculative decoding — not ported yet (raises).
        cache_layout: 'paged' ('dense' / 'ssd' are not ported yet).
        block_size: tokens per pool block; must divide `max_seq_len`.
        num_blocks: pool size including the sentinel; defaults to every
            slot at `max_seq_len`.
        kv_dtype: 'model' (compute dtype) or 'int8' (per-row absmax
            payloads + f32 scales).
        kernel: the paged READ: 'fused' (the Hopper kernel; CUDA only),
            'gather' (its plain version) or 'auto' ('fused' on CUDA,
            'gather' on the CPU).
        prefix_cache: enable cross-request prefix sharing.
        device: `cuda` by default; the CPU only when asked for.
    """

    def __init__(self, model, *, slots: int,
                 max_seq_len: tp.Optional[int] = None,
                 temperature: float = 0.0,
                 generator: tp.Optional[torch.Generator] = None,
                 pad_token: int = 0,
                 min_bucket: int = 4,
                 chunk: tp.Optional[int] = None,
                 tail_bucket: tp.Optional[int] = None,
                 spec_k: tp.Optional[int] = None,
                 cache_layout: str = "paged",
                 block_size: int = 16,
                 num_blocks: tp.Optional[int] = None,
                 kv_dtype: str = "model",
                 kernel: str = "auto",
                 prefix_cache: bool = True,
                 device: tp.Any = None):
        self.device = resolve_device(device)
        check_same_device("model", model.embed, self.device)
        self._cfg = cfg = model.config
        check_supported(cfg)
        if cache_layout in ("dense", "ssd"):
            raise NotImplementedError(
                f"cache_layout={cache_layout!r}: {TODO_LAYOUTS}")
        if cache_layout != "paged":
            raise ValueError(f"cache_layout must be 'dense', 'paged' or "
                             f"'ssd', got {cache_layout!r}")
        if spec_k is not None:
            raise NotImplementedError(f"spec_k: {TODO_SPECULATIVE}")
        if kv_dtype not in ("model", "int8"):
            raise ValueError(f"kv_dtype must be 'model' or 'int8', "
                             f"got {kv_dtype!r}")
        if kernel not in ("auto", "gather", "fused"):
            raise ValueError(f"kernel must be 'auto', 'gather' or "
                             f"'fused', got {kernel!r}")
        if kernel == "fused" and self.device.type != "cuda":
            # an explicit 'fused' must RUN the kernel; the plain path
            # standing in for it would let every kernel gate false-pass
            raise ValueError(
                f"kernel='fused' cannot run here: the paged decode kernel "
                f"is CUDA-only and the engine's device is {self.device}; "
                f"use kernel='gather' (or 'auto')")
        self.kernel = default_kernel(self.device) if kernel == "auto" \
            else kernel
        self.slots = slots
        self.max_seq_len = min(max_seq_len or cfg.max_seq_len,
                               cfg.max_seq_len)
        self.cache_layout = cache_layout
        self.kv_dtype = kv_dtype
        self.block_size = int(block_size)
        self.temperature = float(temperature)
        if self.temperature > 0.0 and generator is None:
            raise ValueError("DecodeEngine(temperature>0) samples and needs "
                             "an explicit torch.Generator (greedy needs "
                             "none)")
        self._generator = generator
        self.pad_token = int(pad_token)
        self.min_bucket = int(min_bucket)
        self.chunk = int(chunk if chunk is not None else self.block_size)
        if self.chunk < 1 or self.max_seq_len % self.chunk:
            raise ValueError(f"chunk must divide max_seq_len "
                             f"({self.max_seq_len}), got {self.chunk}")
        self.tail_bucket = int(tail_bucket if tail_bucket is not None
                               else min(self.min_bucket, self.chunk))
        if not 1 <= self.tail_bucket <= self.chunk:
            raise ValueError(f"tail_bucket must be in [1, chunk], got "
                             f"{self.tail_bucket} (chunk {self.chunk})")
        self.allocator = SlotAllocator(slots)
        if num_blocks is None:
            num_blocks = 1 + slots * (self.max_seq_len // self.block_size)
        self.num_blocks = int(num_blocks)
        self._pool = BlockPool(num_blocks=self.num_blocks,
                               block_size=self.block_size,
                               max_seq_len=self.max_seq_len,
                               prefix_cache=prefix_cache)
        self._params = decode_params(model)
        self._cache_box = CacheBox(init_pool(
            cfg, self.num_blocks, self.block_size, kv_dtype,
            device=self.device))
        self._copy = copy_block_fn()
        self._block_bytes = block_bytes(cfg, self.block_size, kv_dtype)
        self._table_host = np.zeros((slots, self._pool.max_blocks), np.int32)
        self._table_dev = torch.from_numpy(self._table_host).to(self.device)
        self._table_dirty = False
        # attention reads made, by step kind (each runs num_layers reads)
        self.step_counts = {"decode": 0, "prefill_chunk": 0}
        self._reset_slot_state()

    def _reset_slot_state(self) -> None:
        """Every slot inactive, parked at `max_seq_len` (its writes land
        in the sentinel block), on device and in the host mirror."""
        s, dev = self.slots, self.device
        self._tokens = torch.full((s,), self.pad_token, dtype=torch.long,
                                  device=dev)
        self._positions = torch.full((s,), self.max_seq_len,
                                     dtype=torch.long, device=dev)
        self._active = torch.zeros((s,), dtype=torch.bool, device=dev)
        # host mirror: every position move is host-driven, so reading
        # lengths never needs a device->host copy
        self._positions_host = np.full((s,), self.max_seq_len, np.int64)
        self._active_host = np.zeros((s,), bool)

    @property
    def _cache(self):
        return self._cache_box.value

    @property
    def pool(self) -> BlockPool:
        return self._pool

    @property
    def cache_box(self) -> CacheBox:
        return self._cache_box

    def _table(self) -> torch.Tensor:
        """Device copy of the block tables, refreshed only after the host
        tables changed (admission / retirement, never mid-decode)."""
        if self._table_dirty:
            self._table_dev = torch.from_numpy(self._table_host).to(
                self.device)
            self._table_dirty = False
        return self._table_dev

    def _set_slot(self, slot: int, token: int, position: int,
                  active: bool) -> None:
        self._tokens[slot] = token
        self._positions[slot] = position
        self._active[slot] = active
        self._positions_host[slot] = position
        self._active_host[slot] = active

    # ------------------------------------------------------------------
    # public surface
    # ------------------------------------------------------------------
    def bucket_for(self, prompt_len: int) -> int:
        return bucket_length(prompt_len, minimum=self.min_bucket,
                             maximum=self.max_seq_len)

    @torch.no_grad()
    def _decode_step(self) -> torch.Tensor:
        logits, _ = paged_apply_step(
            self._params, self._cfg, self._tokens[:, None],
            self._positions[:, None], self._cache, self._table(),
            kernel=self.kernel)
        nxt = sample_tokens(logits[:, -1], self.temperature,
                            self._generator)
        return torch.where(self._active, nxt,
                           torch.full_like(nxt, self.pad_token))

    def warmup(self) -> None:
        """Build the paged-decode kernel (on CUDA) and run one decode over
        all-sentinel tables: every slot is parked, so the step's writes
        land in the sentinel block. Call before admitting requests."""
        if self.allocator.live_count:
            raise ValueError("warmup() runs before any slot is live")
        self._decode_step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._reset_slot_state()
        logger.info("serve warm-up done (kernel=%s)", self.kernel)

    def acquire_slot(self) -> tp.Optional[int]:
        """Claim a free slot (None when all are live) to admit into."""
        return self.allocator.acquire()

    def can_admit(self, prompt: np.ndarray, max_new_tokens: int) -> bool:
        """Whether the pool can reserve this request's whole budget now
        (net of its prefix-cache credit)."""
        return self._pool.can_admit(np.asarray(prompt, np.int32),
                                    max_new_tokens)

    def admit(self, slot: int, prompt: np.ndarray,
              max_new_tokens: int) -> int:
        """Reserve the request's blocks and return where prefill starts.

        Walks the prefix index (refcount bumps on shared full blocks, a
        device block copy for a copy-on-write fork), fills the slot's
        table row, and returns the prompt tokens served from the cache
        (always < len(prompt)). Raises PoolExhausted, with nothing
        changed, when the pool lacks headroom.
        """
        if slot not in self.allocator.live:
            raise ValueError(f"slot {slot} was not acquired")
        prompt = np.asarray(prompt, np.int32)
        plan = self._pool.plan(prompt, max_new_tokens)
        row, start, cow = self._pool.commit(plan, slot)
        self._table_host[slot] = row
        self._table_dirty = True
        if cow is not None:
            self._copy(self._cache, *cow)
        return start

    def pool_stats(self) -> tp.Dict[str, float]:
        """Block-pool counters plus `kv_bytes_per_token`, the pool bytes
        reserved per live token."""
        stats = self._pool.stats()
        live_tokens = int(sum(self._positions_host[self._active_host]))
        stats["kv_bytes_per_token"] = (
            stats["in_use"] * self._block_bytes / live_tokens
            if live_tokens else 0.0)
        return stats

    def state_bytes_per_slot(self) -> int:
        return state_bytes_per_slot(self._cfg, self.max_seq_len,
                                    self.cache_layout,
                                    kv_dtype=self.kv_dtype,
                                    block_size=self.block_size)

    @torch.no_grad()
    def prefill_chunk(self, slot: int, prompt: np.ndarray,
                      start: int) -> tp.Tuple[int, tp.Optional[int]]:
        """Advance `slot`'s prefill by ONE slice of `chunk` (or
        `tail_bucket` when the rest fits it) tokens from `start`.

        Returns `(next_start, first_token)`; `first_token` is None until
        the final slice, when the slot goes live. Pad rows past the
        prompt write at positions past every causal horizon.
        """
        prompt = np.asarray(prompt)
        if prompt.ndim != 1 or prompt.size < 1:
            raise ValueError(f"prompt must be 1-D and non-empty, "
                             f"got shape {prompt.shape}")
        if slot not in self.allocator.live:
            raise ValueError(f"slot {slot} was not acquired")
        length = int(prompt.size)
        if length > self.max_seq_len:
            raise ValueError(f"prompt length {length} exceeds "
                             f"max_seq_len {self.max_seq_len}")
        if not 0 <= start < length:
            raise ValueError(f"chunk start {start} outside prompt "
                             f"[0, {length})")
        remaining = length - start
        size = self.tail_bucket if remaining <= self.tail_bucket \
            else self.chunk
        used = min(remaining, size)
        final = start + used >= length
        padded = np.full((1, size), self.pad_token, np.int64)
        padded[0, :used] = prompt[start:start + used]
        tokens = torch.from_numpy(padded).to(self.device)
        positions = (start + torch.arange(size, device=self.device))[None]
        row = self._table()[slot:slot + 1]
        logits, _ = paged_apply_step(self._params, self._cfg, tokens,
                                     positions, self._cache, row,
                                     kernel=self.kernel)
        self.step_counts["prefill_chunk"] += 1
        if not final:
            return start + used, None
        first = int(sample_tokens(logits[0, used - 1:used], self.temperature,
                                  self._generator)[0])
        # prompt fully written: index its full blocks for sharing
        self._pool.on_live(slot)
        self._set_slot(slot, first, length, True)
        return start + used, first

    def decode(self) -> np.ndarray:
        """One [S, 1] decode step over every slot; returns the [S] next
        tokens (pad_token on inactive slots)."""
        tokens = self._decode_step()
        self.step_counts["decode"] += 1
        out = tokens.cpu().numpy()
        self._tokens = tokens
        self._positions = self._positions + self._active.long()
        self._positions_host += self._active_host
        return out

    def _park(self, slot: int) -> None:
        self._set_slot(slot, self.pad_token, self.max_seq_len, False)

    def retire(self, slot: int) -> None:
        """Free `slot`: park it (pending writes land in the sentinel) and
        drop its block refcounts; prompt blocks the prefix index caches
        stay resident for later admissions."""
        self._park(slot)
        if self._pool.holds(slot):
            self._pool.release(slot)
            self._table_host[slot] = 0
            self._table_dirty = True
        self.allocator.release(slot)

    def preempt_slot(self, slot: int) -> None:
        """Tear a live slot down mid-decode for a higher-priority request:
        as `retire()`, but through `BlockPool.evict_slot` (counted as a
        preemption; its prompt chain stays cached for re-admission)."""
        if slot not in self.allocator.live:
            raise ValueError(f"slot {slot} is not live")
        self._park(slot)
        if self._pool.holds(slot):
            self._pool.evict_slot(slot)
            self._table_host[slot] = 0
            self._table_dirty = True
        self.allocator.release(slot)

    @property
    def live_count(self) -> int:
        return self.allocator.live_count

    @property
    def free_count(self) -> int:
        return self.allocator.free_count
