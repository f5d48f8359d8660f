"""Slot-based decode engine over a paged KV pool or resident SSD states
(port of flashy_tpu/serve/engine.py, `cache_layout='paged'` and, for
pure-SSD stacks, `'ssd'`).

S slots share one block pool; ONE decode step of shape [S, 1] advances
every live slot together, an active mask (not a shape) expressing
liveness. Prompts prefill in fixed `[1, chunk]` slices that the
scheduler interleaves with decode steps, and attend earlier (possibly
prefix-shared) blocks through the slot's table row. Every paged read
goes through `serve.paged.paged_apply_step`, which on CUDA launches the
Hopper paged-decode kernel (`kernel='fused'`, the default there). On the
ssd layout each slot holds one [H, Dh, N] f32 state per layer: prefill
slices run the chunked scan (on CUDA the Hopper SSD kernel), decode the
recurrence, and sessions may stream past `max_seq_len`.

The JAX package's compiled-step cache becomes captured CUDA graphs
(`serve.compile_cache.CompileCache`): `warmup()` captures one graph for
each key live traffic can touch, the decode step ("decode", S), the two
prefill slices ("prefill_chunk", chunk and tail_bucket) and, on the
paged layout, the copy-on-write block copy ("copy_block",), and every
later step replays one. A graph reads and writes fixed tensors, so the
engine's per-slot state, block tables and prefill inputs are static
buffers filled in place (`copy_`, `fill_`), and the pool is allocated
once and updated in place. A prefill slice's slot, start and length
reach its graph as device values in those buffers (its table row, its
positions, its token mask, its slot index), not as Python ints, so one
graph serves every slot: the SSD slice gathers the slot's states with
`index_select` and scatters them back with `index_copy_`. On the CPU
the same steps run eagerly.
"""
import logging
import typing as tp

import numpy as np
import torch

from ..models.decoding import (_apply_step, decode_params, init_cache,
                               sample_tokens)
from ..models.transformer import check_supported, mixer_pattern
from ..ops.paged_attention import block_bytes, init_pool
from ..ops.paged_decode import default_kernel
from ..ops.ssd_scan import ssd_state_bytes
from ..utils import check_same_device, resolve_device
from .compile_cache import CompileCache, bucket_length
from .paged import BlockPool, CacheBox, copy_block_fn, paged_apply_step

logger = logging.getLogger(__name__)

TODO_LAYOUTS = ("ROADMAP.md queue A item 3, L1 (the dense layout, and "
                "hybrid ssd serving on its per-slot slabs)")
TODO_SPECULATIVE = ("ROADMAP.md queue A item 3, L2 (speculative decode + "
                    "serve/draft.py)")
TODO_MOE_SERVING = "ROADMAP.md queue A item 3, L7 (MoE in the serving engine)"


def state_bytes_per_slot(cfg: tp.Any, max_seq_len: int, cache_layout: str,
                         *, kv_dtype: str = "model",
                         block_size: int = 16) -> int:
    """Decode-state bytes ONE slot reserves at `max_seq_len` (host
    arithmetic): the dense layout's per-layer [max_seq_len, H, Dh] K+V
    slabs; the paged layout's full block budget at `block_bytes` (int8
    pools count payload + scales); the ssd layout's fixed [H, Dh, N] f32
    state per SSD layer, with no max_seq_len term, plus a dense slab per
    attention layer of a hybrid stack."""
    kv_slab = (2 * max_seq_len * cfg.num_heads * cfg.head_dim
               * cfg.dtype.itemsize)
    if cache_layout == "dense":
        return kv_slab * cfg.num_layers
    if cache_layout == "paged":
        if max_seq_len % block_size:
            raise ValueError(f"block_size {block_size} must divide "
                             f"max_seq_len {max_seq_len}")
        return (max_seq_len // block_size) * block_bytes(cfg, block_size,
                                                         kv_dtype)
    if cache_layout == "ssd":
        state = ssd_state_bytes(cfg.num_heads, cfg.head_dim,
                                cfg.ssd_state_dim)
        return sum(state if m == "ssd" else kv_slab
                   for m in mixer_pattern(cfg))
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
    """S slots over a paged KV pool (or resident SSD states) + the
    prefill-chunk and decode steps over them.

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
        spec_k: speculative decoding — not ported yet (raises; on the
            ssd layout a ValueError: a cumulative state has no rollback).
        cache_layout: 'paged' for attention stacks, 'ssd' (required) for
            pure-SSD stacks: per slot one [H, Dh, N] f32 state per
            layer, `self.unbounded`, sessions may stream past
            `max_seq_len`, which then only sizes chunking. 'dense' and
            hybrid stacks are not ported yet (raise).
        block_size: tokens per pool block; must divide `max_seq_len`.
        num_blocks: pool size including the sentinel; defaults to every
            slot at `max_seq_len`.
        kv_dtype: 'model' (compute dtype) or 'int8' (per-row absmax
            payloads + f32 scales).
        kernel: the paged READ: 'fused' (the Hopper kernel; CUDA only),
            'gather' (its plain version) or 'auto' ('fused' on CUDA,
            'gather' on the CPU). The ssd layout has no paged read
            ('auto' reads 'gather'); its scan kernel follows
            `config.ssd_kernel`.
        prefix_cache: enable cross-request prefix sharing (paged).
        compile_cache: the CompileCache to keep the steps in; by default
            a private one on the engine's device.
        cuda_graphs: on CUDA, capture the steps as CUDA graphs (the
            default). False runs them eagerly: only for measurements
            that hold replay against eager. It is not a fallback: a
            capture or a replay that fails raises.
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
                 compile_cache: tp.Optional[CompileCache] = None,
                 cuda_graphs: bool = True,
                 device: tp.Any = None):
        self.device = resolve_device(device)
        check_same_device("model", model.embed, self.device)
        self._cfg = cfg = model.config
        check_supported(cfg)
        if cfg.moe_experts > 0:
            raise NotImplementedError(
                f"serving an MoE model through the engine is not ported "
                f"yet (`generate` decodes it): {TODO_MOE_SERVING}")
        if cache_layout not in ("dense", "paged", "ssd"):
            raise ValueError(f"cache_layout must be 'dense', 'paged' or "
                             f"'ssd', got {cache_layout!r}")
        pattern = mixer_pattern(cfg)
        if "ssd" in pattern and cache_layout != "ssd":
            raise ValueError(
                f"the model's mixer pattern {pattern} contains SSD layers, "
                f"whose decode state is a resident per-slot tensor, not "
                f"positioned K/V rows: serve it with cache_layout='ssd' "
                f"(got {cache_layout!r})")
        if cache_layout == "ssd":
            if "ssd" not in pattern:
                raise ValueError(
                    f"cache_layout='ssd' needs at least one SSD layer in "
                    f"the model's mixer pattern, got {pattern}")
            if spec_k is not None:
                raise ValueError(
                    "speculative decoding is not supported with SSD layers: "
                    "the recurrence state is cumulative, so rejected draft "
                    "tokens cannot be rolled back")
            if "attention" in pattern:
                raise NotImplementedError(
                    f"a hybrid stack {pattern} on cache_layout='ssd' keeps "
                    f"dense per-slot K/V slabs beside its states: "
                    f"{TODO_LAYOUTS}")
            if kv_dtype != "model":
                raise ValueError("kv_dtype='int8' requires the paged cache "
                                 "layout")
            if kernel == "fused":
                raise ValueError("kernel='fused' is the paged pool read; "
                                 "the ssd layout has none (its scan kernel "
                                 "follows config.ssd_kernel)")
        if cache_layout == "dense":
            raise NotImplementedError(
                f"cache_layout='dense': {TODO_LAYOUTS}")
        # a pure-SSD stack (the only one the ssd layout takes here) holds
        # nothing per slot that grows with the context: sessions may
        # stream past max_seq_len
        self.unbounded = cache_layout == "ssd"
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
        if kernel == "auto":
            kernel = default_kernel(self.device) if cache_layout == "paged" \
                else "gather"
        self.kernel = kernel
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
        if compile_cache is None:
            compile_cache = CompileCache(device=self.device,
                                         cuda_graphs=cuda_graphs)
        if generator is not None:
            compile_cache.register_generator(generator)
        self.compile_cache = compile_cache
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
        self._params = decode_params(model)
        self._pool: tp.Optional[BlockPool] = None
        if cache_layout == "ssd":
            self._cache_box = CacheBox(init_cache(cfg, slots, 0,
                                                  self.device))
        else:
            if num_blocks is None:
                num_blocks = 1 + slots * (self.max_seq_len
                                          // self.block_size)
            self.num_blocks = int(num_blocks)
            self._pool = BlockPool(num_blocks=self.num_blocks,
                                   block_size=self.block_size,
                                   max_seq_len=self.max_seq_len,
                                   prefix_cache=prefix_cache)
            self._cache_box = CacheBox(init_pool(
                cfg, self.num_blocks, self.block_size, kv_dtype,
                device=self.device))
            self._block_bytes = block_bytes(cfg, self.block_size, kv_dtype)
            self._table_host = np.zeros((slots, self._pool.max_blocks),
                                        np.int32)
            self._table_dev = torch.from_numpy(self._table_host).to(
                self.device)
            self._table_dirty = False
            # the copy-on-write fork's source and destination blocks
            self._copy_blocks = torch.zeros((2, 1), dtype=torch.long,
                                            device=self.device)
        # steps made, by kind (each runs num_layers paged reads or, on
        # the ssd layout, num_layers SSD layers)
        self.step_counts = {"decode": 0, "prefill_chunk": 0}
        # the steps' static buffers: per-slot state, and the inputs of
        # each prefill slice size
        s, dev = self.slots, self.device
        self._tokens = torch.empty((s,), dtype=torch.long, device=dev)
        self._positions = torch.empty((s,), dtype=torch.long, device=dev)
        self._active = torch.empty((s,), dtype=torch.bool, device=dev)
        self._prefill_inputs = {size: self._prefill_buffers(size)
                                for size in {self.chunk, self.tail_bucket}}
        self._reset_slot_state()

    def _prefill_buffers(self, size: int) -> tp.Dict[str, torch.Tensor]:
        """The static inputs of a prefill slice of `size` tokens: tokens
        and positions [1, size]; on the paged layout the slot's table row
        [1, max_blocks]; on the ssd layout the token mask [1, size], the
        slot index [1] and whether the slot starts fresh [1, 1, 1, 1]."""
        dev = self.device
        bufs = {"tokens": torch.zeros((1, size), dtype=torch.long,
                                      device=dev),
                "positions": torch.zeros((1, size), dtype=torch.long,
                                         device=dev)}
        if self._pool is not None:
            bufs["row"] = torch.zeros((1, self._pool.max_blocks),
                                      dtype=torch.int32, device=dev)
        else:
            bufs["mask"] = torch.zeros((1, size), dtype=torch.bool,
                                       device=dev)
            bufs["slot"] = torch.zeros((1,), dtype=torch.long, device=dev)
            bufs["fresh"] = torch.zeros((1, 1, 1, 1), dtype=torch.bool,
                                        device=dev)
        return bufs

    def _reset_slot_state(self) -> None:
        """Every slot inactive, parked at `max_seq_len` (its writes land
        in the sentinel block), on device (in place: the steps' graphs
        read these tensors) and in the host mirror."""
        self._tokens.fill_(self.pad_token)
        self._positions.fill_(self.max_seq_len)
        self._active.fill_(False)
        # host mirror: every position move is host-driven, so reading
        # lengths never needs a device->host copy
        self._positions_host = np.full((self.slots,), self.max_seq_len,
                                       np.int64)
        self._active_host = np.zeros((self.slots,), bool)

    @property
    def _cache(self):
        return self._cache_box.value

    @property
    def pool(self) -> tp.Optional[BlockPool]:
        """The block pool (None on the ssd layout)."""
        return self._pool

    @property
    def cache_box(self) -> CacheBox:
        return self._cache_box

    def _table(self) -> torch.Tensor:
        """Device copy of the block tables, refreshed in place only after
        the host tables changed (admission / retirement, never
        mid-decode)."""
        if self._table_dirty:
            self._table_dev.copy_(torch.from_numpy(self._table_host))
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

    # ------------------------------------------------------------------
    # the steps (eager callables; the compile cache captures them)
    # ------------------------------------------------------------------
    def _build_decode(self) -> tp.Callable:
        """The [S, 1] decode step over the static per-slot state: samples
        every slot's next token (pad_token where inactive) into `tokens`
        and advances the live slots' `positions`, in place; returns
        `tokens`."""
        params, cfg, kernel = self._params, self._cfg, self.kernel

        def decode(tokens, positions, active, table=None):
            if table is None:
                # `active` freezes the state of every slot that is not
                # live: free, or mid-prefill with its state half built
                logits, _ = _apply_step(
                    params, cfg, tokens[:, None], positions[:, None],
                    self._cache, positions, state_mask=active)
            else:
                logits, _ = paged_apply_step(
                    params, cfg, tokens[:, None], positions[:, None],
                    self._cache, table, kernel=kernel)
            nxt = sample_tokens(logits[:, -1], self.temperature,
                                self._generator)
            tokens.copy_(torch.where(active, nxt,
                                     torch.full_like(nxt, self.pad_token)))
            positions.add_(active.long())
            return tokens

        return decode

    def _build_prefill(self) -> tp.Callable:
        """One prefill slice from its static inputs (`_prefill_buffers`);
        returns the slice's f32 logits [1, size, V]. On the ssd layout
        the slot's states are gathered (zeroed where it starts fresh),
        advanced, and scattered back."""
        params, cfg, kernel = self._params, self._cfg, self.kernel
        if self._pool is not None:
            def prefill(tokens, positions, row):
                logits, _ = paged_apply_step(params, cfg, tokens, positions,
                                             self._cache, row,
                                             kernel=kernel)
                return logits

            return prefill

        def prefill_ssd(tokens, positions, mask, slot, fresh):
            mini = {}
            for name, entry in self._cache.items():
                rows = entry["ssd"].index_select(0, slot)
                mini[name] = {"ssd": torch.where(
                    fresh, torch.zeros_like(rows), rows)}
            logits, _ = _apply_step(params, cfg, tokens, positions, mini, 0,
                                    token_mask=mask)
            for name, entry in self._cache.items():
                entry["ssd"].index_copy_(0, slot, mini[name]["ssd"])
            return logits

        return prefill_ssd

    def _build_copy(self) -> tp.Callable:
        """The copy-on-write fork: block blocks[0]'s rows onto block
        blocks[1], in place, across every layer and leaf."""
        copy = copy_block_fn()
        return lambda blocks: copy(self._cache, blocks[0], blocks[1])

    def _decode_args(self) -> tp.Tuple[torch.Tensor, ...]:
        args = (self._tokens, self._positions, self._active)
        return args if self._pool is None else args + (self._table(),)

    @torch.no_grad()
    def warmup(self) -> None:
        """Warm every step live traffic can touch, on scratch inputs over
        parked slots (their writes land in the sentinel block; on the ssd
        layout slot 0's state, which a fresh prefill zeroes): the decode
        step, the prefill slices of `chunk` and `tail_bucket` tokens and,
        paged, the copy-on-write block copy (sentinel onto sentinel). On
        CUDA each is built, run once and captured as a CUDA graph; then
        the compile cache is sealed, so any later capture counts as a
        recompile. Call before admitting requests."""
        if self.allocator.live_count:
            raise ValueError("warmup() runs before any slot is live")
        cache = self.compile_cache
        for size in sorted(self._prefill_inputs):
            bufs = self._prefill_inputs[size]
            bufs["tokens"].fill_(self.pad_token)
            bufs["positions"].copy_(torch.arange(size)[None])
            if self._pool is None:
                bufs["mask"].fill_(False)
                bufs["mask"][0, 0] = True
                bufs["fresh"].fill_(True)
            cache.warm(("prefill_chunk", size), self._build_prefill,
                       *bufs.values())
        cache.warm(("decode", self.slots), self._build_decode,
                   *self._decode_args())
        if self._pool is not None:
            self._copy_blocks.zero_()
            cache.warm(("copy_block",), self._build_copy, self._copy_blocks)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        cache.seal()
        self._reset_slot_state()
        logger.info("serve warm-up done (kernel=%s): %d steps (%s)",
                    self.kernel, len(cache),
                    ", ".join(cache.executables()))

    def acquire_slot(self) -> tp.Optional[int]:
        """Claim a free slot (None when all are live) to admit into."""
        return self.allocator.acquire()

    def can_admit(self, prompt: np.ndarray, max_new_tokens: int) -> bool:
        """Whether the pool can reserve this request's whole budget now
        (net of its prefix-cache credit); always on the ssd layout, where
        the slot is the reservation."""
        if self._pool is None:
            return True
        return self._pool.can_admit(np.asarray(prompt, np.int32),
                                    max_new_tokens)

    def admit(self, slot: int, prompt: np.ndarray,
              max_new_tokens: int) -> int:
        """Reserve the request's blocks and return where prefill starts.

        Walks the prefix index (refcount bumps on shared full blocks, a
        device block copy for a copy-on-write fork), fills the slot's
        table row, and returns the prompt tokens served from the cache
        (always < len(prompt)). Raises PoolExhausted, with nothing
        changed, when the pool lacks headroom. On the ssd layout there
        is nothing to reserve: prefill starts at 0.
        """
        if slot not in self.allocator.live:
            raise ValueError(f"slot {slot} was not acquired")
        if self._pool is None:
            return 0
        prompt = np.asarray(prompt, np.int32)
        plan = self._pool.plan(prompt, max_new_tokens)
        row, start, cow = self._pool.commit(plan, slot)
        self._table_host[slot] = row
        self._table_dirty = True
        if cow is not None:
            self._copy_blocks.copy_(torch.tensor(cow)[:, None])
            with torch.no_grad():
                self.compile_cache.get(("copy_block",), self._build_copy)(
                    self._copy_blocks)
        return start

    def pool_stats(self) -> tp.Optional[tp.Dict[str, float]]:
        """Block-pool counters plus `kv_bytes_per_token`, the pool bytes
        reserved per live token (None on the ssd layout)."""
        if self._pool is None:
            return None
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
        prompt write at positions past every causal horizon; on the ssd
        layout a token mask keeps them out of the state, and the slice
        at `start == 0` zeroes the slot's states first (a fresh request).
        """
        prompt = np.asarray(prompt)
        if prompt.ndim != 1 or prompt.size < 1:
            raise ValueError(f"prompt must be 1-D and non-empty, "
                             f"got shape {prompt.shape}")
        if slot not in self.allocator.live:
            raise ValueError(f"slot {slot} was not acquired")
        length = int(prompt.size)
        if length > self.max_seq_len and not self.unbounded:
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
        bufs = self._prefill_inputs[size]
        bufs["tokens"].copy_(torch.from_numpy(padded))
        bufs["positions"].copy_(torch.arange(start, start + size)[None])
        if self._pool is None:
            bufs["mask"].copy_(torch.arange(size)[None] < used)
            bufs["slot"].fill_(slot)
            bufs["fresh"].fill_(start == 0)
        else:
            bufs["row"].copy_(torch.from_numpy(
                self._table_host[slot:slot + 1]))
        logits = self.compile_cache.get(("prefill_chunk", size),
                                        self._build_prefill)(*bufs.values())
        self.step_counts["prefill_chunk"] += 1
        if not final:
            return start + used, None
        first = int(sample_tokens(logits[0, used - 1:used], self.temperature,
                                  self._generator)[0])
        if self._pool is not None:
            # prompt fully written: index its full blocks for sharing
            self._pool.on_live(slot)
        self._set_slot(slot, first, length, True)
        return start + used, first

    @torch.no_grad()
    def decode(self) -> np.ndarray:
        """One [S, 1] decode step over every slot; returns the [S] next
        tokens (pad_token on inactive slots)."""
        step = self.compile_cache.get(("decode", self.slots),
                                      self._build_decode)
        tokens = step(*self._decode_args())
        self.step_counts["decode"] += 1
        out = tokens.cpu().numpy()
        self._positions_host += self._active_host
        return out

    def _park(self, slot: int) -> None:
        self._set_slot(slot, self.pad_token, self.max_seq_len, False)

    def retire(self, slot: int) -> None:
        """Free `slot`: park it (pending writes land in the sentinel) and
        drop its block refcounts; prompt blocks the prefix index caches
        stay resident for later admissions."""
        self._park(slot)
        if self._pool is not None and self._pool.holds(slot):
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
        if self._pool is not None and self._pool.holds(slot):
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
