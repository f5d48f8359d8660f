"""Slot-based decode engine (port of flashy_tpu/serve/engine.py): S
slots over a dense K/V slab (`cache_layout='dense'`, the default), a
paged K/V pool (`'paged'`) or resident SSD states (`'ssd'`). Every model
layout serves: per-layer and scan-stacked stacks (a stacked model's cache
and pool are stacked [L, ...] leaves), dense or MoE MLPs, and dense or
int8 weights (`params=`, from `models.quantize.quantize_lm_params`).

ONE decode step of shape [S, 1] advances every live slot together, an
active mask (not a shape) expressing liveness, and speculative decoding
adds ONE [S, k+1] verify step that scores k drafted tokens a slot
(`decode_speculative`; accepted counts are data, never shapes). On the
dense layout each slot owns a [max_seq_len, H, Dh] K/V slab per layer,
read with plain einsums (the JAX package's XLA path: no kernel runs
there); prompts prefill either whole, through one step per power-of-two
bucket (`prefill`), or in fixed `[1, chunk]` slices the scheduler
interleaves with decode steps (`prefill_chunk`). On the paged layout
every read goes through `serve.paged.paged_apply_step`, which on CUDA
launches the Hopper paged-decode kernel (`kernel='fused'`, the default
there), the verify step at T = k+1 included; prompts always prefill in
slices, which attend earlier (possibly prefix-shared) blocks through the
slot's table row. On the ssd layout each SSD layer holds one [H, Dh, N]
f32 state a slot: prefill slices run the chunked scan (on CUDA the Hopper
SSD kernel), decode the recurrence; a hybrid stack's attention layers
keep dense slabs beside the states, and a pure-SSD stack may stream
sessions past `max_seq_len`.

The JAX package's compiled-step cache becomes captured CUDA graphs
(`serve.compile_cache.CompileCache`): `warmup()` captures one graph for
each key live traffic can touch, the decode step ("decode", S), the
prefill slices ("prefill_chunk", chunk and tail_bucket) or buckets
("prefill", bucket), the verify step ("verify", S, k) and, on the paged
layout, the copy-on-write block copy ("copy_block",), each key prefixed
by the engine's `cache_scope` when it has one; every later step replays
one. A graph reads and writes fixed tensors, so the engine's per-slot
state, block tables, drafts and prefill inputs are static buffers filled
in place (`copy_`, `fill_`), and the cache is allocated once and updated
in place. A prefill's slot, start and length reach its graph as device
values in those buffers, not as Python ints, so one graph serves every
slot: a slice gathers the slot's rows of every cache leaf with
`index_select` and scatters them back with `index_copy_`. On the CPU the
same steps run eagerly.

Paged engines may share one pool (`pool=`, `cache_box=`,
`pool_slot_base=`): the disaggregated handoff of `serve.fleet` moves a
request between them as a block list (`release_for_handoff`,
`adopt_handoff`), every write to the engine's per-slot state in place,
since its graphs read those tensors. A compile-cache entry belongs to
the engine that built it (`serve.compile_cache`).

With a tracer (`tracer=`, or the process-wide telemetry's) the engine
drops an instant at each admission and a span around each prefill,
prefill slice, decode and verify step (`serve/admit`, `serve/prefill`,
`serve/prefill_chunk`, `serve/decode`, `serve/verify`): host-side Python
around a replay, never inside a capture. The decode and verify spans,
and the final prefill slice's and the bucketed prefill's, include the
read of the step's tokens to the host, which waits for the card: they
time the step to completion. A prefill slice that is not the last reads
nothing back, so its span times the host's dispatch only. No span adds
a synchronize.
"""
import contextlib
import logging
import typing as tp

import numpy as np
import torch

from ..models.decoding import (_apply_step, cache_leaves, decode_params,
                               init_cache, sample_tokens,
                               speculative_acceptance, with_spare_row)
from ..models.transformer import check_supported, mixer_pattern
from ..ops.paged_attention import block_bytes, init_pool, pool_bytes
from ..ops.paged_decode import default_kernel
from ..ops.ssd_scan import ssd_state_bytes
from ..utils import check_same_device, resolve_device
from .compile_cache import CompileCache, bucket_length
from .paged import BlockPool, CacheBox, copy_block_fn, paged_apply_step

logger = logging.getLogger(__name__)

# span names of the engine's steps (category "serve")
SPAN_PREFILL = "serve/prefill"
SPAN_PREFILL_CHUNK = "serve/prefill_chunk"
SPAN_DECODE = "serve/decode"
SPAN_VERIFY = "serve/verify"
SPAN_ADMIT = "serve/admit"


def _zero_ssd_leaves(cache: tp.Dict, fresh: torch.Tensor) -> tp.Dict:
    """Zero the SSD state leaves of a cache dict (per-layer or stacked),
    in place, where `fresh` (a bool tensor that broadcasts against them)
    is set; attention K/V leaves are left as they are. A masked fill,
    never a shape change."""
    for leaf, t in cache_leaves(cache):
        if leaf == "ssd":
            t.masked_fill_(fresh, 0.0)
    return cache


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
    free slot (or None) or a named free one, `release()` returns one;
    double release raises."""

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

    def acquire(self, slot: tp.Optional[int] = None) -> tp.Optional[int]:
        """Claim the lowest free slot (None when every slot is live), or a
        specific free slot: a draft model's engine holds exactly the slots
        its target assigned (serve/draft.py); asking for a live or
        out-of-range slot raises."""
        if slot is None:
            if not self._free:
                return None
            slot = self._free.pop()
            self._live.add(slot)
            return slot
        if slot not in self._free:
            raise ValueError(f"slot {slot} is not free (live: "
                             f"{sorted(self._live)})")
        self._free.remove(slot)
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
    """S slots over a dense K/V slab, a paged K/V pool or resident SSD
    states, and the prefill, decode and verify steps over them.

    Args:
        model: a port `TransformerLM` (per-layer or scan-stacked, dense
            or MoE MLPs); its weights are cast once to the compute dtype
            (`models.decoding.decode_params`).
        slots: S, the number of concurrent requests.
        max_seq_len: per-slot cap; defaults to (and is capped by) the
            model's `config.max_seq_len`.
        temperature: 0 -> greedy (token-exact against `generate()`);
            > 0 -> categorical sampling on `generator`.
        generator: the `torch.Generator` sampling draws from.
        pad_token: emitted for inactive slots; pads prompt slices.
        min_bucket: the smallest prompt bucket and the default
            `tail_bucket`.
        chunk: prefill slice size: prompts prefill in `[1, chunk]` slices
            (`prefill_chunk`); must divide `max_seq_len`. None (the
            default on the dense and ssd layouts) prefills each prompt
            whole through its power-of-two bucket (`prefill`); the paged
            layout always prefills in slices, `chunk` defaulting to
            `block_size`.
        tail_bucket: the smaller slice used when the remaining prompt
            fits it; <= chunk.
        spec_k: speculative decoding: `warmup()` also captures the
            [S, k+1] verify step for this draft length, and the paged
            pool reserves `spec_k` overshoot rows a request. The ssd
            layout refuses it (ValueError: a cumulative state has no
            rollback).
        cache_layout: 'dense' (the default): per slot and attention
            layer a [max_seq_len, H, Dh] K/V slab, read with plain
            einsums. 'paged': a global block pool with per-slot block
            tables, prefix sharing and copy-on-write forks. 'ssd'
            (required when the stack has SSD layers): per slot one
            [H, Dh, N] f32 state per SSD layer and, in a hybrid stack, a
            dense slab per attention layer; a pure-SSD stack sets
            `self.unbounded` and may stream past `max_seq_len`.
        block_size: tokens per pool block (paged); must divide
            `max_seq_len`.
        num_blocks: pool size including the sentinel (paged); defaults to
            every slot at `max_seq_len`.
        kv_dtype: 'model' (compute dtype) or 'int8' (per-row absmax
            payloads + f32 scales; paged only).
        kernel: the paged READ: 'fused' (the Hopper kernel; CUDA only),
            'gather' (its plain version) or 'auto' ('fused' on CUDA,
            'gather' on the CPU). The dense and ssd layouts have no
            paged read: 'fused' raises there and 'auto' reads 'gather'
            (the ssd scan kernel follows `config.ssd_kernel`).
        prefix_cache: enable cross-request prefix sharing (paged).
        pool: a `BlockPool` to share with other paged engines (the
            disaggregated handoff, `serve.fleet.DisaggregatedPair`): its
            block size and `max_seq_len` must be this engine's, and its
            verify overshoot cover `spec_k`. None builds a private pool.
        cache_box: the `CacheBox` holding the shared pool's device
            tensors (requires `pool`): an empty box is filled by this
            engine, a filled one is read as it is, so every engine over
            the pool reads and writes the same tensors (and its graphs
            capture them).
        pool_slot_base: this engine's offset in the shared pool's
            reservation keys (`pool_key(slot) = slot + pool_slot_base`):
            engines over one pool keep disjoint key ranges.
        cache_scope: prefix of this engine's compile-cache keys, so that
            two engines (a draft mirror and its target, a fleet's
            members) can share one CompileCache; an entry belongs to the
            engine that built it, and another engine asking for its key
            raises. A shared cache counts every entry made ready after
            its `seal()` as a recompile: warm every engine that shares it
            with `warmup(seal=False)` before one seals it (as
            `ServingFleet.warmup` does).
        compile_cache: the CompileCache to keep the steps in; by default
            a private one on the engine's device, reporting to the active
            telemetry's watchdog, tracer and (when enabled) roofline
            (`observability.get_telemetry()`), or to a private watchdog.
        tracer: an `observability.Tracer` receiving the engine's spans;
            by default the active telemetry's, if any.
        cuda_graphs: on CUDA, capture the steps as CUDA graphs (the
            default). False runs them eagerly: only for measurements
            that hold replay against eager. It is not a fallback: a
            capture or a replay that fails raises.
        params: the weights to serve instead of the model's own: a
            JAX-shaped tree on the engine's device
            (`models.decoding.lm_params`), e.g. int8 kernels from
            `models.quantize.quantize_lm_params`, which stay resident as
            int8 and are converted at use.
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
                 cache_layout: str = "dense",
                 block_size: int = 16,
                 num_blocks: tp.Optional[int] = None,
                 kv_dtype: str = "model",
                 kernel: str = "auto",
                 prefix_cache: bool = True,
                 pool: tp.Optional[BlockPool] = None,
                 cache_box: tp.Optional[CacheBox] = None,
                 pool_slot_base: int = 0,
                 cache_scope: str = "",
                 compile_cache: tp.Optional[CompileCache] = None,
                 tracer: tp.Any = None,
                 cuda_graphs: bool = True,
                 params: tp.Optional[tp.Dict[str, tp.Any]] = None,
                 device: tp.Any = None):
        self.device = resolve_device(device)
        check_same_device("model", model.embed, self.device)
        self._cfg = cfg = model.config
        check_supported(cfg)
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
        # a pure-SSD stack holds nothing per slot that grows with the
        # context: sessions may stream past max_seq_len; one attention
        # layer's dense slab reinstates the ceiling
        self.unbounded = cache_layout == "ssd" and "attention" not in pattern
        if kv_dtype not in ("model", "int8"):
            raise ValueError(f"kv_dtype must be 'model' or 'int8', "
                             f"got {kv_dtype!r}")
        if kv_dtype == "int8" and cache_layout != "paged":
            raise ValueError("kv_dtype='int8' requires the paged cache "
                             "layout (scales live beside the block pool)")
        if kernel not in ("auto", "gather", "fused"):
            raise ValueError(f"kernel must be 'auto', 'gather' or "
                             f"'fused', got {kernel!r}")
        if kernel == "fused" and cache_layout != "paged":
            raise ValueError(
                f"kernel='fused' is the paged pool read "
                f"(ops/paged_decode.py); the {cache_layout} layout has no "
                f"block tables to iterate (its attention is plain einsums; "
                f"an SSD scan kernel follows config.ssd_kernel)")
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
        if tracer is None or compile_cache is None:
            from ..observability import get_telemetry
            telemetry = get_telemetry()
            if tracer is None and telemetry is not None:
                tracer = telemetry.tracer
            if compile_cache is None:
                compile_cache = CompileCache(
                    watchdog=telemetry.watchdog if telemetry else None,
                    tracer=tracer,
                    roofline=(telemetry.roofline
                              if telemetry is not None
                              and telemetry.roofline.enabled else None),
                    device=self.device, cuda_graphs=cuda_graphs)
        self.tracer = tracer
        if generator is not None:
            compile_cache.register_generator(generator)
        self.compile_cache = compile_cache
        self.cache_scope = str(cache_scope)
        self.pad_token = int(pad_token)
        self.min_bucket = int(min_bucket)
        if cache_layout == "paged" and chunk is None:
            # paged engines always prefill in slices: a slice attends the
            # slot's earlier (possibly prefix-shared) blocks through its
            # table and can resume at any prefix-matched offset
            chunk = self.block_size
        self.chunk = int(chunk) if chunk is not None else None
        if self.chunk is not None:
            if self.chunk < 1 or self.max_seq_len % self.chunk:
                raise ValueError(f"chunk must divide max_seq_len "
                                 f"({self.max_seq_len}), got {self.chunk}")
            self.tail_bucket = int(tail_bucket if tail_bucket is not None
                                   else min(self.min_bucket, self.chunk))
            if not 1 <= self.tail_bucket <= self.chunk:
                raise ValueError(f"tail_bucket must be in [1, chunk], got "
                                 f"{self.tail_bucket} (chunk {self.chunk})")
        else:
            self.tail_bucket = None
        self.spec_k = int(spec_k) if spec_k is not None else None
        if self.spec_k is not None and self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.spec_k}")
        self.allocator = SlotAllocator(slots)
        self._params = decode_params(model, params=params)
        if pool_slot_base < 0:
            raise ValueError(f"pool_slot_base must be >= 0, "
                             f"got {pool_slot_base}")
        if cache_layout != "paged" and (pool is not None
                                        or cache_box is not None
                                        or pool_slot_base):
            raise ValueError("pool / cache_box / pool_slot_base are "
                             "paged-layout sharing hooks; the "
                             f"{cache_layout} layout has no block pool to "
                             "share")
        self._pool_base = int(pool_slot_base)
        self._pool: tp.Optional[BlockPool] = None
        if cache_layout == "paged":
            if pool is not None:
                if pool.block_size != self.block_size:
                    raise ValueError(
                        f"shared pool has block_size {pool.block_size}, "
                        f"engine wants {self.block_size}")
                if pool.max_seq_len != self.max_seq_len:
                    raise ValueError(
                        f"shared pool has max_seq_len {pool.max_seq_len}, "
                        f"engine wants {self.max_seq_len}: table widths "
                        f"would disagree")
                if self.spec_k and pool.spec_overshoot < self.spec_k:
                    raise ValueError(
                        f"shared pool reserves spec_overshoot="
                        f"{pool.spec_overshoot} < this engine's spec_k="
                        f"{self.spec_k}: verify writes would overrun "
                        f"reservations")
                if num_blocks is not None \
                        and int(num_blocks) != pool.num_blocks:
                    raise ValueError(
                        f"num_blocks={num_blocks} contradicts the shared "
                        f"pool's {pool.num_blocks}")
                self._pool = pool
                self.num_blocks = pool.num_blocks
            else:
                if cache_box is not None:
                    raise ValueError("cache_box sharing requires a shared "
                                     "pool (the box holds that pool's "
                                     "device blocks)")
                if num_blocks is None:
                    num_blocks = 1 + slots * (self.max_seq_len
                                              // self.block_size)
                self.num_blocks = int(num_blocks)
                self._pool = BlockPool(num_blocks=self.num_blocks,
                                       block_size=self.block_size,
                                       max_seq_len=self.max_seq_len,
                                       spec_overshoot=self.spec_k or 0,
                                       prefix_cache=prefix_cache)
            self._cache_box = cache_box if cache_box is not None \
                else CacheBox()
            if self._cache_box.value is None:
                self._cache_box.value = init_pool(
                    cfg, self.num_blocks, self.block_size, kv_dtype,
                    device=self.device)
            self._block_bytes = block_bytes(cfg, self.block_size, kv_dtype)
            self._table_host = np.zeros((slots, self._pool.max_blocks),
                                        np.int32)
            self._table_dev = torch.from_numpy(self._table_host).to(
                self.device)
            self._table_dirty = False
            # the copy-on-write fork's source and destination blocks
            self._copy_blocks = torch.zeros((2, 1), dtype=torch.long,
                                            device=self.device)
        else:
            # the dense slabs (hybrid stacks: beside the SSD states)
            self.num_blocks = 0
            self._cache_box = CacheBox(init_cache(cfg, slots,
                                                  self.max_seq_len,
                                                  self.device))
        # steps made, by kind (each attention layer of each step makes
        # one attention read; each SSD layer of a multi-token step one
        # scan)
        self.step_counts = {"decode": 0, "prefill_chunk": 0, "prefill": 0,
                            "verify": 0}
        # the steps' static buffers: per-slot state, the inputs of each
        # prefill slice size and bucket, and each draft length's drafts
        s, dev = self.slots, self.device
        self._tokens = torch.empty((s,), dtype=torch.long, device=dev)
        self._positions = torch.empty((s,), dtype=torch.long, device=dev)
        self._active = torch.empty((s,), dtype=torch.bool, device=dev)
        self._prefill_inputs = {} if self.chunk is None else {
            size: self._prefill_buffers(size)
            for size in {self.chunk, self.tail_bucket}}
        self._bucket_inputs: tp.Dict[int, tp.Dict[str, torch.Tensor]] = {}
        self._draft_inputs: tp.Dict[int, torch.Tensor] = {}
        self._reset_slot_state()

    def _key(self, *parts: tp.Any) -> tp.Tuple[tp.Any, ...]:
        """Compile-cache key of one of this engine's steps, prefixed with
        `cache_scope` so that co-resident engines never collide."""
        return ((self.cache_scope,) if self.cache_scope else ()) + parts

    def _prefill_buffers(self, size: int) -> tp.Dict[str, torch.Tensor]:
        """The static inputs of a prefill slice of `size` tokens: tokens
        and positions [1, size]; on the paged layout the slot's table row
        [1, max_blocks]; on the others the token mask [1, size], the slot
        index [1] and whether the slot starts fresh [1, 1, 1, 1]."""
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

    def _bucket_buffers(self, bucket: int) -> tp.Dict[str, torch.Tensor]:
        """The static inputs of the monolithic prefill of `bucket`: the
        right-padded prompt [1, bucket], its length [1] and the slot [1]
        (made at the bucket's first use, kept for its graph)."""
        if bucket not in self._bucket_inputs:
            dev = self.device
            self._bucket_inputs[bucket] = {
                "tokens": torch.zeros((1, bucket), dtype=torch.long,
                                      device=dev),
                "length": torch.ones((1,), dtype=torch.long, device=dev),
                "slot": torch.zeros((1,), dtype=torch.long, device=dev)}
        return self._bucket_inputs[bucket]

    def _draft_buffer(self, k: int) -> torch.Tensor:
        """The static [S, k] drafts the verify step of length k reads."""
        if k not in self._draft_inputs:
            self._draft_inputs[k] = torch.full(
                (self.slots, k), self.pad_token, dtype=torch.long,
                device=self.device)
        return self._draft_inputs[k]

    def _reset_slot_state(self) -> None:
        """Every slot inactive, parked at `max_seq_len` (its writes are
        dropped, or land in the sentinel block), on device (in place: the
        steps' graphs read these tensors) and in the host mirror."""
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
        """The block pool (None on the dense and ssd layouts)."""
        return self._pool

    @property
    def cache_box(self) -> CacheBox:
        """The CacheBox holding the device cache (share it, with `pool`,
        with a second paged engine for the disaggregated handoff)."""
        return self._cache_box

    def pool_key(self, slot: int) -> int:
        """The BlockPool reservation key of an engine slot: `slot +
        pool_slot_base`, disjoint across engines sharing one pool."""
        return slot + self._pool_base

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
        """The prefill bucket a prompt of this length lands in."""
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
                # `active` freezes the SSD state of every slot that is
                # not live (free, or mid-prefill with its state half
                # built); a parked slot's K/V write is dropped
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

    def _slot_rows(self, slot: torch.Tensor
                   ) -> tp.Tuple[tp.Dict, tp.List[tp.Tuple]]:
        """The slot's rows of every cache leaf (the slot dim is -4 on
        every leaf, per-layer or stacked), as a batch-1 cache (K/V slabs
        keep their spare row, `models.decoding.init_cache`), and the
        (cache tensor, rows) pairs to scatter them back."""
        pairs = []

        def rows_of(node):
            return {key: rows_of(t) if isinstance(t, dict)
                    else rows_of_leaf(key, t) for key, t in node.items()}

        def rows_of_leaf(leaf, t):
            full = t if leaf == "ssd" else with_spare_row(t)
            rows = full.index_select(full.ndim - 4, slot)
            pairs.append((full, rows))
            return rows if leaf == "ssd" else rows[..., :t.shape[-3], :, :]

        return rows_of(self._cache), pairs

    def _build_prefill_chunk(self, size: int) -> tp.Callable:
        """One prefill slice of `size` tokens from its static inputs
        (`_prefill_buffers`); returns the slice's f32 logits [1, size, V].
        Off the paged layout the slot's rows of every leaf are gathered
        (its SSD states zeroed where it starts fresh), advanced, and
        scattered back: each attention slab of the slot is copied out
        and back once a slice."""
        params, cfg, kernel = self._params, self._cfg, self.kernel
        if self._pool is not None:
            def prefill(tokens, positions, row):
                logits, _ = paged_apply_step(params, cfg, tokens, positions,
                                             self._cache, row,
                                             kernel=kernel)
                return logits

            return prefill

        def prefill_slot(tokens, positions, mask, slot, fresh):
            mini, pairs = self._slot_rows(slot)
            _zero_ssd_leaves(mini, fresh)
            # pad rows past the prompt write at positions past every
            # causal horizon; the token mask keeps them out of the state
            logits, _ = _apply_step(params, cfg, tokens, positions, mini,
                                    positions[:, 0], token_mask=mask)
            for full, rows in pairs:
                full.index_copy_(full.ndim - 4, slot, rows)
            return logits

        return prefill_slot

    def _build_prefill(self, bucket: int) -> tp.Callable:
        """The monolithic prefill of one prompt bucket (dense and ssd
        layouts): the prompt [1, bucket] runs against a fresh batch-1
        cache, which is merged into the slot's rows; returns the f32
        logits [1, bucket, V]. Pad positions past `length` are never
        attended, and the token mask keeps them out of SSD states."""
        params, cfg = self._params, self._cfg

        def prefill(tokens, length, slot):
            mini = init_cache(cfg, 1, bucket, self.device)
            positions = torch.arange(bucket, device=tokens.device)[None]
            mask = positions < length[:, None]
            logits, mini = _apply_step(params, cfg, tokens, positions, mini,
                                       0, token_mask=mask)
            for (leaf, t), (_, rows) in zip(cache_leaves(self._cache),
                                            cache_leaves(mini)):
                target = t if leaf == "ssd" else t[..., :bucket, :, :]
                target.index_copy_(t.ndim - 4, slot, rows)
            return logits

        return prefill

    def _build_verify(self, k: int) -> tp.Callable:
        """The [S, k+1] verify step: scores each slot's last token and its
        k drafts in one forward (k+1 K/V rows written at the slot's own
        offset), accepts the longest matching prefix
        (`speculative_acceptance`), and advances `tokens` and `positions`
        past it, in place; returns (out [S, k+1], accepted [S]). Rows
        past the accepted position hold stale draft K/V, past every
        causal horizon until overwritten: rollback is free. Rows past
        the cache are dropped (dense) or land in the sentinel block
        (paged)."""
        params, cfg, kernel = self._params, self._cfg, self.kernel
        pad = self.pad_token

        def verify(tokens, drafts, positions, active, table=None):
            toks = torch.cat([tokens[:, None], drafts], dim=1)
            pos = positions[:, None] + torch.arange(k + 1,
                                                    device=tokens.device)
            if table is None:
                logits, _ = _apply_step(params, cfg, toks, pos, self._cache,
                                        positions)
            else:
                logits, _ = paged_apply_step(params, cfg, toks, pos,
                                             self._cache, table,
                                             kernel=kernel, verify=True)
            out, accepted = speculative_acceptance(
                drafts, logits, temperature=self.temperature,
                generator=self._generator, pad_token=pad)
            out = torch.where(active[:, None], out, torch.full_like(out, pad))
            accepted = torch.where(active, accepted,
                                   torch.zeros_like(accepted))
            last = torch.gather(out, 1, accepted[:, None])[:, 0]
            tokens.copy_(torch.where(active, last,
                                     torch.full_like(last, pad)))
            positions.add_(torch.where(active, accepted + 1,
                                       torch.zeros_like(accepted)))
            return out, accepted

        return verify

    def _build_copy(self) -> tp.Callable:
        """The copy-on-write fork: block blocks[0]'s rows onto block
        blocks[1], in place, across every layer and leaf."""
        copy = copy_block_fn()
        return lambda blocks: copy(self._cache, blocks[0], blocks[1])

    def _decode_args(self) -> tp.Tuple[torch.Tensor, ...]:
        args = (self._tokens, self._positions, self._active)
        return args if self._pool is None else args + (self._table(),)

    def _verify_args(self, k: int) -> tp.Tuple[torch.Tensor, ...]:
        args = (self._tokens, self._draft_buffer(k), self._positions,
                self._active)
        return args if self._pool is None else args + (self._table(),)

    @torch.no_grad()
    def warmup(self, prompt_lengths: tp.Iterable[int] = (),
               seal: bool = True) -> None:
        """Warm every step live traffic can touch, on scratch inputs over
        parked slots (their writes are dropped or land in the sentinel
        block; a prefill's scratch rows land in slot 0, which a real
        prefill overwrites): the prefill slices of `chunk` and
        `tail_bucket` tokens, or the buckets of `min_bucket` and of
        `prompt_lengths`; the decode step; with `spec_k` the verify step;
        and, paged, the copy-on-write block copy (sentinel onto
        sentinel). On CUDA each is built, run once and captured as a CUDA
        graph; then the compile cache is sealed, so any later capture
        counts as a recompile. `seal=False` leaves it open for the other
        engines that share it (the last one's warm-up, or the caller,
        seals it). Call before admitting requests."""
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
                bufs["slot"].zero_()
                bufs["fresh"].fill_(True)
            cache.warm(self._key("prefill_chunk", size),
                       lambda: self._build_prefill_chunk(size),
                       *bufs.values(), owner=self)
        if self.chunk is None:
            buckets = {self.min_bucket}
            buckets.update(self.bucket_for(n) for n in prompt_lengths)
            for bucket in sorted(buckets):
                bufs = self._bucket_buffers(bucket)
                bufs["tokens"].fill_(self.pad_token)
                bufs["length"].fill_(1)
                bufs["slot"].zero_()
                cache.warm(self._key("prefill", bucket),
                           lambda: self._build_prefill(bucket),
                           *bufs.values(), owner=self)
        cache.warm(self._key("decode", self.slots), self._build_decode,
                   *self._decode_args(), owner=self)
        if self.spec_k is not None:
            self._draft_buffer(self.spec_k).fill_(self.pad_token)
            cache.warm(self._key("verify", self.slots, self.spec_k),
                       lambda: self._build_verify(self.spec_k),
                       *self._verify_args(self.spec_k), owner=self)
        if self._pool is not None:
            self._copy_blocks.zero_()
            cache.warm(self._key("copy_block"), self._build_copy,
                       self._copy_blocks, owner=self)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if seal:
            cache.seal()
        self._reset_slot_state()
        logger.info("serve warm-up done (kernel=%s): %d steps (%s)",
                    self.kernel, len(cache),
                    ", ".join(cache.executables()))

    def acquire_slot(self, slot: tp.Optional[int] = None
                     ) -> tp.Optional[int]:
        """Claim a free slot (None when all are live) to admit into; a
        specific `slot` for a mirrored draft engine."""
        return self.allocator.acquire(slot)

    def can_admit(self, prompt: np.ndarray, max_new_tokens: int) -> bool:
        """Whether the pool can reserve this request's whole budget now
        (net of its prefix-cache credit); always on the dense and ssd
        layouts, where the slot is the reservation."""
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
        changed, when the pool lacks headroom. On the dense and ssd
        layouts there is nothing to reserve: prefill starts at 0.
        """
        if slot not in self.allocator.live:
            raise ValueError(f"slot {slot} was not acquired")
        if self._pool is None:
            return 0
        prompt = np.asarray(prompt, np.int32)
        plan = self._pool.plan(prompt, max_new_tokens)
        row, start, cow = self._pool.commit(plan, self.pool_key(slot))
        self._table_host[slot] = row
        self._table_dirty = True
        if cow is not None:
            self._copy_blocks.copy_(torch.tensor(cow)[:, None])
            with torch.no_grad():
                self.compile_cache.get(self._key("copy_block"),
                                       self._build_copy,
                                       owner=self)(self._copy_blocks)
        if self.tracer is not None:
            self.tracer.instant(SPAN_ADMIT, category="serve", slot=slot,
                                matched=start, prompt=int(prompt.size),
                                cow=cow is not None)
        return start

    def _span(self, name: str, **args: tp.Any) -> tp.ContextManager:
        """A tracer span around a step (host-side), or nothing."""
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, category="serve", **args)

    def pool_stats(self) -> tp.Optional[tp.Dict[str, float]]:
        """Block-pool counters plus `kv_bytes_per_token`, the pool bytes
        reserved per live token (None off the paged layout)."""
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

    def cache_bytes(self) -> int:
        """Device bytes of this engine's cache: the whole pool on the
        paged layout, else every slab and state (each slab's spare row
        excluded: it is not cache)."""
        if self._pool is not None:
            return pool_bytes(self._cfg, self.num_blocks, self.block_size,
                              self.kv_dtype)
        return int(sum(t.numel() * t.element_size()
                       for _, t in cache_leaves(self._cache)))

    def _check_prompt(self, slot: int, prompt: tp.Any) -> np.ndarray:
        prompt = np.asarray(prompt)
        if prompt.ndim != 1 or prompt.size < 1:
            raise ValueError(f"prompt must be 1-D and non-empty, "
                             f"got shape {prompt.shape}")
        if slot not in self.allocator.live:
            raise ValueError(f"slot {slot} was not acquired")
        return prompt

    @torch.no_grad()
    def prefill(self, slot: int, prompt: np.ndarray) -> int:
        """Run the whole `prompt` (1-D int tokens) into `slot` through its
        bucket's step; returns the first generated token. The slot must
        have been acquired. Dense and ssd layouts."""
        if self._pool is not None:
            raise ValueError(
                "paged engines prefill in slices (chunk is always set): use "
                "admit() + prefill_chunk(); the monolithic prefill merges a "
                "dense batch-1 cache, which has no meaning for a block pool")
        prompt = self._check_prompt(slot, prompt)
        length = int(prompt.size)
        bucket = self.bucket_for(length)
        padded = np.full((1, bucket), self.pad_token, np.int64)
        padded[0, :length] = prompt
        bufs = self._bucket_buffers(bucket)
        bufs["tokens"].copy_(torch.from_numpy(padded))
        bufs["length"].fill_(length)
        bufs["slot"].fill_(slot)
        step = self.compile_cache.get(self._key("prefill", bucket),
                                      lambda: self._build_prefill(bucket),
                                      owner=self)
        with self._span(SPAN_PREFILL, slot=slot, bucket=bucket,
                        length=length):
            logits = step(*bufs.values())
            first = int(sample_tokens(logits[0, length - 1:length],
                                      self.temperature, self._generator)[0])
        self.step_counts["prefill"] += 1
        self._set_slot(slot, first, length, True)
        return first

    @torch.no_grad()
    def prefill_chunk(self, slot: int, prompt: np.ndarray,
                      start: int) -> tp.Tuple[int, tp.Optional[int]]:
        """Advance `slot`'s prefill by ONE slice of `chunk` (or
        `tail_bucket` when the rest fits it) tokens from `start`.

        Returns `(next_start, first_token)`; `first_token` is None until
        the final slice, when the slot goes live. Pad rows past the
        prompt write at positions past every causal horizon; a token mask
        keeps them out of SSD states, and the slice at `start == 0`
        zeroes the slot's states first (a fresh request).
        """
        if self.chunk is None:
            raise ValueError("engine was built without chunk=...; use "
                             "prefill() for the monolithic bucketed "
                             "prefill")
        prompt = self._check_prompt(slot, prompt)
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
        step = self.compile_cache.get(
            self._key("prefill_chunk", size),
            lambda: self._build_prefill_chunk(size), owner=self)
        with self._span(SPAN_PREFILL_CHUNK, slot=slot, size=size,
                        offset=start, length=length):
            logits = step(*bufs.values())
            if final:
                first = int(sample_tokens(logits[0, used - 1:used],
                                          self.temperature,
                                          self._generator)[0])
        self.step_counts["prefill_chunk"] += 1
        if not final:
            return start + used, None
        if self._pool is not None:
            # prompt fully written: index its full blocks for sharing
            self._pool.on_live(self.pool_key(slot))
        self._set_slot(slot, first, length, True)
        return start + used, first

    @torch.no_grad()
    def decode(self) -> np.ndarray:
        """One [S, 1] decode step over every slot; returns the [S] next
        tokens (pad_token on inactive slots)."""
        step = self.compile_cache.get(self._key("decode", self.slots),
                                      self._build_decode, owner=self)
        with self._span(SPAN_DECODE, live=self.allocator.live_count):
            tokens = step(*self._decode_args())
            # a copy: on the CPU `.cpu()` returns the step's own buffer
            out = tokens.cpu().numpy().copy()
        self.step_counts["decode"] += 1
        self._positions_host += self._active_host
        return out

    @torch.no_grad()
    def decode_speculative(self, drafts: np.ndarray
                           ) -> tp.Tuple[np.ndarray, np.ndarray]:
        """One [S, k+1] verify step over every slot against `drafts` ([S,
        k] proposed tokens; inactive rows ignored).

        Returns `(out_tokens, accepted)`: out_tokens [S, k+1] holds each
        live slot's emitted tokens at indices 0..accepted[s] (accepted
        drafts + the bonus or resampled token, `pad_token` beyond and on
        inactive rows); accepted [S] counts kept drafts. Greedy engines
        emit exactly `generate()`'s tokens
        (`models.decoding.speculative_acceptance`). The step advances each
        live slot by accepted + 1; the stale draft rows past it are past
        every causal horizon until overwritten.
        """
        if self.cache_layout == "ssd":
            raise ValueError(
                "speculative decoding is not supported on the SSD layout: "
                "the recurrence state is cumulative, so rejected drafts "
                "cannot be rolled back")
        drafts = np.asarray(drafts, np.int64)
        if drafts.ndim != 2 or drafts.shape[0] != self.slots \
                or drafts.shape[1] < 1:
            raise ValueError(f"drafts must be [S={self.slots}, k>=1], "
                             f"got {drafts.shape}")
        k = int(drafts.shape[1])
        self._draft_buffer(k).copy_(torch.from_numpy(drafts))
        step = self.compile_cache.get(self._key("verify", self.slots, k),
                                      lambda: self._build_verify(k),
                                      owner=self)
        with self._span(SPAN_VERIFY, k=k, live=self.allocator.live_count):
            out, accepted = step(*self._verify_args(k))
            both = torch.cat([out, accepted[:, None]], dim=1).cpu().numpy()
        self.step_counts["verify"] += 1
        out_np, accepted_np = both[:, :-1], both[:, -1]
        self._positions_host += np.where(self._active_host,
                                         accepted_np + 1, 0)
        return out_np, accepted_np

    def set_slot_state(self, slot: int, last_token: int,
                       position: int) -> None:
        """Overwrite a live slot's (last token, position) pair: the
        rollback and resync of a mirrored draft engine that ran ahead
        (rows past `position` need no cleanup: they are past every causal
        horizon until overwritten)."""
        if slot not in self.allocator.live:
            raise ValueError(f"slot {slot} is not live")
        if not (0 <= position <= self.max_seq_len
                or (self.unbounded and position >= 0)):
            raise ValueError(f"position {position} outside "
                             f"[0, {self.max_seq_len}]")
        self._tokens[slot] = int(last_token)
        self._positions[slot] = int(position)
        self._positions_host[slot] = int(position)

    def slot_length(self, slot: int) -> int:
        """Current sequence length of a slot (prompt + generated), from
        the host mirror: no device->host copy."""
        return int(self._positions_host[slot])

    def _park(self, slot: int) -> None:
        self._set_slot(slot, self.pad_token, self.max_seq_len, False)

    def retire(self, slot: int) -> None:
        """Free `slot`: park it (pending writes are dropped or land in the
        sentinel) and drop its block refcounts; prompt blocks the prefix
        index caches stay resident for later admissions."""
        self._park(slot)
        if self._pool is not None and self._pool.holds(self.pool_key(slot)):
            self._pool.release(self.pool_key(slot))
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
        if self._pool is not None and self._pool.holds(self.pool_key(slot)):
            self._pool.evict_slot(self.pool_key(slot))
            self._table_host[slot] = 0
            self._table_dirty = True
        self.allocator.release(slot)

    def release_for_handoff(self, slot: int) -> tp.Dict[str, tp.Any]:
        """Export a live slot's decode state and detach the slot WITHOUT
        freeing its pool blocks (the prefill half of disaggregation).

        Returns `{"blocks", "position", "last_token"}`: the ordered pool
        blocks behind the slot's table, the next write position (prompt +
        generated length) and the last emitted token, which is all an
        engine over the SAME pool and CacheBox needs to continue the
        request token-exactly. The reservation stays keyed to
        `pool_key(slot)` until the importer re-keys it
        (`BlockPool.transfer_slot`); the slot is parked (in place: the
        graphs read these tensors) and returned to the allocator. Paged
        engines only.
        """
        if self._pool is None:
            raise ValueError("handoff requires the paged layout: the "
                             "transfer unit is a block id list")
        if slot not in self.allocator.live or not self._active_host[slot]:
            raise ValueError(f"slot {slot} is not live")
        packet = {
            "blocks": self._pool.slot_blocks(self.pool_key(slot)),
            "position": int(self._positions_host[slot]),
            "last_token": int(self._tokens[slot]),
        }
        self._park(slot)
        self._table_host[slot] = 0
        self._table_dirty = True
        self.allocator.release(slot)
        return packet

    def adopt_handoff(self, slot: int, blocks: tp.Sequence[int],
                      last_token: int, position: int) -> None:
        """Install an exported reservation into an acquired slot (the
        decode half of disaggregation): the slot's table row becomes the
        handed-off block list (refreshed on device through the dirty
        table) and the slot is armed at (`last_token`, `position`), in
        place, so the next decode step continues where the exporting
        engine stopped. The reservation must already be keyed to
        `pool_key(slot)` (`BlockPool.transfer_slot`; the fleet's
        `hand_off` does both halves in order). Token-exact: the blocks
        hold K/V rows that are pure functions of (token, position,
        weights), and this engine shares all three.
        """
        if self._pool is None:
            raise ValueError("handoff requires the paged layout")
        if slot not in self.allocator.live:
            raise ValueError(f"slot {slot} was not acquired")
        if not self._pool.holds(self.pool_key(slot)):
            raise ValueError(
                f"pool holds no reservation keyed to {self.pool_key(slot)}"
                f": transfer_slot() must re-key the export first")
        if not 0 < position <= self.max_seq_len:
            raise ValueError(f"position {position} outside "
                             f"(0, {self.max_seq_len}]")
        blocks = list(blocks)
        if len(blocks) > self._pool.max_blocks:
            raise ValueError(f"{len(blocks)} blocks exceed the "
                             f"{self._pool.max_blocks}-entry table")
        row = np.zeros(self._pool.max_blocks, np.int32)  # sentinel-padded
        row[:len(blocks)] = blocks
        self._table_host[slot] = row
        self._table_dirty = True
        self._set_slot(slot, int(last_token), int(position), True)

    @property
    def live_count(self) -> int:
        return self.allocator.live_count

    @property
    def free_count(self) -> int:
        return self.allocator.free_count
