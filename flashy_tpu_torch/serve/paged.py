"""Paged KV cache management (port of flashy_tpu/serve/paged.py).

The host-side half of the paged layout — `BlockPool` (free list,
refcounts, whole-budget reservations at admission, the sentinel block)
and `PrefixIndex` (block-granular prefix sharing with copy-on-write
forks of partially shared blocks) — is numpy and carries over from the
JAX package line for line. `paged_apply_step` is the device step: the
dense decode step with the slab read/write swapped for table-driven
pool writes and paged reads, through the Hopper kernel
(`kernel='fused'`) or its plain version (`kernel='gather'`).

The matched prefix is capped at len(prompt) - 1: the last prompt token
is always re-prefilled so the engine gets its first-token logits from a
real forward. Re-writing that row into a still-shared block is exact:
a cached K/V row is a pure function of (token, position, params).
"""
import dataclasses
import heapq
import logging
import typing as tp

import numpy as np
import torch

logger = logging.getLogger(__name__)

SENTINEL = 0  # physical block 0: never allocated, absorbs parked writes
# the chaos fault point every admission's reservation passes
POOL_FAULT_SITE = "serve.pool"


class PoolExhausted(RuntimeError):
    """Raised when an admission cannot reserve its blocks.

    The paged counterpart of a full slot table: the scheduler treats it
    as no-capacity-right-now (the request stays queued; QueueFull at
    the submit door is the client-visible backpressure), never as a
    crash.
    """


class CacheBox:
    """One level of indirection over the device pool dict, so an engine
    reads the pool through `value` instead of holding the tensors itself:
    engines sharing one pool (`DecodeEngine(pool=, cache_box=)`) share
    the box, and the first fills it."""

    __slots__ = ("value",)

    def __init__(self, value: tp.Any = None):
        self.value = value


_ROOT = ("root",)


@dataclasses.dataclass
class _IndexEntry:
    """One cached full block: its chain key, tokens, and pool block."""
    key: tp.Tuple
    tokens: np.ndarray            # [block_size] int32, this block's tokens
    block: int                    # pool block id holding its K/V
    parent_key: tp.Tuple          # _ROOT or another entry's key
    children: int = 0             # cached entries chaining off this one
    last_use: int = 0             # LRU clock (bumped on every match)


class PrefixIndex:
    """Chain-hash index of cached full blocks.

    Keys are `(parent_key, tokens.tobytes())` — the exact token content
    of the block appended to its parent's chain — so a hit means the
    whole prefix up to and including this block is token-identical, and
    the cached K/V can be shared by reference (rows are pure functions
    of token + position). Partial matches (for copy-on-write forks)
    scan the parent's children for the longest common token prefix.
    """

    def __init__(self):
        self._entries: tp.Dict[tp.Tuple, _IndexEntry] = {}
        self._children: tp.Dict[tp.Tuple, tp.List[_IndexEntry]] = {}
        self._clock = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def blocks(self) -> tp.Set[int]:
        """Pool blocks currently held by the index."""
        return {e.block for e in self._entries.values()}

    def _tick(self, entry: _IndexEntry) -> None:
        self._clock += 1
        entry.last_use = self._clock

    def match(self, prompt: np.ndarray, block_size: int
              ) -> tp.Tuple[tp.List[_IndexEntry],
                            tp.Optional[tp.Tuple[_IndexEntry, int]]]:
        """Longest cached walk of `prompt`.

        Returns `(full, partial)`: `full` is the chain of fully
        matching block entries (block i covers prompt tokens
        [i*bs, (i+1)*bs)); `partial` is the child entry sharing the
        longest non-empty token prefix with the REMAINING prompt (the
        copy-on-write fork source), or None.
        """
        full: tp.List[_IndexEntry] = []
        parent = _ROOT
        n_full = len(prompt) // block_size
        i = 0
        while i < n_full:
            tokens = np.ascontiguousarray(prompt[i * block_size:
                                                 (i + 1) * block_size])
            entry = self._entries.get((parent, tokens.tobytes()))
            if entry is None:
                break
            self._tick(entry)
            full.append(entry)
            parent = entry.key
            i += 1
        rest = prompt[i * block_size:]
        best: tp.Optional[tp.Tuple[_IndexEntry, int]] = None
        if len(rest):
            for child in self._children.get(parent, ()):
                n = int(np.argmin(np.concatenate([
                    child.tokens[:len(rest)] == rest[:len(child.tokens)],
                    [False]])))
                if n > 0 and (best is None or n > best[1]):
                    best = (child, n)
            if best is not None:
                self._tick(best[0])
        return full, best

    def register(self, prompt: np.ndarray, blocks: tp.Sequence[int],
                 block_size: int) -> tp.List[int]:
        """Index the prompt's full blocks; returns the block ids NEWLY
        held by the index (their pool blocks must survive slot
        retirement until evicted). Chains that already exist keep their
        existing entry — the caller's twin block stays private."""
        added: tp.List[int] = []
        parent = _ROOT
        for i in range(len(prompt) // block_size):
            tokens = np.ascontiguousarray(prompt[i * block_size:
                                                 (i + 1) * block_size])
            key = (parent, tokens.tobytes())
            entry = self._entries.get(key)
            if entry is None:
                entry = _IndexEntry(key=key, tokens=tokens.copy(),
                                    block=int(blocks[i]), parent_key=parent)
                self._entries[key] = entry
                self._children.setdefault(parent, []).append(entry)
                if parent is not _ROOT:
                    self._entries[parent].children += 1
                self._tick(entry)
                added.append(entry.block)
            parent = key
        return added

    def evictable(self, refcount: np.ndarray) -> tp.List[_IndexEntry]:
        """Leaf entries whose block no slot references, LRU-first."""
        leaves = [e for e in self._entries.values()
                  if e.children == 0 and refcount[e.block] == 0]
        return sorted(leaves, key=lambda e: e.last_use)

    def evict(self, entry: _IndexEntry) -> int:
        """Drop a (leaf) entry; returns its freed pool block id."""
        assert entry.children == 0, "evict leaves first"
        del self._entries[entry.key]
        self._children[entry.parent_key].remove(entry)
        if entry.parent_key is not _ROOT:
            self._entries[entry.parent_key].children -= 1
        return entry.block


@dataclasses.dataclass
class AdmissionPlan:
    """One admission's block accounting, computed before committing."""
    prompt: np.ndarray
    reserve_blocks: int                 # table entries the slot will own
    full: tp.List[_IndexEntry]          # shared full-block chain
    partial: tp.Optional[tp.Tuple[_IndexEntry, int]]  # COW source, n tokens
    matched_tokens: int                 # capped at len(prompt) - 1
    fresh_needed: int                   # blocks to allocate (incl. COW dst)


class BlockPool:
    """Host-side bookkeeping of the global K/V block pool.

    Owns WHICH pool block belongs to whom — free list, per-block slot
    refcounts, per-slot reservations, and the PrefixIndex — while the
    device arrays live in the engine's cache pytree. All methods are
    host-synchronous (the scheduler is single-threaded); `check()`
    asserts the conservation invariant the paged demo gates on: every
    block is exactly one of {sentinel, free, slot-referenced,
    index-cached} and the pool never over-commits.

    Args:
        num_blocks: pool size INCLUDING the sentinel (capacity is
            num_blocks - 1).
        block_size: tokens per block; must divide max_seq_len.
        max_seq_len: per-slot logical cap (table width derives from it).
        spec_overshoot: extra reserved tokens per request covering the
            speculative verify's write/query overshoot (engine.spec_k).
        prefix_cache: enable the PrefixIndex (sharing + COW); off, every
            admission allocates fresh blocks and retirement frees them
            all.
    """

    def __init__(self, *, num_blocks: int, block_size: int,
                 max_seq_len: int, spec_overshoot: int = 0,
                 prefix_cache: bool = True):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (sentinel + 1 real), "
                             f"got {num_blocks}")
        if block_size < 1 or max_seq_len % block_size != 0:
            raise ValueError(f"block_size must divide max_seq_len "
                             f"({max_seq_len}), got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.max_blocks = max_seq_len // block_size  # per-slot table entries
        self.max_seq_len = max_seq_len
        self.spec_overshoot = int(spec_overshoot)
        self.prefix_cache = prefix_cache
        self.capacity = num_blocks - 1
        # min-heap: allocation pops the lowest free block (deterministic
        # tables for tests/traces) in O(log N), not via list sorts
        self._free = list(range(SENTINEL + 1, num_blocks))
        self.refcount = np.zeros(num_blocks, np.int64)
        self.index = PrefixIndex()
        # incrementally maintained mirror of index.blocks, so the
        # per-step accounting views never rebuild a set over the index
        self._cached: tp.Set[int] = set()
        # slot -> (prompt, ordered owned/shared block ids, reserve count)
        self._slots: tp.Dict[int, tp.Tuple[np.ndarray, tp.List[int], int]] = {}
        # counters for metrics / the demo gates
        self.peak_in_use = 0
        self.allocated_total = 0
        self.evictions = 0
        self.cow_forks = 0
        self.prefix_matched_tokens = 0
        self.prefix_total_tokens = 0
        self.preemptions = 0
        self.handoffs = 0

    # ------------------------------------------------------------------
    # accounting views
    # ------------------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def in_use_blocks(self) -> int:
        """Blocks neither free nor sentinel (slot-held or index-cached)."""
        return self.capacity - len(self._free)

    @property
    def cached_blocks(self) -> int:
        """Index-held blocks no live slot references (evictable)."""
        return sum(1 for b in self._cached if self.refcount[b] == 0)

    @property
    def headroom(self) -> int:
        """Blocks an admission could obtain: free + evictable cached."""
        return self.free_blocks + self.cached_blocks

    @property
    def prefix_hit_rate(self) -> float:
        """Cumulative prompt tokens served from the index / submitted.

        ENGINE-lifetime scope, the number the paged demo gates on.
        `ServeMetrics.on_prefix` keeps the same tally per SCHEDULER
        (one serving phase) — same formula, different window; the demo
        runs two schedulers over one engine, so both exist on purpose.
        """
        return (self.prefix_matched_tokens / self.prefix_total_tokens
                if self.prefix_total_tokens else 0.0)

    def reserve_blocks_for(self, prompt_tokens: int,
                           max_new_tokens: int) -> int:
        """Table entries a request must own: prompt + output budget +
        verify overshoot, rounded up to blocks, capped at the table
        width (positions past max_seq_len clamp into the sentinel, the
        dense path's mode='drop')."""
        tokens = prompt_tokens + max_new_tokens + self.spec_overshoot
        return min(-(-tokens // self.block_size), self.max_blocks)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def plan(self, prompt: np.ndarray,
             max_new_tokens: int) -> AdmissionPlan:
        """Price one admission: prefix walk + blocks still needed."""
        prompt = np.asarray(prompt, np.int32)
        reserve = self.reserve_blocks_for(len(prompt), max_new_tokens)
        full: tp.List[_IndexEntry] = []
        partial = None
        if self.prefix_cache:
            full, partial = self.index.match(prompt, self.block_size)
        matched = len(full) * self.block_size
        if partial is not None:
            matched += partial[1]
        # always leave >= 1 token to prefill (the first-token logits
        # come from a real forward); a partial match shrunk to zero by
        # the cap is no fork at all.
        matched = min(matched, len(prompt) - 1)
        if partial is not None and matched <= len(full) * self.block_size:
            partial = None
        return AdmissionPlan(prompt=prompt, reserve_blocks=reserve,
                             full=full, partial=partial,
                             matched_tokens=matched,
                             fresh_needed=reserve - len(full))

    def _plan_protect(self, plan: AdmissionPlan) -> tp.Set[int]:
        """Blocks this plan references that eviction must not free: the
        matched full chain (their refcount bump happens at commit, so a
        cached-only matched block still LOOKS evictable) and the COW
        fork source (copied from right after commit)."""
        protect = {e.block for e in plan.full}
        if plan.partial is not None:
            protect.add(plan.partial[0].block)
        return protect

    def _headroom_for(self, plan: AdmissionPlan) -> int:
        """Free + evictable blocks NET of the plan's protected set."""
        protect = self._plan_protect(plan)
        evictable = sum(1 for b in self._cached if self.refcount[b] == 0
                        and b not in protect)
        return self.free_blocks + evictable

    def can_admit(self, prompt: np.ndarray, max_new_tokens: int) -> bool:
        """Whether `commit(plan(...))` would succeed right now."""
        plan = self.plan(prompt, max_new_tokens)
        return plan.fresh_needed <= self._headroom_for(plan)

    def _evict_for(self, need: int, protect: tp.Set[int]) -> None:
        """Free cached blocks (LRU leaves first) until `need` are free."""
        while len(self._free) < need:
            candidates = [e for e in self.index.evictable(self.refcount)
                          if e.block not in protect]
            if not candidates:
                raise PoolExhausted(
                    f"pool over-committed: need {need} free blocks, have "
                    f"{len(self._free)} free + "
                    f"{self.cached_blocks} evictable")
            block = self.index.evict(candidates[0])
            self.evictions += 1
            self._cached.discard(block)
            heapq.heappush(self._free, block)

    def commit(self, plan: AdmissionPlan, slot: int
               ) -> tp.Tuple[np.ndarray, int,
                             tp.Optional[tp.Tuple[int, int]]]:
        """Reserve `plan`'s blocks for `slot`.

        Returns `(table_row, prefill_start, cow)`: a `[max_blocks]`
        int32 table row (sentinel-padded), the position prefill resumes
        at (== matched tokens), and the `(src, dst)` pool blocks the
        engine must device-copy for a COW fork (None when no partial
        match). Atomic: on PoolExhausted nothing changed. Passes the
        `serve.pool` fault point first: an injected fault there is an
        allocation failure (PoolExhausted), which the scheduler sheds.
        """
        from ..resilience import InjectedFault, fault_point
        if slot in self._slots:
            raise ValueError(f"slot {slot} already holds a reservation")
        try:
            fault_point(POOL_FAULT_SITE, slot=slot, need=plan.fresh_needed)
        except InjectedFault as exc:
            raise PoolExhausted(f"injected allocation failure: {exc}") \
                from exc
        if plan.fresh_needed > self._headroom_for(plan):
            raise PoolExhausted(
                f"admission needs {plan.fresh_needed} blocks, pool has "
                f"{self._headroom_for(plan)} (free {self.free_blocks} + "
                f"evictable cached net of this plan's own matched "
                f"blocks)")
        self._evict_for(plan.fresh_needed, self._plan_protect(plan))
        fresh = [heapq.heappop(self._free)
                 for _ in range(plan.fresh_needed)]
        self.allocated_total += len(fresh)
        blocks = [e.block for e in plan.full] + fresh
        for b in blocks:
            self.refcount[b] += 1
        row = np.full(self.max_blocks, SENTINEL, np.int32)
        row[:len(blocks)] = blocks
        self._slots[slot] = (plan.prompt, blocks, plan.reserve_blocks)
        self.prefix_matched_tokens += plan.matched_tokens
        self.prefix_total_tokens += len(plan.prompt)
        cow = None
        if plan.partial is not None:
            # the first fresh block sits right after the shared chain —
            # exactly the table entry the partial match covers
            cow = (plan.partial[0].block, fresh[0])
            self.cow_forks += 1
        self.peak_in_use = max(self.peak_in_use, self.in_use_blocks)
        # O(touched) sanity inline; the full O(pool) check() stays for
        # demos/tests/fault paths, off the per-admission hot path
        assert SENTINEL not in blocks and len(set(blocks)) == len(blocks)
        return row, plan.matched_tokens, cow

    def on_live(self, slot: int) -> None:
        """Prefill finished: index the slot's full prompt blocks so
        later admissions can share them (no-op without prefix_cache)."""
        if not self.prefix_cache:
            return
        prompt, blocks, _ = self._slots[slot]
        self._cached.update(
            self.index.register(prompt, blocks, self.block_size))

    def release(self, slot: int) -> tp.List[int]:
        """Retire a slot's reservation; returns the blocks actually
        freed (index-cached blocks stay resident at refcount 0 until
        evicted — that IS the prefix cache)."""
        prompt, blocks, _ = self._slots.pop(slot)
        freed: tp.List[int] = []
        for b in blocks:
            self.refcount[b] -= 1
            assert self.refcount[b] >= 0, f"double release of block {b}"
            if self.refcount[b] == 0 and b not in self._cached:
                heapq.heappush(self._free, b)
                freed.append(b)
        return freed

    def evict_slot(self, slot: int) -> tp.List[int]:
        """Preempt a live slot: atomically tear down its reservation
        mid-flight and return the blocks actually freed.

        The preemption primitive (scheduler priority classes): every
        block the slot references drops one
        refcount, and blocks nothing else holds return to the free list
        — EXCEPT prompt blocks the prefix index still caches, which
        stay resident at refcount 0. That is what makes preemption
        rollback cheap: the preempted request's re-admission re-matches
        its own prompt chain, so the re-prefill shrinks to the uncached
        suffix plus whatever it had generated. No K/V cleanup is needed
        for rows the request wrote past its prompt: once the engine
        parks the slot's position they sit beyond every causal horizon
        until a later reservation overwrites them — the same
        rollback-is-free argument as speculative rejection.

        Identical conservation outcome to `release()` (the invariant
        `check()` asserts holds across either), kept as a distinct
        verb so preemptions are separately counted and auditable.
        Raises KeyError for a slot holding no reservation.
        """
        if slot not in self._slots:
            raise KeyError(f"slot {slot} holds no reservation to evict")
        self.preemptions += 1
        return self.release(slot)

    def transfer_slot(self, src: int, dst: int) -> tp.List[int]:
        """Re-key a reservation from slot key `src` to `dst` (the
        disaggregated prefill->decode handoff).

        Refcounts, the prefix index and the device blocks are untouched:
        ownership of the SAME block list moves between slot keys, so the
        transfer unit is a block id list, never a K/V slab. Returns the
        ordered block list now keyed to `dst`. Raises KeyError when `src`
        holds no reservation and ValueError when `dst` already holds one.
        """
        if src not in self._slots:
            raise KeyError(f"slot {src} holds no reservation to transfer")
        if dst in self._slots:
            raise ValueError(f"slot {dst} already holds a reservation")
        self._slots[dst] = self._slots.pop(src)
        self.handoffs += 1
        return list(self._slots[dst][1])

    def holds(self, slot: int) -> bool:
        """Whether `slot` currently holds a reservation."""
        return slot in self._slots

    def slot_blocks(self, slot: int) -> tp.List[int]:
        """The ordered pool blocks backing a live slot's table."""
        return list(self._slots[slot][1])

    # ------------------------------------------------------------------
    # invariants + stats
    # ------------------------------------------------------------------
    def check(self) -> None:
        """Conservation invariant: sentinel + free + referenced/cached
        partition the pool; refcounts match the live reservations.

        O(pool): the demo/test/fault-path gate, not called per step —
        mutations keep O(touched) asserts inline instead."""
        if np.any(self.refcount < 0):
            raise AssertionError("negative block refcount")
        if self._cached != self.index.blocks:
            raise AssertionError("cached-block mirror drifted from the "
                                 "index")
        want = np.zeros(self.num_blocks, np.int64)
        for _, blocks, _ in self._slots.values():
            for b in blocks:
                want[b] += 1
        if not np.array_equal(want, self.refcount):
            raise AssertionError("refcounts drifted from reservations")
        free = set(self._free)
        if SENTINEL in free:
            raise AssertionError("sentinel block on the free list")
        held = {b for _, blocks, _ in self._slots.values() for b in blocks}
        held |= self.index.blocks
        if free & held:
            raise AssertionError(f"blocks both free and held: {free & held}")
        if len(free) + len(held) != self.capacity:
            raise AssertionError(
                f"pool leak: {len(free)} free + {len(held)} held != "
                f"capacity {self.capacity}")

    def stats(self) -> tp.Dict[str, float]:
        """Occupancy + prefix counters for ServeMetrics/the demo."""
        return {
            "capacity": self.capacity,
            "free": self.free_blocks,
            "in_use": self.in_use_blocks,
            "cached": self.cached_blocks,
            "occupancy": self.in_use_blocks / self.capacity,
            "peak_in_use": self.peak_in_use,
            "evictions": self.evictions,
            "cow_forks": self.cow_forks,
            "allocated_total": self.allocated_total,
            "prefix_hit_rate": self.prefix_hit_rate,
            "preemptions": self.preemptions,
            "handoffs": self.handoffs,
        }


# ----------------------------------------------------------------------
# the paged model step (device side)
# ----------------------------------------------------------------------
def paged_apply_step(params: tp.Dict, cfg, tokens: torch.Tensor,
                     positions: torch.Tensor, cache: tp.Dict,
                     table: torch.Tensor, kernel: str = "gather",
                     verify: bool = False):
    """Forward `tokens` [B, T] at `positions` [B, T] against the pool.

    The paged twin of `models.decoding._apply_step`: the same embed,
    projections (int8 kernels included), MLP or routed experts, norms
    and head, with the dense slab read/write swapped for `paged_write`
    and a paged read; a scan-stacked model runs the same layer over
    per-layer views of its stacked parameters and pool. `table` is
    [B, max_blocks] int32. `kernel` picks the READ: 'fused' is the
    Hopper kernel (`ops.paged_decode`, legal because every engine read
    queries consecutive positions per row), 'gather' its plain version.
    `verify` marks the speculative verify step, whose fused read is
    `fused_speculative_verify` (the same kernel at T = k+1). The pool is
    updated in place; returns (f32 logits [B, T, V], cache).
    """
    from ..models.decoding import (_attention_out, _blocks, _embed_tokens,
                                   _head_logits, _kernel, _mlp_forward,
                                   _postscale, _rmsnorm, _rotary,
                                   cache_entries)
    from ..ops.paged_attention import paged_attention, paged_write
    from ..ops.paged_decode import (fused_paged_attention,
                                    fused_speculative_verify)

    if kernel not in ("gather", "fused"):
        raise ValueError(f"kernel must be 'gather' or 'fused', "
                         f"got {kernel!r}")
    attend = paged_attention if kernel == "gather" \
        else fused_speculative_verify if verify else fused_paged_attention

    x = _embed_tokens(params, tokens, cfg.dtype)
    for bp, entry in zip(_blocks(cfg, params), cache_entries(cfg, cache)):
        normed = _rmsnorm(x, bp["norm1"]["scale"], cfg.dtype)
        qkv_w, qkv_s = _kernel(bp["attn"]["qkv"]["kernel"], cfg.dtype)
        qkv = _postscale(torch.einsum("btd,dchk->btchk", normed, qkv_w),
                         qkv_s)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        q = _rotary(q, positions)
        k = _rotary(k, positions)
        paged_write(entry, k, v, table, positions)
        attn = attend(q, entry, table, positions,
                      head_dim=cfg.head_dim, dtype=cfg.dtype)
        x = x + _attention_out(cfg, bp, attn)
        normed = _rmsnorm(x, bp["norm2"]["scale"], cfg.dtype)
        x = x + _mlp_forward(cfg, bp, normed)
    return _head_logits(params, x, cfg), cache


def copy_block_fn() -> tp.Callable:
    """Build the COW device copy: `(cache, src, dst) -> cache` with
    block `src`'s rows duplicated onto block `dst` in place, across
    every layer and leaf (int8 payloads and their scales). The block
    axis comes from each leaf's rank, as in the JAX package's
    `copy_block_fn`: k/v leaves are [..., N, bs, H, Dh], scales
    [..., N, bs, H], so a scan-stacked pool's [L, ...] leaves copy on
    axis 1. `src` and `dst` are [1] int64 tensors on the pool's device,
    so that one captured step serves every pair of blocks."""
    from ..models.decoding import cache_leaves

    def copy(cache, src: torch.Tensor, dst: torch.Tensor):
        for name, leaf in cache_leaves(cache):
            axis = leaf.ndim - (4 if name in ("k", "v") else 3)
            leaf.index_copy_(axis, dst, leaf.index_select(axis, src))
        return cache

    return copy
