"""Prefill/decode disaggregation (port of
flashy_tpu/serve/fleet/handoff.py): move a request's K/V state between
engines as a block list.

Prefill is compute-bound and decode bandwidth-bound; the classic serving
split runs them on separate engines. The paged layout makes the transfer
almost free: both engines index the SAME device pool through their own
tables, so moving a request re-keys a `BlockPool` reservation and
installs a table row. A block id list crosses the boundary, never a K/V
slab. Token exactness is the purity argument the paged cache rests on:
K/V rows are pure functions of (token, position, weights), and the
decode engine shares all three with the prefill engine.

The two engines share one `BlockPool` and one `CacheBox`: the box's
tensors are allocated once, by the first engine, and both engines' CUDA
graphs capture those same tensors. The handoff's writes to the
importing engine's per-slot state are in place (`DecodeEngine.
adopt_handoff`), since its graphs read those tensors.
"""
import dataclasses
import time
import typing as tp

import numpy as np


@dataclasses.dataclass(frozen=True)
class HandoffPacket:
    """Everything that crosses the prefill->decode boundary: the ordered
    pool block ids behind the request's table row, the next write
    position (prompt + generated length) and the last emitted token. No
    K/V tensors: the blocks already live in the shared pool."""
    blocks: tp.Tuple[int, ...]
    position: int
    last_token: int
    src: str = ""  # engine names, for the journal/trace record
    dst: str = ""


def hand_off(src: tp.Any, dst: tp.Any, slot: int,
             dst_slot: tp.Optional[int] = None
             ) -> tp.Tuple[int, HandoffPacket]:
    """Move the live request in `src`'s `slot` onto `dst`; returns
    `(dst_slot, packet)`.

    Three steps, ordered so that a failure leaves a consistent pool: (1)
    claim the destination slot (fails before anything moved); (2) export
    and detach from `src` (`release_for_handoff`: the blocks stay
    reserved); (3) re-key the reservation (`BlockPool.transfer_slot`) and
    install it (`adopt_handoff`). Both engines must share ONE `BlockPool`
    and ONE `CacheBox`, with disjoint `pool_slot_base` ranges.
    """
    if src.pool is None or src.pool is not dst.pool:
        raise ValueError("handoff requires src and dst to share one "
                         "BlockPool (the block ids must name the same "
                         "device pool)")
    if src.cache_box is not dst.cache_box:
        raise ValueError("handoff requires src and dst to share one "
                         "CacheBox: separate device pools would make the "
                         "block list name K/V the destination cannot read")
    new_slot = dst.acquire_slot(dst_slot)
    if new_slot is None:
        raise RuntimeError(f"destination engine has no free slot for the "
                           f"handoff (live {dst.live_count}/{dst.slots})")
    state = src.release_for_handoff(slot)
    dst.pool.transfer_slot(src.pool_key(slot), dst.pool_key(new_slot))
    dst.adopt_handoff(new_slot, state["blocks"], state["last_token"],
                      state["position"])
    packet = HandoffPacket(blocks=tuple(state["blocks"]),
                           position=state["position"],
                           last_token=state["last_token"],
                           src=src.cache_scope, dst=dst.cache_scope)
    return new_slot, packet


class DisaggregatedPair:
    """A prefill-role and a decode-role engine over one shared pool.

    Both `DecodeEngine`s are built over the same `BlockPool` and
    `CacheBox` with disjoint `pool_slot_base` ranges and the cache scopes
    'prefill' and 'decode'. `serve(prompts, max_new_tokens)` admits and
    prefills every prompt on the prefill engine, hands each finished
    prefill to the decode engine, then runs ONE [S, 1] decode loop over
    the handed-off slots; mixed lengths retire independently, and greedy
    output is token-exact against `generate()`.

    Args:
        model: the served port `TransformerLM`.
        prefill_slots / decode_slots: concurrency of each role.
        max_seq_len: per-request cap (defaults to the model's).
        block_size: the pool's block size.
        num_blocks: the shared pool's size; by default both engines'
            slots reserving full budgets at once (during a handoff a
            reservation exists on one side only, so the sum is the peak).
        kwargs: passed to both engines (device, kernel, kv_dtype,
            compile_cache, ...).
    """

    def __init__(self, model, *, prefill_slots: int = 2,
                 decode_slots: int = 4,
                 max_seq_len: tp.Optional[int] = None,
                 block_size: int = 16,
                 num_blocks: tp.Optional[int] = None,
                 prefix_cache: bool = True,
                 **kwargs: tp.Any):
        from ..engine import DecodeEngine
        from ..paged import BlockPool, CacheBox
        max_seq_len = min(max_seq_len or model.config.max_seq_len,
                          model.config.max_seq_len)
        if num_blocks is None:
            num_blocks = 1 + (prefill_slots + decode_slots) \
                * (max_seq_len // block_size)
        self.pool = BlockPool(num_blocks=num_blocks, block_size=block_size,
                              max_seq_len=max_seq_len,
                              prefix_cache=prefix_cache)
        self.cache_box = CacheBox()
        self.prefill = DecodeEngine(
            model, slots=prefill_slots, max_seq_len=max_seq_len,
            cache_layout="paged", block_size=block_size,
            num_blocks=num_blocks, cache_scope="prefill",
            pool=self.pool, cache_box=self.cache_box, pool_slot_base=0,
            prefix_cache=prefix_cache, **kwargs)
        self.decode = DecodeEngine(
            model, slots=decode_slots, max_seq_len=max_seq_len,
            cache_layout="paged", block_size=block_size,
            num_blocks=num_blocks, cache_scope="decode",
            pool=self.pool, cache_box=self.cache_box,
            pool_slot_base=prefill_slots,
            prefix_cache=prefix_cache, **kwargs)
        self.handoffs: tp.List[HandoffPacket] = []
        # host seconds of each `hand_off` call
        self.handoff_seconds: tp.List[float] = []

    def warmup(self, prompt_lengths: tp.Iterable[int] = ()) -> None:
        """Warm both engines (each under its own cache scope), then seal
        their compile caches: a cache the two share is sealed only after
        both warmed, so neither's warm-up counts as a recompile."""
        lengths = list(prompt_lengths)
        engines = (self.prefill, self.decode)
        for engine in engines:
            engine.warmup(prompt_lengths=lengths, seal=False)
        for cache in {id(e.compile_cache): e.compile_cache
                      for e in engines}.values():
            cache.seal()

    def serve(self, prompts: tp.Sequence[tp.Any], max_new_tokens: int,
              eos_token: tp.Optional[int] = None) -> tp.List[tp.List[int]]:
        """Run every prompt through prefill -> handoff -> decode; returns
        each request's generated tokens (prompt excluded), in order.
        Prompts go in waves of at most `decode_slots`, so mixed-length
        requests decode together (one [S, 1] step advances all of them;
        finished slots retire independently)."""
        results: tp.List[tp.List[int]] = [[] for _ in prompts]
        pending = list(range(len(prompts)))
        while pending:
            wave = pending[:self.decode.slots]
            pending = pending[len(wave):]
            live: tp.Dict[int, int] = {}  # decode slot -> request index
            budgets: tp.Dict[int, int] = {}
            for i in wave:
                prompt = np.asarray(prompts[i], np.int32)
                slot = self.prefill.acquire_slot()
                assert slot is not None, "wave exceeds prefill slots?"
                start = self.prefill.admit(slot, prompt, max_new_tokens)
                first: tp.Optional[int] = None
                while first is None:
                    start, first = self.prefill.prefill_chunk(
                        slot, prompt, start)
                results[i].append(first)
                if max_new_tokens == 1 or (eos_token is not None
                                           and first == eos_token):
                    self.prefill.retire(slot)
                    continue
                t0 = time.perf_counter()
                dslot, packet = hand_off(self.prefill, self.decode, slot)
                self.handoff_seconds.append(time.perf_counter() - t0)
                self.handoffs.append(packet)
                live[dslot] = i
                budgets[dslot] = max_new_tokens - 1
            while live:
                tokens = self.decode.decode()
                for dslot in list(live):
                    i = live[dslot]
                    token = int(tokens[dslot])
                    results[i].append(token)
                    budgets[dslot] -= 1
                    if budgets[dslot] <= 0 or (eos_token is not None
                                               and token == eos_token):
                        self.decode.retire(dslot)
                        del live[dslot], budgets[dslot]
        return results
