"""1F1B / interleaved pipeline schedule tables (host-side, numpy-only):
the port's copy of flashy_tpu/parallel/schedules.py.

GPipe's fill-drain keeps every microbatch's activations until the
backward (O(M) residency). The PipeDream-flush family built here holds
at most O(S) microbatches in flight per stage at the same bubble, and
interleaved virtual stages (v non-adjacent layer chunks a stage) divide
the bubble to (S-1)/(v*M + S-1). Packed 1F1B runs the steady state's
forward and backward in one tick: 2(vM+S-1) ticks become vM+(v+1)S-2.

A schedule is a set of numpy `[ticks, stages]` tables plus exact
bookkeeping (idle ticks, stash slots from interval coloring), so
`bubble_frac` and `peak_stash_bytes` are properties of the table. Every
table, statistic and error text equals the reference's; the port's
`parallel.pipeline` walks one column of the tables per rank (a process
on the 'pipe' axis), where the reference runs them as one SPMD program.
`dead_compute_stats` is the reference's FLOP-priced lane accounting
(`flashy_tpu/analysis/trace/dead_compute.py`), kept here for the bench.
"""
import dataclasses
import functools
import math
import typing as tp

import numpy as np

# Work item kinds in the per-device timeline.
FORWARD = "F"
BACKWARD = "B"

# Schedule spellings the validators and surfaces accept — the single
# source of truth (models.pipelined.SCHEDULES and the example solver
# both alias it).
KNOWN_SCHEDULES = ("gpipe", "1f1b", "packed_1f1b")

# The packed+forward rejection, shared verbatim by every surface that
# raises it (validate_pipeline_args, pipeline_1f1b, pipelined_apply
# spells its own variant with its alternatives).
PACKED_FORWARD_ERROR = (
    "schedule='packed_1f1b' has no forward-only spelling: packing "
    "pairs each steady-state forward with a backward in the same "
    "tick, which is meaningless without a backward lane. Use "
    "schedule='1f1b' for pipelined forwards/inference.")


def ring_perms(num_stages: int) -> tp.Tuple[tp.List[tp.Tuple[int, int]],
                                            tp.List[tp.Tuple[int, int]]]:
    """(forward, backward) permutations of the pipeline ring.

    Activations hop +1 (stage i -> i+1 mod S), cotangents hop -1; the
    last stage sends to stage 0 under interleave (the ring wraps). The
    port's ranks send along exactly these pairs (`parallel.pipeline`).
    """
    fwd = [(i, (i + 1) % num_stages) for i in range(num_stages)]
    bwd = [(i, (i - 1) % num_stages) for i in range(num_stages)]
    return fwd, bwd


def bubble_fraction(num_stages: int, num_micro: int,
                    interleave: int = 1) -> float:
    """Ideal bubble fraction of the 1F1B family: (S-1)/(v*M + S-1).

    With equal-cost forward/backward ticks each device idles 2(S-1)
    chunk-ticks of a 2(v*M + S-1)-tick step; `interleave=1` reduces to
    the GPipe fraction (1F1B trades memory, interleaving trades bubble).
    The generated schedules achieve this exactly — tests compare it
    against idle ticks counted from the tables.
    """
    return (num_stages - 1) / (interleave * num_micro + num_stages - 1)


def packed_ticks(num_stages: int, num_micro: int, interleave: int = 1,
                 overlap: bool = False) -> int:
    """Closed-form tick count of the packed 1F1B schedule.

    Packing co-schedules the steady state's one-forward-one-backward
    pair into a single tick (the SPMD body pays both lanes every tick
    anyway), so the step shrinks from the unpacked `2(vM + S - 1)`
    ticks to `vM + (v+1)S - 2`: the `vM` steady ticks advance one
    microbatch each, and the fill/drain overhead is the forward chain
    (`S-1` hops) plus the backward chain (`vS-1` hops) that bracket it.
    At `interleave=1` this is the `M + 2(S-1)` of the classic packed
    timeline. `overlap=True` (interleave=1 only) adds one tick of ring
    latency per hop so the `ppermute` can run under the stage compute:
    `M + 4(S-1)` — still below unpacked whenever `M > 2(S-1)`. Tests
    pin these against ticks counted from the generated tables.
    """
    S, M, v = num_stages, num_micro, interleave
    if overlap:
        if v != 1:
            raise ValueError(
                "packed overlap is interleave=1 only (the doubled hop "
                "latency exceeds the S-tick chunk group, see "
                "build_1f1b_schedule)")
        return M + 4 * (S - 1)
    return v * M + (v + 1) * S - 2


def packed_bubble_fraction(num_stages: int, num_micro: int,
                           interleave: int = 1,
                           overlap: bool = False) -> float:
    """Idle-LANE fraction of the packed schedule: `1 - vM/T`.

    Packed accounting is per lane (each tick has a forward and a
    backward lane, both paid), so the useful fraction is `2vM` busy
    lane-slots of the `2T` the device executes. This is the honest
    wall-clock number: unlike the unpacked schedule-theoretic
    `bubble_frac` (one work item per tick), a packed tick at fraction
    `f` wastes `f` of the compute it actually pays for.
    """
    return 1.0 - (interleave * num_micro) / packed_ticks(
        num_stages, num_micro, interleave, overlap)


def gpipe_bubble_fraction(num_stages: int, num_micro: int) -> float:
    """GPipe fill-drain bubble fraction (S-1)/(M+S-1) — the baseline."""
    return (num_stages - 1) / (num_micro + num_stages - 1)


def microbatch_bytes(microbatch_shape: tp.Sequence[int],
                     dtype_size: int = 4) -> int:
    """Bytes of one microbatch activation `[mb, ...]` at `dtype_size`."""
    return int(math.prod(microbatch_shape)) * int(dtype_size)


def gpipe_stash_bytes(num_stages: int, num_micro: int,
                      microbatch_shape: tp.Sequence[int],
                      dtype_size: int = 4) -> int:
    """Lower bound on GPipe's live-activation residency per device.

    Differentiating the fill-drain scan stashes at least the per-tick
    carry (one microbatch activation) for every one of the M+S-1
    forward ticks — the O(M) term the 1F1B stash ring removes. Real
    residency is higher (per-layer residuals inside each stage); this
    bound is what the demo compares against `PipelineSchedule`'s exact
    allocation, so GPipe is flattered, not strawmanned.
    """
    return (num_micro + num_stages - 1) * microbatch_bytes(
        microbatch_shape, dtype_size)


def validate_pipeline_args(num_stages: int, num_micro: int, batch: int,
                           interleave: int = 1,
                           require_fill: bool = False,
                           schedule: str = "1f1b",
                           mode: str = "train") -> None:
    """Validate the (S, M, B, v) combination with actionable messages.

    `require_fill=True` adds the 1F1B constraints: M >= S (the steady
    state needs a full fill of in-flight microbatches) and, for
    interleave > 1, M divisible by S (chunk rotation walks microbatch
    groups of size S). `schedule='packed_1f1b'` shares every 1F1B
    constraint but additionally rejects `mode='forward'`: packing
    co-schedules each forward tick with a backward, so a forward-only
    packed schedule has nothing to pack.
    """
    if schedule not in KNOWN_SCHEDULES:
        raise ValueError(f"schedule must be one of {KNOWN_SCHEDULES}, "
                         f"got {schedule!r}")
    if schedule == "packed_1f1b" and mode == "forward":
        raise ValueError(PACKED_FORWARD_ERROR)
    if num_micro < 1:
        raise ValueError(f"num_microbatches must be >= 1, got {num_micro}")
    if interleave < 1:
        raise ValueError(f"interleave must be >= 1, got {interleave}")
    if batch % num_micro:
        divisors = [m for m in range(1, batch + 1) if batch % m == 0]
        raise ValueError(
            f"batch {batch} is not divisible into {num_micro} microbatches; "
            f"pick num_microbatches from the divisors of the batch "
            f"(e.g. {divisors[-min(len(divisors), 6):]}) or pad the batch.")
    if interleave > 1 and num_micro % num_stages:
        # the chunk rotation walks microbatch groups of size S in BOTH
        # modes (the forward order uses the same item formula)
        raise ValueError(
            f"interleaved 1F1B rotates virtual-stage chunks over "
            f"microbatch groups of size S={num_stages}, so "
            f"num_microbatches must be a multiple of S: got "
            f"M={num_micro}. Use M in "
            f"{[num_stages * k for k in range(1, 5)]}, or "
            f"interleave=1.")
    if require_fill and num_micro < num_stages:
        raise ValueError(
            f"1F1B needs num_microbatches >= num_stages (the steady "
            f"state holds one in-flight microbatch per stage): got "
            f"M={num_micro} < S={num_stages}. Raise num_microbatches "
            f"to at least {num_stages}, or fall back to "
            f"schedule='gpipe' for tiny batches.")


@dataclasses.dataclass(frozen=True)
class PipelineSchedule:
    """A fully-resolved pipeline schedule: per-(tick, device) tables.

    All tables are int32 `[num_ticks, num_stages]` numpy arrays, meant
    to be fed into the jitted pipeline program as inputs (values are
    data; only `num_ticks` and the buffer depths shape the program).
    Forward fields: `f_do` (1 when the device runs a forward this
    tick), `f_chunk` (local virtual-stage index, 0..interleave-1),
    `f_micro`, `f_slot` (activation-stash slot holding the input),
    `f_from_x` (stage 0 of chunk 0: read the microbatched input
    directly), `f_last` (global last chunk: the loss attaches here);
    `rxf_do`/`rxf_slot` bank the activation arriving over `ppermute`
    into the stash. Backward fields (`mode='train'` only) mirror them:
    `b_do`, `b_chunk`, `b_micro`, `b_slot` (stashed input for the
    recompute-VJP), `b_last`, `b_first`, `b_rx` (cotangent slot) and
    `rxb_do`/`rxb_slot`.

    `stash_depth`/`brx_depth` are exact interval-coloring results: the
    smallest ring buffers that hold every live activation/cotangent.
    For 1F1B at interleave=1 the stash depth is exactly S — the O(S)
    memory claim, checked by tests rather than asserted in prose.

    `packed=True` marks the co-scheduled timeline: steady-state ticks
    carry one forward AND one backward item for the same device, so
    `idle_ticks` counts idle LANE-slots (each tick has two lanes, both
    paid by the SPMD body) and `bubble_frac` divides by `2*T`.
    `hop_latency=2` is the comm-overlap variant: consumers wait one
    extra tick so a hop issued at the top of tick t (from tick t-1's
    banked output) can run under tick t's stage compute; the jitted
    body must then bank arrivals AFTER the compute (late banking), and
    this field is what tells it to.
    """
    mode: str                    # 'train' | 'forward'
    num_stages: int
    num_micro: int
    interleave: int
    num_ticks: int
    tables: tp.Mapping[str, np.ndarray]
    stash_depth: int
    brx_depth: int
    idle_ticks: tp.Tuple[int, ...]   # per device; lane-slots when packed
    packed: bool = False
    hop_latency: int = 1

    @property
    def num_chunks(self) -> int:
        return self.num_stages * self.interleave

    @property
    def lanes(self) -> int:
        """Work lanes per tick in the idle accounting: packed ticks
        carry an F and a B lane; unpacked accounting stays the classic
        one-work-item-per-tick (schedule-theoretic) convention."""
        return 2 if self.packed else 1

    @property
    def bubble_frac(self) -> float:
        """Idle fraction counted from the tables (not the formula)."""
        return sum(self.idle_ticks) / (
            self.lanes * self.num_stages * self.num_ticks)

    @property
    def idle_ticks_per_device(self) -> float:
        return sum(self.idle_ticks) / self.num_stages

    def stash_bytes(self, microbatch_shape: tp.Sequence[int],
                    dtype_size: int = 4) -> int:
        """Exact schedule-buffer bytes per device: the activation stash
        ring, the cotangent ring, their sentinel rows, and the two
        in-flight `ppermute` messages. Flat in M at fixed (S, v)."""
        per = microbatch_bytes(microbatch_shape, dtype_size)
        rings = (self.stash_depth + 1) + (self.brx_depth + 1 if
                                          self.mode == "train" else 0)
        messages = 2 if self.mode == "train" else 1
        return (rings + messages) * per

    def stats(self, microbatch_shape: tp.Optional[tp.Sequence[int]] = None,
              dtype_size: int = 4) -> tp.Dict[str, tp.Any]:
        """One-stop summary for metrics/bench/demo reporting."""
        base = "packed_1f1b" if self.packed else "1f1b"
        out: tp.Dict[str, tp.Any] = {
            "schedule": base if self.interleave == 1 else
                        f"{base}-interleave{self.interleave}",
            "num_stages": self.num_stages,
            "num_micro": self.num_micro,
            "interleave": self.interleave,
            "num_ticks": self.num_ticks,
            "bubble_frac": round(self.bubble_frac, 6),
            "idle_ticks_per_device": self.idle_ticks_per_device,
            "stash_depth": self.stash_depth,
            "gpipe_bubble_frac": round(gpipe_bubble_fraction(
                self.num_stages, self.num_micro), 6),
        }
        if self.packed:
            out["hop_latency"] = self.hop_latency
            out["overlap"] = self.hop_latency > 1
            # the wall-clock claim packing makes: ticks vs the unpacked
            # schedule at equal (S, M, v) — per-tick cost is ~constant
            # (the SPMD body always executes both lanes)
            out["tick_ratio_vs_unpacked"] = round(
                self.num_ticks / (2 * (self.interleave * self.num_micro
                                       + self.num_stages - 1)), 6)
        if microbatch_shape is not None:
            out["peak_stash_bytes"] = self.stash_bytes(
                microbatch_shape, dtype_size)
            out["gpipe_stash_bytes"] = gpipe_stash_bytes(
                self.num_stages, self.num_micro, microbatch_shape,
                dtype_size)
        return out


def _device_orders(num_stages: int, num_micro: int, interleave: int,
                   mode: str) -> tp.List[tp.List[tp.Tuple[str, int, int]]]:
    """Megatron-ordered work lists per device: `(kind, chunk, micro)`
    with `chunk` the LOCAL virtual-stage index.

    Forwards walk microbatch groups of size S through the device's
    chunks in rotation; backwards mirror it from the last chunk.
    Warmup depth (S-d-1 plain, (S-d-1)*2 + (v-1)*S interleaved) is the
    PipeDream-flush fill that bounds in-flight microbatches at O(S).
    """
    S, M, v = num_stages, num_micro, interleave
    total = M * v

    def fwd_item(i: int) -> tp.Tuple[str, int, int]:
        if v == 1:
            return (FORWARD, 0, i)
        group = i // S
        return (FORWARD, group % v, (group // v) * S + i % S)

    def bwd_item(j: int) -> tp.Tuple[str, int, int]:
        if v == 1:
            return (BACKWARD, 0, j)
        group = j // S
        return (BACKWARD, v - 1 - (group % v), (group // v) * S + j % S)

    orders = []
    for d in range(S):
        if mode == "forward":
            orders.append([fwd_item(i) for i in range(total)])
            continue
        if v == 1:
            warm = min(total, S - d - 1)
        else:
            warm = min(total, (S - d - 1) * 2 + (v - 1) * S)
        items = [fwd_item(i) for i in range(warm)]
        nf, nb = warm, 0
        while nf < total or nb < total:
            if nf < total:
                items.append(fwd_item(nf))
                nf += 1
            if nb < total:
                items.append(bwd_item(nb))
                nb += 1
        orders.append(items)
    return orders


def _simulate(num_stages: int, orders, num_chunks: int
              ) -> tp.Tuple[tp.Dict[tp.Tuple[str, int, int], int], int]:
    """Tick-accurate execution of the per-device work lists.

    Each device runs its items strictly in order, one per tick, and
    stalls when the item's producer has not completed by the *previous*
    tick (`ppermute` delivers with one tick of latency). In-order
    execution over a dependency DAG cannot deadlock; the budget check
    turns a schedule-generator bug into a loud error instead of a spin.
    """
    S, C = num_stages, num_chunks
    ptr = [0] * S
    done: tp.Dict[tp.Tuple[str, int, int], int] = {}
    budget = 8 * sum(len(o) for o in orders) + 64
    t = 0
    while any(ptr[d] < len(orders[d]) for d in range(S)):
        if t > budget:
            raise RuntimeError(
                f"pipeline schedule simulation exceeded {budget} ticks — "
                f"a generator bug produced an unsatisfiable order")
        for d in range(S):
            if ptr[d] >= len(orders[d]):
                continue
            kind, k, m = orders[d][ptr[d]]
            c = k * S + d  # global chunk index
            if kind == FORWARD:
                ready = c == 0 or done.get((FORWARD, c - 1, m), t + 1) < t
            elif c == C - 1:
                ready = done.get((FORWARD, c, m), t + 1) < t
            else:
                ready = done.get((BACKWARD, c + 1, m), t + 1) < t
            if ready:
                done[(kind, c, m)] = t
                ptr[d] += 1
        t += 1
    return done, t


def _simulate_packed(num_stages: int, orders, num_chunks: int,
                     hop_latency: int
                     ) -> tp.Tuple[tp.Dict[tp.Tuple[str, int, int], int], int]:
    """Tick-accurate execution of the packed (co-scheduled) timeline.

    The per-kind projections of the Megatron order become two
    independent lanes per device; each tick a device runs the next
    forward AND the next backward whose producers are satisfied, so the
    steady state packs the 1F1B pair into one tick. Cross-device
    producers must be done by `t - hop_latency` (`ppermute` delivery;
    2 in overlap mode so the hop can hide under the consumer tick's
    compute). The last chunk's backward depends on its own forward on
    the SAME device, which the jitted body runs earlier in the same
    tick — that dep is satisfied at `t` itself, which is what lets the
    last stage run F(m) and B(m) together. Lanes run strictly in their
    kind's order, so the f32 accumulation sequence per chunk is
    IDENTICAL to the unpacked schedule — the bit-identical-gradients
    guarantee is an ordering fact, not a numerics hope.
    """
    S, C, L = num_stages, num_chunks, hop_latency
    lanes = {
        FORWARD: [[it for it in o if it[0] == FORWARD] for o in orders],
        BACKWARD: [[it for it in o if it[0] == BACKWARD] for o in orders],
    }
    ptr = {FORWARD: [0] * S, BACKWARD: [0] * S}
    done: tp.Dict[tp.Tuple[str, int, int], int] = {}
    never = 1 << 30
    budget = 8 * sum(len(o) for o in orders) + 64
    t = 0
    while any(ptr[kind][d] < len(lanes[kind][d])
              for kind in (FORWARD, BACKWARD) for d in range(S)):
        if t > budget:
            raise RuntimeError(
                f"packed pipeline schedule simulation exceeded {budget} "
                f"ticks — a generator bug produced an unsatisfiable order")
        # Forward lane first: the body computes F before B within a
        # tick, so a same-tick F(C-1, m) satisfies B(C-1, m) below.
        for d in range(S):
            if ptr[FORWARD][d] >= len(lanes[FORWARD][d]):
                continue
            _, k, m = lanes[FORWARD][d][ptr[FORWARD][d]]
            c = k * S + d
            if c == 0 or done.get((FORWARD, c - 1, m), never) <= t - L:
                done[(FORWARD, c, m)] = t
                ptr[FORWARD][d] += 1
        for d in range(S):
            if ptr[BACKWARD][d] >= len(lanes[BACKWARD][d]):
                continue
            _, k, m = lanes[BACKWARD][d][ptr[BACKWARD][d]]
            c = k * S + d
            if c == C - 1:
                ready = done.get((FORWARD, c, m), never) <= t
            else:
                ready = done.get((BACKWARD, c + 1, m), never) <= t - L
            if ready:
                done[(BACKWARD, c, m)] = t
                ptr[BACKWARD][d] += 1
        t += 1
    return done, t


def _allocate_slots(intervals: tp.Sequence[tp.Tuple[tp.Any, int, int]]
                    ) -> tp.Tuple[tp.Dict[tp.Any, int], int]:
    """Greedy interval coloring: `(key, start, end)` inclusive ranges to
    ring-buffer slots such that no two live ranges share a slot. Returns
    `(key -> slot, depth)`. Inclusive non-overlap means a slot written
    and a slot read at the same tick are never the same, so the jitted
    tick body may bank arrivals and read stashes in any order."""
    slots: tp.Dict[tp.Any, int] = {}
    free_at: tp.List[int] = []  # per slot, last tick it is still live
    for key, start, end in sorted(intervals, key=lambda it: (it[1], it[2])):
        for idx, last in enumerate(free_at):
            if last < start:
                free_at[idx] = end
                slots[key] = idx
                break
        else:
            slots[key] = len(free_at)
            free_at.append(end)
    return slots, len(free_at)


@functools.lru_cache(maxsize=32)
def build_1f1b_schedule(num_stages: int, num_micro: int,
                        interleave: int = 1,
                        mode: str = "train",
                        packed: bool = False,
                        overlap: bool = False) -> PipelineSchedule:
    """Build (and cache) the full table set for a 1F1B schedule.

    `mode='train'` is the one-forward-one-backward schedule;
    `mode='forward'` is the forward half only (inference through the
    same interleaved chunk placement). `packed=True` co-schedules the
    steady state's F and B into one tick (train only — the tables gain
    ticks with `f_do` and `b_do` both set, which the always-both-lanes
    SPMD body turns into useful work in both lanes), shrinking the step
    from `2(vM+S-1)` to `packed_ticks(S, M, v)` ticks. `overlap=True`
    (packed, interleave=1 only) builds the schedule at hop latency 2 so
    the jitted body can issue each tick's `ppermute` from the previous
    tick's banked output and hide the hop under the stage compute; at
    interleave > 1 the doubled latency exceeds the S-tick chunk group
    and the round-trip would stall below the UNPACKED rate, so it is
    rejected rather than silently slower. Deterministic in its
    arguments, so the lru_cache can never serve a stale schedule.
    """
    if mode not in ("train", "forward"):
        raise ValueError(f"mode must be 'train' or 'forward', got {mode!r}")
    if overlap and not packed:
        raise ValueError("overlap=True is a packed-schedule feature "
                         "(the unpacked tables stay at hop latency 1); "
                         "pass packed=True as well")
    if overlap and interleave > 1:
        raise ValueError(
            f"packed overlap (hop latency 2) supports interleave=1 only: "
            f"at interleave={interleave} the hop round-trip of a "
            f"virtual-stage wrap (2*S ticks) exceeds the S-tick chunk "
            f"group, so the overlapped schedule would run BELOW the "
            f"unpacked rate. Use overlap=False, or interleave=1.")
    S, M, v = num_stages, num_micro, interleave
    C = S * v
    # forward-only orders are plain sequential fills — no steady-state
    # 1F1B alternation, so M < S is legal there (small-batch inference)
    validate_pipeline_args(S, M, batch=M, interleave=v,
                           require_fill=(mode == "train" or packed),
                           schedule="packed_1f1b" if packed else "1f1b",
                           mode=mode)
    hop_latency = 2 if overlap else 1
    orders = _device_orders(S, M, v, mode)
    if packed:
        done, T = _simulate_packed(S, orders, C, hop_latency)
    else:
        done, T = _simulate(S, orders, C)

    fields = ["f_do", "f_chunk", "f_micro", "f_slot", "f_from_x", "f_last",
              "rxf_do", "rxf_slot"]
    if mode == "train":
        fields += ["b_do", "b_chunk", "b_micro", "b_slot", "b_last",
                   "b_first", "b_rx", "rxb_do", "rxb_slot"]
    tables = {name: np.zeros((T, S), np.int32) for name in fields}

    stash_depth = 0
    brx_depth = 0
    for d in range(S):
        act_intervals = []
        brx_intervals = []
        for k in range(v):
            c = k * S + d
            for m in range(M):
                t_f = done[(FORWARD, c, m)]
                start = t_f if c == 0 else done[(FORWARD, c - 1, m)] + 1
                end = done[(BACKWARD, c, m)] if mode == "train" else t_f
                act_intervals.append(((c, m), start, end))
                if mode == "train" and c != C - 1:
                    brx_intervals.append(
                        ((c, m), done[(BACKWARD, c + 1, m)] + 1,
                         done[(BACKWARD, c, m)]))
        act_slots, depth = _allocate_slots(act_intervals)
        stash_depth = max(stash_depth, depth)
        brx_slots, depth = _allocate_slots(brx_intervals)
        brx_depth = max(brx_depth, depth)

        for k in range(v):
            c = k * S + d
            for m in range(M):
                t_f = done[(FORWARD, c, m)]
                slot = act_slots[(c, m)]
                tables["f_do"][t_f, d] = 1
                tables["f_chunk"][t_f, d] = k
                tables["f_micro"][t_f, d] = m
                tables["f_slot"][t_f, d] = slot
                tables["f_last"][t_f, d] = int(c == C - 1)
                if c == 0:
                    tables["f_from_x"][t_f, d] = 1
                else:
                    arrive = done[(FORWARD, c - 1, m)] + 1
                    tables["rxf_do"][arrive, d] = 1
                    tables["rxf_slot"][arrive, d] = slot
                if mode != "train":
                    continue
                t_b = done[(BACKWARD, c, m)]
                tables["b_do"][t_b, d] = 1
                tables["b_chunk"][t_b, d] = k
                tables["b_micro"][t_b, d] = m
                tables["b_slot"][t_b, d] = slot
                tables["b_last"][t_b, d] = int(c == C - 1)
                tables["b_first"][t_b, d] = int(c == 0)
                if c != C - 1:
                    tables["b_rx"][t_b, d] = brx_slots[(c, m)]
                    arrive = done[(BACKWARD, c + 1, m)] + 1
                    tables["rxb_do"][arrive, d] = 1
                    tables["rxb_slot"][arrive, d] = brx_slots[(c, m)]

    if packed:
        # lane accounting: each tick has an F and a B lane, both paid
        busy = tables["f_do"].sum(axis=0) + tables["b_do"].sum(axis=0)
        idle = tuple(int(2 * T - b) for b in busy)
    else:
        busy = tables["f_do"].sum(axis=0)
        if mode == "train":
            busy = busy + tables["b_do"].sum(axis=0)
        idle = tuple(int(T - b) for b in busy)
    for name, table in tables.items():
        table.setflags(write=False)
    return PipelineSchedule(
        mode=mode, num_stages=S, num_micro=M, interleave=v, num_ticks=T,
        tables=tables, stash_depth=int(stash_depth), brx_depth=int(brx_depth),
        idle_ticks=idle, packed=packed, hop_latency=hop_latency)


def schedule_stats(num_stages: int, num_micro: int, interleave: int = 1, *,
                   mode: str = "train", packed: bool = False,
                   overlap: bool = False,
                   microbatch_shape: tp.Optional[tp.Sequence[int]] = None,
                   dtype_size: int = 4) -> tp.Dict[str, tp.Any]:
    """Stats of the (cached) schedule — the host-side numbers the stage
    metrics, the `pipeline/bubble` tracer track, the demo gates and the
    bench leg all report. Degenerate single-stage pipelines have no
    schedule (and no bubble)."""
    if num_stages <= 1:
        out: tp.Dict[str, tp.Any] = {
            "schedule": "single-stage", "num_stages": 1,
            "num_micro": num_micro, "interleave": 1, "num_ticks": num_micro,
            "bubble_frac": 0.0, "idle_ticks_per_device": 0.0,
            "stash_depth": 0, "gpipe_bubble_frac": 0.0}
        if microbatch_shape is not None:
            out["peak_stash_bytes"] = 0
            out["gpipe_stash_bytes"] = 0
        return out
    schedule = build_1f1b_schedule(num_stages, num_micro, interleave, mode,
                                   packed=packed, overlap=overlap)
    return schedule.stats(microbatch_shape, dtype_size)


# FLOP weights of a forward and a backward lane (the backward's two
# products against the forward's one)
DEFAULT_LANE_COSTS = (1.0, 2.0)


def dead_compute_stats(schedule: PipelineSchedule,
                       lane_costs: tp.Tuple[float, float] = DEFAULT_LANE_COSTS
                       ) -> tp.Dict[str, float]:
    """FLOP-weighted lane accounting of one `PipelineSchedule`: the
    reference's SPMD body pays `f_cost + b_cost` on every stage every
    tick (masked lanes compute on zeros), forward-only bodies `f_cost`.
    Returns `paid_flops`, `useful_flops`, `dead_frac` (1 - useful /
    paid), `useful_frac` and `per_tick_cost`. The port's ranks skip an
    idle lane, so this prices the schedule, not the port's compute."""
    f_cost, b_cost = (float(c) for c in lane_costs)
    S, T = schedule.num_stages, schedule.num_ticks
    train = schedule.mode == "train"
    f_busy = float(np.asarray(schedule.tables["f_do"]).sum())
    b_busy = float(np.asarray(schedule.tables["b_do"]).sum()) if train \
        else 0.0
    per_tick = f_cost + (b_cost if train else 0.0)
    paid = S * T * per_tick
    useful = f_busy * f_cost + b_busy * b_cost
    return {
        "paid_flops": paid,
        "useful_flops": useful,
        "dead_frac": 1.0 - useful / paid if paid else 0.0,
        "useful_frac": useful / paid if paid else 1.0,
        "per_tick_cost": per_tick,
    }
