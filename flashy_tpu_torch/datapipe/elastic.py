"""resplit_*_states: re-partition per-rank datapipe cursors N -> M (the
port of flashy_tpu/datapipe/elastic.py).

A cursor is saved per rank: rank r of world N owns `files[r::N]` and its
state describes positions in those files. When the world size changes,
the new world M partitions the same global file list differently, so a
resume needs the cursors of all old ranks merged and re-dealt:
`resplit_states([rank states], M)`. The guarantee is per-file prefix
exactness: every file resumes at the exact document its consumed prefix
ends at, so no token is consumed twice and none is skipped. When
consumption was balanced (the lockstep training regime) the re-split
continues the canonical global stream bit-identically. Pure host code;
the multi-process elastic drill waits for ROADMAP.md queue A item 8e
(processes, collectives and state across ranks are ported: items 5 and
8a).
"""
import typing as tp

logger = None  # set lazily; this module must stay import-light


def _log():
    global logger
    if logger is None:
        import logging
        logger = logging.getLogger(__name__)
    return logger


def _resplit_fault_point(num_shards: int, states: tp.Sequence[tp.Any]) -> None:
    from ..resilience import chaos
    chaos.fault_point("datapipe.resplit", old_world=len(states),
                      new_world=num_shards)


def resplit_stream_states(states: tp.Sequence[tp.Mapping[str, tp.Any]],
                          num_shards: int
                          ) -> tp.List[tp.Dict[str, tp.Any]]:
    """Re-partition N per-rank `ShardedTextStream` cursors into M.

    `states` must be the state_dicts of EVERY rank of the old world
    (any order); validation mirrors the name/weight checks of ordinary
    resume — all states must cover the same global file list exactly
    once (shards 0..N-1 of the same N), and agree on `passes` (ranks of
    a looping stream mid-pass at different pass counts have no exact
    merged position; resume from a commit where consumption was
    balanced, or use non-looping streams). Returns M state_dicts, one
    per new rank, loadable by a stream built with
    ``shard_index=r, num_shards=M`` over the same shard files.
    """
    if not states:
        raise ValueError("resplit_stream_states needs at least one state")
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    for state in states:
        if state.get("file_cursors") is None \
                or state.get("global_file_names") is None:
            raise ValueError(
                "a cursor predates elastic checkpoints (no per-file cursor "
                "map / global file list); it cannot be re-split "
                "token-exactly.")
    global_files = list(states[0]["global_file_names"])
    old_world = int(states[0].get("num_shards", 1))
    seen_shards = sorted(int(s.get("shard_index", 0)) for s in states)
    if seen_shards != list(range(old_world)) or len(states) != old_world:
        raise ValueError(
            f"re-split needs every rank of the old world exactly once: "
            f"expected shards 0..{old_world - 1}, got {seen_shards}.")
    passes = {int(s["passes"]) for s in states}
    if len(passes) != 1:
        raise ValueError(
            f"ranks disagree on the loop pass count ({sorted(passes)}); a "
            "mid-pass looping stream has no exact merged position across "
            "unequal passes — resume from a balanced commit boundary.")
    cursor_map: tp.Dict[str, int] = {}
    for state in states:
        if list(state["global_file_names"]) != global_files:
            raise ValueError(
                "ranks name different global shard lists "
                f"({state['global_file_names']} vs {global_files}); "
                "re-splitting a mixed corpus cannot be token-exact.")
        for name, cursor in state["file_cursors"].items():
            name = str(name)
            if name in cursor_map:
                raise ValueError(
                    f"file {name!r} appears in more than one rank's cursor "
                    "map; overlapping ownership has no single true "
                    "position and cannot resume token-exactly.")
            cursor_map[name] = int(cursor)
    missing = [name for name in global_files if name not in cursor_map]
    if missing:
        raise ValueError(f"merged cursors cover no position for {missing}; "
                         "every global shard file needs exactly one owner.")
    _resplit_fault_point(num_shards, states)
    passes_value = passes.pop()
    out: tp.List[tp.Dict[str, tp.Any]] = []
    for rank in range(num_shards):
        names = global_files[rank::num_shards]
        cursors = [cursor_map[name] for name in names]
        # the next file in the canonical (global round-robin) order is
        # the least-consumed one, lowest global index first
        rr = min(range(len(names)), key=lambda i: (cursors[i], i)) \
            if names else 0
        out.append({
            "cursors": cursors, "rr": rr, "passes": passes_value,
            "num_files": len(names), "file_names": list(names),
            "shard_index": rank, "num_shards": num_shards,
            "global_file_names": list(global_files),
            "file_cursors": {name: cursor_map[name] for name in names},
        })
    _log().info("re-split %d stream cursor(s) over %d global files into "
                "%d", len(states), len(global_files), num_shards)
    return out


def resplit_mixture_states(states: tp.Sequence[tp.Mapping[str, tp.Any]],
                           num_shards: int
                           ) -> tp.List[tp.Dict[str, tp.Any]]:
    """Re-partition N per-rank `MixtureStream` cursors into M.

    The mixture's draw schedule is per-rank and counter-keyed (draw k
    of every rank uses the same `(seed, k)` fold-in), so a merged
    position exists exactly when the ranks consumed in lockstep: all
    states must agree on seed, weights AND the draw counter (the same
    balanced-boundary requirement `resplit_stream_states` puts on loop
    passes). Each source is re-split position-wise via
    `resplit_states`; a source counts as alive if ANY old rank still
    had documents in its shard (exhaustion is re-detected lazily).
    """
    if not states:
        raise ValueError("resplit_mixture_states needs at least one state")
    import numpy as np
    first = states[0]
    for state in states[1:]:
        if state.get("seed") != first.get("seed") or not np.allclose(
                state.get("weights", ()), first.get("weights", ())):
            raise ValueError(
                "ranks disagree on the mixture config (seed "
                f"{state.get('seed')} / weights {state.get('weights')} vs "
                f"{first.get('seed')} / {first.get('weights')}); "
                "re-splitting a changed mixture cannot be token-exact.")
        if len(state["sources"]) != len(first["sources"]):
            raise ValueError(
                f"ranks disagree on the source count "
                f"({len(state['sources'])} vs {len(first['sources'])}).")
    draws = {int(s["draws"]) for s in states}
    if len(draws) != 1:
        raise ValueError(
            f"ranks disagree on the mixture draw counter ({sorted(draws)}); "
            "the counter-keyed schedule only has an exact merged position "
            "at a lockstep boundary — resume from a balanced commit.")
    num_sources = len(first["sources"])
    draws_value = draws.pop()
    per_source = [
        resplit_states([state["sources"][i] for state in states], num_shards)
        for i in range(num_sources)]
    alive = [any(bool(state["alive"][i]) for state in states)
             for i in range(num_sources)]
    return [{
        "draws": draws_value, "alive": list(alive),
        "seed": first.get("seed"),
        "weights": list(first.get("weights", ())),
        "sources": [per_source[i][rank] for i in range(num_sources)],
    } for rank in range(num_shards)]


def resplit_prefetch_states(states: tp.Sequence[tp.Mapping[str, tp.Any]],
                            num_shards: int
                            ) -> tp.List[tp.Dict[str, tp.Any]]:
    """Re-partition N `PrefetchIterator` cursors: a prefetch cursor IS
    its source's consumed-position cursor, so re-split delegates."""
    inner = resplit_states([state["source"] for state in states], num_shards)
    return [{"source": state} for state in inner]


def _packer_buffers_empty(state: tp.Mapping[str, tp.Any]) -> bool:
    row = state.get("row", ((), (), ()))
    return not state.get("ready") and not any(row)


def resplit_packer_states(states: tp.Sequence[tp.Mapping[str, tp.Any]],
                          num_shards: int
                          ) -> tp.List[tp.Dict[str, tp.Any]]:
    """Re-partition N `SequencePacker` cursors — only at a packer-empty
    boundary. Partially packed rows are rank-local token buffers; there
    is no exact way to re-deal tokens already drawn from the old
    sharding, so a non-empty buffer raises instead of silently dropping
    or duplicating tokens."""
    blocked = [i for i, state in enumerate(states)
               if not _packer_buffers_empty(state)]
    if blocked:
        raise ValueError(
            f"rank(s) {blocked} checkpointed partially packed rows; "
            "buffered tokens are rank-local and cannot be re-split "
            "token-exactly — commit at a packer-empty boundary (or "
            "re-split the stage below the packer).")
    inner = resplit_states([state["source"] for state in states], num_shards)
    return [{"source": state, "ready": [], "row": ([], [], []),
             "seg": 0, "exhausted": False} for state in inner]


def resplit_states(states: tp.Sequence[tp.Mapping[str, tp.Any]],
                   num_shards: int) -> tp.List[tp.Dict[str, tp.Any]]:
    """Re-partition N per-rank datapipe cursors into M, dispatching on
    the cursor shape (prefetch / mixture / packer / stream — the four
    `flashy_tpu_torch.datapipe` stage kinds)."""
    if not states:
        raise ValueError("resplit_states needs at least one state")
    first = states[0]
    if set(first) == {"source"}:
        return resplit_prefetch_states(states, num_shards)
    if "draws" in first and "sources" in first:
        return resplit_mixture_states(states, num_shards)
    if "ready" in first and "row" in first:
        return resplit_packer_states(states, num_shards)
    if "cursors" in first or "file_cursors" in first:
        return resplit_stream_states(states, num_shards)
    raise ValueError(
        f"unrecognized datapipe cursor shape (keys {sorted(first)}); "
        "resplit_states understands stream / mixture / packer / prefetch "
        "cursors.")


class ElasticCursorGroup:
    """A bundle of per-worker datapipes checkpointed as ONE stateful
    unit whose world size may change between save and restore.

    Built with one pipeline per (virtual or real local) worker,
    `state_dict()` records every worker's cursor plus the world size;
    `load_state_dict()` either restores positionally (same world) or
    re-splits the merged cursors onto the new world via
    `resplit_states` — the single-process emulation of fleet churn, and
    the construct the elastic chaos drill trains through. Iterating the
    group yields one item per worker (a "world step" view).
    """

    def __init__(self, pipes: tp.Sequence[tp.Any]):
        if not pipes:
            raise ValueError("ElasticCursorGroup needs at least one pipe")
        self.pipes = list(pipes)

    @property
    def world_size(self) -> int:
        return len(self.pipes)

    def __iter__(self) -> "ElasticCursorGroup":
        return self

    def __next__(self) -> tp.List[tp.Any]:
        return [next(pipe) for pipe in self.pipes]

    def state_dict(self) -> tp.Dict[str, tp.Any]:
        return {"world_size": len(self.pipes),
                "per_rank": [pipe.state_dict() for pipe in self.pipes]}

    def load_state_dict(self, state: tp.Mapping[str, tp.Any]) -> None:
        per_rank = state["per_rank"]
        if int(state["world_size"]) != len(per_rank):
            raise ValueError(
                f"corrupt group cursor: world_size {state['world_size']} "
                f"but {len(per_rank)} per-rank states")
        if len(per_rank) == len(self.pipes):
            for pipe, entry in zip(self.pipes, per_rank):
                pipe.load_state_dict(entry)
            return
        from ..resilience.retry import call_with_retry
        resplit = call_with_retry(resplit_states, per_rank, len(self.pipes),
                                  name="datapipe.resplit",
                                  retry_on=(OSError,))
        _log().warning(
            "ELASTIC RE-SPLIT: datapipe cursors of world size %d "
            "re-partitioned onto world size %d.", len(per_rank),
            len(self.pipes))
        for pipe, entry in zip(self.pipes, resplit):
            pipe.load_state_dict(entry)

    def close(self) -> None:
        for pipe in self.pipes:
            close = getattr(pipe, "close", None)
            if close is not None:
                close()
