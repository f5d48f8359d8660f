"""MixtureStream: deterministic weighted sampling over N sources (the port
of flashy_tpu/datapipe/mixture.py).

The sampling is counter-keyed: draw k's randomness is a pure function
of (seed, k), `np.random.default_rng(SeedSequence([seed, k]))`, exactly
as in the JAX package, so the mixture sequence is a value, not hidden
RNG state, and the port picks the same source as the reference at every
draw. The checkpoint carries one integer (the draw counter) plus each
source's cursor, and a resumed run replays draw k with bit-identical
randomness. These are host-side draws, not tensor randomness: no
`torch.Generator` takes part.
"""
import typing as tp

import numpy as np

from .iterator import PipelineStage


class MixtureStream(PipelineStage):
    """Sample each next document from one of `sources` by weight.

    Args:
        sources: CheckpointableIterators (e.g. one `ShardedTextStream`
            per corpus; loop them for the steady-state training mix).
        weights: relative sampling rates, one per source (normalized
            here; must be non-negative with a positive sum).
        seed: the mixture key. Draw k uses
            ``np.random.default_rng(SeedSequence([seed, k]))`` — the
            counter-keyed fold-in that makes every draw reproducible in
            isolation.

    A source that raises StopIteration is retired from the mixture (its
    weight drops to zero; the draw counter still advances one-per-draw
    so the remaining sources keep their deterministic schedule); the
    stream ends when every source is exhausted. Exhaustion is itself
    deterministic, so resumed runs retire sources at the same draws.
    """

    def __init__(self, sources: tp.Sequence[tp.Any],
                 weights: tp.Sequence[float], seed: int = 0):
        if len(sources) != len(weights):
            raise ValueError(f"{len(sources)} sources but {len(weights)} "
                             "weights")
        if not sources:
            raise ValueError("MixtureStream needs at least one source")
        weights_arr = np.asarray(weights, dtype=np.float64)
        if (weights_arr < 0).any() or weights_arr.sum() <= 0:
            raise ValueError("weights must be non-negative with a positive "
                             f"sum, got {list(weights)}")
        self.sources = list(sources)
        self.weights = weights_arr / weights_arr.sum()
        self.seed = seed
        self._draws = 0
        self._alive = [True] * len(sources)

    def _pick(self, k: int) -> tp.Optional[int]:
        """Source index of draw k: pure function of (seed, k, alive);
        None once no live source has any weight left (a zero-weight
        source can outlive every weighted one — it is never drawable)."""
        weights = np.where(self._alive, self.weights, 0.0)
        total = weights.sum()
        if total <= 0:
            return None
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, k]))
        return int(rng.choice(len(self.sources), p=weights / total))

    def __next__(self) -> tp.Any:
        while True:
            index = self._pick(self._draws)
            if index is None:
                raise StopIteration
            self._draws += 1
            try:
                return next(self.sources[index])
            except StopIteration:
                self._alive[index] = False

    def state_dict(self) -> tp.Dict[str, tp.Any]:
        return {"draws": self._draws, "alive": list(self._alive),
                "seed": self.seed, "weights": [float(w) for w in self.weights],
                "sources": [s.state_dict() for s in self.sources]}

    def load_state_dict(self, state: tp.Dict[str, tp.Any]) -> None:
        if len(state["sources"]) != len(self.sources):
            raise ValueError(f"checkpoint covers {len(state['sources'])} "
                             f"sources, this mixture has {len(self.sources)}")
        if state.get("seed", self.seed) != self.seed or not np.allclose(
                state.get("weights", self.weights), self.weights):
            # draws from `_draws` onward would follow a different
            # schedule than the uninterrupted run — the same silent
            # divergence a changed shard file set causes downstream.
            raise ValueError(
                "checkpointed mixture used seed "
                f"{state.get('seed')} / weights {state.get('weights')} but "
                f"this mixture has seed {self.seed} / weights "
                f"{list(self.weights)}; resuming with a changed mixture "
                "config cannot be token-exact.")
        self._draws = int(state["draws"])
        self._alive = [bool(a) for a in state["alive"]]
        for source, payload in zip(self.sources, state["sources"]):
            source.load_state_dict(payload)

    def close(self) -> None:
        for source in self.sources:
            close = getattr(source, "close", None)
            if close is not None:
                close()
