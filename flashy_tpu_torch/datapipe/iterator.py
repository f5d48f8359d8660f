"""CheckpointableIterator: the exact-resume protocol of every stage (the
port of flashy_tpu/datapipe/iterator.py).

The solver's epoch is an atomic commit unit; a stream has no natural
epoch boundary, so the input cursor must be committed with the model
state, or a preempted run re-reads or skips samples between the last
commit and the kill. Every stage therefore implements the
state_dict / load_state_dict pair the rest of the harness checkpoints
through (`flashy_tpu_torch.state.StateDictSource`): register the
outermost stage with `BaseSolver.register_stateful` and `commit()`
persists the exact cursor of every stage below it, recursively.
"""
import typing as tp

T = tp.TypeVar("T")


@tp.runtime_checkable
class CheckpointableIterator(tp.Protocol[T]):
    """An iterator whose position can be checkpointed and restored.

    The contract, shared by every `flashy_tpu_torch.datapipe` stage:

    * `state_dict()` describes the cursor AS OF THE ITEMS ALREADY
      YIELDED to the caller — not items fetched ahead internally (the
      prefetch stage buffers; its state tracks consumption).
    * `load_state_dict(state)` repositions the iterator (and,
      recursively, its sources) so the next `__next__` returns exactly
      the item an uninterrupted run would have produced next.
    * `close()` releases background resources (threads, file handles);
      idempotent.

    Any object with these methods qualifies (`runtime_checkable`
    structural protocol) — which is also exactly what
    `flashy_tpu_torch.state.StateDictSource` needs, so a pipeline registered
    via `BaseSolver.register_stateful` is committed and restored in
    place like any other stateful attribute.
    """

    def __iter__(self) -> tp.Iterator[T]:
        ...

    def __next__(self) -> T:
        ...

    def state_dict(self) -> tp.Dict[str, tp.Any]:
        ...

    def load_state_dict(self, state: tp.Dict[str, tp.Any]) -> None:
        ...

    def close(self) -> None:
        ...


class PipelineStage:
    """Minimal base for datapipe stages: iterator plumbing + close
    fan-out to the source. Subclasses implement `__next__`,
    `state_dict` and `load_state_dict` (the cursor semantics are the
    interesting part and never generic)."""

    source: tp.Optional[tp.Any] = None

    def __iter__(self):
        return self

    def __next__(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def close(self) -> None:
        """Release the source's resources (recursively); idempotent."""
        close = getattr(self.source, "close", None)
        if close is not None:
            close()
