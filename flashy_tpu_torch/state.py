"""Automatic tracking of stateful solver attributes (the port of
flashy_tpu/state.py).

`StateManager` maps a name to a `StateDictSource`. `AttributeWrapper`
turns *any* attribute of an object into such a source: objects already
implementing the `state_dict`/`load_state_dict` protocol (`nn.Module`s,
optimizers) delegate to it; lists and dicts are restored in place;
everything else is restored by plain attribute assignment.
"""
import typing as tp

StateDict = tp.Any


@tp.runtime_checkable
class StateDictSource(tp.Protocol):
    """Anything with the idiomatic `state_dict`/`load_state_dict` pair."""

    def state_dict(self) -> StateDict:
        ...

    def load_state_dict(self, state: StateDict) -> None:
        ...


def _capture(value: tp.Any) -> StateDict:
    """Snapshot a value: protocol objects export themselves, plain values
    are stored as-is."""
    return value.state_dict() if isinstance(value, StateDictSource) else value


def _restore(owner: tp.Any, attr: str, payload: StateDict) -> None:
    """Put `payload` back into `owner.<attr>`.

    Mutable containers and protocol objects are refilled in place so that
    aliases held elsewhere keep seeing the restored content; any other
    value (numbers, strings, tuples) is rebound with `setattr`.
    """
    current = getattr(owner, attr)
    if isinstance(current, StateDictSource):
        current.load_state_dict(payload)
        return
    if isinstance(current, list):
        current[:] = payload
        return
    if isinstance(current, dict):
        current.clear()
        current.update(payload)
        return
    setattr(owner, attr, payload)


class AttributeWrapper:
    """Expose an arbitrary attribute of `owner` as a StateDictSource.

    Restore dispatch: protocol match → in-place `load_state_dict`; list →
    slice assign; dict → clear+update; anything else → `setattr`.
    """

    def __init__(self, owner: tp.Any, name: str):
        self.owner = owner
        self.name = name

    def state_dict(self) -> StateDict:
        return _capture(getattr(self.owner, self.name))

    def load_state_dict(self, state: StateDict) -> None:
        _restore(self.owner, self.name, state)


class WriteOnlyWrapper(StateDictSource):
    """Saved into checkpoints for forensics, never restored.

    Used for the experiment config and signature: you want them recorded
    next to the weights, but restoring them would clobber the live run's
    config.
    """

    def __init__(self, source: StateDictSource):
        self.source = source

    def state_dict(self) -> StateDict:
        return self.source.state_dict()

    def load_state_dict(self, state: StateDict) -> None:
        del state  # forensic-only entry: restoring is a deliberate no-op

    def __repr__(self) -> str:
        return f"WriteOnlyWrapper({self.source!r})"


class StateManager(StateDictSource):
    """Registry of named StateDictSources; itself a StateDictSource."""

    def __init__(self):
        self.sources: tp.Dict[str, StateDictSource] = {}

    def register(self, name: str, source: StateDictSource, write_only: bool = False) -> None:
        if name in self.sources:
            raise ValueError(
                f"A stateful entry named {name!r} is already registered; "
                "pick a distinct name per register_stateful call.")
        self.sources[name] = WriteOnlyWrapper(source) if write_only else source

    def names(self) -> tp.List[str]:
        """Registered entry names, in registration order."""
        return list(self.sources)

    def state_dict(self) -> StateDict:
        out: tp.Dict[str, StateDict] = {}
        for name, source in self.sources.items():
            out[name] = source.state_dict()
        return out

    def load_state_dict(self, state: StateDict) -> None:
        for name, payload in state.items():
            self.sources[name].load_state_dict(payload)
