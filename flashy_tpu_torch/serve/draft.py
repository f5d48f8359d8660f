"""Draft providers for speculative decoding (port of
flashy_tpu/serve/draft.py).

The verify step (`DecodeEngine.decode_speculative`) takes any proposal of
k tokens a slot: greedy verification stays token-exact and rejection
sampling distribution-exact whatever was proposed, so a better draft only
raises the acceptance rate. `NGramDraft` looks the slot's trailing n-gram
up in its own history, on the host; `ModelDraft` runs a small
TransformerLM on a dense-layout engine that mirrors the target slot for
slot. `k` is fixed per provider, so the verify step is one captured graph.
"""
import abc
import typing as tp

import numpy as np


class DraftProvider(abc.ABC):
    """The contract between the scheduler and a draft source.

    Per request: `begin(slot, prompt, first_token)` when the target's
    prefill completes; `propose()` once per speculative step (an [S, k]
    proposal for every slot; rows without a live request are ignored);
    `observe(slot, tokens, position)` with the tokens the verify step
    emitted and the slot's new length (a model draft rolls its mirror
    back here); `retire(slot)` when the request finishes.
    """

    #: tokens proposed per slot per step (fixed)
    k: int

    def warmup(self, prompt_lengths: tp.Iterable[int] = ()) -> None:
        """Warm whatever the provider runs on the device (nothing for
        host-side drafts)."""

    @abc.abstractmethod
    def begin(self, slot: int, prompt: np.ndarray,
              first_token: int) -> None:
        """A request finished prefill into `slot`: seed the draft with its
        prompt and first generated token."""

    @abc.abstractmethod
    def propose(self) -> np.ndarray:
        """[S, k] int proposed tokens for every slot."""

    @abc.abstractmethod
    def observe(self, slot: int, tokens: tp.Sequence[int],
                position: int) -> None:
        """Feed back the tokens the verify step emitted for a live slot
        and the slot's new sequence length."""

    @abc.abstractmethod
    def retire(self, slot: int) -> None:
        """The request in `slot` finished; drop its draft state."""


class NGramDraft(DraftProvider):
    """Prompt-lookup decoding: propose the continuation of the most recent
    earlier occurrence of the slot's trailing n-gram, tried from `ngram`
    tokens down to 1; no match proposes `k` repeats of the last token.
    Host-side numpy, no device work.

    Args:
        slots: S, the target engine's slot count.
        k: tokens proposed per step.
        ngram: longest trailing n-gram to look up.
        pad_token: fills rows without a live request.
        window: the lookup scans only the most recent `window` tokens of
            a history, bounding its cost per step.
    """

    def __init__(self, slots: int, k: int = 4, ngram: int = 2,
                 pad_token: int = 0, window: int = 1024):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if ngram < 1:
            raise ValueError(f"ngram must be >= 1, got {ngram}")
        if window < ngram + 1:
            raise ValueError(f"window must be > ngram, got {window}")
        self.slots = slots
        self.k = int(k)
        self.ngram = int(ngram)
        self.pad_token = int(pad_token)
        self.window = int(window)
        self._history: tp.Dict[int, tp.List[int]] = {}

    def begin(self, slot: int, prompt: np.ndarray,
              first_token: int) -> None:
        self._history[slot] = [int(t) for t in np.asarray(prompt)]
        self._history[slot].append(int(first_token))

    def observe(self, slot: int, tokens: tp.Sequence[int],
                position: int) -> None:
        self._history[slot].extend(int(t) for t in tokens)

    def retire(self, slot: int) -> None:
        self._history.pop(slot, None)

    def _lookup(self, history: tp.List[int]) -> tp.List[int]:
        """k-token proposal from the most recent earlier occurrence of the
        trailing n-gram (longest n first), within the trailing window."""
        arr = np.asarray(history[-self.window:], np.int64)
        size = arr.size
        for n in range(min(self.ngram, size - 1), 0, -1):
            key = arr[size - n:]
            # the most recent occurrence strictly before the trailing one
            windows = np.lib.stride_tricks.sliding_window_view(
                arr[:size - 1], n)
            hits = np.flatnonzero((windows == key).all(axis=1))
            if hits.size:
                start = int(hits[-1]) + n
                proposal = arr[start:start + self.k].tolist()
                if proposal:
                    proposal += [proposal[-1]] * (self.k - len(proposal))
                    return proposal
        return [int(arr[-1])] * self.k

    def propose(self) -> np.ndarray:
        out = np.full((self.slots, self.k), self.pad_token, np.int64)
        for slot, history in self._history.items():
            if history:
                out[slot] = self._lookup(history)
        return out


class ModelDraft(DraftProvider):
    """A small TransformerLM drafting on its own dense-layout engine.

    The engine mirrors the target slot for slot (the same S and slot
    indices, its own cache and its own compile-cache scope). It drafts k
    tokens by running its [S, 1] decode step k+1 times: the first k
    emissions are the proposal, and the extra step only writes the k-th
    draft's K/V row, without which a fully accepted span would leave a
    hole below the mirror's causal horizon. After each verify step
    `observe()` resets the mirror to the accepted position; its stale
    rows past it are overwritten before they are attended. The draft
    decodes greedily: a one-hot proposal, exact under rejection sampling
    too (`models.decoding.speculative_acceptance`).

    Args:
        model: the (small) draft TransformerLM, on the target's device;
            it must share the target's vocabulary.
        slots: the target engine's slot count.
        k: tokens drafted per step.
        max_seq_len, pad_token: as the target engine's.
        cache_scope: the mirror's compile-cache key prefix.
        compile_cache: a CompileCache to share (see `DecodeEngine`).
        tracer: an `observability.Tracer` for the mirror engine's spans
            (see `DecodeEngine`).
        params: the draft's weights instead of its model's own (e.g.
            int8, `models.quantize.quantize_lm_params`; see
            `DecodeEngine`).
        device: `cuda` by default; the CPU only when asked for.
    """

    def __init__(self, model, *, slots: int, k: int = 4,
                 max_seq_len: tp.Optional[int] = None, pad_token: int = 0,
                 cache_scope: str = "draft", compile_cache: tp.Any = None,
                 tracer: tp.Any = None, params: tp.Any = None,
                 device: tp.Any = None):
        from .engine import DecodeEngine
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.k = int(k)
        self.engine = DecodeEngine(model, slots=slots,
                                   max_seq_len=max_seq_len,
                                   pad_token=pad_token,
                                   cache_layout="dense",
                                   cache_scope=cache_scope,
                                   compile_cache=compile_cache,
                                   tracer=tracer, params=params,
                                   device=device)

    def warmup(self, prompt_lengths: tp.Iterable[int] = ()) -> None:
        self.engine.warmup(prompt_lengths)

    def begin(self, slot: int, prompt: np.ndarray,
              first_token: int) -> None:
        self.engine.acquire_slot(slot)
        self.engine.prefill(slot, prompt)
        # the target emitted the first token: resync the mirror to it
        self.engine.set_slot_state(slot, int(first_token),
                                   int(np.asarray(prompt).size))

    def propose(self) -> np.ndarray:
        # k+1 steps for k drafts: step i writes draft i-1's K/V row
        columns = [self.engine.decode() for _ in range(self.k + 1)]
        return np.stack(columns[:self.k], axis=1)

    def observe(self, slot: int, tokens: tp.Sequence[int],
                position: int) -> None:
        self.engine.set_slot_state(slot, int(tokens[-1]), int(position))

    def retire(self, slot: int) -> None:
        self.engine.retire(slot)
