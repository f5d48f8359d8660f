"""SequencePacker: variable-length documents -> fixed [B, L] packed
batches (the port of flashy_tpu/datapipe/packing.py).

One batch shape for the whole run: `[B, max_len]` tokens with
`segment_ids` and `positions`. Packing is greedy and streaming: a
document goes into the current row if it fits, else the row is closed
(padded) and a fresh row starts; documents longer than max_len are
split into max_len-sized chunks. Each placed chunk gets a fresh segment
id (1-based; 0 marks padding) and positions restarting at 0, so the
models' segment-aware masking (the dense masked attention path; the SSD
mixer's `SSD_LOG_RESET` at each segment start and its padding mask)
keeps packed documents invisible to each other. Batches are numpy
int32 dicts; the trainer uploads them.
"""
import typing as tp

import numpy as np

from .iterator import PipelineStage

PackedBatch = tp.Dict[str, np.ndarray]
# one row being packed: (tokens, segment ids, positions) as int lists
Row = tp.Tuple[tp.List[int], tp.List[int], tp.List[int]]


class SequencePacker(PipelineStage):
    """Pack a document stream into fixed ``[batch_size, max_len]`` batches.

    Yields dicts of int32 arrays, all ``[B, L]``:

    * ``tokens`` — packed token ids, `pad_id` in the padded tail;
    * ``segment_ids`` — 1-based per-document segment numbering within
      each row, 0 on padding (doubles as the loss mask);
    * ``positions`` — position within the segment, restarting at 0 per
      document (feed to rotary embeddings), 0 on padding.

    Exact resume: the cursor is the source's cursor plus the partially
    packed rows still buffered here (`state_dict` carries them as plain
    int lists — bounded by one batch). `load_state_dict` restores both,
    so the next batch is identical to an uninterrupted run's.

    With ``drop_last=True`` (default) a non-looping source's trailing
    partial batch is dropped — static shapes end-to-end; otherwise the
    final batch is padded with all-padding rows.
    """

    def __init__(self, source: tp.Any, batch_size: int, max_len: int, *,
                 pad_id: int = 0, drop_last: bool = True):
        if batch_size < 1 or max_len < 1:
            raise ValueError("batch_size and max_len must be >= 1, got "
                             f"{batch_size} and {max_len}")
        self.source = source
        self.batch_size = batch_size
        self.max_len = max_len
        self.pad_id = pad_id
        self.drop_last = drop_last
        # rows finished but not yet emitted (each a (tokens, segs, pos)
        # triple of int lists) and the row being filled.
        self._ready: tp.List[Row] = []
        self._row: Row = ([], [], [])
        self._seg = 0
        self._exhausted = False

    # ------------------------------------------------------------------
    def _close_row(self) -> None:
        tokens, segs, pos = self._row
        if not tokens:
            return
        pad = self.max_len - len(tokens)
        tokens.extend([self.pad_id] * pad)
        segs.extend([0] * pad)
        pos.extend([0] * pad)
        self._ready.append(self._row)
        self._row = ([], [], [])
        self._seg = 0

    def _place(self, doc: tp.Sequence[int]) -> None:
        """Greedy placement of one document (possibly split)."""
        offset = 0
        while offset < len(doc):
            tokens, segs, pos = self._row
            space = self.max_len - len(tokens)
            if space == 0 or (offset == 0 and space < len(doc) - offset
                              and len(doc) - offset <= self.max_len):
                # no room, or the whole (remaining) doc would be split
                # even though it fits in a fresh row: close and restart.
                self._close_row()
                continue
            chunk = doc[offset:offset + min(space, self.max_len)]
            self._seg += 1
            tokens.extend(int(t) for t in chunk)
            segs.extend([self._seg] * len(chunk))
            pos.extend(range(len(chunk)))
            offset += len(chunk)
            if len(tokens) == self.max_len:
                self._close_row()

    def _emit(self) -> PackedBatch:
        rows = self._ready[:self.batch_size]
        del self._ready[:self.batch_size]
        while len(rows) < self.batch_size:   # drop_last=False tail only
            rows.append(([self.pad_id] * self.max_len,
                         [0] * self.max_len, [0] * self.max_len))
        batch = {
            "tokens": np.asarray([r[0] for r in rows], dtype=np.int32),
            "segment_ids": np.asarray([r[1] for r in rows], dtype=np.int32),
            "positions": np.asarray([r[2] for r in rows], dtype=np.int32),
        }
        return batch

    def __next__(self) -> PackedBatch:
        while len(self._ready) < self.batch_size and not self._exhausted:
            try:
                doc = next(self.source)
            except StopIteration:
                self._exhausted = True
                self._close_row()
                break
            if len(doc) == 0:
                continue
            self._place(doc)
        if len(self._ready) >= self.batch_size:
            return self._emit()
        if self._ready and not self.drop_last:
            return self._emit()
        raise StopIteration

    # ------------------------------------------------------------------
    def state_dict(self) -> tp.Dict[str, tp.Any]:
        return {
            "source": self.source.state_dict(),
            "ready": [tuple(list(part) for part in row)
                      for row in self._ready],
            "row": tuple(list(part) for part in self._row),
            "seg": self._seg,
            "exhausted": self._exhausted,
        }

    def load_state_dict(self, state: tp.Dict[str, tp.Any]) -> None:
        self.source.load_state_dict(state["source"])
        self._ready = [tuple(list(part) for part in row)
                       for row in state["ready"]]
        self._row = tuple(list(part) for part in state["row"])
        self._seg = int(state["seg"])
        self._exhausted = bool(state["exhausted"])
