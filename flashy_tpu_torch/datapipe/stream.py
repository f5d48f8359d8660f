"""ShardedTextStream: disjoint per-process file shards -> a document
stream (the port of flashy_tpu/datapipe/stream.py).

The file list is partitioned by `shards[shard_index::num_shards]`, so
every process owns a disjoint set of files and reads it with no
cross-process coordination; determinism comes from sorting the file
list and interleaving the assigned files round-robin in a fixed order.
The cursor is a few integers per file, which makes mid-epoch exact
resume cheap: a checkpoint carries document counts, never buffered
data. Host-only: numpy arrays, no tensor.
"""
from pathlib import Path
import json
import logging
import typing as tp

import numpy as np

from ..utils import AnyPath
from .iterator import PipelineStage

logger = logging.getLogger(__name__)


def _load_documents(path: Path) -> tp.List[np.ndarray]:
    """All documents of one shard file, as int32 token arrays.

    Two shard formats:

    * ``.jsonl`` — one document per line; ``{"tokens": [...]}`` is used
      as-is, ``{"text": "..."}`` falls back to byte-level tokens (utf-8
      values) so the pipeline runs without any tokenizer dependency.
    * ``.npy`` — a 2-D ``[num_docs, doc_len]`` int array, one row per
      document, right-padded with negative values (trimmed here); a 1-D
      array is a single document.
    """
    if path.suffix == ".npy":
        arr = np.load(path)
        if arr.ndim == 1:
            return [arr.astype(np.int32)]
        if arr.ndim != 2:
            raise ValueError(f"{path}: expected a 1-D or 2-D token array, "
                             f"got shape {arr.shape}")
        return [row[row >= 0].astype(np.int32) for row in arr]
    docs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            record = json.loads(line)
            if "tokens" in record:
                docs.append(np.asarray(record["tokens"], dtype=np.int32))
            elif "text" in record:
                docs.append(np.frombuffer(record["text"].encode("utf-8"),
                                          dtype=np.uint8).astype(np.int32))
            else:
                raise ValueError(f"{path}: jsonl record needs a 'tokens' or "
                                 f"'text' field, got keys {sorted(record)}")
    return docs


class ShardedTextStream(PipelineStage):
    """Stream documents from this process's slice of the file shards.

    Args:
        shards: shard files (jsonl / .npy, see `_load_documents`) or
            directories (expanded to their sorted ``*.jsonl`` + ``*.npy``
            entries). Sorted for a deterministic global order, then this
            process keeps ``shards[shard_index::num_shards]``.
        shard_index / num_shards: the per-host assignment; default from
            `flashy_tpu_torch.distrib` is the caller's job (pass
            `distrib.rank()` / `distrib.world_size()`).
        loop: restart from the first document after the last (the
            stream-shaped training posture — epochs are step counts,
            not dataset passes); `passes` in `state_dict` counts wraps.

    Documents are yielded round-robin across the assigned files
    (file 0 doc 0, file 1 doc 0, ..., file 0 doc 1, ...), so a corpus
    split into per-source files is interleaved rather than consumed one
    file at a time. The cursor (`state_dict`) is the per-file document
    counts plus the round-robin position — `load_state_dict` re-opens
    and skips, token-exact, without storing any tokens.

    File contents are cached per file after first touch (shard files
    are the unit of assignment and assumed host-memory sized; the
    bounded-memory knob is more, smaller shards).
    """

    def __init__(self, shards: tp.Union[AnyPath, tp.Sequence[AnyPath]], *,
                 shard_index: int = 0, num_shards: int = 1,
                 loop: bool = False):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index must be in [0, {num_shards}), "
                             f"got {shard_index}")
        if isinstance(shards, (str, Path)):
            shards = [shards]
        files: tp.List[Path] = []
        for entry in shards:
            entry = Path(entry)
            if entry.is_dir():
                files.extend(sorted(p for p in entry.iterdir()
                                    if p.suffix in (".jsonl", ".npy")))
            else:
                files.append(entry)
        files.sort()
        if not files:
            raise ValueError("ShardedTextStream got an empty shard list; "
                             "an empty stream would starve this process and "
                             "deadlock any downstream collective.")
        self.shard_index = shard_index
        self.num_shards = num_shards
        # The GLOBAL sorted file list (pre-slice) is part of the cursor
        # identity: a world-size re-split is only token-exact against
        # the same global corpus, so resume validates it by name.
        self._global_files = [f.name for f in files]
        self.files = files[shard_index::num_shards]
        if not self.files:
            raise ValueError(
                f"no shard files left for process {shard_index} of "
                f"{num_shards} ({len(files)} files total); provide at least "
                f"num_shards files so every process owns a non-empty slice.")
        self.loop = loop
        self._docs: tp.Dict[int, tp.List[np.ndarray]] = {}
        self._cursors = [0] * len(self.files)
        self._rr = 0          # round-robin position (next file to try)
        self._passes = 0

    def _file_docs(self, i: int) -> tp.List[np.ndarray]:
        if i not in self._docs:
            self._docs[i] = _load_documents(self.files[i])
        return self._docs[i]

    def __next__(self) -> np.ndarray:
        for _ in range(2):  # second try only after a loop reset
            for probe in range(len(self.files)):
                i = (self._rr + probe) % len(self.files)
                docs = self._file_docs(i)
                if self._cursors[i] < len(docs):
                    doc = docs[self._cursors[i]]
                    self._cursors[i] += 1
                    self._rr = (i + 1) % len(self.files)
                    return doc
            if not self.loop:
                break
            self._cursors = [0] * len(self.files)
            self._rr = 0
            self._passes += 1
        raise StopIteration

    def state_dict(self) -> tp.Dict[str, tp.Any]:
        return {"cursors": list(self._cursors), "rr": self._rr,
                "passes": self._passes,
                "num_files": len(self.files),
                "file_names": [f.name for f in self.files],
                # v2 (elastic) fields: the per-file cursor map plus the
                # global layout, so a checkpoint written under world
                # size N can be re-partitioned to world size M
                # (`datapipe.elastic.resplit_stream_states`).
                "shard_index": self.shard_index,
                "num_shards": self.num_shards,
                "global_file_names": list(self._global_files),
                "file_cursors": {f.name: int(c) for f, c
                                 in zip(self.files, self._cursors)}}

    def load_state_dict(self, state: tp.Dict[str, tp.Any]) -> None:
        names = [f.name for f in self.files]
        if state["num_files"] == len(self.files) \
                and state.get("file_names", names) == names:
            # same layout: exact positional resume, as ever
            self._cursors = list(state["cursors"])
            self._rr = int(state["rr"])
            self._passes = int(state["passes"])
            return
        if state.get("file_names", names) == names:
            # a pre-elastic cursor (no file_names recorded) whose count
            # does not match: positional cursors cannot be re-dealt.
            raise ValueError(
                f"checkpointed cursor covers {state['num_files']} shard "
                f"files but this process is assigned {len(self.files)}; "
                "resuming with a different sharding layout cannot be "
                "token-exact.")
        # A DIFFERENT layout: the world-size-aware re-split path. Only
        # sound when the state carries a per-file cursor map covering
        # every file this process now owns (a re-split state built by
        # `elastic.resplit_stream_states`, or a world-size-1 cursor
        # being re-partitioned) against the SAME global corpus.
        from ..resilience.retry import call_with_retry
        call_with_retry(self._adopt_resplit, state, name="datapipe.resplit",
                        retry_on=(OSError,))

    def _adopt_resplit(self, state: tp.Dict[str, tp.Any]) -> None:
        """Adopt per-file cursors from a cursor saved under a different
        sharding layout (world size N -> this stream's M). Token-exact
        by construction: every file resumes at its exact consumed-doc
        prefix, so no document is read twice and none is skipped."""
        from ..resilience import chaos
        chaos.fault_point("datapipe.resplit", shard_index=self.shard_index,
                          num_shards=self.num_shards)
        names = [f.name for f in self.files]
        saved_layout = (f"{state.get('num_files')} files of shard "
                        f"{state.get('shard_index', '?')}/"
                        f"{state.get('num_shards', '?')}")
        live_layout = (f"{len(self.files)} files of shard "
                       f"{self.shard_index}/{self.num_shards}")
        cursors = state.get("file_cursors")
        if cursors is None:
            raise ValueError(
                f"checkpointed cursor ({saved_layout}) does not match this "
                f"process's layout ({live_layout}) and carries no per-file "
                "cursor map — it predates elastic checkpoints; re-splitting "
                "it cannot be token-exact.")
        saved_global = state.get("global_file_names")
        if saved_global is not None \
                and list(saved_global) != list(self._global_files):
            raise ValueError(
                "checkpointed cursor names different shard files at the "
                f"global level ({saved_global} vs {self._global_files}); "
                "re-splitting against a changed file set cannot be "
                "token-exact.")
        missing = [name for name in names if name not in cursors]
        if missing:
            raise ValueError(
                f"re-split cursor covers only {sorted(cursors)} but this "
                f"process ({live_layout}) also owns {missing}; merge every "
                "source rank's cursor first "
                "(datapipe.elastic.resplit_stream_states).")
        self._cursors = [int(cursors[name]) for name in names]
        self._rr = min(range(len(self.files)),
                       key=lambda i: (self._cursors[i], i))
        self._passes = int(state["passes"])
        logger.warning(
            "ELASTIC RE-SPLIT: shard cursor saved as %s re-partitioned "
            "onto %s (global corpus of %d files unchanged); per-file "
            "positions are exact.", saved_layout, live_layout,
            len(self._global_files))
        from ..observability import get_telemetry
        telemetry = get_telemetry()
        if telemetry is not None:
            telemetry.record({
                "type": "datapipe_resplit",
                "saved_layout": saved_layout, "live_layout": live_layout,
                "files": len(self.files),
                "global_files": len(self._global_files)})

    def close(self) -> None:
        """No-op: the stream holds no OS resources (files are read
        whole per touch, never kept open), and the parsed-document
        cache is deliberately KEPT — a device prefetcher closes its
        source at every epoch end, and dropping the cache there would
        re-read and re-parse the entire corpus each epoch."""
