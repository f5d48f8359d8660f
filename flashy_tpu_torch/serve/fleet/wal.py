"""RequestWAL: the fleet's durable request journal (port of
flashy_tpu/serve/fleet/wal.py; the records are the same JSON lines, so
a journal written by either package replays in the other).

An engine death is survivable because the fleet process survives to
drain and re-route; a kill of the process itself would lose every queued
and in-flight request. The write-ahead log makes admission durable: an
intent record is fsync'd before `submit()` acknowledges, generated-token
high-water marks land on a step cadence, and a completion record is
fsync'd at retirement. A restarted fleet replays the log, re-admits every
incomplete request through `resume_prompt` (prefilling prompt + generated
re-derives the lost K/V exactly, and greedy decode is deterministic, so
the re-served suffix is the uninterrupted run's) and answers completed
requests from the log. Delivery is at-least-once with exact dedup by
uid: a uid never gets two completion records.
"""
import dataclasses
import json
import logging
import os
import typing as tp
from pathlib import Path

import numpy as np

from ...resilience import fault_point
from ...utils import AnyPath

logger = logging.getLogger(__name__)

# Default WAL filename inside an xp folder, next to fleet.json.
WAL_NAME = "requests.wal"

# Consulted on every record append (ctx: kind=admit|progress|complete,
# uid) and once per replay. A transient fault at the append site is
# absorbed by the fleet door's deadline-capped retry; exhaustion there
# rolls the admission back (a never-acknowledged request may fail).
APPEND_FAULT_SITE = "fleet.wal_append"
REPLAY_FAULT_SITE = "fleet.wal_replay"


@dataclasses.dataclass
class WALEntry:
    """One request's replayed state: the merge of its WAL records."""
    uid: int
    prompt: tp.List[int]
    max_new_tokens: int
    eos_token: tp.Optional[int]
    tenant: str
    priority: int
    generated: tp.List[int] = dataclasses.field(default_factory=list)
    complete: bool = False
    finish_reason: tp.Optional[str] = None
    complete_records: int = 0  # dedup evidence: must end at exactly 1


class RequestWAL:
    """Append-only jsonl journal of request intents and outcomes.

    Record kinds (one JSON object a line):
      ``admit``     uid and what rebuilds the Request (prompt, max_new,
                    eos, tenant, priority); fsync'd before the fleet door
                    acknowledges the submit.
      ``progress``  uid, ``n`` (tokens generated after this record) and
                    ``tokens`` (the delta since the last mark); appended
                    every `progress_every` fleet steps.
      ``complete``  uid, finish reason and the FULL generated stream;
                    fsync'd at retirement, and served from on restart.

    A SIGKILL can tear at most the final line (appends are sequential):
    `replay()` stops at the first undecodable line, warns and truncates
    the file back to the last good record.
    """

    def __init__(self, path: AnyPath, progress_every: int = 1):
        if progress_every < 1:
            raise ValueError(f"progress_every must be >= 1, "
                             f"got {progress_every}")
        self.path = Path(path)
        self.progress_every = progress_every
        self._f: tp.Optional[tp.TextIO] = None
        self._steps = 0                       # note_progress call count
        self._marks: tp.Dict[int, int] = {}   # uid -> logged token count
        self._completed: tp.Set[int] = set()  # uids with a complete record

    # ------------------------------------------------------------------
    # appending
    # ------------------------------------------------------------------
    def _append(self, record: tp.Dict[str, tp.Any], fsync: bool) -> None:
        fault_point(APPEND_FAULT_SITE, kind=record["t"], uid=record["uid"])
        if self._f is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._f = open(self.path, "a", encoding="utf-8")
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()
        if fsync:
            os.fsync(self._f.fileno())

    def append_admit(self, request: tp.Any) -> None:
        """Journal the intent record, durable (fsync) before the caller
        acknowledges the request. Raises OSError on failure: the fleet
        door retries, then rolls the admission back."""
        self._append({
            "t": "admit",
            "uid": int(request.uid),
            "prompt": np.asarray(request.prompt).astype(int).tolist(),
            "max_new": int(request.max_new_tokens),
            "eos": (int(request.eos_token)
                    if request.eos_token is not None else None),
            "tenant": request.tenant,
            "priority": int(request.priority),
        }, fsync=True)
        self._marks.setdefault(int(request.uid), 0)

    def note_progress(self, requests: tp.Iterable[tp.Any]) -> int:
        """Once a fleet step: every `progress_every` calls, append a
        high-water mark for each request that generated tokens since its
        last mark; returns the records written. One fsync covers the
        batch: the cadence bounds how many tokens a crash makes the fleet
        re-serve, not whether the output is right."""
        self._steps += 1
        if self._steps % self.progress_every:
            return 0
        written = 0
        for request in requests:
            uid = int(request.uid)
            if uid in self._completed:
                continue
            mark = self._marks.get(uid, 0)
            total = len(request.generated)
            if total <= mark:
                continue
            self._append({"t": "progress", "uid": uid, "n": total,
                          "tokens": [int(t) for t
                                     in request.generated[mark:]]},
                         fsync=False)
            self._marks[uid] = total
            written += 1
        if written and self._f is not None:
            os.fsync(self._f.fileno())
        return written

    def append_complete(self, request: tp.Any) -> None:
        """Journal the outcome record (fsync'd): the full generated stream
        and the finish reason. Idempotent per uid within this process."""
        uid = int(request.uid)
        if uid in self._completed:
            return
        self._append({"t": "complete", "uid": uid,
                      "reason": request.finish_reason,
                      "tokens": [int(t) for t in request.generated]},
                     fsync=True)
        self._completed.add(uid)
        self._marks[uid] = len(request.generated)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    # ------------------------------------------------------------------
    # replay
    # ------------------------------------------------------------------
    def replay(self) -> tp.Dict[int, WALEntry]:
        """Fold the journal into per-uid entries (admission order).

        A torn tail stops the scan with a warning AND truncates the file
        back to the last good record, so a recovered fleet never appends
        behind an undecodable line. Progress records merge by their total
        `n`, so duplicates or stale marks never shrink or corrupt a
        stream. Primes this WAL's marks, so a recovered fleet appending
        to the same file continues from the replayed high-water marks.
        """
        fault_point(REPLAY_FAULT_SITE, path=str(self.path))
        entries: tp.Dict[int, WALEntry] = {}
        if not self.path.exists():
            return entries
        torn_at: tp.Optional[int] = None
        with open(self.path, "r", encoding="utf-8") as f:
            lineno = 0
            while True:
                offset = f.tell()
                line = f.readline()
                if not line:
                    break
                lineno += 1
                try:
                    record = json.loads(line)
                except json.JSONDecodeError:
                    torn_at = offset
                    logger.warning(
                        "WAL %s: undecodable line %d (torn tail after a "
                        "crash); truncating back to byte %d",
                        self.path, lineno, offset)
                    break
                kind = record.get("t")
                uid = record.get("uid")
                if kind == "admit":
                    if uid in entries:
                        logger.warning("WAL %s: duplicate admit for uid "
                                       "%s (line %d); keeping the first",
                                       self.path, uid, lineno)
                        continue
                    entries[uid] = WALEntry(
                        uid=uid, prompt=list(record["prompt"]),
                        max_new_tokens=record["max_new"],
                        eos_token=record["eos"], tenant=record["tenant"],
                        priority=record["priority"])
                    continue
                entry = entries.get(uid)
                if entry is None:
                    logger.warning("WAL %s: %s record for unknown uid %s "
                                   "(line %d); skipping",
                                   self.path, kind, uid, lineno)
                    continue
                if kind == "progress":
                    total = record["n"]
                    have = len(entry.generated)
                    if total > have:
                        entry.generated.extend(
                            record["tokens"][-(total - have):])
                elif kind == "complete":
                    entry.complete_records += 1
                    entry.complete = True
                    entry.finish_reason = record["reason"]
                    entry.generated = list(record["tokens"])
        if torn_at is not None:
            # before any post-recovery append lands
            assert self._f is None, "replay() must precede appends"
            with open(self.path, "r+", encoding="utf-8") as f:
                f.truncate(torn_at)
        for uid, entry in entries.items():
            self._marks[uid] = len(entry.generated)
            if entry.complete:
                self._completed.add(uid)
        return entries
