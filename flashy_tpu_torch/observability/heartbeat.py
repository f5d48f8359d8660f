"""Heartbeat files per rank + straggler report over an XP folder (the port
of flashy_tpu/observability/heartbeat.py).

Each process atomically rewrites a tiny per-rank JSON file at step and
stage boundaries; any other process (or `python -m flashy_tpu_torch.info`
on the shared filesystem) reads the set and computes cross-rank step
skew and staleness without a collective: what a hung job still leaves
behind.
"""
from pathlib import Path
import json
import os
import socket
import time
import typing as tp

from ..utils import AnyPath, write_and_rename

HEARTBEAT_PREFIX = "rank"


def device_memory_stats() -> tp.List[tp.Dict[str, tp.Any]]:
    """Live memory of every visible CUDA device: the caching allocator's
    bytes in use and their peak (`torch.cuda.memory_stats`) and the
    device's total as its limit (`torch.cuda.mem_get_info`).

    Returns [] on a process without CUDA, before it touched the card
    (reading the stats would create a context on every device) and while
    the current stream captures a CUDA graph (no CUDA call belongs
    inside a capture). Never raises: heartbeats run on every platform.
    """
    import torch
    out: tp.List[tp.Dict[str, tp.Any]] = []
    try:
        if not torch.cuda.is_available() or not torch.cuda.is_initialized() \
                or torch.cuda.is_current_stream_capturing():
            return out
        count = torch.cuda.device_count()
    except RuntimeError:
        return out
    for index in range(count):
        entry: tp.Dict[str, tp.Any] = {
            "id": index, "platform": "cuda",
            "kind": torch.cuda.get_device_name(index)}
        try:
            stats = torch.cuda.memory_stats(index)
            _, total = torch.cuda.mem_get_info(index)
        except RuntimeError:
            out.append(entry)
            continue
        entry["bytes_in_use"] = int(stats.get("allocated_bytes.all.current",
                                              0))
        entry["peak_bytes_in_use"] = int(stats.get(
            "allocated_bytes.all.peak", 0))
        entry["bytes_limit"] = int(total)
        out.append(entry)
    return out


class Heartbeat:
    """Atomically rewrites `<folder>/rank{r}.json` with liveness info.

    `beat()` is throttled to one write per `interval` seconds (step loops
    call it every step; `force=True` at stage boundaries). The write is
    atomic (write + rename), so readers never see a torn file. With
    `with_device_stats` each beat carries `device_memory_stats()`, each
    device entry with `bytes_in_use_delta` against this rank's previous
    beat (a climbing rank against one holding a large working set).
    """

    def __init__(self, folder: AnyPath, rank: int = 0, world_size: int = 1,
                 interval: float = 10.0, with_device_stats: bool = True):
        self.folder = Path(folder)
        self.rank = rank
        self.world_size = world_size
        self.interval = interval
        self.with_device_stats = with_device_stats
        self._last_beat = float("-inf")
        # device id -> bytes_in_use at the previous beat (delta base)
        self._last_bytes: tp.Dict[int, int] = {}
        self.folder.mkdir(parents=True, exist_ok=True)

    @property
    def path(self) -> Path:
        return self.folder / f"{HEARTBEAT_PREFIX}{self.rank}.json"

    def beat(self, step: tp.Optional[int] = None,
             epoch: tp.Optional[int] = None,
             stage: tp.Optional[str] = None, force: bool = False,
             **extra: tp.Any) -> bool:
        """Write a heartbeat unless one was written < `interval` ago.
        Returns True when a file was written."""
        now = time.monotonic()
        if not force and now - self._last_beat < self.interval:
            return False
        self._last_beat = now
        payload: tp.Dict[str, tp.Any] = {
            "rank": self.rank, "world_size": self.world_size,
            "time": time.time(), "pid": os.getpid(),
            "host": socket.gethostname(),
            "step": step, "epoch": epoch, "stage": stage,
        }
        payload.update(extra)
        if self.with_device_stats:
            devices = device_memory_stats()
            for entry in devices:
                used = entry.get("bytes_in_use")
                if used is None:
                    continue
                previous = self._last_bytes.get(entry["id"])
                if previous is not None:
                    entry["bytes_in_use_delta"] = used - previous
                self._last_bytes[entry["id"]] = used
            payload["devices"] = devices
        with write_and_rename(self.path, "w", pid=True) as f:
            json.dump(payload, f, default=float)
        return True


def read_heartbeats(folder: AnyPath) -> tp.List[tp.Dict[str, tp.Any]]:
    """All parseable per-rank heartbeat payloads under `folder`, by rank."""
    folder = Path(folder)
    if not folder.is_dir():
        return []
    beats = []
    for path in sorted(folder.glob(f"{HEARTBEAT_PREFIX}*.json")):
        try:
            with open(path) as f:
                beats.append(json.load(f))
        except (OSError, json.JSONDecodeError):
            continue  # mid-rewrite or corrupt: skip, do not crash the reader
    beats.sort(key=lambda b: b.get("rank", 0))
    return beats


def _rank_hbm_pressure(beat: tp.Dict[str, tp.Any]) -> tp.Optional[float]:
    """Worst bytes_in_use / bytes_limit over a beat's devices, or None."""
    pressures = []
    for entry in beat.get("devices") or []:
        limit = entry.get("bytes_limit")
        used = entry.get("bytes_in_use")
        if limit and used is not None:
            pressures.append(used / limit)
    return max(pressures) if pressures else None


# a rank past this fraction of its device memory is close enough to the
# allocator's ceiling that stalls on it become plausible
HBM_PRESSURE_THRESHOLD = 0.9


def straggler_report(folder: AnyPath,
                     now: tp.Optional[float] = None) -> tp.Dict[str, tp.Any]:
    """Cross-rank liveness summary from the heartbeat files.

    Returns ``{"ranks", "expected", "missing", "max_step_skew",
    "stalest_rank", "stalest_age", "per_rank"}``: the spread between the
    fastest and slowest rank's last step, and the seconds since the
    oldest beat. When beats carry device stats, `hbm_pressure` maps each
    rank to its worst bytes_in_use / bytes_limit and
    `pressured_stragglers` lists the ranks both behind the fastest step
    and past `HBM_PRESSURE_THRESHOLD`. An empty folder gives
    ``{"ranks": 0}``.
    """
    beats = read_heartbeats(folder)
    if not beats:
        return {"ranks": 0}
    now = time.time() if now is None else now
    expected = max(b.get("world_size") or 1 for b in beats)
    seen = {b.get("rank", 0) for b in beats}
    steps = [b["step"] for b in beats if b.get("step") is not None]
    ages = [(now - b["time"], b.get("rank", 0)) for b in beats if "time" in b]
    stalest_age, stalest_rank = max(ages) if ages else (0.0, None)
    pressure = {b.get("rank", 0): p for b in beats
                if (p := _rank_hbm_pressure(b)) is not None}
    pressured = []
    if pressure and steps:
        top_step = max(steps)
        for beat in beats:
            rank = beat.get("rank", 0)
            lagging = (beat.get("step") is not None
                       and beat["step"] < top_step)
            if lagging and pressure.get(rank, 0.0) >= HBM_PRESSURE_THRESHOLD:
                pressured.append(rank)
    report = {
        "ranks": len(beats),
        "expected": expected,
        "missing": sorted(set(range(expected)) - seen),
        "max_step_skew": (max(steps) - min(steps)) if steps else 0,
        "stalest_rank": stalest_rank,
        "stalest_age": stalest_age,
        "per_rank": beats,
    }
    if pressure:
        report["hbm_pressure"] = pressure
        report["pressured_stragglers"] = pressured
    return report


def format_straggler_report(report: tp.Dict[str, tp.Any]) -> str:
    """One-line rendering of `straggler_report` (the info CLI)."""
    if not report.get("ranks"):
        return "no heartbeats"
    parts = [f"{report['ranks']}/{report.get('expected', report['ranks'])} "
             f"ranks"]
    if report.get("missing"):
        parts.append("missing " + ",".join(str(r) for r in report["missing"]))
    parts.append(f"step skew {report.get('max_step_skew', 0)}")
    if report.get("stalest_rank") is not None:
        parts.append(f"stalest rank {report['stalest_rank']} "
                     f"({report['stalest_age']:.1f}s ago)")
    if report.get("pressured_stragglers"):
        ranks = report["pressured_stragglers"]
        worst = max(report["hbm_pressure"][r] for r in ranks)
        parts.append("HBM-pressured stragglers "
                     + ",".join(str(r) for r in ranks)
                     + f" (worst {worst:.0%})")
    return " | ".join(parts)
