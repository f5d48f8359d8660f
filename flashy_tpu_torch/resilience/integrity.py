"""Checkpoint manifests: sha256 and size per file, verification, the
corruption report (the port of flashy_tpu/resilience/integrity.py).

The A/B slot scheme (`flashy_tpu_torch.checkpoint`) guarantees that a
complete checkpoint survives a crash mid-save, but completeness is not
integrity: a bit-rotted block, a torn page on a network filesystem or a
stray truncation leaves a slot that looks committed and fails deep in
unpickling at restore time. Each committed slot therefore carries a
manifest (sha256 and size of every payload file, written before the
pointer flip), and each single-file checkpoint a sidecar
(`checkpoint.th.manifest.json`); restore verifies before unpickling and
falls back to the sibling slot on a mismatch.

`verify_checkpoint` also loads each verified file with
`torch.load(weights_only=True)`: a file whose digest matches but whose
pickle names anything beyond tensors and plain containers is not
restorable by the port, so it is reported, never run.
"""
from pathlib import Path
import hashlib
import json
import time
import typing as tp

from ..utils import AnyPath, write_and_rename

MANIFEST_NAME = "manifest.json"
# Sidecar suffix of single-file checkpoints (checkpoint.th.manifest.json).
SIDECAR_SUFFIX = ".manifest.json"


class CheckpointError(RuntimeError):
    """A checkpoint could not be loaded; the message names the path (and
    slot, for slot checkpoints) instead of leaking a raw unpickling
    traceback as the only clue."""


class CheckpointCorrupted(CheckpointError):
    """No restorable checkpoint remains: every candidate (both A/B slots,
    or the single file) failed integrity verification or unpickling."""


def file_digest(path: AnyPath, chunk_bytes: int = 1 << 20
                ) -> tp.Tuple[str, int]:
    """(sha256 hexdigest, size) of a file, streamed in chunks."""
    digest = hashlib.sha256()
    size = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk_bytes)
            if not block:
                break
            digest.update(block)
            size += len(block)
    return digest.hexdigest(), size


def _payload_files(slot_dir: Path) -> tp.List[Path]:
    """Every file of a slot the manifest must cover: all but the
    manifest itself and write-and-rename temporaries."""
    out = []
    for path in sorted(slot_dir.rglob("*")):
        if not path.is_file():
            continue
        if path.name == MANIFEST_NAME or ".tmp" in path.suffixes:
            continue
        out.append(path)
    return out


def write_manifest(slot_dir: AnyPath,
                   files: tp.Optional[tp.Iterable[AnyPath]] = None,
                   known: tp.Optional[tp.Mapping[str, tp.Tuple[str, int]]]
                   = None, extra: tp.Optional[tp.Mapping[str, tp.Any]] = None
                   ) -> Path:
    """Write `<slot_dir>/manifest.json`: {relpath: {sha256, size}} for
    every payload file (or the explicit `files`), atomically. Called by
    the commit path after all payload writes and before the pointer
    flip. `known` maps a relpath to a digest already taken of that file
    once it was written (an asynchronous save hashes its payload in the
    background), so it is not read again here. `extra` adds top-level
    keys (a save across ranks records its world and layout there)."""
    slot_dir = Path(slot_dir)
    targets = ([Path(f) for f in files] if files is not None
               else _payload_files(slot_dir))
    entries: tp.Dict[str, tp.Dict[str, tp.Any]] = {}
    for path in targets:
        rel = path.relative_to(slot_dir).as_posix()
        sha, size = (known or {}).get(rel) or file_digest(path)
        entries[rel] = {"sha256": sha, "size": size}
    manifest_path = slot_dir / MANIFEST_NAME
    with write_and_rename(manifest_path, "w") as f:
        json.dump({"version": 1, "created": time.time(), "files": entries,
                   **(extra or {})}, f, indent=2)
    return manifest_path


def verify_slot(slot_dir: AnyPath, strict: bool = False) -> tp.List[str]:
    """Verify a slot against its manifest; returns the problems ([] =
    verified). A missing manifest is a problem only when `strict`; a
    missing, short or mismatched payload file always is."""
    slot_dir = Path(slot_dir)
    manifest_path = slot_dir / MANIFEST_NAME
    if not manifest_path.exists():
        return [f"{slot_dir}: no {MANIFEST_NAME}"] if strict else []
    try:
        manifest = json.loads(manifest_path.read_text())
        entries = dict(manifest["files"])
    except (json.JSONDecodeError, KeyError, TypeError) as exc:
        return [f"{manifest_path}: unreadable manifest ({exc})"]
    problems = []
    for rel, meta in entries.items():
        path = slot_dir / rel
        if not path.exists():
            problems.append(f"{path}: listed in manifest but missing")
            continue
        sha, size = file_digest(path)
        if size != meta.get("size"):
            problems.append(f"{path}: size {size} != manifest "
                            f"{meta.get('size')}")
        elif sha != meta.get("sha256"):
            problems.append(f"{path}: sha256 mismatch (corrupted)")
    return problems


# ----------------------------------------------------------------------
# single-file sidecars
# ----------------------------------------------------------------------
def sidecar_path(path: AnyPath) -> Path:
    return Path(str(path) + SIDECAR_SUFFIX)


def write_sidecar(path: AnyPath) -> Path:
    """Write the integrity sidecar of a single-file checkpoint."""
    sha, size = file_digest(path)
    target = sidecar_path(path)
    with write_and_rename(target, "w") as f:
        json.dump({"version": 1, "created": time.time(),
                   "sha256": sha, "size": size}, f, indent=2)
    return target


def verify_file(path: AnyPath, strict: bool = False) -> tp.List[str]:
    """Verify a single-file checkpoint against its sidecar; [] = ok. As
    with `verify_slot`, a missing sidecar only counts when `strict`."""
    path = Path(path)
    side = sidecar_path(path)
    if not path.exists():
        return [f"{path}: missing"]
    if not side.exists():
        return [f"{path}: no integrity sidecar"] if strict else []
    try:
        meta = json.loads(side.read_text())
    except json.JSONDecodeError as exc:
        return [f"{side}: unreadable sidecar ({exc})"]
    sha, size = file_digest(path)
    if size != meta.get("size"):
        return [f"{path}: size {size} != recorded {meta.get('size')}"]
    if sha != meta.get("sha256"):
        return [f"{path}: sha256 mismatch (corrupted)"]
    return []


def load_problems(path: AnyPath) -> tp.List[str]:
    """[] when `path` loads with `torch.load(weights_only=True)` (memory-
    mapped, so a large file is not read into memory), else the error."""
    import torch
    from .. import checkpoint as _markers  # noqa: F401 (allow-lists them)
    try:
        torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    except Exception as error:  # any unloadable file is a finding
        return [f"{path}: {type(error).__name__}: {error}"]
    return []


def verify_checkpoint(folder: AnyPath,
                      checkpoint_name: str = "checkpoint.th"
                      ) -> tp.Dict[str, tp.Any]:
    """Integrity report over an XP folder's checkpoints (both forms).

    Returns ``{"single": problems|None, "slots": {slot: problems},
    "active": slot|None, "restorable": bool}``; None entries mean that
    form does not exist. A file or slot that verifies is also loaded
    with `weights_only=True` (`load_problems`). `restorable` is True
    when at least one verified source exists (the active slot, a
    fallback sibling or the single file). Read-only; the engine behind
    ``python -m flashy_tpu_torch.info --verify-checkpoint``.
    """
    from ..checkpoint import SLOTS, read_slot_pointer
    folder = Path(folder)
    report: tp.Dict[str, tp.Any] = {"single": None, "slots": {},
                                    "active": None, "restorable": False}
    single = folder / checkpoint_name
    if single.exists():
        report["single"] = verify_file(single) or load_problems(single)
        if not report["single"]:
            report["restorable"] = True
    sharded = folder / (checkpoint_name + ".sharded")
    if sharded.is_dir():
        report["active"] = read_slot_pointer(sharded)
        for slot in SLOTS:
            slot_dir = sharded / slot
            if not (slot_dir / "state.pkl").exists():
                continue
            problems = verify_slot(slot_dir)
            if not problems:
                for path in _payload_files(slot_dir):
                    problems += load_problems(path)
            report["slots"][slot] = problems
            if not problems:
                report["restorable"] = True
    return report
