"""`python -m flashy_tpu_torch.info [root]`: list the experiments under an
output root with their signatures, override argv, progress and last
metrics (the port of flashy_tpu/info.py).

    python -m flashy_tpu_torch.info ./outputs_torch [-v]
    python -m flashy_tpu_torch.info ./outputs_torch --verify-checkpoint
    python -m flashy_tpu_torch.info --devices

`--verify-checkpoint` loads each XP's single-file `checkpoint.th` with
`checkpoint.load_state` and reports it; `--devices` reads
`torch.cuda.mem_get_info` for every CUDA device. The fault-site report
(`--faults`), the SLO table (`--slo`), heartbeat telemetry and the
fleet view come with the modules they read, which the port does not
have yet: they raise NotImplementedError naming their ROADMAP entries.
"""
import argparse
import json
import typing as tp
from pathlib import Path

TODO_RESILIENCE = "ROADMAP.md queue A item 9 (resilience/)"
TODO_OBSERVABILITY = "ROADMAP.md queue A item 9 (observability/)"
TODO_FLEET = "ROADMAP.md queue A item 10 (serve/fleet/)"

CHECKPOINT_META_NAME = "checkpoint_meta.json"
HEARTBEAT_DIR_NAME = "heartbeats"
SERVE_STATUS_NAME = "serve.json"
FLEET_STATUS_NAME = "fleet.json"


def _read_json(path: Path) -> tp.Any:
    with open(path) as f:
        return json.load(f)


def collect(root: Path) -> tp.Iterator[tp.Dict[str, tp.Any]]:
    """Yield {sig, cfg, argv, history, telemetry, serve, fleet,
    checkpoint} per XP under `root`."""
    from .xp import CONFIG_SNAPSHOT_NAME, RUN_INFO_NAME, Link
    xps_dir = Path(root) / "xps"
    if not xps_dir.is_dir():
        return
    for folder in sorted(xps_dir.iterdir()):
        if not folder.is_dir():
            continue
        if (folder / HEARTBEAT_DIR_NAME).is_dir():
            raise NotImplementedError(
                f"{folder / HEARTBEAT_DIR_NAME}: heartbeat telemetry is not "
                f"ported yet: {TODO_OBSERVABILITY}")
        entry: tp.Dict[str, tp.Any] = {
            "sig": folder.name, "cfg": {}, "argv": [], "history": [],
            "telemetry": {}, "serve": {}, "fleet": {}, "checkpoint": {}}
        for key, name in (("checkpoint", CHECKPOINT_META_NAME),
                          ("cfg", CONFIG_SNAPSHOT_NAME),
                          ("serve", SERVE_STATUS_NAME),
                          ("fleet", FLEET_STATUS_NAME)):
            if (folder / name).exists():
                entry[key] = _read_json(folder / name)
        if (folder / RUN_INFO_NAME).exists():
            entry["argv"] = _read_json(folder / RUN_INFO_NAME).get("argv", [])
        entry["history"] = Link(folder).load()
        yield entry


def format_entry(entry: tp.Mapping[str, tp.Any],
                 verbose: bool = False) -> str:
    """One XP as the JAX package's `info` prints it: sig, epochs, argv,
    the last epoch's first four numeric metrics a stage, then the serve,
    fleet and checkpoint views and (verbose) the config."""
    history = entry["history"]
    line = f"{entry['sig']}  epochs={len(history)}"
    if entry["argv"]:
        line += "  [" + " ".join(entry["argv"]) + "]"
    if history:
        parts = []
        for stage, metrics in history[-1].items():
            if isinstance(metrics, dict):
                numeric = [(k, v) for k, v in metrics.items()
                           if isinstance(v, (int, float))]
                shown = {k: round(v, 4) for k, v in numeric[:4]}
                parts.append(f"{stage}: {shown}")
        if parts:
            line += "  " + " | ".join(parts)
    if entry.get("serve"):
        line += "\n  serve: " + format_serve_status(entry["serve"])
    if entry.get("fleet"):
        line += "\n  fleet: " + format_fleet_status(entry["fleet"])
    if entry.get("checkpoint"):
        line += "\n  checkpoint: " + format_checkpoint_meta(
            entry["checkpoint"])
    if verbose:
        line += "\n  cfg: " + json.dumps(entry["cfg"], default=str)[:500]
    return line


def format_serve_status(status: tp.Mapping[str, tp.Any]) -> str:
    """One-line view of a `serve.json` snapshot: request tallies, TTFT
    and inter-token latency percentiles, SLO alerts, occupancy, the
    speculative acceptance, the cache layout and the pool. Unknown keys
    are ignored, so the snapshot can grow."""
    parts = []
    for key in ("requests", "completed", "rejected", "expired"):
        if key in status:
            parts.append(f"{key}={int(status[key])}")
    for base in ("ttft_ms", "itl_ms"):
        for key in sorted((k for k in status
                           if k.startswith(f"{base}_p")
                           and isinstance(status[k], (int, float))),
                          key=lambda k: float(k.rsplit("_p", 1)[1])):
            parts.append(f"{key}={status[key]:.1f}")
    if status.get("slo", {}).get("alerting"):
        burning = [name for name, budget
                   in status["slo"].get("budgets", {}).items()
                   if budget.get("alerting")]
        parts.append("SLO-ALERT[" + ",".join(burning) + "]")
    if "occupancy_p50" in status:
        parts.append(f"occupancy_p50={status['occupancy_p50'] * 100:.0f}%")
    if "acceptance_rate" in status:
        parts.append(f"acceptance={status['acceptance_rate'] * 100:.0f}%")
        if "accepted_per_step_p50" in status:
            parts.append("accepted_per_step_p50="
                         f"{status['accepted_per_step_p50']:.1f}")
    if status.get("cache_layout"):
        layout = str(status["cache_layout"])
        if status.get("kv_dtype"):
            layout += f"/{status['kv_dtype']}"
        parts.append(f"cache={layout}")
    if "state_bytes_per_slot" in status:
        parts.append(
            f"state_bytes_per_slot={int(status['state_bytes_per_slot'])}")
    if "pool_occupancy_p50" in status:
        parts.append(f"pool_p50={status['pool_occupancy_p50'] * 100:.0f}%")
    if "pool_occupancy_p95" in status:
        parts.append(f"pool_p95={status['pool_occupancy_p95'] * 100:.0f}%")
    if "prefix_hit_rate" in status:
        parts.append(f"prefix_hit={status['prefix_hit_rate'] * 100:.0f}%")
    return "  ".join(parts) or "(empty serve.json)"


def format_fleet_status(status: tp.Mapping[str, tp.Any]) -> str:
    """The fleet's topology view: comes with the serving fleet."""
    raise NotImplementedError(
        f"the fleet view (fleet.json) is not ported yet: {TODO_FLEET}")


def format_checkpoint_meta(meta: tp.Mapping[str, tp.Any]) -> str:
    """One-line view of a `checkpoint_meta.json` snapshot: the save mode
    and the state-sharding layout."""
    parts = []
    if meta.get("mode"):
        parts.append(f"mode={meta['mode']}")
    sharding = meta.get("state_sharding") or {}
    summary = sharding.get("summary") or sharding.get("mode")
    if summary:
        parts.append(f"state-sharding={summary}")
    return "  ".join(parts) or "(empty checkpoint_meta.json)"


def format_topology(topology: tp.Optional[tp.Mapping[str, tp.Any]]) -> str:
    """One-line summary of the topology a checkpoint was saved on."""
    if not topology:
        return "unknown (no topology metadata)"
    parts = [f"{topology.get('device_count', '?')} device(s)"]
    mesh = topology.get("mesh")
    if mesh:
        axes = ",".join(f"{name}={size}" for name, size
                        in zip(mesh["axis_names"], mesh["shape"])
                        if int(size) != 1) or "1-chip"
        parts.append(f"mesh({axes})")
    if topology.get("state_sharding"):
        parts.append(f"state={topology['state_sharding']}")
    if topology.get("world_size", 1) != 1:
        parts.append(f"{topology['world_size']} host(s)")
    return " ".join(parts)


def format_verify_report(sig: str, report: tp.Mapping[str, tp.Any],
                         topology: tp.Optional[tp.Mapping] = None,
                         live_devices: tp.Optional[int] = None) -> str:
    """One-line view of a checkpoint report (`verify_checkpoint`): every
    checkpoint form found (the single file; A/B slots with the active
    one starred), whether a restore source remains, the saved topology
    where the checkpoint has one, and a WARN when the live device count
    differs from it."""
    parts = []
    if report["single"] is not None:
        parts.append("single=" + ("OK" if not report["single"]
                                  else "CORRUPT"))
    for slot, problems in sorted(report["slots"].items()):
        label = f"{slot}={'OK' if not problems else 'CORRUPT'}"
        if slot == report.get("active"):
            label += "*"
        parts.append(label)
    if not parts:
        return f"{sig}  no checkpoints"
    verdict = "restorable" if report["restorable"] else "NOT RESTORABLE"
    line = f"{sig}  {' '.join(parts)}  -> {verdict}"
    if topology:
        line += f"\n  topology: saved on {format_topology(topology)}"
        saved_devices = topology.get("device_count")
        if (live_devices is not None and saved_devices is not None
                and int(saved_devices) != int(live_devices)):
            line += (f"\n  WARN: live mesh has {live_devices} device(s) "
                     f"but the checkpoint was saved on {saved_devices} — "
                     "restore will reshard (elastic resume)")
    problems = list(report["single"] or [])
    for slot_problems in report["slots"].values():
        problems += slot_problems
    for problem in problems:
        line += f"\n  ! {problem}"
    return line


def verify_checkpoint(folder: Path, checkpoint_name: str = "checkpoint.th"
                      ) -> tp.Dict[str, tp.Any]:
    """The report `format_verify_report` reads for one XP folder: the
    single-file checkpoint loaded with `checkpoint.load_state` (problems
    [] when it loads, None when there is none). The port writes no
    sharded slots yet, so `slots` is empty."""
    from .checkpoint import load_state
    report: tp.Dict[str, tp.Any] = {"single": None, "slots": {},
                                    "active": None, "restorable": False}
    path = Path(folder) / checkpoint_name
    if path.exists():
        try:
            load_state(path)
            report["single"] = []
            report["restorable"] = True
        except Exception as error:  # any unreadable file is a finding
            report["single"] = [f"{path}: {type(error).__name__}: {error}"]
    return report


def verify_checkpoints(root: Path) -> int:
    """Check every XP's checkpoint under `root`; the exit code is 1 when
    an XP has a checkpoint that does not load, or when `root` holds no
    experiments; 0 otherwise (XPs without checkpoints are fine)."""
    xps_dir = Path(root) / "xps"
    if not xps_dir.is_dir():
        print(f"no experiments under {root}/xps")
        return 1
    bad = 0
    for folder in sorted(xps_dir.iterdir()):
        if not folder.is_dir():
            continue
        report = verify_checkpoint(folder)
        print(format_verify_report(folder.name, report))
        if report["single"] is not None and not report["restorable"]:
            bad += 1
    return 1 if bad else 0


def fault_site_report(strict: bool = False) -> int:
    """The fault-injection sites and their campaign coverage: comes with
    the resilience package."""
    raise NotImplementedError(
        f"the fault-site report is not ported yet: {TODO_RESILIENCE}")


def format_device_stats() -> str:
    """Free and total memory of this host's CUDA devices
    (`torch.cuda.mem_get_info`)."""
    import torch
    if not torch.cuda.is_available():
        return "no devices"
    lines = []
    for index in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(index)
        lines.append(f"device {index} [cuda] "
                     f"{torch.cuda.get_device_name(index)}  "
                     f"in_use={(total - free) / 2 ** 30:.2f}G  "
                     f"limit={total / 2 ** 30:.2f}G")
    return "\n".join(lines)


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m flashy_tpu_torch.info",
        description="List flashy_tpu_torch experiments under an output "
                    "root.")
    parser.add_argument("root", nargs="?", default="./outputs_torch",
                        help="output root (the folder containing xps/)")
    parser.add_argument("-v", "--verbose", action="store_true",
                        help="also print each XP's config")
    parser.add_argument("-d", "--devices", action="store_true",
                        help="also print each CUDA device's memory in use")
    parser.add_argument("--slo", action="store_true",
                        help="render each XP's SLO table (not ported yet)")
    parser.add_argument("--verify-checkpoint", action="store_true",
                        help="load every XP's checkpoint.th; exit 1 when one "
                             "does not load (or when no experiments exist "
                             "under the root)")
    parser.add_argument("--faults", action="store_true",
                        help="list the fault-injection sites (not ported "
                             "yet)")
    parser.add_argument("--strict", action="store_true",
                        help="with --faults: exit 1 on an uncovered site")
    args = parser.parse_args(argv)

    if args.faults:
        return fault_site_report(strict=args.strict)
    if args.slo:
        raise NotImplementedError(
            f"--slo is not ported yet: {TODO_OBSERVABILITY}")
    if args.verify_checkpoint:
        return verify_checkpoints(Path(args.root))
    if args.devices:
        print(format_device_stats())

    found = False
    for entry in collect(Path(args.root)):
        found = True
        print(format_entry(entry, verbose=args.verbose))
    if not found:
        print(f"no experiments under {args.root}/xps")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
