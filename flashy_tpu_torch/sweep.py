"""Grid sweeps over config overrides: expand, print, or run (the port of
flashy_tpu/sweep.py).

A cartesian-product expander over the `key=value` override syntax the
CLI speaks; each point is one XP, and the signature machinery
(`flashy_tpu_torch.xp`) dedupes and reuses folders as for single runs.
"""
import argparse
import itertools
import subprocess
import sys
import typing as tp


def expand_grid(overrides: tp.Sequence[str]) -> tp.List[tp.List[str]]:
    """Expand `key=v1,v2` overrides into the cartesian product.

    >>> expand_grid(["lr=0.1,0.3", "dim=256"])
    [['lr=0.1', 'dim=256'], ['lr=0.3', 'dim=256']]

    Plain `key=value` (no comma) passes through to every point. A comma
    inside brackets is NOT split (list-valued overrides).
    """
    axes: tp.List[tp.List[str]] = []
    for override in overrides:
        if "=" not in override:
            raise ValueError(
                f"Expected key=value[,value...], got: {override!r}")
        key, _, values = override.partition("=")
        if values.startswith("[") or "," not in values:
            axes.append([override])
        else:
            axes.append([f"{key}={v}" for v in values.split(",") if v != ""])
    return [list(point) for point in itertools.product(*axes)]


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m flashy_tpu_torch.sweep",
        description="Run a command once per grid point. Everything after "
                    "'--' is the command; grid axes are key=v1,v2 overrides "
                    "appended per point.")
    parser.add_argument("--dry-run", action="store_true",
                        help="print each point's command, run nothing")
    parser.add_argument("--keep-going", action="store_true",
                        help="run every point even after a failure")
    parser.add_argument("overrides", nargs="*",
                        help="grid axes, e.g. lr=1e-3,3e-4 model.dim=256,512")

    from .launch import split_command
    argv, command = split_command(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv)
    if not command:
        parser.error("no command given; put it after '--'")

    points = expand_grid(args.overrides)
    code = 0
    for index, point in enumerate(points):
        full = list(command) + point
        print(f"[sweep {index + 1}/{len(points)}] {' '.join(full)}",
              file=sys.stderr)
        if args.dry_run:
            print(" ".join(full))
            continue
        result = subprocess.call(full)
        if result:
            code = code or result
            if not args.keep_going:
                return code
    return code


if __name__ == "__main__":
    sys.exit(main())
