"""Time variants of the grouped-GEMM kernels in turns, on one card.

    python3 tools/gmm_variants.py NAME=CSRC_DIR [NAME=CSRC_DIR ...]

Each variant is a directory holding a copy of flashy_tpu_torch/csrc,
edited as the experiment needs (make it under a directory that
.gitignore lists, such as build/). The script builds each variant's
grouped_matmul library, holds each against the plain versions on
`chip_smoke.check_gmm_kernels`' cases (a variant that misses a bar is
reported and still timed), then times the six launches of a layer at the
training shapes (`chip_smoke.gmm_training_launches`; `time_runs`, device
time, three timings each) for every variant in turns, twice, the second
pass in reverse order, and prints each launch's medians per variant.
Run it on the machine with the card.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from flashy_tpu_torch.ops import _build  # noqa: E402
from flashy_tpu_torch.ops import grouped_matmul as G  # noqa: E402


def load(csrc: Path, name: str):
    """The grouped library built from `csrc`, under build/ (gitignored)."""
    _build.CSRC = csrc
    _build.BUILD_DIR = ROOT / "build" / "gmm_variants" / name
    _build._loaded.pop("grouped_matmul", None)
    t0 = time.perf_counter()
    lib = _build.load("grouped_matmul", G._FUNCTIONS)
    info = _build.build_info.get("grouped_matmul")
    notes = [line.strip() for line in (info[1] if info else "").splitlines()
             if "C75" in line or "spill stores" in line and " 0 bytes spill"
             not in line]
    print(f"built {name} in {time.perf_counter() - t0:.1f}s"
          + "".join(f"\n  {note[:200]}" for note in notes), flush=True)
    return lib


def main() -> None:
    if len(sys.argv) < 2 or any("=" not in a for a in sys.argv[1:]):
        sys.exit(__doc__)
    variants = [a.split("=", 1) for a in sys.argv[1:]]
    card = C.card_line()
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {name: load(Path(csrc).resolve(), name) for name, csrc in variants}
    for name, lib in libs.items():
        _build._loaded["grouped_matmul"] = lib
        try:
            C.check_gmm_kernels(torch, device, card)
            print(f"{name}: every case within the bars", flush=True)
        except SystemExit:
            print(f"{name}: MISSES a bar (the FAIL line above)", flush=True)
    launches = C.gmm_training_launches(torch, device)[5]
    times = {(name, label): [] for name in libs for _, label, *_ in launches}
    order = list(libs)
    for sweep in (order, order[::-1]):
        for name in sweep:
            _build._loaded["grouped_matmul"] = libs[name]
            for _, label, kernel, *_ in launches:
                times[name, label].append(
                    C.time_runs(torch, kernel, iters=20)["ms"])
    for _, label, *_ in launches:
        print(f"{label}: " + "; ".join(
            f"{name} " + "/".join(f"{ms:.4f}" for ms in times[name, label])
            for name in libs) + f" [{card}]", flush=True)


if __name__ == "__main__":
    main()
