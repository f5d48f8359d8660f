"""A/B of two checkouts of the repo on one CUDA card, in turns.

    python3 tools/chip_ab.py OTHER [THIS]

Runs each checkout's own `chip_smoke.py` training phases (`train` and
`ring train`, each followed by its profiled window) in a process of its
own, in the order OTHER, THIS, THIS, OTHER, and prints the phases' lines
under a header per run. THIS defaults to the checkout this script lives
in. Run it on the machine with the card, from anywhere; make OTHER with
`git archive <commit> | tar -x -C <dir>` (a directory that .gitignore
lists, such as build/). Compare the two trees only inside one run: the
same card, in turns.
"""
import subprocess
import sys
import time
from pathlib import Path

PHASES = '''
import sys, tempfile, torch
sys.path.insert(0, ".")
import chip_smoke as C
card = C.card_line()
torch.backends.cuda.matmul.allow_tf32 = False
with tempfile.TemporaryDirectory() as folder:
    _, solver = C.phase_train(torch, card, folder)
    C.profile_train(torch, solver, card, watch=("flash_fwd_kernel", "flash_bwd"))
    del solver
with tempfile.TemporaryDirectory() as folder:
    _, solver = C.phase_ring_train(torch, card, folder)
    C.profile_train(torch, solver, card, steps=3, label="profile ring train",
                    watch=("ring_fwd_kernel", "flash_bwd"))
'''
KEEP = ("train:", "profile", "ring train:", "FAIL")


def main() -> None:
    if len(sys.argv) not in (2, 3):
        sys.exit(__doc__)
    this = Path(sys.argv[2] if len(sys.argv) == 3 else
                Path(__file__).resolve().parents[1])
    trees = {"other": Path(sys.argv[1]), "this": this}
    for name, tree in trees.items():
        if not (tree / "chip_smoke.py").is_file():
            sys.exit(f"{name} checkout {tree} holds no chip_smoke.py")
    for name in ("other", "this", "this", "other"):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-c", PHASES],
                             cwd=trees[name], capture_output=True, text=True)
        print(f"=== {name} {trees[name]} (exit {run.returncode}, "
              f"{time.perf_counter() - t0:.0f}s)", flush=True)
        for line in run.stdout.splitlines():
            if line.startswith(KEEP):
                print(line, flush=True)
        if run.returncode:
            print(run.stderr[-2000:], flush=True)
            sys.exit(run.returncode)


if __name__ == "__main__":
    main()
