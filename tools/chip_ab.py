"""A/B of two checkouts of the repo on one CUDA card, in turns.

    python3 tools/chip_ab.py OTHER [THIS] [--phases train,ring,moe,serve]

Runs each checkout's own `chip_smoke.py` phases in a process of its own,
in the order OTHER, THIS, THIS, OTHER, and prints the phases' lines
under a header per run. The phases (by default `train,ring`): `train`
and `ring` (`train` and `ring train`, each followed by its profiled
window), `moe` (`moe train` and its profiled window, with the grouped
kernels' device ms a step) and `serve` (`serve bf16`, the paged serving
leg and its profile). THIS defaults to the checkout this script lives
in. Run it on the machine with the card, from anywhere; make OTHER with
`git archive <commit> | tar -x -C <dir>` (a directory that .gitignore
lists, such as build/). Compare the two trees only inside one run: the
same card, in turns.
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

HEAD = '''
import sys, tempfile, torch
sys.path.insert(0, ".")
import chip_smoke as C
card = C.card_line()
torch.backends.cuda.matmul.allow_tf32 = False
'''
PHASES = {
    "train": '''
with tempfile.TemporaryDirectory() as folder:
    _, solver = C.phase_train(torch, card, folder)
    C.profile_train(torch, solver, card, watch=("flash_fwd_kernel", "flash_bwd"))
    del solver
''',
    "ring": '''
with tempfile.TemporaryDirectory() as folder:
    _, solver = C.phase_ring_train(torch, card, folder)
    C.profile_train(torch, solver, card, steps=3, label="profile ring train",
                    watch=("ring_fwd_kernel", "flash_bwd"))
    del solver
''',
    # "grouped_" names every grouped kernel of either tree
    "moe": '''
with tempfile.TemporaryDirectory() as folder:
    _, solver = C.phase_moe_train(torch, card, folder)
    C.profile_train(torch, solver, card, steps=3, label="profile moe train",
                    watch=("grouped_", "split_bf16_kernel"))
    del solver
''',
    "serve": '''
C.phase_serve(torch, torch.device("cuda"), card, kv_dtype="model",
              requests_n=16, prompt_len=128, max_new=128, label="serve bf16")
''',
}
KEEP = ("train:", "profile", "ring train:", "moe train:", "serve bf16",
        "FAIL")


def main() -> None:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("other")
    parser.add_argument("this", nargs="?",
                        default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--phases", default="train,ring")
    args = parser.parse_args()
    phases = args.phases.split(",")
    unknown = [p for p in phases if p not in PHASES]
    if unknown:
        sys.exit(f"unknown phases {unknown}; known: {sorted(PHASES)}")
    code = HEAD + "".join(PHASES[p] for p in phases)
    trees = {"other": Path(args.other), "this": Path(args.this)}
    for name, tree in trees.items():
        if not (tree / "chip_smoke.py").is_file():
            sys.exit(f"{name} checkout {tree} holds no chip_smoke.py")
    for name in ("other", "this", "this", "other"):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-c", code],
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
