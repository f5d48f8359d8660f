"""Time variants of the bf16 flash backward kernels in turns, on one card.

    python3 tools/flash_bwd_variants.py NAME=CSRC_DIR [NAME=CSRC_DIR ...]
    python3 tools/flash_bwd_variants.py --stress [CSRC_DIR]

Each variant is a directory holding a copy of flashy_tpu_torch/csrc,
edited as the experiment needs (make it under a directory that
.gitignore lists, such as build/). The script builds each variant into a
library of its own, then times the fused, split dQ and split dK/dV
kernels of every variant at the training shapes (B 16, H 16, T 1024, D
64, causal, bf16; `chip_smoke.time_runs`, device time, three timings
each) twice, the second pass in reverse order, and prints each kernel's
median and every timing, and whether the variant's fused gradient is
bit-equal to the first variant's split pair. With --stress it launches
the kernels of one source (by default the checkout's) hundreds of times
over six shapes and counts the launches whose gradients are not
bit-equal to the split pair's (a race in the fused kernel's dQ chain
would show there). Run it on the machine with the card; a variant whose
kernel traps takes the process's CUDA context with it, so time a racy
variant alone.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from flashy_tpu_torch.ops import _build  # noqa: E402
from flashy_tpu_torch.ops import attention as A  # noqa: E402

STRESS_CASES = ((16, 16, 1024, 1024, True), (2, 4, 320, 128, True),
                (1, 4, 100, 164, False), (8, 16, 512, 512, True),
                (8, 16, 512, 512, False), (3, 5, 777, 777, True))


def load(csrc: Path, name: str):
    """The flash library built from `csrc`, under build/ (gitignored)."""
    _build.CSRC = csrc
    _build.BUILD_DIR = ROOT / "build" / "flash_bwd_variants" / name
    _build._loaded.pop("flash_attention", None)
    return _build.load("flash_attention", A._FUNCTIONS)


def gradient_args(B, H, t_q, t_k, causal, seed):
    q, k, v, do = C.flash_inputs(torch, torch.device("cuda"),
                                 torch.bfloat16, B, H, t_q, t_k, seed=seed)
    out, lse = A.flash_forward(q, k, v, causal)
    return (q, k, v, do, lse, A.flash_delta(do, out), causal)


def compare(variants, card):
    libs = {name: load(csrc, name) for name, csrc in variants}
    _build._loaded["flash_attention"] = libs[variants[0][0]]
    args = gradient_args(16, 16, 1024, 1024, True, seed=7)
    want = A.flash_backward_split(*args)
    kernels = {"fused": lambda: A.flash_backward_fused(*args),
               "dq": lambda: A._launch_backward(A._BWD_DQ, *args),
               "dkv": lambda: A._launch_backward(A._BWD_DKV, *args)}
    runs = {}
    for order in (variants, variants[::-1]):
        for name, _ in order:
            _build._loaded["flash_attention"] = libs[name]
            for kind, fn in kernels.items():
                runs.setdefault((name, kind), []).extend(
                    C.time_runs(torch, fn, iters=20)["ms_runs"])
    for name, _ in variants:
        _build._loaded["flash_attention"] = libs[name]
        line = f"{name}:"
        for kind in kernels:
            got = sorted(runs[(name, kind)])
            line += (f" {kind} median {got[len(got) // 2]:.4f} ("
                     + "/".join(f"{x:.4f}" for x in got) + ")")
        same = [torch.equal(a, b)
                for a, b in zip(A.flash_backward_fused(*args), want)]
        print(f"{line}; fused == split {same} [{card}]", flush=True)


def stress(csrc, card):
    load(csrc, "stress")
    for B, H, t_q, t_k, causal in STRESS_CASES:
        args = gradient_args(B, H, t_q, t_k, causal, seed=t_q)
        want = A.flash_backward_split(*args)
        n, bad = (300 if t_q >= 512 else 100), 0
        for i in range(n):
            got = A.flash_backward_fused(*args)
            if i % 25 == 0 or i == n - 1:
                bad += sum(not torch.equal(a, b) for a, b in zip(got, want))
        for _ in range(50):
            got = A.flash_backward_split(*args)
        bad += sum(not torch.equal(a, b) for a, b in zip(got, want))
        torch.cuda.synchronize()
        print(f"stress B={B} H={H} t_q={t_q} t_k={t_k} causal={causal}: "
              f"{n} fused + 50 split launches, {bad} results not bit-equal "
              f"to the split pair [{card}]", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = C.card_line()
    t0 = time.perf_counter()
    if sys.argv[1:2] == ["--stress"]:
        stress(Path(sys.argv[2]) if len(sys.argv) > 2 else _build.CSRC, card)
    else:
        variants = [(spec.split("=", 1)[0], Path(spec.split("=", 1)[1]))
                    for spec in sys.argv[1:]]
        if not variants or any(not (csrc / "flash_attention.cu").is_file()
                               for _, csrc in variants):
            sys.exit(__doc__)
        compare(variants, card)
    print(f"[{time.perf_counter() - t0:.0f}s]", flush=True)


if __name__ == "__main__":
    main()
