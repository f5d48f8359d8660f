"""Time variants of one kernel library in turns, on one card.

    python3 tools/variants.py KIND NAME=CSRC_DIR [NAME=CSRC_DIR ...]
    python3 tools/variants.py flash_bwd --stress [CSRC_DIR]

KIND names the library and what it is held to and timed on:

- `flash_bwd`: flash_attention, held to `chip_smoke.check_flash_kernels`;
  the fused, split dQ and split dK/dV backward kernels at the training
  shapes (B 16, H 16, T 1024, D 64, causal, bf16);
- `gmm`: grouped_matmul, held to `chip_smoke.check_gmm_kernels`; the
  six launches of a layer at the training shapes
  (`chip_smoke.gmm_training_launches`);
- `paged`: paged_decode, held to `chip_smoke.check_kernels`; the serving
  reads (8 slots x 16 heads x 64, block 16, seeded pools; bf16 and int8:
  T=1 at context 192, T=16 at context 128, and a prefill chunk's one
  slot at T=16);
- `ssd`: ssd_scan, held to `chip_smoke.check_ssd_kernel`; the main
  path's `ssd_chunked_scan` call (`chip_smoke.time_ssd`'s inputs: bf16
  projection slices with a padding mask and a carried state, chunk 64)
  at `chip_smoke.SSD_SHAPES` and at a longer prompt, [1, 4096].

Each variant is a directory holding a copy of flashy_tpu_torch/csrc,
edited as the experiment needs (make it under a directory that
.gitignore lists, such as build/). The script builds each variant's
library (printing ptxas's register, spill and wgmma-serialization
lines), holds it to the check (a variant that misses a bar is reported
and still timed), then times every case of every variant in turns,
twice, the second pass in reverse order (`chip_smoke.time_runs`, device
time, the median of three timings), and prints each case's medians per
variant.

With --stress, flash_bwd launches the fused backward of one source (by
default the checkout's) hundreds of times over six shapes and counts the
launches whose gradients are not bit-equal to the split pair's (a race
in the fused kernel's dQ chain would show there). A variant whose kernel
traps takes the process's CUDA context with it, so time a racy variant
alone. Run it on the machine with the card.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from flashy_tpu_torch.ops import _build  # noqa: E402

STRESS_CASES = ((16, 16, 1024, 1024, True), (2, 4, 320, 128, True),
                (1, 4, 100, 164, False), (8, 16, 512, 512, True),
                (8, 16, 512, 512, False), (3, 5, 777, 777, True))


def flash_gradient_args(B, H, t_q, t_k, causal, seed):
    from flashy_tpu_torch.ops import attention as A
    q, k, v, do = C.flash_inputs(torch, torch.device("cuda"),
                                 torch.bfloat16, B, H, t_q, t_k, seed=seed)
    out, lse = A.flash_forward(q, k, v, causal)
    return (q, k, v, do, lse, A.flash_delta(do, out), causal)


def flash_cases(device):
    from flashy_tpu_torch.ops import attention as A
    args = flash_gradient_args(16, 16, 1024, 1024, True, seed=7)
    return [("fused", lambda: A.flash_backward_fused(*args)),
            ("dq", lambda: A._launch_backward(A._BWD_DQ, *args)),
            ("dkv", lambda: A._launch_backward(A._BWD_DKV, *args))]


def gmm_cases(device):
    launches = C.gmm_training_launches(torch, device)[5]
    return [(label, kernel) for _, label, kernel, *_ in launches]


def paged_cases(device):
    from flashy_tpu_torch.models.quantize import quantize_kv
    from flashy_tpu_torch.ops import paged_decode as P
    g = torch.Generator(device=device).manual_seed(0)
    B, H, D, bs, E = 8, 16, 64, 16, 16
    out = []
    for kv in ("bf16", "int8"):
        k, v = (torch.randn((1 + B * E, bs, H, D), generator=g,
                            device=device) for _ in range(2))
        if kv == "int8":
            (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
            entry = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            entry = {"k": k.bfloat16(), "v": v.bfloat16()}
        for slots, T, ctx in ((B, 1, 192), (B, 16, 128), (1, 16, 128)):
            live = -(-ctx // bs)
            table = torch.zeros((slots, E), dtype=torch.int32, device=device)
            table[:, :live] = 1 + torch.arange(
                slots * live, device=device).view(slots, live)
            q = torch.randn((slots, T, H, D), generator=g,
                            device=device).bfloat16()
            positions = (ctx - T + torch.arange(T, device=device)).expand(
                slots, T)
            out.append((f"{kv} B={slots} T={T} context {ctx}",
                        lambda a=(q, entry, table, positions):
                        P.fused_paged_attention(*a, head_dim=D,
                                                dtype=torch.bfloat16)))
    return out


def ssd_cases(device):
    from flashy_tpu_torch.ops.ssd_scan import ssd_chunked_scan
    out = []
    for B, T in C.SSD_SHAPES + ((1, 4096),):
        c, b, v, log_a, state, mask = C.ssd_inputs(
            torch, device, torch.bfloat16, B, T, seed=5, proj=True)
        out.append((f"ssd [{B}, {T}]",
                    lambda a=(c, b, v, log_a), s=state, m=mask:
                    ssd_chunked_scan(*a, state=s, chunk=C.SSD_CHUNK,
                                     token_mask=m, kernel="fused")))
    return out


# KIND: (library, module holding its `_FUNCTIONS`, check, cases, iters)
KINDS = {
    "flash_bwd": ("flash_attention", "attention", C.check_flash_kernels,
                  flash_cases, 20),
    "gmm": ("grouped_matmul", "grouped_matmul", C.check_gmm_kernels,
            gmm_cases, 20),
    "paged": ("paged_decode", "paged_decode", C.check_kernels, paged_cases,
              50),
    "ssd": ("ssd_scan", "ssd_scan", C.check_ssd_kernel, ssd_cases, 20),
}


def load(kind: str, csrc: Path, name: str):
    """KIND's library built from `csrc`, under build/ (gitignored)."""
    import importlib
    library, module = KINDS[kind][:2]
    functions = importlib.import_module(
        f"flashy_tpu_torch.ops.{module}")._FUNCTIONS
    _build.CSRC = csrc
    _build.BUILD_DIR = ROOT / "build" / "variants" / kind / name
    _build._loaded.pop(library, None)
    t0 = time.perf_counter()
    lib = _build.load(library, functions)
    info = _build.build_info.get(library)
    notes = [line.strip() for line in (info[1] if info else "").splitlines()
             if "Used" in line or "C75" in line or "spill stores" in line
             and " 0 bytes spill" not in line]
    print(f"built {name} in {time.perf_counter() - t0:.1f}s"
          + "".join(f"\n  {note[:200]}" for note in notes), flush=True)
    return lib


def compare(kind, variants, card):
    library, _, check, cases_of, iters = KINDS[kind]
    device = torch.device("cuda")
    libs = {name: load(kind, Path(csrc).resolve(), name)
            for name, csrc in variants}
    for name, lib in libs.items():
        _build._loaded[library] = lib
        try:
            check(torch, device, card)
            print(f"{name}: every case within the bars", flush=True)
        except SystemExit:
            print(f"{name}: MISSES a bar (the FAIL line above)", flush=True)
    cases = cases_of(device)
    times = {(name, label): [] for name in libs for label, _ in cases}
    order = list(libs)
    for sweep in (order, order[::-1]):
        for name in sweep:
            _build._loaded[library] = libs[name]
            for label, call in cases:
                times[name, label].append(
                    C.time_runs(torch, call, iters=iters)["ms"])
    for label, _ in cases:
        print(f"{label}: " + "; ".join(
            f"{name} " + "/".join(f"{ms:.4f}" for ms in times[name, label])
            for name in libs) + f" [{card}]", flush=True)


def stress(csrc, card):
    from flashy_tpu_torch.ops import attention as A
    load("flash_bwd", csrc, "stress")
    for B, H, t_q, t_k, causal in STRESS_CASES:
        args = flash_gradient_args(B, H, t_q, t_k, causal, seed=t_q)
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
    args = sys.argv[1:]
    if not args or args[0] not in KINDS:
        sys.exit(__doc__)
    kind, rest = args[0], args[1:]
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = C.card_line()
    t0 = time.perf_counter()
    if kind == "flash_bwd" and rest[:1] == ["--stress"]:
        stress(Path(rest[1]).resolve() if len(rest) > 1 else _build.CSRC,
               card)
    elif rest and all("=" in a for a in rest):
        compare(kind, [a.split("=", 1) for a in rest], card)
    else:
        sys.exit(__doc__)
    print(f"[{time.perf_counter() - t0:.0f}s]", flush=True)


if __name__ == "__main__":
    main()
