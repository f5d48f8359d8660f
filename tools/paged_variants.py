"""Time variants of the paged-attention kernel in turns, on one card.

    python3 tools/paged_variants.py NAME=CSRC_DIR [NAME=CSRC_DIR ...]

Each variant is a directory holding a copy of flashy_tpu_torch/csrc,
edited as the experiment needs (make it under a directory that
.gitignore lists, such as build/). The script builds each variant's
paged_decode library, holds it against the plain version and the
entry-by-entry reference on `chip_smoke.check_kernels`' cases (a variant
that misses a bar is reported and still timed), then times the serving
reads (8 slots x 16 heads x 64, block 16, seeded pools; bf16 and int8:
T=1 at context 192, T=16 at context 128, and a prefill chunk's one slot
at T=16; `time_runs`, device time, three timings each) for every
variant in turns, twice, the second pass in reverse order, and prints
each read's medians per variant. Run it on the machine with the card.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from flashy_tpu_torch.models.quantize import quantize_kv  # noqa: E402
from flashy_tpu_torch.ops import _build  # noqa: E402
from flashy_tpu_torch.ops import paged_decode as P  # noqa: E402


def load(csrc: Path, name: str):
    """The paged library built from `csrc`, under build/ (gitignored)."""
    _build.CSRC = csrc
    _build.BUILD_DIR = ROOT / "build" / "paged_variants" / name
    _build._loaded.pop("paged_decode", None)
    t0 = time.perf_counter()
    lib = _build.load("paged_decode", P._FUNCTIONS)
    info = _build.build_info.get("paged_decode")
    notes = [line.strip() for line in (info[1] if info else "").splitlines()
             if "Used" in line or "spill stores" in line and " 0 bytes spill"
             not in line]
    print(f"built {name} in {time.perf_counter() - t0:.1f}s"
          + "".join(f"\n  {note[:120]}" for note in notes), flush=True)
    return lib


def reads(device):
    """(label, call) of the serving reads, on seeded pools."""
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


def main() -> None:
    if len(sys.argv) < 2 or any("=" not in a for a in sys.argv[1:]):
        sys.exit(__doc__)
    variants = [a.split("=", 1) for a in sys.argv[1:]]
    card = C.card_line()
    device = torch.device("cuda")
    libs = {name: load(Path(csrc).resolve(), name) for name, csrc in variants}
    for name, lib in libs.items():
        _build._loaded["paged_decode"] = lib
        try:
            C.check_kernels(torch, device, card)
            print(f"{name}: every case within the bars", flush=True)
        except SystemExit:
            print(f"{name}: MISSES a bar (the FAIL line above)", flush=True)
    cases = reads(device)
    times = {(name, label): [] for name in libs for label, _ in cases}
    order = list(libs)
    for sweep in (order, order[::-1]):
        for name in sweep:
            _build._loaded["paged_decode"] = libs[name]
            for label, call in cases:
                times[name, label].append(
                    C.time_runs(torch, call, iters=50)["ms"])
    for label, _ in cases:
        print(f"{label}: " + "; ".join(
            f"{name} " + "/".join(f"{ms:.4f}" for ms in times[name, label])
            for name in libs) + f" [{card}]", flush=True)


if __name__ == "__main__":
    main()
