"""A/B of two checkouts of the repo on one CUDA card, in turns.

    python3 tools/chip_ab.py OTHER [THIS] [--phases PHASE,...]

PHASE is one of train, ring, moe, serve, paged, ssd, ssd_serve, f32flash.

Runs each checkout's own `chip_smoke.py` phases in a process of its own,
in the order OTHER, THIS, THIS, OTHER, and prints the phases' lines
under a header per run. The phases (by default `train,ring`):

- `train`, `ring`: `train` and `ring train`, each followed by its
  profiled window;
- `moe`: `moe train` and its profiled window, with the grouped kernels'
  device ms a step;
- `serve`: `serve bf16`, the paged serving leg and its profile;
- `paged`: the tree's paged-attention wrapper on seeded bf16 and int8
  pools at the serving shapes (8 slots x 16 heads x 64, block 16: T=1
  at context 192 and T=16 at context 128), device time three times and
  the wrapper's host us a call;
- `ssd`: the tree's `ssd_chunked_scan` on the serving path's inputs
  (bf16 projection slices [B, T, 16, 2 x 16 + 64 + 1] with a padding
  mask and a carried state, chunk 64) at [1, 64] and [8, 1024]: the
  whole call's device time three times and its host us;
- `ssd_serve`: `ssd serve bf16`, its profiled window with the SSD
  kernel's device time, and the tree's own SSD timing lines;
- `f32flash`: the four flash kernels in f32 at `step`'s shapes (B 2,
  H 16, T 256, D 64, causal) on whatever route the tree runs f32 on,
  held against their plain versions and timed (`time_flash`).

THIS
defaults to the checkout this script lives in. Run it on the machine
with the card, from anywhere; make OTHER with
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
    # only the wrapper's public signature, which every tree shares
    "paged": '''
from flashy_tpu_torch.models.quantize import quantize_kv
from flashy_tpu_torch.ops.paged_decode import fused_paged_attention
g = torch.Generator(device="cuda").manual_seed(0)
B, H, D, bs, E = 8, 16, 64, 16, 16
for kv in ("model", "int8"):
    k, v = (torch.randn((1 + B * E, bs, H, D), generator=g, device="cuda")
            for _ in range(2))
    if kv == "int8":
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        entry = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        entry = {"k": k.bfloat16(), "v": v.bfloat16()}
    for T, ctx in ((1, 192), (16, 128)):
        live = -(-ctx // bs)
        table = torch.zeros((B, E), dtype=torch.int32, device="cuda")
        table[:, :live] = 1 + torch.arange(B * live, device="cuda").view(
            B, live)
        q = torch.randn((B, T, H, D), generator=g, device="cuda").bfloat16()
        positions = (ctx - T + torch.arange(T, device="cuda")).expand(B, T)
        fn = lambda: fused_paged_attention(q, entry, table, positions,
                                           head_dim=D, dtype=torch.bfloat16)
        t = C.time_runs(torch, fn, iters=50)
        print(f"paged {kv} T={T} context {ctx}: device "
              f"{C.spread_text(t)} host_us={C.host_us(torch, fn):.1f} "
              f"[{card}]", flush=True)
''',
    # only the public signatures, which every tree shares
    "ssd": '''
from flashy_tpu_torch.ops.ssd_scan import ssd_chunked_scan
g = torch.Generator(device="cuda").manual_seed(0)
H, N, D = 16, 16, 64
for B, T in ((1, 64), (8, 1024)):
    p = torch.randn((B, T, H, 2 * N + D + 1), generator=g,
                    device="cuda").bfloat16()
    c, b, v = p[..., :N], p[..., N:2 * N], p[..., 2 * N:2 * N + D]
    log_a = -torch.nn.functional.softplus(
        torch.randn((B, T, H), generator=g, device="cuda"))
    state = torch.randn((B, H, D, N), generator=g, device="cuda")
    mask = torch.ones((B, T), dtype=torch.bool, device="cuda")
    mask[-1, T - T // 8:] = False
    call = lambda: ssd_chunked_scan(c, b, v, log_a, state=state, chunk=64,
                                    token_mask=mask, kernel="fused")
    iters = 50 if B * T <= 256 else 20
    t_call = C.time_runs(torch, call, iters=iters)
    print(f"ssd [{B}, {T}]: call device {C.spread_text(t_call)} "
          f"host_us={C.host_us(torch, call):.1f} [{card}]", flush=True)
''',
    "ssd_serve": '''
C.phase_ssd_serve(torch, torch.device("cuda"), card)
''',
    "f32flash": '''
C.time_flash(torch, torch.device("cuda"), card, B=2, T=256,
             dtype=torch.float32)
''',
    "serve": '''
C.phase_serve(torch, torch.device("cuda"), card, kv_dtype="model",
              requests_n=16, prompt_len=128, max_new=128, label="serve bf16")
''',
}
KEEP = ("train:", "profile", "ring train:", "moe train:", "serve bf16",
        "paged ", "ssd ", "flash ", "FAIL")


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
