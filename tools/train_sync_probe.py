"""Where the LM train step waits for the card, at `train`'s shapes.

Builds `chip_smoke.py`'s telemetry solver (235M, bf16, b16 t1024, flash)
on the card and, after three warm-up steps:

1. runs one step under `torch.cuda.set_sync_debug_mode("warn")` and
   prints each synchronizing call with its stack;
2. times the parts of four steps on the host clock with nothing waited
   for inside (the upload, the forward, the backward, the clip, AdamW),
   then the wait for the card at the end;
3. times three `train_step` calls: the launch loop, then the wait;
4. profiles two steps with `torch.profiler` and prints the CUDA runtime
   calls (counts and host time) and the busiest operators.

Run on the card: `chiprun -- python3 tools/train_sync_probe.py` (about
a minute of command; the kernels build first).
"""
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> None:
    import torch
    import chip_smoke
    from flashy_tpu_torch.examples.lm.solver import LMSolver, train_step
    from flashy_tpu_torch.examples.lm.solver import main as lm_main
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("the probe needs a CUDA card")
    device = torch.device("cuda")
    with tempfile.TemporaryDirectory() as folder:
        xp = lm_main.get_xp(chip_smoke.TELEMETRY_ARGS
                            + [f"dora.dir={folder}"])
        with xp.enter():
            solver = LMSolver(xp.cfg, device=device)

    def loss_fn(model, tokens):
        return solver.loss(tokens)

    def step(index):
        return train_step(solver.model, solver.optimizer, solver.schedule,
                          index, solver.batch_at(index), loss_fn)

    for index in range(3):
        float(step(index)["loss"])
    torch.cuda.synchronize()

    seen = set()

    def show(message, category, filename, lineno, file=None, line=None):
        stack = "".join(traceback.format_stack(limit=14)[:-2])
        if stack not in seen:
            seen.add(stack)
            print(f"synchronizing call: {message}\n{stack}", flush=True)

    warnings.showwarning = show
    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")
    step(3)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"distinct synchronizing sites in one step: {len(seen)}",
          flush=True)

    def ms(a, b):
        return f"{(b - a) * 1e3:.2f}"

    model = solver.model
    for index in range(4, 8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = solver.batch_at(index)
        t1 = time.perf_counter()
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        t2 = time.perf_counter()
        loss.backward()
        t3 = time.perf_counter()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        norm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
        for grad in grads:
            grad.copy_(torch.where(norm < 1.0, grad, grad / norm))
        t4 = time.perf_counter()
        solver.optimizer.step()
        t5 = time.perf_counter()
        torch.cuda.synchronize()
        t6 = time.perf_counter()
        print(f"step {index}: upload {ms(t0, t1)} forward {ms(t1, t2)} "
              f"backward {ms(t2, t3)} clip {ms(t3, t4)} adamw {ms(t4, t5)} "
              f"then the wait {ms(t5, t6)}, total {ms(t0, t6)} ms",
              flush=True)

    for index in range(8, 11):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(index)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"train_step {index}: launch loop {ms(t0, t1)} ms, then the "
              f"wait {ms(t1, t2)} ms", flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for index in range(11, 13):
            step(index)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    runtime = sorted((e for e in averages if e.key.startswith("cuda")),
                     key=lambda e: -e.cpu_time_total)
    for event in runtime[:10]:
        print(f"runtime {event.key}: {event.count} calls, "
              f"{event.cpu_time_total / 1e3:.2f} ms on the host (two steps, "
              f"the probe's own final synchronize included)", flush=True)
    print(averages.table(sort_by="self_cpu_time_total", row_limit=25),
          flush=True)
    print(nvidia_smi(), flush=True)


def nvidia_smi() -> str:
    import subprocess
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip()


if __name__ == "__main__":
    main()
