"""`python -m flashy_tpu_torch.datapipe`: the kill/resume token-exactness
drill of the streaming data pipeline (the port of
flashy_tpu/datapipe/__main__.py).

It packs a synthetic two-corpus mixture (jsonl and .npy shards, made
from a seed: nothing to download) into fixed [B, L] segment-masked
batches and trains a tiny TransformerLM (attention='dense', f32, plain
SGD at 0.05) three times: once uninterrupted, once stopped by a
simulated SIGTERM mid-stream (the `datapipe.batch` fault site through
the FaultInjector), then resumed from the committed input cursor. Exit
1 unless the concatenated consumed-token sequence of kill + resume is
identical to the uninterrupted run's and the final parameters match bit
for bit.

The reference's step is a jitted function watched by the recompile
watchdog, and the drill gates on zero post-warm-up recompiles. The
port's step is eager (the watchdog refuses the port's callables: no jit
cache to poll), so the gate reads the watchdog's summary, which stays 0.

The model runs on `cuda` unless `--device cpu` (or `device="cpu"`) asks
for the host.
"""
import argparse
import itertools
import json
import logging
import shutil
import sys
import tempfile
import time
import typing as tp
from pathlib import Path

import numpy as np

logger = logging.getLogger("flashy_tpu_torch.datapipe.drill")

MIX_WEIGHTS = (0.7, 0.3)
VOCAB = 257
LR = 0.05


def make_corpus(root: Path, seed: int = 0) -> tp.Dict[str, tp.List[Path]]:
    """Synthesize a two-corpus layout: corpus A as jsonl shards (token
    and byte-level text records), corpus B as padded .npy token shards
    (the JAX package's corpus, draw for draw)."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    jsonl_files, npy_files = [], []
    for shard in range(3):
        path = root / f"corpus_a.{shard:02d}.jsonl"
        with open(path, "w") as f:
            for doc in range(12):
                if doc % 5 == 4:  # exercise the byte-level text path
                    text = "doc %d of shard %d " % (doc, shard) * (doc + 1)
                    f.write(json.dumps({"text": text}) + "\n")
                else:
                    length = int(rng.integers(5, 90))
                    tokens = rng.integers(0, VOCAB, length)
                    f.write(json.dumps({"tokens": [int(t) for t in tokens]})
                            + "\n")
        jsonl_files.append(path)
    for shard in range(2):
        path = root / f"corpus_b.{shard:02d}.npy"
        docs = np.full((8, 64), -1, dtype=np.int64)
        for row in range(docs.shape[0]):
            length = int(rng.integers(10, 60))
            docs[row, :length] = rng.integers(0, VOCAB, length)
        np.save(path, docs)
        npy_files.append(path)
    return {"jsonl": jsonl_files, "npy": npy_files}


def build_pipeline(corpus: tp.Dict[str, tp.List[Path]], batch_size: int,
                   seq_len: int, seed: int = 0):
    """corpus shards -> looped streams -> weighted mixture -> packer ->
    background prefetch (the full subsystem, end to end)."""
    from . import (MixtureStream, SequencePacker, ShardedTextStream,
                   prefetch)
    streams = [ShardedTextStream(corpus["jsonl"], loop=True),
               ShardedTextStream(corpus["npy"], loop=True)]
    mixture = MixtureStream(streams, list(MIX_WEIGHTS), seed=seed)
    packer = SequencePacker(mixture, batch_size, seq_len)
    return prefetch(packer, size=2)


def upload(batch: tp.Mapping[str, np.ndarray], device: tp.Any
           ) -> tp.Dict[str, tp.Any]:
    """A packed numpy batch as int64 tensors on `device` (tokens index
    the embedding; segment ids and positions as the model takes them)."""
    import torch
    return {key: torch.from_numpy(np.asarray(value)).long().to(device)
            for key, value in batch.items()}


def same_batch(a: tp.Mapping[str, np.ndarray],
               b: tp.Mapping[str, np.ndarray]) -> bool:
    """Two packed batches equal key for key and bit for bit."""
    return a.keys() == b.keys() and all(np.array_equal(a[key], b[key])
                                        for key in a)


def packed_next_token_loss(model: tp.Callable, tokens: tp.Any,
                           segment_ids: tp.Any, positions: tp.Any) -> tp.Any:
    """Mean next-token NLL over the pairs within one segment: packing must
    never leak loss across document boundaries, and padding (segment 0)
    counts nothing (the reference drill's `loss_fn`)."""
    import torch
    logits = model(tokens, positions=positions, segment_ids=segment_ids)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None])[..., 0]
    mask = ((segment_ids[:, 1:] == segment_ids[:, :-1])
            & (segment_ids[:, 1:] > 0)).float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def drill_config(seq_len: int):
    """The drill's tiny LM: the reference drill's widths, dense attention
    (packed rows take the dense masked path), f32."""
    import torch
    from ..models.transformer import TransformerConfig
    return TransformerConfig(vocab_size=VOCAB, dim=32, num_layers=2,
                             num_heads=2, max_seq_len=seq_len,
                             attention="dense", dtype=torch.float32)


def _solver_class():
    # Deferred so `--help` stays instant (importing the solver pulls torch).
    import torch

    from ..models.transformer import TransformerLM
    from ..resilience import chaos
    from ..solver import BaseSolver
    from ..utils import resolve_device

    class DatapipeSolver(BaseSolver):
        """Tiny LM trained on the packed stream; the model AND the input
        cursor are stateful, so `commit()` makes both durable together
        and a killed run resumes token-exact mid-stream. Every consumed
        batch is recorded (`self.consumed`): the oracle the drill
        compares across runs. A subclass trains another model on the
        same loop by overriding `build_model` and `train_step`."""

        def __init__(self, corpus, epochs: int, steps: int,
                     batch_size: int, seq_len: int, device: tp.Any = None):
            super().__init__()
            self.epochs = epochs
            self.steps = steps
            self.device = resolve_device(device)
            self.pipe = build_pipeline(corpus, batch_size, seq_len)
            self.consumed: tp.List[tp.Dict[str, np.ndarray]] = []
            self.model = self.build_model(seq_len)
            self.register_stateful("model", "pipe")

        def build_model(self, seq_len: int) -> tp.Any:
            return TransformerLM(drill_config(seq_len), device=self.device,
                                 seed=0)

        def train_step(self, batch) -> tp.Any:
            """One eager SGD step (p - 0.05 g, as the reference rounds
            it); returns the loss as a device scalar."""
            params = list(self.model.parameters())
            loss = packed_next_token_loss(self.model, batch["tokens"],
                                          batch["segment_ids"],
                                          batch["positions"])
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                for p, g in zip(params, grads):
                    p.sub_(LR * g)
            return loss.detach()

        def train_stage(self):
            metrics: tp.Dict[str, float] = {}
            progress = self.log_progress(
                "train", itertools.islice(self.pipe, self.steps),
                total=self.steps, updates=1)
            for batch in progress:
                chaos.fault_point("datapipe.batch", epoch=self.epoch)
                self.consumed.append(batch)
                loss = self.train_step(upload(batch, self.device))
                progress.observe(loss)
                metrics["loss"] = float(loss)
            return metrics

        def run(self):
            self.restore()
            for _ in range(self.epoch, self.epochs + 1):
                self.run_stage("train", self.train_stage)
                self.commit()
            self.pipe.close()

    return DatapipeSolver


def _strip_wallclock(history: tp.List[dict]) -> tp.List[dict]:
    """Keep only the deterministic metric (`loss`): durations and step
    timings can never match across runs."""
    return [{stage: {k: v for k, v in metrics.items() if k == "loss"}
             for stage, metrics in epoch.items()} for epoch in history]


def _recompiles() -> int:
    from ..observability import get_telemetry
    telemetry = get_telemetry()
    assert telemetry is not None
    return sum(telemetry.watchdog.summary().values())


def run_drill(epochs: int = 3, steps: int = 6, batch_size: int = 4,
              seq_len: int = 64, kill_epoch: int = 2,
              root: tp.Optional[str] = None, keep: bool = False,
              device: tp.Any = None,
              log: tp.Optional[logging.Logger] = None) -> int:
    """Run the datapipe drill; returns 0 when every check passes.

    Phase A: uninterrupted baseline (records every consumed batch).
    Phase B: same job, simulated SIGTERM mid-stream of `kill_epoch`
    (requeue exit after that epoch's commit). Phase C: resume from the
    committed cursor; the concatenated consumed-token stream of B+C
    must be bit-identical to A's, the final parameters bit-equal, and
    the watchdog's recompile count 0 everywhere.
    """
    from .. import resilience
    from ..observability import disable_telemetry
    from ..resilience import chaos
    from ..utils import resolve_device
    from ..xp import Config, create_xp

    log = log or logger
    if not 1 < kill_epoch <= epochs:
        raise ValueError(f"kill_epoch must be in (1, {epochs}], "
                         f"got {kill_epoch}")
    device = resolve_device(device)
    workdir = Path(root) if root else Path(
        tempfile.mkdtemp(prefix="flashy_torch_datapipe_"))
    corpus = make_corpus(workdir / "corpus")
    DatapipeSolver = _solver_class()
    failures: tp.List[str] = []

    def check(ok: bool, what: str) -> None:
        if ok:
            log.info("PASS: %s", what)
        else:
            log.error("FAIL: %s", what)
            failures.append(what)

    def make_solver():
        return DatapipeSolver(corpus, epochs, steps, batch_size, seq_len,
                              device=device)

    try:
        log.info("phase A: uninterrupted baseline (%d epochs x %d steps) "
                 "on %s", epochs, steps, device)
        xp = create_xp(Config({"datapipe": "baseline"}), root=workdir)
        with xp.enter():
            baseline = make_solver()
            baseline.enable_telemetry()
            baseline.run()
        check(_recompiles() == 0,
              "baseline: the watchdog counts zero recompiles (eager step)")
        disable_telemetry()
        base_consumed = baseline.consumed
        base_history = _strip_wallclock(baseline.history)
        base_params = baseline.model.state_dict()
        check(len(base_consumed) == epochs * steps,
              f"baseline consumed {epochs * steps} batches")
        check(baseline.pipe.stats()["tokens"] > 0,
              "prefetch throughput counters saw the token stream")
        check("data_wait_frac" in baseline.history[0]["train"],
              "StepTimer reports data_wait for the prefetch-fed stage")

        log.info("phase B: simulated SIGTERM mid-stream of epoch %d",
                 kill_epoch)
        # strict: uninstall() raises UnfiredFaultRules if any armed rule
        # never fired; a drill whose faults never happened proves nothing
        injector = chaos.install(strict=True)
        injector.preempt_at("datapipe.batch",
                            call=(kill_epoch - 1) * steps + 3)
        chaos_cfg = Config({"datapipe": "chaos"})
        xp = create_xp(chaos_cfg, root=workdir)
        exit_code: tp.Optional[tp.Any] = None
        with xp.enter():
            killed = make_solver()
            killed.enable_preemption_guard(install=False)
            killed.enable_telemetry()
            try:
                killed.run()
            except SystemExit as exc:
                exit_code = exc.code
        check(_recompiles() == 0,
              "killed run: the watchdog counts zero recompiles")
        disable_telemetry()
        check(exit_code == resilience.EXIT_PREEMPTED,
              f"killed run exited with the requeue code "
              f"{resilience.EXIT_PREEMPTED} (got {exit_code})")
        check(injector.hits("datapipe.batch", kind="preempt") == 1,
              "simulated mid-stream SIGTERM fired")
        check(len(killed.history) == kill_epoch,
              f"kill landed after the epoch-{kill_epoch} commit "
              f"({len(killed.history)} committed epochs)")
        check(len(killed.consumed) == kill_epoch * steps,
              "killed run consumed exactly the committed epochs' batches")

        log.info("phase C: resume from the committed input cursor")
        chaos.uninstall()
        resilience.disable_preemption_guard()
        xp = create_xp(chaos_cfg, root=workdir)  # same cfg -> same folder
        with xp.enter():
            resumed = make_solver()
            resumed.enable_telemetry()
            resumed.run()
        check(_recompiles() == 0,
              "resumed run: the watchdog counts zero recompiles")
        disable_telemetry()
        check(len(resumed.consumed) == (epochs - kill_epoch) * steps,
              "resumed run consumed exactly the remaining batches")
        replayed = killed.consumed + resumed.consumed
        divergence = [i for i, (a, b) in enumerate(zip(base_consumed,
                                                       replayed))
                      if not same_batch(a, b)]
        check(len(replayed) == len(base_consumed) and not divergence,
              "kill+resume token stream identical to the uninterrupted "
              f"run ({len(base_consumed)} batches"
              + (f"; first divergence at batch {divergence[0]}"
                 if divergence else "") + ")")
        check(_strip_wallclock(resumed.history) == base_history,
              "resumed history (losses) identical to the baseline")
        final = resumed.model.state_dict()
        check(set(final) == set(base_params) and all(
            bool((final[name] == base_params[name]).all())
            for name in base_params),
              "resumed final params bit-identical to the baseline")
    finally:
        # verify=False: a strict raise here would mask the original error
        # (the success path already verified via the mid-drill uninstall)
        chaos.uninstall(verify=False)
        from ..resilience.preemption import disable_preemption_guard
        disable_preemption_guard()
        disable_telemetry()
        if not keep and root is None:
            shutil.rmtree(workdir, ignore_errors=True)
        elif keep:
            log.info("artifacts kept under %s", workdir)

    if failures:
        log.error("datapipe drill FAILED %d checks:\n  %s", len(failures),
                  "\n  ".join(failures))
        return 1
    log.info("datapipe drill passed: mid-stream kill+resume was token-exact "
             "with bit-identical parameters and zero recompiles.")
    return 0


def run_packing_bench(batches: int = 200, batch_size: int = 8,
                      seq_len: int = 512,
                      root: tp.Optional[str] = None) -> tp.Dict[str, tp.Any]:
    """Packing throughput (host only): stream + mix + pack `batches`
    fixed [B, L] batches, report tokens/s and the packing efficiency
    (the non-padding fraction)."""
    workdir = Path(root) if root else Path(
        tempfile.mkdtemp(prefix="flashy_torch_datapipe_bench_"))
    pipe = None
    try:
        corpus = make_corpus(workdir / "corpus")
        pipe = build_pipeline(corpus, batch_size, seq_len)
        warm = next(pipe)  # first batch pays the file reads
        begin = time.perf_counter()
        packed = padded = 0
        for batch in itertools.islice(pipe, batches):
            packed += int(batch["tokens"].size)
            padded += int((batch["segment_ids"] == 0).sum())
        elapsed = time.perf_counter() - begin
        return {
            "batches": batches,
            "batch_shape": list(warm["tokens"].shape),
            "tokens_per_sec": round(packed / elapsed) if elapsed > 0 else None,
            "packing_efficiency": round(1.0 - padded / max(packed, 1), 4),
        }
    finally:
        if pipe is not None:  # an errored bench must not leak the worker
            pipe.close()
        if root is None:
            shutil.rmtree(workdir, ignore_errors=True)


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m flashy_tpu_torch.datapipe",
        description="Datapipe drill: pack a synthetic corpus, train, kill "
                    "mid-stream, resume, and prove the consumed token "
                    "stream and the final parameters are exact.")
    parser.add_argument("-e", "--epochs", type=int, default=3)
    parser.add_argument("-s", "--steps", type=int, default=6,
                        help="steps per epoch (the epoch is a step count: "
                             "streams have no natural epoch boundary)")
    parser.add_argument("-b", "--batch-size", type=int, default=4)
    parser.add_argument("-l", "--seq-len", type=int, default=64)
    parser.add_argument("--kill-epoch", type=int, default=2,
                        help="epoch whose stream takes the simulated "
                             "SIGTERM (in (1, epochs])")
    parser.add_argument("--device", default=None,
                        help="where the model runs (default: cuda)")
    parser.add_argument("--dir", default=None,
                        help="work directory (default: a fresh temp dir)")
    parser.add_argument("--keep", action="store_true",
                        help="keep the XP folders for inspection")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="[%(levelname)s] %(message)s")
    return run_drill(epochs=args.epochs, steps=args.steps,
                     batch_size=args.batch_size, seq_len=args.seq_len,
                     kill_epoch=args.kill_epoch, root=args.dir,
                     keep=args.keep, device=args.device)


if __name__ == "__main__":
    raise SystemExit(main())
