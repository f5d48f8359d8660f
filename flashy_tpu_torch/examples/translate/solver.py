"""Seq2seq solver: synthetic translation with cached greedy decode (the
port of examples/translate/solver.py).

    python -m flashy_tpu_torch.examples.translate.solver [key=value ...]

Trains the port's `Seq2SeqTransformer` on synthetic transduction pairs
(reverse or copy: solvable only through the cross attention) with
teacher forcing (the decoder reads BOS + tgt[:-1] and predicts tgt),
evaluates the held-out loss and, every `translate_every` epochs, the
token and sequence accuracy of `cached_translate` on the first eval
batch. With `model.attention=flash` (the default) the self-attention of
both stacks runs the Hopper flash kernels: the encoder non-causal, the
decoder causal, each one 64-row tile at `src_len` 64.

The optimizer, its schedule and the update are the LM solver's
(`build_optimizer`, `train_step`), as the JAX solver chains the same
optax transformations. A batch travels as one [rows, 3, S] tensor (src,
tgt, decoder input). One rank a process over the mesh's process axes,
each data-parallel rank (`data x fsdp`) on its contiguous rows of the
global batch, the ranks of a tensor group on the same rows:
`mesh.fsdp > 1` holds the parameters as FSDP shards and `mesh.tensor >
1` cuts the model over Megatron tensor ranks, both under
`seq2seq_shardings` (the LM solver's `wrap_model`); the loss is then
vocab-parallel, and the cached decoder runs on the summoned full
parameters. It runs on the card; `device=cpu` runs it on the host.
"""
import contextlib
import time
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from ... import distrib
from ...formatter import Formatter
from ...logging import setup_logging
from ...models.seq2seq import (Seq2SeqConfig, Seq2SeqTransformer,
                               cached_translate)
from ...parallel.data_parallel import shard_batch
from ...parallel.tensor import vocab_parallel_cross_entropy
from ...solver import BaseSolver
from ...utils import averager, resolve_device
from ...xp import main as xp_main
from ..lm.solver import (TODO_EXPERT_SOLVERS, build_optimizer, check_mesh,
                         train_step, wrap_model)


def synthetic_pairs(vocab_size: int, task: str = "reverse", seed: int = 0):
    """(src, tgt) batch generator over (seed, subset, step) SeedSequence
    namespacing, bit-equal to the JAX solver's: ids from 2 up (1 is BOS),
    tgt the reversed or copied src."""
    if task not in ("reverse", "copy"):
        raise ValueError(f"task must be 'reverse' or 'copy', got {task!r}")

    def batch(batch_size: int, seq_len: int, step: int, subset: int = 0):
        gen = np.random.default_rng([seed, subset, step])
        src = gen.integers(2, vocab_size, (batch_size, seq_len)).astype(
            np.int32)
        tgt = src[:, ::-1].copy() if task == "reverse" else src.copy()
        return src, tgt

    return batch


def teacher_loss(model: tp.Callable, packed: torch.Tensor,
                 vocab_mesh: tp.Any = None) -> torch.Tensor:
    """Mean cross entropy of `packed` ([B, 3, S]: src, tgt, decoder
    input); over a `vocab_mesh` (a model cut over 'tensor') the logits
    are the rank's vocabulary columns (`vocab_parallel_cross_entropy`)."""
    src, tgt, dec_in = packed.unbind(1)
    logits = model(src, dec_in)
    if vocab_mesh is not None:
        return vocab_parallel_cross_entropy(logits, tgt, vocab_mesh).mean()
    return F.cross_entropy(logits.flatten(0, 1), tgt.flatten())


class TranslateSolver(BaseSolver):
    """The seq2seq solver, one device a process (`cuda` unless `device`
    says so)."""

    def __init__(self, cfg, device: tp.Any = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = check_mesh(cfg.mesh, cfg.model.attention,
                               model=cfg.model, expert=TODO_EXPERT_SOLVERS)
        model_cfg = Seq2SeqConfig(
            vocab_size=cfg.model.vocab_size, dim=cfg.model.dim,
            enc_layers=cfg.model.enc_layers, dec_layers=cfg.model.dec_layers,
            num_heads=cfg.model.num_heads, mlp_ratio=cfg.model.mlp_ratio,
            attention=cfg.model.attention,
            max_seq_len=max(int(cfg.src_len) + 1, 128))
        self.model = Seq2SeqTransformer(model_cfg, device=self.device, seed=0,
                                        mesh=self.mesh)
        rows = self.mesh.data_parallel_size
        if cfg.batch_size % rows:
            raise ValueError(f"batch_size={cfg.batch_size} (the global "
                             f"batch) does not split over {rows} "
                             f"data-parallel ranks")
        self.train_model = wrap_model(self.model, self.mesh)
        self.vocab_mesh = self.mesh if self.mesh.shape["tensor"] > 1 \
            else None
        self.optimizer, self.schedule = build_optimizer(self.model, cfg)
        self.state: tp.Dict[str, tp.Any] = {"step": 0}
        self.register_stateful("model", "optimizer", "state")
        self._pairs = synthetic_pairs(cfg.model.vocab_size,
                                      cfg.get("task", "reverse"))
        self._bos = int(cfg.bos_token)
        # host seconds of each train step this process ran
        self.step_seconds: tp.List[float] = []

    def get_formatter(self, stage_name):
        return Formatter({"loss": ".4f", "grad_norm": ".2f",
                          "seq_acc": ".1%", "tok_acc": ".1%"})

    def batch_at(self, step: int, eval_set: bool = False
                 ) -> tp.Dict[str, np.ndarray]:
        """The global batch of `step` on the host: {"src", "tgt",
        "dec_in"} int32 [B, S], the decoder input BOS + tgt[:-1]."""
        cfg = self.cfg
        src, tgt = self._pairs(cfg.batch_size, cfg.src_len, step,
                               subset=1 if eval_set else 0)
        dec_in = np.concatenate(
            [np.full((src.shape[0], 1), self._bos, np.int32), tgt[:, :-1]],
            axis=1)
        return {"src": src, "tgt": tgt, "dec_in": dec_in}

    def _local(self, batch: tp.Dict[str, np.ndarray]) -> torch.Tensor:
        """This rank's rows of `batch` as one [rows, 3, S] tensor on the
        device."""
        rows = self.cfg.batch_size // self.mesh.data_parallel_size
        start = self.mesh.data_parallel_index() * rows
        packed = np.stack([batch["src"], batch["tgt"], batch["dec_in"]],
                          axis=1)[start:start + rows]
        return shard_batch(packed, self.mesh, device=self.device).long()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self):
        cfg = self.cfg
        average = averager()
        progress = self.log_progress("train", range(cfg.steps_per_epoch),
                                     updates=5)
        metrics: tp.Dict[str, float] = {}
        for index in progress:
            global_step = (self.epoch - 1) * cfg.steps_per_epoch + index
            t0 = time.perf_counter()
            step_metrics = train_step(
                self.train_model, self.optimizer, self.schedule,
                self.state["step"], self._local(self.batch_at(global_step)),
                lambda model, packed: teacher_loss(model, packed,
                                                   self.vocab_mesh),
                mesh=self.mesh)
            self.state["step"] += 1
            progress.observe(step_metrics["loss"])
            metrics = average(step_metrics)
            self.step_seconds.append(time.perf_counter() - t0)
            progress.update(**metrics)
        self._sync()
        return distrib.average_metrics(metrics)

    def valid(self):
        """Held-out teacher-forced loss, then the cached decoder's
        accuracy on the first eval batch."""
        average = averager()
        progress = self.log_progress(
            "valid", range(self.cfg.get("valid_steps", 4)), updates=2)
        metrics: tp.Dict[str, float] = {}
        with torch.no_grad():
            for index in progress:
                loss = teacher_loss(self.model, self._local(
                    self.batch_at(index, eval_set=True)), self.vocab_mesh)
                progress.observe(loss)
                metrics = average({"loss": loss})
                progress.update(**metrics)
        every = int(self.cfg.get("translate_every", 1))
        if every and self.epoch % every == 0:
            src, tgt, _ = self._local(self.batch_at(0, eval_set=True)
                                      ).unbind(1)
            summon = getattr(self.model, "summon_full_params",
                             contextlib.nullcontext)
            with summon():
                out = cached_translate(self.model, src,
                                       max_new_tokens=self.cfg.src_len,
                                       bos_id=self._bos)
            hits = (out == tgt).float()
            metrics["tok_acc"] = float(hits.mean())
            metrics["seq_acc"] = float(hits.prod(dim=1).mean())
        return distrib.average_metrics(metrics)

    def run(self):
        restored = self.restore()
        self.logger.info("Restored: %s; starting at epoch %d", restored,
                         self.epoch)
        for _ in range(self.epoch, self.cfg.epochs + 1):
            self.run_stage("train", self.train)
            if self.cfg.get("valid_steps", 4):
                self.run_stage("valid", self.valid)
            self.commit()


@xp_main(config_path="config")
def main(cfg):
    """Train the seq2seq model; returns the solver."""
    setup_logging()
    distrib.init(backend="gloo" if cfg.get("device") == "cpu" else None)
    solver = TranslateSolver(cfg, device=cfg.get("device"))
    solver.run()
    return solver


if __name__ == "__main__":
    main()
