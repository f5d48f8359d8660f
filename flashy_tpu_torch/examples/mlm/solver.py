"""Masked-LM solver: bidirectional encoder training (the port of
examples/mlm/solver.py).

    python -m flashy_tpu_torch.examples.mlm.solver [key=value ...]

The port's `TransformerLM` with `causal=False`, trained on the LM
example's synthetic token stream with BERT's 80/10/10 recipe: `mask_prob`
of the positions are selected; 80% of them become the reserved
`mask_token`, 10% a random token, 10% stay; the loss is the cross
entropy at the selected positions, their sum over their count. With
`model.attention=flash` (the default) every attention call runs the
Hopper flash kernels non-causal: the forward on every step, the fused
backward on every training step.

The optimizer, its schedule and the update are the LM solver's
(`build_optimizer`, `train_step`): optax's `clip_by_global_norm(1.0)`
then AdamW under `warmup_cosine_decay_schedule`, as the JAX solver
chains them. A batch travels as one [rows, 3, T] tensor (inputs, labels,
selection) so the LM's step takes it whole. One rank a process over the
mesh's process axes: each data-parallel rank (`data x fsdp`) takes its
contiguous rows of the global batch and divides its selected sum by the
global batch's count (times the data-parallel size, which
DistributedDataParallel's mean undoes), so the ranks' loss and gradients
are the global batch's masked mean, as the JAX step's sum over count
is. `mesh.fsdp` above 1 wraps the model in FSDP form as the LM solver
does (`wrap_model`, the reduce-scatter averaging as DDP's mean does);
`mesh.tensor` above 1 cuts it over Megatron tensor ranks, which take the
same rows, and the masked loss is then over the rank's vocab-parallel
logits (`vocab_parallel_cross_entropy`). It runs on the card;
`device=cpu` runs it on the host.
"""
import time
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from ... import distrib
from ...formatter import Formatter
from ...logging import setup_logging
from ...models.transformer import TransformerConfig, TransformerLM
from ...parallel.data_parallel import shard_batch
from ...parallel.tensor import vocab_parallel_cross_entropy
from ...solver import BaseSolver
from ...utils import averager, resolve_device
from ...xp import main as xp_main
from ..lm.solver import (TODO_EXPERT_SOLVERS, build_optimizer, check_mesh,
                         synthetic_token_stream, train_step, wrap_model)


def mask_tokens(tokens: np.ndarray, step: int, eval_set: bool,
                mask_prob: float, mask_id: int, vocab: int
                ) -> tp.Dict[str, np.ndarray]:
    """BERT's recipe over [B, T] stream tokens: {"inputs", "labels"
    (int32), "selected" (bool)}, as the JAX solver's `batch_at` draws it.

    Tokens are folded onto vocab - 1 ids and those at or above `mask_id`
    shift up by one, so the [MASK] id never occurs naturally; then
    `mask_prob` of the positions are selected (a generator seeded with
    (17, eval_set, step)): 80% replaced by the [MASK] id, 10% by a random
    token, 10% kept. The model predicts the original token at every
    selected position."""
    if not 0 <= mask_id < vocab:
        raise ValueError(f"mask_token {mask_id} outside vocab {vocab}")
    tokens = tokens % (vocab - 1)
    tokens = tokens + (tokens >= mask_id)
    rng = np.random.default_rng([17, int(eval_set), step])
    sel = rng.random(tokens.shape) < mask_prob
    action = rng.random(tokens.shape)
    rand_tok = rng.integers(0, vocab - 1, tokens.shape)
    rand_tok = rand_tok + (rand_tok >= mask_id)
    inputs = tokens.copy()
    inputs[sel & (action < 0.8)] = mask_id
    swap = sel & (action >= 0.8) & (action < 0.9)
    inputs[swap] = rand_tok[swap]
    return {"inputs": inputs.astype(np.int32),
            "labels": tokens.astype(np.int32), "selected": sel}


def masked_loss(model: tp.Callable, packed: torch.Tensor,
                count: float, vocab_mesh: tp.Any = None) -> torch.Tensor:
    """The cross entropy at the selected positions of `packed` ([B, 3, T]:
    inputs, labels, selection), summed and divided by `count`; over a
    `vocab_mesh` (a model cut over 'tensor') the logits are the rank's
    vocabulary columns."""
    inputs, labels, selected = packed.unbind(1)
    logits = model(inputs)
    if vocab_mesh is not None:
        per_token = vocab_parallel_cross_entropy(logits, labels, vocab_mesh)
    else:
        per_token = F.cross_entropy(logits.flatten(0, 1), labels.flatten(),
                                    reduction="none").view_as(labels)
    return (per_token * selected.float()).sum() / count


class MLMSolver(BaseSolver):
    """The masked-LM solver, one device a process (`cuda` unless `device`
    says so)."""

    def __init__(self, cfg, device: tp.Any = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = check_mesh(cfg.mesh, cfg.model.attention,
                               model=cfg.model, expert=TODO_EXPERT_SOLVERS)
        model_cfg = TransformerConfig(
            vocab_size=cfg.model.vocab_size, dim=cfg.model.dim,
            num_layers=cfg.model.num_layers, num_heads=cfg.model.num_heads,
            mlp_ratio=cfg.model.mlp_ratio, attention=cfg.model.attention,
            remat=cfg.model.get("remat", False), causal=False)
        self.model = TransformerLM(model_cfg, device=self.device, seed=0,
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
        self._stream = synthetic_token_stream(cfg.model.vocab_size)
        # host seconds of each train step this process ran
        self.step_seconds: tp.List[float] = []

    def get_formatter(self, stage_name):
        return Formatter({"loss": ".4f", "ppl": ".1f", "grad_norm": ".2f"})

    def batch_at(self, step: int, eval_set: bool = False
                 ) -> tp.Dict[str, np.ndarray]:
        """The global masked batch of `step` on the host (`mask_tokens`
        over the stream's tokens), bit-equal to the JAX solver's."""
        cfg = self.cfg
        tokens = self._stream(cfg.batch_size, cfg.seq_len, step,
                              subset=1 if eval_set else 0)
        return mask_tokens(tokens, step, eval_set, cfg.mask_prob,
                           int(cfg.mask_token), cfg.model.vocab_size)

    def _local(self, batch: tp.Dict[str, np.ndarray]
               ) -> tp.Tuple[torch.Tensor, float]:
        """This rank's rows of `batch` as one [rows, 3, T] tensor on the
        device, and the divisor of its selected sum: the global count
        (at least 1) over the data-parallel size."""
        shards = self.mesh.data_parallel_size
        index = self.mesh.data_parallel_index()
        rows = self.cfg.batch_size // shards
        packed = np.stack([batch["inputs"], batch["labels"],
                           batch["selected"].astype(np.int32)], axis=1)
        local = packed[index * rows:(index + 1) * rows]
        count = max(float(batch["selected"].sum()), 1.0) / shards
        return shard_batch(local, self.mesh, device=self.device).long(), \
            count

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
            packed, count = self._local(self.batch_at(global_step))
            step_metrics = train_step(
                self.train_model, self.optimizer, self.schedule,
                self.state["step"], packed,
                lambda model, batch: masked_loss(model, batch, count,
                                                 self.vocab_mesh),
                mesh=self.mesh)
            self.state["step"] += 1
            progress.observe(step_metrics["loss"])
            metrics = average(step_metrics)
            self.step_seconds.append(time.perf_counter() - t0)
            progress.update(**metrics)
        self._sync()
        # a rank's loss is its share of the global masked mean
        metrics = distrib.average_metrics(metrics)
        metrics["ppl"] = float(np.exp(min(metrics["loss"], 20.0)))
        return metrics

    def valid(self):
        average = averager()
        steps = range(self.cfg.get("valid_steps", 4))
        progress = self.log_progress("valid", steps, updates=2)
        metrics: tp.Dict[str, float] = {}
        with torch.no_grad():
            for index in progress:
                packed, count = self._local(self.batch_at(index,
                                                          eval_set=True))
                loss = masked_loss(self.model, packed, count,
                                   self.vocab_mesh)
                progress.observe(loss)
                metrics = average({"loss": loss})
                progress.update(**metrics)
        metrics = distrib.average_metrics(metrics)
        metrics["ppl"] = float(np.exp(min(metrics["loss"], 20.0)))
        return metrics

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
    """Train the masked LM; returns the solver."""
    setup_logging()
    distrib.init(backend="gloo" if cfg.get("device") == "cpu" else None)
    solver = MLMSolver(cfg, device=cfg.get("device"))
    solver.run()
    return solver


if __name__ == "__main__":
    main()
