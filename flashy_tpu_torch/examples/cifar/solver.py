"""CIFAR-10 solver: the port of examples/cifar/solver.py.

ResNet-18, ResNet-50 or `vit_tiny` (`model`) trained with SGD, one rank
a process over the mesh's `data` axis (`data_parallel: -1` is the world
size): above one rank the training step runs `parallel.wrap`
(DistributedDataParallel), and the ResNet's BatchNorm normalizes with
the global batch's statistics. Batches reach the card through
`prefetch_to_device(size=2)`.

The optimizer is the JAX package's optax chain `add_decayed_weights(wd)`
then `sgd(cosine, momentum, nesterov=True)`, which is the recurrence of
`torch.optim.SGD(weight_decay=wd, momentum=m, nesterov=True,
dampening=0)`; the learning rate is set before each update from optax's
closed form `lr * 0.5 * (1 + cos(pi * min(count, T) / T))` at the update
count before it, with T = epochs * min(len(train), max_batches).

Eval runs on `pad_to_even` batches with a `valid` mask and sums, so a
sharded eval equals an unsharded one. Each stage reports images/s; the
run ends by reporting against `target_acc`, which applies to real
CIFAR-10 only.
"""
import time
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from ... import distrib
from ...data import prefetch_to_device
from ...formatter import Formatter
from ...models import resnet18, resnet50, vit_tiny
from ...parallel.data_parallel import wrap
from ...parallel.mesh import make_mesh
from ...solver import BaseSolver
from ...utils import averager, resolve_device
from ..lm.solver import lr_schedule

MODELS = {"resnet18": resnet18, "resnet50": resnet50, "vit_tiny": vit_tiny}


class Solver(BaseSolver):
    def __init__(self, cfg, loaders, is_real: bool = False,
                 device: tp.Any = None):
        super().__init__()
        self.cfg = cfg
        self.loaders = loaders
        self.is_real = is_real
        self.device = resolve_device(device)
        self.model = MODELS[cfg.model](num_classes=10, device=self.device,
                                       seed=0)
        n_data = cfg.data_parallel if cfg.data_parallel > 0 \
            else distrib.world_size()
        self.mesh = make_mesh({"data": n_data})
        steps_per_epoch = max(1, len(loaders["train"]))
        if cfg.max_batches is not None:
            # budgeted runs must anneal over the steps that will run
            steps_per_epoch = min(steps_per_epoch, cfg.max_batches)
        # optax's cosine_decay_schedule: the LM's warm-up cosine, no warm-up
        self.schedule = lr_schedule(cfg.lr, 0, cfg.epochs * steps_per_epoch)
        self.optimizer = torch.optim.SGD(
            self.model.parameters(), lr=self.schedule(0),
            momentum=cfg.momentum, dampening=0.0,
            weight_decay=cfg.weight_decay, nesterov=True)
        # the update count, which the schedule reads
        self.state: tp.Dict[str, int] = {"step": 0}
        self.register_stateful("model", "optimizer", "state")
        # every rank normalizes with the global batch's statistics, so
        # the buffers agree without DDP's broadcast
        self.train_model = wrap(self.model, broadcast_buffers=False)

    def train_step(self, batch: tp.Dict[str, torch.Tensor]
                   ) -> tp.Dict[str, torch.Tensor]:
        """One SGD update on `batch` ({"image", "label"}); returns the
        loss and the accuracy as device scalars."""
        labels = batch["label"].long()
        logits = self.train_model(batch["image"], train=True)
        loss = F.cross_entropy(logits, labels)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.state["step"])
        self.optimizer.step()
        self.state["step"] += 1
        acc = (logits.argmax(-1) == labels).float().mean()
        return {"loss": loss.detach(), "acc": acc}

    def eval_step(self, batch: tp.Dict[str, torch.Tensor]
                  ) -> tp.Dict[str, torch.Tensor]:
        """Sums over the batch's valid rows (`batch["valid"]`, 0/1):
        padding rows count nothing, so the host can weight by the true
        count."""
        labels = batch["label"].long()
        with torch.no_grad():
            logits = self.model(batch["image"], train=False)
            loss_vec = F.cross_entropy(logits, labels, reduction="none")
            correct = (logits.argmax(-1) == labels).float()
            valid = batch["valid"]
            return {"loss_sum": (loss_vec * valid).sum(),
                    "acc_sum": (correct * valid).sum(), "n": valid.sum()}

    def get_formatter(self, stage_name):
        return Formatter({"acc": ".1%", "loss": ".5f",
                          "images_per_sec": ".0f"})

    def _run_epoch(self, train: bool):
        loader = self.loaders["train" if train else "valid"]
        loader.set_epoch(self.epoch)
        average = averager()
        progress = self.log_progress(self.current_stage, loader, updates=5)
        metrics: tp.Dict[str, float] = {}
        count = 0.0
        begin = time.time()
        if train:
            source = progress
        else:
            # the validity mask rides with the batch
            source = ({**batch, "valid": mask.astype(np.float32)}
                      for batch, mask in progress)
        batches = prefetch_to_device(source, size=2, mesh=self.mesh,
                                     device=self.device)
        batch = None
        for index, batch in enumerate(batches):
            if self.cfg.max_batches is not None \
                    and index >= self.cfg.max_batches:
                break
            if train:
                step_metrics = self.train_step(batch)
                weight = float(len(batch["label"]))
                metrics = average(step_metrics, weight=weight)
            else:
                sums = {k: float(v) for k, v in self.eval_step(batch).items()}
                weight = sums["n"]
                if weight:
                    metrics = average({"loss": sums["loss_sum"] / weight,
                                       "acc": sums["acc_sum"] / weight},
                                      weight=weight)
            progress.update(**metrics)
            count += weight
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        metrics["images_per_sec"] = count / max(time.time() - begin, 1e-9)
        if not train and batch is not None:
            self.log_image("valid", "sample",
                           batch["image"][0].cpu().numpy() * 0.25 + 0.5)
        # the weighted mean over the processes (the identity in one)
        return distrib.average_metrics(metrics, count)

    def run(self):
        restored = self.restore()
        self.logger.info("Restored: %s; starting at epoch %d", restored,
                         self.epoch)
        self.log_hyperparams(dict(self.cfg))
        for _ in range(self.epoch, self.cfg.epochs + 1):
            self.run_stage("train", self._run_epoch, train=True)
            self.run_stage("valid", self._run_epoch, train=False)
            self.commit()
        self._report_target_acc()

    def _report_target_acc(self):
        """BASELINE.md target 2: the accuracy to reach, judged on real
        data only."""
        target = self.cfg.get("target_acc")
        if not target or not self.history:
            return
        acc = self.history[-1].get("valid", {}).get("acc")
        if acc is None:
            return
        if not self.is_real:
            self.logger.info(
                "valid acc %.2f%% on SYNTHETIC data; target_acc=%.2f%% only "
                "applies to real CIFAR-10 (set data_root / FLASHY_TPU_CIFAR)",
                100 * acc, 100 * target)
        elif acc >= target:
            self.logger.info("baseline accuracy REACHED: %.2f%% >= %.2f%%",
                             100 * acc, 100 * target)
        else:
            self.logger.warning("baseline accuracy MISSED: %.2f%% < %.2f%%",
                                100 * acc, 100 * target)
