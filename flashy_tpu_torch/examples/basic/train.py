"""The smallest complete solver (the port of examples/basic/train.py):
linear regression on random data.

    python -m flashy_tpu_torch.examples.basic.train [key=value ...]

`MLP([1])` (a Linear(32 -> 1)) trained with Adam on ten batches an epoch
drawn from `np.random.default_rng(epoch)`, `y = 0.1 * x.sum(1)`; the
model, the optimizer and the best state so far (on the host) are
registered as stateful, TensorBoard is attached, and every second epoch
writes a checkpoint, so a resumed run repeats the uninterrupted one. It
runs on the card; `device=cpu` runs it on the host.
"""
import typing as tp

import numpy as np
import torch

from ... import distrib
from ...logging import setup_logging
from ...models import MLP
from ...solver import BaseSolver
from ...utils import averager, resolve_device
from ...xp import main as xp_main

IN_FEATURES = 32


class Solver(BaseSolver):
    def __init__(self, cfg, device: tp.Any = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = MLP([1], in_features=IN_FEATURES, device=self.device,
                         seed=0)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=cfg.lr)
        self.best_state: tp.Dict[str, tp.Any] = {}
        self.register_stateful("model", "optimizer", "best_state")
        self.init_tensorboard()

    def step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """One Adam update on the mean squared error; returns the loss."""
        loss = torch.mean((self.model(x) - y) ** 2)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def train(self):
        average = averager()
        rng = np.random.default_rng(self.epoch)
        metrics: tp.Dict[str, float] = {}
        for _ in range(10):
            x = torch.from_numpy(rng.normal(
                size=(self.cfg.batch_size, IN_FEATURES)).astype(np.float32)
            ).to(self.device)
            y = x.sum(dim=1, keepdim=True) * 0.1
            metrics = average({"loss": self.step(x, y)})
        return metrics

    def run(self):
        self.restore()
        for epoch in range(self.epoch, self.cfg.epochs + 1):
            metrics = self.run_stage("train", self.train)
            if not self.best_state or \
                    metrics["loss"] < self.best_state.get("loss", 1e9):
                self.best_state = {
                    "loss": metrics["loss"],
                    "params": {k: v.detach().cpu().clone() for k, v
                               in self.model.state_dict().items()}}
            self.commit(save_checkpoint=epoch % 2 == 0)


@xp_main(config_path="config")
def main(cfg):
    """Train the linear regression; returns the solver."""
    setup_logging()
    distrib.init(backend="gloo" if cfg.get("device") == "cpu" else None)
    solver = Solver(cfg, device=cfg.get("device"))
    solver.run()
    return solver


if __name__ == "__main__":
    main()
