"""Adversarial (GAN-style) training helper: the port of
flashy_tpu/adversarial.py.

`AdversarialLoss` holds a discriminator, its optimizer and its training
step, so that a training loop stays simple and `register_stateful` of one
attribute checkpoints both (`state_dict`: {"params", "optimizer"}). In
PyTorch's idiom the discriminator is an `nn.Module` and its optimizer a
`torch.optim.Optimizer`, where the JAX package takes an apply function,
a parameter tree and an optax transformation:

- `train_adv(fake, real)` detaches both inputs, so no gradient reaches
  the generator, back-propagates `loss(D(fake), 1) + loss(D(real), 0)`,
  averages D's gradients over the processes (`distrib.sync_gradients`)
  and steps the optimizer.
- `gen_loss(fake)` (and calling the object) is `loss(D(fake), 0)` with D
  frozen: D runs through `torch.func.functional_call` on detached
  parameters, so the gradient reaches `fake` (and the generator behind
  it) while D's `.grad` stays untouched, the role of the JAX package's
  `freeze`.

Convention, as in the JAX package: the adversary outputs high logits for
the samples it believes fake.
"""
import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from . import distrib
from .utils import freeze

LossFn = tp.Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def bce_with_logits(logits: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Binary cross entropy on logits, mean-reduced (the default GAN
    loss)."""
    return F.binary_cross_entropy_with_logits(logits, targets)


class AdversarialLoss:
    """Wraps a discriminator, its optimizer and its training step.

    Args:
        adversary: the discriminator, `x -> logits`; broadcast from
            process 0 at construction, so every process starts from the
            same one.
        optimizer: the discriminator's optimizer.
        loss: loss on (logits, targets); default BCE with logits.

    Example::

        adv = AdversarialLoss(disc, torch.optim.Adam(disc.parameters()))
        for real in loader:
            fake = generator(noise)
            adv.train_adv(fake, real)       # one D step
            loss_g = adv(fake)              # generator loss, D frozen
    """

    def __init__(self, adversary: nn.Module,
                 optimizer: torch.optim.Optimizer,
                 loss: LossFn = bce_with_logits):
        self.adversary = distrib.broadcast_model(adversary)
        self.optimizer = optimizer
        self.loss = loss

    def train_adv(self, fake: torch.Tensor,
                  real: torch.Tensor) -> torch.Tensor:
        """One discriminator step on the given fake and real batch; the
        gradients are averaged over the processes before the update.
        Returns the D loss (detached)."""
        logit_fake_is_fake = self.adversary(fake.detach())
        logit_real_is_fake = self.adversary(real.detach())
        loss = (self.loss(logit_fake_is_fake,
                          torch.ones_like(logit_fake_is_fake))
                + self.loss(logit_real_is_fake,
                            torch.zeros_like(logit_real_is_fake)))
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        distrib.sync_gradients(self.adversary)
        self.optimizer.step()
        return loss.detach()

    def gen_loss(self, fake: torch.Tensor) -> torch.Tensor:
        """Generator loss: how well `fake` fools the frozen adversary."""
        weights = freeze(dict(self.adversary.named_parameters()))
        weights.update(self.adversary.named_buffers())
        logit_fake_is_fake = torch.func.functional_call(
            self.adversary, weights, (fake,))
        return self.loss(logit_fake_is_fake,
                         torch.zeros_like(logit_fake_is_fake))

    __call__ = gen_loss

    # checkpointing: D's parameters and its optimizer in one entry
    def state_dict(self) -> tp.Dict[str, tp.Any]:
        return {"params": self.adversary.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: tp.Mapping[str, tp.Any]) -> None:
        self.adversary.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["optimizer"])
