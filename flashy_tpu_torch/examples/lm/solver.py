"""LM solver: decoder-only language-model training on one card (the port
of examples/lm/solver.py).

    python -m flashy_tpu_torch.examples.lm.solver [key=value ...]

Trains the TransformerLM on a synthetic Markov token stream through the
port's harness (`BaseSolver`, XP folders, single-file checkpoints). With
`model.attention=flash` (the default) every attention call runs the
Hopper flash kernels, forward on every step and the fused backward on
every training step. With `model.attention=ring_fused` (or `ring`) and
`mesh.seq > 1` the sequence is cut over `mesh.seq` ring ranks that share
the card: every forward runs the Hopper ring-attention kernel once per
rank (`ring` the flash forward per block instead), every backward the
split flash kernels once per visible (rank, ring step) pair. With
`model.moe_experts > 0` every MLP is a routed
MoE and the loss adds `model.moe_aux_weight` times the load-balancing
loss; `model.moe_dispatch=dropless` runs the expert projections through
the Hopper grouped-GEMM kernels, forward and backward. It runs on the
card; `device=cpu` runs it on the host, and nothing else does.

`model.remat=true` recomputes each block in the backward, saving what
`model.remat_policy` (full | dots | dots_no_batch) says. `ema_decay > 0`
(a key the config does not list, read with a default of 0, as the JAX
solver reads it) keeps an f32 EMA shadow of every parameter in
`self.state["ema"]`, folded in after every update with the warm-up
decay of `ema.ema_update` and checkpointed with the rest; `valid`
evaluates the shadow, `generate` the live parameters. `value_and_grad`
and `train_step` take a `dropout_seed` for models with `dropout > 0`
(each microbatch folds its index in); the solver itself trains without
dropout, as the JAX solver does.

The optimizer is the JAX package's optax chain, written out so a test
can drive it on any model: `clip_by_global_norm(1.0)` (no epsilon, the
norm taken before clipping is the logged `grad_norm`), then AdamW (eps
1e-8, betas (0.9, 0.999), decay `lr_t * wd * p` on every parameter)
under `warmup_cosine_decay_schedule(0, lr, warmup, total)`, read at the
step count before the update, so the first update has lr 0.
"""
import math
import time
import typing as tp

import numpy as np
import torch
from torch import nn

from ... import distrib
from ...ema import ema_update
from ...formatter import Formatter
from ...logging import setup_logging
from ...models.decoding import generate as lm_generate
from ...models.transformer import (TransformerConfig, TransformerLM,
                                   fold_seed)
from ...ops.losses import lm_next_token_loss
from ...parallel.mesh import Mesh, make_mesh
from ...solver import BaseSolver
from ...utils import averager, resolve_device
from ...xp import main as xp_main


def synthetic_token_stream(vocab_size: int, seed: int = 0):
    """Deterministic Markov-ish token generator: next-token structure a
    model can actually learn, so loss curves are meaningful without a
    real corpus (zero-egress environments).

    `subset` namespaces independent sample streams over the SAME token
    distribution (the Markov transition table depends only on `seed`):
    train draws subset 0, eval subset 1. The streams are separated by
    feeding (seed, subset, step) to numpy's SeedSequence — proper
    entropy hashing, unlike an arithmetic step offset, which collides
    once training steps walk into the offset range."""
    rng = np.random.default_rng(seed)
    mixing = rng.integers(1, vocab_size - 1, size=257)

    def batch(batch_size: int, seq_len: int, step: int,
              subset: int = 0) -> np.ndarray:
        gen = np.random.default_rng([seed, subset, step])
        tokens = np.empty((batch_size, seq_len), np.int64)
        tokens[:, 0] = gen.integers(0, vocab_size, batch_size)
        noise = gen.random((batch_size, seq_len)) < 0.15
        jumps = gen.integers(0, vocab_size, (batch_size, seq_len))
        for t in range(1, seq_len):
            follow = (tokens[:, t - 1] * 31 + mixing[tokens[:, t - 1] % 257]) % vocab_size
            tokens[:, t] = np.where(noise[:, t], jumps[:, t], follow)
        return tokens.astype(np.int32)

    return batch


def lr_schedule(peak: float, warmup: int, total: int
                ) -> tp.Callable[[int], float]:
    """optax `warmup_cosine_decay_schedule(0, peak, warmup, total)`:
    linear from 0 over `warmup` steps, then a cosine to 0 at `total`."""

    def schedule(count: int) -> float:
        if count < warmup:
            return peak * count / warmup
        decay = total - warmup
        t = min(count - warmup, decay)
        return peak * 0.5 * (1.0 + math.cos(math.pi * t / decay))

    return schedule


def build_optimizer(model: nn.Module, cfg: tp.Mapping
                    ) -> tp.Tuple[torch.optim.AdamW, tp.Callable]:
    """AdamW over every parameter and its schedule, sized as the JAX
    solver sizes it: total = max(epochs * steps_per_epoch, 2) steps,
    warmup = min(warmup_steps, total // 2)."""
    total = max(cfg["epochs"] * cfg["steps_per_epoch"], 2)
    warmup = min(cfg["warmup_steps"], total // 2)
    schedule = lr_schedule(cfg["lr"], warmup, total)
    optimizer = torch.optim.AdamW(model.parameters(), lr=schedule(0),
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=cfg["weight_decay"])
    return optimizer, schedule


def value_and_grad(model: nn.Module, loss_fn: tp.Callable,
                   tokens: torch.Tensor, accumulate: int = 1,
                   dropout_seed: tp.Optional[int] = None) -> torch.Tensor:
    """The loss, with the gradients left in each parameter's `.grad`.

    With `accumulate` > 1 the batch is split into that many microbatches
    run in sequence (peak activation memory divided by `accumulate`):
    the f32 gradients and losses are summed, then scaled by
    1/accumulate, as `with_grad_accumulation` does. With `dropout_seed`
    the loss is called as `loss_fn(model, micro, dropout_seed=s)`, `s`
    the seed with the microbatch index folded in (`fold_seed`), so each
    microbatch draws its own masks, as `with_grad_accumulation
    (fold_rng=True)` folds the index into a PRNG key.
    """
    model.zero_grad(set_to_none=True)
    if tokens.shape[0] % accumulate:
        raise ValueError(f"batch {tokens.shape[0]} does not split into "
                         f"{accumulate} microbatches")
    total = None
    for index, micro in enumerate(
            tokens.split(tokens.shape[0] // accumulate)):
        if dropout_seed is None:
            loss = loss_fn(model, micro)
        else:
            loss = loss_fn(model, micro,
                           dropout_seed=fold_seed(dropout_seed, index))
        loss.backward()
        loss = loss.detach().float()
        total = loss if total is None else total + loss
    if accumulate > 1:
        scale = 1.0 / accumulate
        for param in model.parameters():
            if param.grad is not None:
                param.grad.mul_(scale)
        total = total * scale
    return total


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
               schedule: tp.Callable[[int], float], step: int,
               tokens: torch.Tensor, loss_fn: tp.Callable,
               accumulate: int = 1, max_norm: float = 1.0,
               dropout_seed: tp.Optional[int] = None
               ) -> tp.Dict[str, torch.Tensor]:
    """One update at step count `step` (before the increment): loss and
    grads (`value_and_grad`, with `dropout_seed`), the global norm,
    optax's clip (`g / norm * max_norm` once the norm reaches
    `max_norm`, no epsilon), AdamW at `schedule(step)`. Returns the loss
    and the unclipped `grad_norm` as device scalars."""
    loss = value_and_grad(model, loss_fn, tokens, accumulate, dropout_seed)
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    norm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
    for grad in grads:
        grad.copy_(torch.where(norm < max_norm, grad,
                               grad / norm * max_norm))
    for group in optimizer.param_groups:
        group["lr"] = schedule(step)
    optimizer.step()
    return {"loss": loss, "grad_norm": norm}


def check_mesh(mesh: tp.Mapping, attention: str) -> Mesh:
    """The run's mesh, its ranks on the model's card: `data: -1`
    resolves to 1, `seq` above 1 is a ring and needs `attention` 'ring'
    or 'ring_fused' (with any other attention a `seq` axis would do
    nothing on one card), and any other axis above 1 raises
    NotImplementedError naming its ROADMAP item (`make_mesh`)."""
    built = make_mesh({axis: int(size) for axis, size in mesh.items()})
    if built.shape["seq"] > 1 and attention not in ("ring", "ring_fused"):
        raise ValueError(f"mesh.seq={built.shape['seq']} cuts the sequence "
                         f"over a ring, which needs model.attention=ring or "
                         f"ring_fused, got {attention!r}")
    return built


class LMSolver(BaseSolver):
    """The LM solver on one device (`cuda` unless `device` says so)."""

    def __init__(self, cfg, device: tp.Any = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = check_mesh(cfg.mesh, cfg.model.attention)
        model_cfg = TransformerConfig(
            vocab_size=cfg.model.vocab_size, dim=cfg.model.dim,
            num_layers=cfg.model.num_layers, num_heads=cfg.model.num_heads,
            mlp_ratio=cfg.model.mlp_ratio, attention=cfg.model.attention,
            remat=cfg.model.get("remat", False),
            remat_policy=cfg.model.get("remat_policy", "full"),
            scan_layers=cfg.model.get("scan_layers", False),
            moe_experts=cfg.model.get("moe_experts", 0),
            moe_top_k=cfg.model.get("moe_top_k", 1),
            moe_capacity_factor=cfg.model.get("moe_capacity_factor", 1.25),
            moe_dispatch=cfg.model.get("moe_dispatch", "einsum"))
        self.moe = model_cfg.moe_experts > 0
        self.aux_weight = float(cfg.model.get("moe_aux_weight", 0.01))
        if cfg.get("loss", "dense") == "chunked" and self.moe:
            raise ValueError(
                "loss=chunked is not supported with MoE or pipeline "
                "parallelism (those paths need logits + aux losses); "
                "use loss=dense.")
        self.model = TransformerLM(model_cfg, device=self.device, seed=0,
                                   mesh=self.mesh)
        self.optimizer, self.schedule = build_optimizer(self.model, cfg)
        # the update count: the schedule reads it, so it is checkpointed;
        # with ema_decay > 0 also the EMA shadow, name -> f32 tensor
        self.state: tp.Dict[str, tp.Any] = {"step": 0}
        self.ema_decay = float(cfg.get("ema_decay", 0.0))
        if self.ema_decay > 0.0:
            self.reset_ema()
        self.register_stateful("model", "optimizer", "state")
        self._stream = synthetic_token_stream(cfg.model.vocab_size)
        self.restored = False
        # host seconds and loss of each train step this process ran
        self.step_seconds: tp.List[float] = []
        self.step_losses: tp.List[float] = []

    def reset_ema(self) -> None:
        """(Re)start the EMA shadow as an f32 copy of the live params."""
        self.state["ema"] = {name: p.detach().float().clone() for name, p
                             in self.model.named_parameters()}

    def loss(self, tokens: torch.Tensor,
             params: tp.Optional[tp.Mapping[str, torch.Tensor]] = None
             ) -> torch.Tensor:
        """Mean next-token CE, plus `moe_aux_weight` times the MoE layers'
        load-balancing loss for an MoE model; with `params` (name ->
        tensor, e.g. the EMA shadow) the model runs on those instead of
        its own (`torch.func.functional_call`)."""
        model: tp.Callable = self.model
        if params is not None:
            def model(*args, **kwargs):
                return torch.func.functional_call(self.model, params, args,
                                                  kwargs)
        return lm_next_token_loss(model, tokens,
                                  aux_weight=self.aux_weight if self.moe
                                  else None,
                                  mode=self.cfg.get("loss", "dense"),
                                  chunk_size=int(self.cfg.get("loss_chunk",
                                                              256)))

    def get_formatter(self, stage_name):
        return Formatter({"loss": ".4f", "ppl": ".1f", "grad_norm": ".2f",
                          "tokens_per_sec": ".0f"})

    def batch_at(self, step: int, eval_set: bool = False) -> torch.Tensor:
        # held-out data: an independently seeded subset of the same
        # distribution (see synthetic_token_stream)
        host = self._stream(self.cfg.batch_size, self.cfg.seq_len, step,
                            subset=1 if eval_set else 0)
        return torch.from_numpy(host).long().to(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self):
        cfg = self.cfg
        average = averager()
        progress = self.log_progress("train", range(cfg.steps_per_epoch),
                                     updates=5)
        metrics: tp.Dict[str, float] = {}
        begin = time.time()
        tokens_seen = 0
        for index in progress:
            global_step = (self.epoch - 1) * cfg.steps_per_epoch + index
            t0 = time.perf_counter()
            step_metrics = train_step(
                self.model, self.optimizer, self.schedule,
                self.state["step"], self.batch_at(global_step),
                lambda model, tokens: self.loss(tokens),
                accumulate=int(cfg.get("accumulate", 1)))
            if "ema" in self.state:
                # after the update, at the step count before it
                params = dict(self.model.named_parameters())
                ema_update(self.state["ema"],
                           [params[name] for name in self.state["ema"]],
                           self.ema_decay, step=self.state["step"])
            self.state["step"] += 1
            # reading the metrics to the host waits for the whole step
            metrics = average(step_metrics)
            self.step_seconds.append(time.perf_counter() - t0)
            self.step_losses.append(float(step_metrics["loss"]))
            tokens_seen += cfg.batch_size * cfg.seq_len
            progress.update(**metrics)
        self._sync()
        metrics["ppl"] = float(np.exp(min(metrics["loss"], 20.0)))
        metrics["tokens_per_sec"] = tokens_seen / (time.time() - begin)
        return metrics

    def valid(self):
        """Held-out loss: the same loss function, no update; on the EMA
        shadow when there is one (the eval weights), as the JAX solver
        evaluates it."""
        average = averager()
        steps = range(self.cfg.get("valid_steps", 4))
        progress = self.log_progress("valid", steps, updates=2)
        metrics: tp.Dict[str, float] = {}
        with torch.no_grad():
            for index in progress:
                loss = self.loss(self.batch_at(index, eval_set=True),
                                 params=self.state.get("ema"))
                metrics = average({"loss": loss})
                progress.update(**metrics)
        metrics["ppl"] = float(np.exp(min(metrics["loss"], 20.0)))
        return metrics

    def generate(self):
        """Sample a continuation with the KV-cache decoder and log it."""
        prompt = self._stream(2, 16, step=0)[:, :16]
        generator = torch.Generator(device=self.device).manual_seed(
            self.epoch)
        begin = time.time()
        out = lm_generate(self.model, prompt, max_new_tokens=32,
                          temperature=1.0, generator=generator,
                          device=self.device).cpu().numpy()
        self.log_text("generate", "sample",
                      " ".join(str(int(t)) for t in out[0]))
        return {"gen_tokens_per_sec":
                out.shape[0] * 32 / (time.time() - begin)}

    def _reconcile_ema(self) -> None:
        """Align the restored state with this run's `ema_decay`, loudly:
        a checkpoint without a shadow resumed with EMA on gets a fresh
        shadow from the restored params; a shadow resumed with EMA off
        is dropped. A restored shadow goes back onto the params' devices
        (the checkpoint loads onto the CPU), bit for bit."""
        if self.ema_decay > 0.0 and "ema" not in self.state:
            self.logger.warning(
                "checkpoint has no EMA shadow but ema_decay=%s: "
                "re-initializing the shadow from the restored params",
                self.ema_decay)
            self.reset_ema()
        elif self.ema_decay <= 0.0 and "ema" in self.state:
            self.logger.warning(
                "ema_decay=0 but the checkpoint carries an EMA shadow: "
                "dropping it (eval will use the live params)")
            del self.state["ema"]
        elif "ema" in self.state:
            params = dict(self.model.named_parameters())
            self.state["ema"] = {
                name: shadow.to(params[name].device, torch.float32)
                for name, shadow in self.state["ema"].items()}

    def run(self):
        self.restored = self.restore()
        if self.restored:
            self._reconcile_ema()
        self.logger.info("Restored: %s; starting at epoch %d", self.restored,
                         self.epoch)
        want_generate = bool(self.cfg.get("generate_every"))
        for epoch in range(self.epoch, self.cfg.epochs + 1):
            self.run_stage("train", self.train)
            if self.cfg.get("valid_steps", 4):
                self.run_stage("valid", self.valid)
            if want_generate and epoch % self.cfg.generate_every == 0:
                self.run_stage("generate", self.generate)
            self.commit()


@xp_main(config_path="config")
def main(cfg):
    """Train the TransformerLM; returns the solver."""
    setup_logging()
    distrib.init()
    solver = LMSolver(cfg, device=cfg.get("device"))
    solver.run()
    return solver


if __name__ == "__main__":
    main()
