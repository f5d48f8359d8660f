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

`--workers=N` runs N data-parallel processes (`xp.main`), one rank
each (`distrib.init`: gloo on the CPU and where ranks share a card, NCCL
with a card a rank): `batch_size` stays the global batch, each rank
trains on its contiguous `batch_size / N` rows of it through
`parallel.wrap` (DistributedDataParallel), the logged train and valid
metrics are averaged over the ranks (`distrib.average_metrics`), and rank
0 writes the checkpoint and the history while every rank restores it.
With `mesh.fsdp > 1` (`mesh.data x mesh.fsdp` = N) the model is wrapped
in FSDP form under `transformer_shardings` (`wrap_model`): each rank
holds its shards of the parameters and of the AdamW moments, gathers a
block's parameters around its forward and backward, reduce-scatters the
gradients, and the clip's global norm sums the shards' squares over the
`fsdp` group; with `checkpoint_mode=sharded` every rank writes its
shards into the slots, and a single file is gathered and written by
rank 0.

With `mesh.pipe > 1` (`mesh.data x mesh.pipe` = N) the block stack is
scan-stacked (forced, as in the JAX solver) and cut over the pipe ranks
(`wrap_model`: each rank keeps its chunks of `pipeline_interleave`
virtual stages), and every step runs `models.pipelined_value_and_grad`
under `pipeline_schedule` (gpipe | 1f1b | packed_1f1b) over
`pipeline_microbatches` microbatches (default: the pipe size): the hops
are point-to-point sends between the ranks, the embedding's and
`norm_f`'s gradients are summed over the pipe ranks, the data-parallel
ranks of each stage average theirs (`average_over_data`), and the clip's
norm sums the block leaves' squares over the pipe group. Eval runs
`models.pipelined_apply` (packed_1f1b's forward is 1f1b's). The train
stage logs `bubble_frac` and `peak_stash_bytes` (`_pipeline_stats`).
`mesh.pipe` with `mesh.fsdp`, `mesh.tensor` or `mesh.seq` above 1, and
`loss=chunked` with it, raise.

With `+mesh.expert=E` above 1 (a key the config does not list, as the
JAX solver's does not) and `model.moe_experts` divisible by it, the MoE
blocks' experts are sharded over the expert ranks (`wrap_model`: each
rank holds `moe_experts / E` of every block's experts): the expert ranks
take the same rows, `model.moe_dispatch=dropless_ep` cuts each MoE
layer's tokens over them and exchanges the assignments by all-to-all
(`parallel.moe_ep`), the other dispatches compute each rank's experts'
assignments and sum the block's output over the expert ranks; every
other parameter's gradients are averaged over the expert ranks with the
data-parallel ones (`parallel.wrap`), and the clip's norm sums the
experts' squares over the expert group. `expert`
composes with `data` and `tensor`; with `fsdp`, `pipe` or `seq` it
raises.

The train loop calls `check_preemption()` after every step, so a
preemption guard in 'abandon_stage' mode
(`solver.enable_preemption_guard(mode="abandon_stage")`) stops the stage
there; in the default 'finish_stage' mode the stage finishes and the run
stops at the next boundary with exit code 75.

The optimizer is the JAX package's optax chain, written out so a test
can drive it on any model: `clip_by_global_norm(1.0)` (no epsilon, the
norm taken before clipping is the logged `grad_norm`), then AdamW (eps
1e-8, betas (0.9, 0.999), decay `lr_t * wd * p` on every parameter)
under `warmup_cosine_decay_schedule(0, lr, warmup, total)`, read at the
step count before the update, so the first update has lr 0.
"""
import contextlib
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
from ...models.pipelined import pipelined_apply, pipelined_value_and_grad
from ...models.transformer import (RowShard, TransformerConfig,
                                   TransformerLM)
from ...ops.losses import lm_next_token_loss
from ...parallel.data_parallel import (TODO_PIPE_SHARDED, average_over_data,
                                       grad_norm, shard_batch,
                                       with_grad_accumulation, wrap)
from ...parallel.mesh import Mesh, make_mesh
from ...parallel.schedules import KNOWN_SCHEDULES
from ...parallel.tensor import validate_tensor_args
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
                   dropout_seed: tp.Optional[int] = None,
                   mesh: tp.Optional[Mesh] = None,
                   grad_fn: tp.Optional[tp.Callable] = None) -> torch.Tensor:
    """The loss, with the gradients left in each parameter's `.grad`.

    With `accumulate` > 1 the batch is split into that many microbatches
    run in sequence (peak activation memory divided by `accumulate`):
    `parallel.with_grad_accumulation` sums the f32 gradients and losses,
    then scales them by 1/accumulate, and folds the microbatch index into
    `dropout_seed` (the loss is called as `loss_fn(model, micro,
    dropout_seed=s)`), so each microbatch draws its own masks. `model`
    may be `parallel.wrap`'s DistributedDataParallel: the gradients are
    then averaged over the ranks once a step, and a `dropout_seed`
    becomes the rank's `RowShard`, so ranks holding contiguous rows of
    the global batch draw the masks one process would draw over it. Over
    a `mesh` with a 'tensor' axis the rows are the data-parallel
    process's (`mesh.data_parallel_index()` of `data_parallel_size`), so
    the ranks of a tensor group, which hold the same rows, draw the same
    masks. `grad_fn(model, micro, **kwargs) -> loss`, where given, adds
    the microbatch's gradients into `.grad` itself (a pipelined model's
    schedule) in place of `loss_fn`'s backward.
    """
    model.zero_grad(set_to_none=True)
    kwargs = {}
    if dropout_seed is not None:
        shard, shards = (distrib.rank(), distrib.world_size()) \
            if mesh is None else (mesh.data_parallel_index(),
                                  mesh.data_parallel_size)
        kwargs["dropout_seed"] = dropout_seed if shards == 1 \
            else RowShard(int(dropout_seed), shard, shards)

    def loss_and_grad(model, micro, **kwargs):
        loss = loss_fn(model, micro, **kwargs)
        loss.backward()
        return loss.detach().float()

    if tokens.shape[0] % accumulate:
        raise ValueError(f"batch {tokens.shape[0]} does not split into "
                         f"{accumulate} microbatches")
    return with_grad_accumulation(grad_fn or loss_and_grad, accumulate)(
        model, tokens, **kwargs)


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
               schedule: tp.Callable[[int], float], step: int,
               tokens: torch.Tensor, loss_fn: tp.Callable,
               accumulate: int = 1, max_norm: float = 1.0,
               dropout_seed: tp.Optional[int] = None,
               mesh: tp.Optional[Mesh] = None,
               grad_fn: tp.Optional[tp.Callable] = None
               ) -> tp.Dict[str, torch.Tensor]:
    """One update at step count `step` (before the increment): loss and
    grads (`value_and_grad`, with `dropout_seed`, `mesh` and `grad_fn`),
    the global norm,
    optax's clip (`g / norm * max_norm` once the norm reaches
    `max_norm`, no epsilon), AdamW at `schedule(step)`. Returns the loss
    and the unclipped `grad_norm` as device scalars."""
    loss = value_and_grad(model, loss_fn, tokens, accumulate, dropout_seed,
                          mesh, grad_fn)
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    # the whole gradient's norm: a sharded parameter's squares summed
    # over its axes, a replicated one's counted once
    norm = grad_norm(model.parameters())
    for grad in grads:
        grad.copy_(torch.where(norm < max_norm, grad,
                               grad / norm * max_norm))
    for group in optimizer.param_groups:
        group["lr"] = schedule(step)
    optimizer.step()
    return {"loss": loss, "grad_norm": norm}


# the solvers whose models have no MoE blocks refuse mesh.expert > 1
TODO_EXPERT_SOLVERS = ("ROADMAP.md queue A item 8f (expert parallelism in "
                       "the MLM and translate solvers)")


def check_mesh(mesh: tp.Mapping, attention: str,
               fsdp: tp.Optional[str] = None,
               model: tp.Optional[tp.Mapping] = None,
               expert: tp.Optional[str] = None) -> Mesh:
    """The run's mesh: `data: -1` resolves to the world size over `fsdp`,
    `expert`, `pipe` and `tensor` (the process axes: a rank a process; 1
    in one process), `seq` above 1 is a ring whose ranks share the
    process's card and needs `attention` 'ring' or 'ring_fused' (with any
    other attention a `seq` axis would do nothing on one card), `pipe`
    above 1 is a pipeline over the pipe ranks (processes), `expert` above
    1 shards the MoE blocks' experts over the expert ranks (processes)
    and needs `model.moe_experts` above 0 and divisible by it
    (ValueError); `pipe` with `fsdp`, `tensor` or `seq` above 1, `expert`
    with `fsdp`, `pipe` or `seq` above 1, or `seq` with `tensor` raise
    NotImplementedError naming their ROADMAP item (`make_mesh`, item 8f
    for pipe's). With `model` (the config's model section) a `tensor`
    width is held to its heads and MLP width (`validate_tensor_args`). A
    solver whose model has no FSDP specs passes the ROADMAP item that
    brings them as `fsdp`, and one whose model has no expert-parallel
    layers the item that brings them as `expert`: `mesh.fsdp` or
    `mesh.expert` above 1 then raises NotImplementedError naming it."""
    built = make_mesh({axis: int(size) for axis, size in mesh.items()})
    if fsdp is not None and built.shape["fsdp"] > 1:
        raise NotImplementedError(f"mesh.fsdp={built.shape['fsdp']} needs "
                                  f"this model's shardings: {fsdp}")
    if expert is not None and built.shape["expert"] > 1:
        raise NotImplementedError(f"mesh.expert={built.shape['expert']} "
                                  f"needs this model's expert layers: "
                                  f"{expert}")
    if built.shape["pipe"] > 1:
        others = [f"{axis}={built.shape[axis]}"
                  for axis in ("fsdp", "tensor", "seq")
                  if built.shape[axis] > 1]
        if others:
            raise NotImplementedError(
                f"mesh.pipe={built.shape['pipe']} with {', '.join(others)} "
                f"is not ported yet: {TODO_PIPE_SHARDED}")
    if built.shape["seq"] > 1 and attention not in ("ring", "ring_fused"):
        raise ValueError(f"mesh.seq={built.shape['seq']} cuts the sequence "
                         f"over a ring, which needs model.attention=ring or "
                         f"ring_fused, got {attention!r}")
    if model is not None and built.shape["tensor"] > 1:
        validate_tensor_args(int(model["num_heads"]),
                             int(model["dim"]) * int(model["mlp_ratio"]),
                             built.shape["tensor"],
                             num_devices=distrib.world_size())
    if model is not None and built.shape["expert"] > 1:
        experts = int(model.get("moe_experts", 0))
        if experts <= 0 or experts % built.shape["expert"]:
            raise ValueError(
                f"mesh.expert={built.shape['expert']} shards the MoE "
                f"blocks' experts, which needs model.moe_experts > 0 and "
                f"divisible by it, got {experts}")
    return built


def _shadow(value: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """An f32 EMA shadow of `value` on `param`'s device, carrying the
    param's `.sharding` under FSDP (the shadow is the rank's shard, which
    the checkpoint saves as such)."""
    shadow = value.detach().to(param.device, torch.float32, copy=True)
    if hasattr(param, "sharding"):
        shadow.sharding = param.sharding
    return shadow


def wrap_model(model: nn.Module, mesh: Mesh, interleave: int = 1
               ) -> nn.Module:
    """`parallel.wrap` for the run's mesh under the model's own
    `shardings()` (`transformer_shardings`): with `tensor` or `expert`
    above 1 the model cut over them first (Megatron; the MoE experts;
    then DDP over the `data x fsdp` ranks of each such rank, and the
    leaves held whole over the expert ranks too), with `pipe`
    above 1 its block stack cut over the pipe ranks (`interleave` virtual
    stages; the model itself, its data-parallel average
    `average_over_data`), with `fsdp` above 1 the model itself in FSDP
    form (over the tensor slices under both), else
    DistributedDataParallel above one rank (the model at one)."""
    if any(mesh.shape[axis] > 1
           for axis in ("fsdp", "expert", "tensor", "pipe")):
        return wrap(model, mesh=mesh, fsdp=mesh.shape["fsdp"] > 1,
                    state_sharding=model.shardings(), interleave=interleave)
    return wrap(model)


class LMSolver(BaseSolver):
    """The LM solver, one device a process (`cuda` unless `device` says
    so)."""

    def __init__(self, cfg, device: tp.Any = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = check_mesh(cfg.mesh, cfg.model.attention,
                               model=cfg.model)
        # pipeline parallelism streams the scan-stacked block leaves over
        # the pipe ranks (models/pipelined.py), so pipe > 1 forces the
        # stacked layout
        self.pipe_stages = self.mesh.shape["pipe"]
        self.pipe_schedule = cfg.get("pipeline_schedule", "gpipe")
        self.pipe_interleave = int(cfg.get("pipeline_interleave", 1))
        self.pipe_micro = cfg.get("pipeline_microbatches", None)
        if self.pipe_schedule not in KNOWN_SCHEDULES:
            raise ValueError(f"pipeline_schedule must be one of "
                             f"{KNOWN_SCHEDULES}, got "
                             f"{self.pipe_schedule!r}")
        scan_layers = bool(cfg.model.get("scan_layers", False)) \
            or self.pipe_stages > 1
        model_cfg = TransformerConfig(
            vocab_size=cfg.model.vocab_size, dim=cfg.model.dim,
            num_layers=cfg.model.num_layers, num_heads=cfg.model.num_heads,
            mlp_ratio=cfg.model.mlp_ratio, attention=cfg.model.attention,
            remat=cfg.model.get("remat", False),
            remat_policy=cfg.model.get("remat_policy", "full"),
            scan_layers=scan_layers,
            moe_experts=cfg.model.get("moe_experts", 0),
            moe_top_k=cfg.model.get("moe_top_k", 1),
            moe_capacity_factor=cfg.model.get("moe_capacity_factor", 1.25),
            moe_dispatch=cfg.model.get("moe_dispatch", "einsum"))
        self.moe = model_cfg.moe_experts > 0
        self.aux_weight = float(cfg.model.get("moe_aux_weight", 0.01))
        if cfg.get("loss", "dense") == "chunked" \
                and (self.moe or self.pipe_stages > 1):
            raise ValueError(
                "loss=chunked is not supported with MoE or pipeline "
                "parallelism (those paths need logits + aux losses); "
                "use loss=dense.")
        self.model = TransformerLM(model_cfg, device=self.device, seed=0,
                                   mesh=self.mesh)
        rows = self.mesh.data_parallel_size
        if cfg.batch_size % rows:
            raise ValueError(f"batch_size={cfg.batch_size} (the global "
                             f"batch) does not split over {rows} "
                             f"data-parallel ranks")
        # what the training step runs: DistributedDataParallel above one
        # rank, the model itself at one, or the model in FSDP form, each
        # over its tensor slices under mesh.tensor > 1 (`self.model`
        # stays the module whose state is checkpointed, evaluated and
        # sampled)
        self.train_model = wrap_model(self.model, self.mesh,
                                      self.pipe_interleave)
        self._pipe_grad_fn = None
        if self.pipe_stages > 1:
            self._pipe_grad_fn = pipelined_value_and_grad(
                self.model, mesh=self.mesh,
                num_microbatches=self.pipe_micro,
                interleave=self.pipe_interleave,
                schedule=self.pipe_schedule,
                aux_weight=self.aux_weight if self.moe else 0.0)
        # the mesh a tensor-parallel model's rank logits are reduced over
        self.vocab_mesh = self.mesh if self.mesh.shape["tensor"] > 1 \
            else None
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
        self.state["ema"] = {name: _shadow(p, p) for name, p
                             in self.model.named_parameters()}

    def loss(self, tokens: torch.Tensor,
             params: tp.Optional[tp.Mapping[str, torch.Tensor]] = None,
             model: tp.Optional[tp.Callable] = None) -> torch.Tensor:
        """Mean next-token CE, plus `moe_aux_weight` times the MoE layers'
        load-balancing loss for an MoE model, through `model` (default
        `self.model`; the training step passes `self.train_model`); with
        `params` (name -> tensor, e.g. the EMA shadow) the model runs on
        those instead of its own (`torch.func.functional_call`)."""
        if self.pipe_stages > 1:
            return self._pipelined_loss(tokens, params)
        model = self.model if model is None else model
        if params is not None:
            def model(*args, **kwargs):
                return torch.func.functional_call(self.model, params, args,
                                                  kwargs)
        return lm_next_token_loss(model, tokens,
                                  aux_weight=self.aux_weight if self.moe
                                  else None, vocab_mesh=self.vocab_mesh,
                                  mode=self.cfg.get("loss", "dense"),
                                  chunk_size=int(self.cfg.get("loss_chunk",
                                                              256)))

    def _pipelined_loss(self, tokens: torch.Tensor,
                        params: tp.Optional[tp.Mapping[str, torch.Tensor]]
                        ) -> torch.Tensor:
        """The loss of a forward through the pipeline (eval: no graph
        under 1f1b; packed has no forward-only schedule, and 1f1b's
        forward is the same numbers)."""
        schedule = "1f1b" if self.pipe_schedule == "packed_1f1b" \
            else self.pipe_schedule
        out = pipelined_apply(self.model, tokens, mesh=self.mesh,
                              num_microbatches=self.pipe_micro,
                              schedule=schedule,
                              interleave=self.pipe_interleave, params=params)
        logits, aux = out if self.moe else (out, None)
        ce = torch.nn.functional.cross_entropy(
            logits[:, :-1].reshape(-1, logits.shape[-1]),
            tokens[:, 1:].reshape(-1).long())
        return ce if aux is None else ce + self.aux_weight * aux

    def pipe_grads(self, model: nn.Module, tokens: torch.Tensor,
                   **kwargs: tp.Any) -> torch.Tensor:
        """`train_step`'s `grad_fn` under `mesh.pipe > 1`: the pipelined
        schedule's loss, its gradients added into each parameter's
        `.grad` (the rank's chunks; `embed` and `norm_f` summed over the
        pipe ranks), then averaged over the stage's data-parallel ranks
        unless inside `no_sync()` (gradient accumulation's earlier
        microbatches). Dropout stays off, as in the JAX solver."""
        del kwargs
        loss, grads = self._pipe_grad_fn(None, tokens)
        params = list(self.model.parameters())
        for name, param in self.model.named_parameters():
            grad = grads[name]
            param.grad = grad if param.grad is None else param.grad + grad
        if self.model._sharded.sync:
            average_over_data(params, self.mesh)
        return loss.float()

    def _pipeline_stats(self) -> tp.Optional[tp.Dict[str, tp.Any]]:
        """Host-static schedule numbers of the pipeline: the bubble
        fraction, idle ticks and the exact stash-ring bytes (1F1B) or
        the GPipe residency bound (the stage metrics' and the
        `pipeline/bubble` track's payload); None at pipe=1."""
        if self.pipe_stages <= 1:
            return None
        from ...parallel.pipeline import default_overlap
        from ...parallel.schedules import (gpipe_bubble_fraction,
                                           gpipe_stash_bytes, schedule_stats)
        num_micro = self.pipe_micro or self.pipe_stages
        accumulate = self.cfg.get("accumulate", 1)
        rows = self.cfg.batch_size // self.mesh.data_parallel_size
        mb = max(rows // accumulate // num_micro, 1)
        mb_shape = (mb, self.cfg.seq_len, self.cfg.model.dim)
        if self.pipe_schedule in ("1f1b", "packed_1f1b"):
            packed = self.pipe_schedule == "packed_1f1b"
            return schedule_stats(
                self.pipe_stages, num_micro, self.pipe_interleave,
                packed=packed, overlap=default_overlap(
                    packed, self.pipe_interleave, self.mesh, self.device),
                microbatch_shape=mb_shape)
        return {"schedule": "gpipe",
                "bubble_frac": round(gpipe_bubble_fraction(
                    self.pipe_stages, num_micro), 6),
                "peak_stash_bytes": gpipe_stash_bytes(
                    self.pipe_stages, num_micro, mb_shape)}

    def get_formatter(self, stage_name):
        return Formatter({"loss": ".4f", "ppl": ".1f", "grad_norm": ".2f",
                          "tokens_per_sec": ".0f", "bubble_frac": ".3f"})

    def batch_at(self, step: int, eval_set: bool = False) -> torch.Tensor:
        """This rank's rows of the global [batch_size, seq_len] batch of
        `step`: the contiguous `batch_size / (data x fsdp)` rows of its
        data-parallel index (the ranks of a tensor group take the same
        rows; all of them in one process), on the device."""
        # held-out data: an independently seeded subset of the same
        # distribution (see synthetic_token_stream)
        host = self._stream(self.cfg.batch_size, self.cfg.seq_len, step,
                            subset=1 if eval_set else 0)
        rows = self.cfg.batch_size // self.mesh.data_parallel_size
        index = self.mesh.data_parallel_index()
        local = host[index * rows:(index + 1) * rows]
        return shard_batch(local, self.mesh, device=self.device).long()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self):
        from ...observability import RooflineProfiler, get_telemetry
        cfg = self.cfg
        average = averager()
        progress = self.log_progress("train", range(cfg.steps_per_epoch),
                                     updates=5)
        telemetry = get_telemetry()
        # the roofline prices the step by the aten FLOPs of its first run;
        # a disabled one just calls the step
        roofline = telemetry.roofline if telemetry is not None \
            else RooflineProfiler(enabled=False)
        metrics: tp.Dict[str, float] = {}
        begin = time.time()
        tokens_seen = 0
        pipe_stats = self._pipeline_stats()
        for index in progress:
            global_step = (self.epoch - 1) * cfg.steps_per_epoch + index
            t0 = time.perf_counter()
            args = (self.train_model, self.optimizer, self.schedule,
                    self.state["step"], self.batch_at(global_step),
                    lambda model, tokens: self.loss(tokens, model=model))
            kwargs = {"accumulate": int(cfg.get("accumulate", 1)),
                      "mesh": self.mesh,
                      "grad_fn": self.pipe_grads if self.pipe_stages > 1
                      else None}
            step_metrics = roofline.register_fn("lm/train_step", train_step,
                                                args, kwargs)
            roofline.note_call("lm/train_step")
            if "ema" in self.state:
                # after the update, at the step count before it
                params = dict(self.model.named_parameters())
                ema_update(self.state["ema"],
                           [params[name] for name in self.state["ema"]],
                           self.ema_decay, step=self.state["step"])
            self.state["step"] += 1
            # with a preemption guard in 'abandon_stage' mode a stop
            # raises here; otherwise a no-op
            self.check_preemption()
            # the wait for the card, charged to the step's device time
            # when telemetry times the steps (reading the metrics to the
            # host below would wait anyway)
            progress.observe(step_metrics["loss"])
            metrics = average(step_metrics)
            self.step_seconds.append(time.perf_counter() - t0)
            self.step_losses.append(float(step_metrics["loss"]))
            tokens_seen += cfg.batch_size * cfg.seq_len
            if telemetry is not None and pipe_stats is not None:
                # a per-step sample of the schedule's idle-tick budget:
                # the `pipeline/bubble` counter track
                telemetry.counter("pipeline/bubble", bubble_frac=float(
                    pipe_stats["bubble_frac"]), idle_ticks_per_device=float(
                        pipe_stats.get("idle_ticks_per_device", 0.0)))
            progress.update(**metrics)
        self._sync()
        metrics["tokens_per_sec"] = tokens_seen / (time.time() - begin)
        # the global batch's: every rank ran as many steps
        metrics = distrib.average_metrics(metrics)
        metrics["ppl"] = float(np.exp(min(metrics["loss"], 20.0)))
        if pipe_stats is not None:
            metrics["bubble_frac"] = float(pipe_stats["bubble_frac"])
            metrics["peak_stash_bytes"] = int(pipe_stats["peak_stash_bytes"])
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
                progress.observe(loss)
                metrics = average({"loss": loss})
                progress.update(**metrics)
        metrics = distrib.average_metrics(metrics)
        metrics["ppl"] = float(np.exp(min(metrics["loss"], 20.0)))
        return metrics

    def generate(self):
        """Sample a continuation with the KV-cache decoder and log it."""
        prompt = self._stream(2, 16, step=0)[:, :16]
        generator = torch.Generator(device=self.device).manual_seed(
            self.epoch)
        begin = time.time()
        summon = getattr(self.model, "summon_full_params",
                         contextlib.nullcontext)
        with summon():
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
                name: _shadow(shadow, params[name])
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
    # gloo for ranks on the CPU; else NCCL where each rank has a card
    distrib.init(backend="gloo" if cfg.get("device") == "cpu" else None)
    solver = LMSolver(cfg, device=cfg.get("device"))
    solver.run()
    return solver


if __name__ == "__main__":
    main()
