"""Pipeline-parallel execution of a scan-stacked TransformerLM: the port
of flashy_tpu/models/pipelined.py.

The block stack (`TransformerConfig.scan_layers=True`: every
`blocks.block.*` leaf leads with [num_layers]) is split into chunks over
the mesh's 'pipe' process axis; the embedding and the tied head are
replicated while activations stream through the stages under GPipe
(`parallel.pipeline`, the differentiable oracle), 1F1B with interleaved
virtual stages or packed 1F1B (`parallel.pipeline_1f1b`: an O(S)
recompute stash, the bubble divided by the interleave factor, packed
gradients bit-identical to unpacked).

The model holds either the whole stack (every rank its own copy; each
rank runs its chunks of it) or, once `parallel.wrap(model, mesh=mesh,
interleave=v)` has cut it over 'pipe', the rank's chunks d, d + pipe,
... of `v` virtual stages: [v * L / (pipe * v), ...] leaves. The
functions here take both. Their gradients (`{parameter name: tensor}`)
are the block leaves' in the layout the model holds (the whole stack's
summed over the pipe ranks, or the rank's chunks) and the replicated
leaves' (`embed`, `norm_f.scale`) whole on every pipe rank: stage 0
holds the embedding's scatter-add of d/dx, the last stage the tied
head's leg and `norm_f`'s, and one all-reduce over the pipe group sums
them, where the reference's one program gets the sum for free.

Dropout stays off here (eval-mode blocks), as in the reference.
"""
import typing as tp

import torch
import torch.nn.functional as F

from .. import distrib
from ..ops.losses import tied_head
from ..parallel.mesh import Mesh, default_mesh
from ..parallel.schedules import KNOWN_SCHEDULES as SCHEDULES
from .transformer import TransformerLM, _run_block, rmsnorm

Params = tp.Mapping[str, torch.Tensor]
BLOCKS = "blocks.block."


def _params(model: TransformerLM, params: tp.Optional[Params]) -> Params:
    """`params` (name -> tensor, e.g. an EMA shadow) over the model's own
    named parameters."""
    own = dict(model.named_parameters())
    if params is not None:
        own.update(params)
    return own


def _stacked(model: TransformerLM, params: Params
             ) -> tp.Dict[str, torch.Tensor]:
    """The block leaves by their name inside the block."""
    return {name: params[BLOCKS + name] for name in model.blocks.names}


def _chunked_stage(model: TransformerLM, params: Params, num_chunks: int,
                   held_chunks: int) -> tp.Tuple[tp.Callable,
                                                  tp.Dict[str, torch.Tensor],
                                                  bool]:
    """The per-chunk stage function and the block leaves as
    [held_chunks, layers_per_chunk, ...] (`held_chunks` = num_chunks for
    the whole stack, or the rank's own count)."""
    cfg = model.config
    if not cfg.scan_layers:
        raise ValueError("pipelined_apply needs TransformerConfig.scan_layers"
                         "=True")
    layers_per_chunk = cfg.num_layers // num_chunks
    moe = cfg.moe_experts > 0
    stage_params = {
        name: leaf.reshape(held_chunks, layers_per_chunk, *leaf.shape[1:])
        for name, leaf in _stacked(model, params).items()}
    block = model.blocks.block
    moe_layer = getattr(block, "moe", None)

    def stage_fn(local: tp.Mapping[str, torch.Tensor], h: torch.Tensor):
        # h: [mb, T, D]; local leaves: [layers_per_chunk, ...]
        positions = torch.arange(h.shape[1], device=h.device).expand(
            h.shape[:2])
        aux = None
        for i in range(layers_per_chunk):
            weights = {name: leaf[i] for name, leaf in local.items()}

            def layer(x, positions, weights=weights):
                return torch.func.functional_call(
                    block, weights, (x, positions, None, None),
                    {"layer": i})

            h = _run_block(cfg, layer, h, positions)
            if moe:
                aux = moe_layer.aux if aux is None else aux + moe_layer.aux
        if moe:
            return h, aux
        return h

    return stage_fn, stage_params, moe


def _pipe_setup(model: TransformerLM, params: Params,
                mesh: tp.Optional[Mesh], interleave: int):
    """Validate the layer split against the 'pipe' axis and build the
    chunked stage: (mesh, num_stages, stage_fn, stage_params, moe, full),
    `full` whether the model holds the whole stack."""
    cfg = model.config
    mesh = mesh or default_mesh()
    num_stages = mesh.shape["pipe"]
    num_chunks = num_stages * interleave
    if interleave < 1:
        raise ValueError(f"interleave must be >= 1, got {interleave}")
    if cfg.num_layers % num_stages:
        raise ValueError(f"num_layers {cfg.num_layers} not divisible by "
                         f"pipe={num_stages}")
    if cfg.num_layers % num_chunks:
        layers_per_stage = cfg.num_layers // num_stages
        raise ValueError(
            f"interleave={interleave} must divide the per-device layer "
            f"count: {cfg.num_layers} layers over pipe={num_stages} give "
            f"{layers_per_stage} layers/device, not splittable into "
            f"{interleave} virtual stages. Use interleave in "
            f"{[v for v in range(1, layers_per_stage + 1) if layers_per_stage % v == 0]} "
            f"or change num_layers.")
    held = next(iter(_stacked(model, params).values())).shape[0]
    full = held == cfg.num_layers
    if not full and held * num_stages != cfg.num_layers:
        raise ValueError(
            f"the model holds {held} of {cfg.num_layers} layers, which a "
            f"mesh with pipe={num_stages} does not give")
    stage_fn, stage_params, moe = _chunked_stage(
        model, params, num_chunks, num_chunks if full else interleave)
    return mesh, num_stages, stage_fn, stage_params, moe, full


def _head_logits(x: torch.Tensor, embedding: torch.Tensor,
                 norm_scale: torch.Tensor, cfg: tp.Any) -> torch.Tensor:
    """The LM head shared by every schedule path: the final rmsnorm and
    the tied vocabulary projection (compute-dtype operands, f32
    accumulation: the TransformerLM forward's scheme)."""
    return tied_head(rmsnorm(x, norm_scale, cfg.dtype), embedding)


def _next_token_ce(logits: torch.Tensor, tokens: torch.Tensor
                   ) -> torch.Tensor:
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1).long())


def _scatter_rows(embedding: torch.Tensor, tokens: torch.Tensor,
                  dx: torch.Tensor) -> torch.Tensor:
    """The input lookup's gradient: d/dx added into the token ids' rows of
    an f32 table of the embedding's shape (the reference's
    `zeros.at[tokens].add(dx)`)."""
    return torch.zeros(embedding.shape, dtype=torch.float32,
                       device=embedding.device).index_add_(
        0, tokens.reshape(-1), dx.reshape(-1, dx.shape[-1]).float())


def _gpipe_params(stage_params: tp.Dict[str, torch.Tensor], full: bool,
                  num_stages: int) -> tp.Dict[str, torch.Tensor]:
    """GPipe's one chunk a stage: [S, L/S, ...] for the whole stack, the
    rank's [1, L/S, ...] otherwise."""
    return {name: leaf.reshape(num_stages if full else 1, -1,
                               *leaf.shape[2:])
            for name, leaf in stage_params.items()}


def pipelined_apply(model: TransformerLM, tokens: torch.Tensor, *,
                    mesh: tp.Optional[Mesh] = None,
                    num_microbatches: tp.Optional[int] = None,
                    schedule: str = "gpipe", interleave: int = 1,
                    params: tp.Optional[Params] = None) -> tp.Any:
    """Forward a scan-stacked TransformerLM with pipeline parallelism.

    Requirements: `config.scan_layers=True`, `num_layers` divisible by
    the mesh's 'pipe' size (and by pipe * interleave), no dropout.
    `schedule='gpipe'` (default) streams the microbatches through the
    fill-drain schedule, differentiable (O(M) residency); `'1f1b'` runs
    the forward through the interleaved virtual-stage placement of
    `parallel.pipeline_1f1b` (no graph: for training under 1F1B use
    `pipelined_value_and_grad`). `params` (name -> tensor) replaces the
    model's own parameters (an EMA shadow, in the layout the model
    holds).

    Returns f32 logits [B, T, V] on every pipe rank, or `(logits,
    moe_aux)` for MoE models: the per-layer load-balancing losses summed
    within each stage and over the microbatches, then averaged over the
    microbatches (each microbatch routes on its own tokens).
    """
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, "
                         f"got {schedule!r}")
    if schedule == "packed_1f1b":
        raise ValueError(
            "schedule='packed_1f1b' has no forward-only spelling: packing "
            "pairs each forward tick with a backward, which is meaningless "
            "without a backward lane. Use schedule='1f1b' for pipelined "
            "forwards, or pipelined_value_and_grad(schedule='packed_1f1b') "
            "for training.")
    if schedule == "gpipe" and interleave != 1:
        raise ValueError(
            "interleave>1 (virtual stages) is a 1F1B-family feature; "
            "GPipe streams each device's layers as one stage. Use "
            "schedule='1f1b' (or pipelined_value_and_grad for training).")
    cfg = model.config
    params = _params(model, params)
    mesh, num_stages, stage_fn, stage_params, moe, full = _pipe_setup(
        model, params, mesh, interleave)
    embedding = params["embed"]
    x = embedding[tokens].to(cfg.dtype)
    if schedule == "gpipe":
        from ..parallel.pipeline import pipeline
        result = pipeline(stage_fn,
                          _gpipe_params(stage_params, full, num_stages), x,
                          mesh=mesh, num_microbatches=num_microbatches,
                          has_aux=moe)
    else:
        from ..parallel.pipeline import pipeline_1f1b
        result = pipeline_1f1b(stage_fn, stage_params, x, mesh=mesh,
                               num_microbatches=num_microbatches,
                               interleave=interleave, has_aux=moe)
    if moe:
        x, aux_sum = result
        num_micro = num_microbatches or num_stages
        if num_stages == 1:
            num_micro = 1  # the degenerate path runs the whole batch
        aux = aux_sum / num_micro
    else:
        x = result
    logits = _head_logits(x, embedding, params["norm_f.scale"], cfg)
    if moe:
        return logits, aux
    return logits


def sequential_value_and_grad(model: TransformerLM, *, num_microbatches: int,
                              aux_weight: float = 0.0) -> tp.Callable:
    """Per-microbatch sequential reference grad-fn (no pipeline).

    `fn(params, tokens) -> (loss, grads)` with `params` name -> tensor
    (None: the model's own; the whole stack) and `grads` by parameter
    name: the whole layer stack chained microbatch by microbatch, the
    per-microbatch CE (+ aux) averaged, the exact gradient estimator
    both pipeline schedules compute, spelled without any collective. The
    triangulation oracle of the schedule tests.
    """
    cfg = model.config
    moe = cfg.moe_experts > 0
    M = num_microbatches

    def grad_fn(params: tp.Optional[Params], tokens: torch.Tensor):
        own = _params(model, params)
        names = list(own)
        leaves = [own[name].detach().requires_grad_(True) for name in names]
        held = dict(zip(names, leaves))
        with torch.enable_grad():
            stage_fn, stage_params, _ = _chunked_stage(model, held, 1, 1)
            chunk = {name: leaf[0] for name, leaf in stage_params.items()}
            x = held["embed"][tokens].to(cfg.dtype)
            xm = x.reshape(M, x.shape[0] // M, *x.shape[1:])
            tm = tokens.reshape(M, tokens.shape[0] // M, tokens.shape[1])
            ce_total, aux_total = 0.0, 0.0
            for m in range(M):
                if moe:
                    h, aux = stage_fn(chunk, xm[m])
                    aux_total = aux_total + aux
                else:
                    h = stage_fn(chunk, xm[m])
                logits = _head_logits(h, held["embed"],
                                      held["norm_f.scale"], cfg)
                ce_total = ce_total + _next_token_ce(logits, tm[m])
            loss = ce_total / M + aux_weight * aux_total / M
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), dict(zip(names, grads))

    return grad_fn


def pipelined_value_and_grad(model: TransformerLM, *,
                             mesh: tp.Optional[Mesh] = None,
                             num_microbatches: tp.Optional[int] = None,
                             interleave: int = 1, schedule: str = "1f1b",
                             aux_weight: float = 0.0,
                             overlap: tp.Optional[bool] = None
                             ) -> tp.Callable:
    """A pipelined LM training grad-fn: `fn(params, tokens) -> (loss,
    grads)` with `params` name -> tensor (None: the model's own), `loss
    = ce + aux_weight * moe_aux` (the same on every pipe rank) and
    `grads` by parameter name (see the module doc for their layout).

    `schedule='1f1b'` runs `parallel.pipeline_1f1b`'s program (the
    recompute stash; the embedding gradient assembled from both its
    uses: the tied head's leg from the loss parameters, the input
    lookup's as the scatter-add of d/dx over the token ids);
    `'packed_1f1b'` co-schedules the steady state's forward and backward
    (gradients bit-identical to '1f1b'), `overlap` (default: on for a
    CUDA mesh at interleave 1) runs the hop-latency-2 tables.
    `schedule='gpipe'` is autograd through `pipelined_apply`: the
    oracle the 1F1B gradients are held to.
    """
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, "
                         f"got {schedule!r}")
    cfg = model.config
    moe = cfg.moe_experts > 0

    if schedule == "gpipe":
        def gpipe_fn(params: tp.Optional[Params], tokens: torch.Tensor):
            own = _params(model, params)
            names = list(own)
            leaves = [own[name].detach().requires_grad_(True)
                      for name in names]
            with torch.enable_grad():
                out = pipelined_apply(model, tokens, mesh=mesh,
                                      num_microbatches=num_microbatches,
                                      params=dict(zip(names, leaves)))
                logits, aux = out if moe else (out, None)
                loss = _next_token_ce(logits, tokens)
                if moe:
                    loss = loss + aux_weight * aux
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(leaf) if g is None else g
                     for g, leaf in zip(grads, leaves)]
            out_grads = dict(zip(names, grads))
            full = own[BLOCKS + model.blocks.names[0]].shape[0] \
                == cfg.num_layers
            pipe_mesh = mesh or default_mesh()
            if full and pipe_mesh.shape["pipe"] > 1:
                # each rank's rows of the whole stack: summed over the
                # pipe ranks, every rank holds the stack's gradient
                group = pipe_mesh.group("pipe")
                for name in model.blocks.names:
                    out_grads[BLOCKS + name] = distrib.all_reduce(
                        out_grads[BLOCKS + name], "sum", group)
            return loss.detach(), out_grads

        return gpipe_fn

    def grad_fn(params: tp.Optional[Params], tokens: torch.Tensor):
        from ..parallel.pipeline import (_check_chunk_params,
                                         _single_stage_1f1b, default_overlap,
                                         run_local_1f1b)
        own = _params(model, params)
        pipe_mesh, num_stages, stage_fn, stage_params, _, full = _pipe_setup(
            model, own, mesh, interleave)
        embedding = own["embed"]
        x = embedding[tokens].to(cfg.dtype)
        loss_params = {"embed": embedding, "norm_scale": own["norm_f.scale"]}

        def micro_loss(lp, h, tokens_micro):
            logits = _head_logits(h, lp["embed"], lp["norm_scale"], cfg)
            return _next_token_ce(logits, tokens_micro)

        packed = schedule == "packed_1f1b"
        use_overlap = overlap
        if use_overlap is None:
            use_overlap = default_overlap(packed, interleave, pipe_mesh,
                                          x.device)
        num_chunks = num_stages * interleave
        _check_chunk_params(stage_params, num_chunks, interleave, num_stages)
        weight = aux_weight if moe else 0.0
        if num_stages == 1:
            result = _single_stage_1f1b(stage_fn, stage_params, x, micro_loss,
                                        loss_params, tokens, interleave, moe,
                                        weight)
            (ce, aux), grads = result if moe else ((result[0], None),
                                                   result[1])
            d_blocks = {name: g for name, g in
                        grads["stage_params"].items()}
            d_head = grads["loss_params"]
            gx = grads["x"]
            loss = ce + weight * aux if moe else ce
            d_embed = d_head["embed"].float() + _scatter_rows(
                embedding, tokens, gx)
            d_norm = d_head["norm_scale"]
        else:
            num_micro = num_microbatches or num_stages
            run, hop = run_local_1f1b(
                stage_fn, stage_params, x, loss_fn=micro_loss,
                loss_params=loss_params, targets=tokens, mesh=pipe_mesh,
                num_microbatches=num_micro, interleave=interleave,
                has_aux=moe, aux_weight=weight, packed=packed,
                overlap=use_overlap, full=full)
            # the embedding's two legs and norm_f: this rank's parts,
            # summed over the pipe ranks in one all-reduce with the loss
            glp_embed, glp_norm = run.loss_params
            d_embed = glp_embed
            if run.x is not None:
                d_embed = d_embed + _scatter_rows(embedding, tokens, run.x)
            flat = torch.cat([d_embed.reshape(-1), glp_norm.reshape(-1),
                              run.loss.reshape(1), run.aux.reshape(1)])
            flat = distrib.all_reduce(flat, "sum", hop.group)
            sizes = [embedding.numel(), glp_norm.numel(), 1, 1]
            d_embed, d_norm, loss_sum, aux_sum = flat.split(sizes)
            d_embed = d_embed.view(embedding.shape)
            d_norm = d_norm.view(glp_norm.shape)
            ce = loss_sum[0] / num_micro
            loss = ce + weight * aux_sum[0] / num_micro if moe else ce
            d_blocks = {}
            for i, name in enumerate(stage_params):
                mine = torch.stack([run.stage[k][i]
                                    for k in range(interleave)])
                if full:
                    total = torch.zeros(stage_params[name].shape,
                                        dtype=torch.float32,
                                        device=mine.device)
                    for k in range(interleave):
                        total[k * num_stages + hop.stage] = mine[k]
                    mine = distrib.all_reduce(total, "sum", hop.group)
                d_blocks[name] = mine
        grads = {BLOCKS + name: g.reshape(own[BLOCKS + name].shape)
                 .to(own[BLOCKS + name].dtype)
                 for name, g in d_blocks.items()}
        grads["embed"] = d_embed.to(embedding.dtype)
        grads["norm_f.scale"] = d_norm.to(own["norm_f.scale"].dtype)
        return loss.detach(), grads

    return grad_fn
